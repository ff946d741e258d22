"""The port's transformer families against the reference, on the CPU.

Small configs (``reduced``: 2 layers, d_model 64, 4 heads, 2 KV heads,
head_dim 16, vocab 256; xlstm-350m 4 blocks, whisper-small 2 encoder
layers over 16 frames, internvl2-26b 4 patches).  Both packages load the
same weights: the reference's ``init_params(PRNGKey(0))`` with every bias
and norm parameter replaced by seeded numpy values
(``_torch_oracles.lm_arrays``), and the same numpy tokens, frame and
patch embeddings.  Float32 results agree to 1e-4: a few layers of float32
matrix products summed in another order than XLA's.  The reference's
jitted functions compile once per config (module-scoped fixtures).

The xLSTM, whisper and VLM families: ``forward``, ``loss_fn``,
``prefill`` (logits and every cache leaf) and ``decode_step`` against the
reference's at that tolerance, ``to_arrays(from_arrays(...))`` bit for bit,
cross-attention (``attention_train`` / ``attention_decode`` with
``kv_override``) and whisper's encoder (``encode`` against
``_encoder_forward``) on their own, and xlstm-350m's greedy
``Engine.generate`` equal to the reference engine's tokens.

The hybrid family (jamba): reduced jamba (d 64, 4 experts top-2, one
Mamba:attention 3:1 period of 4 sub-layers, 8 layers) and a 7:1 period
(``attn_every=8``, 8 layers, the published interleave), each through
``from_arrays`` of the doubly stacked pytree (round trip bit for bit),
``forward`` (logits and the MoE layers' aux), ``loss_fn``, ``prefill``
(logits, K/V and every Mamba state) and ``decode_step`` against the
reference's, decode against forward, and greedy ``Engine.generate``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracles import lm_arrays
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.serve.engine import Engine as REngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch.configs.base import get_config, list_archs, reduced
from repro_torch.models import attention as attn
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(2)

CPU = torch.device("cpu")
DENSE = ["qwen2.5-3b", "qwen1.5-4b", "mistral-nemo-12b", "starcoder2-15b"]
MOE = ["grok-1-314b", "qwen3-moe-235b-a22b"]
FAMILIES = ["xlstm-350m", "whisper-small", "internvl2-26b"]   # ssm, audio, vlm
HYBRID = "jamba-1.5-large-398b"
PERIODS = {"3:1": {}, "7:1": {"attn_every": 8, "n_layers": 8}}
PARITY = ["qwen2.5-3b", "qwen1.5-4b", "starcoder2-15b", "mistral-nemo-12b"]
# reduced() squares mistral-nemo's width away (4 heads x 16 = d_model 64):
# head_dim 32 keeps its query width (128) unlike d_model, as published
# (32 x 128 = 4096 against 5120)
PARITY_OVER = {"mistral-nemo-12b": {"head_dim": 32}}
B, S = 2, 16
TOL = dict(atol=1e-4, rtol=1e-4)


def _tokens(cfg, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


class Case:
    """One reduced config in both packages, its weights and reference
    forward logits."""

    def __init__(self, arch, **overrides):
        self.r_cfg = r_reduced(r_get_config(arch), **overrides)
        self.cfg = reduced(get_config(arch), **overrides)
        self.arrays = lm_arrays(self.r_cfg)
        self.r_params = jax.tree.map(jnp.asarray, self.arrays)
        self.model = Transformer.from_arrays(self.cfg, self.arrays, device=CPU)
        self.tokens = _tokens(self.cfg)
        fwd = jax.jit(lambda p, t: RT.forward(p, self.r_cfg, {"tokens": t})[0])
        self.r_logits = np.asarray(
            fwd(self.r_params, jnp.asarray(self.tokens)).astype(jnp.float32))


@pytest.fixture(scope="module", params=PARITY)
def case(request):
    return Case(request.param, **PARITY_OVER.get(request.param, {}))


@pytest.mark.parametrize("arch", DENSE + MOE + FAMILIES + [HYBRID])
def test_config_equals_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(r_get_config(arch))
    assert dataclasses.asdict(reduced(get_config(arch), compute_dtype="bfloat16")) \
        == dataclasses.asdict(r_reduced(r_get_config(arch),
                                        compute_dtype="bfloat16"))
    cfg = get_config(arch)
    assert cfg.param_count() == r_get_config(arch).param_count()
    assert cfg.active_param_count() == r_get_config(arch).active_param_count()


def test_registry_holds_the_dense_configs_only():
    """Every config of the reference: the LM configs, the hybrid family's
    jamba too, and the graph engine's ringo-graph, a cost cell of
    ``launch/ringo_cells.py`` equal to the reference's field by field."""
    assert list_archs() == tuple(sorted(DENSE + MOE + FAMILIES + [HYBRID] +
                                        ["ringo-graph"]))
    assert get_config(HYBRID).family == "hybrid"
    ringo = get_config("ringo-graph")
    assert ringo.family == "graph"
    assert dataclasses.asdict(ringo) == \
        dataclasses.asdict(r_get_config("ringo-graph"))
    with pytest.raises(KeyError, match="unknown arch 'ghost'"):
        get_config("ghost")


def test_parity_keeps_mistral_nemos_query_width_unlike_d_model():
    cfg = reduced(get_config("mistral-nemo-12b"),
                  **PARITY_OVER["mistral-nemo-12b"])
    assert cfg.n_heads * cfg.resolved_head_dim == 128 != cfg.d_model == 64
    full = get_config("mistral-nemo-12b")
    assert full.n_heads * full.resolved_head_dim != full.d_model


def test_round_trip_is_bit_identical(case):
    back = case.model.to_arrays()
    flat_a = jax.tree_util.tree_leaves_with_path(case.arrays)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def test_forward_matches_reference(case):
    logits, aux = case.model({"tokens": torch.from_numpy(case.tokens)})
    assert logits.shape == (B, S, case.cfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), case.r_logits, **TOL)


def test_decode_matches_forward(case):
    """Greedy decode after prefill equals the teacher-forced forward, at
    the reference's own tolerance for this check (test_models.py)."""
    tokens = torch.from_numpy(case.tokens)
    full, _ = case.model({"tokens": tokens})
    _, cache = case.model.prefill({"tokens": tokens[:, :-1]}, S + 4)
    dec, _ = case.model.decode_step(cache, tokens[:, -1:], S - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-4, rtol=2e-3)


def test_prefill_and_decode_match_reference():
    c = Case("qwen2.5-3b")
    cfg, r_cfg = c.cfg, c.r_cfg
    max_seq, n_dec = S + 8, 4
    tokens = _tokens(cfg, seed=1, s=S + n_dec)
    prompt = tokens[:, :S]
    r_prefill = jax.jit(lambda p, t: RT.prefill(p, r_cfg, {"tokens": t},
                                                max_seq))
    r_decode = jax.jit(lambda p, cch, t, pos: RT.decode_step(p, r_cfg, cch,
                                                              t, pos))
    r_logits, r_cache = r_prefill(c.r_params, jnp.asarray(prompt))
    logits, cache = c.model.prefill({"tokens": torch.from_numpy(prompt)},
                                    max_seq)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert cache["attn"]["k"].shape == (cfg.n_layers, B, max_seq,
                                        cfg.n_kv_heads, cfg.resolved_head_dim)

    def same(step):
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   err_msg=f"logits, step {step}", **TOL)
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                cache["attn"][kv].numpy(), np.asarray(r_cache["attn"][kv]),
                err_msg=f"cache {kv}, step {step}", **TOL)

    same("prefill")
    for i in range(n_dec):
        tok = tokens[:, S + i:S + i + 1]
        r_logits, r_cache = r_decode(c.r_params, r_cache, jnp.asarray(tok),
                                     jnp.int32(S + i))
        logits, cache = c.model.decode_step(cache, torch.from_numpy(tok),
                                            S + i)
        same(i)


def test_bf16_compute_forward_matches_reference():
    """bf16 activations: the reference's XLA attention rounds p to bf16
    before p·v and K4 keeps it in float32, so the two differ by bf16
    rounding; held at the reference's bf16 tolerance for K4 (0.06)."""
    c = Case("qwen2.5-3b", compute_dtype="bfloat16")
    logits, _ = c.model({"tokens": torch.from_numpy(c.tokens)})
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), c.r_logits,
                               atol=0.06, rtol=0.06)


def test_other_families_raise():
    """The ``family="graph"`` config (ringo-graph, registered in the port
    too) builds no model: it is a cost cell of ``launch/ringo_cells.py``;
    neither does an LM config given that family."""
    for ringo in (r_get_config("ringo-graph"), get_config("ringo-graph")):
        assert ringo.family == "graph"
        with pytest.raises(NotImplementedError,
                           match="cost cell of launch/ringo_cells.py"):
            Transformer(ringo, device=CPU)
    graph = dataclasses.replace(reduced(get_config("qwen2.5-3b")),
                                family="graph")
    with pytest.raises(NotImplementedError, match="not a model"):
        Transformer(graph, device=CPU)


def test_init_params_distributions():
    cfg = reduced(get_config("starcoder2-15b"), d_model=256, d_ff=512,
                  vocab_size=2048)
    gen = torch.Generator().manual_seed(3)
    model = Transformer.init_params(cfg, gen, device=CPU)
    again = Transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                    device=CPU)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k
    blk = model.layers[0]
    assert torch.all(blk.ln1.scale == 1) and torch.all(blk.ln1.bias == 0)
    assert torch.all(blk.attn.wq.b == 0)
    w = blk.mlp.wi.w
    assert abs(float(w.std()) * 256 ** 0.5 - 1.0) < 0.02
    assert abs(float(model.embed["tok"].table.std()) - 0.02) < 0.001
    assert model.to_arrays()["layers"]["attn"]["wq"]["w"].shape == \
        (cfg.n_layers, 256, cfg.n_heads * cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# the ssm (xLSTM), audio (whisper) and vlm (internvl2) families
# ---------------------------------------------------------------------------


def _family_batch(cfg, seed=0, b=B, s=S):
    """Numpy tokens and targets, with whisper's frame embeddings or the
    VLM's patch embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.normal(size=(b, cfg.enc_seq_len, cfg.d_model)
                                       ).astype(np.float32)
    if cfg.n_patches:
        out["patch_embeds"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)
                                         ).astype(np.float32)
    return out


def _to(batch, lib):
    return {k: (jnp.asarray(v) if lib == "jax" else torch.from_numpy(v))
            for k, v in batch.items()}


class FamilyCase:
    """One reduced config of a new family in both packages, its weights
    and a batch."""

    def __init__(self, arch):
        self.r_cfg = r_reduced(r_get_config(arch))
        self.cfg = reduced(get_config(arch))
        self.arrays = lm_arrays(self.r_cfg)
        self.r_params = jax.tree.map(jnp.asarray, self.arrays)
        self.model = Transformer.from_arrays(self.cfg, self.arrays, device=CPU)
        self.batch = _family_batch(self.cfg)


@pytest.fixture(scope="module", params=FAMILIES)
def fcase(request):
    return FamilyCase(request.param)


def test_family_round_trip_is_bit_identical(fcase):
    back = fcase.model.to_arrays()
    flat_a = jax.tree_util.tree_leaves_with_path(fcase.arrays)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def test_family_forward_and_loss_match_reference(fcase):
    c = fcase
    r_logits, r_aux = jax.jit(lambda p, bt: RT.forward(p, c.r_cfg, bt))(
        c.r_params, _to(c.batch, "jax"))
    logits, aux = c.model(_to(c.batch, "torch"))
    assert logits.shape == (B, S, c.cfg.vocab_size)
    assert float(aux) == float(r_aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), **TOL)
    r_loss, r_parts = jax.jit(lambda p, bt: RT.loss_fn(p, c.r_cfg, bt))(
        c.r_params, _to(c.batch, "jax"))
    loss, parts = c.model.loss_fn(_to(c.batch, "torch"))
    np.testing.assert_allclose(float(loss), float(r_loss), **TOL)
    np.testing.assert_allclose(float(parts["ce"]), float(r_parts["ce"]),
                               **TOL)


def test_family_prefill_and_decode_match_reference(fcase):
    """Prefill's logits and every cache leaf, then decode steps, as the
    reference's (xLSTM: the terminal states; whisper: the decoder's K/V,
    cross-attending to ``encode``'s output in decode)."""
    _prefill_and_decode_match_reference(fcase)


def _prefill_and_decode_match_reference(c):
    cfg, r_cfg = c.cfg, c.r_cfg
    n_dec = 3
    full = _family_batch(cfg, seed=1, s=S + n_dec)
    prompt = dict(full, tokens=full["tokens"][:, :S])
    prompt.pop("targets")
    max_seq = S + n_dec + 4 + cfg.n_patches
    r_logits, r_cache = jax.jit(lambda p, bt: RT.prefill(
        p, r_cfg, bt, max_seq))(c.r_params, _to(prompt, "jax"))
    logits, cache = c.model.prefill(_to(prompt, "torch"), max_seq)
    r_enc = enc = None
    if cfg.is_encoder_decoder:
        r_enc = RT._encoder_forward(c.r_params, r_cfg,
                                    jnp.asarray(full["enc_embeds"]))
        enc = c.model.encode(torch.from_numpy(full["enc_embeds"]))
    r_decode = jax.jit(lambda p, cch, t, pos, e: RT.decode_step(
        p, r_cfg, cch, t, pos, enc_out=e))

    def same(step):
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   err_msg=f"logits, step {step}", **TOL)
        want = dict(jax.tree_util.tree_leaves_with_path(r_cache))
        got = dict(jax.tree_util.tree_leaves_with_path(cache))
        assert set(got) == set(want)
        for path, a in want.items():
            assert tuple(got[path].shape) == a.shape, path
            np.testing.assert_allclose(got[path].numpy(), np.asarray(a),
                                       err_msg=f"cache {path}, step {step}",
                                       **TOL)

    same("prefill")
    for i in range(n_dec):
        tok = full["tokens"][:, S + i:S + i + 1]
        pos = S + i + cfg.n_patches
        r_logits, r_cache = r_decode(c.r_params, r_cache, jnp.asarray(tok),
                                     jnp.int32(pos), r_enc)
        logits, cache = c.model.decode_step(cache, torch.from_numpy(tok),
                                            pos, enc_out=enc)
        same(i)


def test_family_decode_matches_forward(fcase):
    """The reference's ``test_decode_matches_forward`` on the port."""
    c = fcase
    batch = _to(c.batch, "torch")
    full, _ = c.model(batch)
    enc = c.model.encode(batch["enc_embeds"]) \
        if c.cfg.is_encoder_decoder else None
    _, cache = c.model.prefill(dict(batch, tokens=batch["tokens"][:, :-1]),
                               S + 4 + c.cfg.n_patches)
    dec, _ = c.model.decode_step(cache, batch["tokens"][:, -1:],
                                 S - 1 + c.cfg.n_patches, enc_out=enc)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def whisper():
    return FamilyCase("whisper-small")


def test_encode_matches_reference(whisper):
    c = whisper
    frames = c.batch["enc_embeds"]
    want = jax.jit(lambda p, e: RT._encoder_forward(p, c.r_cfg, e))(
        c.r_params, jnp.asarray(frames))
    got = c.model.encode(torch.from_numpy(frames))
    assert got.shape == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = Transformer.from_arrays(reduced(get_config("qwen2.5-3b")),
                                    lm_arrays(r_reduced(r_get_config(
                                        "qwen2.5-3b"))), device=CPU)
    with pytest.raises(ValueError, match="no encoder"):
        dense.encode(torch.from_numpy(frames))
    with pytest.raises(ValueError, match="no cross-attention"):
        dense.decode_step(dense.init_cache(B, 8),
                          torch.zeros((B, 1), dtype=torch.int32), 0,
                          enc_out=got)


def _xattn_inputs(c, sq, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, sq, c.cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, c.cfg.enc_seq_len, c.cfg.d_model)
                     ).astype(np.float32)
    r_p = c.r_params["layers"]
    r_p = jax.tree.map(lambda t: t[0], r_p["xattn"])
    return x, enc, r_p, c.model.layers[0].xattn


@pytest.mark.parametrize("sq", [5, 16, 24])
@torch.no_grad()
def test_cross_attention_train_matches_reference(whisper, sq):
    """K and V from the encoder states, no RoPE, not causal, Sq != Se."""
    c = whisper
    x, enc, r_p, p = _xattn_inputs(c, sq)
    want = RA.attention_train(r_p, jnp.asarray(x), c.r_cfg,
                              kv_override=(jnp.asarray(enc),) * 2)
    e = torch.from_numpy(enc)
    got = attn.attention_train(p, torch.from_numpy(x), c.cfg,
                               kv_override=(e, e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # not causal: the first query sees the last frame
    e2 = e.clone()
    e2[:, -1] += 1.0
    moved = attn.attention_train(p, torch.from_numpy(x), c.cfg,
                                 kv_override=(e2, e2))
    assert not torch.allclose(moved[:, 0], got[:, 0])


@torch.no_grad()
def test_cross_attention_decode_matches_reference(whisper):
    """One token against all Se frames, projected anew; the self-attention
    cache comes back untouched."""
    c = whisper
    x, enc, r_p, p = _xattn_inputs(c, 1)
    cfg = c.cfg
    shape = (B, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    rng = np.random.default_rng(4)
    kv = {k: rng.normal(size=shape).astype(np.float32) for k in ("k", "v")}
    want, r_cache = RA.attention_decode(
        r_p, jnp.asarray(x), c.r_cfg, jax.tree.map(jnp.asarray, kv),
        jnp.int32(5), kv_override=(jnp.asarray(enc),) * 2)
    cache = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
    e = torch.from_numpy(enc)
    got, new = attn.attention_decode(p, torch.from_numpy(x), cfg, cache, 5,
                                     kv_override=(e, e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("k", "v"):
        assert np.array_equal(new[k].numpy(), kv[k])
        assert np.array_equal(np.asarray(r_cache[k]), kv[k])
    # the same as cross-attention over the whole sequence, at one query
    full = attn.attention_train(p, torch.from_numpy(x), cfg,
                                kv_override=(e, e))
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


def test_xlstm_engine_generate_matches_reference():
    """Greedy tokens of the reference's engine: left-padded prompts run
    through the recurrence, as there."""
    c = FamilyCase("xlstm-350m")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, c.cfg.vocab_size, n).tolist()
               for n in (12, 7, 3)]
    want = REngine(c.r_cfg, c.r_params, RServeConfig(batch=4, max_seq=40)
                   ).generate(prompts, 6)
    eng = Engine(c.cfg, c.model, ServeConfig(batch=4, max_seq=40),
                 device=CPU)
    assert eng.generate(prompts, 6) == want


@pytest.mark.parametrize("arch", ["xlstm-350m", "qwen2.5-3b", HYBRID])
def test_astype_keeps_what_applies_read_in_float32(arch):
    """The engine's bf16 copy gives the numbers of the float32 model in
    bf16 compute, bit for bit: norms (perturbed here), sLSTM's ``r_h``
    and the Mamba's ``a_log`` keep their float32 values, as the reference
    reads them."""
    r_cfg = r_reduced(r_get_config(arch), compute_dtype="bfloat16")
    cfg = reduced(get_config(arch), compute_dtype="bfloat16")
    model = Transformer.from_arrays(cfg, lm_arrays(r_cfg), device=CPU)
    copy = model.astype(torch.bfloat16)
    assert copy.norm_f.scale.dtype == torch.float32
    assert copy.embed["tok"].table.dtype == torch.bfloat16
    tokens = torch.from_numpy(_tokens(cfg))
    want, _ = model({"tokens": tokens})
    got, _ = copy({"tokens": tokens})
    assert torch.equal(got, want)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_family_loss_under_remat(fcase, remat):
    """``loss_fn`` with each block (and whisper's encoder layers)
    rematerialised gives the loss and gradients of ``remat="none"``."""
    c = fcase
    batch = _to(c.batch, "torch")

    def loss_and_grads(mode):
        c.model.cfg = dataclasses.replace(c.cfg, remat=mode)
        try:
            c.model.zero_grad(set_to_none=True)
            loss, _ = c.model.loss_fn(batch)
            loss.backward()
            return loss.detach(), {k: p.grad.clone()
                                   for k, p in c.model.named_parameters()}
        finally:
            c.model.cfg = c.cfg

    want, want_g = loss_and_grads("none")
    got, got_g = loss_and_grads(remat)
    assert torch.equal(got, want)
    assert set(got_g) == set(want_g)
    for k, g in want_g.items():
        torch.testing.assert_close(got_g[k], g, atol=1e-6, rtol=1e-5,
                                   msg=k)
    c.model.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# the hybrid family (jamba): Mamba / attention / MoE periods
# ---------------------------------------------------------------------------


class HybridCase(FamilyCase):
    """Reduced jamba at one period shape, in both packages."""

    def __init__(self, period):
        over = PERIODS[period]
        self.r_cfg = dataclasses.replace(r_reduced(r_get_config(HYBRID)),
                                         **over)
        self.cfg = dataclasses.replace(reduced(get_config(HYBRID)), **over)
        self.arrays = lm_arrays(self.r_cfg)
        self.r_params = jax.tree.map(jnp.asarray, self.arrays)
        self.model = Transformer.from_arrays(self.cfg, self.arrays, device=CPU)
        self.batch = _family_batch(self.cfg)


@pytest.fixture(scope="module", params=sorted(PERIODS))
def hcase(request):
    return HybridCase(request.param)


def test_hybrid_round_trip_is_bit_identical(hcase):
    """The reference's doubly stacked leaves ((periods, n, ...) for
    ``mamba``, ``moe`` and ``mlp``; (periods, attn_every, d) norms) load
    into the period modules and come back bit for bit."""
    c = hcase
    n = c.cfg.attn_every
    lay = c.arrays["layers"]
    assert lay["mamba"]["in_proj"]["w"].shape[:2] == (c.cfg.n_layers // n,
                                                      n - 1)
    assert lay["moe"]["wi"].shape[1] == n // 2 == lay["mlp"]["wi"]["w"].shape[1]
    blk = c.model.layers[0]
    assert (len(blk.mamba), len(blk.moe), len(blk.mlp)) == (n - 1, n // 2,
                                                            n // 2)
    assert blk.moe_at == tuple(i % 2 == 1 for i in range(n))
    np.testing.assert_array_equal(blk.moe[1].wi.detach().numpy(),
                                  lay["moe"]["wi"][0, 1])
    np.testing.assert_array_equal(blk.mamba[2].a_log.detach().numpy(),
                                  lay["mamba"]["a_log"][0, 2])
    test_family_round_trip_is_bit_identical(c)


def test_hybrid_forward_and_loss_match_reference(hcase):
    c = hcase
    r_logits, r_aux = jax.jit(lambda p, bt: RT.forward(p, c.r_cfg, bt))(
        c.r_params, _to(c.batch, "jax"))
    logits, aux = c.model(_to(c.batch, "torch"))
    assert logits.shape == (B, S, c.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), **TOL)
    assert float(r_aux) > 0
    np.testing.assert_allclose(float(aux), float(r_aux), **TOL)
    r_loss, r_parts = jax.jit(lambda p, bt: RT.loss_fn(p, c.r_cfg, bt))(
        c.r_params, _to(c.batch, "jax"))
    loss, parts = c.model.loss_fn(_to(c.batch, "torch"))
    np.testing.assert_allclose(float(loss), float(r_loss), **TOL)
    np.testing.assert_allclose(float(parts["ce"]), float(r_parts["ce"]),
                               **TOL)


def test_hybrid_prefill_and_decode_match_reference(hcase):
    """Prefill's logits, K/V and every Mamba state ((periods, n - 1, B,
    di, N) float32 and (periods, n - 1, B, W - 1, di)), then decode steps,
    as the reference's."""
    c = hcase
    cache = c.model.init_cache(B, 8)
    n = c.cfg.attn_every - 1
    di = c.cfg.d_model * c.cfg.ssm_expand
    assert cache["mamba"]["h"].shape == (c.cfg.n_layers // (n + 1), n, B, di,
                                         c.cfg.ssm_state_dim)
    assert cache["mamba"]["h"].dtype == torch.float32
    assert cache["mamba"]["conv"].shape == (c.cfg.n_layers // (n + 1), n, B,
                                            c.cfg.ssm_conv_width - 1, di)
    _prefill_and_decode_match_reference(c)


def test_hybrid_decode_matches_forward(hcase):
    """The reference's ``test_decode_matches_forward`` for jamba: at
    capacity factor 16 no expert drops a token, so the 2-token decode
    routes as the 32-token forward does."""
    hcase.model.cfg = dataclasses.replace(hcase.cfg, capacity_factor=16.0)
    try:
        test_family_decode_matches_forward(hcase)
    finally:
        hcase.model.cfg = hcase.cfg


def test_hybrid_engine_generate_matches_reference():
    """Greedy tokens of the reference's engine: left-padded prompts
    through the Mamba states, the attention cache and the MoE routing."""
    c = HybridCase("3:1")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, c.cfg.vocab_size, n).tolist()
               for n in (12, 7, 3)]
    want = REngine(c.r_cfg, c.r_params, RServeConfig(batch=4, max_seq=40)
                   ).generate(prompts, 6)
    eng = Engine(c.cfg, c.model, ServeConfig(batch=4, max_seq=40),
                 device=CPU)
    assert eng.generate(prompts, 6) == want


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_hybrid_loss_under_remat(hcase, remat):
    """The Mamba's scan under autograd (out of place) and the periods
    rematerialised give the loss and gradients of ``remat="none"``."""
    test_family_loss_under_remat(hcase, remat)
