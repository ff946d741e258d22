"""The port's MoE (``repro_torch/models/moe.py``) and the MoE models against
the reference, on the CPU.

The layer: the reference's ``moe_init`` weights and the same numpy inputs
through ``repro.models.moe.moe_apply_sorted`` and the port's ``moe_apply``,
for reduced qwen3-moe and grok-1 (4 experts, top 2, float32) at capacity
factors 16, 1.25, 1.0 and 0.5, at T = B (capacity 1, as a decode step), at
a T whose capacity rounds up to 384, and with a zero router (every
probability ties, so the top-k order and the drops are decided by the
tie-breaking and the stable sort alone).  The reference's routing is read
from its own run: the top-k, the argsort, the (E, C, d) buckets and the
combine's contributions and segment ids.  Held exactly: the experts picked,
the sorted order, the bucket tokens, which assignments are kept.  Held to
1e-5: the output and the aux loss; the gradients to ``atol 1e-5 + rtol
1e-4`` of ``jax.grad``'s.

The model: reduced MoE configs with the reference's ``init_params``
weights (biases and norms perturbed, ``_torch_oracles.lm_arrays``):
``from_arrays`` / ``to_arrays`` exact, ``forward``'s logits and aux within
1e-5, ``prefill`` then ``decode_step`` as the reference's
``test_decode_matches_forward`` case (capacity factor 16), and
``Engine.generate``'s greedy tokens equal to the reference's.
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
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.serve.engine import Engine as REngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import moe
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(2)

CPU = torch.device("cpu")
ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)

# (capacity factor, batch, seq, router)
LAYER_CASES = [
    (16.0, 2, 8, "normal"),      # no assignment drops at any T
    (1.25, 2, 8, "normal"),      # the configs' own factor
    (1.0, 4, 16, "normal"),
    (0.5, 4, 16, "normal"),      # about half the assignments drop
    (1.25, 8, 64, "normal"),     # T = 512: capacity 320, rounded up to 384
    (1.25, 2, 1, "normal"),      # T = B: capacity 1, as a decode step
    (0.5, 4, 16, "zero"),        # every probability ties
    (1.25, 2, 1, "zero"),
]
LAYER_IDS = [f"cf{cf}-T{b * s}-{r}" for cf, b, s, r in LAYER_CASES]


def _layer_inputs(arch, cf, b, s, router, seed=0):
    """The reference's and the port's configs, the reference's weights
    (numpy) and the input (numpy)."""
    r_cfg = r_reduced(r_get_config(arch), capacity_factor=cf)
    cfg = reduced(get_config(arch), capacity_factor=cf)
    p = jax.tree.map(np.array, RM.moe_init(
        jax.random.PRNGKey(seed), r_cfg.d_model, r_cfg.d_ff,
        r_cfg.n_experts, r_cfg.act, jnp.float32))
    if router == "zero":
        p["router"]["w"][:] = 0.0
    x = np.random.default_rng(seed).normal(
        size=(b, s, r_cfg.d_model)).astype(np.float32)
    return r_cfg, cfg, p, x


def _port_layer(cfg, p):
    layer = moe.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.act,
                    device=CPU)
    with torch.no_grad():
        layer.router.w.copy_(torch.from_numpy(p["router"]["w"]))
        for name in ("wi", "wg", "wo"):
            if name in p:
                getattr(layer, name).copy_(torch.from_numpy(p[name]))
    return layer


def _reference_run(monkeypatch, r_cfg, p, x):
    """The reference's ``moe_apply_sorted`` run eagerly, with the arrays
    its routing made: top-k, argsort, buckets, combine inputs."""
    seen = {}

    def record(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(name, (args, out))
            return out
        return wrapped

    monkeypatch.setattr(jax.lax, "top_k", record("top_k", jax.lax.top_k))
    monkeypatch.setattr(jnp, "argsort", record("argsort", jnp.argsort))
    monkeypatch.setattr(jax.ops, "segment_sum",
                        record("segment_sum", jax.ops.segment_sum))
    monkeypatch.setattr(RM, "shard", record("shard", RM.shard))
    out, aux = RM.moe_apply_sorted(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), r_cfg)
    monkeypatch.undo()
    xf = x.reshape(-1, x.shape[-1])
    xe = np.asarray(seen["shard"][1])                        # (E, C, d)
    valid = np.any(xe != 0, axis=-1)
    row_of = {xf[i].tobytes(): i for i in range(len(xf))}
    bucket_tok = np.where(valid, [[row_of.get(r.tobytes(), -1) for r in e]
                                  for e in xe], 0)
    (contrib, seg_ids), _ = seen["segment_sum"]
    return {"out": np.asarray(out), "aux": float(aux),
            "gate_idx": np.asarray(seen["top_k"][1][1]),
            "order": np.asarray(seen["argsort"][1]),
            "token": np.asarray(seg_ids),
            "keep": np.any(np.asarray(contrib) != 0, axis=-1),
            "bucket_tok": bucket_tok, "bucket_valid": valid}


@pytest.mark.parametrize("case", LAYER_CASES, ids=LAYER_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_output_match_reference(monkeypatch, arch, case):
    r_cfg, cfg, p, x = _layer_inputs(arch, *case)
    want = _reference_run(monkeypatch, r_cfg, p, x)
    layer = _port_layer(cfg, p)
    with torch.no_grad():
        r = moe.route(layer, torch.from_numpy(x), cfg)
        out, aux = moe.moe_apply(layer, torch.from_numpy(x), cfg)
    assert r.capacity == want["bucket_tok"].shape[1]
    np.testing.assert_array_equal(r.gate_idx.numpy(), want["gate_idx"])
    np.testing.assert_array_equal(r.order.numpy(), want["order"])
    np.testing.assert_array_equal(r.token.numpy(), want["token"])
    np.testing.assert_array_equal(r.keep.numpy(), want["keep"])
    np.testing.assert_array_equal(r.bucket_valid.numpy(),
                                  want["bucket_valid"])
    np.testing.assert_array_equal(r.bucket_tok.numpy(), want["bucket_tok"])
    np.testing.assert_allclose(out.numpy(), want["out"], **TOL)
    np.testing.assert_allclose(float(aux), want["aux"], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cases_drop_and_round_up_as_intended(arch):
    """The layer cases exercise what they name: drops at factors below 16,
    none at 16, the round-up past 128, capacity 1 at T = B, and a zero
    router that sends every token to experts 0..k-1 in order."""
    drops = {}
    for case, name in zip(LAYER_CASES, LAYER_IDS):
        _, cfg, p, x = _layer_inputs(arch, *case)
        with torch.no_grad():
            r = moe.route(_port_layer(cfg, p), torch.from_numpy(x), cfg)
        drops[name] = int((~r.keep).sum())
        if case[3] == "zero":
            k = cfg.experts_per_token
            assert torch.equal(r.gate_idx, torch.arange(k).expand_as(
                r.gate_idx))
    assert drops["cf16.0-T16-normal"] == 0
    assert drops["cf0.5-T64-normal"] > 0 and drops["cf0.5-T64-zero"] > 0
    assert drops["cf1.25-T2-zero"] > 0
    cfg = reduced(get_config(arch))
    assert moe.capacity(512, cfg) == 384 and moe.capacity(2, cfg) == 1
    full = get_config(arch)
    # the card's prefill (4 x 2048 tokens) and a decode step of batch 4
    assert moe.capacity(8192, full) == {"qwen3-moe-235b-a22b": 640,
                                        "grok-1-314b": 2560}[arch]
    assert moe.capacity(4, full) == 1


@pytest.mark.parametrize("case", LAYER_CASES, ids=LAYER_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch, case):
    r_cfg, cfg, p, x = _layer_inputs(arch, *case)
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def r_loss(p, x):
        out, aux = RM.moe_apply_sorted(p, x, r_cfg)
        return jnp.sum(out * w) + aux

    r_gp, r_gx = jax.grad(r_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    layer = _port_layer(cfg, p)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(layer, xt, cfg)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(r_gx),
                               **GRAD_TOL)
    np.testing.assert_allclose(layer.router.w.grad.numpy(),
                               np.asarray(r_gp["router"]["w"]), **GRAD_TOL)
    for name in ("wi", "wg", "wo"):
        if name in p:
            np.testing.assert_allclose(getattr(layer, name).grad.numpy(),
                                       np.asarray(r_gp[name]), **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_tp_without_a_group_is_the_sorted_path(monkeypatch, arch):
    r_cfg, cfg, p, x = _layer_inputs(arch, 0.5, 4, 16, "normal")
    layer = _port_layer(cfg, p)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        want, want_aux = moe.moe_apply_sorted(layer, xt, cfg)
        got, aux = moe.moe_apply(
            layer, xt, dataclasses.replace(cfg, moe_impl="expert_tp"))
        with pytest.raises(ValueError, match="moe_impl"):
            moe.moe_apply(layer, xt, dataclasses.replace(cfg,
                                                         moe_impl="dense"))
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    r_out, r_aux = RM.moe_apply(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        dataclasses.replace(r_cfg, moe_impl="expert_tp"))
    np.testing.assert_allclose(got.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_allclose(float(aux), float(r_aux), **TOL)


def test_gelu_experts_match_reference(monkeypatch):
    """``act="gelu"`` (no ``wg``): jax.nn.gelu's tanh form."""
    r_cfg, cfg, p, x = _layer_inputs("grok-1-314b", 1.0, 4, 16, "normal")
    r_cfg = dataclasses.replace(r_cfg, act="gelu")
    cfg = dataclasses.replace(cfg, act="gelu")
    del p["wg"]
    want = _reference_run(monkeypatch, r_cfg, p, x)
    layer = _port_layer(cfg, p)
    assert layer.wg is None
    with torch.no_grad():
        out, aux = moe.moe_apply(layer, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), want["out"], **TOL)
    np.testing.assert_allclose(float(aux), want["aux"], **TOL)


# ---------------------------------------------------------------------------
# the MoE models
# ---------------------------------------------------------------------------

B, S = 2, 16
PROMPTS = [[1, 2, 3], [4, 5]]
NEW = 5


class Case:
    """One reduced MoE config in both packages, its weights and tokens."""

    def __init__(self, arch, **overrides):
        self.r_cfg = r_reduced(r_get_config(arch), **overrides)
        self.cfg = reduced(get_config(arch), **overrides)
        self.arrays = lm_arrays(self.r_cfg)
        self.r_params = jax.tree.map(jnp.asarray, self.arrays)
        self.model = Transformer.from_arrays(self.cfg, self.arrays,
                                             device=CPU)
        self.tokens = np.random.default_rng(0).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


@pytest.fixture(scope="module", params=ARCHS)
def no_drop_case(request):
    return Case(request.param, capacity_factor=16.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_model_builds(arch):
    """The full configs build (on the meta device: no storage) with the
    reference's expert shapes and parameter count plus the norms."""
    cfg = get_config(arch)
    model = Transformer(cfg, device="meta")
    assert len(model.layers) == cfg.n_layers
    blk = model.layers[0]
    assert blk.mlp is None
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert blk.moe.router.w.shape == (d, e)
    assert blk.moe.router.w.dtype == torch.float32
    assert blk.moe.wi.shape == blk.moe.wg.shape == (e, d, f)
    assert blk.moe.wo.shape == (e, f, d)
    assert blk.moe.wi.dtype == torch.bfloat16
    n_norm = (2 * cfg.n_layers + 1) * d
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + n_norm


def test_round_trip_is_bit_identical(case):
    flat = dict(jax.tree_util.tree_leaves_with_path(case.arrays))
    assert any("moe" in jax.tree_util.keystr(k) for k in flat)
    back = dict(jax.tree_util.tree_leaves_with_path(case.model.to_arrays()))
    assert set(back) == set(flat)
    for path, a in flat.items():
        b = back[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def test_forward_matches_reference(case):
    r_logits, r_aux = jax.jit(lambda p, t: RT.forward(
        p, case.r_cfg, {"tokens": t}))(case.r_params,
                                       jnp.asarray(case.tokens))
    logits, aux = case.model({"tokens": torch.from_numpy(case.tokens)})
    assert float(aux) > 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), **TOL)
    np.testing.assert_allclose(float(aux), float(r_aux), **TOL)


def test_decode_matches_forward_and_reference(no_drop_case):
    """The reference's ``test_decode_matches_forward`` case (capacity factor
    16, so no assignment drops at any T): decode after prefill equals the
    teacher-forced forward at that test's tolerance, and the reference's
    decode logits within 1e-5."""
    c = no_drop_case
    tokens = torch.from_numpy(c.tokens)
    full, _ = c.model({"tokens": tokens})
    _, cache = c.model.prefill({"tokens": tokens[:, :-1]}, S + 4)
    dec, _ = c.model.decode_step(cache, tokens[:, -1:], S - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-4, rtol=2e-3)
    _, r_cache = RT.prefill(c.r_params, c.r_cfg,
                            {"tokens": jnp.asarray(c.tokens[:, :-1])}, S + 4)
    r_dec, _ = RT.decode_step(c.r_params, c.r_cfg, r_cache,
                              jnp.asarray(c.tokens[:, -1:]), jnp.int32(S - 1))
    np.testing.assert_allclose(dec.numpy(), np.asarray(r_dec), **TOL)


def test_greedy_generate_matches_reference(monkeypatch, case):
    """At the configs' own capacity factor: the decode steps (T = 2,
    capacity 1) drop assignments, as the reference's do."""
    want = REngine(case.r_cfg, case.r_params,
                   RServeConfig(batch=2, max_seq=48)).generate(
                       PROMPTS, max_new_tokens=NEW)
    eng = Engine(case.cfg, case.model, ServeConfig(batch=2, max_seq=48),
                 device=CPU)
    real, drops = moe.route, []

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        drops.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(moe, "route", spy)
    got = eng.generate(PROMPTS, max_new_tokens=NEW)
    assert got == want
    assert sum(drops) > 0
    assert torch.isfinite(eng.last_logits).all()


def test_init_params_distributions_and_bf16_copy():
    cfg = reduced(get_config("qwen3-moe-235b-a22b"), d_model=256, d_ff=512,
                  n_experts=8)
    model = Transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                    device=CPU)
    again = Transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                    device=CPU)
    for (k, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), k
    m = model.layers[0].moe
    for w, fan_in in ((m.router.w.detach(), 256), (m.wi.detach(), 256),
                      (m.wg.detach(), 256), (m.wo.detach(), 512)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.02
        assert abs(float(w.mean())) < 0.01
    half = model.astype(torch.bfloat16)
    hm = half.layers[0].moe
    assert hm.router.w.dtype == torch.float32
    assert torch.equal(hm.router.w, m.router.w)
    assert hm.wi.dtype == torch.bfloat16
    assert torch.equal(hm.wi, m.wi.to(torch.bfloat16))
