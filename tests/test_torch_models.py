"""The port's dense transformer against the reference, on the CPU.

Small configs (``reduced``: 2 layers, d_model 64, 4 heads, 2 KV heads,
head_dim 16, vocab 256).  Both packages load the same weights: the
reference's ``init_params(PRNGKey(0))`` with every bias and norm parameter
replaced by seeded numpy values (``_torch_oracles.lm_arrays``), and the same
numpy tokens.  Float32 results agree to 1e-4: two layers of float32
matrix products summed in another order than XLA's.  The reference's jitted
functions compile once per config (module-scoped fixtures).
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
from repro.models import transformer as RT
from repro_torch.configs.base import get_config, list_archs, reduced
from repro_torch.models.transformer import Transformer

torch.set_num_threads(2)

CPU = torch.device("cpu")
DENSE = ["qwen2.5-3b", "qwen1.5-4b", "mistral-nemo-12b", "starcoder2-15b"]
MOE = ["grok-1-314b", "qwen3-moe-235b-a22b"]
PARITY = ["qwen2.5-3b", "qwen1.5-4b", "starcoder2-15b"]
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
    return Case(request.param)


@pytest.mark.parametrize("arch", DENSE + MOE)
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
    """The dense and MoE configs; the other families are not ported yet."""
    assert list_archs() == tuple(sorted(DENSE + MOE))
    for arch in ("jamba-1.5-large-398b", "xlstm-350m", "whisper-small",
                 "internvl2-26b"):
        with pytest.raises(KeyError, match="Queue 1 item 15"):
            get_config(arch)


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
    jamba = r_reduced(r_get_config("jamba-1.5-large-398b"))
    assert jamba.family == "hybrid" and jamba.n_experts > 0
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        Transformer(jamba, device=CPU)
    hybrid = dataclasses.replace(reduced(get_config("qwen2.5-3b")),
                                 family="hybrid")
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        Transformer(hybrid, device=CPU)


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
