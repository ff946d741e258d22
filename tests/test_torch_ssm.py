"""The port's Mamba mixer (``repro_torch/models/ssm.py``) against the
reference's (``repro/models/ssm.py``), on the CPU.

Each mixer gets the reference's ``mamba_init`` weights at reduced jamba's
size (d_model 64, expansion 2: di 128, state 16, conv width 4) with
``dt_bias``, ``d_skip`` and ``a_log`` replaced by seeded numpy values
(zeros, ones and log(1..N) at init would leave them barely tested), and
the same numpy inputs.  Float32 is held to 1e-5: ``mamba_train`` at
chunks 4 and 256 (several chunks, and one chunk of S), ``_causal_conv``,
decode steps from a non-zero cache, and the chunked scan's terminal state
against the reference's unchunked ``_mamba_terminal_state``.  bf16
compute is held at the tolerance the model tests use for bf16 (0.06).
The reference's own ``test_mamba_decode_matches_train_tail`` runs on the
port, and the log-depth scan is held to the plain recurrence, with and
without autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import ssm as S

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.06, rtol=0.06)
B = 2
ARCH = "jamba-1.5-large-398b"


def _cfgs():
    return r_reduced(r_get_config(ARCH)), reduced(get_config(ARCH))


def _weights(r_cfg, seed=0):
    p = jax.tree.map(np.array, RS.mamba_init(jax.random.PRNGKey(seed),
                                             r_cfg.d_model, r_cfg,
                                             jnp.float32))
    rng = np.random.default_rng(seed + 100)
    p["dt_bias"] = rng.normal(scale=0.5, size=p["dt_bias"].shape
                              ).astype(np.float32)
    p["d_skip"] = (1.0 + 0.3 * rng.normal(size=p["d_skip"].shape)
                   ).astype(np.float32)
    p["a_log"] = (p["a_log"] + 0.1 * rng.normal(size=p["a_log"].shape)
                  ).astype(np.float32)
    return p


def _module(cfg, arrays):
    m = S.Mamba(cfg.d_model, cfg, device="cpu")
    params = dict(m.named_parameters())
    flat = {}
    for k, v in arrays.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{leaf}": a for leaf, a in v.items()})
        else:
            flat[k] = v
    assert set(flat) == set(params)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(torch.from_numpy(flat[k]))
    return m


def _x(cfg, s, seed=1, b=B, d=None):
    return np.random.default_rng(seed).normal(
        size=(b, s, d or cfg.d_model)).astype(np.float32)


def _cache(cfg, seed=2):
    rng = np.random.default_rng(seed)
    di = cfg.d_model * cfg.ssm_expand
    return {"h": rng.normal(size=(B, di, cfg.ssm_state_dim)
                            ).astype(np.float32),
            "conv": rng.normal(size=(B, cfg.ssm_conv_width - 1, di)
                               ).astype(np.float32)}


@pytest.mark.parametrize("chunk", [4, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@torch.no_grad()
def test_mamba_train_matches_reference(chunk, dtype):
    r_cfg, cfg = _cfgs()
    arrays = _weights(r_cfg)
    x = _x(cfg, 32)
    want = RS.mamba_train(jax.tree.map(jnp.asarray, arrays),
                          jnp.asarray(x).astype(dtype), r_cfg, chunk=chunk)
    got = S.mamba_train(_module(cfg, arrays),
                        torch.from_numpy(x).to(getattr(torch, dtype)), cfg,
                        chunk=chunk)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **(TOL if dtype == "float32" else BF16_TOL))


def test_causal_conv_matches_reference():
    r_cfg, cfg = _cfgs()
    x = _x(cfg, 9, d=128)
    w = np.random.default_rng(3).normal(size=(4, 128)).astype(np.float32)
    want = RS._causal_conv(jnp.asarray(x), jnp.asarray(w))
    got = S._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # causal: the first output sees only the first input, through tap W-1
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 0] * w[-1], **TOL)


@torch.no_grad()
def test_mamba_decode_steps_match_reference():
    """Four steps from a non-zero cache: outputs and both cache leaves."""
    r_cfg, cfg = _cfgs()
    arrays = _weights(r_cfg)
    m = _module(cfg, arrays)
    r_p = jax.tree.map(jnp.asarray, arrays)
    x = _x(cfg, 4, seed=4)
    init = _cache(cfg)
    r_cache = jax.tree.map(jnp.asarray, init)
    cache = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    for t in range(4):
        want, r_cache = RS.mamba_decode(r_p, jnp.asarray(x[:, t:t + 1]),
                                        r_cfg, r_cache)
        got, cache = S.mamba_decode(m, torch.from_numpy(x[:, t:t + 1]), cfg,
                                    cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"step {t}", **TOL)
        for k in ("h", "conv"):
            assert cache[k].dtype == torch.float32
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(r_cache[k]),
                                       err_msg=f"{k}, step {t}", **TOL)


@pytest.mark.parametrize("s", [12, 32])
@torch.no_grad()
def test_terminal_state_matches_reference(s):
    """The chunked scan's last carry and the last W - 1 pre-conv
    projections, against the reference's unchunked recomputation."""
    r_cfg, cfg = _cfgs()
    arrays = _weights(r_cfg)
    x = _x(cfg, s, seed=5)
    want = RT._mamba_terminal_state(jax.tree.map(jnp.asarray, arrays),
                                    jnp.asarray(x), r_cfg)
    _, got = S.mamba_train(_module(cfg, arrays), torch.from_numpy(x), cfg,
                           chunk=4, return_state=True)
    assert set(got) == set(want)
    for k in ("h", "conv"):
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


@torch.no_grad()
def test_mamba_decode_matches_train_tail():
    """The reference's ``test_mamba_decode_matches_train_tail`` on the
    port: decode replayed over 12 tokens from the zero cache continues
    the chunked train scan (chunk 4), at the reference's tolerance; the
    replay's last state is the train scan's terminal state."""
    r_cfg, cfg = _cfgs()
    m = _module(cfg, jax.tree.map(np.array, RS.mamba_init(
        jax.random.PRNGKey(0), r_cfg.d_model, r_cfg, jnp.float32)))
    x = torch.from_numpy(_x(cfg, 12, seed=6))
    y_full, state = S.mamba_train(m, x, cfg, chunk=4, return_state=True)
    cache = S.mamba_init_cache(B, cfg.d_model, cfg)
    ys = []
    for t in range(12):
        y1, cache = S.mamba_decode(m, x[:, t:t + 1], cfg, cache)
        ys.append(y1)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_full.numpy(),
                               atol=1e-4, rtol=1e-3)
    for k in ("h", "conv"):
        np.testing.assert_allclose(cache[k].numpy(), state[k].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_init_cache_and_chunk_rule():
    r_cfg, cfg = _cfgs()
    cache = S.mamba_init_cache(3, cfg.d_model, cfg, torch.bfloat16)
    want = RS.mamba_init_cache(3, r_cfg.d_model, r_cfg, jnp.bfloat16)
    for k in ("h", "conv"):
        assert tuple(cache[k].shape) == want[k].shape
        assert str(cache[k].dtype).split(".")[1] == str(want[k].dtype)
        assert not cache[k].any()
    m = _module(cfg, _weights(r_cfg))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        S.mamba_train(m, torch.zeros((B, 12, cfg.d_model)), cfg, chunk=8)


@pytest.mark.parametrize("length", [1, 7, 16, 256])
def test_scan_pairs_is_the_recurrence(length):
    """The log-depth scan from any start state equals the step-by-step
    recurrence ``h' = a·h + b``; the write-back form (no autograd) and
    the ``torch.cat`` one (autograd) give the same bits."""
    rng = np.random.default_rng(length)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, length, 3, 4))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, length, 3, 4))
                         .astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32))
    with torch.no_grad():
        a_cum, b_cum = S.scan_pairs(a.clone(), b.clone())
    a_g, b_g = S.scan_pairs(a.clone().requires_grad_(),
                            b.clone().requires_grad_())
    assert torch.equal(a_g.detach(), a_cum) and \
        torch.equal(b_g.detach(), b_cum)
    h = h0
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose((a_cum[:, t] * h0 + b_cum[:, t]).numpy(),
                                   h.numpy(), err_msg=f"t={t}", **TOL)
