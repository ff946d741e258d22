"""The port's xLSTM blocks (``repro_torch/models/xlstm.py``) against the
reference's (``repro/models/xlstm.py``), on the CPU.

Each block gets the reference's ``mlstm_init`` / ``slstm_init`` weights
with the gate biases replaced by seeded numpy values (zeros at init would
leave them untested), a reduced xlstm-350m config (d_model 64, 4 heads,
expansion 2: di 128, dk 32) and the same numpy inputs in float32.  Held
to 1e-5: ``mlstm_train`` / ``slstm_train`` outputs and terminal states at
S a multiple of the chunk (several chunks) and at S < chunk (one chunk
of S), one ``*_decode`` step from a non-zero state, and the zero caches
exactly.  The chunk-against-step tests hold the port to itself: the
chunked ``mlstm_train`` (and the scan of ``slstm_train``) against a
token-by-token replay of ``*_decode`` from the zero cache, outputs and
terminal states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import xlstm as RX
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import xlstm as X

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
B = 2


def _cfgs():
    return (r_reduced(r_get_config("xlstm-350m")),
            reduced(get_config("xlstm-350m")))


def _weights(kind, r_cfg, seed=0):
    init = RX.mlstm_init if kind == "mlstm" else RX.slstm_init
    p = jax.tree.map(np.array, init(jax.random.PRNGKey(seed), r_cfg.d_model,
                                    r_cfg, jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for leaf in p.values():
        if "b" in leaf:
            leaf["b"] = rng.normal(scale=0.5, size=leaf["b"].shape
                                   ).astype(np.float32)
    return p


def _module(kind, cfg, arrays):
    cls = X.mLSTM if kind == "mlstm" else X.sLSTM
    m = cls(cfg.d_model, cfg, device="cpu")
    params = dict(m.named_parameters())
    flat = {f"{k}.{leaf}": a for k, d in arrays.items()
            for leaf, a in d.items()}
    assert set(flat) == set(params)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(torch.from_numpy(flat[k]))
    return m.requires_grad_(False)


def _x(cfg, s, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, s, cfg.d_model)).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


def _states_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        _close(got[k], want[k], f"{what} state {k}")


# (S, chunk): several chunks; one chunk of S < 128; the default chunk
CHUNK_CASES = [(32, 8), (24, 128), (256, 128)]


@pytest.mark.parametrize("s,chunk", CHUNK_CASES)
def test_mlstm_train_matches_reference(s, chunk):
    r_cfg, cfg = _cfgs()
    p = _weights("mlstm", r_cfg)
    x = _x(cfg, s)
    r_out, r_st = RX.mlstm_train(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), r_cfg, chunk=chunk,
                                 return_state=True)
    m = _module("mlstm", cfg, p)
    out, st = X.mlstm_train(m, torch.from_numpy(x), cfg, chunk=chunk,
                            return_state=True)
    _close(out, r_out, "output")
    _states_close(st, r_st, "terminal")
    plain = X.mlstm_train(m, torch.from_numpy(x), cfg, chunk=chunk)
    assert torch.equal(plain, out)


@pytest.mark.parametrize("s", [16, 40])
def test_slstm_train_matches_reference(s):
    r_cfg, cfg = _cfgs()
    p = _weights("slstm", r_cfg)
    x = _x(cfg, s)
    r_out, r_st = RX.slstm_train(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), r_cfg, return_state=True)
    m = _module("slstm", cfg, p)
    out, st = X.slstm_train(m, torch.from_numpy(x), cfg, return_state=True)
    _close(out, r_out, "output")
    _states_close(st, r_st, "terminal")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_step_matches_reference(kind):
    """One decode step from the state a 16-token prompt leaves."""
    r_cfg, cfg = _cfgs()
    p = _weights(kind, r_cfg)
    rp = jax.tree.map(jnp.asarray, p)
    train, decode = (RX.mlstm_train, RX.mlstm_decode) if kind == "mlstm" \
        else (RX.slstm_train, RX.slstm_decode)
    _, r_st = train(rp, jnp.asarray(_x(cfg, 16)), r_cfg, return_state=True)
    x1 = _x(cfg, 1, seed=2)
    r_y, r_new = decode(rp, jnp.asarray(x1), r_cfg, r_st)
    m = _module(kind, cfg, p)
    step = X.mlstm_decode if kind == "mlstm" else X.slstm_decode
    cache = {k: torch.from_numpy(np.array(v)) for k, v in r_st.items()}
    y, new = step(m, torch.from_numpy(x1), cfg, cache)
    _close(y, r_y, "output")
    _states_close(new, r_new, "new")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_cache_equals_reference(kind):
    r_cfg, cfg = _cfgs()
    r_init = RX.mlstm_init_cache if kind == "mlstm" else RX.slstm_init_cache
    init = X.mlstm_init_cache if kind == "mlstm" else X.slstm_init_cache
    want = r_init(3, r_cfg.d_model, r_cfg, jnp.bfloat16)
    got = init(3, cfg.d_model, cfg, device="cpu")
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(want[k])), k


def _replay(kind, m, cfg, x):
    """Token-by-token ``*_decode`` from the zero cache -> (outputs, state)."""
    init = X.mlstm_init_cache if kind == "mlstm" else X.slstm_init_cache
    step = X.mlstm_decode if kind == "mlstm" else X.slstm_decode
    cache = init(x.shape[0], cfg.d_model, cfg, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        y, cache = step(m, x[:, t:t + 1], cfg, cache)
        ys.append(y)
    return torch.cat(ys, dim=1), cache


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 128)])
def test_mlstm_chunk_against_step(s, chunk):
    """The chunked form equals the O(1) recurrence, token by token."""
    _, cfg = _cfgs()
    m = _module("mlstm", cfg, _weights("mlstm", _cfgs()[0], seed=3))
    x = torch.from_numpy(_x(cfg, s, seed=4))
    out, st = X.mlstm_train(m, x, cfg, chunk=chunk, return_state=True)
    ys, cache = _replay("mlstm", m, cfg, x)
    np.testing.assert_allclose(out.numpy(), ys.numpy(), **TOL)
    for k in ("c", "n", "m"):
        np.testing.assert_allclose(st[k].numpy(), cache[k].numpy(),
                                   err_msg=k, **TOL)


def test_slstm_chunk_against_step():
    _, cfg = _cfgs()
    m = _module("slstm", cfg, _weights("slstm", _cfgs()[0], seed=3))
    x = torch.from_numpy(_x(cfg, 24, seed=4))
    out, st = X.slstm_train(m, x, cfg, return_state=True)
    ys, cache = _replay("slstm", m, cfg, x)
    np.testing.assert_allclose(out.numpy(), ys.numpy(), **TOL)
    for k in ("c", "n", "h", "m"):
        np.testing.assert_allclose(st[k].numpy(), cache[k].numpy(),
                                   err_msg=k, **TOL)


def test_mlstm_train_rejects_a_ragged_sequence():
    """S must be a multiple of min(chunk, S): the reference asserts it."""
    _, cfg = _cfgs()
    m = _module("mlstm", cfg, _weights("mlstm", _cfgs()[0]))
    x = torch.from_numpy(_x(cfg, 200))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        X.mlstm_train(m, x, cfg)
    X.mlstm_train(m, x[:, :128], cfg)        # a multiple: accepted


def test_mlstm_bf16_compute_matches_reference():
    """bf16 activations: gates and states in float32, as the reference."""
    r_cfg, cfg = _cfgs()
    p = _weights("mlstm", r_cfg)
    x = _x(cfg, 32)
    r_out, r_st = RX.mlstm_train(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x, jnp.bfloat16), r_cfg,
                                 chunk=16, return_state=True)
    out, st = X.mlstm_train(_module("mlstm", cfg, p),
                            torch.from_numpy(x).bfloat16(), cfg, chunk=16,
                            return_state=True)
    assert out.dtype == torch.bfloat16 and st["c"].dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(r_out.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    for k in ("c", "n", "m"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(r_st[k]),
                                   atol=1e-3, rtol=1e-3, err_msg=k)
