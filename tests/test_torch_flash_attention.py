"""The port's K4 (flash-attention forward) against the reference, on the CPU.

On the CPU the wrapper runs its plain PyTorch version; the reference runs
its Pallas kernel in interpret mode, with the sweep and tolerances of
``tests/test_kernels.py``, and its pure-XLA chunked attention
(``repro.models.attention.flash_attention``), which K4 replaces on the
model's path.  The kernel itself is held against the plain version on the
card by ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as r_flash_fwd
from repro.models.attention import flash_attention as r_flash_xla
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_fwd_plain)
from repro_torch.models.attention import flash_attention

torch.set_num_threads(2)

SWEEP = [(2, 64, 3, 16, True, 16),
         (1, 128, 2, 32, False, 32),
         (2, 96, 1, 8, True, 32)]       # non-pow2 seq: the reference fits


def _qkv(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("fn", [flash_attention_fwd, flash_attention_fwd_plain],
                         ids=["wrapper", "plain"])
@pytest.mark.parametrize("b,s,h,d,causal,chunk", SWEEP)
def test_matches_reference_kernel_f32(fn, b, s, h, d, causal, chunk):
    q, k, v = _qkv(s + d, b, s, h, d)
    want = r_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, q_chunk=chunk, k_chunk=chunk,
                       interpret=True)
    before = flash_attention_fwd.launches
    got = fn(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
             q_chunk=chunk, k_chunk=chunk)
    assert flash_attention_fwd.launches == before   # CPU: no kernel launch
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fn", [flash_attention_fwd, flash_attention_fwd_plain],
                         ids=["wrapper", "plain"])
def test_matches_reference_kernel_bf16(fn):
    b, s, h, d = 1, 64, 2, 16
    q, k, v = _qkv(7, b, s, h, d)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = r_flash_fwd(jq, jk, jv, causal=True, q_chunk=16, k_chunk=16,
                       interpret=True)
    # the same bf16 values on both sides (numpy has no bf16: go via f32)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))
                                   ).to(torch.bfloat16) for a in (jq, jk, jv))
    got = fn(tq, tk, tv, causal=True, q_chunk=16, k_chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.06, rtol=0.06)


@pytest.mark.parametrize("b,s,h,d,causal,chunk", SWEEP)
def test_matches_reference_xla_attention_f32(b, s, h, d, causal, chunk):
    q, k, v = _qkv(100 + s, b, s, h, d)
    want = r_flash_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, q_chunk=chunk, k_chunk=chunk)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, q_chunk=chunk, k_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_plain_chunking_changes_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 50, 2, 8))
    whole = flash_attention_fwd_plain(q, k, v, q_chunk=64)
    for chunk in (1, 7, 16):
        np.testing.assert_allclose(
            flash_attention_fwd_plain(q, k, v, q_chunk=chunk).numpy(),
            whole.numpy(), atol=1e-6, rtol=1e-6)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="repeat the KV heads"):
        flash_attention_fwd(q, torch.zeros((1, 8, 2, 16)),
                            torch.zeros((1, 8, 2, 16)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_fwd(q.long(), q.long(), q.long())
    with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
        flash_attention_fwd(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="share a dtype"):
        flash_attention_fwd(q, q.bfloat16(), q)
