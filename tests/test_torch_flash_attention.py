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
from repro_torch.kernels.flash_attention import (attention_error_ratios,
                                                 flash_attention_fwd,
                                                 flash_attention_fwd_plain,
                                                 variant)
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


# --- the wgmma variant's rounding (p to bf16 before p·v) and its rule ---

def _bf16(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


@pytest.mark.parametrize("b,s,h,d,causal,chunk", SWEEP)
def test_round_p_equals_default_in_f32(b, s, h, d, causal, chunk):
    q, k, v = (torch.from_numpy(a) for a in _qkv(200 + s, b, s, h, d))
    want = flash_attention_fwd_plain(q, k, v, causal=causal, q_chunk=chunk)
    got = flash_attention_fwd_plain(q, k, v, causal=causal, q_chunk=chunk,
                                    round_p=True)
    # in float32 nothing is rounded; only the division moves after p·v
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_round_p_bf16_matches_reference_kernel(causal):
    b, s, h, d = 1, 64, 2, 16
    q, k, v = _qkv(11, b, s, h, d)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = r_flash_fwd(jq, jk, jv, causal=causal, q_chunk=16, k_chunk=16,
                       interpret=True)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))
                                   ).to(torch.bfloat16) for a in (jq, jk, jv))
    got = flash_attention_fwd_plain(tq, tk, tv, causal=causal, round_p=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.06, rtol=0.06)


def _tiled_round_p(q, k, v, causal, tile):
    """A float32 model of the wgmma kernel's arithmetic: key tiles of
    ``tile``, scores in log2 units, p rounded to bf16 against the running
    max, the denominator from the float32 p."""
    b, sq, h, d = q.shape
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    c = 1.4426950408889634 / d ** 0.5
    m = torch.full((b, h, sq, 1), -float("inf"))
    den = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[1], tile):
        s = torch.matmul(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2)) * c
        kpos = torch.arange(k0, k0 + s.shape[-1])[None, :]
        if causal:
            s = s.masked_fill(kpos > qpos, -float("inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(),
                                         vf[:, :, k0:k0 + tile])
        m = m_new
    return (acc / den.clamp_min(1e-30)).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("b,sq,sk,h,d,causal,tile",
                         [(1, 256, 256, 2, 64, True, 32),
                          (2, 200, 200, 2, 128, False, 64),
                          (1, 77, 130, 2, 64, True, 128)])
def test_error_rule_passes_round_p_and_a_tiled_model(b, sq, sk, h, d, causal,
                                                     tile):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = _bf16(rng.normal(size=(b, n, h, d)).astype(np.float32)
                    for n in (sq, sk, sk))
    ref = flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                    causal=causal)
    base = flash_attention_fwd_plain(q, k, v, causal=causal, round_p=True)
    same = attention_error_ratios(base, ref, base)
    assert same["ok"] and same["max_ratio"] < 0.51 and same["mean_ratio"] == 0.5
    model = attention_error_ratios(_tiled_round_p(q, k, v, causal, tile),
                                   ref, base)
    assert model["ok"], model


def _wrong_outputs(q, k, v):
    """Two kernels that must fail the rule: the softmax scale times 1.01,
    and the diagonal key dropped from the causal mask."""
    b, s, h, d = q.shape
    scaled = flash_attention_fwd_plain(q.float() * 1.01, k.float(), v.float())
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    sc = torch.matmul(qf, kf.transpose(-1, -2)) / d ** 0.5
    pos = torch.arange(s)
    sc = sc.masked_fill(pos[:, None] <= pos[None, :], -1e30)
    no_diag = torch.matmul(torch.softmax(sc, -1), vf).transpose(1, 2)
    return {"scale_x1.01": scaled.to(torch.bfloat16),
            "no_diagonal": no_diag.to(torch.bfloat16)}


@pytest.mark.parametrize("case", ["scale_x1.01", "no_diagonal"])
@pytest.mark.parametrize("shape", [(1, 256, 2, 64), (1, 128, 2, 128)])
def test_error_rule_fails_wrong_outputs(case, shape):
    rng = np.random.default_rng(1)
    q, k, v = _bf16(rng.normal(size=shape).astype(np.float32)
                    for _ in range(3))
    ref = flash_attention_fwd_plain(q.float(), k.float(), v.float())
    base = flash_attention_fwd_plain(q, k, v, round_p=True)
    r = attention_error_ratios(_wrong_outputs(q, k, v)[case], ref, base)
    assert not r["ok"], r


def test_variant_is_chosen_by_dtype_and_head_dim():
    assert variant(torch.bfloat16, 128) == variant(torch.bfloat16, 64) \
        == "sm90_wgmma"
    for dtype, d in [(torch.float32, 128), (torch.float32, 64),
                     (torch.bfloat16, 32), (torch.bfloat16, 8)]:
        assert variant(dtype, d) == "cuda_core"
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    before = dict(flash_attention_fwd.launches_by_variant)
    flash_attention_fwd(q, q, q)                 # CPU: the plain version
    assert flash_attention_fwd.launches_by_variant == before


@pytest.mark.parametrize("shape,k_len,causal,pairs", [
    ((2, 32768, 1, 128), 32768, True, 32768 * 32769 // 2),
    ((4, 416, 12, 64), 1536, False, 416 * 1536),
    ((1, 100, 2, 32), 60, True, 60 * 61 // 2 + 40 * 60)])
def test_meta_call_gives_the_shape_counts_flops_and_no_launch(
        shape, k_len, causal, pairs):
    """On the meta device K4 returns an empty tensor of the output's shape
    through its custom op, launches nothing, and ``FlopCounterMode``
    counts its formula, 4·D·B·H × the scored pairs (causal: qpos >= kpos)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import flash_attention as fa
    b, sq, h, d = shape
    q = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, k_len, h, d), dtype=torch.bfloat16, device="meta")
    before = (fa.flash_attention_fwd.launches,
              dict(fa.flash_attention_fwd.launches_by_variant))
    with FlopCounterMode(display=False) as fc:
        out = fa.flash_attention_fwd(q, k, k, causal=causal)
    assert out.device.type == "meta" and out.shape == shape
    assert out.dtype == torch.bfloat16
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_fwd.launches_by_variant) == before
    assert fc.get_total_flops() == fa.attention_flops(shape, k.shape,
                                                      causal) \
        == 4 * d * b * h * pairs
    assert torch.ops.repro_torch.flash_attention_fwd(q, k, k, causal).shape \
        == shape


class _Elsewhere:
    """A (B, S, H, D) stand-in on a device with no K4 kernel."""
    dtype, shape, device = torch.bfloat16, (1, 8, 1, 64), torch.device("xpu")

    def dim(self):
        return 4


def test_other_devices_raise_and_the_op_has_no_cpu_kernel():
    from repro_torch.kernels import flash_attention as fa
    x = _Elsewhere()
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        fa.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        fa.launch("sm90_wgmma", x, x, x)
    # the CPU takes the plain version in the wrapper, never the op
    q = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_attention_fwd(q, q, q, True)
