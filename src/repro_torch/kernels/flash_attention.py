"""Flash-attention forward: prefill and full-sequence attention, kernel K4.

Counterpart of ``repro/kernels/flash_attention.py``.  Two kernels, chosen
by dtype and head dim (``variant``):

- ``"sm90_wgmma"`` (``csrc/flash_attention_sm90.cu``) for bfloat16 with
  D in {64, 128}: TMA-fed tiles, ``wgmma`` on the tensor cores, one CTA per
  (128-row query tile, batch·head) with two consumer warpgroups and a
  producer warp.  p is rounded to bf16 before p·v, as every tensor-core
  flash kernel and the reference's model attention do.
- ``"cuda_core"`` (``csrc/flash_attention.cu``) for float32, and for
  D in {8, 16, 32}: float32 FMAs, p kept in float32.

Each walks the key tiles up to the diagonal with an online softmax (see
the notes at the top of the sources).  K4 replaces the reference's pure-XLA
chunked attention on the model's path (``models/attention.flash_attention``).

Training differentiates attention (``flash_attention``, an autograd
function): its forward is K4 and its backward, ``flash_attention_bwd``, is
written in PyTorch.  It recomputes the scores from q, k and v a block of
query rows at a time, as autodiff of the reference's chunked attention
does; no Pallas kernel covers the reference's backward either.

The chunk arguments keep the reference's signature.  The kernel's tiles are
fixed; ``q_chunk`` only sets how many query rows the plain version scores at
once, and ``k_chunk`` is unused (the plain version takes whole key rows).
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "plain_grads", "HEAD_DIMS", "SM90_HEAD_DIMS", "VARIANTS",
           "variant", "launch", "attention_error_ratios",
           "grad_error_ratios"]

HEAD_DIMS = (8, 16, 32, 64, 128)   # head dims the kernels are built for
SM90_HEAD_DIMS = (64, 128)         # head dims of the wgmma kernel (bf16)
VARIANTS = ("sm90_wgmma", "cuda_core")
NEG_INF = -1e30
_ENTRY = {("cuda_core", torch.float32): "flash_attention_fwd_f32",
          ("cuda_core", torch.bfloat16): "flash_attention_fwd_bf16",
          ("sm90_wgmma", torch.bfloat16): "flash_attention_fwd_bf16_sm90"}
_BQ = {"cuda_core": 64, "sm90_wgmma": 128}   # query rows per CTA
_MAX_GRID_Y = 65535


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name} must be float32 or bfloat16, got "
                             f"{t.dtype}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, Sk, H, D) matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if k.shape[2] != h:
        raise ValueError(f"q has {h} heads and k/v {k.shape[2]}: repeat the "
                         f"KV heads first")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")
    if k.shape[1] == 0:
        raise ValueError("k and v need at least one key")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous at a 16-byte aligned base: the kernel reads 16-byte
    vectors."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a CUDA call takes: the wgmma kernel for bf16 with
    D in ``SM90_HEAD_DIMS``, the CUDA-core kernel otherwise."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90_wgmma"
    return "cuda_core"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_chunk: int = 512,
                        k_chunk: int = 512) -> torch.Tensor:
    """q, k, v: (B, S, H, D) with equal head counts (repeat GQA first).

    Returns (B, Sq, H, D) in q's dtype; products, softmax and the
    denominator in float32, p·v accumulated in float32 from p rounded to
    bf16 on the ``"sm90_wgmma"`` variant and from float32 p otherwise.  The
    causal mask is ``qpos >= kpos`` by absolute index.  A CUDA tensor
    launches the kernel of ``variant(dtype, D)`` (or raises); a CPU tensor
    takes the plain version.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, q_chunk, k_chunk)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(variant(q.dtype, q.shape[3]), q, k, v, causal)


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def launch(which: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True) -> torch.Tensor:
    """Launch one variant's kernel on CUDA tensors and count the launch in
    ``flash_attention_fwd.launches`` and its ``launches_by_variant``.  The
    wrapper calls it with ``variant(dtype, D)``; ``chip_smoke.py`` also
    times the CUDA-core kernel at a bf16 shape the wrapper sends to wgmma."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(which, q, k, v, causal)


def _launch(which, q, k, v, causal):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    heads = SM90_HEAD_DIMS if which == "sm90_wgmma" else HEAD_DIMS
    if (which, q.dtype) not in _ENTRY:
        raise ValueError(f"variant {which!r} takes no {q.dtype}")
    if d not in heads:
        raise ValueError(f"head dim {d} not in {heads}")
    if (sq + _BQ[which] - 1) // _BQ[which] > _MAX_GRID_Y or b * h >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    _build.launch(_ENTRY[which, q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, sq, sk, h, d,
                  int(bool(causal)),
                  torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_variant[which] += 1
    return out


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              q_chunk: int = 512, k_chunk: int = 512,
                              round_p: bool = False) -> torch.Tensor:
    """Plain K4: softmax(q·kᵀ·scale + mask)·v in float32, ``q_chunk`` query
    rows at a time (their (B, H, q_chunk, Sk) score block is the largest
    buffer); the result is cast to q's dtype.

    ``round_p=True`` follows the wgmma kernel's rounding: p = exp(s - max)
    in float32 is rounded to v's dtype before p·v, and the float32 sum of
    the unrounded p divides the product.  In float32 it rounds nothing.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    qf = q.float().transpose(1, 2)                       # (B, H, Sq, D)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    step = max(1, int(q_chunk))
    kpos = torch.arange(sk, device=q.device)
    for q0 in range(0, sq, step):
        q1 = min(sq, q0 + step)
        s = torch.matmul(qf[:, :, q0:q1], kf.transpose(-1, -2)) * scale
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        if round_p:
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            pv = torch.matmul(p.to(v.dtype).float(), vf)
            out[:, :, q0:q1] = pv / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        else:
            out[:, :, q0:q1] = torch.matmul(torch.softmax(s, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        q_chunk: int = 512, round_p: bool = False):
    """Gradients (dq, dk, dv) of K4's forward at ``dout``, in PyTorch.

    ``q_chunk`` query rows at a time (causal: only the keys up to the
    block's last row), in float32: s = q·kᵀ·scale, e = exp(s − rowmax),
    l = Σe, out = (p·v) / l with p = e, or e rounded to v's dtype when
    ``round_p`` (what the ``"sm90_wgmma"`` variant computes).  The rounding
    passes gradients through unchanged and the row max is held constant,
    as it cancels in the softmax.  Returns tensors in q's, k's and v's
    dtypes.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    qf = q.float().transpose(1, 2)                       # (B, H, Sq, D)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    gf = dout.float().transpose(1, 2)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    step = max(1, int(q_chunk))
    for q0 in range(0, sq, step):
        q1 = min(sq, q0 + step)
        kend = min(sk, q1) if causal else sk
        qc, kc, vc = qf[:, :, q0:q1], kf[:, :, :kend], vf[:, :, :kend]
        s = torch.matmul(qc, kc.transpose(-1, -2)) * scale
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)
            kpos = torch.arange(kend, device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        del s
        l = e.sum(dim=-1, keepdim=True)
        p = e.to(v.dtype).float() if round_p else e
        g = gf[:, :, q0:q1] / l                          # d(p·v)
        u = torch.matmul(p, vc)                          # p·v, unnormalised
        dv[:, :, :kend] += torch.matmul(p.transpose(-1, -2), g)
        del p
        dl = -(g * u).sum(dim=-1, keepdim=True) / l
        ds = (torch.matmul(g, vc.transpose(-1, -2)) + dl).mul_(e)
        del e
        dq[:, :, q0:q1] = torch.matmul(ds, kc) * scale
        dk[:, :, :kend] += torch.matmul(ds.transpose(-1, -2), qc) * scale
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def plain_grads(q, k, v, dout, causal: bool = True, round_p: bool = False):
    """(dq, dk, dv) by autograd through :func:`flash_attention_fwd_plain`
    (``round_p`` as there): the yardsticks of :func:`flash_attention_bwd`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_fwd_plain(*leaves, causal=causal,
                                        q_chunk=q.shape[1], round_p=round_p)
        return torch.autograd.grad(out, leaves, dout)


class _FlashAttention(torch.autograd.Function):
    """K4 forward, PyTorch backward (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, k_chunk):
        out = flash_attention_fwd(q, k, v, causal, q_chunk, k_chunk)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_chunk = causal, q_chunk
        # differentiate the rounding the forward did
        ctx.round_p = (q.device.type == "cuda" and
                       variant(q.dtype, q.shape[3]) == "sm90_wgmma")
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, ctx.causal,
                                         ctx.q_chunk, ctx.round_p)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 512,
                    k_chunk: int = 512) -> torch.Tensor:
    """:func:`flash_attention_fwd` under autograd: the forward launches K4
    (a CPU tensor takes the plain version) and counts the launch; the
    backward is :func:`flash_attention_bwd`, rounding p as the forward
    did."""
    return _FlashAttention.apply(q, k, v, causal, q_chunk, k_chunk)


def attention_error_ratios(got: torch.Tensor, ref: torch.Tensor,
                           base: torch.Tensor) -> dict:
    """The wgmma variant's accuracy rule, in float64.

    ``ref``: the plain version in float32 from the same bf16 inputs, not
    rounded (``flash_attention_fwd_plain(q.float(), k.float(), v.float())``);
    ``base``: the plain version with ``round_p=True`` in bf16.  ``got``
    passes when max|got − ref| ≤ 2·max|base − ref| + 1e-6 and
    mean|got − ref| ≤ 2·mean|base − ref|; each ratio is the error over its
    limit, so both ≤ 1 pass.  The kernel rounds p against the running max,
    not the row's, so it cannot match ``base`` bit for bit; the factor 2
    leaves room for that and nothing more.
    """
    r = ref.double()
    d_got = (got.double() - r).abs()
    d_base = (base.double() - r).abs()
    max_limit = 2.0 * float(d_base.max()) + 1e-6
    mean_got, mean_base = float(d_got.mean()), float(d_base.mean())
    if mean_base > 0:
        mean_ratio = mean_got / (2.0 * mean_base)
    else:
        mean_ratio = 0.0 if mean_got == 0 else float("inf")
    out = {"max_abs_err": float(d_got.max()),
           "base_max_abs_err": float(d_base.max()),
           "mean_abs_err": mean_got, "base_mean_abs_err": mean_base,
           "max_ratio": float(d_got.max()) / max_limit,
           "mean_ratio": mean_ratio}
    out["ok"] = out["max_ratio"] <= 1.0 and out["mean_ratio"] <= 1.0
    return out


def grad_error_ratios(got, ref, base) -> dict:
    """:func:`attention_error_ratios` for each of (dq, dk, dv): ``ref`` the
    gradients of the float32 plain version from the same bf16 inputs and
    bf16 ``dout`` (``plain_grads`` of their float32 copies), ``base`` those
    of the bf16 plain version with ``round_p=True``.  ``ok`` when all three
    pass."""
    out = {name: attention_error_ratios(g, r, b)
           for name, g, r, b in zip(("dq", "dk", "dv"), got, ref, base)}
    out["ok"] = all(v["ok"] for v in out.values())
    return out
