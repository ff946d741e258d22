"""Flash-attention forward: prefill and full-sequence attention, kernel K4.

Counterpart of ``repro/kernels/flash_attention.py``.  ``csrc/
flash_attention.cu`` runs one CTA per (64-row query tile, batch·head) and
walks the key tiles up to the diagonal with an online softmax, staging K
and V in shared memory (see the note at the top of that file).  It
replaces the reference's pure-XLA chunked attention on the model's path
(``models/attention.flash_attention``).

The chunk arguments keep the reference's signature.  The kernel's tiles are
fixed; ``q_chunk`` only sets how many query rows the plain version scores at
once, and ``k_chunk`` is unused (the plain version takes whole key rows).
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain", "HEAD_DIMS"]

HEAD_DIMS = (8, 16, 32, 64, 128)   # head dims the kernel is built for
NEG_INF = -1e30
_ENTRY = {torch.float32: "flash_attention_fwd_f32",
          torch.bfloat16: "flash_attention_fwd_bf16"}
_BQ = 64                           # the kernel's query rows per CTA
_MAX_GRID_Y = 65535


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _ENTRY:
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


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_chunk: int = 512,
                        k_chunk: int = 512) -> torch.Tensor:
    """q, k, v: (B, S, H, D) with equal head counts (repeat GQA first).

    Returns (B, Sq, H, D) in q's dtype; products, softmax and p·v in
    float32.  The causal mask is ``qpos >= kpos`` by absolute index.  A
    CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, q_chunk, k_chunk)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if (sq + _BQ - 1) // _BQ > _MAX_GRID_Y or b * h >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    _build.launch(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, sq, sk, h, d, int(bool(causal)),
                  torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              q_chunk: int = 512,
                              k_chunk: int = 512) -> torch.Tensor:
    """Plain K4: softmax(q·kᵀ·scale + mask)·v in float32, ``q_chunk`` query
    rows at a time (their (B, H, q_chunk, Sk) score block is the largest
    buffer); the result is cast to q's dtype."""
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
        out[:, :, q0:q1] = torch.matmul(torch.softmax(s, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)
