"""Attention: GQA + RoPE (+ optional QKV bias), prefill and decode
(see ``repro.models.attention``).

* ``attention_train`` — full-sequence causal (or bidirectional) self-
  attention through :func:`flash_attention`, which is kernel K4 on the card
  (under autograd: K4 forward, a PyTorch backward).
* ``attention_prefill`` — the same over the prompt, writing its K/V into the
  cache.
* ``attention_decode`` — one query token against the cache, with the
  reference's position mask; plain PyTorch (memory-bound: one pass over the
  cache).

Cross-attention (``kv_override=(enc, enc)``, whisper's decoder): K and V
are projected from the encoder states (B, Se, d), neither q nor k is
rotated, and the attention is not causal.  ``attention_train`` sends it to
K4 with Sq = the decoder length and Sk = Se; ``attention_decode``
re-projects the encoder states at every step, masks at Se and leaves the
self-attention cache as it is, as the reference does.

Activations keep the reference's (B, S, H, D) layout and the cache its
(B, max_seq, Hkv, D) one.  Where the reference rebuilds the cache with
``dynamic_update_slice``, the port writes the prompt's (or the token's) K/V
into the cache tensors in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..kernels import flash_attention as k4
from .layers import Dense, dense

__all__ = ["rope_frequencies", "apply_rope", "Attention", "flash_attention",
           "attention_train", "init_kv_cache", "attention_prefill",
           "attention_decode"]

Cache = Dict[str, torch.Tensor]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (S,).  Rotates the two halves of the
    head (not interleaved pairs), with angles in float32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                # (D/2,)
    angles = positions[..., :, None].float() * freqs            # (S, D/2)
    cos = torch.cos(angles)[..., :, None, :]                    # (S, 1, D/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv`` (optional bias) and ``wo``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, qkv_bias: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wq = Dense(d_model, n_heads * head_dim, bias=qkv_bias, **kw)
        self.wk = Dense(d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw)
        self.wv = Dense(d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw)
        self.wo = Dense(n_heads * head_dim, d_model, **kw)

    def reset(self, generator: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.reset(generator)


def _project_qkv(p: Attention, x: torch.Tensor, n_heads: int,
                 n_kv_heads: int, head_dim: int, compute_dtype):
    b, s, _ = x.shape
    q = dense(p.wq, x, compute_dtype).reshape(b, s, n_heads, head_dim)
    k = dense(p.wk, x, compute_dtype).reshape(b, s, n_kv_heads, head_dim)
    v = dense(p.wv, x, compute_dtype).reshape(b, s, n_kv_heads, head_dim)
    return q, k, v


def _project_enc_kv(p: Attention, enc: torch.Tensor, n_kv_heads: int,
                    head_dim: int, compute_dtype):
    """Cross-attention's K and V: the encoder states (B, Se, d) through
    ``wk`` and ``wv`` -> (B, Se, Hkv, D) each."""
    b, se, _ = enc.shape
    k = dense(p.wk, enc, compute_dtype).reshape(b, se, n_kv_heads, head_dim)
    v = dense(p.wv, enc, compute_dtype).reshape(b, se, n_kv_heads, head_dim)
    return k, v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D) by head replication."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(
        b, s, h * groups, d)


# ---------------------------------------------------------------------------
# full-sequence core
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_chunk: int = 1024,
                    k_chunk: int = 1024,
                    skip_upper_triangle: bool = True) -> torch.Tensor:
    """Attention over (B, S, H, D) with equal H: kernel K4, differentiable
    (``kernels.flash_attention.flash_attention``).

    K4's key loop always stops at the diagonal when causal;
    ``skip_upper_triangle`` is kept for the reference's signature and, as
    there, changes no result.  ``q_chunk`` steers K4's plain version (CPU
    tensors) and the backward's blocks of query rows.
    """
    return k4.flash_attention(q, k, v, causal, q_chunk, k_chunk)


# ---------------------------------------------------------------------------
# public layer entry points
# ---------------------------------------------------------------------------


def attention_train(p: Attention, x: torch.Tensor, cfg, *, causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    chunk: int = 1024,
                    skip_upper_triangle: bool = True) -> torch.Tensor:
    """Full-sequence attention (train / forward). x: (B, S, d_model);
    with ``kv_override`` cross-attention to ``kv_override[0]`` (B, Se,
    d_model), not causal and without RoPE."""
    compute = x.dtype
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, h, hkv, hd, compute)
    if kv_override is not None:   # cross-attention: K/V from encoder states
        k, v = _project_enc_kv(p, kv_override[0], hkv, hd, compute)
        causal = False            # no RoPE across modalities
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    out = flash_attention(q, k, v, causal=causal, q_chunk=chunk, k_chunk=chunk,
                          skip_upper_triangle=skip_upper_triangle)
    return dense(p.wo, out.reshape(b, s, h * hd), compute)


def init_kv_cache(batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
                  dtype, device=None) -> Cache:
    shape = (batch, max_seq, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(p: Attention, x: torch.Tensor, cfg, cache: Cache,
                      chunk: int = 1024) -> Tuple[torch.Tensor, Cache]:
    """Causal attention over the prompt; its K/V are written into ``cache``
    (B, max_seq, Hkv, D) in place, at positions [0, S)."""
    compute = x.dtype
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, h, hkv, hd, compute)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    kf = _repeat_kv(k, h // hkv)
    vf = _repeat_kv(v, h // hkv)
    out = flash_attention(q, kf, vf, causal=True, q_chunk=chunk, k_chunk=chunk)
    y = dense(p.wo, out.reshape(b, s, h * hd), compute)
    return y, cache


def attention_decode(p: Attention, x: torch.Tensor, cfg, cache: Cache,
                     pos: Union[int, torch.Tensor],
                     kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. x: (B, 1, d_model); cache K/V: (B, S_max, Hkv, D).

    The token's K/V are written into ``cache`` at ``pos`` in place.  Logits
    and p·v run in float32 (the reference's ``preferred_element_type``); the
    softmax weights are rounded to the compute dtype first, as there.  With
    ``kv_override`` the token cross-attends to all Se encoder states,
    projected anew, and ``cache`` is returned untouched.
    """
    compute = x.dtype
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    b = x.shape[0]
    q = dense(p.wq, x, compute).reshape(b, 1, h, hd)
    if kv_override is None:
        if isinstance(pos, torch.Tensor):
            pos_t = pos.reshape(1).to(device=x.device, dtype=torch.long)
        else:   # made on the device: no host-to-device copy per layer
            pos_t = torch.full((1,), int(pos), dtype=torch.long,
                               device=x.device)
        q = apply_rope(q, pos_t, cfg.rope_theta)
        k1 = dense(p.wk, x, compute).reshape(b, 1, hkv, hd)
        v1 = dense(p.wv, x, compute).reshape(b, 1, hkv, hd)
        k1 = apply_rope(k1, pos_t, cfg.rope_theta)
        cache["k"].index_copy_(1, pos_t, k1.to(cache["k"].dtype))
        cache["v"].index_copy_(1, pos_t, v1.to(cache["v"].dtype))
        valid_upto = pos_t + 1
        k = cache["k"].to(compute)
        v = cache["v"].to(compute)
    else:   # cross-attention skips RoPE and the cache (as in train)
        k, v = _project_enc_kv(p, kv_override[0], hkv, hd, compute)
        valid_upto = k.shape[1]
    s_max = k.shape[1]
    # query head i*g + j reads KV head i, as after _repeat_kv; grouping the
    # query heads instead of copying the cache g times gives the same dots
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / (hd ** 0.5)
    mask = torch.arange(s_max, device=x.device) < valid_upto
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(compute)
    out = torch.einsum("bkgs,bskd->bkgd", w.float(), v.float()).to(compute)
    y = dense(p.wo, out.reshape(b, 1, h * hd), compute)
    return y, cache
