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

Tensor parallel (an :class:`Attention` built with a ``group``): the module
holds its rank's heads, ``wq`` / ``wk`` / ``wv`` column blocks and ``wo``'s
row block (Megatron's split), so every function here runs on the local
heads (K4 at (B, S, H_r, D)) and one all-reduce over the group follows
``wo``.  The cache holds the local KV heads.  Heads stay whole: rank r of
m holds the contiguous query heads :func:`head_range` gives it, as even as
whole heads allow (the first H % m ranks one more), and the KV heads
those read (:func:`kv_head_range`), so a KV head is held by every rank
whose query heads read it.  Where a rank's query heads do not read its KV
heads in equal groups (a range that straddles a KV head boundary), the
module maps each local query head to its local KV head (``kv_index``).  A
rank with no query head (H < m) holds zero-width blocks, launches no K4
and adds zeros to ``wo``'s sum: an explicit branch, counted in
:data:`NO_HEAD`.  The reference's rule splits the flat head columns over
"model" instead (``repro/launch/sharding.py:151``), splitting a head where
the heads do not divide, and GSPMD reshards it; the port gives the same
numbers with whole heads.

Trained over ranks, ``attention_train``'s input (and cross-attention's
encoder states) passes ``group.enter`` (backward: the ranks' input
gradients summed) and ``wo``'s output ``group.psum`` (backward: the
identity).  A KV head that several ranks hold gets a partial gradient on
each, from that rank's query heads only; the train step sums each head
over exactly the ranks that hold it (``models/transformer.grad_members``,
``train/zero.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..kernels import flash_attention as k4
from .layers import Dense, dense

__all__ = ["rope_frequencies", "apply_rope", "Attention", "flash_attention",
           "attention_train", "init_kv_cache", "attention_prefill",
           "attention_decode", "head_range", "kv_head_range", "NO_HEAD"]

Cache = Dict[str, torch.Tensor]
NEG_INF = -1e30
#: layer calls on a rank that holds no query head (no K4 launched)
NO_HEAD = {"calls": 0}


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


def head_range(n_heads: int, m: int, r: int) -> Tuple[int, int]:
    """The query heads [lo, hi) of rank ``r`` of ``m``: contiguous, as even
    as whole heads allow, the first ``H % m`` ranks one more (so rank 0
    holds the most; a rank past the H-th holds none)."""
    base, extra = divmod(n_heads, m)
    lo = r * base + min(r, extra)
    return lo, lo + base + (r < extra)


def kv_head_range(n_heads: int, n_kv_heads: int, m: int, r: int
                  ) -> Tuple[int, int]:
    """The KV heads [lo, hi) that rank ``r`` of ``m`` reads: query head i
    (of the rank's :func:`head_range`) reads KV head i // (H / Hkv).  A
    rank with no query head reads none (``lo == hi``)."""
    if n_heads % n_kv_heads:
        raise ValueError(f"{n_heads} query heads do not group over "
                         f"{n_kv_heads} KV heads")
    group = n_heads // n_kv_heads
    qlo, qhi = head_range(n_heads, m, r)
    if qlo == qhi:
        return qlo // group, qlo // group
    return qlo // group, (qhi - 1) // group + 1


def kv_index(n_heads: int, n_kv_heads: int, m: int, r: int
             ) -> Optional[Tuple[int, ...]]:
    """Rank ``r``'s local KV head for each of its local query heads, or
    None where they read the local KV heads in equal groups in order
    (what :func:`_repeat_kv` gives)."""
    qlo, qhi = head_range(n_heads, m, r)
    klo, khi = kv_head_range(n_heads, n_kv_heads, m, r)
    group = n_heads // n_kv_heads
    idx = tuple(i // group - klo for i in range(qlo, qhi))
    h, hkv = qhi - qlo, khi - klo
    if h == 0 or (h % hkv == 0 and
                  idx == tuple(j // (h // hkv) for j in range(h))):
        return None
    return idx


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv`` (optional bias) and ``wo``, for ``n_heads``
    query and ``n_kv_heads`` KV heads; with ``group`` (a
    ``launch.mesh.ModelGroup``) those are the rank's heads and ``wo``'s
    output is summed over the group.  ``kv_index``: each query head's KV
    head where they do not read them in equal groups (:func:`kv_index`)."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, qkv_bias: bool = False, group=None,
                 kv_index: Optional[Tuple[int, ...]] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.n_heads, self.n_kv_heads, self.head_dim = (n_heads, n_kv_heads,
                                                        head_dim)
        self.group, self.kv_index = group, kv_index
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


def _out(p: Attention, o: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``wo`` over the heads' outputs (B, S, H, D); summed over the group
    when ``p`` holds a rank's heads."""
    b, s = o.shape[:2]
    y = dense(p.wo, o.reshape(b, s, -1), compute_dtype)
    return y if p.group is None else p.group.psum(y)


def _no_head(p: Attention, q: torch.Tensor, compute_dtype,
             enc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A rank that holds no query head: no K4; ``wo``'s zero-width product
    adds zeros to the group's sum.  The zero-width products keep the
    input's (and cross-attention's encoder states') gradient path, so the
    backward's collectives run on this rank too."""
    NO_HEAD["calls"] += 1
    b, s = q.shape[:2]
    o = q.reshape(b, s, 0)
    if enc is not None:
        o = o + dense(p.wk, enc, compute_dtype).sum(1, keepdim=True)
    y = dense(p.wo, o, compute_dtype)
    return y if p.group is None else p.group.psum(y)


def _expand_kv(p: Attention, k: torch.Tensor) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D): each query head's KV head."""
    if p.kv_index is None:
        return _repeat_kv(k, p.n_heads // p.n_kv_heads)
    return k.index_select(2, torch.tensor(p.kv_index, device=k.device))


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
    h, hkv, hd = p.n_heads, p.n_kv_heads, p.head_dim
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    enc = None if kv_override is None else kv_override[0]
    if p.group is not None:     # column-parallel entry: x's gradient summed
        x = p.group.enter(x)
        enc = None if enc is None else p.group.enter(enc)
    q, k, v = _project_qkv(p, x, h, hkv, hd, compute)
    if h == 0:
        return _no_head(p, q, compute, enc)
    if enc is not None:           # cross-attention: K/V from encoder states
        k, v = _project_enc_kv(p, enc, hkv, hd, compute)
        causal = False            # no RoPE across modalities
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k = _expand_kv(p, k)
    v = _expand_kv(p, v)
    out = flash_attention(q, k, v, causal=causal, q_chunk=chunk, k_chunk=chunk,
                          skip_upper_triangle=skip_upper_triangle)
    return _out(p, out, compute)


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
    h, hkv, hd = p.n_heads, p.n_kv_heads, p.head_dim
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, h, hkv, hd, compute)
    if h == 0:
        return _no_head(p, q, compute), cache
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    kf = _expand_kv(p, k)
    vf = _expand_kv(p, v)
    out = flash_attention(q, kf, vf, causal=True, q_chunk=chunk, k_chunk=chunk)
    return _out(p, out, compute), cache


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
    h, hkv, hd = p.n_heads, p.n_kv_heads, p.head_dim
    b = x.shape[0]
    q = dense(p.wq, x, compute).reshape(b, 1, h, hd)
    if h == 0:
        return _no_head(p, q, compute), cache
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
    if p.kv_index is not None:    # uneven groups: each query head's own
        k, v, hkv = _expand_kv(p, k), _expand_kv(p, v), h
    # query head i*g + j reads KV head i, as after _repeat_kv; grouping the
    # query heads instead of copying the cache g times gives the same dots
    g = h // hkv
    qg = q.float().reshape(b, hkv, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / (hd ** 0.5)
    mask = torch.arange(s_max, device=x.device) < valid_upto
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(compute)
    out = torch.einsum("bkgs,bskd->bkgd", w.float(), v.float()).to(compute)
    return _out(p, out.reshape(b, 1, h, hd), compute), cache
