"""Mamba-style selective SSM block, jamba's sub-quadratic mixer (see
``repro.models.ssm``).

A selective state space: per token an input-dependent step ``dt`` and
projections B and C, and a diagonal A (``a_log``).  Per channel d and
state n the recurrence is ``h[t] = exp(dt[t]·A)·h[t-1] + dt[t]·u[t]·B[t]``
and the output ``y[t] = h[t]·C[t] + D·u[t]``, gated by ``silu(z)``.

* :func:`mamba_train` runs the whole sequence chunk by chunk, as the
  reference's ``lax.scan`` over chunks of 256 (``launch/hlo_cost.loop``:
  counted on the meta device, the middle chunks run once and count for
  all): within a chunk the (a, b)
  pairs of ``h' = a·h + b`` are combined by a log-depth inclusive scan
  (:func:`scan_pairs`, 8 steps at 256 tokens), then the carried state
  enters through the chunk's cumulative a.  It never divides by a product
  of a's (a cumprod/cumsum shortcut would, and those products underflow).
  ``return_state`` also returns the terminal ``{"h", "conv"}`` cache:
  ``h`` is the last chunk's carry (the recurrence the reference's
  ``_mamba_terminal_state`` recomputes with one unchunked scan) and
  ``conv`` the last ``W - 1`` pre-conv projections.
* :func:`mamba_decode` is the O(1) update of one token from that cache.

The reference's dtype steps are kept: the projections, the causal conv
(summed tap by tap, ``i = 0..W-1``), ``softplus`` and ``dt * u`` in the
compute dtype; ``exp(dt·A)``, ``dt·u·B``, C and the state in float32.  The
state contraction ``einsum("bldn,bln->bld")`` is a float32 product, so on
the card it needs TF32 off (``torch.backends.cuda.matmul.allow_tf32 =
False``, PyTorch's default).  The module has no kernel of its own; the
reference has no Pallas kernel here either.

Over model ranks (a :class:`Mamba` built with ``group``, a
``launch.mesh.ModelGroup``, and ``di`` its share of the inner width, the
reference's "ssm_inner" rules): ``in_proj`` and ``gate_proj`` are
column-parallel (their input passes ``group.enter``); ``conv_w``,
``dt_bias``, ``a_log`` and ``d_skip`` are the rank's channels, so the
causal conv, the scan and the state are the rank's alone; ``x_proj_b``,
``x_proj_c`` and ``x_proj_dt`` are row-parallel, each rank's product a
partial sum of B, C and dt over its channels, and the group adds the
three, concatenated (B, S, 2N + 1), in one fixed-order ``group.psum``
before any use (:func:`_projections`, once a call for the whole
sequence: they are per token).  What follows the sum is per channel, so
its gradient is each rank's part: the sum passes ``group.enter`` too,
which adds the parts in the backward.  ``out_proj`` is row-parallel,
summed by ``group.psum``.  The cache ``{"h", "conv"}`` holds the rank's
channels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..launch import hlo_cost
from .layers import Dense, _empty, dense, fill_normal_

__all__ = ["Mamba", "mamba_train", "mamba_init_cache", "mamba_decode",
           "scan_pairs", "CHUNK"]

State = Dict[str, torch.Tensor]
CHUNK = 256          # mamba_train's chunk, as the reference's default


class Mamba(nn.Module):
    """``in_proj``, ``gate_proj`` (d, di), ``conv_w`` (W, di), ``x_proj_b``,
    ``x_proj_c`` (di, N), ``x_proj_dt`` (di, 1), ``dt_bias`` (di,),
    ``a_log`` (di, N), ``d_skip`` (di,) and ``out_proj`` (di, d); inner
    width ``di = d_model * cfg.ssm_expand`` (with ``group``, the rank's
    share of it), state ``N = cfg.ssm_state_dim``."""

    def __init__(self, d_model: int, cfg, *, di: int = None, group=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        di = d_model * cfg.ssm_expand if di is None else di
        n = cfg.ssm_state_dim
        self.group = group
        kw = dict(device=device, dtype=dtype)
        self.in_proj = Dense(d_model, di, **kw)
        self.gate_proj = Dense(d_model, di, **kw)
        self.conv_w = _empty((cfg.ssm_conv_width, di), device, dtype)
        self.x_proj_b = Dense(di, n, **kw)
        self.x_proj_c = Dense(di, n, **kw)
        self.x_proj_dt = Dense(di, 1, **kw)
        self.dt_bias = _empty((di,), device, dtype)
        self.a_log = _empty((di, n), device, dtype)
        self.d_skip = _empty((di,), device, dtype)
        self.out_proj = Dense(di, d_model, **kw)

    def reset(self, generator: torch.Generator) -> None:
        """``mamba_init``'s values: normal·0.2 conv taps, ``dt_bias`` 0,
        ``a_log`` = log(1..N) in every channel, ``d_skip`` 1."""
        for m in (self.in_proj, self.gate_proj):
            m.reset(generator)
        fill_normal_(self.conv_w, generator, 0.2)     # drawn whole
        for m in (self.x_proj_b, self.x_proj_c, self.x_proj_dt):
            m.reset(generator)
        n = self.a_log.shape[1]
        self.dt_bias.zero_()
        self.a_log.copy_(torch.log(torch.linspace(
            1.0, float(n), n, device=self.a_log.device))[None, :])
        self.d_skip.fill_(1.0)
        self.out_proj.reset(generator)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, di); w: (W, di), in x's dtype,
    the taps summed in order."""
    wdt, s = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], wdt - 1) + x.shape[2:]), x],
                   dim=1)
    out = torch.zeros_like(x)
    for i in range(wdt):                                  # W is tiny (4)
        out = out + xp[:, i:i + s] * w[i]
    return out


def _projections(p: Mamba, u: torch.Tensor, compute):
    """B (B, L, N), C (B, L, N) and the step dt (B, L, di) of ``u`` (B, L,
    di), in the compute dtype; over a group the three projections' partial
    sums added in one ``psum`` (module docstring)."""
    bmat = dense(p.x_proj_b, u, compute)                  # (B, L, N)
    cmat = dense(p.x_proj_c, u, compute)
    dt = dense(p.x_proj_dt, u, compute)                   # (B, L, 1)
    if p.group is not None:
        n = bmat.shape[-1]
        both = p.group.enter(p.group.psum(torch.cat([bmat, cmat, dt], -1)))
        bmat, cmat, dt = both.split([n, n, 1], dim=-1)
    return bmat, cmat, F.softplus(dt + p.dt_bias.to(compute))


def _discretize(p: Mamba, u, bmat, cmat, dt):
    """(dA, dBu, C) of ``u`` and its projections: (B, L, di, N) float32
    twice and (B, L, N) float32."""
    a = -torch.exp(p.a_log.float())                       # (di, N)
    da = torch.exp(dt[..., None].float() * a)
    dbu = (dt * u).float()[..., None] * bmat.float()[..., None, :]
    return da, dbu, cmat.float()


def _ssm_params(p: Mamba, u: torch.Tensor, compute):
    """Input-dependent (dA, dBu, C) of ``u`` (B, L, di)
    (:func:`_discretize` of :func:`_projections`)."""
    return _discretize(p, u, *_projections(p, u, compute))


def scan_pairs(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of the pairs (a[t], b[t]) along dim 1 under
    ``(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2)``: returns (A, B) with
    ``h[t] = A[t]·h0 + B[t]`` the state after t + 1 steps of ``h' = a·h +
    b`` from ``h0``.  Log-depth (Hillis-Steele): the step of offset k
    combines each t >= k with t - k, for k = 1, 2, 4, ...

    Without autograd it writes the combined tail back into ``a`` and
    ``b`` (the caller's tensors); with autograd it builds new tensors
    with ``torch.cat``, whose copies cost more: in a jamba prefill of 4 x
    2048 tokens on an H100 80GB HBM3 (700 W), 0.55 s of copy kernels
    against the write-back's 0.30 s."""
    inplace = not torch.is_grad_enabled()
    k = 1
    while k < a.shape[1]:
        nb = torch.addcmul(b[:, k:], a[:, k:], b[:, :-k])
        na = a[:, k:] * a[:, :-k]
        if inplace:
            b[:, k:] = nb
            a[:, k:] = na
        else:
            b = torch.cat([b[:, :k], nb], dim=1)
            a = torch.cat([a[:, :k], na], dim=1)
        del nb, na
        k *= 2
    return a, b


def mamba_train(p: Mamba, x: torch.Tensor, cfg, chunk: int = CHUNK,
                return_state: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model): the chunked selective scan.

    The chunk is ``min(chunk, S)`` and S must be a multiple of it (a
    ``ValueError``): padding would change the state.  ``return_state``
    also returns the terminal ``{"h", "conv"}``, which prefill hands to
    decode."""
    compute = x.dtype
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mamba_train: the sequence length {s} must be a "
                         f"multiple of the chunk min({chunk}, S); padding "
                         f"would change the state")
    if p.group is not None:     # column-parallel entry: x's gradient summed
        x = p.group.enter(x)
    u_raw = dense(p.in_proj, x, compute)
    z = dense(p.gate_proj, x, compute)
    u = F.silu(_causal_conv(u_raw, p.conv_w.to(compute)))
    di, n = u.shape[-1], p.a_log.shape[1]
    bmat, cmat, dt = _projections(p, u, compute)

    def fold(state, i):
        sl = slice(i * chunk, (i + 1) * chunk)
        da, dbu, c = _discretize(p, u[:, sl], bmat[:, sl], cmat[:, sl],
                                 dt[:, sl])
        a_cum, hs = scan_pairs(da, dbu)
        del da, dbu
        hs = torch.addcmul(hs, a_cum, state[0][:, None])  # (B, L, di, N)
        del a_cum
        y = torch.einsum("bldn,bln->bld", hs, c).to(compute)
        return (hs[:, -1].clone(),), y

    h0 = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    (h,), ys = hlo_cost.loop(x, s // chunk, fold, (h0,))
    y = torch.cat(ys, dim=1)
    y = y + u * p.d_skip.to(compute)
    y = y * F.silu(z)
    out = _out(p, y, compute)
    if return_state:
        wdt = p.conv_w.shape[0]
        return out, {"h": h, "conv": u_raw[:, -(wdt - 1):].clone()}
    return out


def _out(p: Mamba, y: torch.Tensor, compute) -> torch.Tensor:
    """``out_proj`` of ``y``; summed over the group when ``p`` holds a
    rank's channels."""
    out = dense(p.out_proj, y, compute)
    return out if p.group is None else p.group.psum(out)


def mamba_init_cache(batch: int, d_model: int, cfg, dtype=torch.float32,
                     device=None, di: int = None) -> State:
    """Zero state ``h`` (B, di, N) float32 and conv window ``conv`` (B,
    W - 1, di) in ``dtype`` (the compute dtype); ``di``: a rank's share of
    the inner width (default all of it)."""
    di = d_model * cfg.ssm_expand if di is None else di
    return {"h": torch.zeros((batch, di, cfg.ssm_state_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di),
                                dtype=dtype, device=device)}


def mamba_decode(p: Mamba, x: torch.Tensor, cfg, cache: State
                 ) -> Tuple[torch.Tensor, State]:
    """One token, x: (B, 1, d_model) -> (y (B, 1, d_model), new cache)."""
    compute = x.dtype
    if p.group is not None:
        x = p.group.enter(x)
    u = dense(p.in_proj, x, compute)                      # (B, 1, di)
    z = dense(p.gate_proj, x, compute)
    win = torch.cat([cache["conv"], u], dim=1)            # (B, W, di)
    # the reference's einsum: exact products, one float32 sum, one rounding
    conv = (win.float() * p.conv_w.to(compute).float()).sum(dim=1)
    u1 = F.silu(conv.to(compute))[:, None]                # (B, 1, di)
    da, dbu, c = _ssm_params(p, u1, compute)
    h = cache["h"] * da[:, 0] + dbu[:, 0]                 # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h, c[:, 0])[:, None]   # (B, 1, di)
    y = y.to(compute) + u1 * p.d_skip.to(compute)
    y = y * F.silu(z)
    return _out(p, y, compute), {"h": h, "conv": win[:, 1:]}
