"""Mamba-style selective SSM block, jamba's sub-quadratic mixer (see
``repro.models.ssm``).

A selective state space: per token an input-dependent step ``dt`` and
projections B and C, and a diagonal A (``a_log``).  Per channel d and
state n the recurrence is ``h[t] = exp(dt[t]·A)·h[t-1] + dt[t]·u[t]·B[t]``
and the output ``y[t] = h[t]·C[t] + D·u[t]``, gated by ``silu(z)``.

* :func:`mamba_train` runs the whole sequence chunk by chunk, as the
  reference's ``lax.scan`` over chunks of 256: within a chunk the (a, b)
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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, _empty, dense

__all__ = ["Mamba", "mamba_train", "mamba_init_cache", "mamba_decode",
           "scan_pairs", "CHUNK"]

State = Dict[str, torch.Tensor]
CHUNK = 256          # mamba_train's chunk, as the reference's default


class Mamba(nn.Module):
    """``in_proj``, ``gate_proj`` (d, di), ``conv_w`` (W, di), ``x_proj_b``,
    ``x_proj_c`` (di, N), ``x_proj_dt`` (di, 1), ``dt_bias`` (di,),
    ``a_log`` (di, N), ``d_skip`` (di,) and ``out_proj`` (di, d); inner
    width ``di = d_model * cfg.ssm_expand``, state ``N =
    cfg.ssm_state_dim``."""

    def __init__(self, d_model: int, cfg, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        di, n = d_model * cfg.ssm_expand, cfg.ssm_state_dim
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
        self.conv_w.copy_(torch.randn(self.conv_w.shape, generator=generator,
                                      device=self.conv_w.device) * 0.2)
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


def _ssm_params(p: Mamba, u: torch.Tensor, compute):
    """Input-dependent (dA, dBu, C) of ``u`` (B, L, di): (B, L, di, N)
    float32 twice and (B, L, N) float32."""
    bmat = dense(p.x_proj_b, u, compute)                  # (B, L, N)
    cmat = dense(p.x_proj_c, u, compute)
    dt = F.softplus(dense(p.x_proj_dt, u, compute)
                    + p.dt_bias.to(compute))              # (B, L, di)
    a = -torch.exp(p.a_log.float())                       # (di, N)
    da = torch.exp(dt[..., None].float() * a)
    dbu = (dt * u).float()[..., None] * bmat.float()[..., None, :]
    return da, dbu, cmat.float()


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
    u_raw = dense(p.in_proj, x, compute)
    z = dense(p.gate_proj, x, compute)
    u = F.silu(_causal_conv(u_raw, p.conv_w.to(compute)))
    di, n = u.shape[-1], p.a_log.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mamba_train: the sequence length {s} must be a "
                         f"multiple of the chunk min({chunk}, S); padding "
                         f"would change the state")
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        da, dbu, c = _ssm_params(p, u[:, c0:c0 + chunk], compute)
        a_cum, hs = scan_pairs(da, dbu)
        del da, dbu
        hs = torch.addcmul(hs, a_cum, h[:, None])         # (B, L, di, N)
        del a_cum
        ys.append(torch.einsum("bldn,bln->bld", hs, c).to(compute))
        h = hs[:, -1].clone()
        del hs
    y = torch.cat(ys, dim=1)
    y = y + u * p.d_skip.to(compute)
    y = y * F.silu(z)
    out = dense(p.out_proj, y, compute)
    if return_state:
        wdt = p.conv_w.shape[0]
        return out, {"h": h, "conv": u_raw[:, -(wdt - 1):].clone()}
    return out


def mamba_init_cache(batch: int, d_model: int, cfg, dtype=torch.float32,
                     device=None) -> State:
    """Zero state ``h`` (B, di, N) float32 and conv window ``conv`` (B,
    W - 1, di) in ``dtype`` (the compute dtype)."""
    di = d_model * cfg.ssm_expand
    return {"h": torch.zeros((batch, di, cfg.ssm_state_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di),
                                dtype=dtype, device=device)}


def mamba_decode(p: Mamba, x: torch.Tensor, cfg, cache: State
                 ) -> Tuple[torch.Tensor, State]:
    """One token, x: (B, 1, d_model) -> (y (B, 1, d_model), new cache)."""
    compute = x.dtype
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
    return dense(p.out_proj, y, compute), {"h": h, "conv": win[:, 1:]}
