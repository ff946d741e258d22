"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
(see ``repro.models.xlstm``; arXiv:2405.04517 at block level).

* **mLSTM**: per head a (d_k x d_k) matrix memory C with exponential input
  and forget gates and a normaliser state n.  :func:`mlstm_train` runs the
  chunked form, chunk by chunk in a Python loop: the intra-chunk part like
  masked attention, then the whole chunk folded into the carried (C, n, m).
  :func:`mlstm_decode` is the O(1) update of one token.
* **sLSTM**: a scalar memory per channel with exponential gating and the
  m-state stabiliser; strictly sequential over time, so
  :func:`slstm_train` is a Python loop of :func:`slstm_step`, one token at
  a time, as the reference's ``lax.scan``.

Both use the reference's numerics: gates and states in float32, the
stabiliser m starting at -1e30, the intra-chunk log-weights masked to -inf
before their max and exp, ``F.logsigmoid`` for the forget gate, and the
denominator ``|·|`` clamped at 1.  The chunk is ``min(128, S)`` and S must
be a multiple of it (a ``ValueError``): padding would change the state.

The sLSTM recurrence ``h @ r_h`` is a float32 product that 2,048 steps of
a prompt compound, so on the card it needs TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default):
with it on, each step rounds h and r_h to 10 mantissa bits.  The module
has no kernel of its own; the reference has no Pallas kernel here either.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, dense

__all__ = ["mLSTM", "sLSTM", "mlstm_train", "mlstm_init_cache",
           "mlstm_decode", "slstm_step", "slstm_train", "slstm_init_cache",
           "slstm_decode", "CHUNK"]

State = Dict[str, torch.Tensor]
CHUNK = 128          # mlstm_train's chunk, as the reference's default
M_INIT = -1e30       # the stabiliser's start


class mLSTM(nn.Module):    # noqa: N801 -- the paper's name
    """``wq``, ``wk``, ``wv``, ``wz`` (the output gate), ``proj_out``, and
    the gates ``wi`` and ``wf`` with biases; inner width
    ``d_model * cfg.ssm_expand``."""

    def __init__(self, d_model: int, cfg, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        di = d_model * cfg.ssm_expand
        kw = dict(device=device, dtype=dtype)
        self.wq = Dense(d_model, di, **kw)
        self.wk = Dense(d_model, di, **kw)
        self.wv = Dense(d_model, di, **kw)
        self.wi = Dense(d_model, di, bias=True, **kw)    # input gate
        self.wf = Dense(d_model, di, bias=True, **kw)    # forget gate
        self.wz = Dense(d_model, di, **kw)               # output gate
        self.proj_out = Dense(di, d_model, **kw)

    def reset(self, generator: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wi, self.wf, self.wz,
                  self.proj_out):
            m.reset(generator)


class sLSTM(nn.Module):    # noqa: N801 -- the paper's name
    """The gates ``wz`` (cell input), ``wi``, ``wf`` and ``wo_gate`` with
    biases, the recurrent ``r_h`` (di, di) and ``proj_out``."""

    def __init__(self, d_model: int, cfg, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        di = d_model * cfg.ssm_expand
        kw = dict(device=device, dtype=dtype)
        self.wz = Dense(d_model, di, bias=True, **kw)
        self.wi = Dense(d_model, di, bias=True, **kw)
        self.wf = Dense(d_model, di, bias=True, **kw)
        self.wo_gate = Dense(d_model, di, bias=True, **kw)
        self.r_h = Dense(di, di, **kw)
        self.proj_out = Dense(di, d_model, **kw)

    def reset(self, generator: torch.Generator) -> None:
        for m in (self.wz, self.wi, self.wf, self.wo_gate, self.r_h,
                  self.proj_out):
            m.reset(generator)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_heads(cfg, di: int) -> Tuple[int, int]:
    return cfg.n_heads, di // cfg.n_heads


def _mlstm_chunk(state, q, k, v, i_, f_, scale):
    """Fold one chunk (q, k, v: (B, L, H, dk) float32; i_, f_: (B, L, H)
    log gates) into the carried ``(C, n, m)`` -> (new state, y (B, L, H,
    dk) float32)."""
    c_state, n_state, m_state = state        # (B,H,dk,dk), (B,H,dk), (B,H)
    length = q.shape[1]
    f_cum = torch.cumsum(f_, dim=1)                              # (B,L,H)
    # m_new[t] = max(m + f_cum[t], max_{j<=t} (f_cum[t] - f_cum[j] + i[j]))
    g = f_cum[:, :, None, :] - f_cum[:, None, :, :] + i_[:, None, :, :]
    lmask = torch.tril(torch.ones(length, length, dtype=torch.bool,
                                  device=q.device))[None, :, :, None]
    g = torch.where(lmask, g, float("-inf"))                     # (B,L,L',H)
    m_intra = g.amax(dim=2)                                      # (B,L,H)
    m_new = torch.maximum(m_state[:, None] + f_cum, m_intra)
    w_intra = torch.exp(g - m_new[:, :, None, :])
    scores = torch.einsum("blhd,bmhd->blmh", q, k) * scale
    w = w_intra * scores
    num_intra = torch.einsum("blmh,bmhd->blhd", w, v)
    den_intra = w.sum(dim=2)                                     # (B,L,H)
    decay = torch.exp(m_state[:, None] + f_cum - m_new)          # (B,L,H)
    num_inter = torch.einsum("blhd,bhde->blhe", q, c_state) \
        * decay[..., None] * scale
    den_inter = torch.einsum("blhd,bhd->blh", q, n_state) * decay * scale
    den = torch.abs(den_intra + den_inter)
    y = (num_intra + num_inter) / torch.clamp(den, min=1.0)[..., None]
    m_end = m_new[:, -1]                                         # (B,H)
    w_in = torch.exp(f_cum[:, -1:, :] - f_cum + i_ - m_end[:, None])
    kv = torch.einsum("blhd,blhe,blh->bhde", k, v, w_in)
    ksum = torch.einsum("blhd,blh->bhd", k, w_in)
    carry = torch.exp(m_state + f_cum[:, -1] - m_end)[..., None]
    return (c_state * carry[..., None] + kv, n_state * carry + ksum,
            m_end), y


def mlstm_train(p: mLSTM, x: torch.Tensor, cfg, chunk: int = CHUNK,
                return_state: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model): the chunked mLSTM.

    ``return_state`` also returns the terminal ``{"c", "n", "m"}``, which
    prefill hands to decode."""
    compute = x.dtype
    b, s, _ = x.shape
    q = dense(p.wq, x, compute)
    k = dense(p.wk, x, compute)
    v = dense(p.wv, x, compute)
    ig = dense(p.wi, x, compute).float()                  # log-space gates
    fg = dense(p.wf, x, compute).float()
    og = torch.sigmoid(dense(p.wz, x, compute))
    h, dk = _mlstm_heads(cfg, q.shape[-1])
    q, k, v = (t.reshape(b, s, h, dk).float() for t in (q, k, v))
    ig = ig.reshape(b, s, h, dk).mean(-1)                 # per-head gates
    fg = F.logsigmoid(fg.reshape(b, s, h, dk).mean(-1))

    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mlstm_train: the sequence length {s} must be a "
                         f"multiple of the chunk min({chunk}, S); padding "
                         f"would change the state")
    state = _mlstm_zero_state(b, h, dk, x.device)
    scale = 1.0 / (dk ** 0.5)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        state, y = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl],
                                ig[:, sl], fg[:, sl], scale)
        ys.append(y.to(compute))
    y = torch.cat(ys, dim=1).reshape(b, s, -1) * og
    out = dense(p.proj_out, y, compute)
    if return_state:
        return out, dict(zip(("c", "n", "m"), state))
    return out


def _mlstm_zero_state(b, h, dk, device):
    return (torch.zeros((b, h, dk, dk), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device),
            torch.full((b, h), M_INIT, dtype=torch.float32, device=device))


def mlstm_init_cache(batch: int, d_model: int, cfg, device=None) -> State:
    """Zero (C, n) and m = -1e30, float32."""
    di = d_model * cfg.ssm_expand
    h, dk = _mlstm_heads(cfg, di)
    return dict(zip(("c", "n", "m"), _mlstm_zero_state(batch, h, dk,
                                                       device)))


def mlstm_decode(p: mLSTM, x: torch.Tensor, cfg, cache: State
                 ) -> Tuple[torch.Tensor, State]:
    """One token, x: (B, 1, d_model) -> (y (B, 1, d_model), new state)."""
    compute = x.dtype
    b = x.shape[0]
    q = dense(p.wq, x, compute)[:, 0]
    k = dense(p.wk, x, compute)[:, 0]
    v = dense(p.wv, x, compute)[:, 0]
    ig = dense(p.wi, x, compute).float()[:, 0]
    fg = dense(p.wf, x, compute).float()[:, 0]
    og = torch.sigmoid(dense(p.wz, x, compute))[:, 0]
    h, dk = _mlstm_heads(cfg, q.shape[-1])
    q, k, v = (t.float().reshape(b, h, dk) for t in (q, k, v))
    i_t = ig.reshape(b, h, dk).mean(-1)
    f_t = F.logsigmoid(fg.reshape(b, h, dk).mean(-1))
    m_new = torch.maximum(cache["m"] + f_t, i_t)
    fdec = torch.exp(cache["m"] + f_t - m_new)[..., None]
    iw = torch.exp(i_t - m_new)[..., None]
    c = cache["c"] * fdec[..., None] + \
        torch.einsum("bhd,bhe->bhde", k, v) * iw[..., None]
    n = cache["n"] * fdec + k * iw
    scale = 1.0 / (dk ** 0.5)
    num = torch.einsum("bhd,bhde->bhe", q, c) * scale
    den = torch.abs(torch.einsum("bhd,bhd->bh", q, n)) * scale
    y = num / torch.clamp(den, min=1.0)[..., None]
    y = y.reshape(b, 1, -1).to(compute) * og[:, None]
    return dense(p.proj_out, y, compute), {"c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_step(p: sLSTM, state, zi, ii, fi, oi):
    """One sLSTM timestep: ``state`` = (c, n, h, m), each (B, di) float32;
    the gate pre-activations (B, di) float32."""
    c, n, h, m = state
    rh = torch.matmul(h, p.r_h.w.float())
    z = torch.tanh(zi + rh)
    i_log = ii + rh
    f_log = F.logsigmoid(fi + rh)
    m_new = torch.maximum(f_log + m, i_log)
    i_ = torch.exp(i_log - m_new)
    f_ = torch.exp(f_log + m - m_new)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    h_new = torch.sigmoid(oi) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new)


def _slstm_gates(p: sLSTM, x: torch.Tensor):
    compute = x.dtype
    return tuple(dense(w, x, compute).float()
                 for w in (p.wz, p.wi, p.wf, p.wo_gate))


def slstm_train(p: sLSTM, x: torch.Tensor, cfg, return_state: bool = False):
    """x: (B, S, d_model) -> (B, S, d_model): S steps of :func:`slstm_step`
    in order.  ``return_state`` also returns ``{"c", "n", "h", "m"}``."""
    compute = x.dtype
    b, s, _ = x.shape
    zi, ii, fi, oi = _slstm_gates(p, x)
    di = zi.shape[-1]
    state = _slstm_zero_state(b, di, x.device)
    hs = []
    for t in range(s):
        state = slstm_step(p, state, zi[:, t], ii[:, t], fi[:, t], oi[:, t])
        hs.append(state[2])
    y = torch.stack(hs, dim=1).to(compute)
    out = dense(p.proj_out, y, compute)
    if return_state:
        return out, dict(zip(("c", "n", "h", "m"), state))
    return out


def _slstm_zero_state(b, di, device):
    zeros = [torch.zeros((b, di), dtype=torch.float32, device=device)
             for _ in range(3)]
    return tuple(zeros) + (torch.full((b, di), M_INIT, dtype=torch.float32,
                                      device=device),)


def slstm_init_cache(batch: int, d_model: int, cfg, device=None) -> State:
    """Zero (c, n, h) and m = -1e30, float32."""
    di = d_model * cfg.ssm_expand
    return dict(zip(("c", "n", "h", "m"), _slstm_zero_state(batch, di,
                                                            device)))


def slstm_decode(p: sLSTM, x: torch.Tensor, cfg, cache: State
                 ) -> Tuple[torch.Tensor, State]:
    """One token, x: (B, 1, d_model) -> (y (B, 1, d_model), new state)."""
    compute = x.dtype
    zi, ii, fi, oi = (g[:, 0] for g in _slstm_gates(p, x))
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    c, n, h, m = slstm_step(p, state, zi, ii, fi, oi)
    y = h[:, None].to(compute)
    return dense(p.proj_out, y, compute), {"c": c, "n": n, "h": h, "m": m}
