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

Both loops run through ``launch/hlo_cost.loop``: every trip, except under
a ``launch/hlo_cost.CostCounter`` on the meta device (the dry run's
counted cells), where the middle trips, which run the same ops on the
same shapes with the same collectives, run once and count for all.

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

Over model ranks (a block built with ``group``, a
``launch.mesh.ModelGroup``): each input projection's input passes
``group.enter`` and ``proj_out``'s output ``group.psum``.

* **mLSTM: whole heads**, as attention keeps them
  (``models/attention.head_range``, rank 0 the most): rank r holds the
  ``wq``, ``wk``, ``wv``, ``wi``, ``wf`` and ``wz`` columns of its heads
  and the matching ``proj_out`` rows.  The per-head gates are means over
  the head's own channels, so everything between the entry and the sum
  is the rank's alone.  A rank with no head (xlstm-350m's 4 heads over
  more than 4 ranks) runs no chunk and adds ``proj_out``'s zero-width
  product to the sum, which keeps its input's gradient path, so its
  backward joins the group's collectives; counted in :data:`NO_HEAD`.
* **sLSTM: channels split evenly.**  The gates and ``proj_out``'s rows
  hold the rank's di / m channels; ``r_h`` holds every row of the rank's
  output columns, so each step gathers the whole ``h`` (B, di) float32
  over the group (``all_gather_dim``, a reduce-scatter in the backward):
  one collective a step a block, in prefill, decode and training.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..launch import hlo_cost
from .layers import Dense, dense

__all__ = ["mLSTM", "sLSTM", "mlstm_train", "mlstm_init_cache",
           "mlstm_decode", "slstm_step", "slstm_train", "slstm_init_cache",
           "slstm_decode", "CHUNK", "NO_HEAD"]

State = Dict[str, torch.Tensor]
CHUNK = 128          # mlstm_train's chunk, as the reference's default
M_INIT = -1e30       # the stabiliser's start
#: mLSTM calls on a rank that holds no head
NO_HEAD = {"calls": 0}


class mLSTM(nn.Module):    # noqa: N801 -- the paper's name
    """``wq``, ``wk``, ``wv``, ``wz`` (the output gate), ``proj_out``, and
    the gates ``wi`` and ``wf`` with biases; inner width
    ``d_model * cfg.ssm_expand`` over ``cfg.n_heads`` heads of ``dk``
    channels.  With ``group``, ``heads`` of them: the rank's."""

    def __init__(self, d_model: int, cfg, *, heads: int = None, group=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.dk = d_model * cfg.ssm_expand // cfg.n_heads
        self.n_heads = cfg.n_heads if heads is None else heads
        self.group = group
        di = self.n_heads * self.dk
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
    biases, the recurrent ``r_h`` (di, di) and ``proj_out``.  With
    ``group``, ``di`` is the rank's share of the channels and ``r_h``
    (d_model · ssm_expand, di) every row of its columns."""

    def __init__(self, d_model: int, cfg, *, di: int = None, group=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        width = d_model * cfg.ssm_expand
        di = width if di is None else di
        self.group = group
        kw = dict(device=device, dtype=dtype)
        self.wz = Dense(d_model, di, bias=True, **kw)
        self.wi = Dense(d_model, di, bias=True, **kw)
        self.wf = Dense(d_model, di, bias=True, **kw)
        self.wo_gate = Dense(d_model, di, bias=True, **kw)
        self.r_h = Dense(width, di, **kw)
        self.proj_out = Dense(di, d_model, **kw)

    def reset(self, generator: torch.Generator) -> None:
        for m in (self.wz, self.wi, self.wf, self.wo_gate, self.r_h,
                  self.proj_out):
            m.reset(generator)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _enter(p, x: torch.Tensor) -> torch.Tensor:
    """A block's input: over a group, the column-parallel entry."""
    return x if p.group is None else p.group.enter(x)


def _out(p, y: torch.Tensor, compute) -> torch.Tensor:
    """``proj_out`` of ``y``; summed over the group when ``p`` holds a
    rank's share."""
    out = dense(p.proj_out, y, compute)
    return out if p.group is None else p.group.psum(out)


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
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mlstm_train: the sequence length {s} must be a "
                         f"multiple of the chunk min({chunk}, S); padding "
                         f"would change the state")
    x = _enter(p, x)
    h, dk = p.n_heads, p.dk
    q = dense(p.wq, x, compute)
    if h == 0:
        out = _no_head(p, q, compute)
        if return_state:
            return out, dict(zip(("c", "n", "m"),
                                 _mlstm_zero_state(b, 0, dk, x.device)))
        return out
    k = dense(p.wk, x, compute)
    v = dense(p.wv, x, compute)
    ig = dense(p.wi, x, compute).float()                  # log-space gates
    fg = dense(p.wf, x, compute).float()
    og = torch.sigmoid(dense(p.wz, x, compute))
    q, k, v = (t.reshape(b, s, h, dk).float() for t in (q, k, v))
    ig = ig.reshape(b, s, h, dk).mean(-1)                 # per-head gates
    fg = F.logsigmoid(fg.reshape(b, s, h, dk).mean(-1))

    scale = 1.0 / (dk ** 0.5)

    def fold(state, i):
        sl = slice(i * chunk, (i + 1) * chunk)
        state, y = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl],
                                ig[:, sl], fg[:, sl], scale)
        return state, y.to(compute)

    state, ys = hlo_cost.loop(x, s // chunk, fold,
                              _mlstm_zero_state(b, h, dk, x.device))
    y = torch.cat(ys, dim=1).reshape(b, s, -1) * og
    out = _out(p, y, compute)
    if return_state:
        return out, dict(zip(("c", "n", "m"), state))
    return out


def _no_head(p: mLSTM, q: torch.Tensor, compute) -> torch.Tensor:
    """A rank that holds no head: ``proj_out``'s zero-width product of
    ``q`` (B, S, 0) adds zeros to the group's sum and keeps the input's
    gradient path, so the backward's collectives run on this rank too."""
    NO_HEAD["calls"] += 1
    return _out(p, q, compute)


def _mlstm_zero_state(b, h, dk, device):
    return (torch.zeros((b, h, dk, dk), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device),
            torch.full((b, h), M_INIT, dtype=torch.float32, device=device))


def mlstm_init_cache(batch: int, d_model: int, cfg, device=None,
                     heads: int = None) -> State:
    """Zero (C, n) and m = -1e30, float32; ``heads``: a rank's (default
    ``cfg.n_heads``)."""
    dk = d_model * cfg.ssm_expand // cfg.n_heads
    h = cfg.n_heads if heads is None else heads
    return dict(zip(("c", "n", "m"), _mlstm_zero_state(batch, h, dk,
                                                       device)))


def mlstm_decode(p: mLSTM, x: torch.Tensor, cfg, cache: State
                 ) -> Tuple[torch.Tensor, State]:
    """One token, x: (B, 1, d_model) -> (y (B, 1, d_model), new state)."""
    compute = x.dtype
    b = x.shape[0]
    x = _enter(p, x)
    h, dk = p.n_heads, p.dk
    if h == 0:
        return _no_head(p, dense(p.wq, x, compute), compute), cache
    q = dense(p.wq, x, compute)[:, 0]
    k = dense(p.wk, x, compute)[:, 0]
    v = dense(p.wv, x, compute)[:, 0]
    ig = dense(p.wi, x, compute).float()[:, 0]
    fg = dense(p.wf, x, compute).float()[:, 0]
    og = torch.sigmoid(dense(p.wz, x, compute))[:, 0]
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
    return _out(p, y, compute), {"c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_step(p: sLSTM, state, zi, ii, fi, oi):
    """One sLSTM timestep: ``state`` = (c, n, h, m), each (B, di) float32;
    the gate pre-activations (B, di) float32.  Over a group, ``h`` is
    gathered whole for the recurrence (module docstring)."""
    c, n, h, m = state
    if p.group is not None:
        h = p.group.all_gather_dim(h, -1, own_loss=True)
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
    in order.  ``return_state`` also returns ``{"c", "n", "h", "m"}``.
    Counted on the meta device, the middle trips run once (module
    docstring)."""
    compute = x.dtype
    b, s, _ = x.shape
    gates = _slstm_gates(p, _enter(p, x))
    state = _slstm_zero_state(b, gates[0].shape[-1], x.device)

    def step(state, t):
        state = slstm_step(p, state, *(g[:, t] for g in gates))
        return state, state[2]

    state, hs = hlo_cost.loop(x, s, step, state)
    y = torch.stack(hs, dim=1).to(compute)
    out = _out(p, y, compute)
    if return_state:
        return out, dict(zip(("c", "n", "h", "m"), state))
    return out


def _slstm_zero_state(b, di, device):
    zeros = [torch.zeros((b, di), dtype=torch.float32, device=device)
             for _ in range(3)]
    return tuple(zeros) + (torch.full((b, di), M_INIT, dtype=torch.float32,
                                      device=device),)


def slstm_init_cache(batch: int, d_model: int, cfg, device=None,
                     di: int = None) -> State:
    """Zero (c, n, h) and m = -1e30, float32; ``di``: a rank's share of
    the channels (default all of them)."""
    di = d_model * cfg.ssm_expand if di is None else di
    return dict(zip(("c", "n", "h", "m"), _slstm_zero_state(batch, di,
                                                            device)))


def slstm_decode(p: sLSTM, x: torch.Tensor, cfg, cache: State
                 ) -> Tuple[torch.Tensor, State]:
    """One token, x: (B, 1, d_model) -> (y (B, 1, d_model), new state)."""
    compute = x.dtype
    zi, ii, fi, oi = (g[:, 0] for g in _slstm_gates(p, _enter(p, x)))
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    c, n, h, m = slstm_step(p, state, zi, ii, fi, oi)
    y = h[:, None].to(compute)
    return _out(p, y, compute), {"c": c, "n": n, "h": h, "m": m}
