"""Common layers: dense, norms, embeddings and the MLP (see ``repro.models.layers``).

Conventions, as in the reference:

* parameters are stored in ``cfg.param_dtype``; a dense weight is
  ``(d_in, d_out)`` and is applied as ``x @ w``;
* each apply casts to the compute dtype it is given and returns activations
  in it (norms compute in float32 and cast back).

A module holds its tensors under the reference's pytree keys (``w``, ``b``,
``scale``, ``bias``, ``table``), so a ``state_dict`` key names the same leaf
as the reference's parameter path.  Parameters are trainable; the serving
entry points run under ``torch.no_grad``.

Tensor parallel: a parameter of a model sharded over ranks holds its
rank's block and carries ``full_shape`` (the unsharded shape) and
``keep`` (full tensor -> the rank's block); :func:`fill_normal_` draws the
full tensor, as an unsharded model draws it, and keeps the block, so the
ranks together hold the unsharded model's numbers.  An :class:`Embed` or
:class:`MLP` built with a ``group`` is vocab- or column/row-parallel over
it (:func:`embed_apply`, :func:`unembed_apply`, :func:`mlp_apply`):
each column-parallel product's input passes ``group.enter`` (backward:
the ranks' input gradients summed) and each row-parallel output
``group.psum`` (backward: the identity), Megatron's pair, so the sharded
forward trains (``launch/mesh.ModelGroup``).

Weights split over "data" too (``two_d_weights``, the giant models): a
parameter whose spec puts a dim on a data axis of more than one rank also
carries ``data_dim`` (that dim) and ``data_grid`` (the grid), and every
apply reads it through :func:`weight`, which gathers it whole on that dim
where it is used (ZeRO-3's gather, ``launch/mesh.ModelGrid.weight``) and
frees it after; the norms and whatever else the rules replicate carry
neither and are read as they are.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["dtype_of", "Dense", "Norm", "Embed", "MLP", "dense",
           "norm_apply", "embed_apply", "unembed_apply", "mlp_apply",
           "full_shape", "fill_normal_", "weight"]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _empty(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def full_shape(p: torch.Tensor) -> tuple:
    """``p``'s unsharded shape (its own shape unless it is a rank's
    block)."""
    return getattr(p, "full_shape", tuple(p.shape))


def weight(p: torch.Tensor, dtype) -> torch.Tensor:
    """Parameter ``p`` as an apply reads it, in ``dtype``: gathered whole on
    its ``data_dim`` over the data ranks when it carries one (module
    docstring)."""
    grid = getattr(p, "data_grid", None)
    if grid is None:
        return p.to(dtype)
    return grid.weight(p, p.data_dim, dtype)


def fill_normal_(p: torch.Tensor, generator: torch.Generator,
                 scale: float) -> None:
    """``p`` <- normal(0, 1) · ``scale`` from ``generator``, drawn in float32
    at ``p``'s full shape (one tensor alive at a time), then cut to its
    block and cast."""
    w = torch.randn(full_shape(p), generator=generator,
                    device=p.device).mul_(scale)
    keep = getattr(p, "keep", None)
    p.copy_(w if keep is None else keep(w))


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """``x @ w (+ b)``; ``w`` is (d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.w = _empty((d_in, d_out), device, dtype)
        self.b = _empty((d_out,), device, dtype) if bias else None

    def reset(self, generator: torch.Generator) -> None:
        """Normal(0, 1/d_in) weights and zero bias, as ``dense_init``."""
        fill_normal_(self.w, generator, 1.0 / full_shape(self.w)[0] ** 0.5)
        if self.b is not None:
            self.b.zero_()


def dense(p: Dense, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = torch.matmul(x.to(compute_dtype), weight(p.w, compute_dtype))
    if p.b is not None:
        y = y + weight(p.b, compute_dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``).  With
    ``stack=n`` it holds n norms on a leading axis, (n, d) each, as the
    reference's stacked ``norm_init`` (an xLSTM period's ``ln``); ``row(i)``
    is norm i."""

    def __init__(self, d: int, kind: str, *, stack: int = 0, device=None,
                 dtype=torch.float32):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {kind!r}")
        shape = (stack, d) if stack else (d,)
        self.scale = _empty(shape, device, dtype)
        self.bias = _empty(shape, device, dtype) if kind == "layernorm" \
            else None

    def reset(self, generator: Optional[torch.Generator] = None) -> None:
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def row(self, i: int) -> SimpleNamespace:
        """Norm i of a stack, for :func:`norm_apply`."""
        return SimpleNamespace(scale=self.scale[i], bias=None
                               if self.bias is None else self.bias[i])


def norm_apply(p: Norm, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)   # jnp.var
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p.scale.float() + p.bias.float()
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p.scale.float()
    return y.to(dt)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    """A (vocab, d) ``table``: token lookup, or logits ``x @ tableᵀ``.  With
    ``group``, the table's rows [``lo``, ``lo + vocab``) of a vocabulary
    split over the group."""

    def __init__(self, vocab: int, d: int, *, group=None, lo: int = 0,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.table = _empty((vocab, d), device, dtype)
        self.group, self.lo = group, lo

    def reset(self, generator: torch.Generator) -> None:
        """Normal(0, 0.02²), as ``embed_init``."""
        fill_normal_(self.table, generator, 0.02)


def embed_apply(p: Embed, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Token rows; vocab-parallel, each rank looks up the ids in its range
    (the others give zeros) and the group sums: one rank's row plus zeros,
    exact."""
    table = weight(p.table, p.table.dtype)    # the whole d of the rows
    if p.group is None:
        # rows cast after the lookup: the same numbers as casting the table
        return F.embedding(tokens.long(), table).to(compute_dtype)
    ids = tokens.long() - p.lo
    mine = (ids >= 0) & (ids < table.shape[0])
    rows = F.embedding(torch.where(mine, ids, 0), table)
    rows = rows * mine[..., None].to(rows.dtype)
    return p.group.psum(rows.to(compute_dtype))


def unembed_apply(p: Embed, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Logits = x @ tableᵀ (tied or with a separate lm_head table);
    vocab-parallel, the ranks' logits gathered along the vocabulary, so
    every rank holds them all (backward: its slice of the logits'
    gradient, and the group's sum of ``x``'s)."""
    if p.group is not None:
        x = p.group.enter(x)
    y = torch.matmul(x.to(compute_dtype), weight(p.table, compute_dtype).t())
    return y if p.group is None else p.group.all_gather_dim(y, -1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``wi`` (up), ``wo`` (down) and, for SwiGLU, ``wg`` (gate).  With
    ``group``, ``d_ff`` is the rank's share: ``wi`` / ``wg`` column blocks,
    ``wo`` a row block, its output summed over the group."""

    def __init__(self, d: int, d_ff: int, act: str, *, group=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if act not in ("swiglu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.group = group
        self.wi = Dense(d, d_ff, device=device, dtype=dtype)
        self.wo = Dense(d_ff, d, device=device, dtype=dtype)
        self.wg = Dense(d, d_ff, device=device, dtype=dtype) \
            if act == "swiglu" else None

    def reset(self, generator: torch.Generator) -> None:
        for m in (self.wi, self.wo, self.wg):
            if m is not None:
                m.reset(generator)


def mlp_apply(p: MLP, x: torch.Tensor, act: str, compute_dtype) -> torch.Tensor:
    if p.group is not None:     # column-parallel entry: x's gradient summed
        x = p.group.enter(x)
    h = dense(p.wi, x, compute_dtype)
    if act == "swiglu":
        h = F.silu(dense(p.wg, x, compute_dtype)) * h
    else:
        h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    y = dense(p.wo, h, compute_dtype)
    return y if p.group is None else p.group.psum(y)
