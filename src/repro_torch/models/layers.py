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
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["dtype_of", "Dense", "Norm", "Embed", "MLP", "dense",
           "norm_apply", "embed_apply", "unembed_apply", "mlp_apply"]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _empty(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


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
        d_in = self.w.shape[0]
        w = torch.randn(self.w.shape, generator=generator,
                        device=self.w.device) * (1.0 / d_in ** 0.5)
        self.w.copy_(w)
        if self.b is not None:
            self.b.zero_()


def dense(p: Dense, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = torch.matmul(x.to(compute_dtype), p.w.to(compute_dtype))
    if p.b is not None:
        y = y + p.b.to(compute_dtype)
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
    """A (vocab, d) ``table``: token lookup, or logits ``x @ tableᵀ``."""

    def __init__(self, vocab: int, d: int, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.table = _empty((vocab, d), device, dtype)

    def reset(self, generator: torch.Generator) -> None:
        """Normal(0, 0.02²), as ``embed_init``."""
        self.table.copy_(torch.randn(self.table.shape, generator=generator,
                                     device=self.table.device) * 0.02)


def embed_apply(p: Embed, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # rows cast after the lookup: the same numbers as casting the table
    return F.embedding(tokens.long(), p.table).to(compute_dtype)


def unembed_apply(p: Embed, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Logits = x @ tableᵀ (tied or with a separate lm_head table)."""
    return torch.matmul(x.to(compute_dtype), p.table.to(compute_dtype).t())


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``wi`` (up), ``wo`` (down) and, for SwiGLU, ``wg`` (gate)."""

    def __init__(self, d: int, d_ff: int, act: str, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if act not in ("swiglu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.wi = Dense(d, d_ff, device=device, dtype=dtype)
        self.wo = Dense(d_ff, d, device=device, dtype=dtype)
        self.wg = Dense(d, d_ff, device=device, dtype=dtype) \
            if act == "swiglu" else None

    def reset(self, generator: torch.Generator) -> None:
        for m in (self.wi, self.wo, self.wg):
            if m is not None:
                m.reset(generator)


def mlp_apply(p: MLP, x: torch.Tensor, act: str, compute_dtype) -> torch.Tensor:
    h = dense(p.wi, x, compute_dtype)
    if act == "swiglu":
        h = F.silu(dense(p.wg, x, compute_dtype)) * h
    else:
        h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    return dense(p.wo, h, compute_dtype)
