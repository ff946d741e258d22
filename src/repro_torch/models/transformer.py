"""The dense transformer: init / forward / prefill / decode (see
``repro.models.transformer``).

``family == "dense"`` with ``n_experts == 0`` is ported: a pre-norm decoder
(GQA + RoPE + [SwiGLU | GeLU], RMSNorm or LayerNorm).  The layers are a
Python loop over an ``nn.ModuleList`` where the reference scans stacked
parameters; ``from_arrays`` / ``to_arrays`` convert between the two, so the
reference's ``init_params`` pytree loads bit for bit.  Other families, MoE
and ``loss_fn`` raise ``NotImplementedError`` naming their ``ROADMAP.md``
item.

The cache keeps the reference's layout, ``{"attn": {"k", "v"}}`` with
shape (n_layers, B, max_seq, Hkv, D) in the compute dtype; prefill and
decode write it in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve
from . import attention as attn
from .layers import (MLP, Embed, Norm, dtype_of, embed_apply, mlp_apply,
                     norm_apply, unembed_apply)

__all__ = ["Transformer", "n_scan_steps"]

Cache = Dict[str, Dict[str, torch.Tensor]]
_ITEM = "ROADMAP.md Queue 1 item 15"


def n_scan_steps(cfg) -> int:
    if cfg.family == "hybrid":
        assert cfg.n_layers % cfg.attn_every == 0
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        assert cfg.n_layers % len(cfg.block_pattern) == 0
        return cfg.n_layers // len(cfg.block_pattern)
    return cfg.n_layers


def _check_supported(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: "
                                  f"{_ITEM}")
    if cfg.n_experts > 0:
        raise NotImplementedError(f"MoE layers are not ported yet: {_ITEM}")


class Block(nn.Module):
    """One pre-norm decoder layer: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **kw)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim,
                                   qkv_bias=cfg.qkv_bias, **kw)
        self.ln2 = Norm(cfg.d_model, cfg.norm, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw)


class Transformer(nn.Module):
    """A dense decoder whose tensors sit under the reference's pytree keys
    (``embed.tok.table``, ``norm_f.scale``, ``lm_head.table``,
    ``layers.<i>.attn.wq.w``, ...), in ``dtype`` (default
    ``cfg.param_dtype``).  The constructor leaves them uninitialised: use
    :meth:`init_params` or :meth:`from_arrays`."""

    def __init__(self, cfg, *, device: DeviceLike = None, dtype=None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve(device)
        dt = dtype or dtype_of(cfg.param_dtype)
        kw = dict(device=dev, dtype=dt)
        self.cfg = cfg
        self.embed = nn.ModuleDict(
            {"tok": Embed(cfg.vocab_size, cfg.d_model, **kw)})
        self.norm_f = Norm(cfg.d_model, cfg.norm, **kw)
        self.lm_head = None if cfg.tie_embeddings else \
            Embed(cfg.vocab_size, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(n_scan_steps(cfg)))

    # -- parameters ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.norm_f.scale.device

    @property
    def param_dtype(self) -> torch.dtype:
        return self.norm_f.scale.dtype

    @classmethod
    @torch.no_grad()
    def init_params(cls, cfg, generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None) -> "Transformer":
        """Random weights with the reference's distributions (dense: normal
        scaled by 1/√d_in; embeddings: normal·0.02; biases 0; norm scales 1)
        drawn from ``generator`` (default: seed 0 on the model's device).
        The same seed gives other numbers than the reference's ``PRNGKey``."""
        model = cls(cfg, device=device)
        gen = generator if generator is not None else \
            torch.Generator(device=model.device).manual_seed(0)
        model.embed["tok"].reset(gen)
        if model.lm_head is not None:
            model.lm_head.reset(gen)
        model.norm_f.reset()
        for blk in model.layers:
            blk.ln1.reset()
            blk.attn.reset(gen)
            blk.ln2.reset()
            blk.mlp.reset(gen)
        return model

    @classmethod
    @torch.no_grad()
    def from_arrays(cls, cfg, arrays: Dict[str, Any],
                    device: DeviceLike = None) -> "Transformer":
        """Load the reference's ``init_params`` pytree: nested dicts of
        arrays, ``params["layers"]`` leaves with a leading layer axis."""
        model = cls(cfg, device=device)
        flat = {}
        for key, a in _flatten(arrays):
            a = np.asarray(a)
            if key.startswith("layers."):
                rest = key[len("layers."):]
                for i in range(a.shape[0]):
                    flat[f"layers.{i}.{rest}"] = a[i]
            else:
                flat[key] = a
        params = dict(model.named_parameters())
        if set(flat) != set(params):
            raise ValueError(
                f"arrays do not match the model: missing "
                f"{sorted(set(params) - set(flat))}, unexpected "
                f"{sorted(set(flat) - set(params))}")
        for key, p in params.items():
            if tuple(flat[key].shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {flat[key].shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(flat[key])))
        return model

    def to_arrays(self) -> Dict[str, Any]:
        """The inverse of :meth:`from_arrays`: numpy arrays, layers stacked."""
        out: Dict[str, Any] = {}
        stacked: Dict[str, list] = {}
        for key, p in self.named_parameters():
            a = p.detach().cpu().numpy()
            if key.startswith("layers."):
                _, i, rest = key.split(".", 2)
                stacked.setdefault(rest, []).append((int(i), a))
            else:
                _set(out, key, a)
        for rest, items in stacked.items():
            _set(out, "layers." + rest,
                 np.stack([a for _, a in sorted(items, key=lambda t: t[0])]))
        return out

    @torch.no_grad()
    def astype(self, dtype: torch.dtype) -> "Transformer":
        """A copy with every tensor cast to ``dtype`` (round to nearest
        even): the numbers each apply's own cast would give."""
        new = Transformer(self.cfg, device=self.device, dtype=dtype)
        new.load_state_dict(self.state_dict())
        return new

    # -- full sequence ------------------------------------------------------

    def _head(self) -> Embed:
        return self.embed["tok"] if self.cfg.tie_embeddings else self.lm_head

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor], chunk: int = 1024,
                skip_upper_triangle: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward of ``batch["tokens"]`` (B, S) -> (logits
        (B, S, V), aux loss 0)."""
        cfg = self.cfg
        compute = dtype_of(cfg.compute_dtype)
        x = embed_apply(self.embed["tok"], batch["tokens"], compute)
        for blk in self.layers:
            h = norm_apply(blk.ln1, x, cfg.norm)
            x = x + attn.attention_train(
                blk.attn, h, cfg, causal=True, chunk=chunk,
                skip_upper_triangle=skip_upper_triangle)
            h = norm_apply(blk.ln2, x, cfg.norm)
            x = x + mlp_apply(blk.mlp, h, cfg.act, h.dtype)
        x = norm_apply(self.norm_f, x, cfg.norm)
        logits = unembed_apply(self._head(), x, compute)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss_fn(self, batch, chunk: int = 1024,
                skip_upper_triangle: bool = True):
        raise NotImplementedError(f"training is not ported yet: {_ITEM}")

    # -- serving ------------------------------------------------------------

    def init_cache(self, batch_size: int, max_seq: int) -> Cache:
        """Zeroed K/V, (n_layers, B, max_seq, Hkv, D) in the compute dtype."""
        cfg = self.cfg
        n = n_scan_steps(cfg)
        per = attn.init_kv_cache(n * batch_size, max_seq, cfg.n_kv_heads,
                                 cfg.resolved_head_dim,
                                 dtype_of(cfg.compute_dtype), self.device)
        return {"attn": {k: t.view(n, batch_size, *t.shape[1:])
                         for k, t in per.items()}}

    @staticmethod
    def _layer_cache(cache: Cache, i: int) -> Dict[str, torch.Tensor]:
        return {"k": cache["attn"]["k"][i], "v": cache["attn"]["v"][i]}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_seq: int,
                chunk: int = 1024) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt ``batch["tokens"]`` (B, S) -> (last-token logits
        (B, 1, V), a new cache holding the prompt's K/V)."""
        cfg = self.cfg
        compute = dtype_of(cfg.compute_dtype)
        tokens = batch["tokens"]
        cache = self.init_cache(tokens.shape[0], max_seq)
        x = embed_apply(self.embed["tok"], tokens, compute)
        for i, blk in enumerate(self.layers):
            h = norm_apply(blk.ln1, x, cfg.norm)
            a, _ = attn.attention_prefill(blk.attn, h, cfg,
                                          self._layer_cache(cache, i),
                                          chunk=chunk)
            x = x + a
            h = norm_apply(blk.ln2, x, cfg.norm)
            x = x + mlp_apply(blk.mlp, h, cfg.act, h.dtype)
        x = norm_apply(self.norm_f, x, cfg.norm)
        return unembed_apply(self._head(), x[:, -1:], compute), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos,
                    enc_out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step at position ``pos``. tokens: (B, 1) -> (logits
        (B, 1, V), the cache with this token's K/V written in place)."""
        if enc_out is not None:
            raise NotImplementedError(f"cross-attention is not ported yet: "
                                      f"{_ITEM}")
        cfg = self.cfg
        compute = dtype_of(cfg.compute_dtype)
        if not isinstance(pos, torch.Tensor):   # one device scalar per step
            pos = torch.full((1,), int(pos), dtype=torch.long,
                             device=self.device)
        x = embed_apply(self.embed["tok"], tokens, compute)
        for i, blk in enumerate(self.layers):
            h = norm_apply(blk.ln1, x, cfg.norm)
            a, _ = attn.attention_decode(blk.attn, h, cfg,
                                         self._layer_cache(cache, i), pos)
            x = x + a
            h = norm_apply(blk.ln2, x, cfg.norm)
            x = x + mlp_apply(blk.mlp, h, cfg.act, h.dtype)
        x = norm_apply(self.norm_f, x, cfg.norm)
        return unembed_apply(self._head(), x, compute), cache


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key + ".")
        else:
            yield key, v


def _set(tree: Dict[str, Any], dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[leaf] = value
