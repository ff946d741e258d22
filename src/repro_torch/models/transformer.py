"""The dense and MoE transformer: init / forward / loss / prefill / decode
(see ``repro.models.transformer``).

``family`` ``"dense"`` and ``"moe"`` are ported: a pre-norm decoder (GQA +
RoPE + [SwiGLU | GeLU], RMSNorm or LayerNorm) whose FFN is an MLP, or with
``n_experts > 0`` the sort-routed MoE of :mod:`.moe`.  The layers are a
Python loop over an ``nn.ModuleList`` where the reference scans stacked
parameters; ``from_arrays`` / ``to_arrays`` convert between the two, so the
reference's ``init_params`` pytree loads bit for bit.  Other families
raise ``NotImplementedError`` naming their ``ROADMAP.md`` item.

Training: :meth:`Transformer.forward_train` is the forward with autograd
on, each block wrapped per ``cfg.remat`` (the reference's ``_maybe_ckpt``):
``"full"`` recomputes the whole block in the backward
(``torch.utils.checkpoint``), ``"dots"`` keeps the matrix products' outputs
and recomputes the rest (selective checkpointing, the nearest policy to
``jax.checkpoint_policies.checkpoint_dots``), ``"none"`` keeps everything.
:meth:`Transformer.loss_fn` is the reference's ``loss_fn``.  The serving
entry points (``forward``, ``prefill``, ``decode_step``) run under
``torch.no_grad`` and compute the same bits as before.  The MoE layers'
load-balance losses sum into ``forward``'s aux, as in the reference;
``prefill`` and ``decode_step`` drop them.

The cache keeps the reference's layout, ``{"attn": {"k", "v"}}`` with
shape (n_layers, B, max_seq, Hkv, D) in the compute dtype; prefill and
decode write it in place.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import DeviceLike, resolve
from . import attention as attn
from . import moe as moe_mod
from .layers import (MLP, Embed, Norm, dtype_of, embed_apply, mlp_apply,
                     norm_apply, unembed_apply)

__all__ = ["Transformer", "n_scan_steps", "REMAT"]

Cache = Dict[str, Dict[str, torch.Tensor]]
_ITEM = "ROADMAP.md Queue 1 item 15"
REMAT = ("full", "dots", "none")


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of matrix products, recompute everything else."""
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_DOT_OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.matmul.default}


def _ffn(blk: "Block", h: torch.Tensor, cfg
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on ``h`` -> (output, the MoE's aux loss or None)."""
    if blk.moe is not None:
        return moe_mod.moe_apply(blk.moe, h, cfg)
    return mlp_apply(blk.mlp, h, cfg.act, h.dtype), None


def _block_apply(blk: "Block", x: torch.Tensor, cfg, chunk: int,
                 skip_upper_triangle: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = norm_apply(blk.ln1, x, cfg.norm)
    x = x + attn.attention_train(blk.attn, h, cfg, causal=True, chunk=chunk,
                                 skip_upper_triangle=skip_upper_triangle)
    f, aux = _ffn(blk, norm_apply(blk.ln2, x, cfg.norm), cfg)
    return x + f, aux


def n_scan_steps(cfg) -> int:
    if cfg.family == "hybrid":
        assert cfg.n_layers % cfg.attn_every == 0
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        assert cfg.n_layers % len(cfg.block_pattern) == 0
        return cfg.n_layers // len(cfg.block_pattern)
    return cfg.n_layers


def _check_supported(cfg) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: "
                                  f"{_ITEM}")


class Block(nn.Module):
    """One pre-norm decoder layer: ``ln1``, ``attn``, ``ln2``, and ``mlp``
    or, with ``cfg.n_experts > 0``, ``moe``."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **kw)
        self.attn = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim,
                                   qkv_bias=cfg.qkv_bias, **kw)
        self.ln2 = Norm(cfg.d_model, cfg.norm, **kw)
        if cfg.n_experts > 0:
            self.mlp = None
            self.moe = moe_mod.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                   cfg.act, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw)
            self.moe = None


class Transformer(nn.Module):
    """A decoder whose tensors sit under the reference's pytree keys
    (``embed.tok.table``, ``norm_f.scale``, ``lm_head.table``,
    ``layers.<i>.attn.wq.w``, ``layers.<i>.moe.wi``, ...), in ``dtype``
    (default ``cfg.param_dtype``; an MoE router stays float32, as the
    reference's).  The constructor leaves them uninitialised: use
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
        """Random weights with the reference's distributions (dense and
        experts: normal scaled by 1/√d_in; embeddings: normal·0.02; biases
        0; norm scales 1) drawn from ``generator`` (default: seed 0 on the
        model's device).
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
            (blk.mlp if blk.moe is None else blk.moe).reset(gen)
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
        even): the numbers each apply's own cast would give.  An MoE
        router stays float32, as its apply reads it."""
        new = Transformer(self.cfg, device=self.device, dtype=dtype)
        new.load_state_dict(self.state_dict())
        return new

    # -- full sequence ------------------------------------------------------

    def _head(self) -> Embed:
        return self.embed["tok"] if self.cfg.tie_embeddings else self.lm_head

    def _forward(self, batch: Dict[str, torch.Tensor], chunk: int,
                 skip_upper_triangle: bool, remat: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        compute = dtype_of(cfg.compute_dtype)
        x = embed_apply(self.embed["tok"], batch["tokens"], compute)
        body = functools.partial(_block_apply, cfg=cfg, chunk=chunk,
                                 skip_upper_triangle=skip_upper_triangle)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            if remat == "full":
                x, aux_l = ckpt.checkpoint(body, blk, x, use_reentrant=False)
            elif remat == "dots":
                x, aux_l = ckpt.checkpoint(
                    body, blk, x, use_reentrant=False,
                    context_fn=functools.partial(
                        ckpt.create_selective_checkpoint_contexts,
                        _dots_policy))
            else:
                x, aux_l = body(blk, x)
            if aux_l is not None:
                aux = aux + aux_l
        x = norm_apply(self.norm_f, x, cfg.norm)
        logits = unembed_apply(self._head(), x, compute)
        return logits, aux

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor], chunk: int = 1024,
                skip_upper_triangle: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward of ``batch["tokens"]`` (B, S) -> (logits
        (B, S, V), the MoE layers' summed aux loss; 0 for a dense model)."""
        return self._forward(batch, chunk, skip_upper_triangle, "none")

    def forward_train(self, batch: Dict[str, torch.Tensor], chunk: int = 1024,
                      skip_upper_triangle: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward` with autograd on and each block rematerialised
        per ``cfg.remat``; the same numbers."""
        if self.cfg.remat not in REMAT:
            raise ValueError(f"unknown remat {self.cfg.remat!r}; want one of "
                             f"{REMAT}")
        return self._forward(batch, chunk, skip_upper_triangle,
                             self.cfg.remat)

    def loss_fn(self, batch: Dict[str, torch.Tensor], chunk: int = 1024,
                skip_upper_triangle: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's ``loss_fn``: mean next-token cross entropy over
        ``batch["loss_mask"]`` (default all ones) from float32 logits,
        plus 0.01 x the aux loss -> (total, {"ce", "aux"})."""
        logits, aux = self.forward_train(batch, chunk, skip_upper_triangle)
        targets = batch["targets"].long()
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=logits.device)
        ce = torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                           min=1.0)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux}

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
            x = x + _ffn(blk, norm_apply(blk.ln2, x, cfg.norm), cfg)[0]
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
            x = x + _ffn(blk, norm_apply(blk.ln2, x, cfg.norm), cfg)[0]
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
