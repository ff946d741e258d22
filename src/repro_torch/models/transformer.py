"""The transformer families: init / forward / loss / prefill / decode
(see ``repro.models.transformer``).

Ported families:

* ``"dense"`` and ``"moe"``: a pre-norm decoder (GQA + RoPE + [SwiGLU |
  GeLU], RMSNorm or LayerNorm) whose FFN is an MLP, or with
  ``n_experts > 0`` the sort-routed MoE of :mod:`.moe`;
* ``"vlm"`` (internvl2): the dense decoder over [patch-embedding prefix |
  tokens]; ``batch["patch_embeds"]`` (B, P, d) is concatenated before the
  first layer, ``forward`` drops the P patch logits, and the cache holds
  P + S positions (decode continues at ``pos = P + S``);
* ``"audio"`` (whisper): a bidirectional encoder over the stub frame
  embeddings ``batch["enc_embeds"]`` (B, Se, d) (:meth:`Transformer.
  encode`, K4 non-causal), and a causal decoder whose layers add
  cross-attention (``ln_x``, ``xattn``) to the encoder's output.  As in the
  reference, ``prefill`` runs the encoder itself and ``decode_step`` takes
  its output as ``enc_out``, so a generation runs the encoder twice;
* ``"ssm"`` (xLSTM): periods of ``cfg.block_pattern`` blocks (mLSTM /
  sLSTM, :mod:`.xlstm`) with a stacked pre-norm ``ln`` and no FFN;
  ``prefill`` returns the blocks' terminal recurrent states as the cache.

``"hybrid"`` (jamba) raises ``NotImplementedError`` naming its
``ROADMAP.md`` item.  The layers are a Python loop over an
``nn.ModuleList`` where the reference scans stacked parameters;
``from_arrays`` / ``to_arrays`` convert between the two (``layers`` and
``enc.layers`` are stacked), so the reference's ``init_params`` pytree
loads bit for bit.

Training: :meth:`Transformer.forward_train` is the forward with autograd
on, each block (and encoder layer) wrapped per ``cfg.remat`` (the
reference's ``_maybe_ckpt``): ``"full"`` recomputes the whole block in the
backward (``torch.utils.checkpoint``), ``"dots"`` keeps the matrix
products' outputs and recomputes the rest (selective checkpointing, the
nearest policy to ``jax.checkpoint_policies.checkpoint_dots``), ``"none"``
keeps everything.  :meth:`Transformer.loss_fn` is the reference's
``loss_fn``.  The serving entry points (``forward``, ``encode``,
``prefill``, ``decode_step``) run under ``torch.no_grad`` and compute the
same bits as before.  The MoE layers' load-balance losses sum into
``forward``'s aux, as in the reference; ``prefill`` and ``decode_step``
drop them.

The cache keeps the reference's layout: ``{"attn": {"k", "v"}}`` with
shape (n_layers, B, max_seq, Hkv, D) in the compute dtype for the
attention families, ``{"b<i>": {"c", "n", "m"} | {"c", "n", "h", "m"}}``
float32 states with a leading period axis for xLSTM.  Prefill and decode
write it in place.
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
from . import xlstm as xlstm_mod
from .layers import (MLP, Embed, Norm, dtype_of, embed_apply, mlp_apply,
                     norm_apply, unembed_apply)

__all__ = ["Transformer", "n_scan_steps", "REMAT"]

Cache = Dict[str, Dict[str, torch.Tensor]]
_FAMILIES = ("dense", "moe", "ssm", "audio", "vlm")   # the ported ones
_STACKED = ("layers.", "enc.layers.")   # stacked on a leading axis
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


def _block_apply(blk: "Block", x: torch.Tensor,
                 enc_out: Optional[torch.Tensor], cfg, chunk: int,
                 skip_upper_triangle: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One decoder layer; with ``enc_out``, cross-attention after the
    self-attention."""
    h = norm_apply(blk.ln1, x, cfg.norm)
    x = x + attn.attention_train(blk.attn, h, cfg, causal=True, chunk=chunk,
                                 skip_upper_triangle=skip_upper_triangle)
    if enc_out is not None:
        x = x + attn.attention_train(blk.xattn, norm_apply(blk.ln_x, x,
                                                           cfg.norm),
                                     cfg, kv_override=(enc_out, enc_out),
                                     chunk=chunk)
    f, aux = _ffn(blk, norm_apply(blk.ln2, x, cfg.norm), cfg)
    return x + f, aux


def _enc_block_apply(blk: "Block", x: torch.Tensor, cfg, chunk: int
                     ) -> torch.Tensor:
    """One bidirectional encoder layer (K4 non-causal)."""
    x = x + attn.attention_train(blk.attn, norm_apply(blk.ln1, x, cfg.norm),
                                 cfg, causal=False, chunk=chunk,
                                 skip_upper_triangle=False)
    return x + mlp_apply(blk.mlp, norm_apply(blk.ln2, x, cfg.norm), cfg.act,
                         x.dtype)


def _xlstm_apply(blk: "XlstmPeriod", x: torch.Tensor, cfg, states=None
                 ) -> Tuple[torch.Tensor, None]:
    """One xLSTM period; with ``states`` (a list), each block's terminal
    state is appended to it."""
    for i, kind in enumerate(cfg.block_pattern):
        h = norm_apply(blk.ln.row(i), x, cfg.norm)
        train = xlstm_mod.mlstm_train if kind == "mlstm" \
            else xlstm_mod.slstm_train
        if states is None:
            y = train(blk.mixer(i), h, cfg)
        else:
            y, st = train(blk.mixer(i), h, cfg, return_state=True)
            states.append(st)
        x = x + y
    return x, None


def _remat(body, remat: str):
    """``body`` wrapped per ``cfg.remat`` (the reference's ``_maybe_ckpt``)."""
    if remat == "full":
        return functools.partial(ckpt.checkpoint, body, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    return body


def n_scan_steps(cfg) -> int:
    if cfg.family == "hybrid":
        assert cfg.n_layers % cfg.attn_every == 0
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        assert cfg.n_layers % len(cfg.block_pattern) == 0
        return cfg.n_layers // len(cfg.block_pattern)
    return cfg.n_layers


def _check_supported(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: "
                                  f"{_ITEM}")


class Block(nn.Module):
    """One pre-norm layer: ``ln1``, ``attn``, ``ln2``, and ``mlp`` or,
    with ``cfg.n_experts > 0``, ``moe``; with ``cross``, whisper's decoder
    layer, also ``ln_x`` and ``xattn``.  An encoder layer is a Block with
    neither."""

    def __init__(self, cfg, *, cross: bool = False, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)

        def attention():
            return attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim,
                                  qkv_bias=cfg.qkv_bias, **kw)

        self.ln1 = Norm(cfg.d_model, cfg.norm, **kw)
        self.attn = attention()
        self.ln_x = Norm(cfg.d_model, cfg.norm, **kw) if cross else None
        self.xattn = attention() if cross else None
        self.ln2 = Norm(cfg.d_model, cfg.norm, **kw)
        if cfg.n_experts > 0:
            self.mlp = None
            self.moe = moe_mod.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                   cfg.act, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, **kw)
            self.moe = None

    def reset(self, generator: torch.Generator) -> None:
        self.ln1.reset()
        self.attn.reset(generator)
        if self.xattn is not None:
            self.ln_x.reset()
            self.xattn.reset(generator)
        self.ln2.reset()
        (self.mlp if self.moe is None else self.moe).reset(generator)


class XlstmPeriod(nn.Module):
    """One xLSTM period: ``ln``, the stacked pre-norms (len(pattern), d),
    and ``b<i>_mlstm`` / ``b<i>_slstm`` for block i of
    ``cfg.block_pattern``."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln = Norm(cfg.d_model, cfg.norm, stack=len(cfg.block_pattern),
                       **kw)
        self.kinds = tuple(cfg.block_pattern)
        for i, kind in enumerate(self.kinds):
            cls = xlstm_mod.mLSTM if kind == "mlstm" else xlstm_mod.sLSTM
            self.add_module(f"b{i}_{kind}", cls(cfg.d_model, cfg, **kw))

    def mixer(self, i: int) -> nn.Module:
        return getattr(self, f"b{i}_{self.kinds[i]}")

    def reset(self, generator: torch.Generator) -> None:
        self.ln.reset()
        for i in range(len(self.kinds)):
            self.mixer(i).reset(generator)


def _float32_reads(model: nn.Module):
    """The parameters an apply reads in float32 whatever the compute dtype
    (the reference's ``astype(float32)`` of the parameter): norm scales and
    biases, and sLSTM's recurrent ``r_h``."""
    for m in model.modules():
        if isinstance(m, Norm):
            yield from m.parameters()
        elif isinstance(m, xlstm_mod.sLSTM):
            yield from m.r_h.parameters()


class Transformer(nn.Module):
    """A model whose tensors sit under the reference's pytree keys
    (``embed.tok.table``, ``norm_f.scale``, ``lm_head.table``,
    ``layers.<i>.attn.wq.w``, ``layers.<i>.moe.wi``,
    ``layers.<i>.b0_mlstm.wq.w``, ``enc.layers.<i>.attn.wq.w``, ...), in
    ``dtype`` (default ``cfg.param_dtype``; an MoE router stays float32,
    as the reference's).  The constructor leaves them uninitialised: use
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
        if cfg.family == "ssm":
            layers = (XlstmPeriod(cfg, **kw) for _ in range(n_scan_steps(cfg)))
        else:
            layers = (Block(cfg, cross=cfg.is_encoder_decoder, **kw)
                      for _ in range(n_scan_steps(cfg)))
        self.layers = nn.ModuleList(layers)
        self.enc = None
        if cfg.is_encoder_decoder:
            self.enc = nn.ModuleDict({
                "layers": nn.ModuleList(Block(cfg, **kw)
                                        for _ in range(cfg.n_enc_layers)),
                "norm_f": Norm(cfg.d_model, cfg.norm, **kw)})

    # -- parameters ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.norm_f.scale.device

    @property
    def param_dtype(self) -> torch.dtype:
        """The dtype of the weights (norms may keep float32: ``astype``)."""
        return self.embed["tok"].table.dtype

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
            blk.reset(gen)
        if model.enc is not None:
            for blk in model.enc["layers"]:
                blk.reset(gen)
            model.enc["norm_f"].reset()
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
            stack = _stack_of(key)
            if stack:
                rest = key[len(stack):]
                for i in range(a.shape[0]):
                    flat[f"{stack}{i}.{rest}"] = a[i]
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
            stack = _stack_of(key)
            if stack:
                i, rest = key[len(stack):].split(".", 1)
                stacked.setdefault(stack + rest, []).append((int(i), a))
            else:
                _set(out, key, a)
        for key, items in stacked.items():
            _set(out, key,
                 np.stack([a for _, a in sorted(items, key=lambda t: t[0])]))
        return out

    @torch.no_grad()
    def astype(self, dtype: torch.dtype) -> "Transformer":
        """A copy with every tensor cast to ``dtype`` (round to nearest
        even): the numbers each apply's own cast would give.  What an
        apply reads in float32 keeps its dtype: an MoE router (always
        float32), norms and sLSTM's ``r_h``."""
        new = Transformer(self.cfg, device=self.device, dtype=dtype)
        new.load_state_dict(self.state_dict())
        for p_new, p_own in zip(_float32_reads(new), _float32_reads(self)):
            p_new.data = p_own.detach().clone()
        return new

    # -- full sequence ------------------------------------------------------

    def _head(self) -> Embed:
        return self.embed["tok"] if self.cfg.tie_embeddings else self.lm_head

    def _embed_inputs(self, batch: Dict[str, torch.Tensor], compute
                      ) -> torch.Tensor:
        """Token embeddings, after the patch prefix for a VLM."""
        x = embed_apply(self.embed["tok"], batch["tokens"], compute)
        if self.cfg.n_patches:
            x = torch.cat([batch["patch_embeds"].to(compute), x], dim=1)
        return x

    def _encode(self, enc_embeds: torch.Tensor, chunk: int, remat: str
                ) -> torch.Tensor:
        cfg = self.cfg
        x = enc_embeds.to(dtype_of(cfg.compute_dtype))
        body = _remat(functools.partial(_enc_block_apply, cfg=cfg,
                                        chunk=chunk), remat)
        for blk in self.enc["layers"]:
            x = body(blk, x)
        return norm_apply(self.enc["norm_f"], x, cfg.norm)

    @torch.no_grad()
    def encode(self, enc_embeds: torch.Tensor, chunk: int = 1024
               ) -> torch.Tensor:
        """Whisper's bidirectional encoder over the stub frame embeddings
        (B, Se, d) -> (B, Se, d) in the compute dtype: the reference's
        ``_encoder_forward``, and ``decode_step``'s ``enc_out``."""
        if self.enc is None:
            raise ValueError(f"{self.cfg.name} has no encoder")
        return self._encode(enc_embeds, chunk, "none")

    def _forward(self, batch: Dict[str, torch.Tensor], chunk: int,
                 skip_upper_triangle: bool, remat: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        compute = dtype_of(cfg.compute_dtype)
        x = self._embed_inputs(batch, compute)
        enc_out = self._encode(batch["enc_embeds"], chunk, remat) \
            if cfg.is_encoder_decoder else None
        if cfg.family == "ssm":
            body = _remat(functools.partial(_xlstm_apply, cfg=cfg), remat)
        else:
            body = _remat(functools.partial(
                _block_apply, cfg=cfg, chunk=chunk,
                skip_upper_triangle=skip_upper_triangle), remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            if cfg.family == "ssm":
                x, aux_l = body(blk, x)
            else:
                x, aux_l = body(blk, x, enc_out)
            if aux_l is not None:
                aux = aux + aux_l
        x = norm_apply(self.norm_f, x, cfg.norm)
        logits = unembed_apply(self._head(), x, compute)
        if cfg.n_patches:
            logits = logits[:, cfg.n_patches:]
        return logits, aux

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor], chunk: int = 1024,
                skip_upper_triangle: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward of ``batch["tokens"]`` (B, S) (with
        ``enc_embeds`` (B, Se, d) for whisper, ``patch_embeds`` (B, P, d)
        for a VLM) -> (logits (B, S, V), the MoE layers' summed aux loss;
        0 for the other families)."""
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
        """Zeroed K/V, (n_layers, B, max_seq, Hkv, D) in the compute dtype;
        for xLSTM each block's zero state (m = -1e30), float32, with a
        leading period axis."""
        cfg = self.cfg
        n = n_scan_steps(cfg)
        if cfg.family == "ssm":
            cache = {}
            for i, kind in enumerate(cfg.block_pattern):
                init = xlstm_mod.mlstm_init_cache if kind == "mlstm" \
                    else xlstm_mod.slstm_init_cache
                per = init(n * batch_size, cfg.d_model, cfg,
                           device=self.device)
                cache[f"b{i}"] = {k: t.view(n, batch_size, *t.shape[1:])
                                  for k, t in per.items()}
            return cache
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
        """Run the prompt ``batch["tokens"]`` (B, S) (with ``forward``'s
        other keys) -> (last-token logits (B, 1, V), a new cache: the
        prompt's K/V, or xLSTM's terminal states).  Whisper's encoder runs
        here, as in the reference."""
        cfg = self.cfg
        compute = dtype_of(cfg.compute_dtype)
        x = self._embed_inputs(batch, compute)
        cache = self.init_cache(x.shape[0], max_seq)
        enc_out = self._encode(batch["enc_embeds"], chunk, "none") \
            if cfg.is_encoder_decoder else None
        for i, blk in enumerate(self.layers):
            if cfg.family == "ssm":
                states = []
                x, _ = _xlstm_apply(blk, x, cfg, states)
                for j, st in enumerate(states):
                    for name, t in st.items():
                        cache[f"b{j}"][name][i] = t
                continue
            h = norm_apply(blk.ln1, x, cfg.norm)
            a, _ = attn.attention_prefill(blk.attn, h, cfg,
                                          self._layer_cache(cache, i),
                                          chunk=chunk)
            x = x + a
            if enc_out is not None:
                h = norm_apply(blk.ln_x, x, cfg.norm)
                x = x + attn.attention_train(blk.xattn, h, cfg,
                                             kv_override=(enc_out, enc_out),
                                             chunk=chunk)
            x = x + _ffn(blk, norm_apply(blk.ln2, x, cfg.norm), cfg)[0]
        x = norm_apply(self.norm_f, x, cfg.norm)
        return unembed_apply(self._head(), x[:, -1:], compute), cache

    @torch.no_grad()
    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos,
                    enc_out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step at position ``pos``. tokens: (B, 1) -> (logits
        (B, 1, V), the cache with this token's K/V, or the new recurrent
        states, written in place).  Whisper's decoder cross-attends to
        ``enc_out`` (``encode``'s output); without it the layers skip
        cross-attention, as the reference's do."""
        cfg = self.cfg
        if enc_out is not None and not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} has no cross-attention for enc_out")
        compute = dtype_of(cfg.compute_dtype)
        if not isinstance(pos, torch.Tensor):   # one device scalar per step
            pos = torch.full((1,), int(pos), dtype=torch.long,
                             device=self.device)
        x = embed_apply(self.embed["tok"], tokens, compute)
        for i, blk in enumerate(self.layers):
            if cfg.family == "ssm":
                for j, kind in enumerate(cfg.block_pattern):
                    h = norm_apply(blk.ln.row(j), x, cfg.norm)
                    step = xlstm_mod.mlstm_decode if kind == "mlstm" \
                        else xlstm_mod.slstm_decode
                    lcache = {k: t[i] for k, t in cache[f"b{j}"].items()}
                    y, st = step(blk.mixer(j), h, cfg, lcache)
                    for name, t in st.items():
                        lcache[name].copy_(t)
                    x = x + y
                continue
            h = norm_apply(blk.ln1, x, cfg.norm)
            a, _ = attn.attention_decode(blk.attn, h, cfg,
                                         self._layer_cache(cache, i), pos)
            x = x + a
            if enc_out is not None:
                h = norm_apply(blk.ln_x, x, cfg.norm)
                a, _ = attn.attention_decode(blk.xattn, h, cfg,
                                             self._layer_cache(cache, i), pos,
                                             kv_override=(enc_out, enc_out))
                x = x + a
            x = x + _ffn(blk, norm_apply(blk.ln2, x, cfg.norm), cfg)[0]
        x = norm_apply(self.norm_f, x, cfg.norm)
        return unembed_apply(self._head(), x, compute), cache


def _stack_of(key: str) -> str:
    """The stacked prefix (``layers.`` or ``enc.layers.``) of a parameter
    key, or ""."""
    return next((p for p in _STACKED if key.startswith(p)), "")


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
