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
  ``prefill`` returns the blocks' terminal recurrent states as the cache;
* ``"hybrid"`` (jamba): periods of ``cfg.attn_every`` sub-layers, the
  first ``attn_every - 1`` mixing with a Mamba (:mod:`.ssm`), the last
  with attention (K4); each sub-layer's FFN is an MoE where ``i %
  cfg.moe_every == 1`` (the reference's model code, not
  ``param_count``'s ``layer % moe_every == 0``) and an MLP elsewhere.
  ``prefill`` returns the attention layer's K/V and each Mamba's terminal
  state (its chunked scan's last carry).

The layers are a Python loop over an ``nn.ModuleList`` where the
reference scans stacked parameters; ``from_arrays`` / ``to_arrays``
convert between the two (``layers`` and ``enc.layers`` are stacked, and
a hybrid period's ``mamba``, ``moe`` and ``mlp`` carry a second, inner
stack axis), so the reference's ``init_params`` pytree loads bit for bit.

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

Sharded over ranks (``group=``, a ``launch.mesh.ModelGrid``): the dense,
MoE, audio and vlm families hold each parameter's block by ``launch.
sharding.param_specs`` and compute Megatron-style: ``wq`` / ``wk`` /
``wv`` and the MLP's ``wi`` / ``wg`` column-parallel, attention's and the
MLP's ``wo`` row-parallel with one all-reduce after each, the token
embedding vocab-parallel (one all-reduce), the LM head's logits gathered
along the vocabulary, so every rank holds all of them (and ``Engine``
picks the same token on each); norms and the router are whole on every
rank, the MoE layers run per ``models/moe.py``.  Attention's blocks are
whole heads (``models/attention.head_range``): rank r holds a contiguous
range of query heads, as even as whole heads allow (qwen1.5-4b's 20 over
16 ranks: 2 on ranks 0–3, 1 on the others; whisper's 12: 1 on ranks
0–11, none on 12–15), ``wq``'s columns, ``wo``'s rows and the q bias of
those heads, and ``wk`` / ``wv`` the KV heads they read, where the
reference's spec splits the flat columns evenly and GSPMD reshards a
split head.  A rank's KV cache holds its KV heads.  Whisper's encoder
layers run over the group as the decoder's do; its output is whole on
every model rank and the decoder's cross-attention projects it onto the
rank's KV heads.  A VLM's patch prefix goes before the first layer on
every model rank.  Each rank's batch is its data shard's rows where the
rules split "batch" over "data", the whole batch otherwise.
``init_params`` draws every full tensor in the unsharded order and keeps
the rank's block, one tensor at a time, and ``from_arrays`` cuts the
reference's arrays the same way, so the ranks together hold the
unsharded model's numbers.  ``forward_train`` runs over ranks: the
collectives carry the gradients (``launch/mesh.ModelGroup``), and
:func:`grad_members` names the blocks whose gradient the train step sums
over model ranks (``train/zero.py``).  Weights whose d_model dim the
rules put on "data" (``two_d_weights``, the giant models) are split over
the data ranks too: a rank holds the block of both axes, and each apply
gathers the weight whole on that dim over the data ranks where it is used
(ZeRO-3's gather: ``models/layers.weight``), in the forward, in prefill
and decode at every call, and again in the backward; its gradient is
reduce-scattered back to the block.  A 2-D block is held by one data
rank (of each pod) only; the norms and the router's replicas stay whole.
The ssm and hybrid families follow the reference's "ssm_inner" rules
(``models/xlstm.py``, ``models/ssm.py``): an mLSTM keeps whole heads as
attention does (a rank with none adds a zero-width product to the sum),
an sLSTM and a Mamba hold the rank's share of the inner channels, the
sLSTM gathering its whole ``h`` each step and the Mamba summing its B, C
and dt projections once a call; a hybrid period's attention, MoE and
MLP run as the other families'.  Every family runs over ranks.

The cache keeps the reference's layout: ``{"attn": {"k", "v"}}`` with
shape (n_layers, B, max_seq, Hkv, D) in the compute dtype for the
attention families, ``{"b<i>": {"c", "n", "m"} | {"c", "n", "h", "m"}}``
float32 states with a leading period axis for xLSTM, and for the hybrid
``{"attn": {"k", "v"}, "mamba": {"h", "conv"}}``: K/V (periods, B,
max_seq, Hkv, D), ``h`` (periods, attn_every - 1, B, di, N) float32,
``conv`` (periods, attn_every - 1, B, W - 1, di) in the compute dtype.
Prefill and decode write it in place.
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import DeviceLike, resolve
from ..launch import sharding
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import (MLP, Embed, Norm, dtype_of, embed_apply, full_shape,
                     mlp_apply, norm_apply, unembed_apply)

__all__ = ["Transformer", "n_scan_steps", "REMAT", "param_blocks",
           "head_cols", "model_cols", "model_dim", "model_ranges",
           "model_holders", "grad_members"]

Cache = Dict[str, Dict[str, torch.Tensor]]
_FAMILIES = ("dense", "moe", "ssm", "audio", "vlm", "hybrid")
_STACKED = ("layers.", "enc.layers.")   # stacked on a leading axis
_INNER = ("mamba.", "moe.", "mlp.")     # a hybrid period's inner stacks
ITEM = "ROADMAP.md Queue 1 item 15"
REMAT = ("full", "dots", "none")


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of matrix products, recompute everything else."""
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_DOT_OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.matmul.default}


def _ffn(ffn: nn.Module, h: torch.Tensor, cfg
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An FFN (an MLP or an MoE) on ``h`` -> (output, the MoE's aux loss
    or None)."""
    if isinstance(ffn, moe_mod.MoE):
        return moe_mod.moe_apply(ffn, h, cfg)
    return mlp_apply(ffn, h, cfg.act, h.dtype), None


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
    f, aux = _ffn(blk.ffn, norm_apply(blk.ln2, x, cfg.norm), cfg)
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


def _hybrid_apply(blk: "HybridPeriod", x: torch.Tensor, cfg, chunk: int,
                  skip_upper_triangle: bool, kv=None, states=None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One hybrid period -> (x, its MoE layers' summed aux loss).  With
    ``kv`` (the period's K/V cache) the attention layer is prefill's and
    each Mamba's terminal state is appended to ``states``."""
    aux = None
    for i, mixer, ffn in blk.sublayers():
        h = norm_apply(blk.mix_ln.row(i), x, cfg.norm)
        if mixer is None:
            if kv is None:
                a = attn.attention_train(
                    blk.attn, h, cfg, causal=True, chunk=chunk,
                    skip_upper_triangle=skip_upper_triangle)
            else:
                a, _ = attn.attention_prefill(blk.attn, h, cfg, kv,
                                              chunk=chunk)
        elif states is None:
            a = ssm_mod.mamba_train(mixer, h, cfg)
        else:
            a, st = ssm_mod.mamba_train(mixer, h, cfg, return_state=True)
            states.append(st)
        x = x + a
        f, aux_l = _ffn(ffn, norm_apply(blk.ffn_ln.row(i), x, cfg.norm), cfg)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
        x = x + f
    return x, aux


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
    if cfg.family == "graph":
        raise NotImplementedError(
            f"{cfg.name}: family 'graph' is not a model but a cost cell of "
            f"launch/ringo_cells.py (run it with launch/dryrun.py --arch "
            f"ringo-graph)")
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: "
                                  f"{ITEM}")


@dataclass(frozen=True)
class _Widths:
    """The widths a rank holds (all of them unsharded), and the group its
    tensor-parallel layers sum over (None: no collective)."""
    heads: int
    kv_heads: int
    ff: int
    vocab: int
    inner: int = 0          # the rank's share of "ssm_inner"
    vocab_lo: int = 0
    group: Any = None
    experts: Optional[moe_mod.ExpertShard] = None
    kv_index: Optional[Tuple[int, ...]] = None


def _widths(cfg, grid, rules) -> _Widths:
    inner = cfg.d_model * cfg.ssm_expand
    if grid is None:
        return _Widths(cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size,
                       inner)
    m, r = grid.model.d, grid.model.rank
    qlo, qhi = attn.head_range(cfg.n_heads, m, r)
    lo, hi = attn.kv_head_range(cfg.n_heads, cfg.n_kv_heads, m, r)
    recurrent = cfg.family in ("ssm", "hybrid")
    for what, n in (("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size),
                    ("ssm_inner", inner if recurrent else 0)):
        if n % m:
            raise ValueError(f"{cfg.name}: {what} {n} does not split over "
                             f"{m} ranks")
    experts = None
    if cfg.n_experts:
        on_model = rules.mapping.get("experts") == "model"
        if on_model and cfg.n_experts % m:
            raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not "
                             f"split over {m} ranks")
        n = cfg.n_experts // m if on_model else cfg.n_experts
        experts = moe_mod.ExpertShard(
            grid, r * n if on_model else 0, n, on_model,
            rules.mapping.get("batch") is not None)
    v = cfg.vocab_size // m
    return _Widths(qhi - qlo, hi - lo, cfg.d_ff // m, v, inner // m, r * v,
                   grid.model if m > 1 else None, experts,
                   attn.kv_index(cfg.n_heads, cfg.n_kv_heads, m, r))


def _moe(cfg, w: _Widths, kw) -> moe_mod.MoE:
    sh = w.experts
    if sh is None:
        return moe_mod.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.act,
                           **kw)
    ff = cfg.d_ff if sh.experts_on_model else w.ff
    return moe_mod.MoE(cfg.d_model, ff, sh.n, cfg.act, shard=sh, **kw)


def _attention(cfg, w: _Widths, kw) -> attn.Attention:
    return attn.Attention(cfg.d_model, w.heads, w.kv_heads,
                          cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                          group=w.group, kv_index=w.kv_index, **kw)


class Block(nn.Module):
    """One pre-norm layer: ``ln1``, ``attn``, ``ln2``, and ``mlp`` or,
    with ``cfg.n_experts > 0``, ``moe``; with ``cross``, whisper's decoder
    layer, also ``ln_x`` and ``xattn``.  An encoder layer is a Block with
    neither."""

    def __init__(self, cfg, w: _Widths, *, cross: bool = False, device,
                 dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **kw)
        self.attn = _attention(cfg, w, kw)
        self.ln_x = Norm(cfg.d_model, cfg.norm, **kw) if cross else None
        self.xattn = _attention(cfg, w, kw) if cross else None
        self.ln2 = Norm(cfg.d_model, cfg.norm, **kw)
        if cfg.n_experts > 0:
            self.mlp = None
            self.moe = _moe(cfg, w, kw)
        else:
            self.mlp = MLP(cfg.d_model, w.ff, cfg.act, group=w.group, **kw)
            self.moe = None

    @property
    def ffn(self) -> nn.Module:
        """The layer's FFN: ``mlp`` or ``moe``."""
        return self.mlp if self.moe is None else self.moe

    def reset(self, generator: torch.Generator) -> None:
        self.ln1.reset()
        self.attn.reset(generator)
        if self.xattn is not None:
            self.ln_x.reset()
            self.xattn.reset(generator)
        self.ln2.reset()
        self.ffn.reset(generator)


class XlstmPeriod(nn.Module):
    """One xLSTM period: ``ln``, the stacked pre-norms (len(pattern), d),
    and ``b<i>_mlstm`` / ``b<i>_slstm`` for block i of
    ``cfg.block_pattern`` (over a group: an mLSTM's whole heads, an
    sLSTM's share of the channels)."""

    def __init__(self, cfg, w: _Widths, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln = Norm(cfg.d_model, cfg.norm, stack=len(cfg.block_pattern),
                       **kw)
        self.kinds = tuple(cfg.block_pattern)
        for i, kind in enumerate(self.kinds):
            mixer = xlstm_mod.mLSTM(cfg.d_model, cfg, heads=w.heads,
                                    group=w.group, **kw) \
                if kind == "mlstm" else \
                xlstm_mod.sLSTM(cfg.d_model, cfg, di=w.inner, group=w.group,
                                **kw)
            self.add_module(f"b{i}_{kind}", mixer)

    def mixer(self, i: int) -> nn.Module:
        return getattr(self, f"b{i}_{self.kinds[i]}")

    def reset(self, generator: torch.Generator) -> None:
        self.ln.reset()
        for i in range(len(self.kinds)):
            self.mixer(i).reset(generator)


class HybridPeriod(nn.Module):
    """One jamba period of ``n = cfg.attn_every`` sub-layers: ``mix_ln``
    and ``ffn_ln``, stacked pre-norms (n, d); ``mamba``, the n - 1 mixers
    of sub-layers 0..n-2; ``attn``, sub-layer n - 1's; ``moe``, the FFNs
    of the sub-layers with ``i % cfg.moe_every == 1``, and ``mlp``, the
    others' (``_hybrid_period_init``'s stacks, in sub-layer order)."""

    def __init__(self, cfg, w: _Widths, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = cfg.attn_every
        self.moe_at = tuple(i % cfg.moe_every == 1 for i in range(n))
        self.mix_ln = Norm(cfg.d_model, cfg.norm, stack=n, **kw)
        self.ffn_ln = Norm(cfg.d_model, cfg.norm, stack=n, **kw)
        self.mamba = nn.ModuleList(
            ssm_mod.Mamba(cfg.d_model, cfg, di=w.inner, group=w.group, **kw)
            for _ in range(n - 1))
        self.attn = _attention(cfg, w, kw)
        self.moe = nn.ModuleList(_moe(cfg, w, kw)
                                 for _ in range(sum(self.moe_at)))
        self.mlp = nn.ModuleList(MLP(cfg.d_model, w.ff, cfg.act,
                                     group=w.group, **kw)
                                 for _ in range(n - sum(self.moe_at)))

    def sublayers(self):
        """(i, the Mamba of sub-layer i or None for attention, its FFN)."""
        moe, mlp = iter(self.moe), iter(self.mlp)
        for i, at in enumerate(self.moe_at):
            mixer = self.mamba[i] if i < len(self.mamba) else None
            yield i, mixer, next(moe) if at else next(mlp)

    def reset(self, generator: torch.Generator) -> None:
        self.mix_ln.reset()
        self.ffn_ln.reset()
        self.attn.reset(generator)
        for m in (*self.mamba, *self.moe, *self.mlp):
            m.reset(generator)


def _float32_reads(model: nn.Module):
    """The parameters an apply reads in float32 whatever the compute dtype
    (the reference's ``astype(float32)`` of the parameter): norm scales and
    biases, sLSTM's recurrent ``r_h`` and the Mamba's ``a_log`` (its
    ``dt_bias``, ``d_skip`` and ``conv_w`` are read in the compute
    dtype)."""
    for m in model.modules():
        if isinstance(m, Norm):
            yield from m.parameters()
        elif isinstance(m, xlstm_mod.sLSTM):
            yield from m.r_h.parameters()
        elif isinstance(m, ssm_mod.Mamba):
            yield m.a_log


class Transformer(nn.Module):
    """A model whose tensors sit under the reference's pytree keys
    (``embed.tok.table``, ``norm_f.scale``, ``lm_head.table``,
    ``layers.<i>.attn.wq.w``, ``layers.<i>.moe.wi``,
    ``layers.<i>.b0_mlstm.wq.w``, ``enc.layers.<i>.attn.wq.w``, ...), in
    ``dtype`` (default ``cfg.param_dtype``; an MoE router stays float32,
    as the reference's).  The constructor leaves them uninitialised: use
    :meth:`init_params` or :meth:`from_arrays`.

    With ``group`` (a ``launch.mesh.ModelGrid``) the model holds this
    rank's blocks under ``rules`` (default:
    ``launch.specs.rules_for(cfg, group, "prefill")``); each
    parameter carries ``full_shape`` and ``keep`` (``models/layers.py``)."""

    def __init__(self, cfg, *, device: DeviceLike = None, dtype=None,
                 group=None, rules: Optional[sharding.LogicalRules] = None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve(device)
        dt = dtype or dtype_of(cfg.param_dtype)
        kw = dict(device=dev, dtype=dt)
        self.cfg = cfg
        self.grid, self.rules = group, None
        if group is not None:
            from ..launch.specs import rules_for
            self.rules = rules or rules_for(cfg, group, "prefill")
        w = _widths(cfg, group, self.rules)
        self.kv_heads = w.kv_heads
        self.embed = nn.ModuleDict({"tok": Embed(
            w.vocab, cfg.d_model, group=w.group, lo=w.vocab_lo, **kw)})
        self.norm_f = Norm(cfg.d_model, cfg.norm, **kw)
        self.lm_head = None if cfg.tie_embeddings else \
            Embed(w.vocab, cfg.d_model, group=w.group, lo=w.vocab_lo, **kw)
        if cfg.family == "ssm":
            layers = (XlstmPeriod(cfg, w, **kw)
                      for _ in range(n_scan_steps(cfg)))
        elif cfg.family == "hybrid":
            layers = (HybridPeriod(cfg, w, **kw)
                      for _ in range(n_scan_steps(cfg)))
        else:
            layers = (Block(cfg, w, cross=cfg.is_encoder_decoder, **kw)
                      for _ in range(n_scan_steps(cfg)))
        self.layers = nn.ModuleList(layers)
        self.enc = None
        if cfg.is_encoder_decoder:
            self.enc = nn.ModuleDict({
                "layers": nn.ModuleList(Block(cfg, w, **kw)
                                        for _ in range(cfg.n_enc_layers)),
                "norm_f": Norm(cfg.d_model, cfg.norm, **kw)})
        if group is not None:
            self._hold_blocks(param_blocks(cfg, group.coords, self.rules))

    def _hold_blocks(self, blocks) -> None:
        """Give each parameter its ``full_shape`` and ``keep``
        (``param_blocks``), checking that its shape is the block's; a
        parameter whose spec splits a dim over a data axis of more than
        one rank also its ``data_dim`` and ``data_grid``
        (``models/layers.weight`` gathers it where it is used)."""
        two_d = self.grid.weight_data.d > 1
        for name, p in self.named_parameters():
            full, spec, keep = blocks[name]
            want = tuple(keep(full).shape)
            ddim = next((i for i, e in enumerate(spec)
                         if "data" in sharding._axes(e)), None) \
                if two_d else None
            if ddim is not None:    # the modules hold a weight's whole d
                p.data = torch.empty(want, dtype=p.dtype, device=p.device)
                p.data_dim, p.data_grid = ddim, self.grid
                self.two_d = True
            if tuple(p.shape) != want:
                raise ValueError(f"{name}: this rank holds {tuple(p.shape)}, "
                                 f"its block is {want} of "
                                 f"{tuple(full.shape)}")
            p.full_shape, p.keep = tuple(full.shape), keep

    two_d = False   # some weight is split over "data" (``_hold_blocks``)

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
                    device: DeviceLike = None, group=None,
                    rules: Optional[sharding.LogicalRules] = None
                    ) -> "Transformer":
        """Random weights with the reference's distributions (dense and
        experts: normal scaled by 1/√d_in; embeddings: normal·0.02; biases
        0; norm scales 1) drawn from ``generator`` (default: seed 0 on the
        model's device).
        The same seed gives other numbers than the reference's ``PRNGKey``.
        Sharded, every full tensor is drawn as the unsharded model draws it
        and the rank keeps its block: the same numbers."""
        model = cls(cfg, device=device, group=group, rules=rules)
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
                    device: DeviceLike = None, group=None,
                    rules: Optional[sharding.LogicalRules] = None
                    ) -> "Transformer":
        """Load the reference's ``init_params`` pytree: nested dicts of
        arrays, ``params["layers"]`` leaves with a leading layer axis (and
        a hybrid period's ``mamba`` / ``moe`` / ``mlp`` a second one).
        Sharded, each rank keeps its block of each full array."""
        model = cls(cfg, device=device, group=group, rules=rules)
        inner = _INNER if cfg.family == "hybrid" else ()
        flat = {}
        for key, a in _flatten(arrays):
            a = np.asarray(a)
            stack = _stack_of(key)
            if not stack:
                flat[key] = a
                continue
            rest = key[len(stack):]
            sub = next((q for q in inner if rest.startswith(q)), "")
            for i in range(a.shape[0]):
                if sub:
                    for j in range(a.shape[1]):
                        flat[f"{stack}{i}.{sub}{j}.{rest[len(sub):]}"] = \
                            a[i, j]
                else:
                    flat[f"{stack}{i}.{rest}"] = a[i]
        params = dict(model.named_parameters())
        if set(flat) != set(params):
            raise ValueError(
                f"arrays do not match the model: missing "
                f"{sorted(set(params) - set(flat))}, unexpected "
                f"{sorted(set(flat) - set(params))}")
        for key, p in params.items():
            if tuple(flat[key].shape) != full_shape(p):
                raise ValueError(f"{key}: shape {flat[key].shape} != "
                                 f"{full_shape(p)}")
            a = torch.from_numpy(np.ascontiguousarray(flat[key]))
            p.copy_(a if model.grid is None else p.keep(a))
        return model

    def to_arrays(self) -> Dict[str, Any]:
        """The inverse of :meth:`from_arrays`: numpy arrays, layers stacked
        (a sharded model's: this rank's blocks)."""
        inner = _INNER if self.cfg.family == "hybrid" else ()
        out: Dict[str, Any] = {}
        stacked: Dict[str, Dict[int, Any]] = {}
        for key, p in self.named_parameters():
            a = p.detach().cpu().numpy()
            stack = _stack_of(key)
            if not stack:
                _set(out, key, a)
                continue
            i, rest = key[len(stack):].split(".", 1)
            sub = next((q for q in inner if rest.startswith(q)), "")
            if sub:
                j, rest = rest[len(sub):].split(".", 1)
                stacked.setdefault(stack + sub + rest, {}).setdefault(
                    int(i), {})[int(j)] = a
            else:
                stacked.setdefault(stack + rest, {})[int(i)] = a
        for key, rows in stacked.items():
            _set(out, key, _stack_rows(rows))
        return out

    @torch.no_grad()
    def astype(self, dtype: torch.dtype) -> "Transformer":
        """A copy with every tensor cast to ``dtype`` (round to nearest
        even): the numbers each apply's own cast would give.  What an
        apply reads in float32 keeps its dtype: an MoE router (always
        float32), norms and sLSTM's ``r_h``."""
        new = Transformer(self.cfg, device=self.device, dtype=dtype,
                          group=self.grid, rules=self.rules)
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
        elif cfg.family == "hybrid":
            body = _remat(functools.partial(
                _hybrid_apply, cfg=cfg, chunk=chunk,
                skip_upper_triangle=skip_upper_triangle), remat)
        else:
            body = _remat(functools.partial(
                _block_apply, cfg=cfg, chunk=chunk,
                skip_upper_triangle=skip_upper_triangle), remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.layers:
            if cfg.family in ("ssm", "hybrid"):
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
        per ``cfg.remat``; the same numbers.  Over ranks the collectives
        carry the gradients (``launch/mesh.ModelGroup``), and a
        recompute calls its forward collectives again, in the same order
        on every rank.  Weights split over "data" are gathered where they
        are used and, under any ``remat``, not kept for the backward,
        which gathers them again (``launch/mesh.regather_saved``)."""
        if self.cfg.remat not in REMAT:
            raise ValueError(f"unknown remat {self.cfg.remat!r}; want one of "
                             f"{REMAT}")
        if not self.two_d:
            return self._forward(batch, chunk, skip_upper_triangle,
                                 self.cfg.remat)
        from ..launch.mesh import regather_saved
        with regather_saved():
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
        """Zeroed K/V, (n_layers, B, max_seq, Hkv, D) in the compute dtype
        (sharded: the rank's KV heads);
        for xLSTM each block's zero state (m = -1e30), float32, with a
        leading period axis; for the hybrid the period's K/V and its
        Mambas' zero states, (periods, attn_every - 1, ...).  Sharded, a
        recurrent state holds the rank's mLSTM heads or share of the
        channels."""
        cfg = self.cfg
        n = n_scan_steps(cfg)
        if cfg.family == "ssm":
            cache = {}
            period = self.layers[0]
            for i, kind in enumerate(cfg.block_pattern):
                mixer = period.mixer(i)
                if kind == "mlstm":
                    per = xlstm_mod.mlstm_init_cache(
                        n * batch_size, cfg.d_model, cfg, device=self.device,
                        heads=mixer.n_heads)
                else:
                    per = xlstm_mod.slstm_init_cache(
                        n * batch_size, cfg.d_model, cfg, device=self.device,
                        di=mixer.r_h.w.shape[1])
                cache[f"b{i}"] = {k: t.view(n, batch_size, *t.shape[1:])
                                  for k, t in per.items()}
            return cache
        compute = dtype_of(cfg.compute_dtype)
        per = attn.init_kv_cache(n * batch_size, max_seq, self.kv_heads,
                                 cfg.resolved_head_dim, compute, self.device)
        cache = {"attn": {k: t.view(n, batch_size, *t.shape[1:])
                          for k, t in per.items()}}
        if cfg.family == "hybrid":
            m = cfg.attn_every - 1
            per = ssm_mod.mamba_init_cache(
                n * m * batch_size, cfg.d_model, cfg, compute, self.device,
                di=self.layers[0].mamba[0].d_skip.shape[0])
            cache["mamba"] = {k: t.view(n, m, batch_size, *t.shape[1:])
                              for k, t in per.items()}
        return cache

    @staticmethod
    def _layer_cache(cache: Cache, i: int) -> Dict[str, torch.Tensor]:
        return {"k": cache["attn"]["k"][i], "v": cache["attn"]["v"][i]}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], max_seq: int,
                chunk: int = 1024) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt ``batch["tokens"]`` (B, S) (with ``forward``'s
        other keys) -> (last-token logits (B, 1, V), a new cache: the
        prompt's K/V, xLSTM's terminal states, or the hybrid's K/V and
        Mamba states).  Whisper's encoder runs here, as in the
        reference."""
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
            if cfg.family == "hybrid":
                states = []
                x, _ = _hybrid_apply(blk, x, cfg, chunk, True,
                                     kv=self._layer_cache(cache, i),
                                     states=states)
                for j, st in enumerate(states):
                    for name, t in st.items():
                        cache["mamba"][name][i, j] = t
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
            x = x + _ffn(blk.ffn, norm_apply(blk.ln2, x, cfg.norm), cfg)[0]
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
            if cfg.family == "hybrid":
                x = self._hybrid_decode(blk, i, x, cache, pos)
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
            x = x + _ffn(blk.ffn, norm_apply(blk.ln2, x, cfg.norm), cfg)[0]
        x = norm_apply(self.norm_f, x, cfg.norm)
        return unembed_apply(self._head(), x, compute), cache

    def _hybrid_decode(self, blk: HybridPeriod, i: int, x: torch.Tensor,
                       cache: Cache, pos: torch.Tensor) -> torch.Tensor:
        """One token through period ``i``; its cache rows in place."""
        cfg = self.cfg
        for j, mixer, ffn in blk.sublayers():
            h = norm_apply(blk.mix_ln.row(j), x, cfg.norm)
            if mixer is None:
                a, _ = attn.attention_decode(blk.attn, h, cfg,
                                             self._layer_cache(cache, i), pos)
            else:
                lcache = {k: t[i, j] for k, t in cache["mamba"].items()}
                a, st = ssm_mod.mamba_decode(mixer, h, cfg, lcache)
                for name, t in st.items():
                    lcache[name].copy_(t)
            x = x + a
            x = x + _ffn(ffn, norm_apply(blk.ffn_ln.row(j), x, cfg.norm),
                         cfg)[0]
        return x


def _keep(t: torch.Tensor, spec: tuple, coords, cols) -> torch.Tensor:
    """A rank's block of a full parameter: by ``spec``, but where
    :func:`model_cols` gives (dim, lo, hi) the rows or columns [lo, hi)
    on that dim in place of the spec's "model" split (whole heads, a
    Mamba's channels of ``a_log``)."""
    if cols is not None:
        dim, lo, hi = cols
        t = t.narrow(dim, lo, hi - lo)
        spec = tuple(_without_model(e) for e in
                     (None,) * (t.dim() - len(spec)) + tuple(spec))
    return sharding.local_block(t, tuple(spec), coords)


def _without_model(entry):
    """A spec entry with "model" taken out of it."""
    axes = tuple(a for a in sharding._axes(entry) if a != "model")
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _a_log(name: str) -> bool:
    return re.search(r"mamba\.(\d+\.)?a_log$", name) is not None


def model_dim(name: str, spec: tuple) -> Optional[int]:
    """The dim of parameter ``name`` that the port splits over "model":
    the spec's, but a Mamba's ``a_log`` (channels, state) on its channels,
    where the reference's rule (its one entry right-aligned) puts "model"
    on the state: the scan needs each channel's whole row.  None where the
    spec names no "model"."""
    mdim = next((i for i, e in enumerate(spec)
                 if "model" in sharding._axes(e)), None)
    return 0 if mdim is not None and _a_log(name) else mdim


def model_cols(cfg, name: str, m: int, r: int
               ) -> Optional[Tuple[int, int, int]]:
    """(dim, lo, hi) of the block rank ``r`` of ``m`` holds of parameter
    ``name`` where it is not the spec's even block of "model": whole
    heads (:func:`head_cols`), and a Mamba's ``a_log`` rows of the rank's
    channels; None for any other leaf or at ``m == 1``."""
    if m > 1 and _a_log(name):
        n = cfg.d_model * cfg.ssm_expand // m
        return 0, r * n, (r + 1) * n
    return head_cols(cfg, name, m, r)


def head_cols(cfg, name: str, m: int, r: int
              ) -> Optional[Tuple[int, int, int]]:
    """(dim, lo, hi) of the whole heads rank ``r`` of ``m`` holds of
    attention or mLSTM leaf ``name`` (:func:`_head_leaf`): the columns of
    its query heads for ``wq``'s weight and bias (an mLSTM's heads for its
    ``wq``, ``wk``, ``wv``, ``wi``, ``wf``, ``wz`` and their biases), the
    rows for ``wo``'s (``proj_out``'s) weight, the columns of the KV heads
    those read for ``wk`` / ``wv``; None for any other leaf or at ``m ==
    1``."""
    kind = _head_leaf(name)
    if kind is None or m == 1:
        return None
    hd = cfg.resolved_head_dim
    if kind == "kv":
        lo, hi = attn.kv_head_range(cfg.n_heads, cfg.n_kv_heads, m, r)
    else:
        lo, hi = attn.head_range(cfg.n_heads, m, r)
    if kind == "mlstm":
        hd = cfg.d_model * cfg.ssm_expand // cfg.n_heads
    dim = 0 if name.endswith(("wo.w", "proj_out.w")) else -1
    return dim, lo * hd, hi * hd


def param_blocks(cfg, coords, rules: sharding.LogicalRules
                 ) -> Dict[str, Tuple[torch.Tensor, tuple, Callable]]:
    """``{name: (the full parameter on the meta device, spec, keep)}`` of
    each parameter of ``cfg``'s model on the rank at ``coords`` (``{axis:
    (index, size)}``) under ``rules``: ``keep`` cuts a full tensor to the
    rank's block.  The block is ``local_block`` by the spec
    (``launch.sharding.param_specs``, the reference's), but on attention's
    head dim the rank's whole heads (:func:`head_cols`, attention's and
    the mLSTM's), whether or not the heads split evenly over "model", and
    a Mamba's ``a_log`` by its channels (:func:`model_cols`)."""
    full = {k: p.detach() for k, p in
            Transformer(cfg, device="meta").named_parameters()}
    specs = sharding.param_specs(full, rules)
    r, m = coords.get("model", (0, 1))
    out = {}
    for name, p in full.items():
        out[name] = (p, specs[name], functools.partial(
            _keep, spec=specs[name], coords=coords,
            cols=model_cols(cfg, name, m, r)))
    return out


def _head_leaf(name: str) -> Optional[str]:
    """"q" for attention's ``wq`` weight and bias and ``wo``'s weight,
    "kv" for ``wk`` / ``wv``'s, "mlstm" for an mLSTM's head leaves, None
    for any other leaf (``wo``'s bias is on d_model)."""
    if re.search(r"b\d+_mlstm\.(wq|wk|wv|wi|wf|wz|proj_out)\.[wb]$", name):
        return "mlstm"
    hit = re.search(r"attn\.w([qkvo])\.([wb])$", name)
    if hit is None or hit.group(1) == "o" and hit.group(2) == "b":
        return None
    return "kv" if hit.group(1) in "kv" else "q"


def _kv_leaf(name: str) -> bool:
    return _head_leaf(name) == "kv"


def model_ranges(cfg, name: str, spec: tuple, shape: Tuple[int, ...],
                 m: int) -> Optional[Tuple[Tuple[int, int], ...]]:
    """Each model rank's (start, size) on the dim of parameter ``name``
    (full shape ``shape``) that the port splits over "model"
    (:func:`model_dim`), or None where the spec names no "model" (whole
    on every rank): the rank's whole heads for an attention or mLSTM leaf
    and its channels of a Mamba's ``a_log`` (:func:`model_cols`), else
    the spec's even blocks."""
    mdim = model_dim(name, spec)
    if mdim is None:
        return None
    out = []
    for q in range(m):
        cols = model_cols(cfg, name, m, q)
        if cols is not None:
            out.append((cols[1], cols[2] - cols[1]))
        else:
            n = shape[mdim] // m
            out.append((q * n, n))
    return tuple(out)


def model_holders(cfg, name: str, spec: tuple, m: int, r: int
                  ) -> Tuple[int, ...]:
    """The model ranks (of ``m``) that hold the same block of parameter
    ``name`` as rank ``r``, in order: all of them for a parameter whole on
    every rank (``spec`` names no "model"), the ranks that read the same
    KV heads for a ``wk`` / ``wv`` leaf (:func:`param_blocks`), else
    ``r`` alone.  Over "data" a block is held by every data rank, but one
    the spec splits over "data" (a 2-D weight) by its own data rank only
    (``train/zero.Leaf.d_owner``)."""
    if not any("model" in sharding._axes(e) for e in spec):
        return tuple(range(m))
    if m > 1 and _kv_leaf(name):
        heads = [attn.kv_head_range(cfg.n_heads, cfg.n_kv_heads, m, q)
                 for q in range(m)]
        return tuple(q for q in range(m) if heads[q] == heads[r])
    return (r,)


def grad_members(cfg, name: str, spec: tuple, m: int, r: int
                 ) -> Tuple[int, ...]:
    """The model ranks whose gradients of parameter ``name`` add up to its
    gradient, in order (``r`` alone: its own is the whole).

    A block several ranks hold needs the sum where its ranks compute
    different things from it: a KV head read by the query heads of several
    ranks (each rank's gradient comes from its own query heads; the ranks
    whose KV heads overlap rank ``r``'s, each head summed over the ranks
    that hold it, ``train/zero.py``), and an MoE router under a sharded
    layer (each rank's combine weighs only its own experts' gates, or its
    own columns of every expert).  The norms are whole on every rank too,
    but every rank computes the same thing from them, so each already
    holds the whole gradient."""
    if m > 1 and _kv_leaf(name):
        heads = [attn.kv_head_range(cfg.n_heads, cfg.n_kv_heads, m, q)
                 for q in range(m)]
        lo, hi = heads[r]
        return tuple(q for q, (a, b) in enumerate(heads)
                     if q == r or max(a, lo) < min(b, hi))
    if m > 1 and re.search(r"moe\.(\d+\.)?router\.w$", name):
        return tuple(range(m))
    return (r,)


def _stack_of(key: str) -> str:
    """The stacked prefix (``layers.`` or ``enc.layers.``) of a parameter
    key, or ""."""
    return next((p for p in _STACKED if key.startswith(p)), "")


def _stack_rows(rows: Dict[int, Any]) -> np.ndarray:
    """``{i: array or {j: array}}`` stacked in index order, inner first."""
    return np.stack([_stack_rows(v) if isinstance(v, dict) else v
                     for _, v in sorted(rows.items())])


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
