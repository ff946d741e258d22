"""input_specs(): meta-tensor stand-ins for every model input, one rank's
local shapes, with their spec trees (see ``repro.launch.specs``).

Per cell kind:
  train   -> (params, opt_state, batch{tokens,targets[,enc,patch]}, step)
  prefill -> (params, batch)
  decode  -> (params, cache, tokens(B,1), pos[, enc_out])

Each ``*_structs`` returns ``(structs, specs)``: meta tensors
(``device="meta"``, no memory) in the shapes a rank holds, and a tree of
the same keys holding each leaf's spec (``launch/sharding.py``).  A "mesh"
is anything with ``shape`` ({axis: size}) and ``axis_names``: a
``launch.mesh.ModelGrid``, or ``make_production_mesh()``'s
``MeshShape``.  The structs are rank 0's: every rank holds blocks of one
shape, but where attention's heads do not split evenly over "model" rank 0
holds the most (``models/attention.head_range``).

Where the port's layout differs from the reference's:

* ``params``: the specs are the reference's, but attention's blocks are
  whole heads (``models/transformer.head_cols``): ``wq``'s columns and
  bias and ``wo``'s rows of the rank's query heads, as even as whole
  heads allow, and for ``wk`` / ``wv`` the columns of the KV heads those
  read (``models/attention.kv_head_range``), not the spec's even block of
  the flat columns.  Where the heads do not split evenly (qwen1.5-4b's 20
  over 16: 2 on rank 0; whisper-small's 12: 1), the reference's GSPMD
  pads the flat columns to an even split and rank 0 holds 1/16 of them;
  the port's rank 0 holds its whole heads, so its bytes differ
  (``PERF.md``).
* ``cache``: the reference puts the decode cache's sequence on
  ``kv_seq`` ("model" for ``decode_32k``) and splits no heads (its
  ``cache_structs``, ``repro/launch/specs.py:113-147``).  A rank of the port
  holds its KV heads and the whole sequence: k / v (L, B, S, Hkv, D) get
  (None, batch, None, kv_heads, None), rank 0's KV heads.  A recurrent
  state holds rank 0's share, as its model does: an mLSTM's ``c`` (L, B,
  h_r, dk, dk), ``n`` (L, B, h_r, dk) and ``m`` (L, B, h_r) of its whole
  heads (``models/transformer.head_cols``), an sLSTM's (L, B, di / m) and
  a Mamba's ``h`` (L, n, B, di / m, N) and ``conv`` (L, n, B, W - 1,
  di / m) of its channels, specs (None, batch, "model", ...) and (None,
  None, batch, "model", ...), (..., "model") for ``conv``: the reference
  shards them on batch only, and its GSPMD reshards.
* ``opt_state``: the specs are the reference's ZeRO-1 specs
  (``train/optimizer.opt_state_specs``) over the state of the full
  parameters, an Adafactor state over the reference's stacked ones (its
  ``adafactor_init`` of ``params["layers"]`` stacked on the layer axis:
  one state per group, ``f["layers.ln1.scale"]``).  The structs are what
  a rank of the sharded train step holds (``train/zero.py``): the state
  of its ZeRO block of its parameter's block, the block as ``params``
  above gives it (a ``wk`` / ``wv`` leaf's whole KV heads included),
  split over the data axis on the first dim the spec leaves unsplit that
  divides by the data size (``zero1_extend_spec``'s rule).  The data axis
  is every batch axis folded, as ``launch/mesh.counting_grid`` folds it
  (pod × data on two pods, where the reference's specs split over "data"
  alone).  AdamW's m and v have the ZeRO block's shape; Adafactor's
  factors are those of a group's layers' ZeRO blocks stacked, of the
  whole stacked parameter's factoring.
* two-dimensional weights (``two_d_weights``, the giant models:
  ``is_giant``): ``params`` are the block of both axes, each weight's
  d_model dim split over "data" as the reference's specs say; a rank
  gathers a weight whole over "data" where it uses it
  (``launch/mesh.ModelGrid.weight``).  On two pods the reference splits
  ``w_embed`` over "data" alone (16 ranks) and the batch over ("pod",
  "data") (32), and so does the port: the gather runs over a pod's 16
  data ranks, and the gradient, reduce-scattered over them, is then
  summed over the pods in order.  Such a block spends its "data" on the
  spec, so it gets no ZeRO split: its state is that of the whole block,
  held alike on both pods.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..launch import sharding as shlib
from ..launch.mesh import counting_grid
from ..models import transformer as model
from ..models.layers import dtype_of
from ..train import zero
from ..train.optimizer import get_optimizer, opt_state_specs

__all__ = ["GIANT_PARAM_BYTES", "is_giant", "rules_for", "param_structs",
           "batch_structs", "cache_structs", "opt_structs", "input_specs"]

GIANT_PARAM_BYTES = 8e9  # per-chip TP-sharded weight budget -> go 2D above

META = torch.device("meta")


def is_giant(cfg: ArchConfig, model_par: int = 16) -> bool:
    return cfg.param_count() * (2 if cfg.param_dtype == "bfloat16" else 4) \
        / model_par > GIANT_PARAM_BYTES


def _dp_total(mesh, dp) -> int:
    if dp is None:
        return 1
    return math.prod(mesh.shape[ax]
                     for ax in (dp if isinstance(dp, tuple) else (dp,)))


def rules_for(cfg: ArchConfig, mesh, kind: str,
              shape: Optional[ShapeSpec] = None) -> shlib.LogicalRules:
    """The reference's decisions: experts on "model" when E divides;
    weights 2-D above ``GIANT_PARAM_BYTES`` a model rank; the decode cache's
    ``kv_seq`` axis; ``batch -> None`` when the batch does not divide."""
    multi_pod = "pod" in mesh.axis_names
    model_par = mesh.shape["model"]
    eap = cfg.n_experts > 0 and cfg.n_experts % model_par == 0
    two_d = is_giant(cfg, model_par)
    kv_axis = None
    if kind == "decode" and shape is not None:
        if shape.global_batch == 1:
            # batch=1 frees every DP axis: flash-decode shards the cache's
            # sequence dim across the whole mesh
            kv_axis = ("pod", "data", "model") if multi_pod \
                else ("data", "model")
        else:
            kv_axis = "model"
    rules = shlib.default_rules(mesh, multi_pod=multi_pod,
                                kv_seq_axis=kv_axis,
                                expert_axis_parallel=eap,
                                two_d_weights=two_d)
    # tiny batches can't shard over the DP axes (long_500k has batch=1)
    if shape is not None and \
            shape.global_batch % _dp_total(mesh, rules.mapping["batch"]):
        rules.mapping["batch"] = None
    return rules


def _coords(mesh) -> Dict[str, Tuple[int, int]]:
    return {ax: (0, n) for ax, n in mesh.shape.items()}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def param_structs(cfg: ArchConfig, mesh, rules) -> Tuple[Dict, Dict]:
    """({name: meta block}, {name: spec}) for the parameters (the names of
    ``Transformer.named_parameters``)."""
    blocks = model.param_blocks(cfg, _coords(mesh), rules)
    return ({k: keep(full) for k, (full, _, keep) in blocks.items()},
            {k: spec for k, (_, spec, _) in blocks.items()})


def _local_batch(mesh, rules, b: int) -> Tuple[Any, int]:
    dp = rules.mapping["batch"]
    return dp, b // _dp_total(mesh, dp)


def batch_structs(cfg: ArchConfig, shape: ShapeSpec, mesh, rules,
                  with_targets: bool = True) -> Tuple[Dict, Dict]:
    dp, b = _local_batch(mesh, rules, shape.global_batch)
    s = shape.seq_len
    emb_dt = dtype_of(cfg.compute_dtype)
    s_tok = s - cfg.n_patches if cfg.n_patches else s
    structs = {"tokens": _meta((b, s_tok), torch.int32)}
    specs = {"tokens": (dp, None)}
    if with_targets:
        structs["targets"] = _meta((b, s_tok), torch.int32)
        specs["targets"] = (dp, None)
    if cfg.is_encoder_decoder:
        structs["enc_embeds"] = _meta((b, cfg.enc_seq_len, cfg.d_model),
                                      emb_dt)
        specs["enc_embeds"] = (dp, None, None)
    if cfg.n_patches:
        structs["patch_embeds"] = _meta((b, cfg.n_patches, cfg.d_model),
                                        emb_dt)
        specs["patch_embeds"] = (dp, None, None)
    return structs, specs


def cache_structs(cfg: ArchConfig, shape: ShapeSpec, mesh, rules
                  ) -> Tuple[Dict, Dict]:
    """The port's decode cache on rank 0 (module docstring): the
    ``init_cache`` of rank 0's model over a counting grid of ``mesh``."""
    dp, b = _local_batch(mesh, rules, shape.global_batch)
    grid = counting_grid(mesh) if mesh.shape["model"] > 1 else None
    cache = model.Transformer(cfg, device=META, group=grid, rules=rules) \
        .init_cache(b, shape.seq_len)
    specs = {}
    for group, leaves in cache.items():
        specs[group] = {}
        for name, t in leaves.items():
            if group == "attn":
                specs[group][name] = (None, dp, None,
                                      rules.mapping["kv_heads"], None)
                continue
            # xLSTM (periods, B, heads or channels, ...), Mamba (periods,
            # n, B, channels, N) and its window (periods, n, B, W - 1,
            # channels)
            at = 2 if group == "mamba" else 1
            split = t.dim() - 1 if name == "conv" else at + 1
            specs[group][name] = tuple(
                dp if i == at else rules.mapping["ssm_inner"] if i == split
                else None for i in range(t.dim()))
    return cache, specs


def opt_structs(cfg: ArchConfig, mesh, rules, param_specs: Dict
                ) -> Tuple[Dict, Dict]:
    """(the state a rank holds, the reference's ZeRO-1 spec tree): the
    structs are ``train/zero.init_state``'s blocks (module docstring)."""
    full = {k: p.detach() for k, p in
            model.Transformer(cfg, device=META).named_parameters()}
    state = get_optimizer(cfg.optimizer).init(full)
    specs = opt_state_specs(cfg.optimizer, param_specs, state, mesh,
                            data_axis="data")
    data = math.prod(n for ax, n in mesh.shape.items() if ax != "model")
    return zero.state_structs(cfg, _coords(mesh), rules, (0, data)), specs


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                kind: Optional[str] = None):
    """(rules, structs, specs) for the cell, keyed by kind."""
    kind = kind or shape.kind
    rules = rules_for(cfg, mesh, kind, shape)
    p_structs, p_specs = param_structs(cfg, mesh, rules)
    if kind == "train":
        o_structs, o_specs = opt_structs(cfg, mesh, rules, p_specs)
        batch, b_specs = batch_structs(cfg, shape, mesh, rules)
        return rules, (p_structs, o_structs, batch, _meta((), torch.int64)), \
            (p_specs, o_specs, b_specs, ())
    if kind == "prefill":
        batch, b_specs = batch_structs(cfg, shape, mesh, rules,
                                       with_targets=False)
        return rules, (p_structs, batch), (p_specs, b_specs)
    if kind == "decode":
        cache, c_specs = cache_structs(cfg, shape, mesh, rules)
        dp, b = _local_batch(mesh, rules, shape.global_batch)
        structs = (p_structs, cache, _meta((b, 1), torch.int32),
                   _meta((), torch.int64))
        specs = (p_specs, c_specs, (dp, None), ())
        if cfg.is_encoder_decoder:
            structs += (_meta((b, cfg.enc_seq_len, cfg.d_model),
                              dtype_of(cfg.compute_dtype)),)
            specs += ((dp, None, None),)
        return rules, structs, specs
    raise ValueError(kind)
