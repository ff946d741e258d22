"""Logical-axis sharding rules for the LM stack (see ``repro.launch.sharding``).

Model code names axes logically ("batch", "heads", ...); a rule set maps
them to mesh axes.  Parameters get their specs from path patterns over
their names.  The default mapping is the reference's:

  batch    -> ("pod", "data") or "data"   data parallel
  heads/kv_heads/ff/vocab/ssm_inner -> "model"   tensor parallel
  experts  -> "model" when ``expert_axis_parallel``, else ``expert_ff``
  w_embed  -> "data" with ``two_d_weights`` (a weight's d_model dim)
  kv_seq   -> ``kv_seq_axis``

A spec is a tuple with one entry per dimension: ``None`` (whole), a mesh
axis name, or a tuple of names (split over their product, the first the
major one, as a mesh orders them).

Where the reference hands specs to GSPMD, the port computes with explicit
collectives (``models/*.py`` over ``launch/mesh.ModelGroup``), so
:func:`shard`, the reference's ``with_sharding_constraint`` on
activations, is the identity.  A rank holds its block of each parameter,
:func:`local_block` of the full tensor.  The reference's
``graph_shard_spec`` and ``graph_replicated_spec`` return
``NamedSharding``s, which have no counterpart: the graph engine has no
placement specs (``launch/mesh.py``).
"""

from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

__all__ = ["LogicalRules", "default_rules", "rules_ctx", "shard",
           "logical_to_spec", "param_specs", "current_rules", "param_path",
           "local_block"]

Spec = Tuple[Any, ...]

_state = threading.local()


class LogicalRules:
    def __init__(self, mapping: Dict[str, Any], mesh: Any = None):
        self.mapping = dict(mapping)
        self.mesh = mesh

    def spec(self, logical: Sequence[Optional[str]]) -> Spec:
        return tuple(self.mapping.get(ax) if ax is not None else None
                     for ax in logical)


def default_rules(mesh: Any = None, *, multi_pod: bool = False,
                  kv_seq_axis=None, expert_axis_parallel: bool = True,
                  two_d_weights: bool = False) -> LogicalRules:
    """Logical -> mesh axis mapping, the reference's decision for decision.

    two_d_weights: also shard every weight's d_model dim over "data".
    expert_axis_parallel: experts over "model"; otherwise the experts are
    whole on every rank and their FFN dim takes "model".
    kv_seq_axis: the decode cache's sequence dim (the reference's; the
    port's cache keeps the sequence whole, ``launch/specs.py``).
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    mapping: Dict[str, Any] = {
        "batch": dp,
        "seq": None,
        "embed": None,
        "w_embed": "data" if two_d_weights else None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model" if expert_axis_parallel else None,
        "expert_ff": None if expert_axis_parallel else "model",
        "kv_seq": kv_seq_axis,
        "ssm_inner": "model",
        "state": None,
        "layers": None,
        "frames": None,
    }
    return LogicalRules(mapping, mesh)


def current_rules() -> Optional[LogicalRules]:
    return getattr(_state, "rules", None)


@contextmanager
def rules_ctx(rules: LogicalRules):
    """Install ``rules`` for :func:`logical_to_spec` in this thread.  A
    model takes its rules from ``Transformer(rules=)`` only."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def logical_to_spec(logical: Sequence[Optional[str]]) -> Optional[Spec]:
    r = current_rules()
    if r is None:
        return None
    return r.spec(logical)


def shard(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """The identity: the port's model code places its collectives itself
    (module docstring)."""
    return x


# ---------------------------------------------------------------------------
# parameter specs by path pattern
# ---------------------------------------------------------------------------

# The reference's patterns (``repro/launch/sharding.py:144-180``) over the
# port's names with the layer indices dropped (:func:`param_path`: the
# dotted path of ``Transformer.to_arrays``).  First hit wins; trailing dims
# map right-aligned.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / unembedding
    (r"embed\.tok\.table", ("vocab", "w_embed")),
    (r"embed\.pos\.table", (None, "w_embed")),
    (r"lm_head\.table", ("vocab", "w_embed")),
    # attention (self and cross)
    (r".*attn\.wq\.w", ("w_embed", "heads")),
    (r".*attn\.wk\.w", ("w_embed", "kv_heads")),
    (r".*attn\.wv\.w", ("w_embed", "kv_heads")),
    (r".*attn\.wo\.w", ("heads", "w_embed")),
    (r".*attn\.w[qkv]\.b", ("heads",)),
    (r".*attn\.wo\.b", ("w_embed",)),
    # dense mlp
    (r"mlp\.w[ig]\.w", ("w_embed", "ff")),
    (r"mlp\.wo\.w", ("ff", "w_embed")),
    (r"mlp\.w[igo]\.b", (None,)),
    # MoE
    (r"moe\.router\.w", ("w_embed", None)),
    (r"moe\.w[ig]$", ("experts", "w_embed", "expert_ff")),
    (r"moe\.wo$", ("experts", "expert_ff", "w_embed")),
    # mamba
    (r"mamba\.in_proj\.w", ("w_embed", "ssm_inner")),
    (r"mamba\.gate_proj\.w", ("w_embed", "ssm_inner")),
    (r"mamba\.out_proj\.w", ("ssm_inner", "w_embed")),
    (r"mamba\.conv_w", (None, "ssm_inner")),
    (r"mamba\.(x_proj_b|x_proj_c|x_proj_dt)\.w", ("ssm_inner", None)),
    (r"mamba\.(dt_bias|a_log|d_skip)", ("ssm_inner",)),
    # xlstm
    (r"b\d+_(mlstm|slstm)\.(wq|wk|wv|wi|wf|wo_gate|wz)\.w",
     ("w_embed", "ssm_inner")),
    (r"b\d+_(mlstm|slstm)\.(wq|wk|wv|wi|wf|wo_gate|wz)\.b", ("ssm_inner",)),
    (r"b\d+_(mlstm|slstm)\.r_h\.w", (None, "ssm_inner")),
    (r"b\d+_(mlstm|slstm)\.proj_out\.w", ("ssm_inner", "w_embed")),
    # norms & scalars: replicated
    (r".*(norm|ln)[^.]*\.(scale|bias)", ()),
    (r".*", ()),  # fallback: replicate
)


def param_path(name: str) -> str:
    """A parameter's name without its layer indices (``layers.3.moe.1.wi``
    -> ``layers.moe.wi``): its path in the reference's stacked pytree,
    dot-joined."""
    return ".".join(k for k in name.split(".") if not k.isdigit())


def param_specs(params: Mapping[str, Any], rules: LogicalRules
                ) -> Dict[str, Spec]:
    """``{name: spec}`` for ``{name: tensor}`` (``named_parameters``, meta
    tensors too), by the path rules; a spec has one entry per dim."""

    def leaf_spec(name: str, ndim: int) -> Spec:
        path = param_path(name)
        for pat, logical in _PARAM_RULES:
            if re.search(pat, path):
                if not logical:
                    return (None,) * ndim
                axes = list(rules.spec(logical))
                extra = ndim - len(axes)
                if extra < 0:   # scalar-ish leaf vs wide rule
                    axes = axes[-ndim:] if ndim else []
                    extra = 0
                return tuple([None] * extra + axes)
        return (None,) * ndim

    return {k: leaf_spec(k, len(p.shape)) for k, p in params.items()}


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_block(t: torch.Tensor, spec: Sequence[Any],
                coords: Mapping[str, Tuple[int, int]]) -> torch.Tensor:
    """The block of ``t`` a rank holds under ``spec`` (a view).

    ``coords`` maps each mesh axis to (this rank's index, the axis size),
    as ``ModelGrid.coords`` gives it.  A dim split over several axes takes
    the first as the major one.  Raises ``ValueError`` when a dim does not
    divide.
    """
    spec = (None,) * (t.dim() - len(spec)) + tuple(spec)
    for dim, entry in enumerate(spec):
        index, count = 0, 1
        for ax in _axes(entry):
            i, n = coords[ax]
            index, count = index * n + i, count * n
        if count == 1:
            continue
        if t.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"{count} ways ({entry})")
        size = t.shape[dim] // count
        t = t.narrow(dim, index * size, size)
    return t
