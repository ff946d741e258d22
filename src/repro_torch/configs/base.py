"""Architecture config schema, registry and assigned input shapes.

A copy of ``repro/configs/base.py``: the same frozen :class:`ArchConfig`,
``SHAPES``, ``runnable_shapes`` and ``reduced``, so a config of the port
equals its reference counterpart field by field.  The registry holds the
reference's eleven configs: the four ``family="dense"`` ones, the two
``family="moe"`` ones, xlstm-350m (``"ssm"``), whisper-small
(``"audio"``), internvl2-26b (``"vlm"``), jamba-1.5-large-398b
(``"hybrid"``), and ringo-graph (``"graph"``), which is no model but the
cost cells of ``launch/ringo_cells.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "register", "get_config", "list_archs",
           "SHAPES", "runnable_shapes", "reduced"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned LM shape set (identical across the 10 archs).
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    # transformer backbone
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "swiglu"            # swiglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1             # MoE FFN on every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    # hybrid / ssm
    attn_every: int = 0            # jamba: one attention layer per this many
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    block_pattern: Tuple[str, ...] = ()   # xlstm: ("mlstm","slstm",...) cycle
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 0           # fixed encoder frames (whisper: 1500)
    # vlm
    n_patches: int = 0             # patch-embedding prefix length
    # vocab padding (vocab_size is padded to a multiple of 256 for TP
    # divisibility; logits past vocab_unpadded are never targeted)
    vocab_unpadded: int = 0
    # MoE implementation: "sorted" (global sort-based routing, baseline) or
    # "expert_tp" (shard_map local bucketing + psum combine — see §Perf)
    moe_impl: str = "sorted"
    # training defaults
    optimizer: str = "adamw"       # adamw | adafactor (giant models)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        d, h = self.d_model, self.resolved_head_dim
        qkv = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h)
        o = self.n_heads * h * d
        attn = qkv + o
        ffn_mult = 3 if self.act == "swiglu" else 2
        dense_ffn = ffn_mult * d * self.d_ff if self.d_ff else 0
        total = 0
        if self.family == "ssm":  # xlstm blocks
            di = d * self.ssm_expand
            per = 2 * d * di + 2 * di * d  # in/out projections + gates approx
            total += self.n_layers * per
        else:
            for layer in range(self.n_layers):
                is_attn = (self.attn_every == 0) or ((layer % self.attn_every)
                                                     == self.attn_every - 1)
                if is_attn:
                    total += attn
                else:  # mamba mixer
                    di = d * self.ssm_expand
                    total += 2 * d * di + di * d + di * (2 * self.ssm_state_dim + 2)
                use_moe = self.n_experts > 0 and (layer % self.moe_every == 0)
                if use_moe:
                    e_ff = self.d_ff
                    total += self.n_experts * ffn_mult * d * e_ff + d * self.n_experts
                elif self.d_ff:
                    total += dense_ffn
        if self.is_encoder_decoder:
            total += self.n_enc_layers * (attn + dense_ffn)       # encoder
            total += self.n_layers * attn                         # cross-attn
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: experts_per_token of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        ffn_mult = 3 if self.act == "swiglu" else 2
        moe_layers = len([l for l in range(self.n_layers)
                          if l % self.moe_every == 0])
        all_experts = moe_layers * self.n_experts * ffn_mult * d * self.d_ff
        active = moe_layers * self.experts_per_token * ffn_mult * d * self.d_ff
        return full - all_experts + active


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def runnable_shapes(cfg: ArchConfig) -> Dict[str, ShapeSpec]:
    """Shapes this arch runs: ``long_500k`` only for sub-quadratic families."""
    out = {}
    for name, s in SHAPES.items():
        if name == "long_500k" and not cfg.is_subquadratic:
            continue  # full attention at 500k ctx: assignment says skip
        out[name] = s
    return out


def _ensure_loaded() -> None:
    """Import all config modules once so registration side-effects run."""
    from . import (whisper_small, qwen1_5_4b, qwen2_5_3b,       # noqa: F401
                   starcoder2_15b, mistral_nemo_12b, grok_1_314b,
                   qwen3_moe_235b_a22b, jamba_1_5_large_398b, xlstm_350m,
                   internvl2_26b, ringo_graph)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    shrink = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.attn_every or cfg.block_pattern else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq_len=min(cfg.enc_seq_len, 16) if cfg.enc_seq_len else 0,
        n_patches=min(cfg.n_patches, 4) if cfg.n_patches else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.attn_every:
        shrink["attn_every"] = min(cfg.attn_every, 4)
        shrink["n_layers"] = 2 * shrink["attn_every"]
        shrink["moe_every"] = cfg.moe_every
    shrink.update(overrides)
    return dataclasses.replace(cfg, **shrink)
