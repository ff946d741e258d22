"""grok-1-314b [moe]: 64L d6144 48H GQA(kv=8) ff32768 v131072, MoE 8e top-2.
Adafactor + bf16 params (Adam states would exceed single-pod HBM; see
DESIGN.md §5).  [hf:xai-org/grok-1; unverified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    act="swiglu",               # grok uses GeGLU: gated 3-matrix FFN
    norm="rmsnorm",
    n_experts=8,
    experts_per_token=2,
    optimizer="adafactor",
    param_dtype="bfloat16",
    source="hf:xai-org/grok-1 (unverified)",
))
