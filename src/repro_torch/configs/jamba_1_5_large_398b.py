"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H GQA(kv=8) ff24576 v65536,
Mamba:attention 7:1 interleave, MoE 16e top-2 every other layer.
Runs long_500k (sub-quadratic: Mamba state decode + flash-decode attention).
[arXiv:2403.19887; hf]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_every=8,               # 7 mamba + 1 attention per period
    ssm_state_dim=16,
    ssm_expand=2,
    optimizer="adafactor",
    param_dtype="bfloat16",
    source="arXiv:2403.19887 (hf)",
))
