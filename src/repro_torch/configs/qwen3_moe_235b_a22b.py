"""qwen3-moe-235b-a22b [moe]: 94L d4096 64H GQA(kv=4) per-expert ff1536
v151936, MoE 128e top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                  # per-expert FFN width
    vocab_size=151936,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    n_experts=128,
    experts_per_token=8,
    optimizer="adafactor",
    param_dtype="bfloat16",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B (hf)",
))
