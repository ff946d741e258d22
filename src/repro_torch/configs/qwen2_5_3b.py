"""qwen2.5-3b [dense]: 36L d2048 16H GQA(kv=2) ff11008 v151936, QKV bias.
[hf:Qwen/Qwen2.5-0.5B; hf]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B (hf)",
))
