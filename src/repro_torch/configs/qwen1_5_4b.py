"""qwen1.5-4b [dense]: 40L d2560 20H (kv=20, i.e. MHA) ff6912 v151936, QKV
bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    source="hf:Qwen/Qwen1.5-0.5B (hf)",
))
