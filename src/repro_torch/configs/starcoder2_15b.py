"""starcoder2-15b [dense]: 40L d6144 48H GQA(kv=4) ff24576 v49152, RoPE.
[arXiv:2402.19173; hf]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    norm="layernorm",
    qkv_bias=True,
    source="arXiv:2402.19173 (hf)",
))
