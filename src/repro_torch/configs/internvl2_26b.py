"""internvl2-26b [vlm]: InternLM2-20B backbone 48L d6144 48H GQA(kv=8)
ff16384 v92553 + InternViT frontend STUB (input_specs provides 256
precomputed patch embeddings per the assignment spec).
[arXiv:2404.16821; hf]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92672,           # 92553 padded to 256-multiple for TP
    vocab_unpadded=92553,
    act="swiglu",
    norm="rmsnorm",
    n_patches=256,
    source="arXiv:2404.16821 (hf)",
))
