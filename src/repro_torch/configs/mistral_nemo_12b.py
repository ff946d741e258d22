"""mistral-nemo-12b [dense]: 40L d5120 32H GQA(kv=8) ff14336 v131072, 128k ctx.
head_dim 128 (explicit — 5120/32=160 but Nemo uses 128).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407 (hf)",
))
