"""whisper-small [audio]: enc-dec, conv frontend stubbed (precomputed frame
embeddings per assignment spec).  12 encoder + 12 decoder layers.
[arXiv:2212.04356; unverified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,              # decoder layers; encoder below
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=52224,           # 51865 padded to 256k alignment for TP
    vocab_unpadded=51865,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    is_encoder_decoder=True,
    n_enc_layers=12,
    enc_seq_len=1536,         # whisper's 1500 frames padded to the 512-chunk grid
    source="arXiv:2212.04356 (unverified)",
))
