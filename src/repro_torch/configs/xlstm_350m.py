"""xlstm-350m [ssm]: 24L d1024 4H ff0 v50304 — alternating mLSTM/sLSTM blocks
(paper's 1:1 simplification of the 7:1 placement; DESIGN.md).  Runs
long_500k (O(1) recurrent state decode).  [arXiv:2405.04517; unverified]"""

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                     # xLSTM blocks have no separate FFN
    vocab_size=50304,
    act="gelu",
    norm="layernorm",
    ssm_expand=2,
    block_pattern=("mlstm", "slstm"),
    source="arXiv:2405.04517 (unverified)",
))
