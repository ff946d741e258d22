"""The paper's own workload as a dry-runnable config: distributed PageRank
over a Twitter2010-scale graph (42 M nodes, 1.5 B edges) on the production
mesh — the graph engine's cells next to the LM cells (a copy of
``repro/configs/ringo_graph.py``)."""

from .base import ArchConfig, register

# Encoded via the generic ArchConfig so the registry/dry-run machinery is
# uniform; the graph fields are carried in `source` and interpreted by
# launch/ringo_cells.py.  It builds no model (models/transformer.py).
CONFIG = register(ArchConfig(
    name="ringo-graph",
    family="graph",
    n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    source="twitter2010: n=41.7M nodes, e=1.47B edges (paper Table 2)",
))
