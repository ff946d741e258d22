"""Graph-derived training corpora: the bridge between the graph engine
and the LM (see ``repro.data.graph_corpus``).

Ringo's loop ends with "results back to tables"; here a graph becomes an
LM token stream: random walks over a :class:`Graph` (DeepWalk-style)
are the sequences, so the LM trains on data the graph engine produced.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.graph import Graph

__all__ = ["RandomWalkCorpus"]


class RandomWalkCorpus:
    """Batches of random-walk token sequences over a graph.

    Node ids (dense, ``[0, n_nodes)``) are the tokens.  Batch ``step`` is a
    function of ``(seed, step)`` alone, walked on the host from a numpy
    copy of the graph's out-CSR: the reference's walks element for element.
    """

    def __init__(self, g: Graph, batch: int, seq_len: int, seed: int = 0):
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.n = g.n_nodes
        # host-side CSR copies for fast walking
        self.ptr = g.out_ptr.cpu().numpy()
        self.idx = g.out_idx.cpu().numpy()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        walks = np.zeros((self.batch, self.seq + 1), np.int32)
        cur = rng.integers(0, self.n, self.batch)
        walks[:, 0] = cur
        for t in range(1, self.seq + 1):
            lo = self.ptr[cur]
            hi = self.ptr[cur + 1]
            deg = hi - lo
            # dangling nodes teleport
            jump = rng.integers(0, self.n, self.batch)
            offs = (rng.random(self.batch) * np.maximum(deg, 1)).astype(np.int64)
            nxt = np.where(deg > 0, self.idx[lo + offs], jump)
            cur = nxt.astype(np.int64)
            walks[:, t] = cur
        return {"tokens": walks[:, :-1], "targets": walks[:, 1:]}
