"""R-MAT graph generator (Chakrabarti et al.), a copy of the reference's.

The same seed gives byte-identical edges to ``repro.data.rmat.rmat_edges``:
the parity tests and ``chip_smoke.py`` build their graphs from it.
(a, b, c, d) = (0.57, 0.19, 0.19, 0.05) gives LiveJournal/Twitter-like
community structure and heavy-tailed degrees.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["rmat_edges"]


def rmat_edges(scale: int, edge_factor: int = 16, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Generate 2^scale nodes and edge_factor·2^scale directed edges."""
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    for bit in range(scale):
        r = rng.random(m)
        src_bit = (r >= ab).astype(np.int64)
        # within chosen half, pick column quadrant
        r2 = rng.random(m)
        thresh = np.where(src_bit == 0, a / ab, c / (1.0 - ab))
        dst_bit = (r2 >= thresh).astype(np.int64)
        src |= src_bit << bit
        dst |= dst_bit << bit
    # permute labels to kill the bit-pattern locality artifact
    perm = rng.permutation(n)
    return perm[src].astype(np.int32), perm[dst].astype(np.int32)
