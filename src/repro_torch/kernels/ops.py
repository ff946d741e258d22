"""Host-side re-blocking for the graph kernels (numpy, once per graph).

Counterpart of ``repro/kernels/ops.py:49-114, 153-172``.  The plan calls
these once per graph and caches the results; they return tensors on the
requested device.  ``build_block_triples`` is vectorized but enumerates the
triples in the reference's order, so the arrays are equal element for
element.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .segment_sum import (DEFAULT_BLOCK, DEFAULT_CHUNK, chunk_layout,
                          segment_sum_chunked)

__all__ = ["edges_to_bsr", "build_block_triples", "segment_sum_sorted"]


def edges_to_bsr(src: np.ndarray, dst: np.ndarray, n: int,
                 values: Optional[np.ndarray] = None,
                 block: int = DEFAULT_BLOCK, device: DeviceLike = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Build (tiles, rows, cols, n_blocks) BSR with every row-block present.

    Matrix semantics: M[dst, src] = value (the PageRank pull layout:
    y = M @ x gathers from sources into destinations).
    """
    dev = resolve(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    vals = np.ones_like(src, dtype=np.float32) if values is None \
        else np.asarray(values, dtype=np.float32)
    # nb >= 1 even for empty graphs, so the SpMV grid is never empty
    nb = max((n + block - 1) // block, 1)
    rb, cb = dst // block, src // block
    key = rb * nb + cb
    uniq, inv = np.unique(key, return_inverse=True)
    # ensure every row block appears (zero tile on the diagonal)
    present = np.unique(uniq // nb)
    missing = np.setdiff1d(np.arange(nb), present)
    n_tiles = len(uniq) + len(missing)
    tiles = np.zeros((max(n_tiles, 1), block, block), np.float32)
    np.add.at(tiles, (inv.reshape(-1), dst % block, src % block), vals)
    rows = np.concatenate([uniq // nb, missing])
    cols = np.concatenate([uniq % nb, missing])
    order = np.argsort(rows, kind="stable")
    tiles = tiles[order] if n_tiles else tiles
    rows, cols = rows[order], cols[order]
    return (torch.from_numpy(tiles).to(dev),
            torch.from_numpy(rows.astype(np.int32)).to(dev),
            torch.from_numpy(cols.astype(np.int32)).to(dev), nb)


def build_block_triples(rows: np.ndarray, cols: np.ndarray,
                        device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Enumerate tile triples (I,J),(I,K),(K,J) all nonzero.

    Same order as the reference's loops: tile ij ascending, then the tiles
    ik of row I in ascending index; (K, J) resolves to the last tile with
    that key.  A placeholder triple (0, 0, 0) keeps the grid non-empty.
    """
    dev = resolve(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    nnzb = rows.size
    t_ij = t_ik = t_kj = np.empty((0,), np.int64)
    if nnzb:
        order = np.argsort(rows, kind="stable")       # tiles grouped by row
        uniq_r, first, counts = np.unique(rows[order], return_index=True,
                                          return_counts=True)
        grp = np.searchsorted(uniq_r, rows)
        n_per = counts[grp]                           # candidates per ij
        ij = np.repeat(np.arange(nnzb), n_per)
        offs = np.arange(ij.size) - np.repeat(np.cumsum(n_per) - n_per, n_per)
        ik = order[np.repeat(first[grp], n_per) + offs]
        width = int(max(rows.max(), cols.max())) + 1
        keys = rows * width + cols
        key_order = np.argsort(keys, kind="stable")
        sorted_keys = keys[key_order]
        want = cols[ik] * width + cols[ij]            # tile (k, j)
        pos = np.searchsorted(sorted_keys, want, side="right") - 1
        pos_c = np.maximum(pos, 0)
        hit = (pos >= 0) & (sorted_keys[pos_c] == want)
        t_ij, t_ik, t_kj = ij[hit], ik[hit], key_order[pos_c][hit]
    if not t_ij.size:  # keep grid non-empty
        t_ij = t_ik = t_kj = np.zeros((1,), np.int64)
    return tuple(torch.from_numpy(t.astype(np.int32)).to(dev)
                 for t in (t_ij, t_ik, t_kj))


def segment_sum_sorted(vals: torch.Tensor, seg_ids, n_segments: int,
                       chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Segment-sum of values whose ``seg_ids`` are sorted ascending.

    Host-side chunking via :func:`chunk_layout`, then kernel K2 on ``vals``'s
    device.  Returns (n_segments,) f32.
    """
    seg = seg_ids.cpu().numpy() if torch.is_tensor(seg_ids) \
        else np.asarray(seg_ids)
    entry_chunk, entry_slot, lids, cblk, nb, total = chunk_layout(
        seg, n_segments, chunk)
    dev = vals.device
    cvals = torch.zeros((total, chunk), dtype=torch.float32, device=dev)
    cvals[torch.from_numpy(entry_chunk).to(dev).long(),
          torch.from_numpy(entry_slot).to(dev).long()] = vals.float()
    out = segment_sum_chunked(cvals, torch.from_numpy(lids).to(dev),
                              torch.from_numpy(cblk).to(dev), nb)
    return out.reshape(-1)[:n_segments]
