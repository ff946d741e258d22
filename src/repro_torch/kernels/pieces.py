"""What K1 (``bsr_spmv``) and K2 (``segment_sum``) share on the host side.

``csrc/pieces.cuh`` builds a piece table on the device for both kernels;
``piece_table`` here is its plain version.  ``aligned`` gives both kernels
the 16-byte aligned base their vector loads need.
"""

from __future__ import annotations

import torch

__all__ = ["piece_table", "aligned"]


def piece_table(block_start: torch.Tensor, piece: int) -> torch.Tensor:
    """(nb + 1,) int32 exclusive scan of each block's piece count.

    Block b owns chunks (K2) or tiles (K1) ``block_start[b]:block_start[b +
    1]``; it gets ``max(ceil(n_b / piece), 1)`` pieces (a block with none
    still gets one, which writes zeros), and piece k of it covers items
    ``block_start[b] + k * piece`` up to ``piece`` further.  The plain
    version of the table that pass 0 of ``csrc/segment_sum.cu`` and
    ``csrc/bsr_spmv.cu`` builds on the device.
    """
    if piece < 1:
        raise ValueError("piece must be >= 1")
    n = (block_start[1:] - block_start[:-1]).to(torch.int64)
    counts = torch.clamp((n + piece - 1) // piece, min=1)
    off = torch.zeros(block_start.shape, dtype=torch.int64,
                      device=block_start.device)
    torch.cumsum(counts, 0, out=off[1:])
    return off.to(torch.int32)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy at a 16-byte aligned base: the kernels read 16-byte
    vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
