"""Block-sparse SpMV: the "bsr" backend's pull and push, kernel K1.

Counterpart of ``repro/kernels/bsr_spmv.py``.  ``csrc/bsr_spmv.cu`` splits
each row block's run of tiles into pieces of at most ``PIECE_TILES`` tiles,
one CTA each, that stream the tiles with 16-byte loads; a second pass adds
a row block's pieces in order, with no float atomics (see the note at the
top of that file).  The kernel builds its row and piece tables on the
device, with no host sync; ``pieces.piece_table`` over the row starts is
the plain version of the piece table.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .pieces import aligned

__all__ = ["bsr_spmv", "bsr_spmv_plain", "launch", "DEFAULT_BLOCK", "BLOCKS",
           "PIECE_TILES"]

DEFAULT_BLOCK = 128
BLOCKS = (8, 16, 32, 64, 128)    # tile sizes the kernel is built for
# most tiles one CTA of the kernel reads; a longer row block is split
PIECE_TILES = 8
_ENTRY = {torch.float32: "bsr_spmv_f32", torch.bfloat16: "bsr_spmv_bf16"}


def _check(tiles, rows, cols, x_blocks, n_row_blocks):
    if tiles.dim() != 3 or tiles.shape[1] != tiles.shape[2]:
        raise ValueError(f"tiles must be (nnzb, B, B), got {tuple(tiles.shape)}")
    if tiles.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tiles must be float32 or bfloat16, got {tiles.dtype}")
    b = tiles.shape[1]
    if b not in BLOCKS:
        raise ValueError(f"tile size {b} not in {BLOCKS}")
    nnzb = tiles.shape[0]
    for name, t in (("rows", rows), ("cols", cols)):
        if t.shape != (nnzb,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({nnzb},) int32")
    if x_blocks.dim() != 2 or x_blocks.shape[1] != b \
            or x_blocks.dtype != torch.float32:
        raise ValueError(f"x_blocks must be (n_col_blocks, {b}) float32")
    if n_row_blocks < 0:
        raise ValueError("n_row_blocks must be >= 0")
    if not (tiles.device == rows.device == cols.device == x_blocks.device):
        raise ValueError("bsr_spmv inputs must share a device")
    if not all(t.is_contiguous() for t in (tiles, rows, cols, x_blocks)):
        raise ValueError("bsr_spmv needs contiguous tensors")


def bsr_spmv(tiles: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             x_blocks: torch.Tensor, n_row_blocks: int) -> torch.Tensor:
    """y = A @ x for BSR ``A`` -> (n_row_blocks, B) f32.

    ``tiles`` (nnzb, B, B) f32 or bf16; ``rows`` (nnzb,) int32 row-block
    ids sorted ascending and covering every row block (duplicate tiles add);
    ``cols`` (nnzb,) int32; ``x_blocks`` (n_col_blocks, B) f32, rounded to
    the tile type before the product.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes the plain version.
    """
    _check(tiles, rows, cols, x_blocks, n_row_blocks)
    if tiles.device.type == "cpu":
        return bsr_spmv_plain(tiles, rows, cols, x_blocks, n_row_blocks)
    if tiles.device.type != "cuda":
        raise ValueError(f"no kernel for device {tiles.device}")
    return _launch(tiles, rows, cols, x_blocks, n_row_blocks, PIECE_TILES,
                   None)


bsr_spmv.launches = 0


def launch(tiles: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           x_blocks: torch.Tensor, n_row_blocks: int, piece: int,
           tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All passes of the kernel on CUDA tensors, at most ``piece`` tiles a
    CTA; counts one launch in ``bsr_spmv.launches``.  The wrapper passes
    ``PIECE_TILES``; ``chip_smoke.py`` also times other piece sizes.
    ``tables``, if given, is a (2 * (n_row_blocks + 1),) int32 CUDA tensor
    that receives the device-built ``row_start`` and
    ``piece_table(row_start, piece)``."""
    _check(tiles, rows, cols, x_blocks, n_row_blocks)
    if tiles.device.type != "cuda":
        raise ValueError(f"no kernel for device {tiles.device}")
    if piece < 1:
        raise ValueError("piece must be >= 1")
    return _launch(tiles, rows, cols, x_blocks, n_row_blocks, piece, tables)


def _launch(tiles, rows, cols, x_blocks, n_row_blocks, piece, tables):
    dev, nnzb, b = tiles.device, tiles.shape[0], tiles.shape[1]
    nb = n_row_blocks
    if tables is None:
        tables = torch.empty((2 * (nb + 1),), dtype=torch.int32, device=dev)
    elif (tables.shape != (2 * (nb + 1),) or tables.dtype != torch.int32
          or tables.device != dev):
        raise ValueError("tables must be (2 * (n_row_blocks + 1),) int32")
    # the sum over row blocks of max(ceil(n_R / piece), 1) is at most
    # nb + ceil(nnzb / piece)
    max_pieces = nb + (nnzb + piece - 1) // piece
    partial = torch.empty((max_pieces, b), dtype=torch.float32, device=dev)
    y = torch.empty((nb, b), dtype=torch.float32, device=dev)
    tiles, x_blocks = aligned(tiles), aligned(x_blocks)
    _build.launch(_ENTRY[tiles.dtype], tiles.data_ptr(),
                  rows.data_ptr(), cols.data_ptr(), x_blocks.data_ptr(),
                  tables.data_ptr(), partial.data_ptr(), y.data_ptr(), nnzb,
                  nb, b, piece, max_pieces,
                  torch.cuda.current_stream(dev).cuda_stream)
    bsr_spmv.launches += 1
    return y


def bsr_spmv_plain(tiles: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                   x_blocks: torch.Tensor, n_row_blocks: int) -> torch.Tensor:
    """Plain PyTorch K1: ``bmm`` of the tiles with the gathered x blocks,
    then a segmented sum over the sorted rows.

    The product is float32 (bf16 tiles and the rounded x upcast exactly),
    which on the card assumes ``torch.backends.cuda.matmul.allow_tf32`` is
    False, PyTorch's default.
    """
    xg = x_blocks[cols.long()].to(tiles.dtype).float()
    prod = torch.bmm(tiles.float(), xg.unsqueeze(-1)).squeeze(-1)
    lengths = torch.bincount(rows.long(), minlength=n_row_blocks)
    return torch.segment_reduce(prod, "sum", lengths=lengths, axis=0,
                                unsafe=True)
