"""Triangle counting as block-sparse A∘(A·A): kernel K3.

Counterpart of ``repro/kernels/bsr_tricount.py``.  ``csrc/bsr_tricount.cu``
multiplies the tile triples on the tensor cores in fp16 (exact for 0/1
tiles) and sums into an int64 (see the note at the top of that file).  The
reference returns an f32 scalar, exact only below 2^24; this one returns the
exact int64 count.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["bsr_tricount", "bsr_tricount_plain", "BLOCKS"]

BLOCKS = (16, 32, 64, 128)    # tile sizes the kernel is built for (WMMA 16x16)


def _check(tiles, t_ij, t_ik, t_kj):
    if tiles.dim() != 3 or tiles.shape[1] != tiles.shape[2] \
            or tiles.dtype != torch.float32:
        raise ValueError(f"tiles must be (nnzb, B, B) float32, got "
                         f"{tuple(tiles.shape)} {tiles.dtype}")
    n = t_ij.shape
    for name, t in (("t_ij", t_ij), ("t_ik", t_ik), ("t_kj", t_kj)):
        if t.dim() != 1 or t.shape != n or t.dtype != torch.int32:
            raise ValueError(f"{name} must be 1-D int32 like t_ij")
    if not (tiles.device == t_ij.device == t_ik.device == t_kj.device):
        raise ValueError("bsr_tricount inputs must share a device")
    if not all(t.is_contiguous() for t in (tiles, t_ij, t_ik, t_kj)):
        raise ValueError("bsr_tricount needs contiguous tensors")


def bsr_tricount(tiles: torch.Tensor, t_ij: torch.Tensor, t_ik: torch.Tensor,
                 t_kj: torch.Tensor) -> torch.Tensor:
    """Ordered-triple count = 6 × #triangles, as a 0-d int64 tensor.

    ``tiles`` (nnzb, B, B) symmetric 0/1 float32 adjacency tiles;
    ``t_ij``, ``t_ik``, ``t_kj`` (n_triples,) int32 tile indices.  A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes the plain
    version.
    """
    _check(tiles, t_ij, t_ik, t_kj)
    if tiles.device.type == "cpu":
        return bsr_tricount_plain(tiles, t_ij, t_ik, t_kj)
    if tiles.device.type != "cuda":
        raise ValueError(f"no kernel for device {tiles.device}")
    b = tiles.shape[1]
    if b not in BLOCKS:
        raise ValueError(f"tile size {b} not in {BLOCKS}")
    if tiles.data_ptr() % 32:
        raise ValueError("tiles must be 32-byte aligned for WMMA loads")
    dev = tiles.device
    out = torch.zeros((1,), dtype=torch.int64, device=dev)
    _build.launch("bsr_tricount", tiles.data_ptr(), t_ij.data_ptr(),
                  t_ik.data_ptr(), t_kj.data_ptr(), out.data_ptr(),
                  int(t_ij.shape[0]), b,
                  torch.cuda.current_stream(dev).cuda_stream)
    bsr_tricount.launches += 1
    return out[0]


bsr_tricount.launches = 0


def bsr_tricount_plain(tiles: torch.Tensor, t_ij: torch.Tensor,
                       t_ik: torch.Tensor, t_kj: torch.Tensor,
                       chunk: int = 2048) -> torch.Tensor:
    """Plain PyTorch K3: chunked ``bmm`` and masked sums, totalled in int64.

    For 0/1 tiles every product entry is an integer <= B and each triple's
    masked sum is <= B^3 = 2^21, so float32 holds both exactly; the total
    is accumulated in int64.
    """
    total = torch.zeros((), dtype=torch.int64, device=tiles.device)
    for lo in range(0, int(t_ij.shape[0]), chunk):
        ij, ik, kj = (t[lo:lo + chunk].long() for t in (t_ij, t_ik, t_kj))
        prod = torch.bmm(tiles[ik], tiles[kj])
        part = (tiles[ij] * prod).sum(dim=(1, 2))
        total += part.to(torch.int64).sum()
    return total
