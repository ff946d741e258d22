"""Triangle counting as block-sparse A∘(A·A): kernel K3.

Counterpart of ``repro/kernels/bsr_tricount.py``.  ``csrc/bsr_tricount.cu``
multiplies the tile triples on the tensor cores in fp16 (exact for 0/1
tiles) and sums into an int64 (see the note at the top of that file), in
one of two kernels chosen by tile size (``variant``):

- ``"sm90_wgmma"`` for B in {64, 128}: a persistent grid walks runs of
  consecutive triples with the same IJ tile (``run_table``); TMA feeds the
  fp16 A_IK and A_KJ tiles to ``wgmma``, which accumulates a whole run's
  products, so the A_IJ mask and the integer reduction run once per run.
- ``"wmma"`` for B in {16, 32}: WMMA 16x16x16 on shared-memory slabs,
  masked once per triple.

The reference returns an f32 scalar, exact only below 2^24; this one
returns the exact int64 count.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["bsr_tricount", "bsr_tricount_plain", "run_table", "max_run",
           "variant", "launch", "BLOCKS", "SM90_BLOCKS", "VARIANTS"]

BLOCKS = (16, 32, 64, 128)    # tile sizes the kernels are built for
SM90_BLOCKS = (64, 128)       # tile sizes of the wgmma kernel
VARIANTS = ("sm90_wgmma", "wmma")
_ENTRY = {"sm90_wgmma": "bsr_tricount_sm90", "wmma": "bsr_tricount_wmma"}


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
    ``t_ij``, ``t_ik``, ``t_kj`` (n_triples,) int32 tile indices, in any
    order (triples sorted by ``t_ij`` make the longest runs).  A CUDA
    tensor launches the kernel of ``variant(B)`` (or raises); a CPU tensor
    takes the plain version.
    """
    _check(tiles, t_ij, t_ik, t_kj)
    if tiles.device.type == "cpu":
        return bsr_tricount_plain(tiles, t_ij, t_ik, t_kj)
    if tiles.device.type != "cuda":
        raise ValueError(f"no kernel for device {tiles.device}")
    return _launch(variant(tiles.shape[1]), tiles, t_ij, t_ik, t_kj, None)


bsr_tricount.launches = 0
bsr_tricount.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def variant(block: int) -> str:
    """Which kernel a CUDA call takes: ``"sm90_wgmma"`` for tiles of
    ``SM90_BLOCKS``, ``"wmma"`` otherwise."""
    return "sm90_wgmma" if block in SM90_BLOCKS else "wmma"


def max_run(block: int) -> int:
    """Most triples one accumulator of the wgmma kernel sums: every entry
    (at most run length × B for 0/1 tiles) stays below 2^24, so f32 is
    exact."""
    return (2 ** 24 - 1) // block


def launch(which: str, tiles: torch.Tensor, t_ij: torch.Tensor,
           t_ik: torch.Tensor, t_kj: torch.Tensor,
           runs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch one variant's kernel on CUDA tensors and count the launch in
    ``bsr_tricount.launches`` and its ``launches_by_variant``.  The wrapper
    calls it with ``variant(B)``; ``chip_smoke.py`` also times ``"wmma"``
    at B = 128.  ``runs``, if given, is an (n_triples + 2,) int32 CUDA
    tensor that receives the ``"sm90_wgmma"`` kernel's device-built run
    table (``run_table``'s first R + 2 entries)."""
    _check(tiles, t_ij, t_ik, t_kj)
    if tiles.device.type != "cuda":
        raise ValueError(f"no kernel for device {tiles.device}")
    if which not in VARIANTS:
        raise ValueError(f"variant {which!r} not in {VARIANTS}")
    return _launch(which, tiles, t_ij, t_ik, t_kj, runs)


def _launch(which, tiles, t_ij, t_ik, t_kj, runs):
    b, n, dev = tiles.shape[1], int(t_ij.shape[0]), tiles.device
    blocks = SM90_BLOCKS if which == "sm90_wgmma" else BLOCKS
    if b not in blocks:
        raise ValueError(f"tile size {b} not in {blocks}")
    out = torch.zeros((1,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if which == "sm90_wgmma":
        if runs is None:
            runs = torch.empty((n + 2,), dtype=torch.int32, device=dev)
        elif (runs.shape != (n + 2,) or runs.dtype != torch.int32
              or runs.device != dev):
            raise ValueError("runs must be (n_triples + 2,) int32")
        half = tiles.to(torch.float16)   # 0/1 is exact; a fresh, aligned copy
        _build.launch(_ENTRY[which], half.data_ptr(), t_ij.data_ptr(),
                      t_ik.data_ptr(), t_kj.data_ptr(), runs.data_ptr(),
                      out.data_ptr(), n, int(tiles.shape[0]), b, stream)
    else:
        if tiles.data_ptr() % 32:
            raise ValueError("tiles must be 32-byte aligned for WMMA loads")
        _build.launch(_ENTRY[which], tiles.data_ptr(), t_ij.data_ptr(),
                      t_ik.data_ptr(), t_kj.data_ptr(), out.data_ptr(), n, b,
                      stream)
    bsr_tricount.launches += 1
    bsr_tricount.launches_by_variant[which] += 1
    return out[0]


def run_table(t_ij: torch.Tensor, max_len: int) -> torch.Tensor:
    """(R + 2,) int32: ``[R, start_0, ..., start_{R-1}, n]``, the runs of
    ``t_ij`` that the ``"sm90_wgmma"`` kernel walks.  A run starts at 0,
    where ``t_ij`` changes, and at every multiple of ``max_len``, so no run
    is longer than ``max_len``.  The plain version of the table the kernel
    builds on the device (pass 0 of ``csrc/bsr_tricount.cu``)."""
    if max_len < 1:
        raise ValueError("max_len must be >= 1")
    n = int(t_ij.shape[0])
    pos = torch.arange(n, device=t_ij.device)
    start = pos % max_len == 0
    start[1:] |= t_ij[1:] != t_ij[:-1]
    first = pos[start]
    return torch.cat([first.new_tensor([first.numel()]), first,
                      first.new_tensor([n])]).to(torch.int32)


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
