"""Chunked segment sum: the "pallas" backend's reduction, kernel K2.

Counterpart of ``repro/kernels/segment_sum.py``.  The reference's TPU kernel
turns each chunk of sorted entries into a one-hot matrix product on the MXU;
here ``csrc/segment_sum.cu`` sums each 128-wide output block's chunks in one
CTA without float atomics (see the note at the top of that file).

``chunk_layout`` is the reference's host-side chunking, copied as numpy: the
plan computes it once per graph and every reduction scatters fresh values
into it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build

__all__ = ["chunk_layout", "segment_sum_chunked", "segment_sum_chunked_plain",
           "DEFAULT_CHUNK", "DEFAULT_BLOCK"]

DEFAULT_CHUNK = 512
DEFAULT_BLOCK = 128
# one chunk's values and ids (8 bytes a slot) must fit the 48 KiB of shared
# memory a CTA gets without opting in to more
_MAX_CHUNK = 48 * 1024 // 8


def chunk_layout(seg_ids: np.ndarray, n_segments: int,
                 chunk: int = DEFAULT_CHUNK
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            int, int]:
    """Static chunking structure for **sorted** segment ids (host-side).

    Groups entries by 128-wide output block and splits each group into
    ``chunk``-long chunks (every block gets >= 1 chunk).  Returns
    ``(entry_chunk, entry_slot, local_ids, chunk_block, nb, C)`` where
    ``local_ids`` is (C, L) int32 with pad id = 128, ``chunk_block`` is (C,)
    sorted ascending, ``nb`` the output block count and ``C`` the total
    chunk count.
    """
    b = DEFAULT_BLOCK
    nb = max((n_segments + b - 1) // b, 1)
    seg = np.asarray(seg_ids, dtype=np.int64)
    e = int(seg.shape[0])
    blocks = seg // b
    starts = np.searchsorted(blocks, np.arange(nb), side="left")
    ends = np.searchsorted(blocks, np.arange(nb), side="right")
    counts = ends - starts
    n_chunks = np.maximum((counts + chunk - 1) // chunk, 1)
    base = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
    total = int(n_chunks.sum())
    pos = np.arange(e) - starts[blocks]
    entry_chunk = (base[blocks] + pos // chunk).astype(np.int32)
    entry_slot = (pos % chunk).astype(np.int32)
    local_ids = np.full((total, chunk), b, np.int32)
    if e:
        local_ids[entry_chunk, entry_slot] = (seg % b).astype(np.int32)
    chunk_block = np.repeat(np.arange(nb), n_chunks).astype(np.int32)
    return entry_chunk, entry_slot, local_ids, chunk_block, nb, total


def _check(vals, local_ids, chunk_block, n_out_blocks):
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise ValueError(f"vals must be (C, L) float32, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if local_ids.shape != vals.shape or local_ids.dtype != torch.int32:
        raise ValueError("local_ids must be int32 with the shape of vals")
    if chunk_block.shape != vals.shape[:1] or chunk_block.dtype != torch.int32:
        raise ValueError("chunk_block must be (C,) int32")
    if n_out_blocks < 1:
        raise ValueError("n_out_blocks must be >= 1")
    if not (vals.device == local_ids.device == chunk_block.device):
        raise ValueError("vals, local_ids and chunk_block must share a device")
    if not all(t.is_contiguous() for t in (vals, local_ids, chunk_block)):
        raise ValueError("segment_sum_chunked needs contiguous tensors")


def segment_sum_chunked(vals: torch.Tensor, local_ids: torch.Tensor,
                        chunk_block: torch.Tensor,
                        n_out_blocks: int) -> torch.Tensor:
    """Segment-sum of pre-chunked sorted data -> (n_out_blocks, 128) f32.

    ``vals`` (C, L) float32 (padding entries may hold anything);
    ``local_ids`` (C, L) int32 ids within the owning 128-block, padding
    >= 128, not necessarily sorted within a chunk; ``chunk_block`` (C,)
    int32, sorted ascending, covering every output block.  A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain version.
    """
    _check(vals, local_ids, chunk_block, n_out_blocks)
    if vals.device.type == "cpu":
        return segment_sum_chunked_plain(vals, local_ids, chunk_block,
                                         n_out_blocks)
    if vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {vals.device}")
    c, l = vals.shape
    if l > _MAX_CHUNK:
        raise ValueError(f"chunk length {l} exceeds {_MAX_CHUNK}")
    dev = vals.device
    block_start = torch.searchsorted(
        chunk_block, torch.arange(n_out_blocks + 1, dtype=torch.int32,
                                  device=dev)).to(torch.int32)
    out = torch.empty((n_out_blocks, DEFAULT_BLOCK), dtype=torch.float32,
                      device=dev)
    _build.launch("segment_sum_chunked", vals.data_ptr(), local_ids.data_ptr(),
                  block_start.data_ptr(), out.data_ptr(), n_out_blocks, l,
                  torch.cuda.current_stream(dev).cuda_stream)
    segment_sum_chunked.launches += 1
    return out


segment_sum_chunked.launches = 0


def segment_sum_chunked_plain(vals: torch.Tensor, local_ids: torch.Tensor,
                              chunk_block: torch.Tensor,
                              n_out_blocks: int) -> torch.Tensor:
    """Plain PyTorch K2: global ids, pads masked, a sorted segmented sum."""
    b = DEFAULT_BLOCK
    keep = (local_ids >= 0) & (local_ids < b)
    gid = (chunk_block.long()[:, None] * b + local_ids.long())[keep]
    v = vals.float()[keep]
    order = torch.argsort(gid, stable=True)
    lengths = torch.bincount(gid, minlength=n_out_blocks * b)
    out = torch.segment_reduce(v[order], "sum", lengths=lengths, unsafe=True)
    return out.view(n_out_blocks, b)
