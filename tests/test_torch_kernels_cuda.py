"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless ``torch.cuda.is_available()``.
The file imports no jax, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Inputs come from numpy seeds, as in ``tests/test_kernels.py``'s sweeps, and
go through the kernel and its plain version on the same card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_plain
from repro_torch.kernels.bsr_tricount import bsr_tricount, bsr_tricount_plain
from repro_torch.kernels.segment_sum import (chunk_layout, segment_sum_chunked,
                                             segment_sum_chunked_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_bsr(rng, n_row_blocks, n_col_blocks, b, nnzb):
    rows = np.sort(rng.integers(0, n_row_blocks, nnzb)).astype(np.int32)
    rows[:n_row_blocks] = np.arange(n_row_blocks)
    rows = np.sort(rows)
    cols = rng.integers(0, n_col_blocks, nnzb).astype(np.int32)
    tiles = rng.normal(size=(nnzb, b, b)).astype(np.float32)
    return tiles, rows, cols


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("b", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bsr_spmv_kernel_matches_plain(dev, b, dtype):
    rng = np.random.default_rng(b)
    tiles, rows, cols = _random_bsr(rng, 4, 3, b, 10)
    x = _t(rng.normal(size=(3, b)).astype(np.float32), dev)
    tiles, rows, cols = _t(tiles, dev).to(dtype), _t(rows, dev), _t(cols, dev)
    before = bsr_spmv.launches
    y = bsr_spmv(tiles, rows, cols, x, 4)
    torch.cuda.synchronize()
    assert bsr_spmv.launches == before + 1
    want = bsr_spmv_plain(tiles, rows, cols, x, 4)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                               rtol=tol, atol=tol * 8)


def test_bsr_spmv_kernel_duplicates_and_zero_node(dev):
    rng = np.random.default_rng(1)
    tiles = _t(rng.normal(size=(2, 128, 128)).astype(np.float32), dev)
    rows = cols = torch.zeros((2,), dtype=torch.int32, device=dev)
    x = _t(rng.normal(size=(1, 128)).astype(np.float32), dev)
    y = bsr_spmv(tiles, rows, cols, x, 1)
    np.testing.assert_allclose(y[0].cpu().numpy(),
                               ((tiles[0] + tiles[1]) @ x[0]).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    e = np.zeros((0,), np.int32)
    tiles, rows, cols, nb = ops.edges_to_bsr(e, e, 0, device=dev)
    y = bsr_spmv(tiles, rows, cols, torch.zeros((nb, 128), device=dev), nb)
    assert nb == 1 and not y.any()


def test_bsr_spmv_kernel_rejects_unsupported_block(dev):
    tiles = torch.zeros((1, 12, 12), device=dev)
    z = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        bsr_spmv(tiles, z, z, torch.zeros((1, 12), device=dev), 1)


@pytest.mark.parametrize("c,l,nb", [(6, 32, 3), (40, 512, 9)])
def test_segment_sum_kernel_unsorted_ids(dev, c, l, nb):
    rng = np.random.default_rng(c)
    vals = _t(rng.normal(size=(c, l)).astype(np.float32), dev)
    lids = _t(rng.integers(0, 129, size=(c, l)).astype(np.int32), dev)
    blk = np.sort(rng.integers(0, nb, c)).astype(np.int32)
    blk[:nb] = np.arange(nb)
    blk = _t(np.sort(blk), dev)
    before = segment_sum_chunked.launches
    got = segment_sum_chunked(vals, lids, blk, nb)
    torch.cuda.synchronize()
    assert segment_sum_chunked.launches == before + 1
    want = segment_sum_chunked_plain(vals, lids, blk, nb)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_segment_sum_kernel_sorted_layout(dev):
    rng = np.random.default_rng(7)
    seg = np.sort(rng.integers(0, 700, 5000))
    vals = rng.normal(size=5000).astype(np.float32)
    got = ops.segment_sum_sorted(_t(vals, dev), seg, 700, chunk=64)
    want = np.zeros(700, np.float64)
    np.add.at(want, seg, vals)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-5)
    ec, es, lids, cblk, nb, total = chunk_layout(seg, 700, 64)
    assert total == lids.shape[0] and nb == 6


@pytest.mark.parametrize("n,b", [(64, 16), (300, 16), (200, 32), (260, 64),
                                 (260, 128)])
def test_bsr_tricount_kernel_exact(dev, n, b):
    rng = np.random.default_rng(n + b)
    m = n * 4
    s, d = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = s != d
    s, d = s[keep], d[keep]
    tiles, rows, cols, _ = ops.edges_to_bsr(np.concatenate([s, d]),
                                            np.concatenate([d, s]), n,
                                            block=b, device=dev)
    tiles = torch.clamp(tiles, max=1.0)
    tij, tik, tkj = ops.build_block_triples(rows.cpu().numpy(),
                                            cols.cpu().numpy(), device=dev)
    before = bsr_tricount.launches
    got = bsr_tricount(tiles, tij, tik, tkj)
    torch.cuda.synchronize()
    assert bsr_tricount.launches == before + 1
    assert int(got) == int(bsr_tricount_plain(tiles, tij, tik, tkj))
    assert int(got) % 6 == 0
