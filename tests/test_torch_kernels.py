"""The port's kernel modules against the reference's Pallas kernels (CPU).

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernel in interpret mode, as ``tests/test_kernels.py`` does.  The
same numpy inputs, from the same seeds and with the same sweeps and
tolerances, go through both.  The kernels themselves are held against
these plain versions on the card by ``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.bsr_spmv import bsr_spmv as r_bsr_spmv
from repro.kernels.bsr_tricount import bsr_tricount as r_bsr_tricount
from repro.kernels.segment_sum import chunk_layout as r_chunk_layout
from repro.kernels.segment_sum import segment_sum_chunked as r_segsum
from repro_torch.kernels import bsr_spmv as k1
from repro_torch.kernels import bsr_tricount as k3
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_plain
from repro_torch.kernels.bsr_tricount import bsr_tricount
from repro_torch.kernels.segment_sum import (chunk_layout, piece_table,
                                             segment_sum_chunked,
                                             segment_sum_chunked_plain)

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _random_bsr(rng, n_row_blocks, n_col_blocks, b, nnzb):
    rows = np.sort(rng.integers(0, n_row_blocks, nnzb)).astype(np.int32)
    # ensure every row block appears (kernel contract)
    rows[:n_row_blocks] = np.arange(n_row_blocks)
    rows = np.sort(rows)
    cols = rng.integers(0, n_col_blocks, nnzb).astype(np.int32)
    tiles = rng.normal(size=(nnzb, b, b)).astype(np.float32)
    return tiles, rows, cols


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b", [8, 16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsr_spmv_sweep(rng, b, dtype):
    nrb, ncb, nnzb = 4, 3, 10
    tiles, rows, cols = _random_bsr(rng, nrb, ncb, b, nnzb)
    x = rng.normal(size=(ncb, b)).astype(np.float32)
    want = r_bsr_spmv(jnp.asarray(tiles).astype(getattr(jnp, dtype)),
                      jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(x),
                      nrb, interpret=True)
    got = bsr_spmv(_t(tiles).to(getattr(torch, dtype)), _t(rows), _t(cols),
                   _t(x), nrb)
    assert got.dtype == torch.float32 and got.shape == (nrb, b)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("b", [8, 128])
def test_bsr_spmv_duplicate_tiles_accumulate(rng, b):
    tiles = rng.normal(size=(2, b, b)).astype(np.float32)
    rows = cols = np.zeros((2,), np.int32)
    x = rng.normal(size=(1, b)).astype(np.float32)
    want = r_bsr_spmv(jnp.asarray(tiles), jnp.asarray(rows), jnp.asarray(cols),
                      jnp.asarray(x), 1, interpret=True)
    got = bsr_spmv(_t(tiles), _t(rows), _t(cols), _t(x), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_edges_to_bsr_zero_nodes_keeps_grid_nonempty():
    e = np.zeros((0,), np.int32)
    want = r_ops.edges_to_bsr(e, e, 0)
    tiles, rows, cols, nb = ops.edges_to_bsr(e, e, 0, device=CPU)
    assert nb == want[3] == 1
    for a, b in zip((tiles, rows, cols), want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y = bsr_spmv(tiles, rows, cols, torch.zeros((nb, tiles.shape[1])), nb)
    assert y.shape == (1, 128) and not y.any()


def test_segment_sum_chunked_unsorted_ids(rng):
    c, l = 6, 32
    vals = rng.normal(size=(c, l)).astype(np.float32)
    lids = rng.integers(0, 129, size=(c, l)).astype(np.int32)
    blk = np.sort(rng.integers(0, 3, c)).astype(np.int32)
    blk[:3] = np.arange(3)
    blk = np.sort(blk)
    want = r_segsum(jnp.asarray(vals), jnp.asarray(lids), jnp.asarray(blk), 3,
                    interpret=True)
    got = segment_sum_chunked(_t(vals), _t(lids), _t(blk), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(r_ref.segment_sum_chunked_ref(
            jnp.asarray(vals), jnp.asarray(lids), jnp.asarray(blk), 3)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("e,n_seg,chunk", [(100, 40, 16), (1000, 700, 64),
                                           (5000, 260, 512)])
def test_segment_sum_sorted_sweep(rng, e, n_seg, chunk):
    seg = np.sort(rng.integers(0, n_seg, e))
    vals = rng.normal(size=e).astype(np.float32)
    want = r_ops.segment_sum_sorted(jnp.asarray(vals), jnp.asarray(seg), n_seg,
                                    chunk=chunk, interpret=True)
    got = ops.segment_sum_sorted(_t(vals), seg, n_seg, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    ref_sum = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                  num_segments=n_seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_sum),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(chunk_layout(seg, n_seg, chunk),
                    r_chunk_layout(seg, n_seg, chunk)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("piece", [1, 4, 16, 64])
def test_piece_table_matches_numpy(rng, piece):
    # a chunk layout with a hub block, empty-looking runs and single chunks
    seg = np.sort(np.concatenate([rng.integers(0, 2000, 6000),
                                  np.full(40000, 517)]))
    _, _, lids, cblk, nb, total = chunk_layout(seg, 2000, 64)
    blk = torch.from_numpy(cblk)
    block_start = torch.searchsorted(
        blk, torch.arange(nb + 1, dtype=torch.int32)).to(torch.int32)
    got = piece_table(block_start, piece)
    runs = np.diff(np.searchsorted(cblk, np.arange(nb + 1)))
    want = np.concatenate([[0], np.cumsum(np.maximum(-(-runs // piece), 1))])
    assert got.dtype == torch.int32 and got.shape == (nb + 1,)
    np.testing.assert_array_equal(got.numpy(), want)
    # pieces tile every block's chunks: block, first chunk, chunk count
    cover = np.zeros(total, np.int64)
    for b_ in range(nb):
        for k_ in range(want[b_ + 1] - want[b_]):
            c0 = block_start[b_].item() + k_ * piece
            c1 = min(block_start[b_ + 1].item(), c0 + piece)
            cover[c0:c1] += 1
    assert (cover == 1).all()
    assert runs.max() >= 625          # the hub: 40,000 entries / 64
    # the wrapper's grid bound holds
    assert want[-1] <= nb + -(-total // piece)


def test_piece_table_gives_an_empty_block_one_piece():
    got = piece_table(torch.tensor([0, 3, 3, 40, 41], dtype=torch.int32), 16)
    assert got.tolist() == [0, 1, 2, 5, 6]


@pytest.mark.parametrize("n,b", [(64, 8), (300, 16), (260, 128)])
def test_bsr_tricount_sweep(rng, n, b):
    m = n * 4
    s = rng.integers(0, n, m)
    d = rng.integers(0, n, m)
    keep = s != d
    s, d = s[keep], d[keep]
    src, dst = np.concatenate([s, d]), np.concatenate([d, s])
    r_tiles, r_rows, r_cols, r_nb = r_ops.edges_to_bsr(src, dst, n, block=b)
    tiles, rows, cols, nb = ops.edges_to_bsr(src, dst, n, block=b, device=CPU)
    assert nb == r_nb
    for a, w in zip((tiles, rows, cols), (r_tiles, r_rows, r_cols)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    r_trip = r_ops.build_block_triples(np.asarray(r_rows), np.asarray(r_cols))
    trip = ops.build_block_triples(rows.numpy(), cols.numpy(), device=CPU)
    for a, w in zip(trip, r_trip):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    want = r_bsr_tricount(jnp.minimum(r_tiles, 1.0), *r_trip, interpret=True)
    got = bsr_tricount(torch.clamp(tiles, max=1.0), *trip)
    assert got.dtype == torch.int64
    assert int(got) == int(round(float(want)))
    assert int(got) == int(round(float(r_ref.bsr_tricount_ref(
        jnp.minimum(r_tiles, 1.0), r_rows, r_cols, r_nb))))


def test_build_block_triples_empty_keeps_placeholder():
    e = np.zeros((0,), np.int64)
    for a, w in zip(ops.build_block_triples(e, e, device=CPU),
                    r_ops.build_block_triples(e, e)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch(rng):
    tiles, rows, cols = _random_bsr(rng, 2, 2, 16, 4)
    x = rng.normal(size=(2, 16)).astype(np.float32)
    before = bsr_spmv.launches
    got = bsr_spmv(_t(tiles), _t(rows), _t(cols), _t(x), 2)
    assert bsr_spmv.launches == before
    np.testing.assert_array_equal(
        got.numpy(), bsr_spmv_plain(_t(tiles), _t(rows), _t(cols), _t(x),
                                    2).numpy())
    vals = _t(rng.normal(size=(2, 8)).astype(np.float32))
    lids = _t(np.full((2, 8), 128, np.int32))
    blk = _t(np.asarray([0, 1], np.int32))
    before = segment_sum_chunked.launches
    out = segment_sum_chunked(vals, lids, blk, 2)
    assert segment_sum_chunked.launches == before and not out.any()
    np.testing.assert_array_equal(
        out.numpy(), segment_sum_chunked_plain(vals, lids, blk, 2).numpy())


def _bad_calls():
    z2 = torch.zeros((2,), dtype=torch.int32)
    z3 = torch.zeros((3,), dtype=torch.int32)
    t16 = torch.zeros((2, 16, 16))
    x16 = torch.zeros((1, 16))
    noncontig = torch.zeros((16, 2)).t()[:1]          # (1, 16), stride 2
    lids = torch.full((2, 4), 128, dtype=torch.int32)
    return {
        "spmv_dtype": lambda: bsr_spmv(t16.double(), z2, z2, x16, 1),
        "spmv_rows": lambda: bsr_spmv(t16, z3, z2, x16, 1),
        "spmv_block": lambda: bsr_spmv(torch.zeros((2, 12, 12)), z2, z2,
                                       torch.zeros((1, 12)), 1),
        "spmv_noncontig": lambda: bsr_spmv(t16, z2, z2, noncontig, 1),
        "segsum_ids": lambda: segment_sum_chunked(
            torch.zeros((2, 4)), lids.float(), z2, 1),
        "segsum_blocks": lambda: segment_sum_chunked(
            torch.zeros((2, 4)), lids, z3, 1),
        "tricount_dtype": lambda: bsr_tricount(t16.half(), z2, z2, z2),
        "tricount_triples": lambda: bsr_tricount(t16, z2, z2, z3),
        # the variants' launchers take CUDA tensors only: no CPU fallback
        "spmv_launch_cpu": lambda: k1.launch(t16, z2, z2, x16, 1, 8),
        "tricount_launch_cpu": lambda: k3.launch("wmma", t16, z2, z2, z2),
        "run_table_len": lambda: k3.run_table(z2, 0),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()
