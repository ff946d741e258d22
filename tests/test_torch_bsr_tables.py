"""The tables the "bsr" kernels build on the device, in their plain versions
(CPU).

K1 (``csrc/bsr_spmv.cu``) cuts each row block's run of tiles into pieces
with ``pieces.piece_table`` over the row starts; K3's wgmma kernel
(``csrc/bsr_tricount.cu``) walks runs of triples with one IJ tile, from
``bsr_tricount.run_table``.  On the card ``tests/test_torch_kernels_cuda.py``
holds the device-built tables equal to these.  Here the tables are checked
against numpy loops, and the layouts they are built for go through the
reference's Pallas kernels (interpret mode) and the port's wrappers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels.bsr_spmv import bsr_spmv as r_bsr_spmv
from repro.kernels.bsr_tricount import bsr_tricount as r_bsr_tricount
from repro_torch.kernels import bsr_spmv as k1
from repro_torch.kernels import bsr_tricount as k3
from repro_torch.kernels import ops
from repro_torch.kernels.pieces import piece_table

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _hub_rows():
    """Row blocks 0..5: block 2 a hub of 241 tiles, block 4 four tiles of
    one column (duplicates add), the others one tile each."""
    rows = np.sort(np.concatenate([np.arange(6), np.full(240, 2),
                                   np.full(3, 4)])).astype(np.int32)
    return rows


@pytest.mark.parametrize("piece", [1, 2, 8, 32, 300])
def test_k1_piece_table_over_row_starts(piece):
    rows = torch.from_numpy(_hub_rows())
    nb = 6
    row_start = torch.searchsorted(
        rows, torch.arange(nb + 1, dtype=torch.int32)).to(torch.int32)
    got = piece_table(row_start, piece)
    runs = np.diff(row_start.numpy())
    assert runs.tolist() == [1, 1, 241, 1, 4, 1]
    want = [0]
    for n in runs:                       # a loop, as the kernel's CTAs see it
        want.append(want[-1] + max(-(-int(n) // piece), 1))
    assert got.tolist() == want
    # every tile is in exactly one piece of its own row block, and the
    # wrapper's grid bound holds
    owner = np.full(rows.numel(), -1)
    for r in range(nb):
        for k in range(want[r + 1] - want[r]):
            t0 = int(row_start[r]) + k * piece
            t1 = min(int(row_start[r + 1]), t0 + piece)
            assert t1 > t0 and (owner[t0:t1] == -1).all()
            owner[t0:t1] = r
    np.testing.assert_array_equal(owner, rows.numpy())
    assert want[-1] <= nb + -(-rows.numel() // piece)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_hub_layout_matches_reference(rng, dtype):
    # the layout the piece table splits, through the reference's kernel
    rows = _hub_rows()
    cols = rng.integers(0, 5, rows.size).astype(np.int32)
    cols[rows == 4] = 1
    b = 8
    tiles = rng.normal(size=(rows.size, b, b)).astype(np.float32)
    x = rng.normal(size=(5, b)).astype(np.float32)
    want = r_bsr_spmv(jnp.asarray(tiles).astype(getattr(jnp, dtype)),
                      jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(x),
                      6, interpret=True)
    got = k1.bsr_spmv(torch.from_numpy(tiles).to(getattr(torch, dtype)),
                      torch.from_numpy(rows), torch.from_numpy(cols),
                      torch.from_numpy(x), 6)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * 8)


def _run_table_loop(t_ij, max_len):
    starts = []
    for i, v in enumerate(t_ij):
        if i == 0 or v != t_ij[i - 1] or i % max_len == 0:
            starts.append(i)
    return [len(starts)] + starts + [len(t_ij)]


def _triples(rng, n=300, b=16):
    m = n * 4
    s, d = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = s != d
    s, d = s[keep], d[keep]
    src, dst = np.concatenate([s, d]), np.concatenate([d, s])
    tiles, rows, cols, _ = ops.edges_to_bsr(src, dst, n, block=b, device=CPU)
    trip = ops.build_block_triples(rows.numpy(), cols.numpy(), device=CPU)
    return torch.clamp(tiles, max=1.0), trip, (src, dst, n, b)


@pytest.mark.parametrize("case", ["sorted", "shuffled", "placeholder",
                                  "split"])
def test_k3_run_table(rng, case):
    _, (t_ij, _, _), _ = _triples(rng)
    max_len = k3.max_run(128)
    if case == "shuffled":
        t_ij = t_ij[torch.from_numpy(rng.permutation(t_ij.numel()))]
    elif case == "placeholder":
        t_ij = torch.zeros((1,), dtype=torch.int32)
    elif case == "split":            # runs longer than the cap are cut
        max_len = 7
    got = k3.run_table(t_ij, max_len)
    want = _run_table_loop(t_ij.tolist(), max_len)
    assert got.dtype == torch.int32
    assert got.tolist() == want
    lengths = np.diff(want[1:])
    assert lengths.sum() == t_ij.numel() and (lengths >= 1).all()
    assert lengths.max() <= max_len
    if case == "sorted":             # one run per IJ tile
        assert want[0] == len(set(t_ij.tolist()))
    if case == "placeholder":
        assert want == [1, 0, 1]


def test_k3_max_run_keeps_accumulators_exact():
    for b in k3.SM90_BLOCKS:
        assert k3.max_run(b) * b < 2 ** 24 <= (k3.max_run(b) + 1) * b


def test_bsr_tricount_plain_is_order_independent(rng):
    tiles, trip, (src, dst, n, b) = _triples(rng)
    order = torch.from_numpy(rng.permutation(trip[0].numel()))
    shuffled = [t[order].contiguous() for t in trip]
    got = k3.bsr_tricount(tiles, *trip)
    assert int(k3.bsr_tricount(tiles, *shuffled)) == int(got)
    # the reference's kernel on the shuffled order gives the same count
    r_tiles, *_ = r_ops.edges_to_bsr(src, dst, n, block=b)
    want = r_bsr_tricount(jnp.minimum(r_tiles, 1.0),
                          *(jnp.asarray(t.numpy()) for t in shuffled),
                          interpret=True)
    assert int(got) == int(round(float(want)))
    assert int(got) % 6 == 0 and int(got) > 0
