"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips unless ``torch.cuda.is_available()``.
The file imports no jax, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Inputs come from numpy seeds, as in ``tests/test_kernels.py``'s sweeps, and
go through the kernel and its plain version on the same card.  The last
tests drive the engine on the card: ``frontier_fixpoint`` on CUDA tensors
against the same call on the CPU, bit for bit, over the parity corpus, and
K1 and K2 under ``eigenvector_centrality`` and ``k_core`` against "xla".
"""

import numpy as np
import pytest
import torch

from _torch_oracles import build, corpus
from repro_torch.core import algorithms as A
from repro_torch.core.graph import Graph
from repro_torch.data.rmat import rmat_edges
from repro_torch.kernels import bsr_spmv as k1
from repro_torch.kernels import bsr_tricount as k3
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmv import bsr_spmv, bsr_spmv_plain
from repro_torch.kernels.bsr_tricount import bsr_tricount, bsr_tricount_plain
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (attention_error_ratios,
                                                 flash_attention_fwd,
                                                 flash_attention_fwd_plain)
from repro_torch.kernels.pieces import piece_table
from repro_torch.kernels.segment_sum import (chunk_layout,
                                             segment_sum_chunked,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("piece", [1, 8, 32])
def test_bsr_spmv_kernel_hub_row_block_bit_equal(dev, dtype, piece):
    # a hub row block of 240 tiles (split into many pieces), single-tile
    # row blocks and duplicate (row, col) tiles
    rng = np.random.default_rng(piece)
    rows = np.sort(np.concatenate([np.arange(6), np.full(240, 2),
                                   np.full(3, 4)])).astype(np.int32)
    cols = rng.integers(0, 5, rows.size).astype(np.int32)
    cols[rows == 4] = 1                          # three duplicates add
    tiles = _t(rng.normal(size=(rows.size, 128, 128)).astype(np.float32),
               dev).to(dtype)
    rows, cols = _t(rows, dev), _t(cols, dev)
    x = _t(rng.normal(size=(5, 128)).astype(np.float32), dev)
    tables = torch.zeros((2 * 7,), dtype=torch.int32, device=dev)
    before = bsr_spmv.launches
    a = k1.launch(tiles, rows, cols, x, 6, piece, tables=tables)
    b_ = k1.launch(tiles, rows, cols, x, 6, piece)
    torch.cuda.synchronize()
    assert bsr_spmv.launches == before + 2
    assert torch.equal(a, b_)
    row_start = torch.searchsorted(
        rows, torch.arange(7, dtype=torch.int32, device=dev)).to(torch.int32)
    assert torch.equal(tables[:7], row_start)
    assert torch.equal(tables[7:], piece_table(row_start, piece))
    want = bsr_spmv_plain(tiles, rows, cols, x, 6)
    tol = (5e-2 if dtype == torch.bfloat16 else 1e-5) * max(
        1.0, float(want.abs().max()))
    assert float((a - want).abs().max()) <= tol
    if piece == k1.PIECE_TILES:
        assert torch.equal(bsr_spmv(tiles, rows, cols, x, 6), a)


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


@pytest.mark.parametrize("piece", [1, 16, 64])
def test_segment_sum_kernel_hub_block_bit_equal(dev, piece):
    # one hub block of >= 2,000 chunks among small ones, as RMAT makes them
    rng = np.random.default_rng(piece)
    seg = np.sort(np.concatenate([rng.integers(0, 5000, 20000),
                                  np.full(2000 * 512, 1234)]))
    vals = rng.random(seg.shape[0]).astype(np.float32)
    ec, es, lids, cblk, nb, total = chunk_layout(seg, 5000, 512)
    assert np.bincount(cblk).max() >= 2000
    cv = np.zeros(lids.shape, np.float32)
    cv[ec, es] = vals
    cv, lids, cblk = _t(cv, dev), _t(lids, dev), _t(cblk, dev)
    from repro_torch.kernels import segment_sum as ss
    before = segment_sum_chunked.launches
    tables = torch.zeros((2 * (nb + 1),), dtype=torch.int32, device=dev)
    a = ss.launch(cv, lids, cblk, nb, piece, tables=tables)
    b_ = ss.launch(cv, lids, cblk, nb, piece)
    torch.cuda.synchronize()
    assert segment_sum_chunked.launches == before + 2
    assert torch.equal(a, b_)
    # the tables built on the device equal the plain piece table
    block_start = torch.searchsorted(
        cblk, torch.arange(nb + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    assert torch.equal(tables[:nb + 1], block_start)
    assert torch.equal(tables[nb + 1:], ss.piece_table(block_start, piece))
    want = segment_sum_chunked_plain(cv, lids, cblk, nb)
    tol = 1e-5 * float(want.abs().max())
    assert float((a - want).abs().max()) <= tol
    exact = np.zeros(nb * 128, np.float64)
    np.add.at(exact, seg, vals.astype(np.float64))
    assert np.abs(a.reshape(-1).cpu().numpy() - exact).max() <= tol


def test_segment_sum_kernel_blocks_without_chunks(dev):
    # chunk_block skips blocks 0, 2 and 5: their sums are 0, as in the plain
    rng = np.random.default_rng(4)
    blk = _t(np.asarray([1, 1, 3, 4, 4, 4], np.int32), dev)
    lids = _t(np.sort(rng.integers(0, 129, size=(6, 64)), axis=1
                      ).astype(np.int32), dev)
    cv = _t(rng.normal(size=(6, 64)).astype(np.float32), dev)
    got = segment_sum_chunked(cv, lids, blk, 6)
    want = segment_sum_chunked_plain(cv, lids, blk, 6)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not got[[0, 2, 5]].any()


def test_segment_sum_kernel_long_and_odd_chunks(dev):
    # chunks longer than a warp's 512-slot span, and lengths not a
    # multiple of 16 (scalar loads), sorted and not
    rng = np.random.default_rng(9)
    for l in (1500, 37):
        seg = np.sort(rng.integers(0, 600, 20000))
        vals = rng.normal(size=20000).astype(np.float32)
        got = ops.segment_sum_sorted(_t(vals, dev), seg, 600, chunk=l)
        want = np.zeros(600, np.float64)
        np.add.at(want, seg, vals)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5,
                                   atol=1e-4)
        lids = _t(rng.integers(0, 129, size=(9, l)).astype(np.int32), dev)
        cv = _t(rng.normal(size=(9, l)).astype(np.float32), dev)
        blk = _t(np.asarray([0, 0, 1, 1, 1, 2, 2, 3, 3], np.int32), dev)
        np.testing.assert_allclose(
            segment_sum_chunked(cv, lids, blk, 4).cpu().numpy(),
            segment_sum_chunked_plain(cv, lids, blk, 4).cpu().numpy(),
            rtol=1e-5, atol=1e-4)


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
    which = k3.variant(b)
    assert which == ("sm90_wgmma" if b >= 64 else "wmma")
    before = bsr_tricount.launches
    by_variant = dict(bsr_tricount.launches_by_variant)
    got = bsr_tricount(tiles, tij, tik, tkj)
    torch.cuda.synchronize()
    assert bsr_tricount.launches == before + 1
    assert bsr_tricount.launches_by_variant[which] == by_variant[which] + 1
    assert int(got) == int(bsr_tricount_plain(tiles, tij, tik, tkj))
    assert int(got) % 6 == 0
    if b == 128:   # the WMMA kernel at the wgmma kernel's tile size
        assert int(k3.launch("wmma", tiles, tij, tik, tkj)) == int(got)


def _tricount_case(case, b, rng, dev):
    """0/1 tiles and triples for one edge case of the wgmma kernel."""
    if case == "placeholder":   # an empty graph's one zero tile
        tiles = torch.zeros((1, b, b), device=dev)
        z = torch.zeros((1,), dtype=torch.int32, device=dev)
        return tiles, z, z, z
    nnzb = 7
    # not symmetric, and no tile equals its transpose: a transposed mask
    # or operand changes the count
    tiles = (rng.random((nnzb, b, b)) < 0.3).astype(np.float32)
    n = {"shuffled": 300, "runs_of_one": 40, "not_symmetric": 120}[case]
    tij = np.sort(rng.integers(0, nnzb, n))
    tik, tkj = rng.integers(0, nnzb, n), rng.integers(0, nnzb, n)
    if case == "shuffled":
        order = rng.permutation(n)
        tij, tik, tkj = tij[order], tik[order], tkj[order]
    elif case == "runs_of_one":
        tij = np.arange(n) % nnzb             # t_ij changes at every triple
    return (_t(tiles, dev),) + tuple(_t(a.astype(np.int32), dev)
                                     for a in (tij, tik, tkj))


@pytest.mark.parametrize("b", [64, 128])
@pytest.mark.parametrize("case", ["shuffled", "runs_of_one", "not_symmetric",
                                  "placeholder"])
def test_bsr_tricount_wgmma_edge_cases(dev, case, b):
    rng = np.random.default_rng(b + len(case))
    tiles, tij, tik, tkj = _tricount_case(case, b, rng, dev)
    runs = torch.full((tij.shape[0] + 2,), -1, dtype=torch.int32, device=dev)
    got = k3.launch("sm90_wgmma", tiles, tij, tik, tkj, runs=runs)
    want = bsr_tricount_plain(tiles, tij, tik, tkj)
    torch.cuda.synchronize()
    assert int(got) == int(want)
    table = k3.run_table(tij, k3.max_run(b))
    assert torch.equal(runs[:table.numel()], table)
    if case == "not_symmetric":   # the count a transposed operand would give
        tt = tiles.transpose(1, 2).contiguous()
        assert int(bsr_tricount_plain(tt, tij, tik, tkj)) != int(want)
        assert int(bsr_tricount_plain(tiles, tij, tkj, tik)) != int(want)
    if case == "runs_of_one":
        assert int(table[0]) == tij.shape[0]


def _assert_one_bf16_ulp(got, want):
    # both sides round the same float32 sums to bf16 once, so each element
    # is within one bf16 ulp (2^-7 of its value) of the other
    err = (got.double() - want.double()).abs()
    ratio = float((err / (2.0 ** -7 * want.double().abs() + 1e-6)).max())
    assert ratio <= 1.0, (ratio, float(err.max()))


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 64, 64, 3, 16), (1, 100, 100, 2, 32),
                                         (2, 96, 96, 1, 8), (1, 77, 130, 2, 64),
                                         (1, 130, 77, 2, 64), (2, 200, 200, 2, 128),
                                         (1, 2048, 2048, 2, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, b, sq, sk, h, d, causal,
                                              dtype):
    rng = np.random.default_rng(sq * 1000 + sk + d)
    q, k, v = (_t(rng.normal(size=(b, s, h, d)).astype(np.float32),
                  dev).to(dtype) for s in (sq, sk, sk))
    which = fa.variant(dtype, d)
    before = flash_attention_fwd.launches
    by_variant = dict(flash_attention_fwd.launches_by_variant)
    got = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert flash_attention_fwd.launches_by_variant[which] == \
        by_variant[which] + 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:   # the reference kernel's tolerance
        want = flash_attention_fwd_plain(q, k, v, causal=causal).double()
        assert float((got.double() - want).abs().max()) <= 2e-5
    elif which == "cuda_core":   # D <= 32: p kept in float32, as the plain
        _assert_one_bf16_ulp(got, flash_attention_fwd_plain(q, k, v,
                                                            causal=causal))
    else:   # wgmma: p rounds to bf16 against the running max
        assert which == "sm90_wgmma"
        ref = flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                        causal=causal)
        base = flash_attention_fwd_plain(q, k, v, causal=causal, round_p=True)
        r = attention_error_ratios(got, ref, base)
        assert r["ok"], r


@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 77, 130, 2, 64),
                                         (2, 200, 200, 2, 128)])
def test_flash_attention_cuda_core_variant_bf16_one_ulp(dev, b, sq, sk, h, d):
    # the CUDA-core kernel at head dims the wrapper sends to wgmma in bf16
    rng = np.random.default_rng(sq + d)
    q, k, v = (_t(rng.normal(size=(b, s, h, d)).astype(np.float32),
                  dev).to(torch.bfloat16) for s in (sq, sk, sk))
    got = fa.launch("cuda_core", q, k, v, causal=True)
    _assert_one_bf16_ulp(got, flash_attention_fwd_plain(q, k, v))


def test_flash_attention_wgmma_is_deterministic_and_strided(dev):
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(2, 3, 300, 4, 128)).astype(np.float32),
           dev).to(torch.bfloat16)
    q, k, v = x[:, 0], x[:, 1], x[:, 2]      # views, not contiguous
    a = flash_attention_fwd(q, k, v)
    b_ = flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(a, b_)
    ref = flash_attention_fwd_plain(q.float(), k.float(), v.float())
    base = flash_attention_fwd_plain(q, k, v, round_p=True)
    assert attention_error_ratios(a, ref, base)["ok"]


def test_flash_attention_kernel_rejects_head_dim(dev):
    q = torch.zeros((1, 8, 1, 24), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, q, q)


def test_flash_attention_kernel_strided_input(dev):
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(1, 3, 70, 2, 32)).astype(np.float32), dev)
    q, k, v = x[:, 0], x[:, 1], x[:, 2]      # views at offsets, not contiguous
    got = flash_attention_fwd(q, k, v)
    want = flash_attention_fwd_plain(q, k, v)
    assert float((got - want).abs().max()) <= 2e-5



# ---------------------------------------------------------------------------
# the engine on the card
# ---------------------------------------------------------------------------

GRAPHS = corpus() + [("rmat9", "edges", *rmat_edges(9, 8, seed=9), None)]


@pytest.mark.parametrize("entry", GRAPHS, ids=[e[0] for e in GRAPHS])
def test_frontier_fixpoint_on_the_card_equals_cpu(dev, entry):
    gc = build(Graph, entry, device="cpu")
    gd = build(Graph, entry, device=dev)
    s = int(torch.argmax(gc.plan().out_deg))
    w = np.random.default_rng(7).uniform(0.5, 4.0, gc.n_edges).astype(
        np.float32)
    srcs = np.asarray([0, s, gc.n_nodes - 1], np.int32)
    caps = np.asarray([1, 3, 10_000], np.int32)
    runs = (
        lambda g: A.bfs(g, s, backend="frontier"),
        lambda g: A.sssp(g, s, torch.from_numpy(w).to(g.device),
                         backend="frontier"),
        lambda g: A.bfs(g, torch.from_numpy(srcs).to(g.device), n_iter=caps,
                        backend="frontier"),
        lambda g: A.connected_components(g, backend="frontier"),
        lambda g: A.label_propagation(g, n_iter=3, backend="frontier"),
    )
    for i, fn in enumerate(runs):
        got, want = fn(gd), fn(gc)
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want), f"run {i}"


@pytest.mark.parametrize("backend,kernel", [("bsr", bsr_spmv),
                                            ("pallas", segment_sum_chunked)])
def test_k1_k2_under_eigenvector_centrality_and_k_core(dev, backend, kernel):
    g = Graph.from_edges(*rmat_edges(9, 8, seed=9), device=dev)
    before = kernel.launches
    got = A.eigenvector_centrality(g, n_iter=50, backend=backend)
    assert kernel.launches - before == 50
    want = A.eigenvector_centrality(g, n_iter=50, backend="xla")
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for k in (2, 3, 8):
        before = kernel.launches
        got = A.k_core(g, k, backend=backend)
        assert kernel.launches > before
        assert torch.equal(got, A.k_core(g, k, backend="xla")), f"k={k}"
    assert torch.equal(A.core_numbers(g, backend=backend),
                       A.core_numbers(g, backend="xla"))
