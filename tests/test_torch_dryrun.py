"""The port's dry run (``launch/{dryrun,hlo_cost,ringo_cells}.py``) and
its counting groups (``launch/mesh.py``) against the reference, on the CPU.

The reference's own dry run fails its test
(``tests/test_system.py::test_dryrun_cell_machinery_subprocess``), so its
cells' outputs are not the target.  Held instead:

* ``--list`` byte for byte (the reference in a subprocess: importing
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` in its process);
* the single- and two-pod sweeps: which cells are ``ok``, ``skipped`` and
  ``"error"`` (none: ``ERROR_CELLS`` is empty since the ssm and hybrid
  families run over model ranks; a failing cell would name ``ROADMAP.md``
  Queue 1 item 15 (b)), ``params`` / ``active_params`` against the
  reference's ``param_count`` / ``active_param_count``, argument bytes
  against the sum of ``launch.specs.input_specs``' meta tensors;
* the ringo cells' shard sizes against the reference's formulas, their
  gather bytes against d·ns·itemsize per gathered vector and, on small
  R-MAT graphs, against ``ShardPlan.halo_bytes_per_round``; the ported
  ``pagerank_step_fn`` at d = 1 against the reference's on a one-device
  mesh;
* a reduced dense prefill's counted flops against the reference's
  ``analyze_hlo`` of the same model, attention's term apart (the
  reference's chunk pairs, K4's scored pairs);
* ``hlo_cost``'s counterparts of ``tests/test_sharding.py``'s cost-model
  tests: trip counts come from running the loops.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.ringo_cells import pagerank_step_fn as r_pagerank_step_fn
from repro.models import transformer as RT
from repro_torch.configs.base import SHAPES, get_config, list_archs, reduced
from repro_torch.core.distributed import _inv, pagerank_distributed, shard_graph
from repro_torch.core.graph import Graph
from repro_torch.data.rmat import rmat_edges
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, specs
from repro_torch.launch.hlo_cost import CostCounter
from repro_torch.launch.mesh import (CollectiveLedger, counting_graph_grid,
                                     counting_grid, counting_group,
                                     make_production_mesh)
from repro_torch.launch.ringo_cells import (GRAPHS, pagerank_step_fn,
                                            run_ringo_cell)
from repro_torch.models.transformer import Transformer

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
LM_ARCHS = [a for a in list_archs() if a != "ringo-graph"]
ITEM = "ROADMAP.md Queue 1 item 15 (b)"

# every cell runs: the dense archs train (the sharded train step),
# qwen1.5-4b with its 20 heads over 16 model ranks as whole heads,
# whisper-small and internvl2-26b sharded, the giant models with their
# weights 2-D (``two_d_weights``), and the recurrent families (ssm,
# hybrid) in every shape, long_500k too; jamba's weights are 2-D as well.
# No cell is an error (item 15 (b) is done).
RECURRENT = ["jamba-1.5-large-398b", "xlstm-350m"]
_TRAINED = ["internvl2-26b", "mistral-nemo-12b", "qwen1.5-4b", "qwen2.5-3b",
            "starcoder2-15b", "whisper-small"]
GIANT = ["grok-1-314b", "qwen3-moe-235b-a22b"]
ERROR_CELLS = []
OK_CELLS = sorted([(a, s) for a in _TRAINED + GIANT
                   for s in ("train_4k", "prefill_32k", "decode_32k")]
                  + [(a, s) for a in RECURRENT for s in SHAPES])


def count_cost(fn, *args, ledger=None):
    """The :class:`CostCounter` of ``fn(*args)``."""
    with CostCounter(ledger) as c:
        fn(*args)
    return c


def _run(args, module):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-W", "ignore", "-m", module,
                           *args], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("args", [[], ["--arch", "ringo-graph"],
                                  ["--arch", "qwen2.5-3b"]],
                         ids=["all", "ringo", "one"])
def test_list_equals_reference(args):
    want = _run(["--list", *args], "repro.launch.dryrun")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert dryrun.main(["--list", *args]) == 0
    assert out.getvalue() == want
    assert want.count("\n") == (10 if not args else 1)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """Every cell of ``--all --mesh both``, as the CLI writes them."""
    out = tmp_path_factory.mktemp("dryrun")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = dryrun.main(["--all", "--mesh", "both", "--out", str(out)])
    cells = {}
    for f in out.iterdir():
        r = json.loads(f.read_text())
        cells[(r["arch"], r["shape"], r["multi_pod"])] = r
    return rc, cells, log.getvalue()


def test_sweep_cells_ok_skipped_and_error(sweep):
    rc, cells, log = sweep
    assert len(cells) == len(LM_ARCHS) * len(SHAPES) * 2 == 80
    assert rc == (1 if ERROR_CELLS else 0)   # the reference's: 1 on a failure
    status = {}
    for (arch, shape, _), r in cells.items():
        status.setdefault(r["status"], set()).add((arch, shape))
    assert sorted(status.get("error", ())) == ERROR_CELLS
    assert sorted(status["ok"]) == OK_CELLS
    assert status["skipped"] == {(a, "long_500k") for a in LM_ARCHS} - \
        set(OK_CELLS)
    assert sum(r["status"] == "ok" for r in cells.values()) == 64
    for r in cells.values():
        if r["status"] == "error":
            assert ITEM in r["error"], r["error"]
        if r["status"] == "skipped":
            assert "sub-quadratic" in r["reason"]
    assert log.count("[dryrun]") == 80


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_params_equal_reference(sweep, arch):
    _, cells, _ = sweep
    ref = r_get_config(arch)
    cfg = get_config(arch)
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (ref.param_count(), ref.active_param_count())
    for (a, _, _), r in cells.items():
        if a == arch and r["status"] == "ok":
            assert (r["params"], r["active_params"]) == \
                (ref.param_count(), ref.active_param_count())


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("cell", OK_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_ok_cell_counts(sweep, cell, multi_pod):
    """Argument bytes are ``input_specs``' meta tensors (a train cell's:
    the parameters' blocks, their ZeRO state blocks and the batch); the
    counts are positive and rank 0's.  A giant model's weights are 2-D:
    rank 0 holds a 16th of each over "data", and its train cell's
    gradients of them are reduce-scattered over the 16 data ranks of a
    pod (then summed over "pod": one other part on the wire)."""
    _, cells, _ = sweep
    arch, shape = cell
    r = cells[(arch, shape, multi_pod)]
    assert r["status"] == "ok" and r["kind"] == SHAPES[shape].kind
    assert r["n_chips"] == (512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    _, structs, _ = specs.input_specs(get_config(arch), SHAPES[shape], mesh)
    leaves = torch.utils._pytree.tree_flatten(structs)[0]
    assert all(t.device == META for t in leaves)
    assert r["memory"]["argument_bytes"] == sum(
        t.numel() * t.element_size() for t in leaves)
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["memory"]["peak_bytes"] == r["memory"]["argument_bytes"] + \
        r["memory"]["temp_bytes"]
    # every tensor-parallel sum is a psum: 15 other parts on the wire (a
    # train cell adds the data axis's: 15, or 31 on two pods)
    ar = r["collective_bytes_per_device"]["all-reduce"]
    wire = r["wire_bytes_per_device"]
    two_d = _two_d_grad_bytes(arch, structs[0]) if shape == "train_4k" \
        else (0, 0)
    if arch in GIANT:
        assert two_d[0] or shape != "train_4k"
        assert sum(p.numel() * p.element_size() for p in
                   structs[0].values()) < 2.6e9    # 2.47 / 1.84 GB
    if shape == "train_4k":
        data = 32 if multi_pod else 16
        pod = two_d[0] if multi_pod else 0       # the pods' sums: 1 part
        assert 15 * (ar - pod) + pod <= wire["all-reduce"] <= \
            (data - 1) * (ar - pod) + pod
        params, state, batch, step = structs
        assert step.dtype == torch.int64 and step.dim() == 0
        assert r["memory"]["argument_bytes"] == 8 + sum(
            t.numel() * t.element_size() for t in
            torch.utils._pytree.tree_flatten((params, state, batch))[0])
        # the gradients' reduce-scatter over "data": (d - 1) / d of each;
        # a 2-D weight's over a pod's 16, its gradient in the dtype of the
        # gathered weight
        # an sLSTM's gathers of h reduce-scatter their gradient over the
        # 16 model ranks (15 of 16 blocks received)
        rs = r["collective_bytes_per_device"]["reduce-scatter"]
        mrs = _slstm_gathers(arch, data, backward=True)
        assert wire["reduce-scatter"] == pytest.approx(
            (data - 1) * (rs - two_d[0] - mrs) + two_d[1] + 15 * mrs)
    else:
        assert wire["all-reduce"] == 15 * ar
    if shape == "prefill_32k" and arch == "xlstm-350m":
        # one gather of h a step in each sLSTM block, and the last
        # token's logits
        cfg = get_config(arch)
        b = SHAPES[shape].global_batch // (32 if multi_pod else 16)
        assert r["collective_bytes_per_device"]["all-gather"] == \
            _slstm_gathers(arch, 32 if multi_pod else 16) + \
            b * cfg.vocab_size * 2
    assert "xla_flops_per_device" not in r


def _slstm_gathers(arch, data: int, backward: bool = False) -> int:
    """Rank 0's bytes of the sLSTM's per-step collectives in a cell of
    ``arch`` over ``data`` data ranks: a prefill_32k's all-gathers of
    ``h``, (B, di) float32 a step a block; with ``backward``, a train_4k
    backward's reduce-scatters of their gradients, (B, di / 16) a step
    past the first.  0 for an arch with no sLSTM."""
    cfg = get_config(arch)
    blocks = cfg.n_layers // 2 if cfg.family == "ssm" else 0
    di = cfg.d_model * cfg.ssm_expand
    if backward:
        shape = SHAPES["train_4k"]
        return blocks * (shape.seq_len - 1) * \
            (shape.global_batch // data) * (di // 16) * 4
    shape = SHAPES["prefill_32k"]
    return blocks * shape.seq_len * (shape.global_batch // data) * di * 4


def _two_d_grad_bytes(arch, params):
    """(the float32 bytes of rank 0's reduced gradients of its 2-D weight
    blocks, what their reduce-scatters receive): each 2-D weight is
    gathered once a step (the router in float32, the others in the
    compute dtype), and its gradient's reduce-scatter over a pod's 16 data
    ranks receives 15 of 16 blocks of it."""
    cfg = get_config(arch)
    mesh = make_production_mesh()
    rules = specs.rules_for(cfg, mesh, "train")
    model = Transformer(cfg, device=META, group=counting_grid(mesh),
                        rules=rules)
    compute = torch.empty((), dtype=getattr(torch, cfg.compute_dtype))
    out, wire = 0, 0
    for k, p in model.named_parameters():
        if getattr(p, "data_dim", None) is None:
            continue
        size = 4 if k.endswith("router.w") else compute.element_size()
        out += 4 * params[k].numel()
        wire += 15 * params[k].numel() * size
    return out, wire


def test_the_failing_reference_cell_counterpart():
    """The port's counterpart of ``test_dryrun_cell_machinery_subprocess``:
    its cell, xlstm-350m × decode_32k on the single-pod mesh."""
    r = dryrun.run_cell("xlstm-350m", "decode_32k", False)
    assert r["status"] == "ok"
    assert r["flops_per_device"] > 0
    assert r["n_chips"] == 256


def test_multi_pod_batch_divides_by_32():
    mesh = make_production_mesh(multi_pod=True)
    for shape, local in (("prefill_32k", 1), ("decode_32k", 4)):
        rules = specs.rules_for(get_config("qwen2.5-3b"), mesh,
                                SHAPES[shape].kind, SHAPES[shape])
        assert specs._local_batch(mesh, rules, SHAPES[shape].global_batch) \
            == (("pod", "data"), local)


# ---------------------------------------------------------------------------
# counting groups
# ---------------------------------------------------------------------------


def test_counting_groups_keep_one_ranks_shapes():
    ledger = CollectiveLedger()
    grid = counting_grid(make_production_mesh(multi_pod=True), ledger)
    assert grid.shape == {"data": 32, "model": 16} and grid.size == 512
    assert grid.coords == {"pod": (0, 2), "data": (0, 16), "model": (0, 16)}
    t = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(grid.model.psum(t), t)
    assert torch.equal(grid.model.pmean(t), t / 16)
    g = grid.data.all_gather_dim(t, 1)
    assert torch.equal(g, torch.cat([t] * 32, 1))
    snap = ledger.snapshot()
    assert snap["calls"] == {"all-reduce": 2, "all-gather": 1}
    assert snap["bytes"] == {"all-reduce": 2 * 24.0, "all-gather": 32 * 24.0}
    assert snap["wire_bytes"] == {"all-reduce": 2 * 15 * 24.0,
                                  "all-gather": 31 * 24.0}
    sg = counting_group(8)
    i = torch.arange(8)
    assert torch.equal(sg.all_reduce_sum(i), i)
    assert torch.equal(sg.all_to_all(i), i)
    assert sg.ledger.wire_bytes == {"all-reduce": 2 * 7 / 8 * 64,
                                    "all-to-all": 7 / 8 * 64}
    with pytest.raises(TypeError, match="integers only"):
        sg.all_reduce_sum(i.float())
    with pytest.raises(NotImplementedError, match="broadcast"):
        sg.broadcast("x")
    gg = counting_graph_grid(4)
    assert (gg.r, gg.c) == (0, 0) and gg.world.d == 16
    assert torch.equal(gg.transpose(t), t)
    assert gg.ledger.wire_bytes == {"collective-permute": 0.0}


# ---------------------------------------------------------------------------
# hlo_cost: the reference's cost-model tests, counted by running
# ---------------------------------------------------------------------------


def test_cost_matmul_flops():
    x, y = torch.randn(64, 128), torch.randn(128, 128)
    c = count_cost(lambda: torch.tanh(x @ y) @ y)
    assert c.cost.flops == 2 * (2 * 64 * 128 * 128)
    # two products and a tanh: their inputs and outputs
    assert c.cost.bytes == 4 * (3 * 64 * 128 + 2 * 128 * 128 + 3 * 64 * 128)


def test_cost_multiplies_loop_bodies():
    w = torch.randn(64, 64)

    def g(h):
        for _ in range(16):
            h = torch.tanh(h @ w)
        return h

    c = count_cost(g, torch.randn(32, 64))
    assert c.cost.flops == 2 * 32 * 64 * 64 * 16


def test_cost_nested_loops():
    w = torch.randn(32, 32)

    def nested(h):
        for _ in range(3):
            for _ in range(4):
                h = torch.tanh(h @ w)
        return h

    c = count_cost(nested, torch.randn(16, 32))
    assert c.cost.flops == 2 * 16 * 32 * 32 * 12


def test_cost_counts_collectives_inside_loops():
    group = counting_group(4)

    def h(x):
        for _ in range(5):
            x = x + group.all_gather_cat(x).reshape(4, -1).sum(0)
        return x

    c = count_cost(h, torch.randn(256), ledger=group.ledger)
    assert c.cost.collective_bytes == {"all-gather": 4 * 256 * 4 * 5}
    assert c.wire_bytes == {"all-gather": 3 * 256 * 4 * 5}
    assert c.collective_calls == {"all-gather": 5}
    assert c.cost.total_collective_bytes == 4 * 256 * 4 * 5


def test_cost_skips_views_and_tracks_live_bytes():
    x = torch.randn(1024)
    c = count_cost(lambda: x.view(32, 32).t().reshape(4, 256))
    assert c.cost.bytes == 2 * 4096     # the reshape's copy, nothing else
    c = count_cost(lambda: (x + 1) * 2)
    assert c.peak_live_bytes == 2 * 4096 and c.cost.bytes == 4 * 4096


@pytest.fixture(scope="module")
def dense_cfgs():
    over = dict(n_layers=2)
    return r_reduced(r_get_config("qwen2.5-3b"), **over), \
        reduced(get_config("qwen2.5-3b"), **over)


def test_dense_prefill_flops_match_reference_hlo(dense_cfgs):
    """A reduced dense prefill counted on the meta device against the
    reference's ``analyze_hlo`` of the same model on one CPU device; the
    attention term is each package's own formula (the reference scores
    whole chunk pairs up to the diagonal, K4 the causal pairs)."""
    rcfg, cfg = dense_cfgs
    b, s, chunk = 2, 128, 32
    params = RT.init_params(rcfg, jax.random.PRNGKey(0))
    tokens = jnp.zeros((b, s), jnp.int32)
    hlo = jax.jit(lambda p, t: RT.prefill(p, rcfg, {"tokens": t}, max_seq=s,
                                          chunk=chunk)).lower(
        params, tokens).compile().as_text()
    ref = analyze_hlo(hlo)
    model = Transformer(cfg, device=META)
    with CostCounter() as c:
        model.prefill({"tokens": torch.empty((b, s), dtype=torch.int32,
                                             device=META)}, s, chunk=chunk)
    h, d, layers = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
    n_chunks = s // chunk
    ref_attn = layers * 4 * b * h * d * chunk * chunk * \
        n_chunks * (n_chunks + 1) // 2
    k4_attn = layers * fa.attention_flops((b, s, h, d), (b, s, h, d), True)
    assert k4_attn == layers * 4 * d * b * h * s * (s + 1) // 2
    assert c.cost.flops - k4_attn == ref.flops - ref_attn
    assert c.cost.collective_bytes == {} and ref.collective_bytes == {}


def test_meta_and_cpu_prefill_count_alike_but_attention(dense_cfgs):
    """On the CPU K4 takes its plain version (whole key rows), so only the
    attention term differs from the meta count."""
    _, cfg = dense_cfgs
    b, s = 2, 64
    tokens = torch.zeros((b, s), dtype=torch.int32)
    model = Transformer.init_params(cfg, device="cpu")
    meta = Transformer(cfg, device=META)
    with CostCounter() as cpu:
        model.prefill({"tokens": tokens}, s)
    with CostCounter() as m:
        meta.prefill({"tokens": tokens.to(META)}, s)
    h, d = cfg.n_heads, cfg.resolved_head_dim
    plain = cfg.n_layers * 4 * b * h * d * s * s     # every key, masked
    k4 = cfg.n_layers * fa.attention_flops((b, s, h, d), (b, s, h, d), True)
    assert cpu.cost.flops - plain == m.cost.flops - k4


# ---------------------------------------------------------------------------
# the ringo cells
# ---------------------------------------------------------------------------


RINGO = [(name, mp) for name in GRAPHS for mp in (False, True)]


@pytest.mark.parametrize("name,multi_pod", RINGO,
                         ids=[f"{n}-{'multi' if m else 'single'}"
                              for n, m in RINGO])
def test_ringo_cell_shards_and_gathers(name, multi_pod):
    g = GRAPHS[name]
    r = dryrun.run_cell("ringo-graph", name, multi_pod)
    two_d = g.get("partition") == "2d"
    if two_d and multi_pod:
        assert r["status"] == "skipped" and "single-pod" in r["reason"]
        return
    d = 512 if multi_pod else 256
    assert r["status"] == "ok" and r["n_chips"] == d and r["kind"] == "graph"
    n, e = g["n_nodes"], g["n_edges"]
    wire = 2 if g.get("compress") else 4
    gathered = r["collective_bytes_per_device"]["all-gather"]
    if two_d:
        side = 16
        nb, sl = -(-n // side), -(-(-(-n // side)) // side)
        assert r["shard"] == {"nb": nb, "es": -(-e // d)}
        # x over the column, the dangling sums over the row and the
        # column, the rank vector over the world
        assert gathered == side * sl * wire + 2 * side * 4 + d * sl * 4
        assert r["collective_bytes_per_device"]["all-to-all"] == \
            side * sl * wire
    else:
        ns = -(-n // d)
        assert r["shard"] == {"ns": ns, "es": -(-e // d)}
        # 1/deg and the ranks, then the dangling sum's scalar
        assert gathered == d * ns * 4 + d * ns * wire + d * 4
    assert r["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("d", [2, 4, 8])
def test_ringo_gather_bytes_cover_the_halo(d):
    g = Graph.from_edges(*rmat_edges(10, 8, seed=d), device="cpu")
    group = counting_group(d)
    dg = shard_graph(g, group)
    inv = torch.where(dg.out_deg > 0, 1.0 / dg.out_deg.clamp_min(1.0),
                      torch.zeros(()))
    pr = torch.full((dg.ns,), 1.0 / g.n_nodes)
    step = pagerank_step_fn(group, g.n_nodes, dg.ns)
    with CostCounter(group.ledger) as c:
        out = step(dg.src, dg.dst_local, dg.evalid, dg.seg_len, inv, pr)
    assert out.shape == (dg.ns,) and bool(torch.isfinite(out).all())
    pr_bytes = c.cost.collective_bytes["all-gather"] - d * dg.ns * 4 - d * 4
    assert pr_bytes == d * dg.ns * 4
    halo = g.plan().sharded(d).halo_bytes_per_round()
    assert pr_bytes >= halo
    print(f"d={d}: gathered {pr_bytes} B a round, halo {halo} B, "
          f"ratio {pr_bytes / max(halo, 1):.2f}")


@pytest.mark.parametrize("compress", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 4])
def test_pagerank_step_is_one_round_of_the_engine(d, compress):
    """The 1-D cell times the engine's code: ``pagerank_step_fn`` from the
    uniform start equals rank 0's block of ``pagerank_distributed(...,
    n_iter=1)`` bit for bit, over the same counting group."""
    g = Graph.from_edges(*rmat_edges(9, 8, seed=d), device="cpu")
    group = counting_group(d)
    dg = shard_graph(g, group)
    pr = torch.full((dg.ns,), 1.0 / g.n_nodes)
    step = pagerank_step_fn(group, g.n_nodes, dg.ns, compress_bf16=compress)
    got = step(dg.src, dg.dst_local, dg.evalid, dg.seg_len, _inv(dg.out_deg),
               pr)
    want = pagerank_distributed(dg, n_iter=1, compress_bf16=compress)
    assert bool(dg.nvalid.all())
    assert torch.equal(got, want[:dg.ns])


def test_inert_attention_options_are_refused():
    """``--attn-chunk`` / ``--no-triangle-skip`` steer nothing in the port
    (K4 has fixed tiles and no triangle skip): only their defaults pass."""
    with pytest.raises(ValueError, match="no chunk loop or triangle skip"):
        dryrun.run_cell("qwen2.5-3b", "decode_32k", False, attn_chunk=512)
    with pytest.raises(ValueError, match="no chunk loop or triangle skip"):
        dryrun.run_cell("qwen2.5-3b", "decode_32k", False,
                        skip_upper_triangle=False)
    for argv in (["--list", "--attn-chunk", "512"],
                 ["--list", "--no-triangle-skip"]):
        with pytest.raises(SystemExit) as e, \
                contextlib.redirect_stderr(io.StringIO()):
            dryrun.main(argv)
        assert e.value.code == 2
    with contextlib.redirect_stdout(io.StringIO()):
        assert dryrun.main(["--list", "--attn-chunk", "1024"]) == 0


def test_pagerank_step_matches_reference_at_one_shard():
    rng = np.random.default_rng(0)
    n, e = 300, 2000
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    valid = np.ones(e, bool)
    valid[-37:] = False                    # padding slots trail
    dst[-37:] = 0
    deg = rng.integers(0, 9, n)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0).astype(np.float32)
    pr = (rng.random(n) * 2 / n).astype(np.float32)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("gp",))
    for compress in (False, True):
        want = np.asarray(r_pagerank_step_fn(
            mesh, ("gp",), n, n, e, compress_bf16=compress)(
                *(jnp.asarray(a) for a in (src, dst, valid, inv, pr))))
        seg_len = torch.bincount(torch.where(torch.from_numpy(valid),
                                             torch.from_numpy(dst).long(), n),
                                 minlength=n + 1)
        got = pagerank_step_fn(counting_group(1), n, n,
                               compress_bf16=compress)(
            *(torch.from_numpy(a) for a in (src, dst, valid)), seg_len,
            torch.from_numpy(inv), torch.from_numpy(pr))
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-6 * float(np.abs(want).max()), (compress, err)


def test_ringo_shard_with_data_runs_on_the_cpu():
    """The card phase's inputs: random edges of a (cut) cell's shape; the
    step gives finite ranks of the shard's length."""
    from repro_torch.launch import ringo_cells as rc
    for name in ("pagerank_livejournal", "pagerank_twitter_2d"):
        cell = dict(rc.GRAPHS[name], n_nodes=40_000, n_edges=600_000)
        old = rc.GRAPHS[name]
        rc.GRAPHS[name] = cell
        try:
            step, args, sizes, d = rc.ringo_shard(name, device="cpu", seed=0)
            out = step(*args)
            again = rc.ringo_shard(name, device="cpu", seed=0)
            assert torch.equal(out, again[0](*again[1]))
        finally:
            rc.GRAPHS[name] = old
        assert bool(torch.isfinite(out).all()) and d == 256
        assert out.numel() == (sizes["ns"] if "ns" in sizes
                               else d * -(-sizes["nb"] // 16))
