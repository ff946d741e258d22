"""A d-rank "sharded" ``GraphService`` against a one-rank one, on the CPU.

Rank 0 of a spawned gloo world (``_torch_worlds.run_world``) runs the
service and ``serve_follower`` runs on every other rank.  The scripted mix
(``_torch_worlds.service_script``: two sessions, PageRank to 10 rounds and
to ``tol``, a fused BFS group of mixed depths, CC, a cache hit, an
insert-only delta with a warm PageRank, a warm CC and a retained BFS, then
a service under a zero-byte budget) must give every result bit for bit as
a one-rank service in the test process does, with equal ``stats``; only
the bytes the budget evicts differ by the rank count (each ``ShardPlan``
holds d ranks' arrays), so those are compared by what they are made of.
Two sessions submitting at once from threads into a ``workers=2`` service
give the one-rank results too.  A rank that disagreed would wait in a
collective its peers never enter: the world's deadline turns that into a
failure.
"""

import time

import numpy as np
import pytest
import torch

from _torch_worlds import (group_lifetime_job, run_world, service_job,
                           service_script, service_threads_script)
from repro_torch.launch.mesh import ShardGroup
from repro_torch.serve.graph_service import (GraphService, _Mirror,
                                             serve_follower)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def one_rank():
    return service_script(), service_threads_script()


@pytest.fixture(scope="module", params=[2, 3])
def world(request, tmp_path_factory):
    d = request.param
    return d, run_world(service_job, d, tmp_path_factory.mktemp(f"svc{d}"))


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape and
                a.tobytes() == b.tobytes())
    return a == b


def test_results_equal_one_rank_bit_for_bit(world, one_rank):
    d, res = world
    want = one_rank[0]["results"]
    got = res[0]["results"]
    assert set(got) == set(want)
    for k in want:
        assert _same(got[k], want[k]), k
    assert got["hit"] is True


def test_stats_equal_one_rank(world, one_rank):
    d, res = world
    want, got = one_rank[0], res[0]
    assert got["stats"]["main"] == want["stats"]["main"]
    assert want["stats"]["main"]["fused_calls"] == 1
    assert want["stats"]["main"]["warm_starts"] >= 1
    assert want["stats"]["main"]["retained"] >= 1
    assert want["stats"]["main"]["cache_hits"] >= 1
    # the budget service evicts the same entries and families; its plan
    # bytes hold a d-rank ShardPlan, so only "evicted_bytes" differs
    bw, bg = dict(want["stats"]["budget"]), dict(got["stats"]["budget"])
    assert bw.pop("evicted_bytes") > 0 and bg.pop("evicted_bytes") > 0
    assert bg == bw and bw["evicted_results"] > 0
    assert got["evicted_results"] == want["evicted_results"]
    assert got["evicted_plan_families"] == want["evicted_plan_families"]


def test_followers_repeat_calls_and_exit_at_close(world):
    d, res = world
    for r in range(1, d):
        followed = res[r]["followed"]
        assert len(followed) == 3                     # one per service
        assert followed == res[1]["followed"]
        for f in followed:
            assert f["calls"] > 0 and f["graphs"] > 0 and f["errors"] == 0
        # the first service sent the graph and the delta's child; the
        # budget service sends no result to keep (nothing warm-starts)
        assert followed[0]["graphs"] == 2
        assert followed[1]["results_held"] == 0


def test_threaded_sessions_equal_one_rank(world, one_rank):
    d, res = world
    want = one_rank[1]
    got = res[0]["threads"]
    for name in want:
        assert len(got[name]) == len(want[name])
        for a, b in zip(got[name], want[name]):
            assert _same(a, b), name


def test_no_service_thread_outlives_close(world):
    """After the three services' ``close`` rank 0 runs only its main
    thread: a thread left inside torch when the interpreter exits aborts
    the process ("terminate called without an active exception")."""
    d, res = world
    assert res[0]["threads_after_close"] == ["MainThread"]


@pytest.mark.parametrize("d", [2, 3])
def test_a_destroyed_process_group_is_freed(d, tmp_path):
    """``destroy_process_group`` frees the group although ``graph_group``
    and a "sharded" exec hold it (weakly): a gloo group freed only at
    interpreter shutdown aborted a rank now and then ("terminate called
    without an active exception", ``probes/group_exit_abort.py``).  The
    old ``ShardGroup`` then raises, and a new world gets a new group."""
    res = run_world(group_lifetime_job, d, tmp_path, str(tmp_path))
    for r in res:
        assert r["freed"], r
        assert "was destroyed" in r["old_group"], r["old_group"]
        assert r["new_group"]
        assert np.array_equal(r["pagerank"], res[0]["pagerank"])


def test_mirror_close_joins_its_keepalive_thread():
    """``_Mirror.close`` stops and joins the keep-alive thread at once
    (here over a one-rank group, whose broadcast is the identity): before,
    the thread slept on for up to ``keepalive_s / 4`` after ``close``."""
    m = _Mirror(ShardGroup(1, 0), keepalive_s=4.0)
    assert m._ticker.is_alive()
    t0 = time.monotonic()
    m.close()
    assert not m._ticker.is_alive() and time.monotonic() - t0 < 0.5
    assert m.closed
    m.close()                        # a second close is a no-op


def test_one_rank_group_broadcast_is_the_identity():
    t = torch.arange(5)
    header, out = ShardGroup(1, 0).broadcast({"x": 1}, [t])
    assert header == {"x": 1} and out[0] is t


def test_service_at_one_shard_has_no_followers():
    svc = GraphService(engine_backend="sharded", device="cpu")
    try:
        assert svc._mirror is None
    finally:
        svc.close()
    with pytest.raises(ValueError, match="rank 0"):
        serve_follower(ShardGroup(1, 0), device="cpu")


def test_distributed_analytics_example_runs_on_four_ranks(tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.distributed_analytics",
         "--device", "cpu", "--ranks", "4"], capture_output=True, text=True,
        timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2D pagerank err" in out.stdout
    assert "equal to local: True" in out.stdout
