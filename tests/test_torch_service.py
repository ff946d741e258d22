"""The port's interactive workspace service (repro_torch/serve/graph_service.py).

The reference's ``tests/test_service.py``, case for case, on the port with
``device="cpu"``: shared versioned workspace, session isolation, declarative
execution, the fusion scheduler (concurrent single-source traversals -> one
batched engine call), the versioned result cache, delta retention and warm
starts, admission control and fair share.  Then the parity cases: one
scripted request sequence through the reference's and the port's services
on each corpus graph gives equal results (integers exactly, floats within
1e-5 of the largest value) and equal ``stats`` dicts, and a budgeted port
service answers as an unbounded one does.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import algorithms as A
from repro_torch.core import provenance as P
from repro_torch.core.graph import EdgeDelta, Graph
from repro_torch.core.table import INT, STR, Table
from repro_torch.data.rmat import rmat_edges
from repro_torch.serve.graph_service import (
    DeadlineExpired, GraphService, RejectedError, ServiceError, Workspace)
from repro_torch.serve.policy import (AdmissionPolicy, BatchPolicy,
                                      FairSharePolicy, MemoryPolicy,
                                      SchedulerPolicy)


def rmat_graph(scale=7, edge_factor=4, seed=0):
    s, d = rmat_edges(scale, edge_factor=edge_factor, seed=seed)
    return Graph.from_edges(s, d, device="cpu")


def make_service(**kw):
    svc = GraphService(**kw, device="cpu")
    svc.workspace.put("g", rmat_graph())
    return svc


# ---------------------------------------------------------------------------
# workspace + sessions
# ---------------------------------------------------------------------------


def test_workspace_put_get_version():
    ws = Workspace()
    g = rmat_graph()
    v = ws.put("g", g)
    assert ws.get("g") is g
    assert ws.version("g") == v == g.version
    with pytest.raises(KeyError):
        ws.get("nope")


def test_workspace_update_is_functional_and_bumps_version():
    ws = Workspace()
    ws.put("g", Graph.from_edges([0, 1], [1, 2], device="cpu"))
    v0 = ws.version("g")
    v1 = ws.update("g", lambda g: g.add_edges([2], [0]))
    assert v1 != v0
    assert ws.get("g").n_edges == 3


def test_session_isolation():
    svc = make_service()
    s1, s2 = svc.session("alice"), svc.session("bob")
    s1.put("mine", Table.from_columns({"x": INT}, {"x": [1, 2]}, device="cpu"))
    assert "mine" in s1.local_names()
    with pytest.raises(KeyError):
        s2.get("mine")                    # local writes don't leak
    # "as" bindings are session-local too
    s1.execute({"op": "pagerank", "graph": "g", "params": {"n_iter": 2},
                "as": "pr"})
    with pytest.raises(KeyError):
        s2.get("pr")
    # publish promotes to the shared workspace
    s1.publish("mine")
    assert s2.get("mine") is svc.workspace.get("mine")


def test_sessions_fall_through_to_workspace():
    svc = make_service()
    s = svc.session("alice")
    assert s.get("g") is svc.workspace.get("g")


# ---------------------------------------------------------------------------
# declarative execution
# ---------------------------------------------------------------------------


def test_execute_algorithm_and_table_pipeline():
    svc = GraphService(device="cpu")
    t = Table.from_columns(
        {"u": INT, "v": INT, "tag": STR},
        {"u": [0, 1, 2, 3], "v": [1, 2, 0, 0], "tag": ["a", "a", "a", "b"]}, device="cpu")
    svc.workspace.put("edges", t)
    s = svc.session("alice")
    s.execute({"op": "select", "table": "edges",
               "params": {"col": "tag", "op": "==", "value": "a"},
               "as": "sel"})
    s.execute({"op": "to_graph", "table": "sel",
               "params": {"src_col": "u", "dst_col": "v"}, "as": "g"})
    pr = s.execute({"op": "pagerank", "graph": "g",
                    "params": {"n_iter": 5}, "as": "pr"})
    want = A.pagerank(s.get("g"), n_iter=5)
    np.testing.assert_array_equal(np.asarray(pr), np.asarray(want))
    # the result's provenance chain reaches back to the root table
    recs = P.records_of(s.get("pr"))
    assert [r.op for r in recs] == ["relational.select", "convert.to_graph",
                                    "algorithms.pagerank"]


def test_unknown_op_rejected_and_missing_slot_reported():
    svc = make_service()
    s = svc.session("alice")
    with pytest.raises(ServiceError):
        s.submit({"op": "frobnicate"})
    p = s.submit({"op": "pagerank"})      # missing "graph" slot
    svc.flush()
    with pytest.raises(ServiceError):
        p.result()


# ---------------------------------------------------------------------------
# fusion scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sssp", "bfs", "personalized_pagerank"])
def test_fused_multi_source_parity_vs_sequential(op):
    svc = make_service()
    g = svc.workspace.get("g")
    sources = [0, 3, 7, 11]
    pending = [svc.session(f"u{i}").submit(
        {"op": op, "graph": "g", "params": {"source": s}})
        for i, s in enumerate(sources)]
    svc.flush()
    assert svc.stats["fused_calls"] == 1
    assert svc.stats["fused_requests"] == len(sources)
    assert svc.stats["engine_calls"] == 1
    fn = getattr(A, op)
    for p, s in zip(pending, sources):
        got = np.asarray(p.result())
        assert p.fused
        np.testing.assert_array_equal(got, np.asarray(fn(g, s)))


def test_fused_rows_carry_single_source_provenance():
    svc = make_service()
    pending = [svc.session(f"u{i}").submit(
        {"op": "sssp", "graph": "g", "params": {"source": s}})
        for i, s in enumerate([2, 5])]
    svc.flush()
    for p, s in zip(pending, [2, 5]):
        rec = P.records_of(p.result())[-1]
        assert rec.op == "algorithms.sssp"
        assert dict(rec.params)["source"] == s


def test_mixed_params_do_not_fuse_together():
    svc = make_service()
    a = svc.session("a").submit({"op": "sssp", "graph": "g",
                                 "params": {"source": 0}})
    b = svc.session("b").submit({"op": "personalized_pagerank", "graph": "g",
                                 "params": {"source": 0, "n_iter": 3}})
    svc.flush()
    assert svc.stats["fused_calls"] == 0    # different ops: nothing coalesced
    assert a.result().shape == b.result().shape


def test_fusion_disabled_runs_individually():
    svc = make_service(fuse=False)
    pending = [svc.session(f"u{i}").submit(
        {"op": "sssp", "graph": "g", "params": {"source": s}})
        for i, s in enumerate([0, 3])]
    svc.flush()
    assert svc.stats["fused_calls"] == 0
    assert svc.stats["engine_calls"] == 2
    g = svc.workspace.get("g")
    for p, s in zip(pending, [0, 3]):
        np.testing.assert_array_equal(np.asarray(p.result()),
                                      np.asarray(A.sssp(g, s)))


# ---------------------------------------------------------------------------
# cross-n_iter fusion: mixed depth limits coalesce into one engine call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["bfs", "sssp"])
def test_mixed_depth_requests_fuse_into_one_call(op):
    svc = make_service()
    g = svc.workspace.get("g")
    cases = [(0, None), (3, 2), (7, 5), (11, None)]
    pending = [svc.session(f"u{i}").submit(
        {"op": op, "graph": "g",
         "params": {"source": s} if d is None
         else {"source": s, "n_iter": d}})
        for i, (s, d) in enumerate(cases)]
    svc.flush()
    assert svc.stats["fused_calls"] == 1
    assert svc.stats["fused_requests"] == len(cases)
    assert svc.stats["engine_calls"] == 1
    fn = getattr(A, op)
    for p, (s, d) in zip(pending, cases):
        want = fn(g, s) if d is None else fn(g, s, n_iter=d)
        assert p.fused
        np.testing.assert_array_equal(np.asarray(p.result()),
                                      np.asarray(want), err_msg=f"{s}/{d}")


def test_mixed_depth_ppr_fuses_with_default_n_iter():
    svc = make_service()
    g = svc.workspace.get("g")
    pending = [svc.session(f"u{i}").submit(
        {"op": "personalized_pagerank", "graph": "g", "params": pr})
        for i, pr in enumerate([{"source": 1}, {"source": 2, "n_iter": 3}])]
    svc.flush()
    assert svc.stats["fused_calls"] == 1
    np.testing.assert_array_equal(
        np.asarray(pending[0].result()),
        np.asarray(A.personalized_pagerank(g, 1)))
    np.testing.assert_array_equal(
        np.asarray(pending[1].result()),
        np.asarray(A.personalized_pagerank(g, 2, n_iter=3)))


def test_mixed_depth_rows_carry_per_request_provenance():
    svc = make_service()
    pending = [svc.session(f"u{i}").submit(
        {"op": "bfs", "graph": "g", "params": pr})
        for i, pr in enumerate([{"source": 2, "n_iter": 4}, {"source": 5}])]
    svc.flush()
    rec0 = P.records_of(pending[0].result())[-1]
    assert dict(rec0.params) == {"source": 2, "n_iter": 4}
    rec1 = P.records_of(pending[1].result())[-1]
    assert dict(rec1.params) == {"source": 5}   # no depth limit recorded


def test_result_cache_keys_on_per_request_n_iter():
    svc = make_service()
    s = svc.session("a")
    r2 = s.execute({"op": "bfs", "graph": "g",
                    "params": {"source": 3, "n_iter": 2}})
    assert svc.stats["cache_hits"] == 0
    # same source, same depth: a hit, no engine call
    calls = svc.stats["engine_calls"]
    r2b = s.execute({"op": "bfs", "graph": "g",
                     "params": {"source": 3, "n_iter": 2}})
    assert svc.stats["cache_hits"] == 1
    assert svc.stats["engine_calls"] == calls
    assert r2b is r2
    # same source, different depth: its own key, fresh execution
    r4 = s.execute({"op": "bfs", "graph": "g",
                    "params": {"source": 3, "n_iter": 4}})
    assert svc.stats["engine_calls"] == calls + 1
    assert r4 is not r2
    assert int(np.asarray(r4).max()) >= int(np.asarray(r2).max())


# ---------------------------------------------------------------------------
# result cache
# ---------------------------------------------------------------------------


def test_cache_hit_on_repeat_and_across_sessions():
    svc = make_service()
    req = {"op": "pagerank", "graph": "g", "params": {"n_iter": 4}}
    r1 = svc.session("a").execute(req)
    r2 = svc.session("b").execute(dict(req))
    assert r1 is r2                       # same object: served from cache
    assert svc.stats["cache_hits"] == 1
    assert svc.stats["engine_calls"] == 1


def test_cache_invalidates_on_functional_update():
    svc = GraphService(device="cpu")
    svc.workspace.put("g", Graph.from_edges([0, 1], [1, 2], device="cpu"))
    req = {"op": "pagerank", "graph": "g", "params": {"n_iter": 4}}
    s = svc.session("a")
    r1 = s.execute(req)
    svc.workspace.update("g", lambda g: g.add_edges([2], [0]))
    r2 = s.execute(dict(req))
    assert svc.stats["cache_hits"] == 0   # version bumped: the key changed
    assert r2 is not r1
    want = A.pagerank(svc.workspace.get("g"), n_iter=4)
    np.testing.assert_array_equal(np.asarray(r2), np.asarray(want))


def test_cached_fused_row_hits_without_engine_call():
    svc = make_service()
    req = {"op": "sssp", "graph": "g", "params": {"source": 5}}
    svc.session("a").execute(req)
    calls = svc.stats["engine_calls"]
    out = svc.session("b").execute(dict(req))
    assert svc.stats["engine_calls"] == calls
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(A.sssp(svc.workspace.get("g"), 5)))


def test_cache_disabled_always_recomputes():
    svc = make_service(cache=False)
    req = {"op": "pagerank", "graph": "g", "params": {"n_iter": 2}}
    svc.session("a").execute(req)
    svc.session("a").execute(dict(req))
    assert svc.stats["cache_hits"] == 0
    assert svc.stats["engine_calls"] == 2


# ---------------------------------------------------------------------------
# delta-aware cache retention + warm-start recomputation
# ---------------------------------------------------------------------------


def _path_service():
    """0 -> 1 -> 2 -> 3: small enough to reason about retention by hand."""
    svc = GraphService(device="cpu")
    svc.workspace.put("p", Graph.from_edges([0, 1, 2], [1, 2, 3], device="cpu"))
    return svc


def test_retention_rebinds_unaffected_entries_across_delta():
    """A cached BFS stays served from cache after an insert that provably
    cannot shorten any distance (back edge 2->1: D[2]+1 >= D[1])."""
    svc = _path_service()
    s = svc.session("a")
    req = {"op": "bfs", "graph": "p", "params": {"source": 0}}
    r1 = s.execute(req)
    calls = svc.stats["engine_calls"]
    svc.workspace.apply_delta("p", EdgeDelta.inserts([2], [1]))
    r2 = s.execute(dict(req))
    assert svc.stats["engine_calls"] == calls      # no recompute at all
    assert svc.stats["retained"] >= 1
    np.testing.assert_array_equal(np.asarray(r2), np.asarray(r1))
    np.testing.assert_array_equal(                 # and it is still correct
        np.asarray(r2), np.asarray(A.bfs(svc.workspace.get("p"), 0)))


def test_affected_query_warm_starts_and_stays_exact():
    """An insert that shortens a path (0->3) defeats retention; the engine
    warm-starts from the parent levels and matches the cold answer."""
    svc = _path_service()
    s = svc.session("a")
    req = {"op": "bfs", "graph": "p", "params": {"source": 0}}
    s.execute(req)
    svc.workspace.apply_delta("p", EdgeDelta.inserts([0], [3]))
    r2 = s.execute(dict(req))
    assert np.asarray(r2)[3] == 1                  # shortcut is visible
    assert svc.stats["retained"] == 0
    assert svc.stats["warm_starts"] >= 1
    np.testing.assert_array_equal(
        np.asarray(r2), np.asarray(A.bfs(svc.workspace.get("p"), 0)))
    # warm-started results carry cold-equivalent provenance, flagged
    rec = P.records_of(r2)[-1]
    assert rec.op == "algorithms.bfs"
    assert dict(rec.meta).get("incremental") is True


def test_deletions_fall_back_to_cold_recompute():
    svc = _path_service()
    s = svc.session("a")
    req = {"op": "bfs", "graph": "p", "params": {"source": 0}}
    s.execute(req)
    svc.workspace.apply_delta(
        "p", EdgeDelta(add_src=[2], add_dst=[0], del_src=[0], del_dst=[1]))
    r2 = s.execute(dict(req))
    assert svc.stats["retained"] == 0              # deletion: never retained
    assert svc.stats["incremental_fallbacks"] >= 1
    np.testing.assert_array_equal(
        np.asarray(r2), np.asarray(A.bfs(svc.workspace.get("p"), 0)))


def test_warm_pagerank_under_tol_matches_cold():
    svc = make_service()
    s = svc.session("a")
    req = {"op": "pagerank", "graph": "g", "params": {"tol": 1e-6}}
    s.execute(req)
    ids = np.asarray(svc.workspace.get("g").node_ids)[:8]
    svc.workspace.apply_delta("g", EdgeDelta.inserts(ids[:4], ids[4:8]))
    r2 = s.execute(dict(req))
    assert svc.stats["warm_starts"] >= 1
    np.testing.assert_allclose(
        np.asarray(r2),
        np.asarray(A.pagerank(svc.workspace.get("g"), tol=1e-6)), atol=1e-5)


def test_incremental_disabled_never_retains_or_warms():
    svc = GraphService(incremental=False, device="cpu")
    svc.workspace.put("p", Graph.from_edges([0, 1, 2], [1, 2, 3], device="cpu"))
    s = svc.session("a")
    req = {"op": "bfs", "graph": "p", "params": {"source": 0}}
    s.execute(req)
    calls = svc.stats["engine_calls"]
    svc.workspace.apply_delta("p", EdgeDelta.inserts([2], [1]))
    s.execute(dict(req))
    assert svc.stats["retained"] == 0
    assert svc.stats["warm_starts"] == 0
    assert svc.stats["engine_calls"] == calls + 1  # plain cold recompute


def test_session_stats_carry_cache_counters():
    svc = _path_service()
    a, b = svc.session("a"), svc.session("b")
    req = {"op": "connected_components", "graph": "p", "params": {}}
    a.execute(req)
    a.execute(dict(req))
    b.execute(dict(req))                           # b: pure cache hit
    st = svc.session_stats("a")
    assert st["cache_misses"] >= 1 and st["cache_hits"] >= 1
    assert st["retained"] == 0
    assert "completed" in st                       # scheduler fields coexist
    svc.workspace.apply_delta("p", EdgeDelta.inserts([2], [1]))
    a.execute(dict(req))                           # labels equal: retained
    assert svc.session_stats("a")["retained"] == 1
    assert svc.session_stats("b")["retained"] == 0  # counters are per-session


# ---------------------------------------------------------------------------
# concurrency smoke: many threads, one batching window
# ---------------------------------------------------------------------------


def test_threaded_submissions_are_safe():
    svc = make_service()
    g = svc.workspace.get("g")
    results = {}

    def worker(i):
        s = svc.session(f"u{i}")
        p = s.submit({"op": "bfs", "graph": "g", "params": {"source": i}})
        results[i] = p

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    svc.flush()
    for i, p in results.items():
        np.testing.assert_array_equal(np.asarray(p.result()),
                                      np.asarray(A.bfs(g, i)))


# ---------------------------------------------------------------------------
# admission control: quotas, backpressure, deadlines
# ---------------------------------------------------------------------------


def test_inflight_quota_rejects_with_retry_after():
    svc = make_service(policy=SchedulerPolicy(
        admission=AdmissionPolicy(max_inflight=2)))
    s = svc.session("alice")
    req = {"op": "pagerank", "graph": "g", "params": {"n_iter": 2}}
    a = s.submit(dict(req))
    b = s.submit({**req, "params": {"n_iter": 3}})
    with pytest.raises(RejectedError) as ei:
        s.submit({**req, "params": {"n_iter": 4}})
    assert ei.value.retry_after > 0
    assert svc.stats["rejected"] == 1
    assert svc.session_stats("alice")["rejected"] == 1
    # draining frees the quota; the session may submit again
    svc.flush()
    a.result(), b.result()
    c = s.submit({**req, "params": {"n_iter": 4}})
    svc.flush()
    assert np.asarray(c.result()).shape == (svc.workspace.get("g").n_nodes,)


def test_quota_is_per_session_not_global():
    svc = make_service(policy=SchedulerPolicy(
        admission=AdmissionPolicy(max_inflight=1)))
    svc.session("a").submit({"op": "pagerank", "graph": "g",
                             "params": {"n_iter": 2}})
    # a different session has its own quota
    svc.session("b").submit({"op": "pagerank", "graph": "g",
                             "params": {"n_iter": 2}})
    with pytest.raises(RejectedError):
        svc.session("a").submit({"op": "pagerank", "graph": "g",
                                 "params": {"n_iter": 3}})
    svc.flush()


def test_queue_depth_backpressure_rejects_any_session():
    svc = make_service(policy=SchedulerPolicy(
        admission=AdmissionPolicy(max_inflight=64, max_queue_depth=2)))
    svc.session("a").submit({"op": "pagerank", "graph": "g",
                             "params": {"n_iter": 2}})
    svc.session("b").submit({"op": "pagerank", "graph": "g",
                             "params": {"n_iter": 3}})
    with pytest.raises(RejectedError) as ei:
        svc.session("c").submit({"op": "pagerank", "graph": "g",
                                 "params": {"n_iter": 4}})
    assert ei.value.retry_after > 0
    svc.flush()


def test_expired_deadline_never_reaches_the_engine():
    svc = make_service()
    s = svc.session("alice")
    p = s.submit({"op": "pagerank", "graph": "g", "params": {"n_iter": 5},
                  "deadline_ms": 0})
    svc.flush()
    assert svc.stats["engine_calls"] == 0       # dropped before execution
    assert svc.stats["expired"] == 1
    assert svc.session_stats("alice")["expired"] == 1
    assert svc.session_stats("alice")["completed"] == 0   # not double-counted
    with pytest.raises(DeadlineExpired):
        p.result()
    # a generous deadline executes normally
    out = s.execute({"op": "pagerank", "graph": "g", "params": {"n_iter": 5},
                     "deadline_ms": 60_000})
    assert svc.stats["engine_calls"] == 1
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(A.pagerank(svc.workspace.get("g"),
                                               n_iter=5)))


def test_expired_member_is_dropped_from_coalesced_batch():
    svc = make_service()
    live = svc.session("a").submit({"op": "bfs", "graph": "g",
                                    "params": {"source": 1}})
    stale = svc.session("b").submit({"op": "bfs", "graph": "g",
                                     "params": {"source": 2},
                                     "deadline_ms": 0})
    svc.flush()
    assert svc.stats["expired"] == 1
    with pytest.raises(DeadlineExpired):
        stale.result()
    np.testing.assert_array_equal(
        np.asarray(live.result()),
        np.asarray(A.bfs(svc.workspace.get("g"), 1)))


# ---------------------------------------------------------------------------
# fair share: a flooding session cannot starve interactive ones
# ---------------------------------------------------------------------------


def _submit_overload(svc, n_flood=8, n_interactive=3):
    """One flooding session (non-fusable pageranks, submitted FIRST) and one
    interactive session (single-source bfs that coalesce into one call)."""
    flood = svc.session("flood")
    inter = svc.session("inter")
    flood_pending = [flood.submit({"op": "pagerank", "graph": "g",
                                   "params": {"n_iter": 2 + i}})
                     for i in range(n_flood)]
    inter_pending = [inter.submit({"op": "bfs", "graph": "g",
                                   "params": {"source": i}})
                     for i in range(n_interactive)]
    return flood_pending, inter_pending


def test_fair_share_serves_interactive_ahead_of_flood_backlog():
    svc = make_service(cache=False, policy=SchedulerPolicy(mode="fair"))
    flood_pending, inter_pending = _submit_overload(svc)
    # two scheduling decisions: one flood request, then the whole
    # interactive batch — the flood's 7-deep backlog is still queued
    svc.scheduler.step()
    svc.scheduler.step()
    assert all(p.done for p in inter_pending)
    assert sum(p.done for p in flood_pending) <= 2
    assert svc.scheduler.queued_count("flood") >= 6
    svc.flush()
    # everyone still completes (work-conserving), and the flood session was
    # charged the engine time it consumed
    assert all(p.done for p in flood_pending)
    # both sessions were charged the engine time they consumed (at this toy
    # scale jit compiles dominate, so only the accounting is asserted)
    assert svc.session_stats("flood")["engine_ms"] > 0
    assert svc.session_stats("inter")["engine_ms"] > 0


def test_fifo_mode_makes_interactive_wait_behind_flood():
    svc = make_service(cache=False, policy=SchedulerPolicy(mode="fifo"))
    flood_pending, inter_pending = _submit_overload(svc)
    svc.scheduler.step()
    svc.scheduler.step()
    # strict arrival order: the flood's backlog runs first
    assert not any(p.done for p in inter_pending)
    assert sum(p.done for p in flood_pending) == 2
    svc.flush()
    assert all(p.done for p in inter_pending)


def test_fair_share_completion_share_tracks_weights():
    """With the flood queued deep, interactive completions never fall below
    the share its weight entitles it to (here: it finishes first)."""
    svc = make_service(cache=False, policy=SchedulerPolicy(
        mode="fair", fair=FairSharePolicy(weights={"inter": 2.0})))
    flood_pending, inter_pending = _submit_overload(svc, n_flood=10,
                                                    n_interactive=4)
    done_after = []
    for _ in range(4):
        svc.scheduler.step()
        done_after.append(sum(p.done for p in inter_pending))
    # all interactive requests completed within the first few decisions
    assert done_after[-1] == len(inter_pending)
    svc.flush()


# ---------------------------------------------------------------------------
# negative-weight SSSP: never coalesced (|V|-round bound assumes w >= 0)
# ---------------------------------------------------------------------------


def _weighted_path_service(weights):
    svc = GraphService(device="cpu")
    svc.workspace.put("g", Graph.from_edges([0, 1, 2], [1, 2, 3], device="cpu"))
    return svc, torch.as_tensor(np.asarray(weights, np.float32))


def test_negative_weight_sssp_requests_split_out_of_fusion():
    svc, w = _weighted_path_service([1.0, -1.0, 2.0])
    g = svc.workspace.get("g")
    pending = [svc.session(f"u{i}").submit(
        {"op": "sssp", "graph": "g",
         "params": {"source": s, "weights": w}})
        for i, s in enumerate([0, 1])]
    svc.flush()
    assert svc.stats["fused_calls"] == 0        # split: one call per request
    assert svc.stats["engine_calls"] == 2
    for p, s in zip(pending, [0, 1]):
        assert not p.fused
        np.testing.assert_allclose(np.asarray(p.result()),
                                   np.asarray(A.sssp(g, s, weights=w)))


def test_non_negative_weight_sssp_requests_still_fuse():
    svc, w = _weighted_path_service([1.0, 0.5, 2.0])
    g = svc.workspace.get("g")
    pending = [svc.session(f"u{i}").submit(
        {"op": "sssp", "graph": "g",
         "params": {"source": s, "weights": w}})
        for i, s in enumerate([0, 1])]
    svc.flush()
    assert svc.stats["fused_calls"] == 1        # the regression guard's dual
    assert svc.stats["engine_calls"] == 1
    for p, s in zip(pending, [0, 1]):
        np.testing.assert_allclose(np.asarray(p.result()),
                                   np.asarray(A.sssp(g, s, weights=w)))


# ---------------------------------------------------------------------------
# batching windows + worker mode + scheduling metadata
# ---------------------------------------------------------------------------


def test_effective_window_is_zero_when_idle_and_scales_with_load():
    bp = BatchPolicy(window_ms=10.0, load_full_at=4)
    assert bp.effective_window_s(0) == 0.0      # idle: no added latency
    assert 0 < bp.effective_window_s(1) < bp.effective_window_s(4)
    assert bp.effective_window_s(4) == pytest.approx(0.010)
    assert bp.effective_window_s(400) == pytest.approx(0.010)  # capped


def test_batch_window_coalesces_late_arrival_under_load():
    svc = make_service(policy=SchedulerPolicy(
        batch=BatchPolicy(window_ms=400.0, load_full_at=1)))
    early = svc.session("a").submit({"op": "bfs", "graph": "g",
                                     "params": {"source": 0}})
    # unrelated queued work puts the scheduler "under load", opening the
    # window when the bfs is dispatched
    other = svc.session("b").submit({"op": "pagerank", "graph": "g",
                                     "params": {"n_iter": 2}})
    t = threading.Thread(
        target=lambda: svc.scheduler.step(allow_wait=True), daemon=True)
    t.start()
    time.sleep(0.08)                           # well inside the 0.4s window
    late = svc.session("c").submit({"op": "bfs", "graph": "g",
                                    "params": {"source": 3}})
    t.join(timeout=10)
    svc.flush()
    assert svc.stats["batch_windows"] >= 1
    assert early.fused and late.fused          # the window caught the burst
    assert svc.stats["fused_requests"] >= 2
    other.result()


def test_worker_mode_executes_without_flush():
    svc = make_service(workers=1)
    try:
        g = svc.workspace.get("g")
        pending = [svc.session(f"u{i}").submit(
            {"op": "bfs", "graph": "g", "params": {"source": i}})
            for i in range(3)]
        for i, p in enumerate(pending):        # no flush() anywhere
            np.testing.assert_array_equal(np.asarray(p.result(timeout=120)),
                                          np.asarray(A.bfs(g, i)))
    finally:
        svc.close()


def test_results_carry_queueing_and_coalescing_metadata():
    svc = make_service()
    pending = [svc.session(f"u{i}").submit(
        {"op": "sssp", "graph": "g", "params": {"source": s}})
        for i, s in enumerate([0, 5])]
    svc.flush()
    for p in pending:
        meta = dict(P.records_of(p.result())[-1].meta)
        assert meta["batch"] == 2
        assert meta["sched_mode"] == "fair"
        assert meta["queued_ms"] >= 0
    # non-fused path is annotated too
    out = svc.session("solo").execute({"op": "pagerank", "graph": "g",
                                       "params": {"n_iter": 3}})
    meta = dict(P.records_of(out)[-1].meta)
    assert meta["batch"] == 1
    # ...and the metadata never leaks into replay (same program as an
    # un-scheduled run)
    recs = P.records_of(out)
    replayed = P.replay(recs[-1:], {recs[-1].inputs[0][1]:
                                    svc.workspace.get("g")})
    np.testing.assert_array_equal(np.asarray(replayed), np.asarray(out))


# ---------------------------------------------------------------------------
# service -> provenance export (the full §4 loop)
# ---------------------------------------------------------------------------


def test_service_results_export_and_rebuild():
    svc = GraphService(device="cpu")
    t = Table.from_columns({"u": INT, "v": INT},
                           {"u": [0, 1, 2, 3, 0], "v": [1, 2, 3, 0, 2]}, device="cpu")
    svc.workspace.put("edges", t)
    s = svc.session("alice")
    s.execute({"op": "to_graph", "table": "edges",
               "params": {"src_col": "u", "dst_col": "v"}, "as": "g"})
    s.execute({"op": "pagerank", "graph": "g", "params": {"n_iter": 6},
               "as": "pr"})
    tbl = s.execute({"op": "table_from_map", "graph": "g", "scores": "pr",
                     "params": {"key_name": "node", "value_name": "score"},
                     "as": "ranked"})
    script = P.export_script(tbl)
    ns = {}
    exec(compile(script, "<service-export>", "exec"), ns)
    rebuilt = ns["rebuild"]()
    np.testing.assert_array_equal(rebuilt.column_np("score"),
                                  tbl.column_np("score"))


# ---------------------------------------------------------------------------
# workspace thread-safety under concurrent connections (serving hardening)
# ---------------------------------------------------------------------------


def test_workspace_concurrent_updates_are_never_lost():
    """Two writers doing functional updates must both land (CAS retry).

    Regression for the read-modify-write race the socket server exposes:
    with last-writer-wins semantics, two connections updating one name
    concurrently silently dropped one side's edges.
    """
    ws = Workspace()
    ws.put("g", Graph.from_edges([0], [1], device="cpu"))
    n_threads, n_updates = 4, 6
    errs = []

    def bump(tid):
        try:
            for i in range(n_updates):
                # every thread adds a unique edge; dedupe can't collapse them
                ws.update("g", lambda g, t=tid, k=i:
                          g.add_edges([1000 + t], [2000 + t * 100 + k]))
        except Exception as e:                      # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=bump, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errs
    final = ws.get("g")
    assert final.n_edges == 1 + n_threads * n_updates
    # name->version map stays consistent with the object it names
    assert ws.version("g") == P.version_of(final)


def test_workspace_update_restarts_against_fresh_object():
    """A CAS loser re-runs fn against the winner's object, not the stale
    snapshot it originally read."""
    ws = Workspace()
    ws.put("t", Table.from_columns({"x": INT}, {"x": [1]}, device="cpu"))
    seen = []
    started = threading.Event()
    proceed = threading.Event()

    def slow_fn(t):
        seen.append(t.n_valid)
        started.set()
        proceed.wait(30)                 # hold the update open...
        return t.with_column_added("y", INT, np.zeros(t.n_valid, np.int32)) \
            if "y" not in t.schema else t

    slow = threading.Thread(target=lambda: ws.update("t", slow_fn))
    slow.start()
    started.wait(30)
    # ...while a fast update wins the race
    ws.update("t", lambda t: Table.from_columns({"x": INT}, {"x": [1, 2]}, device="cpu"))
    proceed.set()
    slow.join(60)
    assert seen[0] == 1 and seen[-1] == 2    # fn re-ran on the fresh table
    assert ws.get("t").n_valid == 2


def test_close_resolves_outstanding_requests():
    """close() must drain what the dying workers left queued — a caller
    blocked in result() against a worker-backed service would otherwise
    wait forever (workers alive => no inline drain in _ensure_progress)."""
    svc = make_service(workers=1)
    s = svc.session("a")
    ps = [s.submit({"op": "pagerank", "graph": "g",
                    "params": {"n_iter": n}}) for n in (2, 3, 4, 5)]
    svc.close()
    for p in ps:
        assert p.result(timeout=30) is not None


def test_close_waits_for_a_worker_in_an_engine_call(monkeypatch):
    """close() returns only once every worker has stopped, even one whose
    engine call outlasts a few seconds: a worker left running would still
    be inside torch when the process exits, which aborts it."""
    from repro_torch.serve import graph_service as gs
    entered, release = threading.Event(), threading.Event()
    fn, slots = gs._OPS["pagerank"]

    def slow(*args, **kwargs):
        entered.set()
        release.wait(30)
        return fn(*args, **kwargs)

    monkeypatch.setitem(gs._OPS, "pagerank", (slow, slots))
    monkeypatch.setitem(gs._FOLLOW_FNS, "pagerank", slow)
    svc = make_service(workers=1)
    p = svc.session("a").submit({"op": "pagerank", "graph": "g",
                                 "params": {"n_iter": 2}})
    assert entered.wait(30)
    timer = threading.Timer(6.0, release.set)
    timer.start()
    try:
        svc.close()
        assert not any(t.is_alive() for t in threading.enumerate()
                       if t.name.startswith("graph-service-worker"))
        assert p.result(timeout=0) is not None
    finally:
        release.set()
        timer.cancel()


# ---------------------------------------------------------------------------
# stats consistency under concurrent workers
# ---------------------------------------------------------------------------


def test_stats_counters_exact_under_two_workers():
    """Hammer a worker-backed service from two threads: ``stats`` counters
    are mutated from submitters, scheduler workers and drain callers — the
    dedicated stats lock must make every increment land (no lost updates),
    and the obs mirror must agree."""
    from repro_torch import obs

    svc = make_service(workers=2)
    n_per_thread = 200
    obs_before = obs.counter("service.requests").value
    errors = []

    def hammer(tag):
        s = svc.session(f"hammer-{tag}")
        try:
            for i in range(n_per_thread):
                while True:
                    try:
                        p = s.submit({"op": "bfs", "graph": "g",
                                      "params": {"source": i % 7}})
                        break
                    except RejectedError as e:
                        time.sleep(min(e.retry_after, 0.005))
                p.result(timeout=60)
        except Exception as e:            # pragma: no cover - diagnostic
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    svc.close()
    assert not errors
    total = 2 * n_per_thread
    assert svc.stats["requests"] == total
    assert obs.counter("service.requests").value - obs_before == total
    # every request either hit the cache or reached the engine exactly once
    served = (svc.stats["cache_hits"] + svc.stats["engine_calls"]
              + svc.stats["fused_requests"] - svc.stats["fused_calls"]
              + svc.stats["retained"])
    assert svc.stats["cache_hits"] + svc.stats["cache_misses"] >= \
        svc.stats["engine_calls"]
    assert served >= svc.stats["engine_calls"]


def test_wire_array_parameters_key_on_the_host_then_run_on_the_device():
    svc = make_service()
    g = svc.workspace.get("g")

    def frozen(a):              # as the wire decodes them: read-only views
        a = np.asarray(a, np.int32)
        a.flags.writeable = False
        return a

    s = svc.session("a")
    req = {"op": "personalized_pagerank", "graph": "g",
           "params": {"source": frozen([1, 2]), "n_iter": frozen([3, 4])}}
    got = s.execute(req)
    want = A.personalized_pagerank(g, torch.tensor([1, 2]),
                                   n_iter=np.asarray([3, 4]))
    assert torch.equal(got, want)
    # equal arrays, new objects: the same cache key
    again = s.submit({**req, "params": {"source": frozen([1, 2]),
                                        "n_iter": frozen([3, 4])}})
    assert again.cached and again.result() is got


@pytest.mark.parametrize("op", ["pagerank", "bfs", "triangle_count"])
def test_sharded_engine_backend_at_one_shard_equals_xla(op):
    # at one shard every engine call runs through ShardedExec in this
    # process and answers what "xla" answers, bit for bit (more shards:
    # tests/test_torch_sharded_service.py)
    svc = make_service(engine_backend="sharded")
    params = {"source": 0} if op == "bfs" else {}
    p = svc.session("a").submit({"op": op, "graph": "g", "params": params})
    svc.flush()
    g = svc.workspace.get("g")
    want = getattr(A, op)(g, **params, backend="xla")
    got = p.result()
    if torch.is_tensor(want):
        assert got.dtype == want.dtype and torch.equal(got, want)
    else:
        assert got == want
    assert any(type(ex).__name__ == "ShardedExec"
               for ex in g.plan().execs.values()) or op == "triangle_count"
    assert svc.stats["engine_calls"] == 1


# ---------------------------------------------------------------------------
# parity with the reference's service
# ---------------------------------------------------------------------------

from _torch_oracles import build, corpus  # noqa: E402
from repro.core.graph import EdgeDelta as RefEdgeDelta  # noqa: E402
from repro.core.graph import Graph as RefGraph  # noqa: E402
from repro.serve.graph_service import GraphService as RefService  # noqa: E402

CORPUS = corpus()


def _host(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def assert_same_value(ref, port, what):
    """Integers and booleans exactly, floats within 1e-5 of the largest."""
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(ref) == len(port), what
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same_value(a, b, f"{what}[{i}]")
        return
    if isinstance(ref, Table) or hasattr(ref, "to_pydict"):
        assert ref.to_pydict() == port.to_pydict(), what
        return
    if isinstance(ref, (int, float)) and not hasattr(ref, "shape"):
        assert ref == port, what
        return
    a, b = np.asarray(ref), _host(port)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(b, a, err_msg=what)


def scripted_run(svc, graph, delta_cls, ids, n):
    """One fixed request sequence; returns [(label, value)] and the stats.

    Covers fusion (uniform and mixed depth), the cache (a repeat and a
    cross-session hit), every algorithm family, a table conversion, then
    an insert-only delta (retention and warm starts) and a delete delta
    (cold recomputation).
    """
    svc.workspace.put("g", graph)
    a, b = svc.session("a"), svc.session("b")
    src = [i % n for i in (0, 1, 3, 5)]
    out = []

    def run(sess, label, req):
        out.append((label, sess.execute(req)))

    pend = [(f"bfs{s}", (a if i % 2 else b).submit(
        {"op": "bfs", "graph": "g", "params": {"source": s}}))
        for i, s in enumerate(src)]
    pend += [(f"ppr{s}", a.submit(
        {"op": "personalized_pagerank", "graph": "g",
         "params": {"source": s, "n_iter": 5 if i % 2 else 10}}))
        for i, s in enumerate(src)]
    pend += [(f"sssp{s}", b.submit(
        {"op": "sssp", "graph": "g", "params": {"source": s}}))
        for s in src[:2]]
    svc.flush()
    out += [(label, p.result()) for label, p in pend]
    run(a, "pr10", {"op": "pagerank", "graph": "g", "params": {"n_iter": 10}})
    run(b, "pr10_hit", {"op": "pagerank", "graph": "g",
                        "params": {"n_iter": 10}})
    run(a, "pr_tol", {"op": "pagerank", "graph": "g",
                      "params": {"tol": 1e-6}})
    run(a, "hits", {"op": "hits", "graph": "g", "params": {"n_iter": 5}})
    run(a, "cc", {"op": "connected_components", "graph": "g"})
    run(b, "lp", {"op": "label_propagation", "graph": "g",
                  "params": {"n_iter": 64}})
    run(a, "scc", {"op": "strongly_connected_components", "graph": "g"})
    run(a, "kcore", {"op": "k_core", "graph": "g", "params": {"k": 2}})
    run(b, "cores", {"op": "core_numbers", "graph": "g"})
    run(a, "tri", {"op": "triangle_count", "graph": "g"})
    run(a, "eig", {"op": "eigenvector_centrality", "graph": "g",
                   "params": {"n_iter": 10}})
    run(b, "edges", {"op": "graph_to_edge_table", "graph": "g"})
    # insert-only delta: retention and warm starts, then a delete delta
    rng = np.random.default_rng(3)
    pick = lambda k: ids[rng.integers(0, len(ids), k)].astype(np.int32)
    svc.workspace.apply_delta("g", delta_cls.inserts(pick(4), pick(4)))
    run(a, "bfs_after_insert", {"op": "bfs", "graph": "g",
                                "params": {"source": src[0]}})
    run(b, "cc_after_insert", {"op": "connected_components", "graph": "g"})
    run(b, "lp_after_insert", {"op": "label_propagation", "graph": "g",
                               "params": {"n_iter": 64}})
    run(a, "pr_tol_after_insert", {"op": "pagerank", "graph": "g",
                                   "params": {"tol": 1e-6}})
    run(a, "ppr_after_insert", {"op": "personalized_pagerank", "graph": "g",
                                "params": {"source": src[1], "n_iter": 10}})
    s_, d_ = graph.out_edges()
    k = min(2, graph.n_edges)
    svc.workspace.apply_delta("g", delta_cls.deletes(
        ids[_host(s_)[:k]], ids[_host(d_)[:k]]))
    run(a, "bfs_after_delete", {"op": "bfs", "graph": "g",
                                "params": {"source": src[0]}})
    run(b, "cc_after_delete", {"op": "connected_components", "graph": "g"})
    return out, dict(svc.stats)


@pytest.mark.parametrize("entry", CORPUS, ids=[c[0] for c in CORPUS])
def test_scripted_sequence_matches_the_reference_service(entry):
    ref_g = build(RefGraph, entry)
    port_g = build(Graph, entry, device="cpu")
    n = ref_g.n_nodes
    ids = np.asarray(ref_g.node_ids)[:n]
    ref_out, ref_stats = scripted_run(RefService(), ref_g, RefEdgeDelta,
                                      ids, n)
    port_out, port_stats = scripted_run(GraphService(device="cpu"), port_g,
                                        EdgeDelta, ids, n)
    assert [lbl for lbl, _ in port_out] == [lbl for lbl, _ in ref_out]
    for (label, r), (_, p) in zip(ref_out, port_out):
        assert_same_value(r, p, f"{entry[0]}: {label}")
    assert port_stats == ref_stats
    assert port_stats["fused_calls"] >= 1 and port_stats["cache_hits"] >= 1


def test_budgeted_service_answers_as_an_unbounded_one():
    def run(svc):
        svc.workspace.put("g", rmat_graph(scale=8))
        s = svc.session("a")
        out = []
        for rnd in range(2):
            for op, params in (("pagerank", {"n_iter": 10}),
                               ("connected_components", {}),
                               ("k_core", {"k": 3}),
                               ("bfs", {"source": 0}),
                               ("personalized_pagerank", {"source": 2}),
                               ("triangle_count", {})):
                out.append(s.execute({"op": op, "graph": "g",
                                      "params": params}))
        return out

    free = GraphService(device="cpu")
    want = run(free)
    evictable = free.memory_stats()["plan_evictable_bytes"]
    assert evictable > 0
    tight = GraphService(device="cpu",
                         memory=MemoryPolicy(budget_bytes=evictable // 4))
    got = run(tight)
    for w, g in zip(want, got):
        if torch.is_tensor(w):
            assert torch.equal(w, g)
        else:
            assert w == g
    stats = tight.memory_stats()
    assert stats["tracked_bytes"] <= evictable // 4
    assert tight.stats["evicted_bytes"] > 0
    assert tight.stats["evicted_plan_families"] > 0
