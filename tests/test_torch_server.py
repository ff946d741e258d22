"""The port's cross-process serving (repro_torch/serve/server.py and
client.py) over real sockets.

The reference's ``tests/test_server.py`` case for case on the port, with
server and client on the CPU in one pytest process (loopback TCP, genuine
frames): the remote session mirrors the in-process API (values, errors,
provenance), admission control crosses the wire typed, results stream back
out of order, shutdown drains, concurrent clients share one workspace.
Then the port's own cases: the §4.1 workload through the port's remote
service gives the reference's scores, and one ``spawn_server`` subprocess
on the CPU prints its ready line, answers, drains and exits with rc 0,
also when its ready line reaches the parent in one read with the line
before it.
"""

import threading
import time

import numpy as np
import pytest

from repro_torch.core import algorithms as A
from repro_torch.core import provenance as P
from repro_torch.core.graph import EdgeDelta, Graph
from repro_torch.core.table import INT, STR, Table
from repro_torch.data.rmat import rmat_edges
from repro_torch.serve.client import RemoteService
from repro_torch.serve.graph_service import GraphService, Workspace
from repro_torch.serve.policy import (AdmissionPolicy, DeadlineExpired,
                                      RejectedError, SchedulerPolicy,
                                      ServiceError)
from repro_torch.serve.server import GraphServer


def rmat_graph(scale=7, edge_factor=4, seed=0):
    s, d = rmat_edges(scale, edge_factor=edge_factor, seed=seed)
    return Graph.from_edges(s, d, device="cpu")


@pytest.fixture
def served():
    """(server, client) around an inline (workers=0) service with a graph.

    Inline mode keeps scheduling deterministic — results resolve at flush,
    which the remote client drives exactly like an in-process caller.
    """
    svc = GraphService(workers=0, device="cpu")
    svc.workspace.put("g", rmat_graph())
    server = GraphServer(svc, device="cpu").start()
    client = RemoteService(port=server.port, timeout=120.0, device="cpu")
    yield server, client
    client.close()
    server.shutdown()


@pytest.fixture
def served_workers():
    """(server, client) around a worker-backed (streaming) service."""
    svc = GraphService(workers=2, device="cpu")
    svc.workspace.put("g", rmat_graph())
    server = GraphServer(svc, device="cpu").start()
    client = RemoteService(port=server.port, timeout=120.0, device="cpu")
    yield server, client
    client.close()
    server.shutdown()


# ---------------------------------------------------------------------------
# workspace / session mirroring
# ---------------------------------------------------------------------------


def test_remote_workspace_put_get_version(served):
    server, client = served
    t = Table.from_columns({"x": INT, "s": STR},
                           {"x": [3, 1], "s": ["b", "a"]}, device="cpu")
    v = client.workspace.put("t", t)
    assert client.workspace.version("t") == v
    assert P.peek_version(t) == v          # local root bound to server token
    assert set(client.workspace.names()) == {"g", "t"}
    back = client.workspace.get("t")
    assert back.to_pydict() == t.to_pydict()
    # and the server really holds it (shared workspace, not a client echo)
    assert server.service.workspace.get("t").to_pydict() == t.to_pydict()
    with pytest.raises(KeyError):
        client.workspace.get("nope")


def test_remote_update_refused_with_clear_error(served):
    _, client = served
    with pytest.raises(ServiceError, match="wire"):
        client.workspace.update("g", lambda g: g)


def test_remote_session_isolation_and_publish(served):
    server, client = served
    sess = client.session("alice")
    t = Table.from_columns({"x": INT}, {"x": [1, 2]}, device="cpu")
    sess.put("mine", t)
    assert sess.local_names() == ["mine"]
    # another connection with the SAME session name must not see it
    other = RemoteService(port=server.port, device="cpu")
    try:
        with pytest.raises(KeyError):
            other.session("alice").get("mine")
        sess.publish("mine")
        assert other.session("alice").get("mine").to_pydict() == \
            t.to_pydict()
    finally:
        other.close()


def test_execute_mirrors_in_process_values(served):
    _, client = served
    sess = client.session("s")
    remote = sess.execute({"op": "pagerank", "graph": "g",
                           "params": {"n_iter": 10}, "as": "pr"})
    local_svc = GraphService(device="cpu")
    local_svc.workspace.put("g", rmat_graph())
    local = local_svc.session("s").execute(
        {"op": "pagerank", "graph": "g", "params": {"n_iter": 10}})
    np.testing.assert_allclose(np.asarray(remote), np.asarray(local),
                               rtol=1e-6)
    # the "as" binding lives server-side and reads back identically
    np.testing.assert_array_equal(np.asarray(sess.get("pr")),
                                  np.asarray(remote))


def test_multi_output_op_roundtrip(served):
    _, client = served
    hub, auth = client.session("s").execute(
        {"op": "hits", "graph": "g", "params": {"n_iter": 5}})
    assert hub.shape == auth.shape
    assert [r.op for r in P.records_of(auth)] == ["algorithms.hits"]


def test_cached_and_fused_flags_cross_the_wire(served):
    _, client = served
    sess = client.session("s")
    p1 = sess.submit({"op": "bfs", "graph": "g", "params": {"source": 0}})
    p2 = sess.submit({"op": "bfs", "graph": "g", "params": {"source": 1}})
    client.flush()
    assert p1.result(60) is not None and p2.result(60) is not None
    assert p1.fused and p2.fused
    p3 = sess.submit({"op": "bfs", "graph": "g", "params": {"source": 0}})
    client.flush()
    p3.result(60)
    assert p3.cached
    stats = client.stats
    assert stats["cache_hits"] >= 1 and stats["fused_requests"] >= 2


# ---------------------------------------------------------------------------
# typed errors over the wire
# ---------------------------------------------------------------------------


def test_unknown_op_raises_service_error_at_submit(served):
    _, client = served
    with pytest.raises(ServiceError, match="unknown op"):
        client.session("s").submit({"op": "frobnicate", "graph": "g"})


def test_missing_name_resolves_keyerror_like_in_process(served):
    _, client = served
    p = client.session("s").submit({"op": "pagerank", "graph": "ghost"})
    with pytest.raises(KeyError, match="ghost"):
        p.result(60)


def test_admission_rejection_carries_retry_after(served):
    server, client = served
    server.service.policy.admission.inflight_overrides["c1/greedy"] = 2
    sess = client.session("greedy")
    ok = [sess.submit({"op": "pagerank", "graph": "g",
                       "params": {"n_iter": 2}}) for _ in range(2)]
    with pytest.raises(RejectedError) as ei:
        sess.submit({"op": "pagerank", "graph": "g", "params": {"n_iter": 2}})
    assert ei.value.retry_after > 0
    client.flush()
    for p in ok:
        assert p.result(60) is not None


def test_deadline_expired_crosses_the_wire(served):
    _, client = served
    sess = client.session("s")
    p = sess.submit({"op": "pagerank", "graph": "g",
                     "params": {"n_iter": 2}, "deadline_ms": 0.0})
    time.sleep(0.01)
    client.flush()
    with pytest.raises(DeadlineExpired):
        p.result(60)


# ---------------------------------------------------------------------------
# streaming: completion order, not call order
# ---------------------------------------------------------------------------


def test_results_stream_out_of_order(served):
    _, client = served
    sess = client.session("s")
    # first submit stays queued (inline server, nothing drains it yet)...
    slow = sess.submit({"op": "pagerank", "graph": "g",
                        "params": {"n_iter": 5}})
    # ...second resolves at submit time (name error) -> its RESULT frame
    # arrives while the earlier request is still pending
    fast = sess.submit({"op": "pagerank", "graph": "missing"})
    deadline = time.monotonic() + 30
    while not fast.done and time.monotonic() < deadline:
        time.sleep(0.005)
    assert fast.done and not slow.done
    client.flush()
    assert slow.result(60) is not None
    with pytest.raises(KeyError):
        fast.result(60)


def test_worker_server_streams_without_flush(served_workers):
    _, client = served_workers
    sess = client.session("s")
    ps = [sess.submit({"op": "bfs", "graph": "g", "params": {"source": i}})
          for i in range(4)]
    for p in ps:                    # no flush: worker threads resolve
        assert p.result(120) is not None


# ---------------------------------------------------------------------------
# provenance equivalence + export round trip (acceptance criterion)
# ---------------------------------------------------------------------------


def expert_workload(service):
    """Compact §4.1-style chain: select -> to_graph -> pagerank -> table."""
    posts = Table.from_columns(
        {"src": INT, "dst": INT, "Tag": STR},
        {"src": [0, 1, 2, 3, 0, 4], "dst": [1, 2, 0, 0, 2, 1],
         "Tag": ["java", "java", "java", "python", "java", "java"]}, device="cpu")
    service.workspace.put("posts", posts)
    sess = service.session("analyst")
    sess.execute({"op": "select", "table": "posts",
                  "params": {"col": "Tag", "op": "==", "value": "java"},
                  "as": "jp"})
    sess.execute({"op": "to_graph", "table": "jp",
                  "params": {"src_col": "src", "dst_col": "dst"}, "as": "qg"})
    sess.execute({"op": "pagerank", "graph": "qg",
                  "params": {"n_iter": 15}, "as": "pr"})
    return sess.execute({"op": "table_from_map", "graph": "qg",
                         "scores": "pr",
                         "params": {"key_name": "User",
                                    "value_name": "Scr"}})


def test_remote_equals_in_process_values_and_provenance(served):
    _, client = served
    remote = expert_workload(client)
    local = expert_workload(GraphService(device="cpu"))
    np.testing.assert_array_equal(remote.column_np("User"),
                                  local.column_np("User"))
    np.testing.assert_allclose(remote.column_np("Scr"),
                               local.column_np("Scr"), rtol=1e-6)
    assert [r.op for r in P.records_of(remote)] == \
        [r.op for r in P.records_of(local)]


def test_export_script_of_remote_result_reexecutes(served, tmp_path):
    _, client = served
    remote = expert_workload(client)
    script = P.export_script(remote)
    path = tmp_path / "remote_export.py"
    path.write_text(script)
    ns = {}
    exec(compile(script, str(path), "exec"), ns)
    rebuilt = ns["rebuild"]()
    np.testing.assert_allclose(rebuilt.column_np("Scr"),
                               remote.column_np("Scr"), rtol=1e-6)


def test_put_back_remote_result_keeps_chain(served):
    """hits -> put the authority vector back -> table_from_map provenance."""
    _, client = served
    sess = client.session("s")
    sess.execute({"op": "hits", "graph": "g", "params": {"n_iter": 5},
                  "as": "h"})
    _, auth = sess.get("h")
    sess.put("auth", auth)
    out = sess.execute({"op": "table_from_map", "graph": "g",
                        "scores": "auth",
                        "params": {"key_name": "User",
                                   "value_name": "A"}})
    ops = [r.op for r in P.records_of(out)]
    assert "algorithms.hits" in ops and ops[-1] == "convert.table_from_map"


# ---------------------------------------------------------------------------
# concurrent independent clients
# ---------------------------------------------------------------------------


def test_two_clients_share_workspace_and_fair_share_sees_two_sessions(
        served_workers):
    server, client1 = served_workers
    client2 = RemoteService(port=server.port, device="cpu")
    try:
        results = {}

        def work(tag, cli):
            sess = cli.session("w")
            vals = [sess.execute({"op": "bfs", "graph": "g",
                                  "params": {"source": s}})
                    for s in ((0, 2, 4) if tag == "a" else (1, 3, 5))]
            results[tag] = vals

        t1 = threading.Thread(target=work, args=("a", client1))
        t2 = threading.Thread(target=work, args=("b", client2))
        t1.start(); t2.start(); t1.join(60); t2.join(60)
        assert len(results["a"]) == 3 and len(results["b"]) == 3
        # result() resolves before the scheduler's completion accounting
        # runs (_run_group resolves, _done charges afterwards) — wait for
        # idle so the counters are settled before reading them
        assert server.service.scheduler.wait_idle(timeout=10.0)
        # distinct principals server-side: same client session name, two
        # connection-scoped scheduler sessions
        s1 = client1.session_stats("w")
        s2 = client2.session_stats("w")
        assert s1["completed"] == 3 and s2["completed"] == 3
    finally:
        client2.close()


def test_two_client_publish_race_stays_consistent(served):
    """Concurrent puts/publishes from two connections: every write lands,
    the name->version map never goes stale (regression for the workspace
    read-modify-write race)."""
    server, client1 = served
    client2 = RemoteService(port=server.port, device="cpu")
    try:
        def hammer(cli, base):
            sess = cli.session("w")
            for i in range(8):
                name = f"t{base + i}"
                sess.put(name, Table.from_columns({"x": INT},
                                                  {"x": [base + i]}, device="cpu"))
                sess.publish(name)

        t1 = threading.Thread(target=hammer, args=(client1, 100))
        t2 = threading.Thread(target=hammer, args=(client2, 200))
        t1.start(); t2.start(); t1.join(60); t2.join(60)
        names = server.service.workspace.names()
        assert {f"t{100 + i}" for i in range(8)} <= set(names)
        assert {f"t{200 + i}" for i in range(8)} <= set(names)
        for i in range(8):
            ws = server.service.workspace
            assert ws.version(f"t{100 + i}") == \
                P.version_of(ws.get(f"t{100 + i}"))
    finally:
        client2.close()


# ---------------------------------------------------------------------------
# incremental maintenance over the wire
# ---------------------------------------------------------------------------


def test_apply_delta_over_wire_retention_and_counters(served):
    """ws_apply_delta patches the server-side graph in place of a rebuild;
    a provably-unaffected cached query survives the version bump, an
    affected one warm-starts, and session_stats reports the cache counters
    over the wire."""
    server, client = served
    client.workspace.put("pg", Graph.from_edges([0, 1, 2], [1, 2, 3], device="cpu"))
    sess = client.session("w")
    req = {"op": "bfs", "graph": "pg", "params": {"source": 0}}
    r1 = sess.execute(req)

    v = client.workspace.apply_delta("pg", EdgeDelta.inserts([2], [1]))
    assert client.workspace.version("pg") == v     # bump visible client-side
    assert server.service.workspace.get("pg")._delta is not None  # patched
    r2 = sess.execute(dict(req))                   # back edge: retained
    np.testing.assert_array_equal(np.asarray(r2), np.asarray(r1))
    st = client.session_stats("w")
    assert st["retained"] >= 1
    assert st["cache_hits"] >= 1 and st["cache_misses"] >= 1

    client.workspace.apply_delta("pg", EdgeDelta.inserts([0], [3]))
    r3 = sess.execute(dict(req))                   # shortcut: warm recompute
    assert np.asarray(r3)[3] == 1
    assert server.service.stats["warm_starts"] >= 1
    local = Graph.from_edges([0, 1, 2, 2, 0], [1, 2, 3, 1, 3], device="cpu")
    np.testing.assert_array_equal(np.asarray(r3), np.asarray(A.bfs(local, 0)))


def test_apply_delta_refreshes_client_mirror(served):
    """put() keeps a local mirror; apply_delta tracks it through deltas so
    export_script root embedding stays valid after remote updates."""
    _, client = served
    g = Graph.from_edges([0, 1], [1, 2], device="cpu")
    client.workspace.put("mg", g)
    v = client.workspace.apply_delta("mg", EdgeDelta.inserts([2], [0]))
    mirror = client.workspace._mirror["mg"]
    assert mirror is not g and mirror.n_edges == 3
    assert P.peek_version(mirror) == v == client.workspace.version("mg")



def test_disconnect_cleans_up_sessions(served):
    server, _ = served
    extra = RemoteService(port=server.port, device="cpu")
    sess = extra.session("temp")
    sess.execute({"op": "pagerank", "graph": "g", "params": {"n_iter": 2}})
    key = f"{extra.conn_id}/temp"
    assert key in server.service._sessions
    extra.close()
    deadline = time.monotonic() + 10
    while key in server.service._sessions and time.monotonic() < deadline:
        time.sleep(0.02)
    assert key not in server.service._sessions


# ---------------------------------------------------------------------------
# shutdown drains
# ---------------------------------------------------------------------------


def test_graceful_shutdown_drains_pending_work():
    svc = GraphService(workers=0, device="cpu")          # nothing drains until shutdown
    svc.workspace.put("g", rmat_graph())
    server = GraphServer(svc, device="cpu").start()
    client = RemoteService(port=server.port, device="cpu")
    ps = [client.session("s").submit({"op": "bfs", "graph": "g",
                                      "params": {"source": s}})
          for s in range(3)]
    assert not any(p.done for p in ps)
    server.shutdown()                      # drain flushes queued requests
    for p in ps:
        assert p.result(60) is not None   # RESULT frames flushed pre-close
    client.close()


def test_protocol_version_mismatch_rejected(served):
    import socket as socketlib

    from repro_torch.serve import wire
    server, _ = served
    raw = socketlib.create_connection(("127.0.0.1", server.port))
    try:
        wire.send_frame(raw, wire.FrameType.REQUEST, 1,
                        {"kind": "hello", "protocol": 999})
        frame = wire.read_frame(raw)
        assert frame is not None
        ftype, _, payload = frame
        assert ftype == wire.FrameType.ERROR
        assert "protocol" in payload["message"]
    finally:
        raw.close()


# ---------------------------------------------------------------------------
# observability: trace propagation + metrics over the wire
# ---------------------------------------------------------------------------


def _span_names(client, trace):
    doc = client.chrome_trace(trace=trace)
    return {e["name"] for e in doc["traceEvents"] if e["ph"] in ("X", "i")}


def test_trace_id_reaches_provenance_and_chrome_trace(served):
    _, client = served
    sess = client.session("s")
    p = sess.submit({"op": "bfs", "graph": "g", "params": {"source": 3}})
    v = p.result(60)
    assert p.trace                        # minted client-side at submit
    # ...lands on the server-side result's provenance metadata...
    assert ("trace", p.trace) in P.records_of(v)[-1].meta
    # ...and filters the server's Chrome trace down to this request
    names = _span_names(client, p.trace)
    assert {"rpc.submit", "service.submit", "sched.execute",
            "engine.bfs"} <= names
    doc = client.chrome_trace(trace=p.trace)
    for e in doc["traceEvents"]:
        if e["ph"] in ("X", "i"):
            args = e["args"]
            assert args.get("trace") == p.trace \
                or p.trace in args.get("traces", [])


def test_fused_requests_share_engine_span_across_traces(served):
    _, client = served
    sess = client.session("s")
    p1 = sess.submit({"op": "sssp", "graph": "g", "params": {"source": 0}})
    p2 = sess.submit({"op": "sssp", "graph": "g", "params": {"source": 1}})
    client.flush()
    p1.result(60), p2.result(60)
    assert p1.fused and p2.fused and p1.trace != p2.trace
    for p in (p1, p2):
        doc = client.chrome_trace(trace=p.trace)
        exe = [e for e in doc["traceEvents"] if e["name"] == "sched.execute"]
        assert exe and exe[0]["args"]["batch"] == 2
        assert {p1.trace, p2.trace} <= set(exe[0]["args"]["traces"])


def test_cached_request_traced_as_cache_hit(served):
    _, client = served
    sess = client.session("s")
    p1 = sess.submit({"op": "pagerank", "graph": "g",
                      "params": {"n_iter": 3}})
    client.flush()
    p1.result(60)
    p2 = sess.submit({"op": "pagerank", "graph": "g",
                      "params": {"n_iter": 3}})
    p2.result(60)
    assert p2.cached
    names = _span_names(client, p2.trace)
    assert "service.cache_hit_submit" in names
    assert "engine.pagerank" not in names     # never reached the engine


def test_rejected_request_traced_with_reason(served):
    server, client = served
    server.service.policy.admission.inflight_overrides["c1/greedy"] = 1
    sess = client.session("greedy")
    ok = sess.submit({"op": "pagerank", "graph": "g",
                      "params": {"n_iter": 2}})
    tid = "t-test-rejected"
    with pytest.raises(RejectedError):
        sess.submit({"op": "pagerank", "graph": "g",
                     "params": {"n_iter": 2}, "trace": tid})
    doc = client.chrome_trace(trace=tid)
    rej = [e for e in doc["traceEvents"] if e["name"] == "sched.reject"]
    assert rej and rej[0]["args"]["reason"] == "quota"
    assert rej[0]["args"]["retry_after"] > 0
    client.flush()
    ok.result(60)


def test_deadline_expired_request_traced(served):
    _, client = served
    sess = client.session("s")
    p = sess.submit({"op": "pagerank", "graph": "g",
                     "params": {"n_iter": 2}, "deadline_ms": 0.0,
                     "trace": "t-test-expired"})
    time.sleep(0.01)
    client.flush()
    with pytest.raises(DeadlineExpired):
        p.result(60)
    names = _span_names(client, "t-test-expired")
    assert "sched.expired" in names
    assert "engine.pagerank" not in names


def test_metrics_snapshot_over_the_wire(served):
    _, client = served
    sess = client.session("s")
    sess.execute({"op": "bfs", "graph": "g", "params": {"source": 0}})
    snap = client.metrics()
    assert snap["service.requests"]["type"] == "counter"
    assert snap["service.requests"]["value"] >= 1
    assert snap["sched.engine_ms"]["type"] == "histogram"
    assert snap["sched.engine_ms"]["count"] >= 1
    txt = client.metrics_text()
    assert "# TYPE repro_service_requests counter" in txt


def test_chrome_trace_writes_local_file(served, tmp_path):
    import json as _json
    _, client = served
    sess = client.session("s")
    p = sess.submit({"op": "bfs", "graph": "g", "params": {"source": 0}})
    p.result(60)
    path = tmp_path / "remote_trace.json"
    doc = client.chrome_trace(trace=p.trace, path=str(path))
    assert _json.loads(path.read_text()) == doc
    assert doc["traceEvents"]


def test_health_slo_and_bundle_over_the_wire(served, tmp_path):
    """The acceptance path: a forced-slow request leaves a flight-recorder
    exemplar that is still retrievable over the wire after the trace ring
    has wrapped, and the saved bundle renders through the report CLI."""
    import json as _json

    from repro_torch import obs
    from repro_torch.obs import report as report_mod

    server, client = served
    obs.reset()
    try:
        obs.SLO.set_objective("bfs", latency_ms=0.0)   # force "slow"
        sess = client.session("postmortem")
        p = sess.submit({"op": "bfs", "graph": "g", "params": {"source": 0}})
        client.flush()
        p.result(60)
        # wrap the server-side ring: the request's spans get evicted
        cap = obs.TRACER._events.maxlen
        t0 = time.perf_counter()
        for _ in range(cap + 1):
            obs.add_complete("pad", t0, t0)
        assert obs.TRACER.dropped > 0
        ring = client.chrome_trace(trace=p.trace)["traceEvents"]
        assert [e for e in ring if e["ph"] == "X"] == []

        health = client.health()
        assert health["status"] in ("ok", "degraded", "breaching")
        assert health["ops"]["bfs"]["slow"] >= 1
        assert isinstance(health["reasons"], list)

        report = client.slo_report()
        assert report["ops"]["bfs"]["n"] >= 1
        assert report["ops"]["bfs"]["objective"]["latency_ms"] == 0.0

        path = tmp_path / "bundle.json"
        bundle = client.debug_bundle(str(path), trace=p.trace)
        exs = bundle["exemplars"]["bfs"]
        assert exs[-1]["slow"] is True
        assert exs[-1]["trace"] == p.trace
        assert exs[-1]["spans"], "exemplar evidence must survive ring wrap"
        assert bundle["trace"]["metadata"]["dropped_events"] > 0
        assert _json.loads(path.read_text()) == bundle

        # the saved artifact renders through `python -m repro.obs.report`
        assert report_mod.main(["--bundle", str(path)]) == 0
        assert client.profile_report().startswith("engine profile")
    finally:
        obs.reset()


# ---------------------------------------------------------------------------
# the port's own cases: the reference's §4.1 scores, a spawned server
# ---------------------------------------------------------------------------

import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

from repro_torch.examples.stackoverflow_experts import run_workload  # noqa: E402
from repro_torch.serve.server import spawn_server  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_stackoverflow_experts", ROOT / "examples" /
        "stackoverflow_experts.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_workload_over_the_wire_gives_the_reference_scores(served, tmp_path):
    from repro.core import provenance as RP
    from repro.serve.graph_service import GraphService as RefService
    _, client = served
    port_s = run_workload(client, n_questions=600,
                          export_path=str(tmp_path / "port.py"))
    ref_s = _reference_example().run_workload(
        RefService(), n_questions=600, export_path=str(tmp_path / "ref.py"))
    np.testing.assert_array_equal(port_s.column_np("User"),
                                  ref_s.column_np("User"))
    np.testing.assert_allclose(port_s.column_np("Scr"),
                               ref_s.column_np("Scr"), rtol=0, atol=1e-5)
    # the chain was adopted across the wire: same ops as the reference's
    assert ([r.op for r in P.records_of(port_s)]
            == [r.op for r in RP.records_of(ref_s)])


def test_spawned_server_on_the_cpu_answers_drains_and_exits():
    proc, port = spawn_server(("--device", "cpu", "--rmat-scale", "8"),
                              timeout=120.0)
    try:
        client = RemoteService(port=port, device="cpu")
        assert client.server_pid == proc.pid
        levels = client.session("s").execute(
            {"op": "bfs", "graph": "g", "params": {"source": 0}})
        g = client.workspace.get("g")
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(levels, A.bfs(g, 0).numpy())
        client.shutdown_server()
        client.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_spawn_server_finds_a_ready_line_read_with_the_line_before(
        monkeypatch):
    """A parent slow to read (a loaded machine) finds the child's
    "published" line and its ready line in the pipe together, and one read
    takes both into the text buffer.  ``spawn_server`` must still return
    the port: waiting on the pipe with ``select`` saw no more data and
    timed out."""
    import fcntl
    import struct
    import subprocess
    import termios

    from repro_torch.serve import server as server_mod

    g = rmat_graph(scale=8, edge_factor=8)
    both = (len(f"published 'g': {g.n_nodes} nodes {g.n_edges} edges\n")
            + len(server_mod._READY) + len(" 1024\n"))
    real_popen = subprocess.Popen

    def popen_then_wait_for_both_lines(*args, **kwargs):
        proc = real_popen(*args, **kwargs)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and proc.poll() is None:
            queued = struct.unpack("i", fcntl.ioctl(
                proc.stdout.fileno(), termios.FIONREAD, b"\0" * 4))[0]
            if queued >= both:
                break
            time.sleep(0.05)
        return proc

    monkeypatch.setattr(server_mod.subprocess, "Popen",
                        popen_then_wait_for_both_lines)
    proc, port = server_mod.spawn_server(
        ("--device", "cpu", "--rmat-scale", "8"), timeout=30.0)
    try:
        client = RemoteService(port=port, device="cpu")
        assert client.server_pid == proc.pid
        client.shutdown_server()
        client.close()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
