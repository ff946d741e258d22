"""The port's observability package (repro_torch/obs): registry semantics,
trace spans, structured logging, SLOs, the flight recorder, profiling and
the engine instrumentation hooks — the reference's ``tests/test_obs.py``
case for case on the port, then the engine instruments' values against the
reference's for one call sequence.

Registry/tracer unit tests run against *fresh* instances so they are immune
to what other tests recorded into the module-level ``obs.REGISTRY`` /
``obs.TRACER``; the engine-integration tests use the globals (that is the
wiring under test) and scope their assertions to deltas or to spans they
can identify unambiguously.
"""

import gc
import json
import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import algorithms as A
from repro_torch.core.graph import Graph
from repro_torch.obs.log import format_event, get_logger
from repro_torch.obs.metrics import (COUNT_BUCKETS, Registry,
                               quantile_from_snapshot)
from repro_torch.obs.trace import NOOP_SPAN, Tracer


def small_graph():
    src = np.array([0, 1, 2, 3, 0, 1], np.int32)
    dst = np.array([1, 2, 3, 0, 2, 3], np.int32)
    return Graph.from_edges(src, dst, device="cpu")


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_basics_and_identity():
    reg = Registry()
    c = reg.counter("c")
    assert reg.counter("c") is c          # create-or-return by name
    c.inc()
    c.inc(5)
    assert c.value == 6
    g = reg.gauge("g")
    g.set(3.5)
    g.add(-1.0)
    assert g.value == 2.5


def test_kind_mismatch_raises():
    reg = Registry()
    reg.counter("x")
    with pytest.raises(TypeError, match="x.*Counter"):
        reg.histogram("x")


def test_histogram_le_bucket_edges():
    """Prometheus ``le`` semantics: a value exactly on an edge counts in
    that edge's bucket; above the last edge goes to +Inf overflow."""
    reg = Registry()
    h = reg.histogram("h", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 2.0, 4.0, 99.0):
        h.observe(v)
    snap = reg.snapshot()["h"]
    assert snap["buckets"] == [1.0, 2.0, 4.0]
    assert snap["counts"] == [2, 2, 1, 1]   # le=1: {0.5,1.0}; le=2: {1.5,2.0}
    assert snap["count"] == 6
    assert snap["sum"] == pytest.approx(108.0)


def test_histogram_quantile_interpolates():
    reg = Registry()
    h = reg.histogram("h", buckets=(10.0, 20.0, 40.0))
    for _ in range(100):
        h.observe(15.0)                   # all mass in the (10, 20] bucket
    p50 = h.quantile(0.5)
    assert 10.0 <= p50 <= 20.0
    assert h.quantile(0.0) is not None
    assert reg.histogram("empty").quantile(0.5) is None
    # remote consumers compute the same quantile from the snapshot
    assert quantile_from_snapshot(reg.snapshot()["h"], 0.5) == \
        pytest.approx(p50)


def test_snapshot_isolation():
    reg = Registry()
    c = reg.counter("c")
    h = reg.histogram("h")
    c.inc(3)
    h.observe(1.0)
    snap = reg.snapshot()
    c.inc(100)
    h.observe(2.0)
    assert snap["c"]["value"] == 3
    assert snap["h"]["count"] == 1


def test_prometheus_exposition():
    reg = Registry()
    reg.counter("service.requests").inc(7)
    h = reg.histogram("sched.engine_ms", buckets=(1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    txt = reg.to_prometheus()
    assert "# TYPE repro_service_requests counter" in txt
    assert "repro_service_requests 7" in txt
    # bucket counts are cumulative and end at +Inf
    assert 'repro_sched_engine_ms_bucket{le="1"} 1' in txt
    assert 'repro_sched_engine_ms_bucket{le="10"} 2' in txt
    assert 'repro_sched_engine_ms_bucket{le="+Inf"} 2' in txt
    assert "repro_sched_engine_ms_count 2" in txt


def test_reset_zeroes_but_keeps_instruments():
    reg = Registry()
    c = reg.counter("c")
    c.inc(9)
    reg.reset()
    assert c.value == 0
    assert reg.counter("c") is c          # module-global refs stay valid
    c.inc()
    assert c.value == 1


def test_disabled_mode_is_allocation_free():
    reg = Registry(enabled=False)
    tr = Tracer(enabled=False)
    c = reg.counter("c")
    h = reg.histogram("h")

    assert tr.span("s") is NOOP_SPAN      # shared no-op singleton

    def burn():
        for _ in range(1000):
            c.inc()
            h.observe(3.0)
            s = tr.span("s")
            s.finish()
            tr.instant("i")

    burn()                                # warm any lazy caches
    gc.collect()
    before = sys.getallocatedblocks()
    burn()
    gc.collect()
    after = sys.getallocatedblocks()
    assert after - before < 50            # net-zero: nothing retained
    assert c.value == 0
    assert len(tr) == 0


def test_disabled_updates_do_not_count():
    reg = Registry(enabled=True)
    c = reg.counter("c")
    c.inc()
    reg.disable()
    c.inc(100)
    reg.enable()
    c.inc()
    assert c.value == 2


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_span_nesting_inherits_trace_and_parent():
    tr = Tracer()
    tid = tr.new_trace_id()
    with tr.span("outer", trace=tid) as outer:
        with tr.span("inner") as inner:
            assert inner.trace == tid
            assert inner.parent_id == outer.span_id
    doc = tr.export_chrome_trace(trace=tid)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert names == {"outer", "inner"}


def test_export_filters_by_trace_and_membership():
    tr = Tracer()
    t1, t2 = tr.new_trace_id(), tr.new_trace_id()
    tr.span("a", trace=t1).finish()
    tr.span("b", trace=t2).finish()
    # a fused batch span belongs to every member's trace via ``traces``
    tr.span("fused", trace=t1, traces=[t1, t2]).finish()
    names1 = {e["name"] for e in
              tr.export_chrome_trace(trace=t1)["traceEvents"]
              if e["ph"] == "X"}
    names2 = {e["name"] for e in
              tr.export_chrome_trace(trace=t2)["traceEvents"]
              if e["ph"] == "X"}
    assert names1 == {"a", "fused"}
    assert names2 == {"b", "fused"}


def test_chrome_trace_schema(tmp_path):
    tr = Tracer()
    with tr.span("work", foo=1):
        tr.instant("marker")
    path = tmp_path / "trace.json"
    doc = tr.export_chrome_trace(str(path))
    # the on-disk file is the same JSON document
    assert json.loads(path.read_text()) == doc
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    x = [e for e in evs if e["ph"] == "X"]
    i = [e for e in evs if e["ph"] == "i"]
    m = [e for e in evs if e["ph"] == "M"]
    assert len(x) == 1 and len(i) == 1 and len(m) == 1
    assert x[0]["name"] == "work" and x[0]["dur"] >= 0
    assert x[0]["args"]["foo"] == 1
    for e in x + i:
        assert isinstance(e["ts"], float) and isinstance(e["tid"], int)
    assert m[0]["name"] == "thread_name"


def test_add_complete_records_retroactively():
    tr = Tracer()
    t0 = time.perf_counter()
    t1 = t0 + 0.005
    tr.add_complete("queued", t0, t1, trace="tx", op="bfs")
    ev = tr.export_chrome_trace(trace="tx")["traceEvents"][0]
    assert ev["name"] == "queued"
    assert ev["dur"] == pytest.approx(5000.0, rel=0.01)   # µs


def test_span_exit_records_error_name():
    tr = Tracer()
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("x")
    ev = tr.export_chrome_trace()["traceEvents"][0]
    assert ev["args"]["error"] == "ValueError"


def test_ring_buffer_bounds_memory():
    tr = Tracer(capacity=8)
    for i in range(100):
        tr.span(f"s{i}").finish()
    assert len(tr) == 8


def test_cross_thread_spans_land_on_distinct_rows():
    tr = Tracer()

    def work():
        tr.span("worker-span").finish()

    t = threading.Thread(target=work)
    t.start()
    t.join()
    tr.span("main-span").finish()
    doc = tr.export_chrome_trace()
    tids = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert len(tids) == 2


# ---------------------------------------------------------------------------
# structured logging
# ---------------------------------------------------------------------------


def test_format_event_sorts_and_quotes():
    assert format_event("ev", {}) == "ev"
    assert format_event("ev", {"b": 2, "a": "x"}) == "ev a='x' b=2"


def test_struct_logger_emits_through_repro_hierarchy():
    records = []

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    lg = get_logger("repro_torch.obs_test")
    root = logging.getLogger("repro_torch")
    h = Capture()
    old = root.level
    root.addHandler(h)
    root.setLevel(logging.INFO)
    try:
        lg.info("incremental_fallback", op="bfs", session="s1")
        lg.debug("hidden")                # below level: not emitted
    finally:
        root.removeHandler(h)
        root.setLevel(old)
    msgs = [r.getMessage() for r in records]
    assert "incremental_fallback op='bfs' session='s1'" in msgs
    assert "hidden" not in msgs


def test_get_logger_prefixes_foreign_names():
    assert get_logger("elsewhere").stdlib.name == "repro_torch.elsewhere"
    assert (get_logger("repro_torch.core.graph").stdlib.name
            == "repro_torch.core.graph")


# ---------------------------------------------------------------------------
# engine integration: frontier rounds, tol iterations
# ---------------------------------------------------------------------------


def test_frontier_fixpoint_emits_round_spans_and_metrics():
    g = small_graph()
    rounds_before = obs.counter("engine.frontier.rounds").value
    hist = obs.histogram("engine.frontier.frontier_size",
                         buckets=COUNT_BUCKETS)
    n_before = hist.count
    tid = obs.new_trace_id()
    with obs.span("test.frontier_probe", trace=tid):
        levels = A.bfs(g, 0, backend="frontier")
    assert np.asarray(levels).tolist() == [0, 1, 1, 2]
    assert obs.counter("engine.frontier.rounds").value > rounds_before
    assert hist.count > n_before
    doc = obs.export_chrome_trace(trace=tid)
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert "engine.frontier_fixpoint" in names
    rounds = [e for e in doc["traceEvents"]
              if e["name"] == "engine.frontier.round"]
    assert rounds, "per-round spans missing from the trace"
    assert all("frontier" in e["args"] for e in rounds)
    # first round explores from the single source
    assert rounds[0]["args"]["frontier"] == 1


def test_pagerank_tol_iterations_observed_cold_vs_warm():
    g = small_graph()
    cold = obs.histogram("engine.fixpoint.tol_iters.pagerank",
                         buckets=COUNT_BUCKETS)
    warm = obs.histogram("engine.fixpoint.tol_iters.pagerank_warm",
                         buckets=COUNT_BUCKETS)
    c0, w0 = cold.count, warm.count
    pr = A.pagerank(g, tol=1e-6)
    assert cold.count == c0 + 1 and warm.count == w0
    A.pagerank(g, tol=1e-6, init=pr)
    assert warm.count == w0 + 1


def test_dump_metrics_formats():
    obs.counter("test.dump_probe").inc()
    snap = obs.dump_metrics()
    assert snap["test.dump_probe"]["type"] == "counter"
    assert "# TYPE" in obs.dump_metrics("prom")
    with pytest.raises(ValueError):
        obs.dump_metrics("xml")


# ---------------------------------------------------------------------------
# quantile edge cases (None instead of fabricated values)
# ---------------------------------------------------------------------------


def test_quantile_none_on_degenerate_mass():
    reg = Registry()
    first = reg.histogram("deg.first", buckets=(10.0, 20.0))
    first.observe(5.0)                 # all mass in the zero-anchored bucket
    assert first.quantile(0.5) is None
    over = reg.histogram("deg.over", buckets=(10.0, 20.0))
    over.observe(99.0)                 # all mass in the +Inf overflow
    assert over.quantile(0.5) is None
    assert over.quantile(0.01) is None


def test_quantile_none_on_single_edge_histogram():
    reg = Registry()
    h = reg.histogram("deg.single", buckets=(10.0,))
    assert h.quantile(0.5) is None     # empty
    h.observe(5.0)                     # below the only edge -> first bucket
    assert h.quantile(0.5) is None
    h2 = reg.histogram("deg.single2", buckets=(10.0,))
    h2.observe(50.0)                   # above the only edge -> overflow
    assert h2.quantile(0.5) is None


def test_quantile_recovers_once_mass_is_bracketed():
    reg = Registry()
    h = reg.histogram("deg.mixed", buckets=(10.0, 20.0, 40.0))
    h.observe(5.0)
    assert h.quantile(0.99) is None
    h.observe(15.0)                    # now a real edge pair brackets data
    p = h.quantile(0.99)
    assert p is not None and 0.0 < p <= 20.0
    # snapshot-side helper agrees with the live instrument
    snap = reg.snapshot()
    assert quantile_from_snapshot(snap["deg.mixed"], 0.99) == p
    assert quantile_from_snapshot(snap["deg.first"], 0.5) is None \
        if "deg.first" in snap else True


# ---------------------------------------------------------------------------
# trace ring drop accounting
# ---------------------------------------------------------------------------


def test_ring_wrap_counts_drops():
    reg = Registry()
    tr = Tracer(capacity=8)
    tr.drop_hook = reg.counter("trace.dropped").inc
    for i in range(100):
        with tr.span(f"s{i}"):
            pass
    assert len(tr) == 8
    assert tr.dropped == 92
    st = tr.stats()
    assert st["capacity"] == 8
    assert st["buffered"] == 8
    assert st["dropped"] == 92
    assert reg.counter("trace.dropped").value == 92
    doc = tr.export_chrome_trace()
    assert doc["metadata"]["dropped_events"] == 92
    assert doc["metadata"]["capacity"] == 8
    tr.clear()
    assert tr.dropped == 0
    assert tr.stats()["dropped"] == 0


def test_global_tracer_drop_hook_is_wired():
    # obs/__init__ must route ring overflow into the trace.dropped counter
    assert obs.TRACER.drop_hook is not None


# ---------------------------------------------------------------------------
# SLO tracker: window math, hysteresis, shedding
# ---------------------------------------------------------------------------

from repro_torch.obs.slo import Objective, SLOTracker  # noqa: E402


def _slo_tracker(clk, **kw):
    defaults = dict(window_s=10.0, n_buckets=5,
                    default=Objective(latency_ms=100.0, error_budget=0.1),
                    clear_ticks=2, clock=lambda: clk[0])
    defaults.update(kw)
    return SLOTracker(Registry(), **defaults)


def test_slo_burn_rate_and_window_rotation():
    clk = [0.0]
    trk = _slo_tracker(clk)
    for _ in range(5):
        trk.observe("bfs", 10.0)       # within the 100ms objective
    for _ in range(5):
        trk.observe("bfs", 500.0)      # blown
    h = trk.health()
    # bad fraction 0.5 over a 0.1 budget -> burn rate 5 -> breaching
    assert h["ops"]["bfs"]["burn_rate"] == pytest.approx(5.0)
    assert h["ops"]["bfs"]["status"] == "breaching"
    assert h["status"] == "breaching"
    assert any("bfs" in r for r in h["reasons"])
    # t=6s (bucket width 2s): old data still inside the 10s window
    clk[0] = 6.0
    trk.observe("bfs", 10.0)
    assert trk.health()["ops"]["bfs"]["n"] == 11
    # t=11s: the t=0 bucket rotated out; only the t=6 observation remains
    clk[0] = 11.0
    h = trk.health()
    assert h["ops"]["bfs"]["n"] == 1
    assert h["ops"]["bfs"]["burn_rate"] == 0.0


def test_slo_burn_across_bucket_boundary():
    clk = [0.0]
    trk = _slo_tracker(clk)
    # spread bad completions across two adjacent buckets: the window
    # aggregates them into one burn rate
    trk.observe("pr", 500.0)
    clk[0] = 2.5                       # next bucket
    trk.observe("pr", 500.0)
    trk.observe("pr", 10.0)
    trk.observe("pr", 10.0)
    h = trk.health()
    assert h["ops"]["pr"]["n"] == 4
    assert h["ops"]["pr"]["bad_fraction"] == pytest.approx(0.5)
    assert h["ops"]["pr"]["burn_rate"] == pytest.approx(5.0)


def test_slo_verdict_hysteresis():
    clk = [0.0]
    trk = _slo_tracker(clk)
    for _ in range(10):
        trk.observe("bfs", 500.0)
    assert trk.health()["ops"]["bfs"]["status"] == "breaching"  # immediate
    clk[0] = 12.0                      # slow burst fully rotated out
    trk.observe("bfs", 10.0)           # healthy traffic in the new window
    h1 = trk.health()
    assert h1["ops"]["bfs"]["burn_rate"] == 0.0       # raw data is clean...
    assert h1["ops"]["bfs"]["status"] == "breaching"  # ...verdict lags
    assert h1["status"] == "breaching"
    h2 = trk.health()                  # clear_ticks=2 -> second clean eval
    assert h2["ops"]["bfs"]["status"] == "ok"
    assert h2["status"] == "ok"


def test_slo_shedding_is_per_op_unless_combined_burn():
    clk = [0.0]
    trk = _slo_tracker(clk)
    trk.set_objective("bfs", latency_ms=1.0, error_budget=0.01)
    assert not trk.should_shed("bfs")
    for _ in range(10):
        trk.observe("bfs", 50.0)       # every bfs blown
    for _ in range(90):
        trk.observe("pagerank", 10.0)  # plenty of healthy traffic elsewhere
    clk[0] += 2.0                      # invalidate the shed cache
    assert trk.should_shed("bfs")
    # combined bad fraction is 0.1 == default budget -> burn 1.0, below
    # breach: the healthy op is NOT shed
    assert not trk.should_shed("pagerank")
    h = trk.health()
    assert h["combined"]["status"] != "breaching"
    assert h["ops"]["bfs"]["status"] == "breaching"


def test_slo_tick_folds_snapshot_deltas():
    reg = Registry()
    trk = SLOTracker(reg, window_s=10.0, n_buckets=5)
    reg.counter("service.requests").inc(5)
    assert trk.tick()["service.requests"] == 5
    reg.counter("service.requests").inc(3)
    assert trk.tick()["service.requests"] == 3       # delta, not absolute
    assert trk.health()["service"]["service.requests"] == 8
    reg.reset()
    # a registry reset between ticks reads as "no traffic", never negative
    assert trk.tick()["service.requests"] == 0


def test_slo_set_objective_partial_override():
    clk = [0.0]
    trk = _slo_tracker(clk)
    obj = trk.set_objective("bfs", latency_ms=50.0)
    assert obj.latency_ms == 50.0
    assert obj.error_budget == 0.1     # inherited from the default
    obj2 = trk.set_objective("bfs", error_budget=0.02)
    assert obj2.latency_ms == 50.0     # previous override kept
    assert obj2.error_budget == 0.02
    assert trk.objective_for("pagerank").latency_ms == 100.0


# ---------------------------------------------------------------------------
# flight recorder: exemplar capture + debug bundle
# ---------------------------------------------------------------------------

from repro_torch.serve.graph_service import DeadlineExpired, GraphService  # noqa: E402
from repro_torch.serve.policy import (AdmissionPolicy, RejectedError,  # noqa: E402
                                SchedulerPolicy)


def _flight_service():
    svc = GraphService(workers=0, device="cpu")
    svc.workspace.put("g", small_graph())
    return svc


def test_flight_exemplar_on_slow_completion():
    obs.reset()
    try:
        obs.SLO.set_objective("pagerank", latency_ms=0.0)  # everything slow
        svc = _flight_service()
        s = svc.session("alice")
        p = s.submit({"op": "pagerank", "graph": "g",
                      "params": {"n_iter": 2}})
        svc.flush()
        p.result()
        exs = obs.FLIGHT.exemplars("pagerank")
        assert exs, "slow completion must capture an exemplar"
        ex = exs[-1]
        assert ex["outcome"] == "ok" and ex["slow"] is True
        assert ex["session"] == "alice"
        assert ex["latency_ms"] is not None and ex["latency_ms"] > 0
        assert ex["slo_latency_ms"] == 0.0
        assert ex["spans"], "span tree frozen at completion time"
        names = {e["name"] for e in ex["spans"]}
        assert "service.submit" in names
        assert "counters_delta" in ex
        svc.close()
    finally:
        obs.reset()


def test_flight_exemplar_on_error_and_expired():
    obs.reset()
    try:
        svc = _flight_service()
        s = svc.session("bob")
        # error path: input resolution fails at submit (bypasses scheduler)
        pe = s.submit({"op": "pagerank", "graph": "no-such-graph",
                       "params": {}})
        with pytest.raises(Exception):
            pe.result()
        exs = obs.FLIGHT.exemplars("pagerank")
        assert any(e["outcome"] == "error" and e["error"] for e in exs)
        # expired path: deadline already blown when the scheduler dequeues
        px = s.submit({"op": "pagerank", "graph": "g",
                       "params": {"n_iter": 2}, "deadline_ms": 0})
        svc.flush()
        with pytest.raises(DeadlineExpired):
            px.result()
        exs = obs.FLIGHT.exemplars("pagerank")
        assert any(e["outcome"] == "expired" for e in exs)
        # fast, healthy requests capture nothing
        before = obs.FLIGHT.stats()["exemplars"]
        pg = s.submit({"op": "pagerank", "graph": "g",
                       "params": {"n_iter": 2}})
        svc.flush()
        pg.result()
        assert obs.FLIGHT.stats()["exemplars"] == before
        svc.close()
    finally:
        obs.reset()


def _fake_done_pending(latency_ms=5.0, error=None):
    return type("P", (), {"done": True, "error": error, "trace": None,
                          "latency_ms": latency_ms, "cached": False,
                          "fused": False})()


def test_flight_store_is_bounded_per_op():
    obs.reset()
    saved = obs.FLIGHT.min_capture_interval_s
    obs.FLIGHT.min_capture_interval_s = 0.0
    try:
        cap = obs.FLIGHT.per_op_capacity
        obs.SLO.set_objective("bfs", latency_ms=0.0)
        for i in range(cap + 5):
            obs.FLIGHT.record_pending(_fake_done_pending(), op="bfs",
                                      session="s")
        assert len(obs.FLIGHT.exemplars("bfs")) == cap
    finally:
        obs.FLIGHT.min_capture_interval_s = saved
        obs.reset()


def test_flight_throttles_slow_captures_not_errors():
    obs.reset()
    try:
        obs.SLO.set_objective("bfs", latency_ms=0.0)
        # a burst of slow-but-successful completions: only the first is
        # frozen inside the min-capture interval, the rest are counted
        for _ in range(5):
            obs.FLIGHT.record_pending(_fake_done_pending(), op="bfs",
                                      session="s")
        assert len(obs.FLIGHT.exemplars("bfs")) == 1
        assert obs.FLIGHT.stats()["throttled"] == 4
        # errors are exempt from the rate limit
        for _ in range(3):
            obs.FLIGHT.record_pending(
                _fake_done_pending(error=ValueError("boom")), op="bfs",
                session="s")
        errs = [e for e in obs.FLIGHT.exemplars("bfs")
                if e["outcome"] == "error"]
        assert len(errs) == 3
        assert obs.FLIGHT.stats()["throttled"] == 4
    finally:
        obs.reset()


def test_debug_bundle_round_trip_survives_ring_wrap(tmp_path):
    obs.reset()
    try:
        obs.SLO.set_objective("bfs", latency_ms=0.0)
        svc = _flight_service()
        s = svc.session("carol")
        p = s.submit({"op": "bfs", "graph": "g", "params": {"source": 0}})
        svc.flush()
        p.result()
        ex = obs.FLIGHT.exemplars("bfs")[-1]
        assert ex["spans"] and ex["trace"]
        # wrap the ring: pad events evict every span of the bfs request
        cap = obs.TRACER._events.maxlen
        t0 = time.perf_counter()
        for _ in range(cap + 1):
            obs.add_complete("pad", t0, t0)
        assert obs.TRACER.dropped > 0
        live = obs.export_chrome_trace(trace=ex["trace"])["traceEvents"]
        assert [e for e in live if e["ph"] == "X"] == []  # ring forgot it
        assert obs.FLIGHT.exemplars("bfs")[-1]["spans"]   # recorder didn't
        # bundle: exact JSON round trip through disk
        path = tmp_path / "bundle.json"
        bundle = obs.debug_bundle(str(path), trace=ex["trace"])
        assert json.loads(path.read_text()) == bundle
        assert bundle["kind"] == "repro-debug-bundle"
        assert bundle["health"]["status"] in ("ok", "degraded", "breaching")
        assert bundle["slo"]["ops"]["bfs"]["n"] >= 1
        assert bundle["tracer"]["dropped"] > 0
        assert bundle["trace"]["metadata"]["dropped_events"] > 0
        assert bundle["exemplars"]["bfs"][-1]["spans"]
        assert bundle["config"]["obs_enabled"] is True
        # and it renders through the dashboard
        from repro_torch.obs.report import render_bundle
        text = render_bundle(bundle)
        assert "bfs" in text
        assert "flight recorder" in text
        assert "spans=" in text
        svc.close()
    finally:
        obs.reset()


def test_slo_shed_tightens_admission():
    obs.reset()
    try:
        pol = SchedulerPolicy(admission=AdmissionPolicy(
            max_inflight=8, max_queue_depth=100,
            slo_shed=True, shed_factor=0.125))
        svc = GraphService(workers=0, policy=pol, device="cpu")
        svc.workspace.put("g", small_graph())
        s = svc.session("greedy")
        # no breach -> full quota: several queued submissions are fine
        for i in range(3):
            s.submit({"op": "pagerank", "graph": "g",
                      "params": {"n_iter": 2 + i}})
        svc.flush()
        # blow the objective so pagerank starts breaching
        obs.SLO.set_objective("pagerank", latency_ms=0.0, error_budget=0.01)
        p = s.submit({"op": "pagerank", "graph": "g",
                      "params": {"n_iter": 9}})
        svc.flush()
        p.result()
        # refresh the verdict (should_shed serves a 1s-cached health view)
        assert obs.SLO.health()["ops"]["pagerank"]["status"] == "breaching"
        # quota shrinks to max(1, 8*0.125) = 1: second in-flight rejects
        s.submit({"op": "pagerank", "graph": "g", "params": {"n_iter": 10}})
        with pytest.raises(RejectedError) as ei:
            s.submit({"op": "pagerank", "graph": "g",
                      "params": {"n_iter": 11}})
        assert "slo shedding" in str(ei.value)
        svc.flush()
        svc.close()
    finally:
        obs.reset()


# ---------------------------------------------------------------------------
# engine profiler
# ---------------------------------------------------------------------------


def test_profile_compile_execute_split_and_report():
    obs.reset()
    g = small_graph()
    A.pagerank(g, n_iter=3)
    A.pagerank(g, n_iter=3)            # same signature: execute only
    snap = obs.dump_metrics()
    prof = {k: v for k, v in snap.items()
            if k.startswith("engine.profile.") and v["type"] == "histogram"}
    assert prof, "profiled fixpoint must emit engine.profile.* histograms"
    total = sum(v["count"] for v in prof.values())
    assert total >= 2
    # the second identical call must not land in a compile_ms bucket again:
    # at most one compile observation per (backend, signature)
    compiles = sum(v["count"] for k, v in prof.items()
                   if k.endswith(".compile_ms"))
    executes = sum(v["count"] for k, v in prof.items()
                   if k.endswith(".execute_ms"))
    assert executes >= 1
    assert compiles <= total - 1
    rep = obs.profile_report()
    assert "engine profile" in rep
    assert "execute_ms" in rep


def test_profile_frontier_round_phases():
    obs.reset()
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, 2048).astype(np.int32)
    dst = rng.integers(0, 256, 2048).astype(np.int32)
    g = Graph.from_edges(src, dst, device="cpu")
    A.bfs(g, 0, backend="frontier")
    snap = obs.dump_metrics()
    rounds = snap.get("engine.frontier.rounds", {}).get("value", 0)
    assert rounds >= 1
    timed = sum(snap[k]["count"] for k in
                ("engine.profile.frontier.dense_ms",
                 "engine.profile.frontier.sparse_ms") if k in snap)
    assert timed == rounds, "every frontier round gets a timed phase"


# ---------------------------------------------------------------------------
# engine instruments: the port's values equal the reference's
# ---------------------------------------------------------------------------

from _torch_oracles import build, corpus  # noqa: E402
from repro import obs as ref_obs  # noqa: E402
from repro.core import algorithms as RA  # noqa: E402
from repro.core.graph import EdgeDelta as RefEdgeDelta  # noqa: E402
from repro.core.graph import Graph as RefGraph  # noqa: E402
from repro_torch.core.graph import EdgeDelta  # noqa: E402

_COUNTERS = ("engine.frontier.rounds", "engine.frontier.dense_rounds",
             "engine.frontier.direction_switches",
             "engine.frontier.relaxed_edges",
             "engine.plan_cache.hits", "engine.plan_cache.misses",
             "engine.plan_cache.patched",
             "engine.exec_cache.hits", "engine.exec_cache.misses")
_HISTS = ("engine.fixpoint.tol_iters", "engine.fixpoint.tol_iters.pagerank",
          "engine.fixpoint.tol_iters.pagerank_warm",
          "engine.frontier.frontier_size")


def _instrument_values(registry_obs, alg, graph, delta_cls, ids):
    """Run one call sequence; the instruments' values it moved."""
    registry_obs.reset()
    alg.pagerank(graph, n_iter=5)
    pr = alg.pagerank(graph, tol=1e-6)
    alg.pagerank(graph, tol=1e-6, init=pr)
    alg.hits(graph, n_iter=3)
    alg.bfs(graph, 0, backend="frontier")
    alg.sssp(graph, 1, backend="frontier")
    alg.bfs(graph, np.asarray([0, 2, 4], np.int32), backend="frontier")
    parent = alg.bfs(graph, 0)
    alg.connected_components(graph, backend="frontier")
    alg.label_propagation(graph, n_iter=4, backend="frontier")
    alg.personalized_pagerank(graph, 3, n_iter=4)
    rng = np.random.default_rng(11)
    pick = lambda k: ids[rng.integers(0, len(ids), k)].astype(np.int32)
    child = graph.apply_delta(delta_cls.inserts(pick(3), pick(3)))
    alg.incremental_bfs(child, 0, parent)
    alg.pagerank(child, tol=1e-6, init=pr)
    snap = registry_obs.dump_metrics()
    out = {k: snap[k]["value"] for k in _COUNTERS if k in snap}
    for k in _HISTS:
        if k in snap:
            out[k] = (snap[k]["count"], snap[k]["sum"], snap[k]["counts"])
    return out


@pytest.mark.parametrize("entry", [c for c in corpus()
                                   if c[0] in ("rmat", "path", "star")],
                         ids=lambda c: c[0])
def test_engine_instruments_equal_the_reference(entry):
    ref_g = build(RefGraph, entry)
    port_g = build(Graph, entry, device="cpu")
    ids = np.asarray(ref_g.node_ids)[:ref_g.n_nodes]
    want = _instrument_values(ref_obs, RA, ref_g, RefEdgeDelta, ids)
    got = _instrument_values(obs, A, port_g, EdgeDelta, ids)
    assert want["engine.frontier.rounds"] > 0
    assert want["engine.plan_cache.hits"] > 0
    assert want["engine.fixpoint.tol_iters.pagerank_warm"][0] == 2
    assert got == want


def test_debug_bundle_reports_the_port_versions():
    v = obs.debug_bundle()["versions"]
    assert set(v) == {"python", "torch", "cuda", "numpy", "device"}
    assert v["torch"] == torch.__version__ and "jax" not in v
