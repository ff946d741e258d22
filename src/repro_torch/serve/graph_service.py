"""Interactive graph-analytics service (Ringo §2.1/§4) over the engine.

The port's counterpart of the reference's ``serve/graph_service.py``: the
same workspace, sessions, fusion scheduler, result cache and delta-aware
maintenance, over PyTorch tensors on one device (``device=``, default the
card).  Engine time is measured after a sync of that device, worker
threads run each engine call with it as their current CUDA device, and
cached results are device tensors whose bytes the memory budget counts.

Ringo's defining claim is not just fast algorithms but an *interactive
system*: many analysts iterate trial-and-error over named tables and graphs
held in one big shared memory, and the front end keeps the whole thing
responsive.  This module is that front end for the repro stack, the layer the
ROADMAP's "serve heavy multi-user traffic" north star grows from:

    Workspace        named, versioned tables/graphs shared across sessions.
                     Objects are immutable; ``update`` applies a functional
                     update and publishes the fresh object (fresh version
                     token), so the identity-memoized ``Graph.plan()`` cache
                     and the service result cache invalidate by construction.
    Session          one analyst's namespace, layered over the workspace.
                     Local writes (results bound via ``"as"``) never leak to
                     other sessions until explicitly ``publish``-ed.
    GraphService     executes declarative requests such as
                     ``{"op": "pagerank", "graph": "qa", "params": {...}}``
                     from many concurrent sessions, with two throughput
                     multipliers:

    * a **fusion scheduler**: concurrent single-source ``bfs`` / ``sssp`` /
      ``personalized_pagerank`` requests against the same graph version with
      the same parameters coalesce into ONE multi-source engine call (the
      batched fixpoint the algorithms already expose; the dense backends
      run its rows one after another, "frontier" together), and the rows
      scatter back to the individual requests — each with the provenance of
      the equivalent single-source call, so export/replay are oblivious to
      fusion;
    * a **result cache** keyed by ``(object version, op, canonicalized
      params)``: repeated trial-and-error queries are free until the object
      changes.  Version tokens come from :mod:`repro_torch.core.provenance`;
      because updates are functional, a stale hit is impossible;
    * **delta-aware incremental maintenance**: after
      :meth:`Workspace.apply_delta` publishes a graph's insert-only child,
      cache entries the delta provably cannot change are re-bound to the
      new version (retention — the query never re-executes), and queries
      that must re-execute warm-start from the parent version's cached
      result (frontier re-seeding for traversals/labels, warm power
      iteration for pagerank) instead of running cold.

Requests are submitted with :meth:`GraphService.submit` (returns a
:class:`Pending`) and flow through the load-aware scheduler
(:mod:`repro_torch.serve.scheduler`): per-session admission control (bounded
in-flight quota and queue-depth backpressure raise
:class:`~repro_torch.serve.policy.RejectedError` with a retry-after hint; requests
carrying a ``"deadline_ms"`` are dropped unexecuted once stale), deficit-
round-robin fair share charged in measured engine milliseconds, and load-
tiered batching windows that generalize the fusion scheduler.  With
``workers=0`` (the default) execution happens inline at
:meth:`GraphService.flush` — the synchronous drain that gives concurrent
requests the chance to fuse; with ``workers>0`` background worker threads
run the same loop continuously and :meth:`Pending.result` simply waits.
:meth:`GraphService.execute` is the submit+flush+result convenience for
sequential use.  All entry points are thread-safe.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import algorithms as A
from ..core import convert as C
from ..core import engine
from ..core import provenance as prov
from ..core import relational as R
from ..core.graph import EdgeDelta, Graph
from ..core.plan import EVICTABLE_FAMILIES
from ..core.table import Table
from ..device import DeviceLike, resolve
from ..launch.mesh import ShardGroup, graph_group
from .policy import (DeadlineExpired, MemoryPolicy, RejectedError,
                     SchedulerPolicy, ServiceError)
from .scheduler import QueuedRequest, Scheduler

__all__ = ["Workspace", "Session", "GraphService", "Pending", "EdgeDelta",
           "ServiceError", "RejectedError", "DeadlineExpired",
           "SchedulerPolicy", "MemoryPolicy", "serve_follower"]

_log = obs.get_logger(__name__)

# memory telemetry: what the serving process is holding, and for whom.
# Gauges are set by the memory manager on every accounting pass; they flow
# to remote clients through the existing ``metrics`` RPC unchanged.
_G_PLAN_BYTES = obs.gauge("mem.plan_bytes")
_G_PLAN_EVICTABLE = obs.gauge("mem.plan_evictable_bytes")
_G_CACHE_BYTES = obs.gauge("mem.result_cache_bytes")
_G_TRACKED = obs.gauge("mem.tracked_bytes")
_G_BUDGET = obs.gauge("mem.budget_bytes")
_G_PINS = obs.gauge("mem.provenance_pins")
_H_ENTRY_BYTES = obs.histogram("mem.entry_bytes", buckets=obs.BYTE_BUCKETS)


# ---------------------------------------------------------------------------
# request vocabulary: op name -> (callable, {request_key: param_name})
# ---------------------------------------------------------------------------

_OPS: Dict[str, Tuple[Callable, Dict[str, str]]] = {
    # relational (named inputs: "table" or "left"/"right")
    "select": (R.select, {"table": "t"}),
    "select_inplace": (R.select_inplace, {"table": "t"}),
    "project": (R.project, {"table": "t"}),
    "order": (R.order, {"table": "t"}),
    "group_by": (R.group_by, {"table": "t"}),
    "unique": (R.unique, {"table": "t"}),
    "join": (R.join, {"left": "lt", "right": "rt"}),
    "union": (R.union, {"left": "lt", "right": "rt"}),
    "intersect": (R.intersect, {"left": "lt", "right": "rt"}),
    "difference": (R.difference, {"left": "lt", "right": "rt"}),
    "sim_join": (R.sim_join, {"left": "lt", "right": "rt"}),
    "next_k": (R.next_k, {"table": "t"}),
    # conversions
    "to_graph": (C.to_graph, {"table": "t"}),
    "graph_to_edge_table": (C.graph_to_edge_table, {"graph": "g"}),
    "graph_to_node_table": (C.graph_to_node_table, {"graph": "g"}),
    "table_from_map": (C.table_from_map, {"graph": "g", "scores": "scores"}),
    # algorithms
    "pagerank": (A.pagerank, {"graph": "g"}),
    "personalized_pagerank": (A.personalized_pagerank, {"graph": "g"}),
    "sssp": (A.sssp, {"graph": "g"}),
    "bfs": (A.bfs, {"graph": "g"}),
    "hits": (A.hits, {"graph": "g"}),
    "connected_components": (A.connected_components, {"graph": "g"}),
    "strongly_connected_components": (A.strongly_connected_components,
                                      {"graph": "g"}),
    "k_core": (A.k_core, {"graph": "g"}),
    "core_numbers": (A.core_numbers, {"graph": "g"}),
    "label_propagation": (A.label_propagation, {"graph": "g"}),
    "eigenvector_centrality": (A.eigenvector_centrality, {"graph": "g"}),
    "closeness_centrality": (A.closeness_centrality, {"graph": "g"}),
    "triangle_count": (A.triangle_count, {"graph": "g"}),
    "per_node_triangles": (A.per_node_triangles, {"graph": "g"}),
    "clustering_coefficient": (A.clustering_coefficient, {"graph": "g"}),
}

# ops whose callable accepts ``backend=`` (engine backend dispatch): a
# service-level ``engine_backend`` is injected into their params before
# canonicalization, so cache/fuse keys distinguish backends and every
# algorithm inherits the chosen engine unmodified
_BACKEND_OPS = {
    "pagerank", "personalized_pagerank", "sssp", "bfs", "hits",
    "connected_components", "strongly_connected_components", "k_core",
    "core_numbers", "label_propagation", "eigenvector_centrality",
    "closeness_centrality", "triangle_count",
}

# single-source traversals the scheduler may coalesce into one batched call;
# value = the parameter holding the source vertex
_FUSABLE: Dict[str, str] = {
    "bfs": "source",
    "sssp": "source",
    "personalized_pagerank": "source",
}
_PROV_OP = {"bfs": "algorithms.bfs", "sssp": "algorithms.sssp",
            "personalized_pagerank": "algorithms.personalized_pagerank"}
# cross-n_iter fusion: requests differing only in n_iter coalesce; the batch
# runs to the max cap and each row freezes at its own (the capped fixpoint
# bodies in core/algorithms.py).  Value = the cap standing in for an absent
# n_iter: ppr's iterative default; None for the traversals, resolved per
# graph to |V| (that many relaxation rounds always converge BFS/SSSP).
_FUSE_DEPTH_DEFAULT: Dict[str, Optional[int]] = {
    "bfs": None, "sssp": None, "personalized_pagerank": 10,
}

# --- incremental maintenance (delta-aware serving) -------------------------
# Ops whose cached result can provably survive an insert-only delta
# (see _retention_safe), and ops the service can warm-start from the
# parent version's cached result after a delta.
_RETAINABLE = {"bfs", "sssp", "connected_components", "label_propagation"}
_WARM_OPS = {"pagerank", "personalized_pagerank", "bfs", "sssp",
             "connected_components", "label_propagation"}
# provenance op names for results whose chain the service rewrites (fusion
# scatter rows, warm-started recomputations): the recorded call is always
# the equivalent standalone cold call
_PROV_ANY = dict(_PROV_OP,
                 pagerank="algorithms.pagerank",
                 connected_components="algorithms.connected_components",
                 label_propagation="algorithms.label_propagation")


def _retention_safe(op: str, g: Graph, info: Any, parent_val: Any,
                    params: Dict[str, Any]) -> bool:
    """True when ``parent_val`` provably equals the child-version result.

    ``info`` is the child's ``Graph._delta`` (insert-only, same node
    numbering as the parent by construction of the fast apply path), so the
    parent's cached array indexes the child's vertices directly.  Per-op
    predicates over the inserted dense edges ``(u, v)``:

    * ``bfs`` / unweighted ``sssp`` — ``D[u] + 1 >= D[v]`` (unreachable as
      +inf): the new edge cannot shorten any path.  Sound even for a capped
      ``n_iter``: round-``t`` values are exact <=t-hop distances, and an
      edge satisfying the predicate creates no shorter path of any length.
      Weighted ``sssp`` never retains (the cached weights keying cannot be
      re-verified against the patched edge order).
    * ``connected_components`` — ``label[u] == label[v]``: an
      intra-component edge changes no component.  Sound because cc always
      runs to fixpoint (no round cap in its API).
    * ``label_propagation`` — same equality test, but only when
      ``n_iter >= |V|`` (a capped run is not a fixpoint: equal labels at
      radius ``t`` do not pin the labels interior vertices see through the
      new shortcut).

    Everything else (pagerank, hits, triangles, ...) is never retained —
    any new edge perturbs the value.

    ``info``'s edge lists and ``parent_val`` are tensors on the graph's
    device; the test runs there and the host reads its one verdict.
    """
    if info.add_src.numel() == 0:
        return True
    u, v = info.add_src.long(), info.add_dst.long()
    val = torch.as_tensor(parent_val, device=info.add_src.device)
    if op in ("bfs", "sssp"):
        if op == "sssp" and params.get("weights") is not None:
            return False
        D = val.to(torch.float64)
        if op == "bfs":
            D = torch.where(D < 0, float("inf"), D)
        return bool(torch.all(D[..., u] + 1.0 >= D[..., v]))
    if op == "label_propagation":
        n_iter = params.get("n_iter", 20)
        if not isinstance(n_iter, (int, np.integer)) or n_iter < g.n_nodes:
            return False
    return bool(torch.all(val[u] == val[v]))


def _sssp_weights_block_fusion(canon: Tuple[Tuple[str, Any], ...]) -> bool:
    """True when an ``sssp`` request's weights bar it from coalescing.

    Any negative weight voids the |V|-round convergence bound the fused
    mixed-depth batch uses for its unbounded members (ROADMAP open item),
    so such requests never coalesce — each runs standalone.  The check
    reads the already-canonicalized literal (at most 256 embedded values,
    no device transfer); an :class:`~repro_torch.core.provenance.Opaque` weights
    array could never share a fusion key anyway (identity-hashed), so it is
    unfusable too rather than worth an O(|E|) scan.
    """
    for k, v in canon:
        if k != "weights":
            continue
        if v is None:
            return False
        if isinstance(v, tuple) and len(v) == 4 and v[0] == "array":
            return any(x < 0 for x in v[3])
        return True          # opaque / non-array literal: stay unfused
    return False


_MISS = object()        # _cache_get sentinel: None is a valid cached value


def _to_device(params: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    """``params`` with its numpy arrays (as the wire delivers them) as
    tensors on ``dev``.

    Runs after the cache and fusion keys were taken from the host arrays;
    the copy also frees the call from the wire's read-only buffers.
    """
    if not any(isinstance(v, np.ndarray) for v in params.values()):
        return params
    return {k: torch.from_numpy(np.array(v)).to(dev)
            if isinstance(v, np.ndarray) else v for k, v in params.items()}


# ---------------------------------------------------------------------------
# d ranks: rank 0 serves, ranks >= 1 follow its engine calls
# ---------------------------------------------------------------------------

# engine callables a follower may be asked to run, by name
_FOLLOW_FNS: Dict[str, Callable] = dict(
    {op: fn for op, (fn, _) in _OPS.items() if op in _BACKEND_OPS},
    incremental_bfs=A.incremental_bfs, incremental_sssp=A.incremental_sssp,
    incremental_connected_components=A.incremental_connected_components,
    incremental_label_propagation=A.incremental_label_propagation)


class _GraphRef(tuple):
    """A graph the followers hold, by version token."""


class _TensorRef(tuple):
    """The ``i``-th tensor sent after the header."""


class _ResultRef(tuple):
    """A result the followers hold, by rank 0's cache key."""


class _Stored(tuple):
    """The ``i``-th tensor sent, also kept by the followers under a key."""


class _Held:
    """A value rank 0 found in its cache under ``key`` (a warm start's
    parent result): the followers receive it once and keep it there."""

    def __init__(self, key: Tuple, value: Any):
        self.key, self.value = key, value


def _local(x: Any) -> Any:
    """``x`` with every :class:`_Held` unwrapped (rank 0's own call)."""
    if isinstance(x, _Held):
        return x.value
    if isinstance(x, dict):
        return {k: _local(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_local(v) for v in x)
    return x


class _Mirror:
    """Rank 0's side of a d-rank ``"sharded"`` service.

    Every engine call that enters a collective is made under one lock, just
    after a broadcast that describes it (the callable's name, its
    arguments with graphs by version and tensors sent after the header,
    the cache keys the followers keep its result under).  So whatever the
    worker threads do, the ranks' collectives come in one order.  Rank 0
    makes every decision (cache hit, warm start, eviction, fusion); a
    follower only repeats the calls.  A graph the followers have not seen
    crosses once, as its five CSR arrays; when it dies on rank 0 they drop
    it, and they drop a kept result when rank 0's cache lets go of its key
    (:meth:`forget`).  Both sides change what the followers hold in one
    order: a message's drops first, then its call, then what the call
    keeps, so rank 0 always knows what a follower holds.  An idle service
    sends a keep-alive so the followers' wait never reaches the process
    group's timeout; :meth:`close` stops and joins the thread that sends
    it, so no thread of the service outlives ``close``.
    """

    def __init__(self, group: ShardGroup, keepalive_s: float = 5.0):
        self.group = group
        self.lock = threading.Lock()
        self._graphs: Dict[str, bool] = {}
        self._results: set = set()
        # versions of dead graphs and keys rank 0's cache let go of, not
        # yet taken (_take_drops); then not yet sent (_outgoing)
        self._dead: List[str] = []
        self._forgotten: List[Tuple] = []
        self._dead_lock = threading.Lock()
        self._outgoing: Dict[str, list] = {"drop_graphs": [],
                                           "drop_results": []}
        self.closed = False
        self.stats = {"calls": 0, "graphs_sent": 0, "graph_bytes": 0,
                      "results_sent": 0, "keepalives": 0}
        self._last = time.monotonic()
        self._keepalive_s = keepalive_s
        self._stop = threading.Event()
        self._ticker = threading.Thread(target=self._keepalive, daemon=True,
                                        name="graph-service-keepalive")
        self._ticker.start()

    # -- wire -------------------------------------------------------------
    def _on_dead(self, version: str) -> None:
        with self._dead_lock:
            self._dead.append(version)

    def forget(self, key: Tuple) -> None:
        """Rank 0's cache let go of ``key``: the followers drop what they
        keep under it with the next message."""
        with self._dead_lock:
            self._forgotten.append(key)

    def _take_drops(self) -> None:
        """Move the pending drops to the next message and out of what rank
        0 counts the followers as holding; the caller holds ``self.lock``
        and encodes nothing before this."""
        with self._dead_lock:
            dead, self._dead = self._dead, []
            gone, self._forgotten = self._forgotten, []
        for v in dead:
            self._graphs.pop(v, None)
        gone = [k for k in gone if k in self._results]
        self._results.difference_update(gone)
        self._outgoing["drop_graphs"] += dead
        self._outgoing["drop_results"] += gone

    def _send(self, header: Dict[str, Any], tensors=()) -> None:
        """Broadcast one message with the drops taken so far; the caller
        holds ``self.lock``."""
        header.update(self._outgoing)
        self._outgoing = {"drop_graphs": [], "drop_results": []}
        self.group.broadcast(header, tensors)
        self._last = time.monotonic()

    def _keepalive(self) -> None:
        while not self._stop.wait(self._keepalive_s / 4):
            if time.monotonic() - self._last < self._keepalive_s:
                continue
            if self.lock.acquire(blocking=False):
                try:
                    if not self.closed:
                        self._take_drops()
                        self._send({"kind": "nop"})
                        self.stats["keepalives"] += 1
                finally:
                    self.lock.release()

    def _ensure_graph(self, g: Graph) -> None:
        v = prov.version_of(g)
        if v in self._graphs:
            return
        arrays = (g.node_ids, g.out_ptr, g.out_idx, g.in_ptr, g.in_idx)
        self._send({"kind": "graph", "version": v, "n_nodes": g.n_nodes,
                    "n_edges": g.n_edges}, arrays)
        self._graphs[v] = True
        weakref.finalize(g, self._on_dead, v)
        self.stats["graphs_sent"] += 1
        self.stats["graph_bytes"] += sum(a.numel() * a.element_size()
                                         for a in arrays)

    def _encode(self, x: Any, tensors: List[torch.Tensor]) -> Any:
        if isinstance(x, Graph):
            self._ensure_graph(x)
            return _GraphRef((prov.version_of(x),))
        if isinstance(x, _Held):
            if x.key in self._results:
                return _ResultRef((x.key,))
            tensors.append(x.value)
            self._results.add(x.key)
            self.stats["results_sent"] += 1
            return _Stored((x.key, len(tensors) - 1))
        if torch.is_tensor(x):
            tensors.append(x)
            return _TensorRef((len(tensors) - 1,))
        if isinstance(x, dict):
            return {k: self._encode(v, tensors) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self._encode(v, tensors) for v in x)
        return x

    # -- calls -------------------------------------------------------------
    def call(self, name: str, args: Tuple, kwargs: Dict[str, Any],
             store: List[Tuple[Tuple, Optional[int]]] = ()) -> Any:
        """Run ``_FOLLOW_FNS[name](*args, **kwargs)`` on every rank; the
        followers keep the result (or its row ``i``) under each key of
        ``store``."""
        fn = _FOLLOW_FNS[name]
        with self.lock:
            if self.closed:
                raise ServiceError("the service's followers were released")
            self._take_drops()
            tensors: List[torch.Tensor] = []
            enc_args = self._encode(args, tensors)
            enc_kwargs = self._encode(kwargs, tensors)
            store = [(k, i) for k, i in store if k is not None]
            self._send({"kind": "call", "fn": name, "args": enc_args,
                        "kwargs": enc_kwargs, "store": store}, tensors)
            self.stats["calls"] += 1
            out = fn(*_local(args), **_local(kwargs))
            self._results.update(k for k, _ in store)
            return out

    def close(self) -> None:
        try:
            with self.lock:
                if not self.closed:
                    self._take_drops()
                    self._send({"kind": "close"})
                    self.closed = True
        finally:
            self._stop.set()
            self._ticker.join()


def serve_follower(group: Optional[ShardGroup] = None,
                   device: DeviceLike = None) -> Dict[str, int]:
    """The loop of ranks >= 1 of a d-rank ``"sharded"`` service.

    Repeats rank 0's engine calls as they are broadcast (see
    :class:`GraphService`) until rank 0's :meth:`GraphService.close`;
    returns counts of what it did.  It makes no decision of its own: it
    keeps the graphs by version and the results under rank 0's keys, and
    drops them when rank 0 says.  A call that raises here raised on rank 0
    too (the same inputs); it is logged and the loop goes on.
    """
    dev = resolve(device)
    if group is None:
        group = graph_group(engine.shard_count())
    if group.rank == 0:
        raise ValueError("rank 0 serves (GraphService); serve_follower runs "
                         "on ranks >= 1")
    graphs: Dict[str, Graph] = {}
    results: Dict[Tuple, Any] = {}
    counts = {"calls": 0, "graphs": 0, "errors": 0, "messages": 0}

    def decode(x, tensors):
        if isinstance(x, _GraphRef):
            return graphs[x[0]]
        if isinstance(x, _TensorRef):
            return tensors[x[0]]
        if isinstance(x, _ResultRef):
            return results[x[0]]
        if isinstance(x, _Stored):
            results[x[0]] = tensors[x[1]]
            return tensors[x[1]]
        if isinstance(x, dict):
            return {k: decode(v, tensors) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(decode(v, tensors) for v in x)
        return x

    ctx = torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()
    with ctx:
        while True:
            header, tensors = group.broadcast(device=dev)
            counts["messages"] += 1
            for v in header["drop_graphs"]:
                graphs.pop(v, None)
            for k in header["drop_results"]:
                results.pop(k, None)
            kind = header["kind"]
            if kind == "graph":
                graphs[header["version"]] = Graph(
                    header["n_nodes"], header["n_edges"], *tensors)
                counts["graphs"] += 1
            elif kind == "call":
                counts["calls"] += 1
                try:
                    out = _FOLLOW_FNS[header["fn"]](
                        *decode(header["args"], tensors),
                        **decode(header["kwargs"], tensors))
                    for key, i in header["store"]:
                        results[key] = out if i is None else out[i]
                except Exception:
                    counts["errors"] += 1
                    _log.exception("follower.call_failed", fn=header["fn"])
            if kind == "close":
                counts["graphs_held"] = len(graphs)
                counts["results_held"] = len(results)
                return counts


# ---------------------------------------------------------------------------
# memory accounting — byte-costed result cache + plan-member eviction
# ---------------------------------------------------------------------------

#: flat per-entry charge covering the key tuple, OrderedDict slot and cost
#: map; keeps zero-byte payloads (scalars, empty tables) from being free
_ENTRY_OVERHEAD = 512


def _payload_bytes(v: Any) -> int:
    """Array bytes held by a cached result value (0 for scalars)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return 0
    if isinstance(v, (Graph, Table)):
        return int(v.nbytes())
    if torch.is_tensor(v):
        return v.numel() * v.element_size()
    if isinstance(v, np.ndarray):
        return int(v.nbytes)
    if isinstance(v, (tuple, list)):
        return sum(_payload_bytes(x) for x in v)
    if isinstance(v, dict):
        return sum(_payload_bytes(x) for x in v.values())
    return 0


def _value_nbytes(v: Any) -> int:
    return _ENTRY_OVERHEAD + _payload_bytes(v)


class _MemoryManager:
    """Keeps the service's tracked bytes under :class:`MemoryPolicy`'s budget.

    Tracked bytes = result-cache bytes + the re-derivable plan families of
    every live graph the service has served.  Eviction order is fixed:
    result-cache entries first (LRU — recomputing is the ordinary miss
    path), then plan families of graphs with no in-flight batch, largest
    first (re-deriving is cheaper than an engine call but not free).  The
    base CSR of a live graph and the plan's eager arrays are never touched.

    Lock order (outermost → innermost): ``self._lock`` → the service's
    ``_lock`` → ``_stats_lock``.  Nothing may call into this class while
    holding the service lock.
    """

    def __init__(self, service: "GraphService", policy: MemoryPolicy):
        self.service = service
        self.policy = policy
        self._lock = threading.RLock()
        # id(graph) -> weakref; a graph that dies simply drops out of
        # accounting (its plan died with it)
        self._graphs: Dict[int, Any] = {}
        # id(graph) -> in-flight batch refcount; a busy graph's plan members
        # are mid-use by an engine call and are skipped by eviction
        self._busy: Dict[int, int] = {}
        # test/debug probe: recent eviction actions ("result"|"plan", bytes)
        self.evlog: "deque" = deque(maxlen=256)

    # -- graph registry -----------------------------------------------------
    def _drop(self, key: int) -> None:
        with self._lock:
            self._graphs.pop(key, None)
            self._busy.pop(key, None)

    def note_graph(self, g: Graph) -> None:
        key = id(g)
        with self._lock:
            if key not in self._graphs:
                self._graphs[key] = weakref.ref(
                    g, lambda r, key=key: self._drop(key))

    def _live_graphs_locked(self) -> List[Graph]:
        out = []
        for key, ref in list(self._graphs.items()):
            g = ref()
            if g is None:
                self._graphs.pop(key, None)
                self._busy.pop(key, None)
            else:
                out.append(g)
        return out

    # -- in-flight pinning (scheduler brackets every engine call) -----------
    def begin_group(self, graphs: List[Graph]) -> None:
        with self._lock:
            for g in graphs:
                key = id(g)
                self._busy[key] = self._busy.get(key, 0) + 1

    def end_group(self, graphs: List[Graph]) -> None:
        with self._lock:
            for g in graphs:
                key = id(g)
                n = self._busy.get(key, 0) - 1
                if n <= 0:
                    self._busy.pop(key, None)
                else:
                    self._busy[key] = n
        self.maybe_evict()

    # -- accounting ---------------------------------------------------------
    def _plan_totals_locked(self) -> Tuple[int, int, List[Tuple[int, str, Any]]]:
        """(total plan bytes, evictable plan bytes, evictable candidates).

        Candidates — ``(bytes, family, plan)`` — cover only graphs with no
        in-flight batch; busy graphs' evictable bytes still count toward the
        total (they are tracked, just momentarily unevictable).
        """
        total = evictable = 0
        candidates: List[Tuple[int, str, Any]] = []
        for g in self._live_graphs_locked():
            p = g._plan
            if p is None:
                continue
            fams = p.nbytes_by_family()
            total += sum(fams.values())
            busy = self._busy.get(id(g), 0) > 0
            for f in EVICTABLE_FAMILIES:
                b = fams[f]
                evictable += b
                if b > 0 and not busy:
                    candidates.append((b, f, p))
        return total, evictable, candidates

    def _prune_lineage_locked(self) -> None:
        cuts = 0
        for g in self._live_graphs_locked():
            cuts += g.prune_lineage(self.policy.max_lineage_depth)
        if cuts:
            self.service._bump("lineage_cuts", cuts)

    def tracked_bytes(self) -> int:
        with self._lock:
            _, evictable, _ = self._plan_totals_locked()
            with self.service._lock:
                return self.service._cache_bytes + evictable

    def on_cache_change(self) -> None:
        """Cheap hook after every ``_cache_put``: O(1) gauge refresh when
        unbudgeted, full eviction pass when a budget is set (a retention put
        at submit time can push past the budget between engine calls)."""
        if self.policy.budget_bytes is None:
            with self.service._lock:
                _G_CACHE_BYTES.set(self.service._cache_bytes)
            return
        self.maybe_evict()

    def maybe_evict(self) -> None:
        """One full accounting pass: prune lineage, evict to budget, gauge."""
        svc = self.service
        with self._lock:
            self._prune_lineage_locked()
            budget = self.policy.budget_bytes
            plan_total, plan_ev, candidates = self._plan_totals_locked()
            n_results = n_plans = freed = 0
            if budget is not None:
                # 1) result cache, LRU order — cheapest to restore
                with svc._lock:
                    while svc._cache_bytes + plan_ev > budget and svc._cache:
                        key, _ = svc._cache.popitem(last=False)
                        svc._forget(key)
                        cost = svc._cache_cost.pop(key, 0)
                        svc._cache_bytes -= cost
                        n_results += 1
                        freed += cost
                        self.evlog.append(("result", cost))
                    cache_bytes = svc._cache_bytes
                # 2) plan families of idle graphs, largest first
                if cache_bytes + plan_ev > budget:
                    for b, fam, p in sorted(candidates, key=lambda c: -c[0]):
                        if cache_bytes + plan_ev <= budget:
                            break
                        got = p.evict(fam)
                        plan_ev = max(plan_ev - got, 0)
                        plan_total = max(plan_total - got, 0)
                        n_plans += 1
                        freed += got
                        self.evlog.append(("plan", got))
            with svc._lock:
                cache_bytes = svc._cache_bytes
            _G_PLAN_BYTES.set(plan_total)
            _G_PLAN_EVICTABLE.set(plan_ev)
            _G_CACHE_BYTES.set(cache_bytes)
            _G_TRACKED.set(cache_bytes + plan_ev)
            _G_BUDGET.set(0 if budget is None else budget)
            _G_PINS.set(prov.pin_stats()["pinned"])
        if n_results:
            svc._bump("evicted_results", n_results)
        if n_plans:
            svc._bump("evicted_plan_families", n_plans)
        if freed:
            svc._bump("evicted_bytes", freed)

    def stats(self) -> Dict[str, int]:
        """Point-in-time memory accounting (also the session_stats payload)."""
        with self._lock:
            plan_total, plan_ev, _ = self._plan_totals_locked()
            with self.service._lock:
                cache_bytes = self.service._cache_bytes
                entries = len(self.service._cache)
        pins = prov.pin_stats()
        budget = self.policy.budget_bytes
        return {"tracked_bytes": cache_bytes + plan_ev,
                "budget_bytes": 0 if budget is None else int(budget),
                "result_cache_bytes": cache_bytes,
                "result_cache_entries": entries,
                "plan_bytes": plan_total,
                "plan_evictable_bytes": plan_ev,
                "provenance_pins": pins["pinned"],
                "provenance_pin_bytes": pins["bytes"]}


# ---------------------------------------------------------------------------
# Workspace — shared named/versioned objects (Ringo's big-memory heap)
# ---------------------------------------------------------------------------


class Workspace:
    """Named, versioned tables/graphs shared across sessions.

    The workspace owns the long-lived references, which is what makes the
    identity-memoized caches effective: as long as a graph stays in the
    workspace, its ``GraphPlan`` (sorted edges, BSR tiles, chunk layouts) and
    every service-cache entry keyed by its version token stay warm.
    """

    def __init__(self):
        self._objs: Dict[str, Any] = {}
        # name -> version token, written in the same critical section as
        # _objs: reads of (object, version) pairs are always consistent,
        # and update()'s CAS compares against it.
        self._versions: Dict[str, str] = {}
        self._lock = threading.RLock()

    def put(self, name: str, obj: Any) -> str:
        """Bind ``name`` to ``obj``; returns the object's version token."""
        with self._lock:
            self._objs[name] = obj
            v = prov.version_of(obj)
            self._versions[name] = v
            return v

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._objs:
                raise KeyError(f"no workspace object {name!r}; "
                               f"have {sorted(self._objs)}")
            return self._objs[name]

    def version(self, name: str) -> str:
        with self._lock:
            if name in self._versions:
                return self._versions[name]
        return prov.version_of(self.get(name))

    def update(self, name: str, fn: Callable[[Any], Any]) -> str:
        """Functional update: bind ``name`` to ``fn(current)``.

        The result is a fresh object with a fresh version token — downstream
        plan caches and service result caches keyed by the old token simply
        stop matching (invalidation by construction, never by broadcast).

        ``fn`` still runs *outside* the workspace lock (a big-graph rebuild
        must not stall every other session's reads), but the read-modify-
        write of the name→version map is a compare-and-swap: the new binding
        only lands if ``name`` still holds the version the update read.
        When a concurrent update (another thread, or another server
        connection) won the race, ``fn`` re-runs against the fresh object —
        no update is ever silently lost.  ``fn`` must therefore be pure.
        """
        while True:
            with self._lock:
                cur = self.get(name)
                cur_ver = self._versions.get(name)
            new = fn(cur)
            with self._lock:
                if self._versions.get(name) != cur_ver \
                        or self._objs.get(name) is not cur:
                    continue          # lost the race; redo against fresh
                self._objs[name] = new
                v = prov.version_of(new)
                self._versions[name] = v
                return v

    def apply_delta(self, name: str, delta: EdgeDelta) -> str:
        """Publish ``name``'s graph with ``delta`` applied; returns the new
        version token.

        A convenience over :meth:`update` that keeps the delta on the
        functional-update path: the child graph carries its ``_delta``
        lineage, so downstream plan builds patch instead of rebuilding and
        the service's delta-aware cache retention / warm starts engage.
        Like any ``update``, a lost CAS race re-applies the delta against
        the fresh object — deltas from concurrent writers all land.
        """
        return self.update(name, lambda g: g.apply_delta(delta))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._objs)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._objs


# ---------------------------------------------------------------------------
# Session — one analyst's namespace over the workspace
# ---------------------------------------------------------------------------


class Session:
    """Per-analyst namespace layered over a shared :class:`Workspace`.

    Reads fall through to the workspace; writes (``put`` and request
    ``"as"`` bindings) stay session-local until :meth:`publish` — the
    isolation contract that lets many analysts iterate on the same shared
    graphs without trampling each other's intermediates.
    """

    def __init__(self, service: "GraphService", name: str):
        self.service = service
        self.name = name
        self._local: Dict[str, Any] = {}
        self._lock = threading.RLock()

    # -- namespace ----------------------------------------------------------
    def put(self, name: str, obj: Any) -> str:
        with self._lock:
            self._local[name] = obj
            return prov.version_of(obj)

    def get(self, name: str) -> Any:
        with self._lock:
            if name in self._local:
                return self._local[name]
        return self.service.workspace.get(name)

    def publish(self, name: str) -> str:
        """Promote a session-local object into the shared workspace."""
        with self._lock:
            if name not in self._local:
                raise KeyError(f"session {self.name!r} has no local object "
                               f"{name!r}")
            obj = self._local.pop(name)
        return self.service.workspace.put(name, obj)

    def local_names(self) -> List[str]:
        with self._lock:
            return sorted(self._local)

    # -- execution ----------------------------------------------------------
    def submit(self, request: Dict[str, Any]) -> "Pending":
        return self.service.submit(self, request)

    def execute(self, request: Dict[str, Any]) -> Any:
        return self.service.execute(self, request)


# ---------------------------------------------------------------------------
# Pending — a submitted request's future result
# ---------------------------------------------------------------------------


class Pending:
    """Handle for a submitted request; resolved by the scheduler."""

    def __init__(self, session: Session, request: Dict[str, Any]):
        self.session = session
        self.request = request
        #: trace id this request rides under (set from the request body or
        #: the submit call; lands on provenance meta and every span)
        self.trace: Optional[str] = request.get("trace")
        self.done = False
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.cached = False
        self.fused = False
        self.submitted_at = time.perf_counter()
        self.dispatched_at: Optional[float] = None
        self.completed_at: Optional[float] = None
        self._event = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks: Optional[List[Callable[["Pending"], None]]] = []

    @property
    def latency_ms(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return (self.completed_at - self.submitted_at) * 1e3

    @property
    def queued_ms(self) -> Optional[float]:
        """Time spent waiting for the scheduler to dispatch this request."""
        if self.dispatched_at is None:
            return None
        return (self.dispatched_at - self.submitted_at) * 1e3

    def _resolve(self, value: Any = None,
                 error: Optional[BaseException] = None,
                 cached: bool = False, fused: bool = False) -> None:
        self.value, self.error = value, error
        self.cached, self.fused = cached, fused
        self.completed_at = time.perf_counter()
        self.done = True
        self._event.set()
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, None
        for fn in cbs or ():
            try:
                fn(self)
            except Exception:        # a dead callback must not poison the
                pass                 # scheduler thread resolving us

    def add_done_callback(self, fn: Callable[["Pending"], None]) -> None:
        """Run ``fn(self)`` when resolved (immediately if already done).

        This is the server's streaming hook: a socket connection registers a
        callback that frames the result back to the client the moment the
        scheduler resolves it — completion order, not submission order.
        Callbacks run on the resolving thread; exceptions are swallowed.
        """
        with self._cb_lock:
            if self._callbacks is not None:
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:
            pass

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self.done:
            # sync services drain inline; worker-backed ones just wait
            # (another thread's drain may have claimed this request mid-run)
            self.session.service._ensure_progress()
            if not self._event.wait(timeout):
                raise TimeoutError(
                    f"request {self.request.get('op')!r} still pending "
                    f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.value


# ---------------------------------------------------------------------------
# GraphService — declarative execution, fusion scheduling, result caching
# ---------------------------------------------------------------------------


class GraphService:
    """Front end executing declarative requests from concurrent sessions.

    Request shape::

        {"op": "pagerank", "graph": "qa", "params": {"n_iter": 20},
         "as": "pr"}                    # optional session-local binding

    Named-object slots are op-specific: ``"table"`` / ``"left"`` + ``"right"``
    for relational ops, ``"graph"`` for conversions and algorithms, plus
    ``"scores"`` for ``table_from_map``.  Slots resolve session-first, then
    workspace.  ``params`` holds the remaining literal keyword arguments of
    the underlying function.  A request may additionally carry
    ``"deadline_ms"``: if the scheduler cannot dispatch it within that
    budget it resolves with :class:`DeadlineExpired` instead of reaching
    the engine.

    Named inputs resolve at **submit** time, pinning the object versions
    the session named (a concurrent workspace update cannot change what an
    already-submitted request computes).  Consequently a request that
    consumes another request's ``"as"`` binding must be submitted after
    the producer has *resolved* (``execute`` or ``result()``), not merely
    after it was submitted — the binding does not exist before then.

    ``policy`` configures admission control, fair share and batching
    windows (:class:`~repro_torch.serve.policy.SchedulerPolicy`); over-quota
    submits raise :class:`RejectedError` with a ``retry_after`` hint.
    ``workers`` starts that many background scheduler threads — the serving
    mode the overload benchmark measures; with ``workers=0`` the scheduler
    runs inline at :meth:`flush` (deterministic, test-friendly).

    ``device`` is where the service computes (default: the card, raising
    without one; ``"cpu"`` by name): engine milliseconds are taken after a
    sync of it, and engine calls run with it as the current CUDA device.

    ``engine_backend="sharded"`` runs the engine calls through
    ``ShardedExec``.  At one shard that is this process alone.  At ``d > 1``
    shards (a default process group of ``d`` ranks) rank 0 constructs the
    service, with its workers and sessions, and ranks ``1..d-1`` run
    :func:`serve_follower`, which returns at rank 0's :meth:`close`.  Rank
    0 makes every decision and broadcasts each engine call that enters a
    collective just before making it, under one lock (``_Mirror``), so the
    ranks' collectives come in one order whatever the worker threads do;
    calls without collectives (table ops, conversions, other backends) run
    on rank 0 alone.  Constructing the service on another rank raises
    ``ValueError``.
    """

    def __init__(self, workspace: Optional[Workspace] = None, *,
                 fuse: bool = True, cache: bool = True, incremental: bool = True,
                 max_cache_entries: int = 1024,
                 policy: Optional[SchedulerPolicy] = None,
                 memory: Optional[MemoryPolicy] = None,
                 workers: int = 0,
                 engine_backend: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve(device)
        self._mirror: Optional[_Mirror] = None
        if engine_backend == "sharded" and engine.shard_count() > 1:
            group = graph_group(engine.shard_count())
            if group.rank != 0:
                raise ValueError(
                    f"rank {group.rank} of a {group.d}-rank 'sharded' service "
                    f"follows rank 0: call serve_follower() there")
            self._mirror = _Mirror(group)
        self.workspace = workspace if workspace is not None else Workspace()
        self.fuse = fuse
        # default engine backend for every _BACKEND_OPS request that does
        # not name one explicitly ("sharded" runs every engine call through
        # ShardedExec at d == 1 on this service's device); injected before
        # canonicalization in _prepare so result-cache and fusion keys never
        # mix backends
        self.engine_backend = engine_backend
        self.cache_enabled = cache
        # delta-aware serving: retain provably-unaffected cache entries
        # across Workspace.apply_delta and warm-start recomputation from the
        # parent version's cached result (``incremental=False`` restores
        # cold-only behavior, e.g. for differential testing)
        self.incremental = incremental
        self._cache: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._cache_cost: Dict[Tuple, int] = {}
        self._cache_bytes = 0
        self._max_cache = max_cache_entries
        self._lock = threading.RLock()
        self._sessions: Dict[str, Session] = {}
        # per-session result-cache accounting, exposed via session_stats
        self._session_counters: Dict[str, Dict[str, int]] = {}
        self.stats = {"requests": 0, "cache_hits": 0, "cache_misses": 0,
                      "fused_calls": 0, "fused_requests": 0,
                      "engine_calls": 0, "rejected": 0, "expired": 0,
                      "batch_windows": 0, "retained": 0, "warm_starts": 0,
                      "incremental_fallbacks": 0,
                      "evicted_results": 0, "evicted_plan_families": 0,
                      "evicted_bytes": 0, "lineage_cuts": 0}
        # dedicated innermost lock for the ``stats`` dict: it is bumped from
        # submitters (under self._lock), scheduler workers (under the
        # scheduler's lock) and drain callers — a bare ``+=`` under two
        # *different* outer locks is a lost-update race.  Every mutation
        # goes through _bump; nothing else is ever taken while holding it.
        self._stats_lock = threading.Lock()
        self.policy = policy if policy is not None else SchedulerPolicy()
        # memory budget: explicit ``memory=`` beats the policy's; the pin
        # ring is process-global, so the most recent service's cap applies
        self.memory = memory if memory is not None else self.policy.memory
        prov.set_pin_capacity(self.memory.max_provenance_pins)
        self._mem = _MemoryManager(self, self.memory)
        self.scheduler = Scheduler(self, self.policy)
        self._stop = threading.Event()
        self._worker_threads: List[threading.Thread] = []
        for i in range(workers):
            t = threading.Thread(target=self.scheduler.run_loop,
                                 args=(self._stop,), daemon=True,
                                 name=f"graph-service-worker-{i}")
            t.start()
            self._worker_threads.append(t)

    def _on_device(self):
        """Context of one engine call: the service's device as the calling
        thread's current CUDA device (kernel launches take the current
        device), nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _block(self, out: Any) -> Any:
        """Wait for device work so measured engine-ms is real, not
        dispatch (a sync of the service's device; nothing on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        """Increment a service counter (thread-safe) and mirror it to the
        observability registry as ``service.<key>``."""
        with self._stats_lock:
            self.stats[key] += n
        obs.counter(f"service.{key}").inc(n)

    def close(self) -> None:
        """Stop background workers, then drain whatever they left queued.

        Each worker finishes the engine call it is in before ``close``
        goes on: a worker left running is a daemon thread still inside
        torch when the interpreter exits, and re-taking the GIL there
        aborts the process ("terminate called without an active
        exception").  Without the drain, a thread already blocked in
        ``Pending.result()`` on a request the dying workers never reached
        would wait forever — worker-backed services skip the inline drain
        in ``_ensure_progress``.
        """
        self._stop.set()
        with self.scheduler._cond:
            self.scheduler._cond.notify_all()
        for t in self._worker_threads:
            t.join()
        self._worker_threads = []
        self.scheduler.drain()
        if self._mirror is not None:
            self._mirror.close()     # releases the followers

    # -- sessions -----------------------------------------------------------
    def session(self, name: str) -> Session:
        with self._lock:
            if name not in self._sessions:
                self._sessions[name] = Session(self, name)
            return self._sessions[name]

    def session_stats(self, name: str) -> Dict[str, Any]:
        """Accounting for one session: the scheduler snapshot (queue,
        deficit, engine-ms consumed, completions, rejections, expiries)
        merged with the service's result-cache counters — ``cache_hits``,
        ``cache_misses`` and ``retained`` (hits served by a cache entry
        re-bound across a delta).  Flat scalars, so the wire codec ships
        the dict unchanged."""
        out = self.scheduler.session_stats(name)
        with self._lock:
            c = self._session_counters.get(name)
            out.update(c if c is not None
                       else {"cache_hits": 0, "cache_misses": 0,
                             "retained": 0})
        # service-wide memory accounting (same for every session): what the
        # server is holding on clients' behalf, visible over the wire
        out.update({f"mem_{k}": v for k, v in self._mem.stats().items()})
        return out

    def end_session(self, name: str) -> None:
        """Drop a session's namespace and (if idle) its scheduler state.

        Called by the socket server when a connection closes: without it,
        every connection would leak a session namespace and a deficit-
        round-robin ring entry for the life of the service.  Scheduler
        state with queued or in-flight work survives until it drains.
        """
        with self._lock:
            self._sessions.pop(name, None)
            self._session_counters.pop(name, None)
        self.scheduler.forget_session(name)

    # -- submission ---------------------------------------------------------
    def submit(self, session: Session, request: Dict[str, Any],
               trace: Optional[str] = None) -> Pending:
        """Validate, prepare and enqueue a request.

        Raises :class:`RejectedError` (with ``retry_after``) when the
        session is over its in-flight quota or the service backlog is at
        its depth bound.  Preparation errors (unknown names, missing slots)
        resolve the returned :class:`Pending` instead of raising here.

        ``trace`` attaches a trace id (e.g. one extracted from the wire) to
        the request's spans and result provenance; without one the request
        inherits the submitting thread's active trace, or mints a fresh id
        (so flight-recorder exemplars always carry span evidence — the
        remote client does the same on its side of the wire).
        """
        op = request.get("op")
        if op not in _OPS:
            raise ServiceError(f"unknown op {op!r}; have {sorted(_OPS)}")
        p = Pending(session, dict(request))
        if trace is not None:
            p.trace = trace
        elif p.trace is None:
            p.trace = obs.current_trace()
        if p.trace is None and obs.TRACER.enabled:
            p.trace = obs.new_trace_id()
        self._bump("requests")
        with obs.TRACER.span("service.submit", trace=p.trace, op=op,
                             session=session.name):
            q = self._prepare(p)
            if q is None:
                # preparation error resolved p without touching the
                # scheduler, so its completion seam never fires — feed the
                # flight recorder here for error-exemplar completeness
                obs.FLIGHT.record_pending(p, op=op, session=session.name)
                return p
            # cache fast path: a repeated trial-and-error query resolves at
            # submit, skipping admission and the scheduler round trip — it
            # consumes no engine time, so there is nothing to admission-
            # control or charge, and the serving path (local or wire) sees
            # memory-speed latency.  The speculative probe must not count a
            # miss: the authoritative lookup happens again at dispatch.
            # Delta retention runs first so a provably-unaffected query
            # against a freshly-updated graph also resolves at submit.
            self._try_retain(q)
            hit, found = self._cache_get(q.cache_key, count_miss=False,
                                         session=p.session.name)
            if found:
                obs.TRACER.instant("service.cache_hit_submit", trace=p.trace,
                                   op=op, session=session.name)
                self._finish(p, hit, cached=True)
                # submit-time cache hits also bypass the scheduler's
                # completion seam; record so SLO windows count every request
                obs.FLIGHT.record_pending(p, op=op, session=session.name)
                return p
            self.scheduler.submit(q)
        return p

    def execute(self, session: Session, request: Dict[str, Any]) -> Any:
        p = self.submit(session, request)
        self.flush()
        return p.result()

    # -- request resolution -------------------------------------------------
    def _resolve_inputs(self, p: Pending) -> List[Tuple[str, Any]]:
        """(param_name, object) pairs for the request's named-object slots."""
        _, slots = _OPS[p.request["op"]]
        out = []
        for slot, param in slots.items():
            if slot not in p.request:
                raise ServiceError(
                    f"op {p.request['op']!r} needs a {slot!r} name")
            out.append((param, p.session.get(p.request[slot])))
        return out

    def _cache_key(self, op: str, inputs: List[Tuple[str, Any]],
                   canon: Tuple) -> Optional[Tuple]:
        if not self.cache_enabled or prov.contains_opaque(canon):
            return None
        versions = tuple((name, prov.version_of(obj)) for name, obj in inputs)
        # order-insensitive: {"a":1,"b":2} and {"b":2,"a":1} are one key
        return (op, versions, tuple(sorted(canon, key=lambda kv: kv[0])))

    def _sess_counter(self, session: str) -> Dict[str, int]:
        """Per-session cache counters; caller holds ``self._lock``."""
        c = self._session_counters.get(session)
        if c is None:
            c = self._session_counters[session] = {
                "cache_hits": 0, "cache_misses": 0, "retained": 0}
        return c

    def _forget(self, key: Tuple) -> None:
        """``key`` left the result cache (the followers drop it too)."""
        if self._mirror is not None:
            self._mirror.forget(key)

    def _engine(self, name: str, g: Graph, args: Tuple,
                kwargs: Dict[str, Any], store=()) -> Any:
        """One engine call, ``_FOLLOW_FNS[name](*args, **kwargs)`` on ``g``:
        through the followers when it enters a collective (a d-rank
        "sharded" service), here alone otherwise."""
        op = name[len("incremental_"):] if name.startswith("incremental_") \
            else name
        if (self._mirror is not None and engine._select_backend(
                g.plan(), kwargs.get("backend"), op) == "sharded"):
            return self._mirror.call(name, args, kwargs, store)
        return _FOLLOW_FNS[name](*_local(args), **_local(kwargs))

    def _cache_get(self, key: Optional[Tuple], count_miss: bool = True,
                   session: Optional[str] = None):
        if key is None:
            return None, False
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                if session is not None:
                    self._sess_counter(session)["cache_hits"] += 1
                hit = self._cache[key]
            else:
                if count_miss and session is not None:
                    self._sess_counter(session)["cache_misses"] += 1
                hit = _MISS
        if hit is not _MISS:
            self._bump("cache_hits")
            return hit, True
        if count_miss:
            self._bump("cache_misses")
        return None, False

    def _cache_put(self, key: Optional[Tuple], value: Any) -> None:
        """Insert under byte accounting; evict LRU-first past any bound.

        Every entry carries its byte cost (payload arrays + a flat
        overhead); the running total feeds the memory manager, which brings
        tracked bytes back under :class:`MemoryPolicy`'s budget after the
        insert — result entries before plan members, never mid-batch.
        """
        if key is None:
            return
        cost = _value_nbytes(value)
        _H_ENTRY_BYTES.observe(cost)
        with self._lock:
            old = self._cache_cost.pop(key, None)
            if old is not None:
                self._cache_bytes -= old
            self._cache[key] = value
            self._cache.move_to_end(key)
            self._cache_cost[key] = cost
            self._cache_bytes += cost
            while len(self._cache) > self._max_cache:
                k, _ = self._cache.popitem(last=False)
                self._forget(k)
                self._cache_bytes -= self._cache_cost.pop(k, 0)
        self._mem.on_cache_change()

    # -- preparation (submit-time resolution) -------------------------------
    def _prepare(self, p: Pending) -> Optional[QueuedRequest]:
        """Resolve names and compute fusion/cache keys at submit time.

        Resolving here pins the object versions the session named at
        submission — coalescing and caching later must not observe a
        concurrent workspace update.  A resolution error resolves the
        :class:`Pending` (the submitter sees it at ``result()``) and
        returns None so nothing is enqueued.
        """
        op = p.request["op"]
        try:
            inputs = self._resolve_inputs(p)
            params = dict(p.request.get("params") or {})
            if (self.engine_backend is not None and op in _BACKEND_OPS
                    and params.get("backend") is None):
                params["backend"] = self.engine_backend
            if (params.get("backend") == "sharded" and self._mirror is None
                    and engine.shard_count() > 1):
                raise ServiceError(
                    "a 'sharded' request at more than one shard needs a "
                    "service with engine_backend='sharded' (its ranks "
                    "follow rank 0's calls)")
            canon = prov.canonical_params(params)
            key = self._cache_key(op, inputs, canon)
        except Exception as e:
            p._resolve(error=e)
            return None
        # keys are taken: the host arrays go to the inputs' device
        dev = next((o.device for _, o in inputs
                    if isinstance(o, (Graph, Table))), self.device)
        params = _to_device(params, dev)
        for _, o in inputs:
            if isinstance(o, Graph):
                self._mem.note_graph(o)
        payload: Dict[str, Any] = {"inputs": inputs, "params": params}
        fuse_key = None
        src_param = _FUSABLE.get(op)
        source = params.get(src_param) if src_param else None
        n_iter = params.get("n_iter")
        if (self.fuse and src_param
                and isinstance(source, (int, np.integer))
                and not isinstance(source, bool)
                and (n_iter is None or (isinstance(n_iter, (int, np.integer))
                                        and not isinstance(n_iter, bool)))
                and not (op == "sssp"
                         and _sssp_weights_block_fusion(canon))):
            # n_iter joins source as a per-request coordinate: requests that
            # differ only in depth still share one fused engine call
            rest = tuple(sorted(((k, v) for k, v in canon
                                 if k not in (src_param, "n_iter")),
                                key=lambda kv: kv[0]))
            fuse_key = (op, prov.version_of(inputs[0][1]), rest)
            payload.update(graph=inputs[0][1], source=int(source),
                           n_iter=None if n_iter is None else int(n_iter))
        deadline_ms = p.request.get("deadline_ms",
                                    self.policy.default_deadline_ms)
        deadline = (None if deadline_ms is None
                    else p.submitted_at + float(deadline_ms) / 1e3)
        return QueuedRequest(pending=p, session=p.session.name, op=op,
                             cache_key=key, fuse_key=fuse_key,
                             payload=payload, deadline=deadline)

    # -- scheduler callbacks ------------------------------------------------
    @staticmethod
    def _group_graphs(group: List[QueuedRequest]) -> List[Graph]:
        """Distinct input graphs an engine call for ``group`` will touch."""
        out: List[Graph] = []
        seen: set = set()
        for q in group:
            for o in ([q.payload.get("graph")]
                      + [x for _, x in q.payload.get("inputs", ())]):
                if isinstance(o, Graph) and id(o) not in seen:
                    seen.add(id(o))
                    out.append(o)
        return out

    def _mem_begin(self, group: List[QueuedRequest]) -> None:
        """Scheduler bracket: pin the group's graphs against plan eviction
        for the duration of the engine call (eviction must never race an
        in-flight batch's plan arrays)."""
        self._mem.begin_group(self._group_graphs(group))

    def _mem_end(self, group: List[QueuedRequest]) -> None:
        """Unpin + run an accounting/eviction pass (plans likely grew)."""
        self._mem.end_group(self._group_graphs(group))

    def memory_stats(self) -> Dict[str, int]:
        """Tracked-bytes accounting: budget, result cache, plan families,
        provenance pins.  Flat scalars — ships over the wire unchanged."""
        return self._mem.stats()

    def _cache_lookup(self, q: QueuedRequest) -> Tuple[Any, bool]:
        self._try_retain(q)
        return self._cache_get(q.cache_key, session=q.session)

    def _finish_cached(self, q: QueuedRequest, value: Any) -> None:
        obs.TRACER.instant("service.cache_hit", trace=q.pending.trace,
                           op=q.op, session=q.session)
        self._finish(q.pending, value, cached=True)

    def _sched_meta(self, q: QueuedRequest, batch: int
                    ) -> Dict[str, Any]:
        """Queueing/coalescing metadata recorded on result provenance."""
        queued = q.pending.queued_ms
        meta = {"queued_ms": 0.0 if queued is None else round(queued, 3),
                "batch": batch, "sched_mode": self.policy.mode}
        if q.pending.trace is not None:
            meta["trace"] = q.pending.trace
        return meta

    # -- incremental maintenance (delta-aware serving) ----------------------
    def _delta_of(self, q: QueuedRequest):
        """(graph, delta-info) when the request's sole input is a graph
        produced by the insert-only ``apply_delta`` fast path, else None."""
        inputs = q.payload["inputs"]
        if len(inputs) != 1 or not isinstance(inputs[0][1], Graph):
            return None
        g = inputs[0][1]
        info = g._delta
        if info is None:
            return None
        return g, info

    def _parent_key(self, q: QueuedRequest, parent: Graph
                    ) -> Optional[Tuple]:
        """``q.cache_key`` re-pointed at the parent graph's version."""
        if q.cache_key is None:
            return None
        op, versions, canon = q.cache_key
        if len(versions) != 1:
            return None
        (name, _), = versions
        return (op, ((name, prov.version_of(parent)),), canon)

    def _parent_cached(self, q: QueuedRequest, parent: Graph):
        """Parent-version cache entry without touching hit/miss counters."""
        pkey = self._parent_key(q, parent)
        if pkey is None:
            return None, False
        with self._lock:
            if pkey in self._cache:
                return self._cache[pkey], True
        return None, False

    def _try_retain(self, q: QueuedRequest) -> bool:
        """Re-bind the parent version's cached result to ``q``'s key when
        the delta provably cannot change it (see :func:`_retention_safe`).

        The retained entry then serves this and every future identical
        query against the child version as an ordinary cache hit — the
        query never reaches the engine even though the graph changed.
        """
        if not self.incremental or q.op not in _RETAINABLE \
                or q.cache_key is None:
            return False
        with self._lock:
            if q.cache_key in self._cache:
                return False          # already resident; nothing to retain
        gi = self._delta_of(q)
        if gi is None:
            return False
        g, info = gi
        if not info.insert_only:
            return False              # deletions can affect any result
        parent_val, found = self._parent_cached(q, info.parent)
        if not found:
            return False
        try:
            if not _retention_safe(q.op, g, info, parent_val,
                                   q.payload["params"]):
                return False
        except Exception:
            _log.exception("retention.predicate_failed", op=q.op,
                           session=q.session, action="running cold")
            return False
        self._cache_put(q.cache_key, parent_val)
        self._bump("retained")
        with self._lock:
            self._sess_counter(q.session)["retained"] += 1
        return True

    def _try_warm(self, q: QueuedRequest) -> Optional[Any]:
        """Warm-start ``q`` from the parent version's cached result.

        Returns the (blocked) result, or None to run cold.  Soundness
        gates mirror the incremental helpers in :mod:`repro_torch.core.algorithms`:
        traversals/labels need an insert-only delta, an uncapped run and the
        exact parent result; pagerank/PPR warm from any delta but only
        under ``tol`` semantics (a warm fixed-``n_iter`` run would be a
        *different* iterate than the cold one, so it never substitutes).
        The result's provenance is rewritten to the equivalent cold call —
        export/replay are oblivious to the warm start, exactly as they are
        to fusion.
        """
        if not self.incremental or q.op not in _WARM_OPS:
            return None
        gi = self._delta_of(q)
        if gi is None:
            return None
        g, info = gi
        op = q.op
        params = dict(q.payload["params"])
        parent_val, found = self._parent_cached(q, info.parent)
        # the parent's result as the followers will hold it
        held = _Held(self._parent_key(q, info.parent), parent_val)
        store = self._keep([q])
        out = None
        try:
            if not found:
                pass                  # no parent result to warm from
            elif op == "pagerank":
                if params.get("tol") is not None and "init" not in params:
                    out = self._engine("pagerank", g, (g,),
                                       dict(params, init=held), store)
            elif op == "personalized_pagerank":
                source = params.pop("source", None)
                if (params.get("tol") is not None and "init" not in params
                        and isinstance(source, (int, np.integer))
                        and not isinstance(source, bool)):
                    out = self._engine("personalized_pagerank", g,
                                       (g, int(source)),
                                       dict(params, init=held), store)
            elif op in ("bfs", "sssp"):
                source = params.pop("source", None)
                # "backend" is neutral to warm soundness: every backend is
                # value-identical, so the default-backend warm helpers
                # substitute for any
                extra = set(params) - {"n_iter", "weights", "backend"}
                if (not extra and params.get("n_iter") is None
                        and params.get("weights") is None
                        and isinstance(source, (int, np.integer))
                        and not isinstance(source, bool)):
                    out = self._engine(f"incremental_{op}", g,
                                       (g, int(source), held), {}, store)
            elif op == "connected_components":
                if not set(params) - {"backend"}:
                    out = self._engine("incremental_connected_components",
                                       g, (g, held), {}, store)
            else:                     # label_propagation
                if not set(params) - {"n_iter", "backend"}:
                    out = self._engine(
                        "incremental_label_propagation", g, (g, held),
                        {"n_iter": params.get("n_iter", 20)}, store)
        except Exception:
            _log.exception("warm_start.failed", op=op, session=q.session,
                           action="running cold")
            out = None
        if out is None:
            self._bump("incremental_fallbacks")
            _log.info("incremental_fallback", op=op, session=q.session)
        else:
            self._bump("warm_starts")
        return None if out is None else self._block(out)

    def _run_group(self, group: List[QueuedRequest]) -> float:
        """Execute one engine call for ``group``; returns measured engine ms.

        A singleton non-fusable request calls its op directly.  A fused
        group shares every parameter except ``source`` and ``n_iter``:
        mixed depths run as ONE batch to the max cap with each row frozen
        at its own — bit-identical to running every request sequentially at
        its own depth — and rows scatter back per request.
        """
        if not group:
            return 0.0
        with self._on_device():
            return self._run_group_on_device(group)

    @staticmethod
    def _keep(group: List[QueuedRequest]) -> List[Tuple[Tuple, Optional[int]]]:
        """What the followers keep of a call for ``group``: each member's
        result (row ``i`` of a fused call) under its cache key, for the
        ops a later warm start may read."""
        if group[0].op not in _WARM_OPS:
            return []
        if len(group) == 1:
            return [(group[0].cache_key, None)]
        return [(m.cache_key, i) for i, m in enumerate(group)]

    def _call_op(self, q: QueuedRequest) -> Any:
        """A non-fused request's call of its op."""
        inputs = dict(q.payload["inputs"])
        g = inputs.get("g")
        if q.op in _BACKEND_OPS and isinstance(g, Graph):
            return self._engine(q.op, g, (), dict(inputs, **q.payload["params"]),
                                self._keep([q]))
        fn, _ = _OPS[q.op]
        return fn(**inputs, **q.payload["params"])

    def _run_group_on_device(self, group: List[QueuedRequest]) -> float:
        q0 = group[0]
        op = q0.op
        self._bump("engine_calls")
        if len(group) > 1:
            self._bump("fused_calls")
            self._bump("fused_requests", len(group))
        if q0.fuse_key is None:
            t0 = time.perf_counter()
            with obs.TRACER.span(f"engine.{op}", trace=q0.pending.trace,
                                 op=op, batch=1, session=q0.session) as esp:
                out = self._try_warm(q0)
                if out is None:
                    esp.set(warm=False)
                    out = self._block(self._call_op(q0))
                    dt = (time.perf_counter() - t0) * 1e3
                    prov.annotate_last(out, self._sched_meta(q0, 1))
                else:
                    # warm-started: the recorded provenance is the equivalent
                    # cold call (the warm init would be an opaque array), with
                    # the warm start visible only as metadata
                    esp.set(warm=True)
                    dt = (time.perf_counter() - t0) * 1e3
                    meta = dict(self._sched_meta(q0, 1), incremental=True)
                    prov.record_call(_PROV_ANY[op], q0.payload["inputs"],
                                     q0.payload["params"], out, meta=meta)
            self._cache_put(q0.cache_key, out)
            self._finish(q0.pending, out)
            return dt
        src_param = _FUSABLE[op]
        g = q0.payload["graph"]   # pinned at submit: the version keys name
        params = dict(q0.payload["params"])
        params.pop(src_param, None)
        params.pop("n_iter", None)
        sources = [m.payload["source"] for m in group]
        n_iters = [m.payload["n_iter"] for m in group]
        if len(group) == 1:
            kw = dict(params)
            if n_iters[0] is not None:
                kw["n_iter"] = n_iters[0]
            t0 = time.perf_counter()
            with obs.TRACER.span(f"engine.{op}", trace=q0.pending.trace,
                                 op=op, batch=1, session=q0.session) as esp:
                out = self._try_warm(q0)
                if out is None:
                    esp.set(warm=False)
                    out = self._block(self._engine(
                        op, g, (g, sources[0]), kw, self._keep(group)))
                    dt = (time.perf_counter() - t0) * 1e3
                    prov.annotate_last(out, self._sched_meta(q0, 1))
                else:
                    esp.set(warm=True)
                    dt = (time.perf_counter() - t0) * 1e3
                    meta = dict(self._sched_meta(q0, 1), incremental=True)
                    prov.record_call(_PROV_ANY[op], [("g", g)],
                                     {**kw, src_param: sources[0]}, out,
                                     meta=meta)
            self._cache_put(q0.cache_key, out)
            self._finish(q0.pending, out)
            return dt
        default = _FUSE_DEPTH_DEFAULT[op]
        if default is None:
            default = g.n_nodes            # convergence bound for bfs/sssp
        uniform = len(set(n_iters)) == 1
        if uniform and n_iters[0] is None:
            kw = dict(params)              # all-unbounded: plain fused call
        elif uniform:
            kw = dict(params, n_iter=n_iters[0])
        else:
            caps = [default if ni is None else int(ni) for ni in n_iters]
            kw = dict(params, n_iter=np.asarray(caps, np.int32))
        t0 = time.perf_counter()
        with obs.TRACER.span(
                f"engine.{op}", trace=q0.pending.trace,
                traces=[m.pending.trace for m in group
                        if m.pending.trace is not None],
                op=op, batch=len(group),
                sources=sources if len(sources) <= 16 else len(sources)):
            rows = self._block(self._engine(
                op, g, (g, torch.tensor(sources, dtype=torch.int32,
                                        device=g.device)), kw,
                self._keep(group)))
        dt = (time.perf_counter() - t0) * 1e3
        for i, m in enumerate(group):
            row = rows[i]
            # the row's provenance is the *single-source* call it stands
            # for — export/replay must not see the fusion batch; the batch
            # shows up only as scheduling metadata on the record
            req_params = {**params, src_param: m.payload["source"]}
            if m.payload["n_iter"] is not None:
                req_params["n_iter"] = int(m.payload["n_iter"])
            prov.record_call(_PROV_OP[op], [("g", g)], req_params, row,
                             meta=self._sched_meta(m, len(group)))
            self._cache_put(m.cache_key, row)
            self._finish(m.pending, row, fused=True)
        return dt

    # -- draining -----------------------------------------------------------
    def flush(self) -> None:
        """Drain the scheduler inline: admission-passed requests execute in
        fair-share (or FIFO) order, coalescing whatever is compatible."""
        self.scheduler.drain()

    def _ensure_progress(self) -> None:
        """Called by :meth:`Pending.result`: inline services drain; worker-
        backed ones rely on their threads."""
        if not self._worker_threads:
            self.scheduler.drain()

    def _finish(self, p: Pending, value: Any, cached: bool = False,
                fused: bool = False) -> None:
        bind = p.request.get("as")
        if bind:
            p.session.put(bind, value)
        p._resolve(value=value, cached=cached, fused=fused)
