"""Remote client: the in-process Workspace API over a socket.

:class:`RemoteService` / :class:`RemoteWorkspace` / :class:`RemoteSession` /
:class:`RemotePending` mirror :class:`~repro_torch.serve.graph_service.
GraphService` / ``Workspace`` / ``Session`` / ``Pending`` closely enough
that the §4.1 expert-finding workload (``examples/stackoverflow_experts.
py``) runs unchanged against either transport:

* ``submit`` is synchronous admission — a server-side quota or queue-depth
  rejection raises :class:`~repro_torch.serve.policy.RejectedError` *at the call
  site* with its ``retry_after``, exactly like the in-process path;
* results stream back **out of order** (request ids, not call order); a
  background reader demultiplexes RESULT frames into the right
  :class:`RemotePending`;
* every object crossing the wire carries its provenance chain and version
  token; the client *adopts* them (:func:`repro_torch.core.provenance.
  adopt_records`), so ``records_of``/``export_script`` on a remotely
  computed table behave as if the computation had happened here.  Roots the
  client itself ``put`` are bound to the server-assigned token, which is
  what lets ``export_script(embed_roots=True)`` embed the local copy;
* errors arrive as typed frames: ``DeadlineExpired``, ``ServiceError``,
  ``KeyError`` (missing names) come back as those exceptions.

The client is thread-safe: many threads may submit/await on one connection
(the benchmark's closed-loop workers do).  It never imports the engine:
arrays decode to numpy, and only the Tables and Graphs it receives are
built, on the client's ``device=`` (default: the card, as everywhere in
the port; ``"cpu"`` by name).
"""

from __future__ import annotations

import itertools
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from .. import obs
from ..device import DeviceLike, resolve
from . import wire
from .policy import ServiceError, error_from_wire

__all__ = ["RemoteService", "RemoteWorkspace", "RemoteSession",
           "RemotePending", "connect"]


class RemotePending:
    """Client-side handle for a submitted request (mirrors ``Pending``)."""

    def __init__(self, service: "RemoteService", request: Dict[str, Any],
                 trace: Optional[str] = None):
        self.service = service
        self.request = request
        #: trace id this submit rode the wire under; pass it to
        #: ``RemoteService.chrome_trace`` to fetch the server-side spans of
        #: exactly this request
        self.trace = trace
        self.done = False
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.cached = False
        self.fused = False
        self.queued_ms: Optional[float] = None
        self.submitted_at = time.perf_counter()
        self.completed_at: Optional[float] = None
        self._event = threading.Event()

    @property
    def latency_ms(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return (self.completed_at - self.submitted_at) * 1e3

    def _resolve(self, value: Any = None,
                 error: Optional[BaseException] = None,
                 cached: bool = False, fused: bool = False,
                 queued_ms: Optional[float] = None) -> None:
        self.value, self.error = value, error
        self.cached, self.fused, self.queued_ms = cached, fused, queued_ms
        self.completed_at = time.perf_counter()
        self.done = True
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self.done:
            self.service._ensure_progress()
            if not self._event.wait(timeout):
                raise TimeoutError(
                    f"request {self.request.get('op')!r} still pending "
                    f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.value


class _RpcWaiter:
    __slots__ = ("event", "ftype", "payload")

    def __init__(self):
        self.event = threading.Event()
        self.ftype: Optional[int] = None
        self.payload: Any = None


class RemoteService:
    """One socket connection to a :class:`~repro_torch.serve.server.GraphServer`.

    Mirrors the ``GraphService`` surface the examples and benchmarks use:
    ``.workspace``, ``.session(name)``, ``.submit/.execute`` (via sessions),
    ``.flush()``, ``.stats``, ``.close()``, ``.device`` (where the Tables
    and Graphs it receives are built).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 timeout: float = 120.0, device: DeviceLike = None):
        self.device = resolve(device)
        self.host, self.port = host, port
        self.rpc_timeout = timeout
        self._sock = socket.create_connection((host, port), timeout=30.0)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._req_seq = itertools.count(1)
        self._rpcs: Dict[int, _RpcWaiter] = {}
        self._pendings: Dict[int, RemotePending] = {}
        self._sessions: Dict[str, RemoteSession] = {}
        self._closed = threading.Event()
        self._conn_error: Optional[BaseException] = None
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="remote-service-reader")
        self._reader.start()
        try:
            hello = self._rpc("hello", protocol=wire.PROTOCOL_VERSION)
        except BaseException:
            self.close()         # don't leak the socket + reader thread on
            raise                # a failed handshake (retry loops reconnect)
        self.conn_id = hello["conn"]
        self.server_workers = int(hello.get("workers", 0))
        self.server_pid = hello.get("pid")
        self.workspace = RemoteWorkspace(self)

    # -- plumbing ------------------------------------------------------------
    def _next_id(self) -> int:
        return next(self._req_seq)

    def _send(self, req_id: int, msg: Dict[str, Any]) -> None:
        if self._closed.is_set():
            raise ServiceError("remote service connection is closed")
        with self._send_lock:
            wire.send_frame(self._sock, wire.FrameType.REQUEST, req_id, msg)

    def _rpc(self, kind: str, **fields: Any) -> Dict[str, Any]:
        req_id = self._next_id()
        waiter = _RpcWaiter()
        with self._lock:
            self._rpcs[req_id] = waiter
        try:
            self._send(req_id, wire.attach_trace({"kind": kind, **fields},
                                                 obs.current_trace()))
            if not waiter.event.wait(self.rpc_timeout):
                raise TimeoutError(f"rpc {kind!r} timed out after "
                                   f"{self.rpc_timeout}s")
        finally:
            with self._lock:
                self._rpcs.pop(req_id, None)
        if waiter.ftype == wire.FrameType.ERROR:
            raise error_from_wire(waiter.payload)
        return waiter.payload

    def _read_loop(self) -> None:
        try:
            while not self._closed.is_set():
                frame = wire.read_frame(self._sock, device=self.device)
                if frame is None:
                    break
                ftype, req_id, payload = frame
                if ftype in (wire.FrameType.OK, wire.FrameType.ERROR):
                    with self._lock:
                        waiter = self._rpcs.get(req_id)
                        pending = (self._pendings.pop(req_id, None)
                                   if ftype == wire.FrameType.ERROR else None)
                    if waiter is not None:
                        waiter.ftype, waiter.payload = ftype, payload
                        waiter.event.set()
                    # a submit rejected server-side also kills its pending
                    if pending is not None and waiter is None:
                        pending._resolve(error=error_from_wire(payload))
                elif ftype == wire.FrameType.RESULT:
                    with self._lock:
                        pending = self._pendings.pop(req_id, None)
                    if pending is not None:
                        self._deliver(pending, payload)
        except (OSError, wire.WireError) as e:
            self._conn_error = e
        finally:
            self._fail_all(self._conn_error
                           or ServiceError("connection closed"))

    def _deliver(self, pending: RemotePending, payload: Dict[str, Any]
                 ) -> None:
        if "error" in payload:
            pending._resolve(error=error_from_wire(payload["error"]),
                             queued_ms=payload.get("queued_ms"))
            return
        try:
            value = wire.unpack_object(payload["result"])
        except Exception as e:
            pending._resolve(error=e)
            return
        pending._resolve(value=value, cached=bool(payload.get("cached")),
                         fused=bool(payload.get("fused")),
                         queued_ms=payload.get("queued_ms"))

    def _fail_all(self, exc: BaseException) -> None:
        self._closed.set()
        with self._lock:
            rpcs, self._rpcs = dict(self._rpcs), {}
            pendings, self._pendings = dict(self._pendings), {}
        for waiter in rpcs.values():
            waiter.ftype = wire.FrameType.ERROR
            waiter.payload = {"etype": "ServiceError", "message": str(exc)}
            waiter.event.set()
        for p in pendings.values():
            if not p.done:
                p._resolve(error=exc)

    def _ensure_progress(self) -> None:
        """Mirror of ``GraphService._ensure_progress``: against a worker-less
        (inline) server, an un-flushed result would wait forever — nudge the
        server to drain.  Worker-backed servers stream on their own."""
        if self.server_workers == 0 and not self._closed.is_set():
            try:
                self._rpc("flush")
            except Exception:
                pass

    # -- GraphService mirror -------------------------------------------------
    def session(self, name: str) -> "RemoteSession":
        with self._lock:
            if name not in self._sessions:
                self._sessions[name] = RemoteSession(self, name)
            return self._sessions[name]

    def submit(self, session: "RemoteSession",
               request: Dict[str, Any]) -> RemotePending:
        req_id = self._next_id()
        # every remote submit rides under a trace id: an explicit one in the
        # request, the calling thread's active trace, or a fresh mint — the
        # id the server's spans and the result's provenance meta carry
        trace = (request.get("trace") or obs.current_trace()
                 or obs.new_trace_id())
        pending = RemotePending(self, dict(request), trace=trace)
        with self._lock:
            self._pendings[req_id] = pending
        waiter = _RpcWaiter()
        with self._lock:
            self._rpcs[req_id] = waiter
        try:
            self._send(req_id, wire.attach_trace(
                {"kind": "submit", "session": session.name,
                 "request": request}, trace))
            if not waiter.event.wait(self.rpc_timeout):
                raise TimeoutError("submit rpc timed out")
        except BaseException:
            with self._lock:           # don't leak the orphaned pending
                self._pendings.pop(req_id, None)
            raise
        finally:
            with self._lock:
                self._rpcs.pop(req_id, None)
        if waiter.ftype == wire.FrameType.ERROR:
            with self._lock:
                self._pendings.pop(req_id, None)
            raise error_from_wire(waiter.payload)
        return pending

    def execute(self, session: "RemoteSession",
                request: Dict[str, Any]) -> Any:
        p = self.submit(session, request)
        self.flush()
        return p.result(timeout=self.rpc_timeout)

    def flush(self) -> None:
        """Drain an inline (worker-less) server; no-op when the server runs
        scheduler workers — results stream on their own there, and an
        inline drain would occupy the server's reader thread with engine
        work, head-of-line blocking this connection's other RPCs."""
        if self.server_workers == 0:
            self._rpc("flush")

    @property
    def stats(self) -> Dict[str, Any]:
        return self._rpc("stats")["stats"]

    def session_stats(self, name: str) -> Dict[str, Any]:
        return self._rpc("session_stats", session=name)["stats"]

    # -- observability -------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """Server-side metrics snapshot (``repro_torch.obs`` registry dict)."""
        return self._rpc("obs_metrics")["metrics"]

    def metrics_text(self) -> str:
        """Server-side metrics in Prometheus text exposition format."""
        return self._rpc("obs_metrics", fmt="prom")["text"]

    def chrome_trace(self, trace: Optional[str] = None,
                     path: Optional[str] = None) -> Dict[str, Any]:
        """Server-side Chrome trace-event JSON (``chrome://tracing``).

        ``trace`` filters to one trace id — pass a ``RemotePending.trace``
        to see exactly that request's journey through admission, queueing,
        batching and the engine.  ``path`` writes the JSON to a local file.
        """
        doc = self._rpc("obs_trace", trace=trace)["trace_events"]
        if path is not None:
            import json
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def health(self) -> Dict[str, Any]:
        """Server-side SLO verdict: ``{"status": "ok|degraded|breaching",
        "ops": {...}, "reasons": [...]}`` (see ``repro_torch.obs.slo``)."""
        return self._rpc("health")["health"]

    def slo_report(self) -> Dict[str, Any]:
        """Server-side SLO window report: per-op rates, burn rate,
        windowed quantiles, configured objectives."""
        return self._rpc("slo_report")["report"]

    def debug_bundle(self, path: Optional[str] = None, *,
                     trace: Optional[str] = None) -> Dict[str, Any]:
        """Fetch the server's postmortem bundle (metrics, Chrome trace,
        flight-recorder exemplars, SLO state, profile report, log tail).

        ``trace`` narrows the embedded Chrome trace to one trace id;
        ``path`` writes the bundle JSON to a local file — the artifact
        ``python -m repro_torch.obs.report --bundle <path>`` renders.
        """
        bundle = self._rpc("debug_bundle", trace=trace)["bundle"]
        if path is not None:
            import json
            with open(path, "w") as f:
                json.dump(bundle, f)
        return bundle

    def profile_report(self) -> str:
        """Text table of the server's ``engine.profile.*`` instruments,
        rendered locally from the shipped metrics snapshot."""
        from ..obs.profile import profile_report
        return profile_report(self.metrics())

    def shutdown_server(self) -> None:
        """Ask the server process to drain and exit (if it allows it).

        The ack inherently races the teardown it requests; losing the
        connection after the request was sent counts as success.  Genuine
        refusals (shutdown disabled) still raise.
        """
        try:
            self._rpc("shutdown")
        except ServiceError as e:
            if "connection closed" not in str(e):
                raise

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=5.0)

    def __enter__(self) -> "RemoteService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class RemoteWorkspace:
    """Mirror of :class:`~repro_torch.serve.graph_service.Workspace` over RPC.

    ``put`` keeps a local mirror reference and binds the local object to the
    server-assigned version token — the client-side root registry that lets
    ``export_script`` embed roots of remotely computed results.
    """

    def __init__(self, service: RemoteService):
        self.service = service
        self._mirror: Dict[str, Any] = {}

    def put(self, name: str, obj: Any) -> str:
        from ..core import provenance as prov
        reply = self.service._rpc("ws_put", name=name,
                                  obj=wire.pack_object(obj))
        version = reply["version"]
        prov.bind_version(obj, version)
        self._mirror[name] = obj
        return version

    def get(self, name: str) -> Any:
        return wire.unpack_object(self.service._rpc("ws_get",
                                                    name=name)["obj"])

    def version(self, name: str) -> str:
        return self.service._rpc("ws_version", name=name)["version"]

    def names(self) -> List[str]:
        return list(self.service._rpc("ws_names")["names"])

    def update(self, name: str, fn: Any) -> str:
        raise ServiceError(
            "functional updates cannot cross the wire (callables have no "
            "wire form); run updates server-side, put() a fresh object, or "
            "apply_delta() for edge inserts/deletes")

    def apply_delta(self, name: str, delta: Any) -> str:
        """Apply an :class:`~repro_torch.core.graph.EdgeDelta` to a workspace
        graph server-side; returns the new version token.

        The one functional update with a wire form: the delta ships as four
        plain arrays and the server runs ``Workspace.apply_delta``, so the
        published child keeps its delta lineage — plan patching, cache
        retention and warm-start recomputation behave exactly as for an
        in-process update.  The local mirror (if any) is refreshed too, so
        ``export_script`` root embedding keeps working after updates.
        """
        cols = {c: getattr(delta, c).cpu().numpy().astype("int32")
                for c in ("add_src", "add_dst", "del_src", "del_dst")}
        reply = self.service._rpc("ws_apply_delta", name=name, **cols)
        version = reply["version"]
        if name in self._mirror:
            from ..core import provenance as prov
            new = self._mirror[name].apply_delta(delta)
            prov.bind_version(new, version)
            self._mirror[name] = new
        return version

    def __contains__(self, name: str) -> bool:
        return name in self.names()


class RemoteSession:
    """Mirror of :class:`~repro_torch.serve.graph_service.Session` over RPC."""

    def __init__(self, service: RemoteService, name: str):
        self.service = service
        self.name = name
        self._mirror: Dict[str, Any] = {}

    def put(self, name: str, obj: Any) -> str:
        from ..core import provenance as prov
        reply = self.service._rpc("sess_put", session=self.name, name=name,
                                  obj=wire.pack_object(obj))
        version = reply["version"]
        prov.bind_version(obj, version)
        self._mirror[name] = obj
        return version

    def get(self, name: str) -> Any:
        return wire.unpack_object(
            self.service._rpc("sess_get", session=self.name,
                              name=name)["obj"])

    def publish(self, name: str) -> str:
        reply = self.service._rpc("publish", session=self.name, name=name)
        if name in self._mirror:
            self.service.workspace._mirror[name] = self._mirror.pop(name)
        return reply["version"]

    def local_names(self) -> List[str]:
        return list(self.service._rpc("local_names",
                                      session=self.name)["names"])

    def submit(self, request: Dict[str, Any]) -> RemotePending:
        return self.service.submit(self, request)

    def execute(self, request: Dict[str, Any]) -> Any:
        return self.service.execute(self, request)


def connect(host: str = "127.0.0.1", port: int = 0, *,
            timeout: float = 120.0, device: DeviceLike = None
            ) -> RemoteService:
    """``connect(host, port)`` — the one-call client entry point."""
    return RemoteService(host, port, timeout=timeout, device=device)
