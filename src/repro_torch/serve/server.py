"""Threaded socket server: the cross-process front door to one GraphService.

Ringo's §2.1 deployment is many analysts sharing one big-memory machine.
This module puts the service's scheduler seam on a TCP socket (the
reference's ``serve/server.py``, speaking the same wire protocol; Tables
and Graphs that clients send are built on the service's device, the card
by default): decoded requests feed
straight into :meth:`GraphService.submit` — admission control (quota /
queue-depth :class:`RejectedError` with ``retry_after``), deadline drops,
deficit-round-robin fair share and batching windows all apply unchanged to
remote clients, which for the first time are *genuinely concurrent
independent processes*.

Design:

* one **accept thread**; per connection one **reader thread** (decodes
  frames, dispatches RPCs — all cheap: admission, namespace ops; never an
  engine call) and one **writer thread** draining an outbox queue, so a
  slow client can't block the scheduler and results stream the moment they
  resolve;
* each connection gets its own session namespace: client session ``name``
  maps to service session ``"c<N>/name"``, so two client processes using
  the same session name stay isolated and fair-share treats them as
  distinct principals.  The workspace, result cache and fusion scheduler
  are shared — that's the point;
* **out-of-order streaming**: ``submit`` replies immediately (admission
  verdict), and the result arrives later as a RESULT frame carrying the
  submit's request id — whichever order the scheduler resolves them;
* **graceful shutdown** drains the scheduler (flush + wait-idle) before
  closing sockets, so accepted work is never dropped mid-stream.

``python -m repro_torch.serve.server`` runs a standalone server on the
card (``--device cpu`` to run on the CPU; without a card and without it
the process exits non-zero); ``--rmat-scale`` pre-publishes a shared RMAT
graph, and the process prints ``RINGO-SERVE LISTENING <port>`` once ready
so parents can spawn it on an ephemeral port.
"""

from __future__ import annotations

import argparse
import itertools
import os
import queue
import socket
import subprocess
import sys
import threading
from typing import Any, Dict, Optional, Tuple

from .. import obs
from ..device import DeviceLike
from . import wire
from .graph_service import EdgeDelta, GraphService, Session
from .policy import SchedulerPolicy, error_to_wire

__all__ = ["GraphServer", "spawn_server", "main"]


class _Connection:
    """One client socket: reader dispatch + writer queue."""

    def __init__(self, server: "GraphServer", sock: socket.socket,
                 conn_id: str):
        self.server = server
        self.sock = sock
        self.conn_id = conn_id
        self.outbox: "queue.Queue[Optional[Tuple[int, int, Any]]]" = \
            queue.Queue()
        self.closed = threading.Event()
        self.sessions: Dict[str, Session] = {}
        # trace id of the frame currently being dispatched; only the one
        # reader thread of this connection ever touches it
        self._trace: Optional[str] = None
        self.reader = threading.Thread(target=self._read_loop, daemon=True,
                                       name=f"serve-read-{conn_id}")
        self.writer = threading.Thread(target=self._write_loop, daemon=True,
                                       name=f"serve-write-{conn_id}")

    def start(self) -> None:
        self.reader.start()
        self.writer.start()

    # -- session mapping -----------------------------------------------------
    def _session(self, name: str) -> Session:
        key = f"{self.conn_id}/{name}"
        if key not in self.sessions:
            self.sessions[key] = self.server.service.session(key)
        return self.sessions[key]

    # -- outbound ------------------------------------------------------------
    def send(self, ftype: int, req_id: int, payload: Any) -> None:
        if not self.closed.is_set():
            self.outbox.put((ftype, req_id, payload))

    def _write_loop(self) -> None:
        while True:
            item = self.outbox.get()
            if item is None:
                break
            ftype, req_id, payload = item
            try:
                wire.send_frame(self.sock, ftype, req_id, payload)
            except (OSError, wire.WireError):
                break
        self._teardown()

    # -- inbound -------------------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while not self.server._stop.is_set():
                frame = wire.read_frame(self.sock,
                                        self.server.max_frame_bytes,
                                        device=self.server.service.device)
                if frame is None:
                    break                      # clean EOF
                ftype, req_id, msg = frame
                if ftype != wire.FrameType.REQUEST:
                    raise wire.WireError(
                        f"client sent non-request frame type {ftype}")
                self._dispatch(req_id, msg)
        except wire.WireError as e:
            # a peer speaking garbage gets one typed error, then the door
            self.send(wire.FrameType.ERROR, 0, error_to_wire(e))
        except OSError:
            pass
        finally:
            # normal disconnect: stop the writer once the queue drains.
            # During server shutdown the writer must OUTLIVE the reader —
            # the drain phase still streams RESULT frames — so shutdown()
            # enqueues the sentinel itself, after draining.
            if not self.server._stop.is_set():
                self.outbox.put(None)          # stop writer -> teardown

    def _teardown(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        try:
            self.sock.close()
        except OSError:
            pass
        for key in list(self.sessions):
            self.server.service.end_session(key)
        self.server._forget(self)

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, req_id: int, msg: Any) -> None:
        if not isinstance(msg, dict):
            raise wire.WireError("request payload must be a dict")
        self._trace = wire.extract_trace(msg)
        kind = msg.get("kind")
        handler = getattr(self, f"_op_{kind}", None)
        if handler is None:
            self.send(wire.FrameType.ERROR, req_id, {
                "etype": "ServiceError",
                "message": f"unknown request kind {kind!r}"})
            return
        try:
            with obs.TRACER.span(f"rpc.{kind}", trace=self._trace,
                                 conn=self.conn_id, cat="rpc"):
                reply = handler(req_id, msg)
        except Exception as e:
            self.send(wire.FrameType.ERROR, req_id, error_to_wire(e))
            return
        if reply is not None:
            self.send(wire.FrameType.OK, req_id, reply)

    # -- RPC handlers --------------------------------------------------------
    def _op_hello(self, req_id: int, msg: dict) -> dict:
        peer = int(msg.get("protocol", -1))
        if peer != wire.PROTOCOL_VERSION:
            raise wire.WireError(
                f"client speaks protocol {peer}, server speaks "
                f"{wire.PROTOCOL_VERSION}")
        return {"protocol": wire.PROTOCOL_VERSION, "conn": self.conn_id,
                "workers": len(self.server.service._worker_threads),
                "pid": os.getpid()}

    def _op_ws_put(self, req_id: int, msg: dict) -> dict:
        obj = wire.unpack_object(msg["obj"])
        return {"version": self.server.service.workspace.put(
            msg["name"], obj)}

    def _op_ws_get(self, req_id: int, msg: dict) -> dict:
        obj = self.server.service.workspace.get(msg["name"])
        return {"obj": wire.pack_object(obj)}

    def _op_ws_names(self, req_id: int, msg: dict) -> dict:
        return {"names": self.server.service.workspace.names()}

    def _op_ws_version(self, req_id: int, msg: dict) -> dict:
        return {"version": self.server.service.workspace.version(
            msg["name"])}

    def _op_ws_apply_delta(self, req_id: int, msg: dict) -> dict:
        # the only functional update that CAN cross the wire: the delta is
        # plain data, and the server applies it on the CAS update path so
        # the child graph keeps its lineage (plan patching, cache retention
        # and warm starts all engage exactly as for an in-process update)
        delta = EdgeDelta(add_src=msg.get("add_src", ()),
                          add_dst=msg.get("add_dst", ()),
                          del_src=msg.get("del_src", ()),
                          del_dst=msg.get("del_dst", ()))
        return {"version": self.server.service.workspace.apply_delta(
            msg["name"], delta)}

    def _op_sess_put(self, req_id: int, msg: dict) -> dict:
        obj = wire.unpack_object(msg["obj"])
        return {"version": self._session(msg["session"]).put(
            msg["name"], obj)}

    def _op_sess_get(self, req_id: int, msg: dict) -> dict:
        obj = self._session(msg["session"]).get(msg["name"])
        return {"obj": wire.pack_object(obj)}

    def _op_publish(self, req_id: int, msg: dict) -> dict:
        return {"version": self._session(msg["session"]).publish(
            msg["name"])}

    def _op_local_names(self, req_id: int, msg: dict) -> dict:
        return {"names": self._session(msg["session"]).local_names()}

    def _op_submit(self, req_id: int, msg: dict) -> Optional[dict]:
        sess = self._session(msg["session"])
        # raises RejectedError / ServiceError -> typed ERROR frame; the
        # client's submit() sees the same admission verdict an in-process
        # caller would, retry_after included
        pending = self.server.service.submit(sess, dict(msg["request"]),
                                             trace=self._trace)
        self.send(wire.FrameType.OK, req_id, {"submitted": True})
        pending.add_done_callback(
            lambda p, rid=req_id: self._stream_result(rid, p))
        return None                      # OK already sent, ordered first

    def _stream_result(self, req_id: int, p: Any) -> None:
        """Pending resolution -> RESULT frame (runs on the resolver)."""
        if p.error is not None:
            payload: Dict[str, Any] = {"error": error_to_wire(p.error)}
        else:
            payload = {"result": wire.pack_object(p.value)}
        payload.update(cached=p.cached, fused=p.fused,
                       queued_ms=p.queued_ms)
        self.send(wire.FrameType.RESULT, req_id, payload)

    def _op_flush(self, req_id: int, msg: dict) -> dict:
        self.server.service.flush()
        return {}

    def _op_stats(self, req_id: int, msg: dict) -> dict:
        with self.server.service._stats_lock:
            return {"stats": dict(self.server.service.stats)}

    def _op_obs_metrics(self, req_id: int, msg: dict) -> dict:
        """Server-side metrics snapshot: ``fmt="json"`` (default) ships the
        registry snapshot dict, ``fmt="prom"`` the Prometheus text."""
        if msg.get("fmt") == "prom":
            return {"text": obs.dump_metrics("prom")}
        return {"metrics": obs.dump_metrics("json")}

    def _op_obs_trace(self, req_id: int, msg: dict) -> dict:
        """Chrome trace-event JSON of the server's span buffer; ``trace``
        filters to one trace id (how a client fetches its own requests)."""
        return {"trace_events":
                obs.export_chrome_trace(trace=msg.get("trace"))}

    def _op_health(self, req_id: int, msg: dict) -> dict:
        """Rolling-window SLO verdict (``ok|degraded|breaching`` overall
        and per op, with machine-readable reasons)."""
        return {"health": obs.health()}

    def _op_slo_report(self, req_id: int, msg: dict) -> dict:
        """Full SLO window: per-op rates, burn, quantiles, objectives."""
        return {"report": obs.slo_report()}

    def _op_debug_bundle(self, req_id: int, msg: dict) -> dict:
        """Postmortem bundle: metrics, trace (optionally filtered to
        ``trace``), flight-recorder exemplars, SLO state, profile report,
        log tail, config/versions — one plain JSON-safe tree."""
        return {"bundle": obs.debug_bundle(trace=msg.get("trace"))}

    def _op_session_stats(self, req_id: int, msg: dict) -> dict:
        key = f"{self.conn_id}/{msg['session']}"
        return {"stats": self.server.service.session_stats(key)}

    def _op_shutdown(self, req_id: int, msg: dict) -> Optional[dict]:
        if not self.server.allow_remote_shutdown:
            raise PermissionError("remote shutdown disabled on this server")
        # reply BEFORE spawning the shutdown thread: it will stop this
        # connection's writer, and the ack must already be in its queue
        self.send(wire.FrameType.OK, req_id, {"stopping": True})
        threading.Thread(target=self.server.shutdown, daemon=True,
                         name="serve-shutdown").start()
        return None


class GraphServer:
    """Accepts connections and serves one shared :class:`GraphService`."""

    def __init__(self, service: Optional[GraphService] = None,
                 host: str = "127.0.0.1", port: int = 0, *,
                 max_frame_bytes: int = wire.MAX_FRAME_BYTES,
                 allow_remote_shutdown: bool = True,
                 drain_timeout_s: float = 30.0,
                 device: DeviceLike = None):
        self.service = service if service is not None \
            else GraphService(workers=2, device=device)
        self.max_frame_bytes = max_frame_bytes
        self.allow_remote_shutdown = allow_remote_shutdown
        self.drain_timeout_s = drain_timeout_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._done = threading.Event()
        self._conn_seq = itertools.count(1)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "GraphServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="serve-accept")
        self._accept_thread.start()
        return self

    def serve_forever(self) -> None:
        """Start (if needed) and block until :meth:`shutdown`."""
        if self._accept_thread is None:
            self.start()
        self._done.wait()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._sock.accept()
            except OSError:
                break                       # listening socket closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(self, sock, f"c{next(self._conn_seq)}")
            with self._conns_lock:
                self._conns.add(conn)
            conn.start()

    def _forget(self, conn: _Connection) -> None:
        with self._conns_lock:
            self._conns.discard(conn)

    def shutdown(self, *, drain: bool = True) -> None:
        """Stop accepting, drain the scheduler, close everything.

        ``drain=True`` (the default) is the graceful path: every admitted
        request executes and its RESULT frame is flushed before sockets
        close.  Idempotent.
        """
        if self._stop.is_set():
            self._done.set()
            return
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        me = threading.current_thread()
        # stop readers FIRST (no new submits can slip in behind the drain):
        # SHUT_RD unblocks read_frame with EOF; readers see _stop set and
        # exit without stopping their writers
        for conn in conns:
            try:
                conn.sock.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        for conn in conns:
            if conn.reader.is_alive() and conn.reader is not me:
                conn.reader.join(timeout=5.0)
        if drain:
            self.service.flush()
            self.service.scheduler.wait_idle(timeout=self.drain_timeout_s)
        for conn in conns:
            conn.outbox.put(None)           # writer flushes queue, then dies
        for conn in conns:
            if conn.writer.is_alive() and conn.writer is not me:
                conn.writer.join(timeout=5.0)
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
        self.service.close()
        self._done.set()


# ---------------------------------------------------------------------------
# subprocess helper + CLI
# ---------------------------------------------------------------------------

_READY = "RINGO-SERVE LISTENING"


def spawn_server(extra_args: Tuple[str, ...] = (), *,
                 timeout: float = 120.0) -> Tuple[Any, int]:
    """Spawn ``python -m repro_torch.serve.server`` and wait for its port.

    Returns ``(Popen, port)``; the child prints ``RINGO-SERVE LISTENING
    <port>`` once its accept loop is live.  Used by the benchmark, the CI
    smoke stage and the remote example — anything that needs a genuinely
    separate server process on an ephemeral port.
    """
    src_dir = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_dir + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.server", "--port", "0",
         *extra_args],
        stdout=subprocess.PIPE, text=True, env=env)
    assert proc.stdout is not None
    # One thread reads the child's stdout for its whole life, so its prints
    # never block it.  Waiting on the pipe with select() instead misses a
    # READY line that arrived in the same read as the line before it: that
    # line sits in the text buffer, and the pipe stays empty.
    lines: "queue.Queue[Optional[str]]" = queue.Queue()
    ready = threading.Event()

    def _read(out):
        for text in out:
            if not ready.is_set():
                lines.put(text)
        lines.put(None)

    threading.Thread(target=_read, args=(proc.stdout,), daemon=True).start()
    import time as _time
    deadline = _time.monotonic() + timeout
    while True:
        try:
            line = lines.get(timeout=max(deadline - _time.monotonic(), 0.0))
        except queue.Empty:
            proc.kill()
            raise TimeoutError("server subprocess never reported its port")
        if line is None:
            raise RuntimeError(
                f"server subprocess exited early (rc={proc.wait()})")
        if line.startswith(_READY):
            ready.set()
            return proc, int(line.split()[-1])


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Standalone Ringo graph-analytics server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral; the bound port is printed")
    ap.add_argument("--workers", type=int, default=2,
                    help="scheduler worker threads (>=1 so results stream "
                         "without client flushes)")
    ap.add_argument("--mode", choices=("fair", "fifo"), default="fair")
    ap.add_argument("--rmat-scale", type=int, default=None,
                    help="pre-publish an RMAT graph of 2^SCALE nodes")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--publish", default="g",
                    help="workspace name for the pre-published graph")
    ap.add_argument("--no-remote-shutdown", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the service computes (default: the card; "
                         "'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    service = GraphService(policy=SchedulerPolicy(mode=args.mode),
                           workers=max(args.workers, 0), device=args.device)
    if args.rmat_scale is not None:
        from ..core.graph import Graph
        from ..data.rmat import rmat_edges
        src, dst = rmat_edges(args.rmat_scale, edge_factor=args.edge_factor,
                              seed=args.seed)
        g = Graph.from_edges(src, dst, device=service.device)
        g.plan()                         # warm the shared plan once
        service.workspace.put(args.publish, g)
        print(f"published {args.publish!r}: {g.n_nodes} nodes "
              f"{g.n_edges} edges", flush=True)

    server = GraphServer(
        service, host=args.host, port=args.port,
        allow_remote_shutdown=not args.no_remote_shutdown).start()
    print(f"{_READY} {server.port}", flush=True)

    import signal

    def _stop(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    server.serve_forever()
    print("server drained and stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
