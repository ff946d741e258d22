"""Wire protocol for cross-process serving — versioned, length-prefixed
binary frames, no pickle anywhere.

The port's codec speaks the reference's protocol byte for byte (the same
header, version, tags and array layout), so a frame built from the same
numpy data is the same bytes in both packages.  A tensor goes on the wire
as its host array (``.detach().cpu().numpy()``); a dtype with no numpy
counterpart (bfloat16) is refused with :class:`WireError`, never cast.
Arrays decode to read-only numpy views of the frame, and the workspace
objects (Table, Graph) decode onto the ``device=`` the decoder is given.

Ringo's front door (§2.1): many analyst *processes* share one big-memory
engine, so declarative requests and their results must cross a socket.  The
codec here is deliberately small and explicit:

* **Frames.**  Every message is one frame: a fixed 16-byte header
  (magic ``RW``, protocol version, frame type, request id, payload length)
  followed by the payload.  Request ids tie responses to requests — the
  server streams :class:`~repro_torch.serve.graph_service.Pending` resolutions
  back in *completion* order, not call order.  A bad magic or an unknown
  protocol version raises :class:`WireError` immediately (the reader never
  guesses at misaligned bytes).
* **Values.**  The payload is one tagged value tree: None/bool/int/float/
  str/bytes, lists, tuples, string-keyed dicts, numeric ndarrays, and the
  two workspace object kinds (:class:`~repro_torch.core.table.Table`,
  :class:`~repro_torch.core.graph.Graph`).  There is no executable content and no
  pickle: an array is ``dtype + shape`` header plus raw bytes, and decoding
  wraps the received buffer **zero-copy** (``np.frombuffer`` on a memoryview
  of the frame; the returned arrays are marked read-only because they alias
  it).  On the send side, array buffers above a threshold are emitted as
  separate scatter-gather chunks (``sendmsg``) instead of being copied into
  the stream.
* **Typed errors.**  Error frames carry the payload produced by
  :func:`repro_torch.serve.policy.error_to_wire`, so admission control crosses the
  wire intact: a rejected submit raises :class:`RejectedError` with its
  ``retry_after`` on the client, a queue-expired request raises
  :class:`DeadlineExpired`.
* **Provenance.**  :func:`pack_object` ships a result with its version
  token and :class:`~repro_torch.core.provenance.ProvRecord` chain (as plain
  data); :func:`unpack_object` rebuilds the object and *adopts* the chain
  (:func:`~repro_torch.core.provenance.adopt_records`), so ``export_script`` works
  on remotely computed objects exactly as on local ones.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike

__all__ = [
    "PROTOCOL_VERSION",
    "MAX_FRAME_BYTES",
    "FrameType",
    "WireError",
    "encode_value",
    "decode_value",
    "encode_frame",
    "decode_frame",
    "send_frame",
    "read_frame",
    "pack_object",
    "unpack_object",
    "TRACE_KEY",
    "attach_trace",
    "extract_trace",
]

PROTOCOL_VERSION = 1
_MAGIC = 0x5257  # "RW"
_HEADER = struct.Struct("!HBBQI")  # magic, version, frame type, req id, len
#: refuse frames above this size (runaway / hostile peers), 1 GiB
MAX_FRAME_BYTES = 1 << 30
#: array buffers at least this large are sent as their own scatter-gather
#: chunk (zero-copy) instead of being copied into the byte stream
_ZERO_COPY_MIN = 4096


class WireError(RuntimeError):
    """Malformed, truncated, oversized or version-incompatible frame."""


#: reserved key carrying a request's trace id inside REQUEST payload dicts —
#: rides the existing value encoding, so the frame header (and the protocol
#: version) is unchanged and peers that ignore it interoperate
TRACE_KEY = "_trace"


def attach_trace(msg: Dict[str, Any], trace: Optional[str]) -> Dict[str, Any]:
    """Stamp ``trace`` into an RPC payload dict (no-op when None)."""
    if trace is not None:
        msg[TRACE_KEY] = trace
    return msg


def extract_trace(msg: Any) -> Optional[str]:
    """Pop and return the trace id of an RPC payload dict, if any."""
    if isinstance(msg, dict):
        t = msg.pop(TRACE_KEY, None)
        if isinstance(t, str):
            return t
    return None


class FrameType:
    """One byte in the header; every frame carries a request id."""

    REQUEST = 1   # client -> server RPC ({"kind": ..., ...})
    OK = 2        # server -> client RPC reply
    ERROR = 3     # server -> client typed error (policy.error_to_wire)
    RESULT = 4    # server -> client streamed Pending resolution


# ---------------------------------------------------------------------------
# value encoding
# ---------------------------------------------------------------------------

_U32 = struct.Struct("!I")
_I64 = struct.Struct("!q")
_F64 = struct.Struct("!d")
_U64 = struct.Struct("!Q")


def _is_arraylike(v: Any) -> bool:
    return torch.is_tensor(v) or (hasattr(v, "dtype") and hasattr(v, "shape")
                                  and hasattr(v, "__array__"))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array; refuses dtypes numpy lacks."""
    try:
        return t.detach().cpu().numpy()
    except TypeError as e:       # bfloat16 and the like: never cast quietly
        raise WireError(f"dtype {t.dtype} has no wire form "
                        f"(numeric/bool arrays only): {e}")


class _Encoder:
    """Accumulates small writes into a buffer, big array payloads as
    standalone zero-copy chunks."""

    def __init__(self):
        self._chunks: List[Any] = []      # bytes / memoryview
        self._buf = bytearray()

    def _flush(self) -> None:
        if self._buf:
            self._chunks.append(bytes(self._buf))
            self._buf = bytearray()

    def chunks(self) -> List[Any]:
        self._flush()
        return self._chunks

    # -- primitives ---------------------------------------------------------
    def raw(self, b: Any) -> None:
        if len(b) >= _ZERO_COPY_MIN:
            self._flush()
            self._chunks.append(b if isinstance(b, (bytes, memoryview))
                                else memoryview(b))
        else:
            self._buf += b

    def tag(self, t: bytes) -> None:
        self._buf += t

    def u32(self, n: int) -> None:
        self._buf += _U32.pack(n)

    def string(self, s: str) -> None:
        b = s.encode("utf-8")
        self.u32(len(b))
        self.raw(b)

    # -- values -------------------------------------------------------------
    def value(self, v: Any) -> None:
        # local imports: core types are needed only when such a value occurs
        from ..core.graph import Graph
        from ..core.table import Table

        if v is None:
            self.tag(b"Z")
        elif v is True:
            self.tag(b"T")
        elif v is False:
            self.tag(b"F")
        elif isinstance(v, (int, np.integer)):
            self.tag(b"I")
            try:
                self._buf += _I64.pack(int(v))
            except struct.error:
                raise WireError(f"integer {v!r} exceeds the wire's int64")
        elif isinstance(v, (float, np.floating)):
            self.tag(b"f")
            self._buf += _F64.pack(float(v))
        elif isinstance(v, str):
            self.tag(b"S")
            self.string(v)
        elif isinstance(v, (bytes, bytearray, memoryview)):
            self.tag(b"B")
            self.u32(len(v))
            self.raw(v)
        elif isinstance(v, Table):
            self.tag(b"t")
            self.value(_table_to_tree(v))
        elif isinstance(v, Graph):
            self.tag(b"G")
            self.value(_graph_to_tree(v))
        elif torch.is_tensor(v):
            self.tag(b"A")
            self.array(_host_array(v))
        elif isinstance(v, np.ndarray) or _is_arraylike(v):
            self.tag(b"A")
            self.array(np.asarray(v))
        elif isinstance(v, tuple):
            self.tag(b"U")
            self.u32(len(v))
            for x in v:
                self.value(x)
        elif isinstance(v, list):
            self.tag(b"L")
            self.u32(len(v))
            for x in v:
                self.value(x)
        elif isinstance(v, dict):
            self.tag(b"D")
            self.u32(len(v))
            for k, x in v.items():
                if not isinstance(k, str):
                    raise WireError(f"dict keys must be str, got {type(k)}")
                self.string(k)
                self.value(x)
        else:
            raise WireError(
                f"value of type {type(v).__name__} has no wire form")

    def array(self, arr: np.ndarray) -> None:
        if arr.dtype.kind not in "biuf":
            raise WireError(f"dtype {arr.dtype} has no wire form "
                            f"(numeric/bool arrays only)")
        if not arr.flags.c_contiguous:   # ascontiguousarray would turn 0-d
            arr = np.ascontiguousarray(arr)  # into 1-d, so only when needed
        dt = arr.dtype.str.encode("ascii")  # includes byte order, e.g. "<f4"
        self._buf += bytes([len(dt)])
        self._buf += dt
        self._buf += bytes([arr.ndim])
        for d in arr.shape:
            self.u32(d)
        self._buf += _U64.pack(arr.nbytes)
        if arr.nbytes:
            self.raw(memoryview(arr).cast("B"))


class _Decoder:
    def __init__(self, mv: memoryview, device: DeviceLike = None):
        self.mv = mv
        self.off = 0
        self.device = device      # where decoded Tables / Graphs live

    def _take(self, n: int) -> memoryview:
        if self.off + n > len(self.mv):
            raise WireError("truncated frame: value runs past payload end")
        out = self.mv[self.off:self.off + n]
        self.off += n
        return out

    def u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def string(self) -> str:
        return bytes(self._take(self.u32())).decode("utf-8")

    def value(self) -> Any:
        tag = bytes(self._take(1))
        if tag == b"Z":
            return None
        if tag == b"T":
            return True
        if tag == b"F":
            return False
        if tag == b"I":
            return _I64.unpack(self._take(8))[0]
        if tag == b"f":
            return _F64.unpack(self._take(8))[0]
        if tag == b"S":
            return self.string()
        if tag == b"B":
            return bytes(self._take(self.u32()))
        if tag == b"A":
            return self.array()
        if tag == b"t":
            return _table_from_tree(self.value(), self.device)
        if tag == b"G":
            return _graph_from_tree(self.value(), self.device)
        if tag == b"U":
            return tuple(self.value() for _ in range(self.u32()))
        if tag == b"L":
            return [self.value() for _ in range(self.u32())]
        if tag == b"D":
            return {self.string(): self.value() for _ in range(self.u32())}
        raise WireError(f"unknown value tag {tag!r}")

    def array(self) -> np.ndarray:
        dt_len = self._take(1)[0]
        try:
            dtype = np.dtype(bytes(self._take(dt_len)).decode("ascii"))
        except TypeError as e:
            raise WireError(f"bad dtype on wire: {e}")
        if dtype.kind not in "biuf":
            raise WireError(f"dtype {dtype} refused (numeric/bool only)")
        ndim = self._take(1)[0]
        shape = tuple(self.u32() for _ in range(ndim))
        nbytes = _U64.unpack(self._take(8))[0]
        expect = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if nbytes != expect:
            raise WireError(f"array header mismatch: {nbytes} bytes for "
                            f"shape {shape} dtype {dtype}")
        buf = self._take(nbytes)
        # zero-copy: the array aliases the received frame buffer
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        if arr.flags.writeable:
            arr.flags.writeable = False
        return arr


# ---------------------------------------------------------------------------
# Table / Graph wire trees (exact rebuild, not pydict round-trips)
# ---------------------------------------------------------------------------


def _table_to_tree(t: Any) -> Dict[str, Any]:
    fields = [(n, ty) for n, ty in t.schema.fields]
    cols = {n: _host_array(t.column(n)) for n, _ in fields}
    return {"fields": fields, "n_valid": t.n_valid,
            "next_row_id": t.next_row_id,
            "row_ids": _host_array(t.row_ids[:t.n_valid]),
            "cols": cols,
            "dicts": {n: list(v) for n, v in t.dicts.items()}}


def _table_from_tree(d: Dict[str, Any], device: DeviceLike) -> Any:
    from ..core.table import Schema, Table, next_capacity
    from ..device import resolve

    dev = resolve(device)
    fields = tuple((n, ty) for n, ty in d["fields"])
    n = int(d["n_valid"])
    cap = next_capacity(n)

    def pad(a: np.ndarray, fill) -> torch.Tensor:
        out = np.full((cap,), fill, dtype=a.dtype)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    cols = {name: pad(d["cols"][name], 0) for name, _ in fields}
    row_ids = pad(np.asarray(d["row_ids"], dtype=np.int32), -1)
    return Table(schema=Schema(fields), columns=cols, row_ids=row_ids,
                 n_valid=n, dicts={k: list(v) for k, v in d["dicts"].items()},
                 next_row_id=int(d["next_row_id"]))


def _graph_to_tree(g: Any) -> Dict[str, Any]:
    src, dst = g.out_edges()
    return {"n_nodes": g.n_nodes,
            "node_ids": _host_array(g.node_ids[:g.n_nodes]),
            "src": _host_array(src), "dst": _host_array(dst)}


def _graph_from_tree(d: Dict[str, Any], device: DeviceLike) -> Any:
    from ..core.graph import Graph

    n = int(d["n_nodes"])
    return Graph.from_dense_edges(
        np.asarray(d["src"], np.int32), np.asarray(d["dst"], np.int32), n,
        node_ids=np.asarray(d["node_ids"], np.int32) if n else None,
        device=device)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def encode_value(v: Any) -> List[Any]:
    """Value tree -> list of byte chunks (large arrays stay un-copied)."""
    enc = _Encoder()
    enc.value(v)
    return enc.chunks()


def decode_value(buf: Any, device: DeviceLike = None) -> Any:
    """Bytes -> value tree; Tables and Graphs are built on ``device``."""
    dec = _Decoder(memoryview(buf), device)
    v = dec.value()
    if dec.off != len(dec.mv):
        raise WireError(f"{len(dec.mv) - dec.off} trailing bytes after value")
    return v


def encode_frame(ftype: int, req_id: int, value: Any) -> List[Any]:
    """Full frame as chunks: header + payload (ready for ``sendmsg``)."""
    chunks = encode_value(value)
    total = sum(len(c) for c in chunks)
    if total > MAX_FRAME_BYTES:
        raise WireError(f"frame payload {total} bytes exceeds "
                        f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})")
    header = _HEADER.pack(_MAGIC, PROTOCOL_VERSION, ftype, req_id, total)
    return [header] + chunks

def decode_frame(buf: Any, device: DeviceLike = None
                 ) -> Tuple[int, int, Any]:
    """One complete frame (header + payload) -> (ftype, req_id, value)."""
    mv = memoryview(buf)
    if len(mv) < _HEADER.size:
        raise WireError("truncated frame: short header")
    magic, ver, ftype, req_id, length = _HEADER.unpack(mv[:_HEADER.size])
    if magic != _MAGIC:
        raise WireError(f"bad frame magic {magic:#06x}")
    if ver != PROTOCOL_VERSION:
        raise WireError(f"unsupported protocol version {ver} "
                        f"(speaking {PROTOCOL_VERSION})")
    payload = mv[_HEADER.size:]
    if len(payload) != length:
        raise WireError(f"truncated frame: header says {length} payload "
                        f"bytes, got {len(payload)}")
    return ftype, req_id, decode_value(payload, device)


# -- socket helpers ----------------------------------------------------------


def send_frame(sock: socket.socket, ftype: int, req_id: int,
               value: Any) -> None:
    """Write one frame; scatter-gather, so big arrays are never copied."""
    chunks = encode_frame(ftype, req_id, value)
    try:
        sent_chunks = 0
        while sent_chunks < len(chunks):
            # stay under IOV_MAX (1024 on Linux) per sendmsg call
            n = sock.sendmsg(chunks[sent_chunks:sent_chunks + 512])
            # advance past fully-sent chunks; re-slice a partial one
            while sent_chunks < len(chunks) and n >= len(chunks[sent_chunks]):
                n -= len(chunks[sent_chunks])
                sent_chunks += 1
            if n:
                part = chunks[sent_chunks]
                chunks[sent_chunks] = memoryview(part)[n:]
    except AttributeError:  # pragma: no cover - platforms without sendmsg
        sock.sendall(b"".join(bytes(c) for c in chunks))


def _recv_exact(sock: socket.socket, n: int) -> Optional[memoryview]:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            if got == 0:
                return None
            raise WireError(f"truncated frame: peer closed after {got} of "
                            f"{n} bytes")
        got += r
    return memoryview(buf)


def read_frame(sock: socket.socket,
               max_bytes: int = MAX_FRAME_BYTES, *,
               device: DeviceLike = None
               ) -> Optional[Tuple[int, int, Any]]:
    """Read one frame; None on clean EOF before a header starts.  Tables
    and Graphs in it are built on ``device``."""
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        return None
    magic, ver, ftype, req_id, length = _HEADER.unpack(head)
    if magic != _MAGIC:
        raise WireError(f"bad frame magic {magic:#06x}")
    if ver != PROTOCOL_VERSION:
        raise WireError(f"unsupported protocol version {ver} "
                        f"(speaking {PROTOCOL_VERSION})")
    if length > max_bytes:
        raise WireError(f"frame payload {length} bytes exceeds limit "
                        f"{max_bytes}")
    payload = _recv_exact(sock, length) if length else memoryview(b"")
    if length and payload is None:
        raise WireError("truncated frame: EOF before payload")
    return ftype, req_id, decode_value(payload, device)


# ---------------------------------------------------------------------------
# objects + provenance (results, workspace puts/gets)
# ---------------------------------------------------------------------------


def _versionable(v: Any) -> bool:
    """Only objects with stable identity get wire version tokens; plain
    python scalars would alias small-int/str interning."""
    from ..core.graph import Graph
    from ..core.table import Table
    from ..core import provenance as prov
    if isinstance(v, (Table, Graph)) or _is_arraylike(v) \
            or isinstance(v, np.ndarray):
        return True
    return bool(prov.records_of(v))


def pack_object(v: Any) -> Dict[str, Any]:
    """Value + provenance chain + version token(s), wire-encodable.

    Tuples (multi-output ops like ``hits``) ship one chain and token per
    element, since records attach to the elements.  Tokens are *peeked*,
    never minted: an object that was never versioned here (a fresh client
    root) ships token-less, and the receiving side assigns one — a
    locally-minted token could collide with the peer's existing tokens.
    """
    from ..core import provenance as prov
    if isinstance(v, tuple):
        return {"multi": True, "value": v,
                "records": [prov.records_to_wire(prov.records_of(x))
                            for x in v],
                "tokens": [prov.peek_version(x) if _versionable(x) else None
                           for x in v]}
    return {"multi": False, "value": v,
            "records": prov.records_to_wire(prov.records_of(v)),
            "token": prov.peek_version(v) if _versionable(v) else None}


def unpack_object(payload: Dict[str, Any]) -> Any:
    """Rebuild a packed value and adopt its provenance into this process."""
    from ..core import provenance as prov
    if payload.get("multi"):
        vals = tuple(payload["value"])
        for x, recs, tok in zip(vals, payload["records"], payload["tokens"]):
            if tok is not None or recs:
                prov.adopt_records(x, prov.records_from_wire(recs), token=tok)
        return vals
    v = payload["value"]
    tok = payload.get("token")
    recs = payload.get("records") or []
    if tok is not None or recs:
        prov.adopt_records(v, prov.records_from_wire(recs), token=tok)
    return v
