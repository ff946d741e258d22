"""The port's wire protocol (repro_torch/serve/wire.py).

The reference's ``tests/test_wire.py`` case for case on the port (tables
and graphs decode onto the CPU), then the parity cases: the port's frames
are byte for byte the reference's for the same message built from the same
numpy arrays (scalars, nested containers, arrays, a Table with STR
columns, a Graph, each error type), each side decodes the other's frames,
a tensor goes on the wire as its host array, and bfloat16 is refused.
"""

import struct

import numpy as np
import pytest
import torch

from repro_torch.core import provenance as P
from repro_torch.core.graph import Graph
from repro_torch.core.table import FLOAT, INT, STR, Table
from repro_torch.serve import wire
from repro_torch.serve.policy import (DeadlineExpired, RejectedError, RemoteError,
                                ServiceError, error_from_wire, error_to_wire)


def roundtrip(v, ftype=wire.FrameType.REQUEST, req_id=9):
    chunks = wire.encode_frame(ftype, req_id, v)
    ft, rid, out = wire.decode_frame(b"".join(bytes(c) for c in chunks),
                                     device="cpu")
    assert ft == ftype and rid == req_id
    return out


# ---------------------------------------------------------------------------
# scalar / container values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v", [
    None, True, False, 0, -1, 2**62, 3.25, float("inf"), "", "héllo wörld",
    b"", b"\x00\xffraw", [], [1, "two", None], (),
    (1, (2, "x")), {}, {"op": "pagerank", "params": {"n_iter": 20}},
])
def test_value_roundtrip(v):
    assert roundtrip(v) == v


def test_tuple_list_distinction_survives():
    out = roundtrip({"t": (1, 2), "l": [1, 2]})
    assert isinstance(out["t"], tuple) and isinstance(out["l"], list)


def test_int_overflow_refused():
    with pytest.raises(wire.WireError, match="int64"):
        wire.encode_frame(1, 1, 2**70)


def test_non_string_dict_keys_refused():
    with pytest.raises(wire.WireError, match="keys must be str"):
        wire.encode_frame(1, 1, {1: "x"})


def test_unencodable_type_refused():
    with pytest.raises(wire.WireError, match="no wire form"):
        wire.encode_frame(1, 1, object())


# ---------------------------------------------------------------------------
# arrays: empty, >1MB, dtypes, zero-copy semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arr", [
    np.zeros((0,), np.float32),
    np.zeros((0, 4), np.int64),
    np.arange(7, dtype=np.int32),
    np.asarray(3.5, dtype=np.float64),               # 0-d scalar array
    np.random.default_rng(0).normal(size=(513, 300)),  # > 1 MB float64
    np.array([True, False, True]),
])
def test_array_roundtrip(arr):
    out = roundtrip(arr)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)


def test_big_array_is_zero_copy_on_both_sides():
    arr = np.random.default_rng(1).normal(size=(1 << 17,))  # 1 MiB
    chunks = wire.encode_frame(2, 1, arr)
    # encoder: the array's buffer is passed through as its own chunk
    assert any(isinstance(c, memoryview) and c.nbytes == arr.nbytes
               for c in chunks)
    _, _, out = wire.decode_frame(b"".join(bytes(c) for c in chunks))
    # decoder: the result aliases the frame buffer, hence read-only
    assert not out.flags.writeable
    np.testing.assert_array_equal(out, arr)


def test_object_dtype_refused():
    with pytest.raises(wire.WireError, match="no wire form"):
        wire.encode_frame(1, 1, np.array(["a", "b"], dtype=object))


def test_tensor_encodes_as_array():
    out = roundtrip(torch.arange(5, dtype=torch.float32))
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.arange(5, dtype=np.float32))


# ---------------------------------------------------------------------------
# tables (incl. string columns) and graphs
# ---------------------------------------------------------------------------


def test_table_roundtrip_string_columns():
    t = Table.from_columns(
        {"id": INT, "score": FLOAT, "tag": STR},
        {"id": [3, 1, 2], "score": [0.5, 1.5, -2.0],
         "tag": ["java", "python", "java"]}, device="cpu")
    out = roundtrip(t)
    assert isinstance(out, Table)
    assert out.schema.fields == t.schema.fields
    assert out.to_pydict() == t.to_pydict()
    np.testing.assert_array_equal(out.column_np("id"), t.column_np("id"))
    assert out.strings("tag") == ["java", "python", "java"]
    assert out.next_row_id == t.next_row_id
    np.testing.assert_array_equal(np.asarray(out.row_ids[:3]),
                                  np.asarray(t.row_ids[:3]))


def test_empty_table_roundtrip():
    t = Table.from_columns({"x": INT, "s": STR}, {"x": [], "s": []}, device="cpu")
    out = roundtrip(t)
    assert len(out) == 0 and out.schema.names == ("x", "s")


def test_graph_roundtrip():
    src = np.array([0, 7, 7, 3], np.int32)
    dst = np.array([7, 3, 0, 0], np.int32)
    g = Graph.from_edges(src, dst, device="cpu")
    out = roundtrip(g)
    assert out.n_nodes == g.n_nodes and out.n_edges == g.n_edges
    np.testing.assert_array_equal(np.asarray(out.node_ids),
                                  np.asarray(g.node_ids))
    s1, d1 = g.out_edges()
    s2, d2 = out.out_edges()
    np.testing.assert_array_equal(np.asarray(s2), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(d2), np.asarray(d1))


# ---------------------------------------------------------------------------
# typed error frames
# ---------------------------------------------------------------------------


def test_rejected_error_keeps_retry_after():
    e = RejectedError("session 'u1' is at its in-flight quota (8)", 0.125)
    out = error_from_wire(roundtrip(error_to_wire(e),
                                    ftype=wire.FrameType.ERROR))
    assert isinstance(out, RejectedError)
    assert out.retry_after == pytest.approx(0.125)
    assert "quota" in str(out)


def test_deadline_expired_roundtrip():
    out = error_from_wire(roundtrip(error_to_wire(
        DeadlineExpired("spent its deadline in the queue"))))
    assert isinstance(out, DeadlineExpired)


def test_service_and_key_errors_roundtrip():
    out = error_from_wire(roundtrip(error_to_wire(
        ServiceError("unknown op 'frobnicate'"))))
    assert isinstance(out, ServiceError) and not isinstance(
        out, (RejectedError, DeadlineExpired))
    key = error_from_wire(roundtrip(error_to_wire(KeyError("posts"))))
    assert isinstance(key, KeyError) and key.args == ("posts",)
    # messages containing quotes round-trip verbatim (str(KeyError) is the
    # repr of its arg; the wire ships the arg itself)
    msg = "no workspace object 'x'; have ['g']"
    key2 = error_from_wire(roundtrip(error_to_wire(KeyError(msg))))
    assert key2.args == (msg,)


def test_unknown_exception_becomes_remote_error():
    out = error_from_wire(roundtrip(error_to_wire(
        ZeroDivisionError("division by zero"))))
    assert isinstance(out, RemoteError)
    assert "ZeroDivisionError" in str(out)


# ---------------------------------------------------------------------------
# framing: truncation, bad magic, unknown version, size bound
# ---------------------------------------------------------------------------


def full_frame(v=("x", [1, 2.5])):
    return b"".join(bytes(c) for c in wire.encode_frame(1, 3, v))


def test_truncated_frame_rejected():
    buf = full_frame(np.arange(100, dtype=np.float64))
    for cut in (4, 15, 17, len(buf) - 1):
        with pytest.raises(wire.WireError, match="truncated|short header"):
            wire.decode_frame(buf[:cut])


def test_trailing_garbage_rejected():
    with pytest.raises(wire.WireError):
        wire.decode_frame(full_frame() + b"\x00")


def test_bad_magic_rejected():
    buf = bytearray(full_frame())
    buf[0] ^= 0xFF
    with pytest.raises(wire.WireError, match="magic"):
        wire.decode_frame(bytes(buf))


def test_unknown_protocol_version_rejected():
    buf = bytearray(full_frame())
    buf[2] = wire.PROTOCOL_VERSION + 1    # version byte follows the magic
    with pytest.raises(wire.WireError, match="protocol version"):
        wire.decode_frame(bytes(buf))


def test_unknown_value_tag_rejected():
    head = struct.pack("!HBBQI", 0x5257, wire.PROTOCOL_VERSION, 1, 0, 1)
    with pytest.raises(wire.WireError, match="unknown value tag"):
        wire.decode_frame(head + b"\x7f")


# ---------------------------------------------------------------------------
# pack_object / unpack_object: provenance across the wire
# ---------------------------------------------------------------------------


def test_pack_object_ships_and_adopts_provenance():
    from repro_torch.core import relational as R
    t = Table.from_columns({"x": INT}, {"x": [5, 1, 3]}, device="cpu")
    ordered = R.order(t, "x")
    payload = roundtrip(wire.pack_object(ordered))
    out = wire.unpack_object(payload)
    assert out.to_pydict() == ordered.to_pydict()
    ops = [r.op for r in P.records_of(out)]
    assert ops == [r.op for r in P.records_of(ordered)]
    # the adopted copy answers to the producer's version token
    assert P.peek_version(out) == P.version_of(ordered)


def test_pack_object_fresh_root_ships_tokenless():
    t = Table.from_columns({"x": INT}, {"x": [1]}, device="cpu")
    payload = wire.pack_object(t)
    assert payload["token"] is None       # receiver assigns the version
    assert payload["records"] == []


def test_pack_object_tuple_per_element_chains():
    from repro_torch.core import relational as R
    t = Table.from_columns({"x": INT}, {"x": [2, 1]}, device="cpu")
    a, b = R.order(t, "x"), t
    payload = roundtrip(wire.pack_object((a, b)))
    out = wire.unpack_object(payload)
    assert isinstance(out, tuple) and len(out) == 2
    assert [r.op for r in P.records_of(out[0])] == \
        [r.op for r in P.records_of(a)]


def test_opaque_params_survive_records_wire():
    rec = P.ProvRecord(op="x", inputs=(("t", "t1"),),
                       params=(("w", P.Opaque("array(9999,):f32")),),
                       outputs=("t2",), meta=())
    data = roundtrip(P.records_to_wire([rec]))
    back = P.records_from_wire(data)
    assert isinstance(back[0].params[0][1], P.Opaque)
    assert back[0].params[0][1].desc == "array(9999,):f32"


# ---------------------------------------------------------------------------
# parity: the port's frames are the reference's, byte for byte
# ---------------------------------------------------------------------------

from repro.core.graph import Graph as RefGraph  # noqa: E402
from repro.core.table import Table as RefTable  # noqa: E402
from repro.serve import policy as ref_policy  # noqa: E402
from repro.serve import wire as ref_wire  # noqa: E402
from repro_torch.serve import policy as port_policy  # noqa: E402


def frame_bytes(codec, v, ftype=1, req_id=7):
    return b"".join(bytes(c) for c in codec.encode_frame(ftype, req_id, v))


_RNG = np.random.default_rng(0)
_MESSAGES = {
    "scalars": [None, True, False, 0, -(2 ** 63), 2 ** 63 - 1, 1.5, "",
                "héllo", b"\x00\xff"],
    "nested": {"kind": "submit", "session": "s",
               "request": {"op": "bfs", "graph": "g",
                           "params": {"source": 3, "n_iter": None}},
               "t": (1, [2, (3.0, {"x": []})])},
    "arrays": [np.arange(7, dtype=np.int32),
               _RNG.random((3, 4)).astype(np.float32),
               _RNG.random(5000),                       # zero-copy chunk
               np.array([True, False]), np.zeros((0, 3), np.int64),
               np.array(2.5, np.float32), np.arange(6, dtype=">i4")],
}


@pytest.mark.parametrize("name", sorted(_MESSAGES))
def test_frames_are_byte_identical_to_the_reference(name):
    v = _MESSAGES[name]
    got = frame_bytes(wire, v)
    assert got == frame_bytes(ref_wire, v)
    # each side decodes the other's frame to the same value
    back = ref_wire.decode_frame(got)[2]
    again = wire.decode_frame(frame_bytes(ref_wire, v), device="cpu")[2]
    assert frame_bytes(ref_wire, back) == got == frame_bytes(wire, again)


def test_table_with_string_columns_is_byte_identical():
    cols = {"id": [3, 1, 2, 7], "score": [0.5, 1.5, -2.0, 3.25],
            "tag": ["java", "python", "java", "c++"]}
    schema = {"id": INT, "score": FLOAT, "tag": STR}
    port_t = Table.from_columns(schema, cols, device="cpu")
    ref_t = RefTable.from_columns(schema, cols)
    got = frame_bytes(wire, {"obj": port_t})
    assert got == frame_bytes(ref_wire, {"obj": ref_t})
    out = wire.decode_frame(frame_bytes(ref_wire, ref_t), device="cpu")[2]
    assert isinstance(out, Table) and out.device.type == "cpu"
    assert out.to_pydict() == ref_t.to_pydict()


def test_graph_is_byte_identical():
    src = np.array([0, 7, 7, 3, 9], np.int32)
    dst = np.array([7, 3, 0, 0, 3], np.int32)
    port_g = Graph.from_edges(src, dst, device="cpu")
    got = frame_bytes(wire, port_g)
    assert got == frame_bytes(ref_wire, RefGraph.from_edges(src, dst))
    out = wire.decode_frame(got, device="cpu")[2]
    assert isinstance(out, Graph)
    for a, b in zip(out.to_arrays(), port_g.to_arrays()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("make", [
    lambda P: P.RejectedError("at its in-flight quota (8)", 0.125),
    lambda P: P.DeadlineExpired("spent its deadline in the queue"),
    lambda P: P.ServiceError("unknown op 'frobnicate'"),
    lambda P: KeyError("no workspace object 'x'"),
    lambda P: ZeroDivisionError("division by zero"),
    lambda P: ref_wire.WireError("bad frame"),
], ids=["rejected", "deadline", "service", "key", "unknown", "wire"])
def test_error_frames_are_byte_identical(make):
    ref_err, port_err = make(ref_policy), make(port_policy)
    if isinstance(ref_err, ref_wire.WireError):
        port_err = wire.WireError("bad frame")
    got = frame_bytes(wire, port_policy.error_to_wire(port_err),
                      ftype=wire.FrameType.ERROR)
    assert got == frame_bytes(ref_wire, ref_policy.error_to_wire(ref_err),
                              ftype=ref_wire.FrameType.ERROR)
    back = port_policy.error_from_wire(wire.decode_frame(got)[2])
    assert type(back).__name__ == type(
        ref_policy.error_from_wire(ref_wire.decode_frame(got)[2])).__name__


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64,
                                   torch.bool, torch.float64])
def test_tensor_frame_is_its_host_array(dtype):
    t = torch.arange(12).reshape(3, 4).to(dtype)
    got = frame_bytes(wire, {"value": t})
    assert got == frame_bytes(wire, {"value": t.numpy()})
    assert got == frame_bytes(ref_wire, {"value": t.numpy()})
    out = wire.decode_frame(got)[2]["value"]
    assert isinstance(out, np.ndarray) and not out.flags.writeable
    np.testing.assert_array_equal(out, t.numpy())


def test_bfloat16_is_refused_not_cast():
    t = torch.ones(4, dtype=torch.bfloat16)
    with pytest.raises(wire.WireError, match="no wire form"):
        wire.encode_frame(1, 1, {"x": t})


def test_decoded_objects_without_a_device_need_the_card(monkeypatch):
    buf = frame_bytes(wire, Table.from_columns({"x": INT}, {"x": [1]},
                                               device="cpu"))
    assert wire.decode_frame(buf, device="cpu")[2].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wire.decode_frame(buf)
    # arrays alone decode on the host with no device at all
    out = wire.decode_frame(frame_bytes(wire, np.arange(3)))[2]
    np.testing.assert_array_equal(out, np.arange(3))
