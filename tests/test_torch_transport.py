"""The port's ``transport`` against the JAX package's: the same columns
give byte-equal frames (colv1 with and without compression, the
``K_TRACED`` request header, the pickle fallback, control frames), the
codec hello negotiates the same codec, and the wire-format matrix of
``tests/test_gateway.py`` round-trips on the port's copy."""

import socket
import threading

import numpy as np
import pytest

from tensorflowonspark_tpu import transport as jax_transport
from tensorflowonspark_torch import transport
from tensorflowonspark_torch.transport import Transport, TransportError

from test_wire_formats import NUMERIC_DTYPES


class _Capture(object):
    """A socket stand-in that keeps every byte sent."""

    def __init__(self):
        self.data = bytearray()

    def setsockopt(self, *args):
        raise OSError("not a TCP socket")

    def sendall(self, data):
        self.data += bytes(data)

    def close(self):
        pass


def _sent(module, fn, codec=None):
    sock = _Capture()
    t = module.Transport(sock, codec=codec)
    fn(t)
    return bytes(sock.data)


def _columns():
    rng = np.random.default_rng(3)
    return [rng.standard_normal((6, 4)).astype(np.float32),
            np.arange(6, dtype=np.int64),
            np.zeros((6, 2048), np.float32)]   # compressible: zlib pays


@pytest.mark.parametrize("codec", [None, "zlib"])
@pytest.mark.parametrize("flow_id", [0, 0x5A5A5])
def test_column_frames_byte_equal(codec, flow_id):
    cols = _columns()

    def send(t):
        kind = t.send_columns(cols, 6, flow_id=flow_id)
        assert kind == 1   # colv1, also inside a traced frame
        t.send_control({"type": "result", "id": 1, "outputs": ["a", "b"]})
        t.send_abort("overload", "queue full", queued=3)

    got = _sent(transport, send, codec)
    want = _sent(jax_transport, send, codec)
    assert got == want
    assert got[4] == (transport.K_TRACED if flow_id else transport.K_COLV1)


def test_pickle_fallback_byte_equal():
    col = np.asarray(["ragged", "objects", None], dtype=object)

    def send(t):
        assert t.send_columns([col], 3, tuple_rows=True) == 2
        t.send_columns([col], 3, flow_id=77)

    assert _sent(transport, send) == _sent(jax_transport, send)


def test_framing_constants_match_jax():
    for name in ("K_JSON", "K_COLV1", "K_PICKLE", "K_TRACED",
                 "SEND_COPY_MAX"):
        assert getattr(transport, name) == getattr(jax_transport, name)
    assert transport.DHEADER.format == jax_transport.DHEADER.format
    assert transport.THEADER.format == jax_transport.THEADER.format
    for addr in ("h:1", ("h", "2"), ["h", 3]):
        assert transport.addr_tuple(addr) == jax_transport.addr_tuple(addr)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_hello_negotiates_the_same_codec(client):
    """A port endpoint and a JAX endpoint on one socketpair agree on the
    codec, either side dialling."""
    a, b = socket.socketpair()
    mods = (transport, jax_transport) if client == "port" else \
        (jax_transport, transport)
    ta, tb = mods[0].Transport(a), mods[1].Transport(b)
    out = {}

    def dial():
        out["reply"] = ta.client_hello(extra={"client": "t"})

    t = threading.Thread(target=dial)
    t.start()
    hello = tb.recv_control()
    assert hello["type"] == "hello" and hello["codecs"]
    codec = tb.server_hello(hello, extra={"max_batch": 4})
    t.join()
    assert out["reply"]["type"] == "hello_ok"
    assert out["reply"]["max_batch"] == 4
    assert ta.codec == tb.codec == codec
    ta.close()
    tb.close()


# ---------------------------------------------------------------------------
# tests/test_gateway.py's transport cases, re-pointed to the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", NUMERIC_DTYPES,
                         ids=[np.dtype(d).name for d in NUMERIC_DTYPES])
def test_request_response_colv1_roundtrip(dtype):
    a, b = socket.socketpair()
    ta, tb = Transport(a), Transport(b)
    try:
        rng = np.random.default_rng(7)
        col = (rng.random((6, 3)) * 100).astype(dtype)
        kind = ta.send_columns([col], 6)
        assert kind == transport.K_COLV1
        k, payload = tb.recv_message()
        cols, count, tuple_rows = Transport.decode_columns(k, payload)
        assert count == 6 and not tuple_rows
        assert cols[0].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(cols[0], col)
    finally:
        ta.close()
        tb.close()


def test_transport_object_column_falls_back_to_pickle():
    a, b = socket.socketpair()
    ta, tb = Transport(a), Transport(b)
    try:
        col = np.asarray(["ragged", "objects"], dtype=object)
        kind = ta.send_columns([col], 2)
        assert kind == transport.K_PICKLE
        k, payload = tb.recv_message()
        cols, count, _ = Transport.decode_columns(k, payload)
        assert count == 2 and list(cols[0]) == ["ragged", "objects"]
    finally:
        ta.close()
        tb.close()


def test_transport_abort_surfaces_typed_error():
    a, b = socket.socketpair()
    ta, tb = Transport(a), Transport(b)
    try:
        ta.send_abort("overload", "queue full", queued=32)
        with pytest.raises(TransportError, match="overload"):
            tb.recv_message()
    finally:
        ta.close()
        tb.close()


def test_traced_frame_roundtrip():
    a, b = socket.socketpair()
    ta, tb = Transport(a), Transport(b)
    try:
        col = np.arange(12, dtype=np.float32).reshape(6, 2)
        kind = ta.send_columns([col], 6, flow_id=0x5A5A5)
        assert kind == transport.K_COLV1    # reports the INNER encoding
        k, payload = tb.recv_message()
        assert k == transport.K_TRACED
        flow, inner, body = Transport.split_traced(payload)
        assert flow == 0x5A5A5 and inner == transport.K_COLV1
        cols, count, _ = Transport.decode_columns(inner, body)
        assert count == 6
        np.testing.assert_array_equal(cols[0], col)
        ta.send_columns([col], 6, flow_id=0x77)
        k2, payload2 = tb.recv_message()
        cols2, count2, _ = Transport.decode_columns(k2, payload2)
        assert count2 == 6
        np.testing.assert_array_equal(cols2[0], col)
        ta.send_columns([col], 6, flow_id=0)
        k3, _ = tb.recv_message()
        assert k3 == transport.K_COLV1
    finally:
        ta.close()
        tb.close()


def test_split_traced_rejects_garbage():
    with pytest.raises(TransportError):
        Transport.split_traced(b"\x00\x01")     # shorter than the header
    bad = transport.THEADER.pack(1, 99, 0, 0) + b"x"
    with pytest.raises(TransportError):
        Transport.split_traced(bad)             # unknown inner kind
