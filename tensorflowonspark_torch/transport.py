"""Shared zero-copy stream framing for every TCP data path in the repo.

The port's copy of :mod:`tensorflowonspark_tpu.transport` (it never imported jax);
the copy is the port's own.

One wire shape for every bulk path: the data-service split streams
(``dataservice.py``), the serving gateway's request/response batches
(``gateway.py``), and whatever subsystem grows a bulk path next.  The
framing was born in the data plane; this module lifts it out so serving
batches ride the exact same colv1 frames as training chunks instead of a
bespoke protocol.

Frame layout: 4-byte big-endian payload length + 1-byte kind byte,
then the payload.  Four kinds:

* ``K_JSON``   — UTF-8 JSON control message (hellos, acks, aborts),
* ``K_COLV1``  — one ``wire.py`` colv1 columnar frame (zero-copy decode
  on receipt; optional per-column compression negotiated at hello),
* ``K_PICKLE`` — pickled python payload, the object/ragged fallback,
* ``K_TRACED`` — a :data:`THEADER` request-trace header (flow id +
  reserved model/version tags) wrapping a K_COLV1/K_PICKLE payload, so
  the serving request flow id rides the wire with its batch.

The module level keeps the bare socket helpers (``recv_exact`` /
``recv_frame`` / ``send_frame`` / ``send_json`` / ``addr_tuple``) so
existing call sites keep their hot-path shape; the :class:`Transport`
class wraps a connected socket with the rest of the protocol contract —
codec negotiation, send/receive counters, columnar encode with pickle
fallback, and in-band typed aborts — so new endpoints don't re-derive
those semantics by hand.
"""

import json
import pickle
import socket
import struct
import threading

from tensorflowonspark_torch import wire

# Data-stream framing: 4-byte big-endian payload length + 1-byte kind.
DHEADER = struct.Struct(">IB")
K_JSON = 0     # UTF-8 JSON control message
K_COLV1 = 1    # one wire.py colv1 frame (zero-copy decode on receipt)
K_PICKLE = 2   # pickled payload (object/ragged fallback)
K_TRACED = 3   # THEADER trace header + an inner K_COLV1/K_PICKLE payload

# Request-plane trace header riding ahead of a columnar payload inside a
# ``K_TRACED`` frame: u64 flow id (``telemetry.Tracer.new_flow_id``), u8
# inner kind byte (K_COLV1 or K_PICKLE), then u16 model tag + u16 version
# tag.  The tags are reserved and always 0 today — serving v2's multi-model
# dimension rides in them without another frame-format bump.  Keeping the
# trace header at the transport layer (not inside the colv1 fixed header)
# means wire.py frames stay bit-identical with the data plane's, and a
# request with no live tracer skips the wrapper entirely.
THEADER = struct.Struct(">QBHH")


class TransportError(RuntimeError):
    """Protocol-level failure on a transport stream (bad hello, unknown
    frame kind, or a peer-sent abort surfaced in-band)."""


def recv_exact(sock, n):
    # Returns a bytearray, not bytes: a final bytes(buf) copy of every
    # ~800 KB chunk payload caps the consumer's aggregate ingest around
    # 750 MB/s on loopback; skipping it nearly triples the framing ceiling.
    # Callers treat the buffer as immutable (frombuffer views pin it).
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise EOFError("connection closed mid-frame")
        got += k
    return buf


def recv_frame(sock):
    """One ``(kind, payload)`` data frame; raises EOFError on a closed peer."""
    length, kind = DHEADER.unpack(recv_exact(sock, DHEADER.size))
    return kind, recv_exact(sock, length)


# Below this, header+payload are sent as one concatenated buffer so small
# control frames never sit behind Nagle/delayed-ACK interactions with a
# previous partial segment; at or above it the payload copy costs more than
# the second sendall (TCP_NODELAY is set on every data socket anyway).
SEND_COPY_MAX = 64 * 1024


def send_frame(sock, kind, payload):
    header = DHEADER.pack(len(payload), kind)
    if len(payload) < SEND_COPY_MAX:
        sock.sendall(header + payload)
    else:
        sock.sendall(header)
        sock.sendall(payload)


def send_json(sock, obj):
    send_frame(sock, K_JSON, json.dumps(obj).encode("utf-8"))


def addr_tuple(addr):
    """Normalize ``(host, port)`` / ``[host, port]`` / ``"host:port"``."""
    if isinstance(addr, str):
        host, _, port = addr.rpartition(":")
        return (host, int(port))
    return (addr[0], int(addr[1]))


class Transport(object):
    """A connected stream speaking the shared framing protocol.

    Wraps an already-connected socket (either side of the connection) and
    owns the per-stream contract the data plane established:

    * **codec negotiation** — one JSON hello round; the server picks the
      first mutually supported codec via :func:`wire.negotiate_codec` and
      every later colv1 frame on the stream uses it,
    * **counters** — frames/bytes in each direction plus a
      ``compress_stats`` dict fed to ``wire.frame_bytes`` (raw vs wire
      bytes, per-codec column counts) for heartbeat export,
    * **columnar send with fallback** — ``send_columns`` tries the
      zero-copy colv1 encoding and silently falls back to pickle for
      object/ragged columns, exactly like the feed-worker stream path,
    * **abort semantics** — ``send_abort`` delivers a typed in-band
      control message (the split-abort pattern) so a peer mid-stream
      learns *why* instead of seeing a bare EOF.

    Sends are serialized by an internal lock so multiple producer threads
    can share one stream; receives are left to a single reader thread
    (both the data service and the gateway dedicate one).
    """

    def __init__(self, sock, codec=None):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not TCP (unix socketpair in tests): Nagle doesn't apply
        self.sock = sock
        self.codec = codec
        self.frames_sent = 0
        self.frames_received = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.colv1_sent = 0
        self.pickle_sent = 0
        self.compress_stats = {}
        self._send_lock = threading.Lock()

    # -- handshake ----------------------------------------------------------

    def client_hello(self, extra=None):
        """Send the client side of the codec handshake and adopt the codec
        the server picks.  Returns the server's hello-reply dict."""
        hello = {"type": "hello", "codecs": wire.supported_codecs()}
        if extra:
            hello.update(extra)
        self.send_control(hello)
        msg = self.recv_control()
        self.codec = msg.get("codec") or None
        return msg

    def server_hello(self, hello, extra=None):
        """Answer a client hello: negotiate the codec and confirm it."""
        self.codec = wire.negotiate_codec(hello.get("codecs"))
        reply = {"type": "hello_ok", "codec": self.codec}
        if extra:
            reply.update(extra)
        self.send_control(reply)
        return self.codec

    # -- send path ----------------------------------------------------------

    def send_control(self, obj):
        payload = json.dumps(obj).encode("utf-8")
        self._send(K_JSON, payload)

    def send_abort(self, code, message, **fields):
        """Typed in-band abort (the data plane's split_abort pattern): the
        peer's reader surfaces it instead of a bare connection reset."""
        msg = {"type": "abort", "code": code, "message": message}
        msg.update(fields)
        self.send_control(msg)

    def send_columns(self, columns, count, tuple_rows=False, flow_id=None):
        """Send one batch of columns: colv1 when framable, pickle fallback.

        A truthy ``flow_id`` wraps the payload in a ``K_TRACED`` frame so
        the request's trace flow id travels with its data (one small-header
        copy on the traced path only).  Returns the *inner* kind byte so
        callers count formats the same with or without tracing.
        """
        kind = K_PICKLE
        payload = None
        try:
            payload = wire.frame_bytes(
                columns, count, tuple_rows,
                codec=self.codec, stats=self.compress_stats)
            if payload is not None:
                kind = K_COLV1
        except wire.FrameError:
            payload = None
        if payload is None:
            payload = pickle.dumps((columns, count, tuple_rows),
                                   protocol=pickle.HIGHEST_PROTOCOL)
        if flow_id:
            payload = THEADER.pack(int(flow_id), kind, 0, 0) + bytes(payload)
            self._send(K_TRACED, payload)
        else:
            self._send(kind, payload)
        if kind == K_COLV1:
            self.colv1_sent += 1
        else:
            self.pickle_sent += 1
        return kind

    def _send(self, kind, payload):
        with self._send_lock:
            send_frame(self.sock, kind, payload)
            self.frames_sent += 1
            self.bytes_sent += DHEADER.size + len(payload)

    # -- receive path -------------------------------------------------------

    def recv_message(self):
        """One frame as ``(kind, decoded)``.

        ``K_JSON`` frames come back as dicts — except ``type: "abort"``
        which raises :class:`TransportError` so mid-stream failures can't
        be mistaken for data.  ``K_COLV1`` / ``K_PICKLE`` payloads are
        returned raw for the caller to decode (column decode wants
        caller-controlled ``copy`` semantics).
        """
        kind, payload = recv_frame(self.sock)
        self.frames_received += 1
        self.bytes_received += DHEADER.size + len(payload)
        if kind == K_JSON:
            msg = json.loads(bytes(payload).decode("utf-8"))
            if isinstance(msg, dict) and msg.get("type") == "abort":
                raise TransportError("peer abort [{}]: {}".format(
                    msg.get("code"), msg.get("message")))
            return kind, msg
        return kind, payload

    def recv_control(self):
        kind, msg = self.recv_message()
        if kind != K_JSON:
            raise TransportError(
                "expected control frame, got kind={}".format(kind))
        return msg

    @staticmethod
    def split_traced(payload):
        """Split a ``K_TRACED`` payload into ``(flow_id, inner_kind,
        inner_payload)``.  The inner payload is a zero-copy memoryview into
        ``payload``; the reserved model/version tags are discarded."""
        if len(payload) < THEADER.size:
            raise TransportError("traced frame shorter than THEADER")
        flow_id, inner_kind, _model, _version = THEADER.unpack_from(
            memoryview(payload), 0)
        if inner_kind not in (K_COLV1, K_PICKLE):
            raise TransportError(
                "traced frame wraps kind={}".format(inner_kind))
        return flow_id, inner_kind, memoryview(payload)[THEADER.size:]

    @staticmethod
    def decode_columns(kind, payload, copy=False):
        """Decode a ``send_columns`` payload back to
        ``(columns, count, tuple_rows)``.  ``copy=False`` keeps colv1
        columns as views pinning the receive buffer (zero-copy).  A
        ``K_TRACED`` frame decodes transparently (flow id discarded —
        callers who want it use :meth:`split_traced` first)."""
        if kind == K_TRACED:
            _, kind, payload = Transport.split_traced(payload)
        if kind == K_COLV1:
            return wire.decode(payload, copy=copy)
        if kind == K_PICKLE:
            return pickle.loads(bytes(payload))
        raise TransportError("not a columnar frame: kind={}".format(kind))

    # -- lifecycle ----------------------------------------------------------

    def counters(self):
        out = {"frames_sent": self.frames_sent,
               "frames_received": self.frames_received,
               "bytes_sent": self.bytes_sent,
               "bytes_received": self.bytes_received,
               "colv1_sent": self.colv1_sent,
               "pickle_sent": self.pickle_sent}
        out.update(self.compress_stats)
        return out

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
