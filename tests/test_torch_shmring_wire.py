"""The JAX package's shm-ring and colv1 wire tests (``tests/test_shmring.py``
and ``tests/test_wire_formats.py``), re-pointed at the port's copies of
``shmring``, ``wire`` and ``marker``.  Left out: the TFRecord and
Example-proto properties (those modules are not ported) and the slow
``python -O`` rerun."""

import multiprocessing
import os
import pickle
import uuid

import numpy as np
import pytest

from tensorflowonspark_torch import marker, shmring, wire

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # property tests skip where absent
    HAVE_HYPOTHESIS = False


ring_required = pytest.mark.skipif(not shmring.available(),
                                   reason="native shm ring unavailable")


# -- shmring --------------------------------------------------------------

@pytest.fixture
def ring():
    name = "/tfos_test_{}".format(uuid.uuid4().hex[:12])
    r = shmring.Ring.create_or_attach(name, capacity=1 << 20)
    assert r is not None
    yield r
    r.detach(unlink=True)


@ring_required
def test_roundtrip_bytes(ring):
    ring.put_bytes(b"hello")
    ring.put_bytes(b"" )
    ring.put_bytes(b"x" * 100000)
    assert ring.get_bytes() == b"hello"
    assert ring.get_bytes() == b""
    assert ring.get_bytes() == b"x" * 100000


@ring_required
def test_pickle_objects(ring):
    ring.put({"a": [1, 2, 3], "b": "text"})
    assert ring.get() == {"a": [1, 2, 3], "b": "text"}


@ring_required
def test_wraparound_many_records(ring):
    # total volume >> capacity forces many wraps; interleave put/get
    payloads = [os.urandom((i * 7919) % 40000 + 1) for i in range(200)]
    got = []
    it = iter(payloads)
    pending = 0
    sent = 0
    for p in payloads:
        ring.put_bytes(p)
        sent += 1
        pending += 1
        if pending >= 8:  # drain in bursts so the ring must wrap
            for _ in range(pending):
                got.append(ring.get_bytes())
            pending = 0
    for _ in range(pending):
        got.append(ring.get_bytes())
    assert got == payloads


@ring_required
def test_oversized_record_returns_false(ring):
    assert ring.put_bytes(b"y" * (2 << 20)) is False  # > capacity


@ring_required
def test_close_semantics(ring):
    ring.put_bytes(b"last")
    ring.close_writes()
    assert ring.get_bytes() == b"last"  # drains before raising
    with pytest.raises(shmring.RingClosed):
        ring.get_bytes(timeout_secs=1)
    ring.reopen()
    ring.put_bytes(b"again")
    assert ring.get_bytes() == b"again"


@ring_required
def test_read_timeout(ring):
    with pytest.raises(TimeoutError):
        ring.get_bytes(timeout_secs=0.2)


def _producer(name, n, chunk):
    r = shmring.Ring.attach(name)
    for i in range(n):
        r.put_bytes(bytes([i % 256]) * chunk)
    r.close_writes()
    r.detach()


@ring_required
def test_cross_process_throughput(ring):
    # real two-process SPSC: producer in a child, consumer here
    n, chunk = 500, 32768
    proc = multiprocessing.get_context("spawn").Process(
        target=_producer, args=(ring.name, n, chunk))
    proc.start()
    got = 0
    try:
        while True:
            try:
                data = ring.get_bytes(timeout_secs=30)
            except shmring.RingClosed:
                break
            assert len(data) == chunk
            assert data[0] == got % 256
            got += 1
    finally:
        proc.join(30)
    assert got == n
    assert proc.exitcode == 0


# ---------------------------------------------------------------------------
# columnar frame (wire.py): deterministic coverage
# ---------------------------------------------------------------------------

NUMERIC_DTYPES = [
    np.bool_, np.int8, np.int16, np.int32, np.int64,
    np.uint8, np.uint16, np.uint32, np.uint64,
    np.float16, np.float32, np.float64,
    np.complex64, np.complex128,
]


def _roundtrip(columns, count, tuple_rows, copy=True):
    buf = wire.frame_bytes(columns, count, tuple_rows)
    assert buf is not None
    return wire.decode(buf, copy=copy)


@pytest.mark.parametrize("dtype", NUMERIC_DTYPES,
                         ids=[np.dtype(d).name for d in NUMERIC_DTYPES])
def test_frame_roundtrip_numeric_dtypes(dtype):
    rng = np.random.default_rng(0)
    a = (rng.random((5, 3)) * 100).astype(dtype)
    b = (rng.random((5,)) * 100).astype(dtype)
    cols, count, tuple_rows = _roundtrip((a, b), 5, True)
    assert count == 5 and tuple_rows
    assert cols[0].dtype == a.dtype and cols[1].dtype == b.dtype
    np.testing.assert_array_equal(cols[0], a)
    np.testing.assert_array_equal(cols[1], b)


def test_frame_roundtrip_bf16_as_uint16():
    # bfloat16 travels as its uint16 bit-pattern carrier: the custom dtype
    # itself isn't in the framable kinds, but its view round-trips
    # bit-exactly and the consumer can reinterpret.
    bits = np.array([0x3F80, 0x4000, 0xC0A0, 0x0000, 0x7F80],
                    np.uint16).reshape(5, 1)
    cols, count, _ = _roundtrip((bits,), 5, False)
    np.testing.assert_array_equal(cols[0], bits)
    assert cols[0].dtype == np.uint16
    try:
        import ml_dtypes
    except ImportError:
        return
    bf = bits.view(ml_dtypes.bfloat16)
    if np.dtype(ml_dtypes.bfloat16).kind not in wire._FRAMABLE_KINDS:
        # the raw custom dtype must soft-fall-back, never mis-frame
        assert wire.encode((bf,), 5, False) is None


def test_frame_roundtrip_zero_dim_and_empty_columns():
    scalar = np.array(3.5, np.float32)         # 0-d: ndim 0, 1 element
    empty = np.empty((0, 7), np.int64)         # 0 rows, nbytes 0
    cols, count, tuple_rows = _roundtrip((scalar, empty), 0, True)
    assert cols[0].shape == () and cols[0] == np.float32(3.5)
    assert cols[1].shape == (0, 7) and cols[1].dtype == np.int64


def test_encode_rejects_non_contiguous_and_object_columns():
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    assert wire.encode((base[:, ::2],), 4, False) is None       # strided
    assert wire.encode((base.T,), 6, False) is None             # transposed
    assert wire.encode((np.array([b"x", b"yy"], object),), 2, False) is None
    assert wire.encode((np.array(["a", "b"]),), 2, False) is None  # unicode
    assert wire.encode(([1, 2, 3],), 3, False) is None          # non-ndarray
    # and the soft-fallback composes with put-side framing: a contiguous
    # copy of the same data IS framable
    assert wire.encode((np.ascontiguousarray(base[:, ::2]),), 4,
                       False) is not None


def test_decode_rejects_truncated_and_corrupt_frames():
    good = wire.frame_bytes((np.arange(6, dtype=np.int32).reshape(2, 3),),
                            2, False)
    # truncated: below fixed-header size, and mid-frame
    with pytest.raises(wire.FrameError):
        wire.decode(good[:10])
    with pytest.raises(wire.FrameError):
        wire.decode(good[:-4])
    # bad magic
    bad = bytearray(good)
    bad[:4] = b"XXXX"
    with pytest.raises(wire.FrameError):
        wire.decode(bytes(bad))
    # unsupported version
    bad = bytearray(good)
    bad[4] = 99
    with pytest.raises(wire.FrameError):
        wire.decode(bytes(bad))
    # corrupt descriptor: nbytes no longer matches shape x itemsize
    bad = bytearray(good)
    import struct as _struct
    desc_off = wire._FIXED.size
    dstr, ndim, res, off, nbytes = wire._DESC.unpack_from(bad, desc_off)
    wire._DESC.pack_into(bad, desc_off, dstr, ndim, res, off, nbytes + 4)
    with pytest.raises(wire.FrameError):
        wire.decode(bytes(bad))
    # column extent pointing outside the frame
    bad = bytearray(good)
    wire._DESC.pack_into(bad, desc_off, dstr, ndim, res, len(good), nbytes)
    with pytest.raises(wire.FrameError):
        wire.decode(bytes(bad))
    del _struct
    # the pristine frame still decodes (the mutations above were on copies)
    cols, count, _ = wire.decode(good)
    assert count == 2
    np.testing.assert_array_equal(cols[0],
                                  np.arange(6, dtype=np.int32).reshape(2, 3))


# ---------------------------------------------------------------------------
# per-column wire compression (negotiated codecs)
# ---------------------------------------------------------------------------

# every codec this host can encode, plus explicit levels — lz4 joins the
# matrix automatically where the package is importable
CODECS = ["none", "zlib", "zlib-0", "zlib-9"]
if wire.codec_supported("lz4"):
    CODECS.append("lz4")


def _compressible(dtype, rows=64):
    """Tiled (compressible) 2-D column + 1-D column of ``dtype`` big enough
    to clear the codec's minimum-size gate."""
    base = np.arange(16).reshape(1, 16) % 7
    a = np.ascontiguousarray(np.tile(base, (rows, 4)).astype(dtype))
    b = np.ascontiguousarray((np.arange(rows * 128) % 5).astype(dtype))
    return a, b


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", NUMERIC_DTYPES,
                         ids=[np.dtype(d).name for d in NUMERIC_DTYPES])
def test_codec_roundtrip_matrix(codec, dtype):
    a, b = _compressible(dtype)
    stats, info = {}, {}
    buf = wire.frame_bytes((a, b), len(a), True, codec=codec, stats=stats)
    cols, count, tuple_rows = wire.decode(buf, info=info)
    assert count == len(a) and tuple_rows
    np.testing.assert_array_equal(cols[0], a)
    np.testing.assert_array_equal(cols[1], b)
    assert cols[0].dtype == a.dtype and cols[1].dtype == b.dtype
    if codec in ("none", "zlib-0"):
        # zlib level 0 stores without compressing, so the pay-off check
        # keeps every column raw — bit-identical to the uncompressed frame
        assert buf == wire.frame_bytes((a, b), len(a), True)
        assert info["codecs"] == []
    else:
        assert stats["cols_compressed"] == 2
        assert stats["wire_bytes"] < stats["raw_bytes"]
        assert info["codecs"] == [codec.split("-")[0]]
        assert info["raw_bytes"] == len(wire.frame_bytes((a, b), len(a),
                                                         True))


@pytest.mark.parametrize("codec", [c for c in CODECS if c != "none"])
def test_codec_roundtrip_bf16_as_uint16(codec):
    # the bf16 carrier convention survives compression: uint16 bit patterns
    # round-trip bit-exactly through the codec
    bits = np.ascontiguousarray(
        np.tile(np.array([0x3F80, 0x4000, 0xC0A0, 0x0000, 0x7F80],
                         np.uint16), (64, 2)))
    buf = wire.frame_bytes((bits,), len(bits), False, codec=codec)
    cols, count, _ = wire.decode(buf)
    assert cols[0].dtype == np.uint16
    np.testing.assert_array_equal(cols[0], bits)


@pytest.mark.parametrize("codec", CODECS)
def test_codec_empty_and_zero_dim_columns(codec):
    scalar = np.array(3.5, np.float32)
    empty = np.empty((0, 7), np.int64)
    buf = wire.frame_bytes((scalar, empty), 0, True, codec=codec)
    cols, count, _ = wire.decode(buf)
    assert cols[0].shape == () and cols[0] == np.float32(3.5)
    assert cols[1].shape == (0, 7) and cols[1].dtype == np.int64


def test_incompressible_columns_stay_raw():
    # random mantissas don't compress: the sampled pay-off check must leave
    # the column raw and the frame identical to an uncompressed one
    rng = np.random.default_rng(3)
    col = rng.random((256, 64))
    stats = {}
    buf = wire.frame_bytes((col,), 256, False, codec="zlib", stats=stats)
    assert stats["cols_compressed"] == 0 and stats["cols_raw"] == 1
    assert buf == wire.frame_bytes((col,), 256, False)
    cols, _, _ = wire.decode(buf)
    np.testing.assert_array_equal(cols[0], col)


def test_small_columns_skip_codec_framing():
    # columns under the minimum-size gate never pay for codec overhead
    tiny = np.zeros((4, 4), np.float32)   # 64 bytes, trivially compressible
    buf = wire.frame_bytes((tiny,), 4, False, codec="zlib")
    assert buf == wire.frame_bytes((tiny,), 4, False)


def test_decode_rejects_unknown_codec_tag():
    a, _ = _compressible(np.float32)
    buf = bytearray(wire.frame_bytes((a,), len(a), False, codec="zlib"))
    desc_off = wire._FIXED.size
    dstr, ndim, tag, off, nbytes = wire._DESC.unpack_from(buf, desc_off)
    assert tag == wire._CODEC_ZLIB
    wire._DESC.pack_into(buf, desc_off, dstr, ndim, 9, off, nbytes)
    with pytest.raises(wire.FrameError, match="unknown codec tag 9"):
        wire.decode(bytes(buf))


@pytest.mark.skipif(wire.codec_supported("lz4"),
                    reason="lz4 importable here: the unavailable-codec "
                           "error path can't trigger")
def test_decode_names_unavailable_codec():
    a, _ = _compressible(np.float32)
    buf = bytearray(wire.frame_bytes((a,), len(a), False, codec="zlib"))
    desc_off = wire._FIXED.size
    dstr, ndim, tag, off, nbytes = wire._DESC.unpack_from(buf, desc_off)
    wire._DESC.pack_into(buf, desc_off, dstr, ndim, wire._CODEC_LZ4, off,
                         nbytes)
    with pytest.raises(wire.FrameError,
                       match="codec lz4.*not.*available on this host"):
        wire.decode(bytes(buf))


def test_decode_rejects_corrupt_compressed_body():
    a, _ = _compressible(np.float32)
    buf = bytearray(wire.frame_bytes((a,), len(a), False, codec="zlib"))
    # trash the compressed body (past the header) — must surface as a
    # FrameError naming the codec, not a bare zlib.error
    desc_off = wire._FIXED.size
    _, _, _, off, nbytes = wire._DESC.unpack_from(buf, desc_off)
    for i in range(off + 2, min(off + 34, off + nbytes)):
        buf[i] ^= 0xFF
    with pytest.raises(wire.FrameError, match="codec zlib"):
        wire.decode(bytes(buf))


def test_frame_bytes_rejects_unknown_codec_name():
    a, _ = _compressible(np.float32)
    with pytest.raises(ValueError, match="unknown wire codec"):
        wire.frame_bytes((a,), len(a), False, codec="snappy")
    with pytest.raises(ValueError, match="zlib level"):
        wire.frame_bytes((a,), len(a), False, codec="zlib-11")


def test_codec_negotiation_prefers_consumer_order():
    assert "zlib" in wire.supported_codecs()
    assert wire.supported_codecs()[-1] == "none"
    assert wire.negotiate_codec(["zlib-9", "zlib"]) == "zlib-9"
    assert wire.negotiate_codec(["snappy", "zlib"]) == "zlib"
    assert wire.negotiate_codec(["snappy"]) is None
    assert wire.negotiate_codec(["none"]) is None     # raw is "no codec"
    assert wire.negotiate_codec(None) is None         # legacy hello
    if not wire.codec_supported("lz4"):
        assert wire.negotiate_codec(["lz4", "zlib"]) == "zlib"


def test_compressed_frame_decode_info_and_views():
    a, b = _compressible(np.int64)
    buf = wire.frame_bytes((a, b), len(a), True, codec="zlib")
    info = {}
    # copy=False on a compressed frame: columns come from the private
    # decompression buffer, never views into `buf`
    cols, _, _ = wire.decode(buf, copy=False, info=info)
    backing = np.frombuffer(buf, np.uint8)
    assert not np.shares_memory(cols[0], backing)
    np.testing.assert_array_equal(cols[0], a)
    assert info["cols_compressed"] == 2


def test_decode_copy_false_returns_views_copy_true_owns():
    col = np.arange(12, dtype=np.float64).reshape(3, 4)
    buf = wire.frame_bytes((col,), 3, False)
    views, _, _ = wire.decode(buf, copy=False)
    backing = np.frombuffer(buf, np.uint8)
    assert np.shares_memory(views[0], backing)
    owned, _, _ = wire.decode(buf, copy=True)
    assert not np.shares_memory(owned[0], backing)
    np.testing.assert_array_equal(owned[0], col)


def test_encode_chunk_decode_chunk_symmetry():
    chunk = marker.ColChunk(
        (np.arange(8, dtype=np.float32).reshape(4, 2),
         np.array([0, 1, 2, 3], np.int64)), 4, True)
    parts = wire.encode_chunk(chunk)
    assert parts is not None and len(parts) == 3
    buf = b"".join(p.tobytes() if isinstance(p, np.ndarray) else p
                   for p in parts)
    out = wire.decode_chunk(buf)
    assert isinstance(out, marker.ColChunk)
    assert out.count == 4 and out.tuple_rows
    assert out.row(2) == (pytest.approx(np.array([4.0, 5.0], np.float32)), 2)


# ---------------------------------------------------------------------------
# framed records through the real ring (skip where the native lib is absent)
# ---------------------------------------------------------------------------


@ring_required
def test_ring_writev_peek_roundtrip_interleaved_with_pickle():
    name = "/tfos_test_wire_{}".format(uuid.uuid4().hex[:8])
    ring = shmring.Ring.create_or_attach(name, 1 << 20)
    assert ring is not None
    try:
        chunk = marker.ColChunk(
            (np.arange(12, dtype=np.float32).reshape(3, 4),
             np.array([7, 8, 9], np.int64)), 3, True)
        assert ring.put_vectored(wire.encode_chunk(chunk), timeout_secs=5)
        blob = pickle.dumps({"k": 1})
        assert ring.put_bytes(blob, timeout_secs=5)
        # framed record via two-phase peek/consume
        view = ring.peek(timeout_secs=5)
        out = wire.decode_chunk(view, copy=True)
        ring.consume()
        np.testing.assert_array_equal(out.columns[0], chunk.columns[0])
        np.testing.assert_array_equal(out.columns[1], chunk.columns[1])
        # pickled record after it, untouched by the framed read
        assert pickle.loads(ring.get_bytes(timeout_secs=5)) == {"k": 1}
        # zero-copy decode reads the ring memory in place
        assert ring.put_vectored(wire.encode_chunk(chunk), timeout_secs=5)
        zc = wire.decode_chunk(ring.peek(timeout_secs=5), copy=False)
        np.testing.assert_array_equal(zc.columns[0], chunk.columns[0])
        ring.consume()
    finally:
        ring.detach(unlink=True)


@ring_required
def test_short_read_raises_runtime_error(monkeypatch):
    # the desync check must be a RuntimeError (not an assert): it guards
    # training-data integrity, so it must survive python -O
    name = "/tfos_test_short_{}".format(uuid.uuid4().hex[:8])
    ring = shmring.Ring.create_or_attach(name, 1 << 16)
    assert ring is not None
    try:
        assert ring.put_bytes(b"x" * 100, timeout_secs=5)
        lib = shmring._lib()
        monkeypatch.setattr(lib, "shmring_pop",
                            lambda h, buf, n: int(n) - 1)
        with pytest.raises(RuntimeError, match="short read"):
            ring.get_bytes(timeout_secs=5)
    finally:
        monkeypatch.undo()
        ring.detach(unlink=True)


# ---------------------------------------------------------------------------
# property-based tier (requires hypothesis)
# ---------------------------------------------------------------------------

if HAVE_HYPOTHESIS:
    @settings(max_examples=30, deadline=None)
    @given(st.integers(min_value=1, max_value=64),
           st.integers(min_value=1, max_value=5),
           st.sampled_from(["f4", "i8", "u1"]))
    def test_colchunk_pack_row_roundtrip(n_rows, arity, dtype):
        rng = np.random.RandomState(n_rows * 7 + arity)
        cols = tuple(rng.randint(0, 100, size=(n_rows, 3)).astype(dtype)
                     for _ in range(arity))
        rows = [tuple(col[i] for col in cols) for i in range(n_rows)]
        chunk = marker.pack_columnar(rows)
        if isinstance(chunk, marker.ColChunk):
            assert chunk.count == n_rows
            for i in range(n_rows):
                row = chunk.row(i)
                for f in range(arity):
                    np.testing.assert_array_equal(np.asarray(row[f]),
                                                  cols[f][i])

    @settings(max_examples=40, deadline=None)
    @given(st.integers(min_value=0, max_value=32),
           st.integers(min_value=1, max_value=4),
           st.sampled_from(["?", "u1", "i2", "i4", "i8", "u8",
                            "f2", "f4", "f8", "c8"]),
           st.booleans())
    def test_wire_frame_roundtrip_property(n_rows, arity, dtype, tuple_rows):
        rng = np.random.RandomState(n_rows * 31 + arity)
        cols = tuple(
            rng.randint(0, 2 if dtype == "?" else 100,
                        size=(n_rows, f + 1)).astype(dtype)
            for f in range(arity))
        got, count, tr = _roundtrip(cols, n_rows, tuple_rows)
        assert count == n_rows and tr == tuple_rows
        for a, b in zip(got, cols):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
