"""Self-describing zero-copy columnar wire format for the shm-ring feed plane.

The ring's original fast path pickled each
:class:`~tensorflowonspark_torch.marker.ColChunk` — PERF.md's stage profile
shows that pack+pickle (3.57 ms) plus unpickle (1.88 ms) per 1024-row batch
dwarf the raw ring round-trip (1.57 ms), and every payload byte was copied
twice more through intermediate pickle buffers.  This module replaces the
pickle bytes with a **frame**: a small self-describing header followed by
each column's raw buffer, so the producer gather-writes the columns
straight into the ring (``Ring.put_vectored`` — one memcpy per column) and
the consumer wraps the in-ring record with ``np.frombuffer`` views and
copies each column exactly once (``decode(copy=True)``), directly into
batch assembly.  tf.data (arXiv:2101.12127) and the tf.data service
(arXiv:2210.14826) both identify exactly this host-side input
serialization as the scaling wall once transport is fast.

Frame layout (all little-endian, no alignment padding)::

    fixed header (32 bytes):
      0:4    magic  b"TFWC"
      4:6    u16    version (1)
      6:8    u16    flags   (bit 0: tuple_rows)
      8:12   u32    ncols
      12:20  u64    count        (rows promised — the token desync check)
      20:28  u64    frame_len    (total frame bytes, header included)
      28:32  u32    header_len   (data section offset = end of descriptors)
    per-column descriptor (32 + 8*ndim bytes):
      8s     dtype.str, NUL-padded (e.g. b"<f4")
      u32    ndim
      u32    reserved (0)
      u64    offset   (column data start, from frame start)
      u64    nbytes
      u64*n  shape

Only plain numeric/bool/complex dtypes (``dtype.kind in "biufc"``) on
C-contiguous arrays are framable; anything else (object columns, unicode,
non-contiguous views, ragged data) returns ``None`` from :func:`encode`
and the caller falls back to the pickled transport — the same soft-fallback
contract :func:`~tensorflowonspark_torch.columnar.rows_to_fields` uses.

**Per-column wire compression** (byte-stream transports only — the shm
ring gather-writes raw column buffers and never compresses): the
per-column descriptor's reserved word carries a codec tag (0 = raw).  A
tagged column's ``nbytes`` is its on-wire (compressed) size; the true
size is recomputed from shape × itemsize and validated after
decompression.  Codecs are stdlib ``zlib`` (``"zlib"`` /
``"zlib-<level>"``) plus ``lz4`` when the optional ``lz4`` package is
importable; which codec a producer may use is negotiated out-of-band at
stream dial (see :meth:`dataservice.ServiceFeed`), riding the same
format-tag convention as the pickle fallback, and each column is
compressed only when a sampled ratio check says it pays — incompressible
columns stay raw inside an otherwise-compressed frame.
"""

import math
import os
import struct
import zlib

import numpy as np

try:  # optional codec — never a hard dependency (bare containers lack it)
    import lz4.frame as _lz4
except Exception:  # pragma: no cover - import-environment dependent
    _lz4 = None

__all__ = [
    "FrameError", "WIRE_PICKLE", "WIRE_COLV1", "enabled",
    "encode", "encode_chunk", "frame_bytes", "frame_chunk_bytes", "decode",
    "decode_chunk", "supported_codecs", "codec_supported", "negotiate_codec",
]

MAGIC = b"TFWC"
VERSION = 1

# Wire-format tags carried by marker.ShmChunk tokens (and reported by
# DataFeed.wire_formats / the bench feedplane leg):
WIRE_PICKLE = "pickle"   # pickled Chunk/ColChunk object bytes (legacy path)
WIRE_COLV1 = "colv1"     # this module's columnar frame, version 1

_FIXED = struct.Struct("<4sHHIQQI")     # magic ver flags ncols count flen hlen
_DESC = struct.Struct("<8sIIQQ")        # dtype ndim codec offset nbytes

_FRAMABLE_KINDS = "biufc"   # bool, (u)int, float, complex — raw-copy safe

# Frame flags (fixed-header u16)
FLAG_TUPLE_ROWS = 0x1
FLAG_COMPRESSED = 0x2   # at least one column carries a codec tag

# Per-column codec tags (the descriptor word that was reserved=0 in the
# original frame layout, so raw frames are bit-identical to version 1
# frames from before compression existed)
_CODEC_RAW = 0
_CODEC_ZLIB = 1
_CODEC_LZ4 = 2
_CODEC_NAMES = {_CODEC_ZLIB: "zlib", _CODEC_LZ4: "lz4"}

_ZLIB_DEFAULT_LEVEL = 1   # speed-dominant: wire compression rides hot paths

# Pay-off sampling: compress at most _SAMPLE_MAX leading bytes of a column
# first; only if the sample shrinks below _PAY_RATIO is the full column
# compressed (and even then the full result must actually be smaller).
# Columns under _MIN_COL_BYTES never pay for the codec framing overhead.
_SAMPLE_MAX = 1 << 16
_PAY_RATIO = 0.9
_MIN_COL_BYTES = 512


class FrameError(ValueError):
    """A buffer is not a valid columnar frame (truncated, corrupt, or an
    unsupported version) — the consumer must not trust any of its fields."""


def enabled():
    """Whether the framed path may be used (``TFOS_WIRE_FORMAT=pickle``
    forces the pickled transport — the A/B knob for profiling and parity
    testing)."""
    return os.environ.get("TFOS_WIRE_FORMAT", "").lower() != WIRE_PICKLE


def _parse_codec(name):
    """``(tag, level)`` for a codec name; raises ``ValueError`` on a name
    this host cannot encode (unknown, or ``lz4`` without the package)."""
    if name is None or name == "none":
        return _CODEC_RAW, None
    if name == "zlib":
        return _CODEC_ZLIB, _ZLIB_DEFAULT_LEVEL
    if name.startswith("zlib-"):
        try:
            level = int(name[5:])
        except ValueError:
            raise ValueError("bad zlib level in codec {!r}".format(name))
        if not 0 <= level <= 9:
            raise ValueError("zlib level out of range in codec "
                             "{!r}".format(name))
        return _CODEC_ZLIB, level
    if name == "lz4":
        if _lz4 is None:
            raise ValueError("codec lz4 requested but the lz4 package is "
                             "not importable on this host")
        return _CODEC_LZ4, None
    raise ValueError("unknown wire codec {!r}".format(name))


def codec_supported(name):
    """Whether this host can encode AND decode codec ``name``."""
    try:
        _parse_codec(name)
    except ValueError:
        return False
    return True


def supported_codecs():
    """Codec names this host supports, in preference order (fastest
    first); always ends with ``"none"`` so negotiation can land on raw."""
    names = ["lz4"] if _lz4 is not None else []
    names += ["zlib", "none"]
    return names


def negotiate_codec(offered):
    """First codec in ``offered`` (the consumer's dial hello, its
    preference order) that this host supports, or ``None`` — the
    producer-side half of the dial negotiation."""
    for name in offered or ():
        if name != "none" and codec_supported(name):
            return name
    return None


def _compress(tag, level, data):
    if tag == _CODEC_ZLIB:
        return zlib.compress(bytes(data), level)
    if tag == _CODEC_LZ4:
        return _lz4.compress(bytes(data))
    raise ValueError("cannot compress with codec tag {}".format(tag))


def _decompress(tag, col_idx, data):
    """Raw bytes of a tagged column; :class:`FrameError` NAMES the codec
    (or its unknown tag) so a mixed-version fleet diagnoses itself."""
    name = _CODEC_NAMES.get(tag)
    if name is None:
        raise FrameError("column {} compressed with unknown codec tag {}"
                         .format(col_idx, tag))
    try:
        if tag == _CODEC_ZLIB:
            return zlib.decompress(bytes(data))
        if _lz4 is None:
            raise FrameError(
                "column {} compressed with codec {}, which is not "
                "available on this host".format(col_idx, name))
        return _lz4.decompress(bytes(data))
    except FrameError:
        raise
    except Exception as e:
        raise FrameError("column {} failed to decompress with codec {}: "
                         "{}".format(col_idx, name, e))


def compression_ratio(raw_bytes, wire_bytes):
    """Wire compression ratio ``raw / wire`` (> 1 when the codec saved
    bytes; 1.0 when nothing compressed or either side is unknown, so
    gauges and bench stats never divide by zero).  The JAX package's
    formula (its ``metrics.compression_ratio``), kept here with the codecs
    so the host planes that report it import no torch."""
    if not raw_bytes or not wire_bytes or wire_bytes <= 0:
        return 1.0
    return raw_bytes / float(wire_bytes)


def encode(columns, count, tuple_rows):
    """Frame ``columns`` for a gather write.

    Returns ``[header_bytes, col0, col1, ...]`` — the header plus the column
    ndarrays themselves, ready for ``Ring.put_vectored`` (no column bytes
    are copied here) — or ``None`` when the columns aren't framable
    (non-ndarray, non-numeric dtype, or non-contiguous: callers fall back
    to pickle).
    """
    descs = []
    header_len = _FIXED.size + sum(
        _DESC.size + 8 * getattr(c, "ndim", 0) for c in columns)
    offset = header_len
    for col in columns:
        if not isinstance(col, np.ndarray):
            return None
        if col.dtype.kind not in _FRAMABLE_KINDS:
            return None
        if not col.flags.c_contiguous:
            return None
        dstr = col.dtype.str.encode("ascii")
        if len(dstr) > 8:
            return None
        descs.append(_DESC.pack(dstr, col.ndim, 0, offset, col.nbytes)
                     + struct.pack("<%dQ" % col.ndim, *col.shape))
        offset += col.nbytes
    header = _FIXED.pack(MAGIC, VERSION, 1 if tuple_rows else 0,
                         len(columns), count, offset, header_len)
    return [header + b"".join(descs)] + list(columns)


def encode_chunk(chunk):
    """Frame a :class:`~tensorflowonspark_torch.marker.ColChunk` (or ``None``
    when it isn't framable)."""
    return encode(chunk.columns, chunk.count, chunk.tuple_rows)


def _column_wire_form(col, tag, level):
    """``(codec_tag, wire_bytes)`` for one column: the compressed bytes
    when the sampled ratio check says the codec pays, else the raw buffer
    (tag 0).  ``col`` is already framability-checked and C-contiguous."""
    if tag == _CODEC_RAW or col.nbytes < _MIN_COL_BYTES:
        return _CODEC_RAW, col
    data = memoryview(col).cast("B")
    if col.nbytes > _SAMPLE_MAX:
        sample = _compress(tag, level, data[:_SAMPLE_MAX])
        if len(sample) > _PAY_RATIO * _SAMPLE_MAX:
            return _CODEC_RAW, col
    comp = _compress(tag, level, data)
    if len(comp) >= _PAY_RATIO * col.nbytes:
        return _CODEC_RAW, col
    return tag, comp


def frame_bytes(columns, count, tuple_rows, codec=None, stats=None):
    """One contiguous frame as bytes (byte-stream transports / tests); the
    ring path uses :func:`encode`'s gather parts instead to skip this join.
    ``None`` when not framable.

    ``codec`` (a :func:`supported_codecs` name) enables per-column wire
    compression: each column is tagged and compressed only when the
    sampled ratio check says it pays.  ``stats``, when a dict, is
    incremented in place with ``raw_bytes`` / ``wire_bytes`` /
    ``cols_compressed`` / ``cols_raw`` / ``frames`` — the producer-side
    compression accounting (``raw_bytes`` is what the frame would have
    cost uncompressed).
    """
    tag, level = _parse_codec(codec)
    if tag == _CODEC_RAW:
        parts = encode(columns, count, tuple_rows)
        if parts is None:
            return None
        out = b"".join(p.tobytes() if isinstance(p, np.ndarray) else p
                       for p in parts)
        if stats is not None:
            stats["frames"] = stats.get("frames", 0) + 1
            stats["raw_bytes"] = stats.get("raw_bytes", 0) + len(out)
            stats["wire_bytes"] = stats.get("wire_bytes", 0) + len(out)
            stats["cols_raw"] = stats.get("cols_raw", 0) + len(columns)
        return out
    header_len = _FIXED.size + sum(
        _DESC.size + 8 * getattr(c, "ndim", 0) for c in columns)
    descs, bodies = [], []
    offset = header_len
    raw_total = header_len
    compressed = 0
    for col in columns:
        if (not isinstance(col, np.ndarray)
                or col.dtype.kind not in _FRAMABLE_KINDS
                or not col.flags.c_contiguous):
            return None
        dstr = col.dtype.str.encode("ascii")
        if len(dstr) > 8:
            return None
        ctag, body = _column_wire_form(col, tag, level)
        nbytes = body.nbytes if isinstance(body, np.ndarray) else len(body)
        descs.append(_DESC.pack(dstr, col.ndim, ctag, offset, nbytes)
                     + struct.pack("<%dQ" % col.ndim, *col.shape))
        bodies.append(body)
        offset += nbytes
        raw_total += col.nbytes
        compressed += ctag != _CODEC_RAW
    flags = (FLAG_TUPLE_ROWS if tuple_rows else 0) | (
        FLAG_COMPRESSED if compressed else 0)
    header = _FIXED.pack(MAGIC, VERSION, flags, len(columns), count,
                         offset, header_len)
    out = b"".join([header] + descs
                   + [b.tobytes() if isinstance(b, np.ndarray) else b
                      for b in bodies])
    if stats is not None:
        stats["frames"] = stats.get("frames", 0) + 1
        stats["raw_bytes"] = stats.get("raw_bytes", 0) + raw_total
        stats["wire_bytes"] = stats.get("wire_bytes", 0) + len(out)
        stats["cols_compressed"] = stats.get("cols_compressed", 0) + compressed
        stats["cols_raw"] = (stats.get("cols_raw", 0)
                             + len(columns) - compressed)
    return out


def frame_chunk_bytes(chunk, codec=None, stats=None):
    """One contiguous frame for a
    :class:`~tensorflowonspark_torch.marker.ColChunk` (``None`` when not
    framable) — the byte-stream transports' convenience (TCP data service);
    the ring path uses :func:`encode_chunk`'s gather parts.  ``codec`` /
    ``stats`` as :func:`frame_bytes`."""
    return frame_bytes(chunk.columns, chunk.count, chunk.tuple_rows,
                       codec=codec, stats=stats)


def decode(buf, copy=True, info=None):
    """Parse one frame; returns ``(columns, count, tuple_rows)``.

    ``copy=True`` (the ring path's contract): each column is copied exactly
    once out of ``buf`` — required when ``buf`` is in-ring memory that the
    producer reclaims after ``Ring.consume``.  ``copy=False`` returns
    zero-copy ``np.frombuffer`` views into ``buf`` (only safe while the
    caller keeps ``buf`` alive and unrecycled).  Compressed columns are
    always materialized from their freshly decompressed buffer, never as
    views into ``buf``.

    ``info``, when a dict, receives decode-side compression accounting:
    ``codecs`` (sorted names of codecs seen in this frame, empty when
    raw), ``raw_bytes`` (the frame's size had it been uncompressed), and
    ``cols_compressed``.

    Raises :class:`FrameError` on anything malformed: wrong magic/version,
    truncation, descriptor/shape inconsistencies, out-of-bounds column
    extents, an unknown or locally unavailable codec tag, or compressed
    data that does not decompress to the descriptor's shape.
    """
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    total = len(mv)
    if total < _FIXED.size:
        raise FrameError("frame shorter than fixed header "
                         "({} < {} bytes)".format(total, _FIXED.size))
    magic, version, flags, ncols, count, frame_len, header_len = \
        _FIXED.unpack_from(mv, 0)
    if magic != MAGIC:
        raise FrameError("bad frame magic {!r}".format(bytes(magic)))
    if version != VERSION:
        raise FrameError("unsupported frame version {}".format(version))
    if frame_len != total:
        raise FrameError("frame length mismatch: header says {} bytes, "
                         "buffer has {}".format(frame_len, total))
    if not _FIXED.size <= header_len <= total:
        raise FrameError("header_len {} out of range".format(header_len))
    columns = []
    codecs_seen = set()
    raw_total = header_len
    n_compressed = 0
    off = _FIXED.size
    for c in range(ncols):
        if off + _DESC.size > header_len:
            raise FrameError("descriptor {} overruns header".format(c))
        dstr, ndim, codec_tag, offset, nbytes = _DESC.unpack_from(mv, off)
        off += _DESC.size
        if off + 8 * ndim > header_len:
            raise FrameError("shape of column {} overruns header".format(c))
        shape = struct.unpack_from("<%dQ" % ndim, mv, off)
        off += 8 * ndim
        try:
            dtype = np.dtype(dstr.rstrip(b"\0").decode("ascii"))
        except (TypeError, UnicodeDecodeError) as e:
            raise FrameError("column {} has unparseable dtype: {}".format(c, e))
        if dtype.kind not in _FRAMABLE_KINDS:
            raise FrameError("column {} has non-framable dtype {}".format(
                c, dtype))
        n_elem = math.prod(shape)
        raw_nbytes = n_elem * dtype.itemsize
        raw_total += raw_nbytes
        if codec_tag == _CODEC_RAW and nbytes != raw_nbytes:
            raise FrameError(
                "column {} nbytes {} != shape {} x itemsize {}".format(
                    c, nbytes, shape, dtype.itemsize))
        if offset < header_len or offset + nbytes > total:
            raise FrameError("column {} extent [{}, {}) outside frame of "
                             "{} bytes".format(c, offset, offset + nbytes,
                                               total))
        if codec_tag == _CODEC_RAW:
            arr = np.frombuffer(mv, dtype=dtype, count=n_elem,
                                offset=offset).reshape(shape)
            columns.append(arr.copy() if copy else arr)
        else:
            raw = _decompress(codec_tag, c, mv[offset:offset + nbytes])
            if len(raw) != raw_nbytes:
                raise FrameError(
                    "column {} decompressed to {} bytes, expected shape {} "
                    "x itemsize {} = {}".format(c, len(raw), shape,
                                                dtype.itemsize, raw_nbytes))
            # the decompressed buffer is private to this column: a view of
            # it is already safe under both copy contracts
            columns.append(np.frombuffer(raw, dtype=dtype,
                                         count=n_elem).reshape(shape))
            codecs_seen.add(_CODEC_NAMES[codec_tag])
            n_compressed += 1
    if info is not None:
        info["codecs"] = sorted(codecs_seen)
        info["raw_bytes"] = raw_total
        info["cols_compressed"] = n_compressed
    return tuple(columns), count, bool(flags & FLAG_TUPLE_ROWS)


def decode_chunk(buf, copy=True, info=None):
    """Parse one frame into a :class:`~tensorflowonspark_torch.marker.ColChunk`.
    ``info`` as :func:`decode`."""
    from tensorflowonspark_torch import marker

    columns, count, tuple_rows = decode(buf, copy=copy, info=info)
    return marker.ColChunk(columns, count, tuple_rows)
