"""TFRecord codec: read/write TFRecord files with masked-CRC32C framing.

The port's copy of :mod:`tensorflowonspark_tpu.tfrecord` (it never imported
jax); the copy is the port's own.

First-party replacement for the reference's bundled Hadoop jar (reference
``dfutil.py:39-41`` and ``DFUtil.scala:189-192`` delegate TFRecord framing
to Java ``TFRecordFileInput/OutputFormat`` from
``lib/tensorflow-hadoop-1.0-SNAPSHOT.jar``; its wire format is
length + masked crc32c(length) + payload + masked crc32c(payload)).

Two interchangeable engines:

- the C++ library (``native/tfrecord.cc``) via ctypes — the fast path for
  bulk host-side ingestion;
- a pure-Python fallback (struct + table-driven crc32c) used when no
  toolchain is available.  Same files, bit-identical output.
"""

import ctypes
import logging
import struct

from tensorflowonspark_torch import fsio, native

logger = logging.getLogger(__name__)

_MASK_DELTA = 0xA282EAD8


def _make_crc_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _make_crc_table()


def _crc32c_py(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _lib():
    lib = native.load("tfrecord")
    if lib is not None and not getattr(lib, "_tfr_ready", False):
        lib.tfr_crc32c.restype = ctypes.c_uint32
        lib.tfr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.tfr_masked_crc32c.restype = ctypes.c_uint32
        lib.tfr_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.tfr_writer_open.restype = ctypes.c_void_p
        lib.tfr_writer_open.argtypes = [ctypes.c_char_p]
        lib.tfr_write.restype = ctypes.c_int
        lib.tfr_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64]
        lib.tfr_writer_flush.restype = ctypes.c_int
        lib.tfr_writer_flush.argtypes = [ctypes.c_void_p]
        lib.tfr_writer_close.restype = ctypes.c_int
        lib.tfr_writer_close.argtypes = [ctypes.c_void_p]
        lib.tfr_reader_open.restype = ctypes.c_void_p
        lib.tfr_reader_open.argtypes = [ctypes.c_char_p]
        lib.tfr_read_next.restype = ctypes.c_int64
        lib.tfr_read_next.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.tfr_reader_close.restype = ctypes.c_int
        lib.tfr_reader_close.argtypes = [ctypes.c_void_p]
        lib._tfr_ready = True
    return lib


def crc32c(data):
    lib = _lib()
    if lib is not None:
        return lib.tfr_crc32c(bytes(data), len(data))
    return _crc32c_py(data)


def masked_crc32c(data):
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


class TFRecordWriter(object):
    """Writes TFRecord files (C++ engine when available)."""

    def __init__(self, path, use_native=True):
        path = fsio.strip_file_scheme(path)
        self.path = path
        self._handle = None
        self._file = None
        # the C++ engine does its own fopen: local paths only; remote URLs
        # (gs:// etc.) stream through fsspec via the python framing path
        lib = (_lib() if use_native and not fsio.is_remote(path) else None)
        if lib is not None:
            self._lib = lib
            self._handle = lib.tfr_writer_open(path.encode())
            if not self._handle:
                raise IOError("cannot open {} for writing".format(path))
        else:
            self._lib = None
            self._file = fsio.open_file(path, "wb")

    def write(self, record):
        record = bytes(record)
        if self._handle is not None:
            if self._lib.tfr_write(self._handle, record, len(record)):
                raise IOError("write failed on {}".format(self.path))
        else:
            header = struct.pack("<Q", len(record))
            self._file.write(header)
            self._file.write(struct.pack("<I", masked_crc32c(header)))
            self._file.write(record)
            self._file.write(struct.pack("<I", masked_crc32c(record)))

    def flush(self):
        if self._handle is not None:
            if self._lib.tfr_writer_flush(self._handle):
                raise IOError("flush failed on {}".format(self.path))
        else:
            self._file.flush()

    def close(self):
        if self._handle is not None:
            handle, self._handle = self._handle, None
            if self._lib.tfr_writer_close(handle):
                # fclose failure = buffered tail never hit disk (e.g. ENOSPC)
                raise IOError("close failed on {}".format(self.path))
        elif self._file is not None:
            f, self._file = self._file, None
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def tfrecord_iterator(path, use_native=True, verify_crc=True):
    """Yield raw record bytes from a TFRecord file, verifying CRCs.

    Local files prefer the C++ engine; remote URLs (``gs://``, ``hdfs://``,
    ``memory://``, ...) stream through :mod:`fsio`'s fsspec branch with the
    same framing checks.

    ``verify_crc=False`` skips both CRC checks (framing lengths still
    guard against truncation) — for hot read paths over data this process
    tree wrote and verified at write time, e.g. the pre-decoded ImageNet
    rows, where the masked-crc pass costs more than the entire record
    parse (measured 0.25 ms vs 0.05 ms on 196 KB rows, docs/PERF.md
    round 5).  The native engine always verifies; skipping routes through
    the python framing loop, which is FASTER than native-with-crc for
    large records (one syscall-sized read per field, no per-byte work)."""
    path = fsio.strip_file_scheme(path)
    lib = (_lib() if use_native and verify_crc
           and not fsio.is_remote(path) else None)
    if lib is not None:
        handle = lib.tfr_reader_open(path.encode())
        if not handle:
            raise IOError("cannot open {} for reading".format(path))
        try:
            out = ctypes.POINTER(ctypes.c_uint8)()
            while True:
                n = lib.tfr_read_next(handle, ctypes.byref(out))
                if n == -1:
                    return
                if n < 0:
                    raise IOError("corrupt TFRecord in {}".format(path))
                yield ctypes.string_at(out, n)
        finally:
            lib.tfr_reader_close(handle)
    else:
        with fsio.open_file(path, "rb") as f:
            while True:
                header = f.read(8)
                if not header:
                    return
                if len(header) != 8:
                    raise IOError("truncated TFRecord header in {}".format(path))
                (length,) = struct.unpack("<Q", header)
                crc_bytes = f.read(4)
                if len(crc_bytes) != 4:
                    raise IOError("truncated TFRecord header in {}".format(path))
                if verify_crc:
                    (len_crc,) = struct.unpack("<I", crc_bytes)
                    if masked_crc32c(header) != len_crc:
                        raise IOError(
                            "corrupt TFRecord length in {}".format(path))
                record = f.read(length)
                if len(record) != length:
                    raise IOError("truncated TFRecord in {}".format(path))
                crc_bytes = f.read(4)
                if len(crc_bytes) != 4:
                    raise IOError("truncated TFRecord in {}".format(path))
                if verify_crc:
                    (data_crc,) = struct.unpack("<I", crc_bytes)
                    if masked_crc32c(record) != data_crc:
                        raise IOError(
                            "corrupt TFRecord data in {}".format(path))
                yield record
