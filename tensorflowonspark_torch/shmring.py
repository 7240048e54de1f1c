"""Python face of the native shared-memory feed transport (``native/shmring.cc``).

Bulk chunk payloads move through a lock-free SPSC shared-memory ring between
the feed task and the training process; the manager ``JoinableQueue`` keeps
carrying one tiny ordering token per chunk
(:class:`~tensorflowonspark_torch.marker.ShmChunk`), so join/backpressure/
fail-fast semantics are exactly the chunked-queue path's — only the payload
bytes stop crossing the manager socket.  Falls back transparently (tokens
are only sent when the ring accepted the payload; oversized or ring-less
chunks travel in-queue as plain :class:`~tensorflowonspark_torch.marker.Chunk`).

The reference's counterpart was the manager proxy itself (reference
``TFManager.py``, per-element hops, SURVEY §3.2); this is the TPU-era
replacement for hosts that feed accelerators at GB/s.
"""

import ctypes
import logging
import os
import pickle

from tensorflowonspark_torch import native

logger = logging.getLogger(__name__)

DEFAULT_CAPACITY = int(os.environ.get("TFOS_SHM_RING_MB", "64")) << 20

_CLOSED = -2
_TIMEOUT = -1


def _lib():
    # librt: shm_open lives there until glibc 2.34 folded it into libc;
    # on newer glibc librt is an empty stub, so linking it is always safe.
    lib = native.load("shmring", libs=("rt",))
    if lib is None:
        return None
    if not getattr(lib, "_shmring_typed", False):
        lib.shmring_create.restype = ctypes.c_void_p
        lib.shmring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.shmring_attach.restype = ctypes.c_void_p
        lib.shmring_attach.argtypes = [ctypes.c_char_p]
        lib.shmring_write.restype = ctypes.c_int
        lib.shmring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_uint64]
        lib.shmring_writev.restype = ctypes.c_int
        lib.shmring_writev.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.POINTER(ctypes.c_uint64),
                                       ctypes.c_uint64, ctypes.c_uint64]
        lib.shmring_next_len.restype = ctypes.c_int64
        lib.shmring_next_len.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.shmring_peek.restype = ctypes.c_int64
        lib.shmring_peek.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.POINTER(ctypes.c_void_p)]
        lib.shmring_consume.argtypes = [ctypes.c_void_p]
        lib.shmring_pop.restype = ctypes.c_int64
        lib.shmring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64]
        lib.shmring_fill.restype = ctypes.c_uint64
        lib.shmring_fill.argtypes = [ctypes.c_void_p]
        lib.shmring_close.argtypes = [ctypes.c_void_p]
        lib.shmring_closed.restype = ctypes.c_int
        lib.shmring_closed.argtypes = [ctypes.c_void_p]
        lib.shmring_reopen.argtypes = [ctypes.c_void_p]
        lib.shmring_free.argtypes = [ctypes.c_void_p]
        lib.shmring_unlink.restype = ctypes.c_int
        lib.shmring_unlink.argtypes = [ctypes.c_char_p]
        lib._shmring_typed = True
    return lib


def available():
    return not os.environ.get("TFOS_DISABLE_SHM") and _lib() is not None


def ring_name(cluster_id, executor_id, qname):
    """shm object name for one executor queue's transport (namespaced by the
    per-run cluster id, so stale objects from crashed runs never collide)."""
    return "/tfos_{}_{}_{}".format(cluster_id, executor_id, qname)


class RingClosed(Exception):
    pass


class Ring(object):
    """Handle over one shm ring; producer and consumer both use this class.

    ``create_or_attach`` is what feeders/consumers call: the first process
    creates, everyone else attaches (the C side's O_EXCL create makes the
    race safe).
    """

    def __init__(self, handle, name):
        self._h = handle
        self.name = name
        # Plain-int telemetry tallies, always on: a few integer ops per
        # record is noise next to the memcpy, so the hot path needs no
        # enabled-check (telemetry merely *reads* these at heartbeat
        # cadence — see counters_snapshot()).
        self.writes = 0
        self.writevs = 0
        self.reads = 0
        self.peeks = 0
        self.consumes = 0
        self.occupancy_hwm = 0

    @classmethod
    def create_or_attach(cls, name, capacity=DEFAULT_CAPACITY):
        lib = _lib()
        if lib is None:
            return None
        h = lib.shmring_create(name.encode(), capacity)
        if not h:
            h = lib.shmring_attach(name.encode())
        if not h:
            logger.warning("cannot create/attach shm ring %s", name)
            return None
        return cls(h, name)

    @classmethod
    def attach(cls, name):
        lib = _lib()
        if lib is None:
            return None
        h = lib.shmring_attach(name.encode())
        if not h:
            return None
        return cls(h, name)

    def put_bytes(self, data, timeout_secs=600):
        """Write one record; returns True, or False if it can never fit
        (caller falls back to the queue path).  Raises on timeout."""
        rc = _lib().shmring_write(self._h, data, len(data),
                                  int(timeout_secs * 1000))
        if rc == 0:
            self.writes += 1
            fill = _lib().shmring_fill(self._h)
            if fill > self.occupancy_hwm:
                self.occupancy_hwm = fill
            return True
        if rc == -3:
            return False
        if rc == _CLOSED:
            raise RingClosed(self.name)
        raise TimeoutError(
            "shm ring {} write timed out after {}s (consumer stalled?)".format(
                self.name, timeout_secs))

    def put_vectored(self, parts, timeout_secs=600):
        """Gather-write ONE record from several buffers (bytes, or objects
        with the ndarray ``.ctypes``/``.nbytes`` surface) — one memcpy per
        buffer straight into the ring, no intermediate join/serialization
        buffer (the zero-copy columnar frame path, see
        :mod:`~tensorflowonspark_torch.wire`).  Same return/raise contract as
        :meth:`put_bytes`."""
        n = len(parts)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_uint64 * n)()
        keep = []  # pin bytes objects for the duration of the call
        for i, p in enumerate(parts):
            if hasattr(p, "ctypes"):  # ndarray (duck-typed: no numpy dep here)
                ptrs[i] = p.ctypes.data
                lens[i] = p.nbytes
            else:
                b = p if isinstance(p, bytes) else bytes(p)
                keep.append(b)
                ptrs[i] = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
                lens[i] = len(b)
        rc = _lib().shmring_writev(self._h, ptrs, lens, n,
                                   int(timeout_secs * 1000))
        del keep
        if rc == 0:
            self.writevs += 1
            fill = _lib().shmring_fill(self._h)
            if fill > self.occupancy_hwm:
                self.occupancy_hwm = fill
            return True
        if rc == -3:
            return False
        if rc == _CLOSED:
            raise RingClosed(self.name)
        raise TimeoutError(
            "shm ring {} write timed out after {}s (consumer stalled?)".format(
                self.name, timeout_secs))

    def get_bytes(self, timeout_secs=600):
        """Read one record; raises RingClosed at end, TimeoutError on stall."""
        lib = _lib()
        n = lib.shmring_next_len(self._h, int(timeout_secs * 1000))
        if n == _CLOSED:
            raise RingClosed(self.name)
        if n == _TIMEOUT:
            raise TimeoutError(
                "shm ring {} read timed out after {}s".format(
                    self.name, timeout_secs))
        buf = ctypes.create_string_buffer(int(n))
        got = lib.shmring_pop(self._h, buf, int(n))
        if got != n:
            # A short read means the ring is desynced — silently returning
            # truncated bytes would corrupt training data, and an assert
            # vanishes under python -O (the repo's rule for data-integrity
            # checks; see datafeed._ring_read's desync check).
            raise RuntimeError(
                "shm ring {} short read: next_len promised {} bytes, pop "
                "returned {}".format(self.name, n, got))
        self.reads += 1
        return buf.raw

    def peek(self, timeout_secs=600):
        """Two-phase zero-copy read, phase 1: a memoryview over the next
        record's bytes IN ring memory (no copy).  The view is valid only
        until :meth:`consume` releases the record back to the producer —
        copy whatever outlives the record before consuming.  Raises
        RingClosed at end, TimeoutError on stall (like :meth:`get_bytes`)."""
        lib = _lib()
        ptr = ctypes.c_void_p()
        n = lib.shmring_peek(self._h, int(timeout_secs * 1000),
                             ctypes.byref(ptr))
        if n == _CLOSED:
            raise RingClosed(self.name)
        if n == _TIMEOUT:
            raise TimeoutError(
                "shm ring {} read timed out after {}s".format(
                    self.name, timeout_secs))
        self.peeks += 1
        return memoryview((ctypes.c_ubyte * int(n)).from_address(ptr.value))

    def consume(self):
        """Two-phase zero-copy read, phase 2: release the record exposed by
        the last :meth:`peek` (advances the tail; the peeked view is dead)."""
        _lib().shmring_consume(self._h)
        self.consumes += 1

    def put(self, obj, timeout_secs=600):
        """Pickle + write; returns False when the object can never fit."""
        return self.put_bytes(
            pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), timeout_secs)

    def get(self, timeout_secs=600):
        return pickle.loads(self.get_bytes(timeout_secs))

    def fill(self):
        return _lib().shmring_fill(self._h)

    def close_writes(self):
        _lib().shmring_close(self._h)

    def reopen(self):
        _lib().shmring_reopen(self._h)

    def detach(self, unlink=False):
        """Release the mapping; ``unlink=True`` also removes the shm object
        (call once, at cluster shutdown)."""
        if self._h:
            if unlink:
                _lib().shmring_unlink(self.name.encode())
            _lib().shmring_free(self._h)
            self._h = None


def unlink(name):
    """Remove the shm object (idempotent; live mappings stay valid)."""
    lib = _lib()
    if lib is not None:
        lib.shmring_unlink(name.encode())
    _rings.pop(name, None)


_rings = {}    # per-process handle cache: rings live for the process lifetime
_created = set()  # names this process created: unlinked at exit as a safety
                  # net for runs that die before the shutdown job unlinks.
                  # Only the long-lived node process creates rings
                  # (node.run pre-creates; feed tasks attach), so this
                  # atexit can never unlink under a consumer that outlives
                  # the creator.


def _atexit_unlink():
    for name in list(_created):
        unlink(name)


def counters_snapshot():
    """Flat telemetry counters over every ring this process has touched.

    Heartbeat-payload schema (sums across rings; ``_hwm`` merges by max
    downstream — see :func:`telemetry.merge_counters`):
    ``ring_writes/ring_writevs/ring_reads/ring_peeks/ring_consumes/
    ring_occupancy_hwm``.
    """
    snap = {"ring_writes": 0, "ring_writevs": 0, "ring_reads": 0,
            "ring_peeks": 0, "ring_consumes": 0, "ring_occupancy_hwm": 0}
    for ring in list(_rings.values()):
        snap["ring_writes"] += ring.writes
        snap["ring_writevs"] += ring.writevs
        snap["ring_reads"] += ring.reads
        snap["ring_peeks"] += ring.peeks
        snap["ring_consumes"] += ring.consumes
        if ring.occupancy_hwm > snap["ring_occupancy_hwm"]:
            snap["ring_occupancy_hwm"] = int(ring.occupancy_hwm)
    return snap


def get_ring(name, create=False):
    """Process-cached create-or-attach (handles must not churn per task —
    see shmring_free's contract in native/shmring.cc)."""
    ring = _rings.get(name)
    if ring is None:
        ring = (Ring.create_or_attach(name) if create else Ring.attach(name))
        if ring is not None:
            _rings[name] = ring
            if create:
                if not _created:
                    import atexit

                    atexit.register(_atexit_unlink)
                _created.add(name)
    return ring
