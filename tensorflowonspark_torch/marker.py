"""Queue sentinel markers (reference ``marker.py:11-18``).

Items placed in the per-executor data queues alongside real records:

- ``None``            — end-of-feed: no more data will ever arrive (reference
                        convention, ``TFNode.py:129-134``).
- ``EndPartition``    — end of one input partition; used by inference feeding so
                        result batches align with partition boundaries
                        (reference ``TFSparkNode.py:469``, ``TFNode.py:135-140``).
"""


class Marker(object):
    """Base class for out-of-band markers placed in data queues."""


class EndPartition(Marker):
    """Marks the end of one input partition within the feed queue."""


class Chunk(Marker):
    """A block of consecutive items travelling as ONE queue element.

    TPU-first addition: the reference paid one manager-proxy round trip per
    example (the InputMode.SPARK throughput ceiling, SURVEY §3.2); feeders
    here put :class:`Chunk` blocks so the per-element IPC cost amortizes over
    ``len(items)``.  :class:`~tensorflowonspark_torch.datafeed.DataFeed`
    unpacks chunks transparently — consumers still see items.
    """

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = items


class ShmChunk(Marker):
    """Ordering token for a chunk whose payload travels through the native
    shared-memory ring (:mod:`~tensorflowonspark_torch.shmring`) instead of
    the manager socket.  The token keeps the JoinableQueue semantics
    (ordering, backpressure, join/fail-fast) while the bytes take the fast
    path; ``count`` is the number of items in the ring record and ``fmt``
    names the in-ring record encoding so the consumer knows how to read it:
    :data:`~tensorflowonspark_torch.wire.WIRE_PICKLE` (pickled chunk object)
    or :data:`~tensorflowonspark_torch.wire.WIRE_COLV1` (self-describing
    zero-copy columnar frame, read via the two-phase peek/consume path).
    """

    __slots__ = ("ring_name", "count", "fmt")

    def __init__(self, ring_name, count, fmt="pickle"):
        self.ring_name = ring_name
        self.count = count
        self.fmt = fmt


class ColChunk(Marker):
    """A block of rows stored **columnar**: one contiguous ndarray per field.

    TPU-first: a block of N ``(ndarray, scalar, ...)`` rows pickles as N
    small objects with per-object overhead and unpickles back into N objects
    the consumer must re-stack; the same block as a few contiguous ndarrays
    pickles/unpickles as a handful of memcpys and feeds straight into
    columnar batch assembly (``DataFeed.next_batch_arrays`` concatenates
    column slices — no per-row Python objects anywhere on the hot path).

    ``columns``: tuple of ndarrays, all sharing leading dim ``count``.
    ``tuple_rows``: True when the original rows were tuples/lists of fields
    (``row(i) == tuple(col[i] for col in columns)``); False when rows were
    single values (``row(i) == columns[0][i]``).
    """

    __slots__ = ("columns", "count", "tuple_rows")

    def __init__(self, columns, count, tuple_rows):
        self.columns = columns
        self.count = count
        self.tuple_rows = tuple_rows

    def row(self, i):
        """Materialize row ``i`` (compat path for the item-list API)."""
        if self.tuple_rows:
            return tuple(col[i] for col in self.columns)
        return self.columns[0][i]


def pack_columnar(block):
    """Pack a list of rows into a :class:`ColChunk`, or return ``None`` when
    the rows aren't uniformly shaped numeric fields (caller falls back to a
    plain object :class:`Chunk`).

    Row semantics live in :mod:`~tensorflowonspark_torch.columnar` (the one
    shared contract for this packer, the DataFeed degraded path, and
    FileFeed); this is the soft (``strict=False``) caller.
    """
    from tensorflowonspark_torch import columnar

    if not block:
        return None
    res = columnar.rows_to_fields(block, strict=False)
    if res is None:
        return None
    fields, tuple_rows = res
    return ColChunk(fields, len(block), tuple_rows)
