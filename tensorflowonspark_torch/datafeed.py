"""User-side data feed helpers, used inside ``main_fun`` (reference ``TFNode.py``).

:class:`DataFeed` consumes the per-executor input queue as batches and pushes
inference results back — same queue semantics as the reference (end-of-feed
``None``, :class:`~tensorflowonspark_torch.marker.EndPartition` alignment, the
1:1 inference contract) — but adds columnar batch assembly: instead of the
reference's element-at-a-time generator hops into ``tf.data.from_generator``
(the known InputMode.SPARK bottleneck, SURVEY §3.2), :meth:`next_batch` can
return columnar numpy arrays ready for one host->device copy per batch (see
:mod:`tensorflowonspark_torch.parallel.infeed`).  The port's copy of the JAX
package's ``datafeed`` module.
"""

import logging
import queue as _queue
import threading
import time

import numpy as np

from tensorflowonspark_torch import fault, marker

logger = logging.getLogger(__name__)

_INTERRUPTED = object()  # internal next_batch abort marker (see interrupt())


def _rows_to_fields(rows):
    """Convert a list of rows into per-field arrays: ``(fields, tuple_rows)``
    (the degraded path for object chunks; columnar chunks skip this).
    Row semantics live in :mod:`~tensorflowonspark_torch.columnar`; this is
    the strict caller — inconsistent arity raises (truncating would
    silently drop fields — wrong training data) where the feeder-side
    packer soft-falls-back."""
    from tensorflowonspark_torch import columnar

    return columnar.rows_to_fields(rows, strict=True)


def assemble_columns(parts, tuple_rows, dtypes, input_tensors=None):
    """Concatenate per-part field slices into final per-field arrays and
    shape the result per the input_mapping contract (shared by
    :class:`DataFeed` and the data-service
    :class:`~tensorflowonspark_torch.dataservice.ServiceFeed`).

    ``parts`` is a list of per-field tuples of array slices; the result is a
    per-tensor dict when ``input_tensors`` is given, a tuple of field arrays
    for tuple rows, else a single array."""
    if not parts:
        if input_tensors is None:
            return np.empty((0,))
        return {t: np.empty((0,)) for t in input_tensors}
    arity = len(parts[0])

    def col(f, dtype):
        arrs = [p[f] for p in parts]
        out = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
        return out if dtype is None else np.asarray(out, dtype=dtype)

    if input_tensors is not None:
        if arity != len(input_tensors):
            raise ValueError(
                "input_mapping names {} tensors but feed rows have {} "
                "fields".format(len(input_tensors), arity))
        return {
            t: col(f, None if dtypes is None else dtypes.get(t))
            for f, t in enumerate(input_tensors)
        }
    if tuple_rows:
        return tuple(
            col(f, None if dtypes is None else dtypes[f])
            for f in range(arity))
    return col(0, dtypes)


def absolute_path(ctx, path):
    """Convert a user path to an absolute path on shared storage.

    Reference ``TFNode.py:23-58`` (``hdfs_path``); scheme list extended with
    the TPU-era object stores (``gs://``, ``s3://``).

    Rules:
    - recognized scheme prefixes pass through unchanged;
    - absolute paths pass through (prefixed with ``file://`` when default_fs
      is local);
    - relative paths resolve against the default filesystem, or against the
      executor's working dir when default_fs is ``file://`` (reference
      behavior for Spark Standalone).
    """
    schemes = ("file://", "hdfs://", "viewfs://", "gs://", "s3://", "s3a://")
    if path.startswith(schemes):
        return path
    default_fs = getattr(ctx, "default_fs", None) or "file://"
    if path.startswith("/"):
        return path if not default_fs.startswith("file://") else "file://" + path
    if default_fs.startswith("file://"):
        working_dir = getattr(ctx, "working_dir", None) or "."
        return "file://{}/{}".format(working_dir, path)
    if default_fs.startswith("hdfs://") or default_fs.startswith("viewfs://"):
        # hdfs relative paths resolve to the user's home dir (reference
        # TFNode.py:52-53).
        import getpass

        return "{}/user/{}/{}".format(default_fs.rstrip("/"), getpass.getuser(), path)
    return "{}/{}".format(default_fs.rstrip("/"), path)


def strip_scheme(path):
    """Drop a ``file://``/``file:`` prefix for direct POSIX access (shared
    canonical helper — keeps this and the checkpoint/data paths agreeing
    on what counts as a local path)."""
    from tensorflowonspark_torch import fsio

    return fsio.strip_file_scheme(path)


class DataFeed(object):
    """Queue consumer for InputMode.SPARK nodes (reference ``TFNode.py:86-194``).

    Args:
      mgr: this node's connected manager (from ``ctx.mgr``).
      train_mode: True for training (no result queue), False for inference.
      qname_in / qname_out: queue names.
      input_mapping: optional ``{column_name: tensor_name}`` dict; when given,
        :meth:`next_batch` returns a dict of per-tensor columns, keyed by
        tensor name, with columns ordered by sorted column name — the same
        contract the pipeline API uses to line up DataFrame columns
        (reference ``TFNode.py:96-103``, ``pipeline.py:428-429``).
    """

    def __init__(self, mgr, train_mode=True, qname_in="input",
                 qname_out="output", input_mapping=None):
        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.done_feeding = False
        self.input_tensors = (
            [tensor for _, tensor in sorted(input_mapping.items())]
            if input_mapping is not None else None
        )
        # Unpacked-but-unconsumed rows from the last chunk (feeders send
        # chunks to amortize the per-element IPC hop; see marker.Chunk /
        # marker.ColChunk).  ``_buffer`` is either a list of items or a
        # ColChunk (columnar rows); ``_buffer_idx`` indexes rows in both.
        # The chunk's task_done is DEFERRED until its last item is handed
        # out (_chunk_q holds the pending ack): a consumer crashing
        # mid-chunk must leave the queue un-joined so the feeder's
        # error-poll fires, matching the reference's per-item fail-fast
        # semantics (reference TFSparkNode.py:407-418).
        self._buffer = []
        self._buffer_idx = 0
        self._chunk_q = None
        # Transport observability: {format: chunks seen} — wire.WIRE_COLV1
        # for zero-copy framed ring records, wire.WIRE_PICKLE for pickled
        # ring records, "queue" for in-queue chunks.  The bench feedplane
        # leg publishes this so a throughput number always names the wire
        # format that produced it.
        self.wire_formats = {}
        # More always-on feed-plane tallies (plain numbers; snapshotted into
        # heartbeat payloads by the node runtime — see counters_snapshot):
        # total rows handed to the trainer, and cumulative seconds spent
        # blocked on an empty input queue (the consumer-starved signal that
        # tells an input-bound job from a compute-bound one).
        self.items_consumed = 0
        self.stall_secs = 0.0
        # Set by interrupt(): unblocks a next_batch blocked on the queue so
        # another thread can take over queue consumption (the queue/ring is
        # single-consumer; see ShardedFeed.terminate).
        self._interrupt = threading.Event()
        # Queue-poll cadence of the interruptible blocking get; a live knob
        # (``feed_poll_secs``) because it trades idle-CPU wakeups against
        # interrupt latency and the right value depends on measured load.
        self._poll_secs = 0.5
        # Chaos hook: consumption-side fault injection ("node dies / fails
        # after N items") — a null object unless TFOS_FAULT_SPEC targets
        # this process (see tensorflowonspark_torch.fault).
        self._fault = fault.from_env()

    def apply_knob(self, name, value):
        """Live-knob hook — the duck-typed protocol every registered feed
        source shares (see ``node.apply_knobs`` and docs/AUTOPILOT.md):
        claim a ``{knob: value}`` push by returning True, return False for
        names that belong to other planes.  The queue-backed DataFeed owns
        just ``feed_poll_secs``; richer feeds (ShardedFeed, ServiceFeed)
        claim the autopilot's performance knobs."""
        if name == "feed_poll_secs":
            self._poll_secs = min(max(float(value), 0.05), 5.0)
            return True
        return False

    def next_batch(self, batch_size):
        """Get up to ``batch_size`` items from the input queue.

        Blocks until data is available.  Returns fewer than ``batch_size``
        items at end-of-feed (``None`` sentinel) or at a partition boundary
        during inference (``EndPartition``) — reference ``TFNode.py:105-151``.

        Returns a list of items, or a dict of per-tensor lists when
        ``input_mapping`` was provided.
        """
        logger.debug("requesting batch of %d items", batch_size)
        queue = self.mgr.get_queue(self.qname_in)
        tensors = ([] if self.input_tensors is None
                   else {tensor: [] for tensor in self.input_tensors})
        count = 0
        while count < batch_size:
            if self._buffer_idx < self._buflen():
                item = self._bufrow(self._buffer_idx)
                self._buffer_idx += 1
                from_queue = False
            else:
                item = self._get_interruptible(queue)
                if item is _INTERRUPTED:
                    logger.info("next_batch: interrupted with %d items", count)
                    break
                from_queue = True
                if isinstance(item, marker.ShmChunk):
                    # Payload took the native shm-ring fast path; the token
                    # preserves ordering/join semantics (see marker.ShmChunk).
                    item = self._ring_read(item)
                elif isinstance(item, (marker.Chunk, marker.ColChunk)):
                    self._note_transport("queue")
                if isinstance(item, (marker.Chunk, marker.ColChunk)):
                    # Buffer the chunk (item list or columnar); ack deferred
                    # (see ctor).
                    self._buffer = (item.items if isinstance(item, marker.Chunk)
                                    else item)
                    self._buffer_idx = 0
                    self._chunk_q = queue
                    if not self._buflen():
                        self._ack_chunk()
                    continue
            if item is None:
                # End-of-feed: producers are done for good (reference 129-134).
                logger.info("next_batch: end of feed")
                self.done_feeding = True
                if from_queue:
                    queue.task_done()
                break
            elif isinstance(item, marker.EndPartition):
                # Partition boundary: stop here if we already have items so
                # result batches align with partitions (reference 135-140).
                logger.debug("next_batch: end of partition")
                if from_queue:
                    queue.task_done()
                if count > 0:
                    break
            else:
                if self.input_tensors is None:
                    tensors.append(item)
                else:
                    for i, tensor in enumerate(self.input_tensors):
                        tensors[tensor].append(item[i])
                count += 1
                if from_queue:
                    queue.task_done()
                elif self._buffer_idx >= self._buflen():
                    # Ack only after the chunk's last item is safely batched:
                    # a crash on a malformed item above must leave the queue
                    # un-joined so the feeder's error-poll fires (see ctor).
                    self._ack_chunk()
        self.items_consumed += count
        self._fault.on_items(count)
        logger.debug("next_batch: returning %d items", count)
        return tensors

    def _buflen(self):
        """Row count of the pending chunk buffer (item list or columnar)."""
        buf = self._buffer
        return buf.count if isinstance(buf, marker.ColChunk) else len(buf)

    def _bufrow(self, i):
        """Row ``i`` of the pending chunk buffer."""
        buf = self._buffer
        return buf.row(i) if isinstance(buf, marker.ColChunk) else buf[i]

    def _get_interruptible(self, queue):
        """Blocking get that aborts (returning ``_INTERRUPTED``) once
        :meth:`interrupt` fires.  Short-timeout polling, not ``block=True``:
        the proxy's blocking get cannot be cancelled from another thread."""
        t0 = time.monotonic()
        try:
            while not self._interrupt.is_set():
                try:
                    return queue.get(block=True, timeout=self._poll_secs)
                except _queue.Empty:
                    continue
            return _INTERRUPTED
        finally:
            self.stall_secs += time.monotonic() - t0

    def interrupt(self):
        """Unblock a concurrent :meth:`next_batch` and make subsequent calls
        return immediately.  Used to hand queue ownership from a consumer
        thread to :meth:`terminate`'s drain — the queue and shm ring are
        strictly single-consumer, so the old consumer must be out before the
        drain starts."""
        self._interrupt.set()

    def _ack_chunk(self):
        if self._chunk_q is not None:
            self._chunk_q.task_done()
            self._chunk_q = None

    def _note_transport(self, fmt):
        self.wire_formats[fmt] = self.wire_formats.get(fmt, 0) + 1

    def _ring_read(self, token, timeout_secs=600):
        """Pop one chunk payload from the shm ring named by the token;
        returns the chunk object (:class:`~tensorflowonspark_torch.marker.Chunk`
        or :class:`~tensorflowonspark_torch.marker.ColChunk`; legacy payloads
        may be bare item lists, returned wrapped in a Chunk).

        ``fmt`` on the token picks the record decoding: framed columnar
        records (:data:`~tensorflowonspark_torch.wire.WIRE_COLV1`) take the
        two-phase peek/consume path — the in-ring bytes are wrapped with
        ``np.frombuffer`` views and each column is copied exactly once into
        the chunk, with no intermediate record buffer and no unpickle."""
        import pickle

        from tensorflowonspark_torch import shmring, wire

        ring = shmring.get_ring(token.ring_name)
        if ring is None:
            raise RuntimeError(
                "feeder sent a shm-ring chunk but ring {} cannot be attached "
                "in the consumer process".format(token.ring_name))
        fmt = getattr(token, "fmt", wire.WIRE_PICKLE)
        if fmt == wire.WIRE_COLV1:
            view = ring.peek(timeout_secs)
            try:
                obj = wire.decode_chunk(view, copy=True)
            finally:
                # Consume even when decode raises: tokens and records must
                # stay 1:1 or every later chunk on this ring desyncs.
                ring.consume()
        else:
            obj = pickle.loads(ring.get_bytes(timeout_secs))
        self._note_transport(fmt)
        if isinstance(obj, list):
            obj = marker.Chunk(obj)
        n = obj.count if isinstance(obj, marker.ColChunk) else len(obj.items)
        if n != token.count:
            # Token/record desync would silently deliver wrong training data;
            # must survive python -O, so not an assert.
            raise RuntimeError(
                "shm ring {} desync: token promised {} items, record has "
                "{}".format(token.ring_name, token.count, n))
        return obj

    def next_batch_arrays(self, batch_size, dtypes=None):
        """TPU-first variant: assemble the batch directly into numpy arrays.

        Columnar end to end: feeders ship
        :class:`~tensorflowonspark_torch.marker.ColChunk` blocks (a few
        contiguous ndarrays), and this method concatenates column *slices* —
        no per-row Python objects ever exist on this path.  Object chunks /
        loose items degrade gracefully to per-row ``np.asarray``.  Pairs with
        ``parallel.infeed.ShardedFeed`` for a single per-host device transfer.

        Returns ``(arrays, count)`` where ``count`` is the number of real
        rows (may be < batch_size at end of feed) and ``arrays`` is:

        - a dict ``{tensor_name: ndarray}`` when ``input_mapping`` was given
          (row fields map positionally to the sorted column order, exactly
          like :meth:`next_batch`);
        - a tuple of per-field ndarrays when rows are tuples;
        - a single ndarray when rows are single values.

        ``dtypes``: optional cast — a dict keyed by tensor name (with
        input_mapping), a sequence matching the field count (tuple rows), or
        a single dtype (single-value rows).
        """
        queue = self.mgr.get_queue(self.qname_in)
        parts = []       # per-part tuple of per-field array slices
        tuple_rows = None
        count = 0
        while count < batch_size:
            buflen = self._buflen()
            if self._buffer_idx < buflen:
                take = min(batch_size - count, buflen - self._buffer_idx)
                i0 = self._buffer_idx
                buf = self._buffer
                if isinstance(buf, marker.ColChunk):
                    fields = tuple(c[i0:i0 + take] for c in buf.columns)
                    tr = buf.tuple_rows
                else:
                    fields, tr = _rows_to_fields(buf[i0:i0 + take])
                if tuple_rows is None:
                    tuple_rows = tr
                elif tuple_rows != tr or (parts and len(parts[-1]) != len(fields)):
                    raise ValueError(
                        "inconsistent row structure across feed chunks "
                        "(tuple_rows {} vs {})".format(tuple_rows, tr))
                parts.append(fields)
                count += take
                self._buffer_idx += take
                if self._buffer_idx >= buflen:
                    self._ack_chunk()
                continue
            item = self._get_interruptible(queue)
            if item is _INTERRUPTED:
                logger.info("next_batch_arrays: interrupted at %d rows", count)
                break
            if isinstance(item, marker.ShmChunk):
                item = self._ring_read(item)
            elif isinstance(item, (marker.Chunk, marker.ColChunk)):
                self._note_transport("queue")
            if isinstance(item, (marker.Chunk, marker.ColChunk)):
                self._buffer = (item.items if isinstance(item, marker.Chunk)
                                else item)
                self._buffer_idx = 0
                self._chunk_q = queue
                if not self._buflen():
                    self._ack_chunk()
                continue
            if item is None:
                logger.info("next_batch_arrays: end of feed")
                self.done_feeding = True
                queue.task_done()
                break
            if isinstance(item, marker.EndPartition):
                queue.task_done()
                if count > 0:
                    break
                continue
            # A loose (unchunked) item: treat as a one-row part, under the
            # same structure-consistency contract as the chunk path.
            fields, tr = _rows_to_fields([item])
            if tuple_rows is None:
                tuple_rows = tr
            elif tuple_rows != tr or (parts and len(parts[-1]) != len(fields)):
                raise ValueError(
                    "inconsistent row structure across feed items "
                    "(tuple_rows {} vs {})".format(tuple_rows, tr))
            parts.append(fields)
            count += 1
            queue.task_done()
        self.items_consumed += count
        self._fault.on_items(count)
        return self._assemble_columns(parts, tuple_rows, dtypes), count

    def _assemble_columns(self, parts, tuple_rows, dtypes):
        return assemble_columns(parts, tuple_rows, dtypes,
                                self.input_tensors)

    def counters_snapshot(self):
        """Flat telemetry counters for heartbeat payloads.

        Schema: ``feed_items`` (rows delivered), ``feed_stall_secs`` (time
        blocked on an empty queue), ``wire_<fmt>`` (chunks per transport —
        ``wire_colv1``/``wire_pickle``/``wire_queue``; data-service feeds
        additionally mint ``wire_colv1+<codec>`` keys for compressed
        streams plus the ``dataservice_cache_*`` / ``wire_compress_*``
        vocabulary, see ``ServiceFeed.counters_snapshot``).
        """
        snap = {"feed_items": self.items_consumed,
                "feed_stall_secs": round(self.stall_secs, 6)}
        for fmt, n in list(self.wire_formats.items()):
            snap["wire_{}".format(fmt)] = n
        return snap

    def should_stop(self):
        """True once end-of-feed was observed (reference ``TFNode.py:153-155``)."""
        return self.done_feeding

    def batch_results(self, results):
        """Push a batch of inference results to the output queue
        (reference ``TFNode.py:157-170``); the whole batch travels as one
        chunk (see :class:`~tensorflowonspark_torch.marker.Chunk`)."""
        results = list(results)
        if results:
            queue = self.mgr.get_queue(self.qname_out)
            queue.put(marker.Chunk(results), block=True)

    def terminate(self):
        """Terminate data feeding early (e.g. training reached max steps with
        epochs of data left).  Sets the node state to ``'terminating'`` so
        upcoming feed partitions are skipped, then drains the input queue
        (reference ``TFNode.py:172-194``)."""
        logger.info("terminate() invoked: draining remaining input")
        try:
            self.mgr.set("state", "terminating")
            self._ack_chunk()  # release a partially-consumed chunk's join hold
            self._buffer, self._buffer_idx = [], 0
            queue = self.mgr.get_queue(self.qname_in)
        except (EOFError, BrokenPipeError, ConnectionError, OSError):
            # the manager died before the drain even started (driver-side
            # shutdown won the race) — nothing left to mark or drain
            logger.info("manager gone at terminate(); assuming shutdown")
            self._buffer, self._buffer_idx = [], 0
            return
        count = 0
        done = False
        while not done:
            try:
                item = queue.get(block=True, timeout=5)
                queue.task_done()
                if item is None:
                    done = True
                else:
                    if isinstance(item, marker.ShmChunk):
                        # Pop the ring record too, so a producer blocked on a
                        # full ring unblocks (tokens and records stay 1:1).
                        try:
                            self._ring_read(item, timeout_secs=5)
                        except Exception:
                            pass
                    count += 1
            except _queue.Empty:
                logger.info("dropped %d items after terminate", count)
                done = True
            except (EOFError, BrokenPipeError, ConnectionError, OSError):
                # The manager died under the drain — the driver shut the
                # cluster down while we were still discarding leftover
                # input.  A dead manager means there is nothing left to
                # drain (or ack to); finishing quietly is the correct
                # outcome, not an error in the user's fn.
                logger.info("manager gone during terminate drain "
                            "(%d items dropped); assuming shutdown", count)
                done = True
