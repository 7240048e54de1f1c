"""FILES-mode input pipeline: the tf.data equivalent for this framework (the
port's copy of :mod:`tensorflowonspark_tpu.data`; the copy is the port's
own, and its one reach into jax, :func:`shard_for_process`'s process index,
reads ``torch.distributed`` instead).

The reference's ``InputMode.TENSORFLOW`` workers read their own data with
``tf.data`` (``ds.shard(num_workers, worker_num)``, shuffle, batch, prefetch
— reference ``examples/mnist/keras/mnist_tf.py:23-27``,
``examples/resnet/imagenet_preprocessing.py``).  This module provides that
role with no TensorFlow:

:class:`FileFeed` streams TFRecord shards through background reader threads
into columnar numpy batches, with file-level process sharding, a shuffle
buffer, and executor-side epochs.  It duck-types the
:class:`~tensorflowonspark_torch.datafeed.DataFeed` consumer interface
(``next_batch_arrays`` / ``should_stop`` / ``interrupt`` / ``terminate``),
so :class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed` composes
unchanged on top: device transfer, prefetch double-buffering, cross-host
end-of-data consensus, and K-step ``grouped_batches`` all work identically
for SPARK-pushed and file-read data.

Typical use inside ``main_fun``::

    feed = data.FileFeed(data.list_shards(args.data_dir),
                         shuffle_buffer=10000, num_epochs=args.epochs,
                         seed=ctx.process_id or 0)
    sharded = infeed.ShardedFeed(feed, args.batch_size,
                                 transform=to_model_batch, device=device)
    trainer.fit_feed(sharded, steps_per_call=8)
"""

import logging
import queue as _queue
import threading

import numpy as np

from tensorflowonspark_torch import fsio

logger = logging.getLogger(__name__)

_END = object()          # reader-side end-of-stream marker
_INTERRUPTED = object()


def list_shards(path, pattern="part-*"):
    """Sorted shard files under ``path`` (a dir, a glob, or a single file;
    local or remote — ``gs://bucket/train`` works the same as a local dir,
    see :mod:`~tensorflowonspark_torch.fsio`).

    Directory case falls back from ``pattern`` to ``*.tfrecord*`` — the
    same lookup ``dfutil.load_tfrecords`` uses, so dirs with either naming
    convention work."""
    if fsio.isdir(path):
        files = (fsio.glob(fsio.join(path, pattern))
                 or fsio.glob(fsio.join(path, "*.tfrecord*")))
    else:
        files = fsio.glob(path) or [path]
    if not files:
        raise FileNotFoundError("no shard files at {!r}".format(path))
    return files


def shard_for_process(files, process_index=None, process_count=None):
    """File-level sharding (the reference's ``ds.shard``): every process
    reads ``files[process_index::process_count]``.  The index and count
    come from the caller, else from the ``torch.distributed`` world (one
    process when none is up).  With fewer files than processes, falls back
    to giving every process the full list with a warning (record-level
    sharding would be needed for true disjointness)."""
    if process_index is None or process_count is None:
        # the JAX package reads jax.process_index() / process_count()
        import torch.distributed as dist

        up = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if up else 0
        if process_count is None:
            process_count = dist.get_world_size() if up else 1
    if len(files) < process_count:
        logger.warning(
            "%d shard files < %d processes: every process reads all files "
            "(write more shards for disjoint reads)", len(files),
            process_count)
        return list(files)
    return list(files)[process_index::process_count]


def tfrecord_rows(path, binary_features=(), schema=None):
    """Generator of parsed row dicts from one TFRecord file (native codec
    with pure-python fallback; schema inference as in dfutil)."""
    from tensorflowonspark_torch import dfutil, tfrecord

    inferred = schema
    for rec in tfrecord.tfrecord_iterator(path):
        if inferred is None:
            inferred = dfutil.infer_schema(rec, binary_features)
        # as_numpy: float columns stay vectorized ndarrays end to end
        yield dfutil.from_example(rec, inferred, as_numpy=True)


def jsonl_rows(path):
    """Generator of rows from a JSON-lines file (one JSON value per line).

    Objects become dict rows (columnar by key), top-level arrays become
    TUPLE rows (a ``[x, y]`` line is a 2-field row — the row shape the
    columnar contract treats as fields; a list row would be a single vector
    value instead, see :mod:`~tensorflowonspark_torch.columnar`), and scalars
    become single-value rows.  The zero-dependency reader for data-service
    workers and tests."""
    import json

    with fsio.open_file(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            yield tuple(row) if isinstance(row, list) else row


def packed_lm_reader(seq_len, tokens_key="tokens", eos_id=None):
    """FileFeed row reader factory for LM training from TFRecord shards:
    concatenates each record's int64 ``tokens_key`` feature (appending
    ``eos_id`` between documents when given) and packs the stream into
    fixed ``seq_len`` rows — ``{"tokens": int32 (seq_len,)}``.  The tail
    that can't fill a row is dropped (standard packing)."""
    def reader(path):
        from tensorflowonspark_torch import example_proto, tfrecord

        buf = []
        for rec in tfrecord.tfrecord_iterator(path):
            _, toks = example_proto.decode_example(rec)[tokens_key]
            buf.extend(int(t) for t in toks)
            if eos_id is not None:
                buf.append(eos_id)
            while len(buf) >= seq_len:
                yield {"tokens": np.asarray(buf[:seq_len], np.int32)}
                del buf[:seq_len]

    return reader


def byte_lm_reader(seq_len, chunk_bytes=1 << 16):
    """FileFeed row reader factory for byte-level LM training straight from
    raw text/binary files (vocab 256, zero tokenizer dependencies): the
    file's byte stream packs into fixed ``seq_len`` rows."""
    def reader(path):
        buf = bytearray()
        with fsio.open_file(path, "rb") as f:
            while True:
                chunk = f.read(chunk_bytes)
                if not chunk:
                    break
                buf.extend(chunk)
                while len(buf) >= seq_len:
                    yield {"tokens": np.frombuffer(
                        bytes(buf[:seq_len]), np.uint8).astype(np.int32)}
                    del buf[:seq_len]

    return reader


class FileFeed(object):
    """Streaming columnar batches from record files (FILES mode).

    Args:
      files: shard file list (see :func:`list_shards`); pass the FULL list —
        process sharding is applied here (``shard=False`` to disable).
      row_reader: ``fn(path) -> iterator of rows`` (defaults to
        :func:`tfrecord_rows`).  Rows may be dicts (columnar by key),
        tuples, or single values — the same row shapes DataFeed handles.
      shuffle_buffer: >0 enables a uniform reservoir shuffle of that size.
      num_epochs: passes over the files (readers re-open per epoch);
        epoch boundaries are invisible to the consumer (like executor-side
        epoch replay in SPARK mode).
      reader_threads: concurrent shard readers (each owns whole files).
      seed: shuffle seed (vary per process for decorrelated shards).
      shard: apply :func:`shard_for_process` to the file list.
      queue_size: reader->consumer row-block queue depth (backpressure).
    """

    BLOCK = 256  # rows per reader->consumer handoff (amortizes queue ops)

    def __init__(self, files, row_reader=None, shuffle_buffer=0,
                 num_epochs=1, reader_threads=2, seed=0, shard=True,
                 queue_size=64):
        self.files = (shard_for_process(files) if shard else list(files))
        self.row_reader = row_reader or tfrecord_rows
        self.shuffle_buffer = shuffle_buffer
        self.num_epochs = num_epochs
        self.reader_threads = max(1, min(reader_threads, len(self.files)))
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._queue = _queue.Queue(maxsize=queue_size)
        self._interrupt = threading.Event()
        self._done = False        # consumer-side end-of-stream latch
        self._reservoir = []
        self._pending = []       # rows spilled past the last batch boundary
        self._ends = 0           # end-markers consumed (persists across calls)
        self._started = False
        self._threads = []
        self._errors = _queue.Queue()

    # -- reader side -------------------------------------------------------

    def _reader(self, worker_idx):
        try:
            block = []
            my_files = list(self.files[worker_idx::self.reader_threads])
            rng = (np.random.default_rng((self._seed, worker_idx))
                   if self.shuffle_buffer else None)
            for epoch in range(self.num_epochs):
                if rng is not None:
                    # file-order reshuffle each epoch (tf.data's
                    # reshuffle_each_iteration at file granularity; row-level
                    # mixing is the consumer-side reservoir's job)
                    rng.shuffle(my_files)
                for path in my_files:
                    for row in self.row_reader(path):
                        block.append(row)
                        if len(block) >= self.BLOCK:
                            if not self._put(block):
                                return
                            block = []
            if block:
                self._put(block)
        except BaseException as exc:  # noqa: B036 — relayed to the consumer
            self._errors.put(exc)
        finally:
            self._put(_END, force=True)

    def _put(self, item, force=False):
        while not self._interrupt.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        if force:
            # unblock the consumer's end-of-stream accounting even when
            # interrupted: drop queued data, push the marker best-effort
            try:
                self._queue.put_nowait(item)
            except _queue.Full:
                pass
        return False

    def _ensure_started(self):
        if self._started:
            return
        self._started = True
        for i in range(self.reader_threads):
            t = threading.Thread(target=self._reader, args=(i,),
                                 name="filefeed-reader-%d" % i, daemon=True)
            self._threads.append(t)
            t.start()

    # -- consumer side (DataFeed duck type) --------------------------------

    def _next_rows(self):
        """One reader block through the shuffle reservoir; None at end."""
        while True:
            if not self._errors.empty():
                raise self._errors.get()
            if self._interrupt.is_set():
                return None
            if self._ends >= len(self._threads):
                break  # every reader already finished (latched)
            try:
                item = self._queue.get(timeout=0.5)
            except _queue.Empty:
                continue
            if item is _END:
                self._ends += 1
                if self._ends >= len(self._threads):
                    break
                continue
            if not self.shuffle_buffer:
                return item
            # reservoir: absorb the block, emit uniformly-sampled rows once
            # the buffer is warm
            self._reservoir.extend(item)
            if len(self._reservoir) >= self.shuffle_buffer + self.BLOCK:
                idx = self._rng.choice(len(self._reservoir), self.BLOCK,
                                       replace=False)
                out = [self._reservoir[i] for i in idx]
                for i in sorted(idx, reverse=True):
                    self._reservoir[i] = self._reservoir[-1]
                    self._reservoir.pop()
                return out
        # end-of-stream: a reader that errored right before its end marker
        # must still surface (the _END branch breaks without a check)
        if not self._errors.empty():
            raise self._errors.get()
        # drain the reservoir at end-of-stream
        if self._reservoir:
            out = self._reservoir
            self._reservoir = []
            self._rng.shuffle(out)
            return out
        return None

    def next_batch_arrays(self, batch_size, dtypes=None):
        """Columnar ``(arrays, count)`` — same contract as
        ``DataFeed.next_batch_arrays`` (dict of columns for dict rows,
        tuple of columns for tuple rows, single array otherwise)."""
        self._ensure_started()
        rows = self._pending
        self._pending = []
        while len(rows) < batch_size:
            block = self._next_rows()
            if block is None:
                self._done = True
                break
            rows.extend(block)
        if len(rows) > batch_size:
            self._pending = rows[batch_size:]
            rows = rows[:batch_size]
        if not rows:
            return np.empty((0,)), 0
        return self._columnar(rows, dtypes), len(rows)

    @staticmethod
    def _columnar(rows, dtypes):
        # Dict rows (FILES-specific surface: TFRecord features by name)
        # assemble here; tuple/single rows delegate to the shared contract
        # (tensorflowonspark_torch.columnar), strict like the consumer side.
        from tensorflowonspark_torch import columnar

        first = rows[0]
        if isinstance(first, dict):
            return {
                k: np.asarray([r[k] for r in rows],
                              dtype=None if not dtypes else dtypes.get(k))
                for k in first
            }
        fields, tuple_rows = columnar.rows_to_fields(
            rows, strict=True, dtypes=dtypes if dtypes else None)
        return fields if tuple_rows else fields[0]

    def should_stop(self):
        return self._done and not self._pending

    def interrupt(self):
        self._interrupt.set()

    def terminate(self):
        """Stop readers and drop buffered data (early stop)."""
        self._interrupt.set()
        for t in self._threads:
            t.join(timeout=5)
        self._reservoir = []
        self._pending = []
        self._done = True


# ---------------------------------------------------------------------------
# Multiprocess decode pool
# ---------------------------------------------------------------------------

def _pool_worker(reader_bytes, files, num_epochs, seed, worker_idx,
                 block_rows, outq, stop_ev):
    """Worker-process body: run the row reader over this worker's file
    subset (via a private single-thread FileFeed, which supplies the
    per-epoch file reshuffle and error relay) and stream row blocks back.

    Protocol on ``outq``: ``("rows", [row, ...])`` | ``("error", repr)`` |
    ``("end", worker_idx)``.
    """
    import queue as q

    import cloudpickle

    def put(item):
        while not stop_ev.is_set():
            try:
                outq.put(item, timeout=0.2)
                return True
            except q.Full:
                continue
        return False

    try:
        reader = cloudpickle.loads(reader_bytes)
        # shuffle_buffer=0: row mixing is the parent reservoir's job, so the
        # worker feed's internal rng is unused and the seed passes through
        feed = FileFeed(files, row_reader=reader, shuffle_buffer=0,
                        num_epochs=num_epochs, reader_threads=1,
                        seed=seed, shard=False)
        feed._ensure_started()  # _next_rows is end-of-stream until started
        pending = []
        while not stop_ev.is_set():
            block = feed._next_rows()
            if block is None:
                break
            pending.extend(block)
            while len(pending) >= block_rows:
                if not put(("rows", pending[:block_rows])):
                    return
                pending = pending[block_rows:]
        if pending and not stop_ev.is_set():
            put(("rows", pending))
    except BaseException as exc:  # noqa: B036 — relayed to the consumer
        put(("error", "{}: {}".format(type(exc).__name__, exc)))
    finally:
        # end marker must LAND (not best-effort): a dropped marker means the
        # parent's end-accounting never completes and the consumer hangs at
        # end of data.  The retry loop blocks until space or stop_ev — on
        # the stop path the parent no longer reads markers anyway.
        put(("end", worker_idx))
        if stop_ev.is_set():
            # terminating: don't let this process's queue feeder thread
            # block exit flushing buffered blocks into a full pipe, and
            # skip interpreter/C++ teardown entirely — abruptly-stopped
            # decoder libs abort ("terminate called without an active
            # exception") in their static destructors
            outq.cancel_join_thread()
            import os

            os._exit(0)


class ProcessPoolFeed(FileFeed):
    """FileFeed with the row readers in worker PROCESSES.

    JPEG decode (and any other CPU-heavy row transform) is GIL-bound in
    FileFeed's reader threads; this variant shards the file list over
    ``num_procs`` spawned processes — each decodes independently on its own
    core — and streams row blocks back over a single bounded mp queue.
    The consumer surface (``next_batch_arrays`` / reservoir shuffle /
    ``terminate``) is inherited unchanged, so ``ShardedFeed`` composes
    identically.

    The reference gets this concurrency from tf.data's C++ thread pool
    (``imagenet_preprocessing.py:87-175`` + ``num_parallel_calls``); a
    Python framework needs processes for the same effect.

    Args:
      files: shard files (process-sharded here unless ``shard=False``,
        then worker-sharded internally).
      row_reader: as FileFeed; cloudpickled to the workers.
      num_procs: worker process count (decode cores to use).
      block_rows: rows per IPC message (bounds message size: 32 rows of
        224x224x3 uint8 is ~4.8 MB).
      queue_blocks: bounded queue depth (backpressure on fast decoders).
    """

    def __init__(self, files, row_reader=None, shuffle_buffer=0,
                 num_epochs=1, num_procs=2, seed=0, shard=True,
                 block_rows=32, queue_blocks=16):
        super(ProcessPoolFeed, self).__init__(
            files, row_reader=row_reader, shuffle_buffer=shuffle_buffer,
            num_epochs=num_epochs, reader_threads=1, seed=seed, shard=shard)
        self.num_procs = max(1, min(num_procs, len(self.files)))
        self.block_rows = block_rows
        self.queue_blocks = queue_blocks
        self._procs = []
        self._stop_ev = None
        self._outq = None

    def _ensure_started(self):
        if self._started:
            return
        self._started = True
        import cloudpickle
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._stop_ev = ctx.Event()
        self._outq = ctx.Queue(maxsize=self.queue_blocks)
        reader_bytes = cloudpickle.dumps(self.row_reader)
        for i in range(self.num_procs):
            p = ctx.Process(
                target=_pool_worker,
                args=(reader_bytes, self.files[i::self.num_procs],
                      self.num_epochs, self._seed, i, self.block_rows,
                      self._outq, self._stop_ev),
                name="poolfeed-worker-%d" % i, daemon=True)
            p.start()
            self._procs.append(p)
        # one forwarder thread: mp queue -> the inherited consumer queue
        t = threading.Thread(target=self._forward, name="poolfeed-forward",
                             daemon=True)
        self._threads.append(t)
        t.start()

    def _forward(self):
        ended = 0
        try:
            while ended < self.num_procs and not self._interrupt.is_set():
                try:
                    kind, payload = self._outq.get(timeout=0.2)
                except _queue.Empty:
                    continue
                if kind == "end":
                    ended += 1
                elif kind == "error":
                    self._errors.put(IOError(payload))
                    return
                elif not self._put(payload):
                    return
        finally:
            # stop the workers on EVERY forwarder exit: on the error path
            # nothing else would, and surviving workers would spin retrying
            # puts into a full queue forever (normal end: workers already
            # exited, setting the event is a no-op)
            if self._stop_ev is not None:
                self._stop_ev.set()
            self._put(_END, force=True)

    def terminate(self):
        if self._stop_ev is not None:
            self._stop_ev.set()
        super(ProcessPoolFeed, self).terminate()
        for p in self._procs:
            p.join(timeout=5)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        # NEVER get() from the queue here: a killed producer can leave a
        # partial message and a "non-blocking" get would block in
        # recv_bytes.  The parent holds no unsent puts, so just detach.
        if self._outq is not None:
            self._outq.cancel_join_thread()
            self._outq.close()
