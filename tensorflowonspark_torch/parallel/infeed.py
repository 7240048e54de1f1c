"""Sharded per-host infeed: Spark-pushed partitions -> device-resident
local batches (the port's twin of
:class:`tensorflowonspark_tpu.parallel.infeed.ShardedFeed`).

The JAX package assembles each host's shard of a mesh-sharded global batch
and transfers it with ``jax.make_array_from_process_local_data``.  The port
has no mesh: each process of the ``torch.distributed`` world trains on its
own local batch of ``global_batch_size / world_size`` rows, and the
Trainer's gradient all-reduce makes the step the global batch's.  Each
host:

1. drains its queue into **columnar numpy batches** (feeders ship ColChunks
   as zero-copy framed ring records — :mod:`~tensorflowonspark_torch.wire`),
2. pads a short final batch to the local batch size with a validity mask,
3. copies it into **pinned** host tensors and from there to the card with
   ``non_blocking=True`` on a side CUDA stream; an event recorded after the
   copies is what the consumer's stream waits on before the step reads the
   batch, and ``record_stream`` tells the caching allocator that the
   consumer's stream uses the batch, so its memory is not handed out again
   while the step may still read it (the pinned host buffers are held by
   PyTorch's host allocator until their copies complete),
4. runs a tiny cross-host consensus each step (a gloo all-reduce, see
   :mod:`~tensorflowonspark_torch.parallel.collectives`) so all hosts agree
   whether a full step's worth of data exists,
5. prefetches (two batches by default) on a host thread, so assembly and
   the host->device copy overlap the device step,
6. for ``Trainer.multi_step``, groups K full batches into ``(K, B, ...)``
   stacks (:meth:`ShardedFeed.grouped_batches`): by default each batch is
   copied as it arrives and the group is stacked on the card on the
   prefetch thread's side stream; ``group_assembly="host"`` stacks on the
   host and makes one pinned copy per group.

With ``mesh=`` (the JAX keyword), the ranks that differ only in the
mesh's non-batch axes (:func:`~tensorflowonspark_torch.parallel.mesh.pooled_axes`:
``seq``, ``tensor``, ``pipe``, and ``expert`` unless ``batch_axes`` names
it) train on the same rows: every rank still feeds ``global_batch_size /
world_size`` rows (in SPARK mode it drains the partitions pushed to it),
and on the consuming thread that group all-gathers its members' batches and
masks.  Its batch is then ``N * global_batch_size / world_size`` rows for a
group of N.  Under a ``seq`` axis of P > 1 each rank keeps its chunk of
dim 1 of every leaf of rank 2 or more (the JAX ``PartitionSpec(batch_axes,
"seq")``).

On the CPU (``device="cpu"``, the tests) the batch is the same tensors,
copied from the feed's arrays, without a stream.  The ``infeed_*``
counters keep the JAX package's names and ride heartbeats the same way.
"""

import collections
import logging
import math
import os
import queue as _queue
import threading
import time

import numpy as np
import torch

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.device import resolve_device
from tensorflowonspark_torch.parallel import collectives
from tensorflowonspark_torch.parallel import mesh as mesh_mod

logger = logging.getLogger(__name__)

#: prefetch depth used when the ctor gets ``prefetch=None`` (double
#: buffering by default; 0 disables the prefetch thread entirely and moves
#: assembly + transfer back onto the dispatch path)
PREFETCH_ENV = "TFOS_INFEED_PREFETCH"
DEFAULT_PREFETCH = 2

#: how long :meth:`ShardedFeed.terminate` waits for the prefetch thread —
#: it can be mid host->device copy (not interruptible), so the join is
#: bounded, re-interrupting the feed each round; past the deadline the
#: queue drain is skipped (single-consumer invariant) and the daemon thread
#: is abandoned.
TERMINATE_JOIN_SECS = 30.0

#: how K-step groups are assembled when ``group_assembly=None`` (the JAX
#: package's variable): ``"device"`` (default) copies each batch as it
#: arrives and stacks the group on the card; ``"host"`` stacks on the host
#: and makes one copy per group
GROUP_ASSEMBLY_ENV = "TFOS_GROUP_ASSEMBLY"
DEFAULT_GROUP_ASSEMBLY = "device"


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _map_many(fn, trees):
    """``fn`` over the matching leaves of several trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_many(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_many(fn, [t[i] for t in trees])
                           for i in range(len(first)))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class ShardedFeed(object):
    """Iterator of device-resident local batches from a DataFeed.

    Args:
      feed: a :class:`~tensorflowonspark_torch.datafeed.DataFeed` (or any
        object with ``next_batch``/``next_batch_arrays``, ``should_stop``,
        ``interrupt`` and ``terminate``).
      global_batch_size: total batch across all processes; this process
        contributes ``global_batch_size / world_size`` rows per step.
      preprocess: optional ``fn(items) -> tree of np.ndarray`` turning a
        list of queue items into columnar arrays (the *row-list* path).
      transform: optional ``fn(arrays) -> tree of np.ndarray`` applied to
        the **columnar** batch from ``DataFeed.next_batch_arrays``.
      pad_final: when the feed ends mid-batch, pad the final batch to full
        size and attach a validity mask instead of dropping the tail.
      prefetch: batches assembled and copied to the card ahead on a host
        thread.  ``None`` reads ``TFOS_INFEED_PREFETCH`` (default 2); 0
        disables the thread.
      device: ``"cuda"`` by default; ``"cpu"`` only when asked (with no
        card otherwise this raises).
      group_assembly: how :meth:`grouped_batches` builds its stacks:
        ``"device"`` (stacked on the card from the per-batch copies; fresh
        buffers every group) or ``"host"`` (``np.stack``, one pinned copy a
        group).  ``None`` reads ``TFOS_GROUP_ASSEMBLY``.
      mesh: the device mesh (:func:`~tensorflowonspark_torch.parallel.mesh.build_mesh`)
        or None; its non-batch axes above 1 pool their ranks' rows (see
        the module docstring).
      batch_axes: the mesh axes that carry distinct rows (``("data",
        "fsdp")`` by default, JAX ``batch_sharding``'s; the LM twin adds
        ``"expert"``).
    """

    def __init__(self, feed, global_batch_size, preprocess=None,
                 transform=None, pad_final=True, prefetch=None, device=None,
                 group_assembly=None, mesh=None, batch_axes=None):
        if preprocess is not None and transform is not None:
            raise ValueError("pass either preprocess (row-list path) or "
                             "transform (columnar)")
        self.device = resolve_device(device)
        self._num_processes = collectives.world_size()
        if global_batch_size % self._num_processes:
            raise ValueError(
                "global_batch_size {} does not split over {} processes".format(
                    global_batch_size, self._num_processes))
        self.mesh = mesh
        self.batch_axes = batch_axes
        self._pool_group = None
        if mesh is not None:
            mesh_mod.local_batch_size(mesh, global_batch_size, batch_axes)
            pooled = mesh_mod.pooled_axes(mesh, batch_axes)
            self._pool_group = mesh_mod.groups(mesh, pooled)
            self._pool_size = math.prod(mesh_mod.axis_size(mesh, a)
                                        for a in pooled)
            self._seq_size = mesh_mod.axis_size(mesh, "seq")
            self._seq_rank = (mesh.get_local_rank("seq")
                              if self._seq_size > 1 else 0)
        self.feed = feed
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // self._num_processes
        self.preprocess = preprocess  # None = columnar next_batch_arrays path
        self.transform = transform
        self.pad_final = pad_final
        if prefetch is None:
            prefetch = int(os.environ.get(PREFETCH_ENV, "")
                           or DEFAULT_PREFETCH)
        self._prefetch_depth = prefetch
        if group_assembly is None:
            group_assembly = (os.environ.get(GROUP_ASSEMBLY_ENV, "")
                              or DEFAULT_GROUP_ASSEMBLY)
        if group_assembly not in ("device", "host"):
            raise ValueError(
                "group_assembly must be 'device' or 'host', got {!r}".format(
                    group_assembly))
        self._group_assembly = group_assembly
        # live group size: grouped_batches(k) seeds _group_k; a
        # train_steps_per_call knob lands in _group_k_target and is taken at
        # the next group-fill start, so every group is uniform
        self._group_k = 0
        self._group_k_target = None
        self._group_assemble_us = 0
        self._group_assemble_us_hwm = 0
        # Always-on plain-int tallies (read at heartbeat cadence; single
        # writer: the prefetch thread, or the consumer when prefetch=0).
        self._n_batches = 0
        self._assembly_us = 0
        self._assembly_us_hwm = 0
        self._put_us = 0
        self._put_us_hwm = 0
        self._stream = None          # side stream of the copies (lazy)
        self._stop = None            # prefetch stop event (set in batches())
        self._prefetch_thread = None
        self._prefetch_buf = None    # live prefetch queue (apply_knob target)
        # Trace-flow relay: ids popped from the upstream feed
        # (ServiceFeed.pop_flow_id) at device-copy time, re-parked here for
        # the trainer's dispatch leg (pop_dispatch_flow).  Best-effort,
        # bounded; single producer (the prefetch thread), single consumer.
        self._dispatch_flows = collections.deque(maxlen=16)
        # Ride this node's heartbeats (duck-typed counters_snapshot).
        from tensorflowonspark_torch import node as _node_mod

        _node_mod._register_feed(self)

    # -- overlap accounting ----------------------------------------------

    def _tally_assembly(self, start):
        us = int((time.perf_counter() - start) * 1e6)
        self._assembly_us += us
        if us > self._assembly_us_hwm:
            self._assembly_us_hwm = us

    def _tally_put(self, start):
        us = int((time.perf_counter() - start) * 1e6)
        self._put_us += us
        if us > self._put_us_hwm:
            self._put_us_hwm = us

    def _note_flow(self, leg, **attrs):
        """Relay a committed-split trace-flow id (if the upstream feed
        carries one) through the device-copy leg to the dispatch leg."""
        pop = getattr(self.feed, "pop_flow_id", None)
        if pop is None:
            return
        try:
            fid = pop()
        except Exception:  # pragma: no cover - duck-typed feeds
            return
        if fid:
            telemetry.get_tracer().flow_step(
                "dataservice/split_flow", fid, leg=leg, **attrs)
            self._dispatch_flows.append(int(fid))

    def pop_dispatch_flow(self):
        """Oldest undrained trace-flow id that reached the device infeed
        (or None); drained by ``Trainer.fit_feed`` to end the flow at the
        dispatch leg."""
        try:
            return self._dispatch_flows.popleft()
        except IndexError:
            return None

    def counters_snapshot(self):
        """Flat infeed overlap counters under the JAX package's names:
        ``infeed_batches`` (device transfers), ``infeed_assembly_us`` (host
        columnar assembly, including time blocked on the upstream feed),
        ``infeed_put_us`` (host time to issue the pinned copy and the
        host->device copy; the copy itself runs on the side stream),
        per-batch ``_hwm`` high-water marks of both,
        ``train_group_assemble_us`` (+``_hwm``: host time to launch the
        device-side stack of a group) and the ``infeed_prefetch_depth_max``
        gauge."""
        return {
            "infeed_batches": self._n_batches,
            "infeed_assembly_us": self._assembly_us,
            "infeed_assembly_us_hwm": self._assembly_us_hwm,
            "infeed_put_us": self._put_us,
            "infeed_put_us_hwm": self._put_us_hwm,
            "train_group_assemble_us": self._group_assemble_us,
            "train_group_assemble_us_hwm": self._group_assemble_us_hwm,
            "infeed_prefetch_depth_max": self._prefetch_depth,
        }

    def apply_knob(self, name, value):
        """Live-knob hook: ``infeed_prefetch`` retunes the prefetch depth
        mid-run (applied to the running prefetch queue in place; a feed
        built with ``prefetch=0`` takes a raise at the next ``batches()``).
        ``train_steps_per_call`` sets the group size that
        :meth:`grouped_batches` takes at its next group-fill start (never
        mid-group); it is refused in a world of more than one process,
        where a knob reaching the ranks at different steps would break
        their lock-step.  Returns True when the knob was claimed."""
        if name == "train_steps_per_call":
            if self._num_processes > 1:
                logger.warning(
                    "refusing live train_steps_per_call retune in a "
                    "%d-process world (per-process knob delivery skew "
                    "would desync grouped lock-step)", self._num_processes)
                return False
            self._group_k_target = max(int(value), 1)
            return True
        if name != "infeed_prefetch":
            return False
        depth = max(int(value), 1)
        self._prefetch_depth = depth
        buf = self._prefetch_buf
        if buf is not None:
            with buf.mutex:
                buf.maxsize = depth
                buf.not_full.notify_all()
        return True

    @property
    def group_assembly(self):
        """``"device"`` or ``"host"``: how grouped stacks are built."""
        return self._group_assembly

    @property
    def group_donation_safe(self):
        """True when every group's stacks are fresh buffers (device
        assembly), the JAX package's condition for donating them."""
        return self._group_assembly == "device"

    # -- host-side batch assembly ----------------------------------------

    def _next_local(self):
        """Assemble this host's local batch as final columnar arrays;
        returns (arrays, count) or None when no usable rows remain."""
        start = time.perf_counter()
        with telemetry.get_tracer().span("infeed/assemble"):
            local = self._next_local_inner()
        if local is not None:
            self._tally_assembly(start)
        return local

    def _next_local_inner(self):
        if self.preprocess is not None:
            # row-list path: user preprocess consumes the raw item lists
            items = self.feed.next_batch(self.local_batch_size)
            if isinstance(items, dict):
                count = len(next(iter(items.values()))) if items else 0
            else:
                count = len(items)
            if count == 0:
                return None
            arrays = self.preprocess(items)
        else:
            arrays, count = self.feed.next_batch_arrays(self.local_batch_size)
            if count == 0:
                return None
            if self.transform is not None:
                arrays = self.transform(arrays)
        if count < self.local_batch_size and not self.pad_final:
            # partial tail with padding disabled: drop it (documented)
            logger.info("dropping %d-row partial tail (pad_final=False)", count)
            return None
        return arrays, count

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def _shard(self, arrays, count):
        """Pad to the local batch size and put the batch on the device;
        returns ``(batch, mask, count, ready)``, ``ready`` the CUDA event
        that follows the copies (None on the CPU)."""
        def to_padded(col):
            col = np.asarray(col)
            if count < self.local_batch_size:
                pad = [(0, self.local_batch_size - count)] + \
                      [(0, 0)] * (col.ndim - 1)
                col = np.pad(col, pad)
            return col

        local = _map(arrays, to_padded)
        mask = np.zeros((self.local_batch_size,), dtype=np.float32)
        mask[:count] = 1.0
        with telemetry.get_tracer().span("infeed/device_put", rows=count):
            batch, mask_t, ready = self._to_device(local, mask)
        self._n_batches += 1
        self._note_flow("infeed_device_put", rows=count)
        return batch, mask_t, count, ready

    def _to_device(self, local, mask):
        """Numpy ``local`` (a tree) and ``mask`` as tensors on the device:
        ``(batch, mask, ready)``.  On the card through pinned host tensors,
        copied on the side stream; ``ready`` is the event after the copies
        (None on the CPU)."""
        start = time.perf_counter()
        if self.device.type == "cpu":
            # copies: the feed's arrays may view buffers it reuses
            batch = _map(local, lambda x: torch.from_numpy(np.array(x)))
            mask_t, ready = torch.from_numpy(mask), None
        else:
            pinned = _map(local, lambda x: torch.from_numpy(
                np.ascontiguousarray(x)).pin_memory())
            pinned_mask = torch.from_numpy(mask).pin_memory()
            stream = self._side_stream()
            with torch.cuda.stream(stream):
                batch = _map(pinned, lambda t: t.to(self.device,
                                                    non_blocking=True))
                mask_t = pinned_mask.to(self.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(stream)
        self._tally_put(start)
        return batch, mask_t, ready

    def _handoff(self, item, stacked=False):
        """``(batch, mask)`` of a sharded item, safe to use on the calling
        thread's current stream: that stream waits for the copies, and the
        allocator learns that it uses the tensors.  On a mesh with non-batch
        axes above 1, the group's pooled rows (see :meth:`_pool_rows`)."""
        batch, mask, _, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in _leaves(batch) + [mask]:
                t.record_stream(consumer)
        if self._pool_group is not None:
            row_dim = 1 if stacked else 0
            batch = _map(batch, lambda t: self._pool_rows(t, row_dim))
            mask = self._pool_rows(mask, row_dim)
        return batch, mask

    def _pool_rows(self, t, row_dim):
        """All-gather ``t`` over the pooling group along its row dim (the
        members' rows in rank order) and, under a ``seq`` axis above 1, keep
        this rank's chunk of the next dim, when ``t`` has one.  Runs on the
        consuming thread, in the order of the step's own collectives on
        every rank."""
        size = self._pool_size
        out = torch.empty(size * t.numel(), dtype=t.dtype, device=t.device)
        torch.distributed.all_gather_into_tensor(
            out, t.contiguous().view(-1), group=self._pool_group)
        pooled = out.view((size,) + tuple(t.shape)).movedim(0, row_dim) \
            .flatten(row_dim, row_dim + 1)
        if self._seq_size > 1 and pooled.dim() > row_dim + 1:
            size = self._seq_size
            chunk = pooled.shape[row_dim + 1] // size
            pooled = pooled.narrow(row_dim + 1, self._seq_rank * chunk,
                                   chunk)
        return pooled.contiguous()

    # -- public iteration -------------------------------------------------

    def batches(self, drain="any"):
        """Generator of ``(batch, mask)`` local batches on the device.

        Every process must iterate in lock-step (the Trainer all-reduces
        each step); the per-step consensus guarantees they agree on when to
        stop, even when partitions are uneven across hosts.

        ``drain`` picks the uneven-tail semantics:

        - ``"any"`` (training default): stop as soon as ANY host runs out —
          a full global batch exists every step; stragglers' tails drop.
        - ``"all"`` (exact evaluation): run until EVERY host is exhausted —
          hosts that ran out keep stepping with a zero-mask dummy batch (a
          masked copy of their last real batch), so no host's rows are ever
          dropped.  Requires each host to produce at least one real batch.
        """
        if drain not in ("any", "all"):
            raise ValueError(
                "drain must be 'any' or 'all', got {!r}".format(drain))
        if drain == "all" and not self.pad_final:
            raise ValueError(
                "drain='all' (exact evaluation) requires pad_final=True")
        stop = self._stop = threading.Event()
        source = (self._prefetched(stop, self._sharded_iter())
                  if self._prefetch_depth else self._sharded_iter())
        template = None
        try:
            for item in source:
                has_data = item is not None
                if drain == "all":
                    if has_data:
                        template = self._handoff(item)
                        if not collectives.any_host_has_data(True):
                            break  # unreachable, keeps call counts aligned
                        yield template
                    else:
                        yield from self._drain_dummies(template)
                        return
                    continue
                if not collectives.end_of_data_consensus(has_data):
                    if has_data:
                        logger.info(
                            "dropping a final partial step (%d local rows): "
                            "another host exhausted its feed", item[2])
                    break
                yield self._handoff(item)
        finally:
            stop.set()  # wind the prefetch thread down on any exit path

    def _drain_dummies(self, template):
        """drain="all" epilogue: this host is exhausted — keep the ranks in
        lock-step with zero-mask dummy steps until every other host is
        exhausted too."""
        if template is None:
            # Raise BEFORE joining any collective: joining first would let
            # the other hosts proceed into their next step and block on a
            # reduction this process never enters.
            raise RuntimeError(
                "drain='all' needs at least one local batch to shape "
                "dummy steps; this host's feed was empty (rebalance "
                "shards so every process gets data)")
        zero_mask = None
        while collectives.any_host_has_data(False):
            if zero_mask is None:
                zero_mask = template[1] * 0.0
            yield template[0], zero_mask

    def grouped_batches(self, k):
        """Generator of ``("multi", batch_stack, mask_stack)`` groups of K
        full batches on the device (leaves shaped ``(k, local_batch,
        ...)``) and ``("single", batch, mask)`` items for tails that cannot
        fill a group, for ``Trainer.fit_feed(steps_per_call=k)``.

        Lock-step across processes, as in the JAX package: before each
        group all processes agree that they ALL hold a full group; the
        first disagreement degrades every process to single steps for the
        rest of the feed (groups already assembled are sliced back into
        singles), where the per-step end-of-data consensus of
        :meth:`batches` takes over."""
        stop = self._stop = threading.Event()
        source = (self._prefetched(stop, self._grouped_iter(k))
                  if self._prefetch_depth else self._grouped_iter(k))
        grouped_ok = True
        try:
            for item in source:
                item = self._handoff_group(item)
                if grouped_ok:
                    is_group = item is not None and item[0] == "multi"
                    if collectives.all_hosts_agree(is_group):
                        yield item
                        continue
                    grouped_ok = False
                    logger.info("degrading to single-step mode (a process "
                                "cannot fill a %d-step group)", k)
                for single in self._degrade(item):
                    if not collectives.end_of_data_consensus(
                            single is not None):
                        return
                    yield single
        finally:
            stop.set()

    def _handoff_group(self, item):
        """A grouped item, ``(kind, batch, mask)``, safe to use on the
        calling thread's stream (see :meth:`_handoff`); None stays None."""
        if item is None:
            return None
        kind, batch, mask, ready = item
        return (kind,) + self._handoff((batch, mask, None, ready),
                                       stacked=kind == "multi")

    @staticmethod
    def _degrade(item):
        """Split one grouped item into single-step items (views of an
        assembled group's slots); a trailing None stays None so the
        caller's consensus sees end-of-feed.  The group size is read off
        the mask stack: a group buffered before a knob retune carries its
        own K."""
        if item is None:
            return [None]
        if item[0] == "single":
            return [item]
        _, stack, masks = item
        return [("single", _map(stack, lambda t: t[i]), masks[i])
                for i in range(masks.shape[0])]

    def _live_group_k(self):
        """The current group size, with a pending knob retune folded in.
        Read only at group-fill starts, so K changes land on group
        boundaries."""
        target = self._group_k_target
        if target and target != self._group_k:
            logger.info("grouped infeed: steps_per_call %d -> %d (group "
                        "boundary)", self._group_k, target)
            self._group_k = target
        return self._group_k

    def _grouped_iter(self, k):
        """Yields ``("multi", stack, masks, ready)`` for runs of K full
        local batches and ``("single", batch, mask, ready)`` for the rest,
        then a single None.  Once a batch arrives short (the end of the
        feed) the iterator stays in single mode."""
        self._group_k = max(int(k), 1)
        host = self._group_assembly == "host"
        pending = []   # full batches awaiting a group: arrays (host mode)
        singles_mode = False   # or sharded items (device mode)
        group_k = self._live_group_k()
        for local in self._local_iter():
            if local is None:
                break
            arrays, count = local
            if not singles_mode and count == self.local_batch_size:
                if not pending:
                    group_k = self._live_group_k()
                pending.append(arrays if host else self._shard(arrays, count))
                if len(pending) >= group_k:
                    item = (self._put_group(pending) if host
                            else self._assemble_group(pending))
                    pending = []
                    yield item
                continue
            singles_mode = True
            for p in pending:
                yield self._single(p, host)
            pending = []
            yield self._single(self._shard(arrays, count), False)
        for p in pending:
            yield self._single(p, host)
        yield None

    def _single(self, pending, host):
        """A pending full batch as a ``("single", ...)`` item."""
        if host:
            pending = self._shard(pending, self.local_batch_size)
        batch, mask, _, ready = pending
        return ("single", batch, mask, ready)

    def _assemble_group(self, pending):
        """Stack k batches already copied to the device, on the stream
        their copies went to (the side stream on the card), so the host
        never holds the Kx copy; returns a ``"multi"`` item whose event
        follows the stacking."""
        group = len(pending)
        start = time.perf_counter()
        with telemetry.get_tracer().span("infeed/group_assemble",
                                         group=group):
            if self.device.type == "cpu":
                stack, masks = self._stack(pending)
                ready = None
            else:
                stream = self._side_stream()
                with torch.cuda.stream(stream):
                    stack, masks = self._stack(pending)
                    ready = torch.cuda.Event()
                    ready.record(stream)
        us = int((time.perf_counter() - start) * 1e6)
        self._group_assemble_us += us
        self._group_assemble_us_hwm = max(self._group_assemble_us_hwm, us)
        self._note_flow("infeed_group_assemble", group=group)
        return ("multi", stack, masks, ready)

    @staticmethod
    def _stack(pending):
        """``(batch stack, mask stack)`` of sharded items."""
        return (_map_many(lambda *leaves: torch.stack(leaves),
                          [p[0] for p in pending]),
                torch.stack([p[1] for p in pending]))

    def _put_group(self, pending):
        """Host assembly: ``np.stack`` k full local batches and copy the
        group to the device at once (pinned on the card)."""
        group = len(pending)
        stack = _map_many(lambda *cols: np.stack([np.asarray(c)
                                                  for c in cols]), pending)
        masks = np.ones((group, self.local_batch_size), np.float32)
        with telemetry.get_tracer().span("infeed/device_put", group=group):
            stack, masks, ready = self._to_device(stack, masks)
        self._n_batches += group
        self._note_flow("infeed_device_put", group=group)
        return ("multi", stack, masks, ready)

    def wire_formats(self):
        """Transport/format counts the underlying feed observed, e.g.
        ``{"colv1": 120}`` when the zero-copy framed ring path carried every
        chunk."""
        return dict(getattr(self.feed, "wire_formats", None) or {})

    def terminate(self):
        """Terminate feeding early (training hit max steps with data left):
        marks the node terminating and drains the input queue so blocked
        feeders unblock (reference ``TFNode.terminate``).

        The queue and shm ring are strictly single-consumer, so the
        prefetch thread must be fully out before the drain starts: stop the
        producer, interrupt its blocked get, join it — then drain.  The
        join is BOUNDED (:data:`TERMINATE_JOIN_SECS`); a thread still alive
        past it is abandoned with a loud log and the drain skipped."""
        if self._stop is not None:
            self._stop.set()
        t = self._prefetch_thread
        if t is not None and t.is_alive():
            deadline = time.monotonic() + TERMINATE_JOIN_SECS
            while t.is_alive() and time.monotonic() < deadline:
                self.feed.interrupt()
                t.join(timeout=0.2)
            if t.is_alive():
                logger.error(
                    "infeed prefetch thread did not exit within %.0fs of "
                    "terminate(); skipping the queue drain (single-consumer "
                    "invariant) and abandoning the daemon thread",
                    TERMINATE_JOIN_SECS)
                return
        self.feed.terminate()

    def _local_iter(self):
        """Yields (arrays, count) per step, then a single None at end-of-feed.

        Stops *without another blocking queue read* once the feed reported
        end-of-feed — the final partial batch consumes the queue's only None
        sentinel, so a further next_batch() would block forever.
        """
        while not self.feed.should_stop():
            local = self._next_local()
            if local is None:
                break
            yield local
        yield None

    def _sharded_iter(self):
        """Yields ``(batch, mask, count, ready)`` per step, then a single
        None at end-of-feed."""
        for local in self._local_iter():
            if local is None:
                yield None
                return
            yield self._shard(*local)

    def _prefetched(self, stop, source_iter):
        """Host-thread prefetch: overlap queue drain, numpy assembly AND the
        host->device copy with the device step.  ``stop`` aborts the
        producer when the consumer exits early (max_steps / consensus)."""
        buf = _queue.Queue(maxsize=self._prefetch_depth)
        self._prefetch_buf = buf

        def _put(item):
            while not stop.is_set():
                try:
                    buf.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        def _producer():
            # An exception in the feed (e.g. a dead manager) travels through
            # the buffer so the consumer re-raises instead of blocking forever
            # on a producer that died without its None sentinel.
            try:
                for item in source_iter:
                    if not _put(item):
                        return
            except BaseException as exc:  # noqa: B036 — relayed, not handled
                _put(exc)

        t = threading.Thread(target=_producer, name="infeed-prefetch",
                             daemon=True)
        self._prefetch_thread = t
        t.start()
        while True:
            # Timed get + producer-liveness check: terminate() from another
            # thread sets stop and the producer exits WITHOUT its None
            # sentinel — a bare blocking get would then wait forever.
            try:
                item = buf.get(timeout=0.2)
            except _queue.Empty:
                if stop.is_set() and not t.is_alive():
                    return
                continue
            if isinstance(item, BaseException):
                raise item
            yield item
            if item is None:
                return
