"""Disaggregated data service: dispatcher + remote feed workers over TCP.

The port's copy of :mod:`tensorflowonspark_tpu.dataservice` (it never
imported jax); the copy is the port's own and frames, journals and
snapshots bytes exactly as the JAX module does, so either side's workers,
consumers and dispatchers interoperate.

Per-host input pipelines cap accelerator utilization once a model is
input-bound — the tf.data service (arXiv:2210.14826) shows the fix is to
move input processing onto a horizontally-scalable fleet of feed workers
and keep only a thin client on the accelerator hosts.  This module
composes the framework's existing planes into exactly that shape:

- :class:`DispatcherServer` — control plane.  Registers workers, owns the
  split ledger for each dataset job (sharding modes :data:`SHARD_OFF` /
  :data:`SHARD_STATIC` / :data:`SHARD_DYNAMIC`), monitors worker liveness
  with the same heartbeat/fencing semantics as the rendezvous
  (:mod:`~tensorflowonspark_torch.reservation`), and reassigns the splits of
  dead workers so every split is visited **exactly once per epoch**
  (tf.data's visitation guarantee, arXiv:2101.12127 §3.3).
- :class:`FeedWorker` — data plane producer.  Wraps a
  :class:`~tensorflowonspark_torch.data.FileFeed` /
  :class:`~tensorflowonspark_torch.data.ProcessPoolFeed` reader per split and
  streams row blocks to consumers as length-prefixed colv1 frames
  (:mod:`~tensorflowonspark_torch.wire`) with pickle fallback for
  object/ragged columns — the same framability rules as the shm-ring
  feeder (``node._ChunkPutter``).
- :class:`ServiceFeed` — data plane consumer.  ``DataFeed``-compatible
  ``next_batch`` / ``next_batch_arrays`` surface, so ``ShardedFeed`` and
  ``train.fit_supervised`` consume it unchanged; receiver threads
  double-buffer network frames ahead of consumption and tally
  ``wire_formats`` + ``dataservice_*`` telemetry counters that ride node
  heartbeats into ``TPUCluster.metrics_snapshot()``.

Exactly-once protocol (STATIC / DYNAMIC): a split travels as
``split_begin`` → data frames → ``split_end`` on one worker→consumer
stream.  The consumer buffers the split's frames and **commits** only on
``split_end``: it publishes the buffered chunks to its batch queue
exactly once (the ``(epoch, split)`` dedupe set), then reports ``DONE``
to the dispatcher at-least-once (``DONE`` is idempotent; a failed report
parks and is retried by the maintainer thread).  Publish-before-DONE
means the ledger can never say a job is done while committed chunks are
still unpublished — the completion path waits for receivers and never
evicts the queue.  A worker death mid-split drops the connection before
``split_end`` — the consumer discards the partial buffer, reports the
split ``LOST`` so the dispatcher re-pools it immediately (worker fencing
remains the backstop), and a surviving worker — or a redial of the same,
still-live worker after a transient TCP reset — re-streams it.  The
dedupe set makes the race between a fenced-but-alive zombie worker and
the reassigned replacement harmless: whichever ``split_end`` lands first
wins, the other is discarded.  A split a worker cannot *read* is aborted
in-band (``split_abort`` + ``SPLIT_ERR``): the dispatcher re-pools it up
to a small budget, then fails the job with the reader's error.

Wire protocol: the dispatcher speaks the length-prefixed-JSON
``MessageSocket`` idiom of :mod:`~tensorflowonspark_torch.reservation`
(``HBEAT``/``BYE`` are byte-compatible, so workers reuse
``HeartbeatSender`` verbatim).  Worker→consumer data streams use a 5-byte
``>IB`` prefix (payload length + kind): kind 0 JSON control, kind 1 a
colv1 frame, kind 2 pickled rows.

Multi-tenant v3 (tf.data-service shared jobs, arXiv:2210.14826 §4):

- **Shared jobs** — ``JOB`` is attach-or-create: a second run naming the
  same job with a compatible spec attaches as an additional *consumer*
  of the live ledger and the splits are handed out across all attached
  consumers exactly-once (each split streams to exactly ONE consumer; the
  runs split the read).  A consumer that detaches (``DETACH``) or goes
  silent past the heartbeat deadline has its bound splits rebound to the
  surviving consumers; a fenced consumer's later reports are refused
  under the same "fresh identity" rule as fenced workers.
- **Cache-affinity DYNAMIC scheduling** — workers advertise the source
  paths their :class:`_FrameCache` holds (registration + every
  heartbeat); the ledger's DYNAMIC hand-out gives a requesting worker a
  split it has cached, else one cached on no live worker (leaving warm
  splits for their holders), else FCFS head-of-queue, so pull-balancing
  is preserved and nothing ever waits on a cache holder.
- **Journaled dispatcher** — with ``journal_dir`` set, every ledger
  mutation is appended to a JSONL journal (flush-per-record) with
  periodic full snapshots; a SIGKILLed dispatcher restarted on the same
  port + journal dir replays the ledger and resumes in-flight jobs.
  Workers re-register when a heartbeat answer carries ``reregister``
  (the restarted dispatcher has never seen them); consumers reconnect
  lazily.  In-flight assignments recover as consumer-bound pending
  splits, so the consumer-side dedupe preserves exactly-once end to end.
"""

import collections
import json
import logging
import os
import pickle
import queue as _queue
import select
import socket
import struct
import threading
import time

import numpy as np

from tensorflowonspark_torch import fault, marker, telemetry, transport, wire
from tensorflowonspark_torch import standby as standby_mod
from tensorflowonspark_torch.reservation import (
    Client, HeartbeatSender, KnobCoordinator, MessageSocket,
    normalize_endpoints)

logger = logging.getLogger(__name__)

__all__ = [
    "SHARD_OFF", "SHARD_STATIC", "SHARD_DYNAMIC", "DispatchError",
    "DispatcherServer", "DispatcherClient", "FeedWorker", "ServiceFeed",
]

#: No coordination: every worker→consumer stream delivers the FULL dataset
#: (``num_epochs`` times).  No visitation guarantee — with W workers a
#: consumer sees W copies per epoch.  The mode for sample-with-replacement
#: training where duplication is acceptable (tf.data service ShardingPolicy
#: OFF).
SHARD_OFF = "off"
#: Splits are owned by workers (round-robin over the worker roster frozen
#: at first assignment); a dead worker's remaining splits transfer to
#: survivors.  Exactly-once per epoch.
SHARD_STATIC = "static"
#: First-come-first-served: any worker pops the next unvisited split.
#: Self-balancing under heterogeneous workers.  Exactly-once per epoch.
SHARD_DYNAMIC = "dynamic"

_MODES = (SHARD_OFF, SHARD_STATIC, SHARD_DYNAMIC)

# Data-stream framing lives in transport.py now (shared with the serving
# gateway); the underscore aliases keep every internal call site and the
# tests that poke them unchanged.
_DHEADER = transport.DHEADER
_K_JSON = transport.K_JSON       # UTF-8 JSON control message
_K_COLV1 = transport.K_COLV1     # one wire.py colv1 frame (zero-copy decode)
_K_PICKLE = transport.K_PICKLE   # pickled row list (object/ragged fallback)

_SENTINEL = object()     # internal end-of-feed marker on the chunk queue
_INTERRUPTED = object()  # internal next_batch abort marker

#: Reader failures tolerated per split before the job fails with the
#: reader's error.  One re-pool covers a transient fault on one worker; a
#: split no worker can read must fail the job with a pointer to the file,
#: not wedge it.
_SPLIT_ERROR_BUDGET = 2

#: How long a worker's new stream for a consumer waits for the stream it
#: supersedes to report its in-flight split LOST (that thread may be inside
#: a reader call when its socket is cut).
_SUPERSEDE_WAIT_SECS = 30.0


class DispatchError(RuntimeError):
    """The dispatcher answered ``ERR`` (unknown job, fenced worker, ...)."""


# ---------------------------------------------------------------------------
# Data-stream framing helpers (extracted to transport.py, re-exported here)
# ---------------------------------------------------------------------------

_SEND_COPY_MAX = transport.SEND_COPY_MAX
_recv_exact = transport.recv_exact
_recv_frame = transport.recv_frame
_send_frame = transport.send_frame
_send_json = transport.send_json
_addr_tuple = transport.addr_tuple


# ---------------------------------------------------------------------------
# Dispatcher: split ledger
# ---------------------------------------------------------------------------

class _Job(object):
    """Per-job split ledger (dispatcher-internal; all access serialized by
    the dispatcher's lock).

    Splits are file paths, identified by index.  Per epoch each split moves
    ``unassigned`` → ``assigned`` (bound to the ``(worker, consumer)`` that
    is streaming it) → ``completed`` (the consumer's ``DONE`` after a
    committed ``split_end``).  A worker death moves its assigned splits to
    ``pending[consumer]`` — still bound to the SAME consumer, so the
    consumer-side dedupe set covers every path a duplicate could take.

    Multi-tenant: ``consumers`` is the set of attached runs; a split is
    handed out once regardless of how many consumers are attached (the
    attached runs *split* the read).  :meth:`detach` rebinds a departing
    consumer's splits to survivors (or back to the pool), and a fenced
    consumer id can never re-attach (fresh-identity rule)."""

    def __init__(self, name, splits, num_epochs, mode):
        self.name = name
        self.splits = list(splits)
        self.num_epochs = int(num_epochs)
        self.mode = mode
        self.epoch = 0
        self.done = not self.splits or self.num_epochs <= 0
        self.error = None          # set => job failed (unreadable split)
        self.split_errors = {}     # split idx -> reader-failure count
        self.reassigned = 0        # splits re-pooled from dead workers (total)
        self.static_owner = None   # split idx -> worker_id (STATIC, lazy)
        self.off_served = set()    # (worker, consumer) streams served (OFF)
        self.consumers = set()     # attached consumer ids
        self.fenced_consumers = set()
        self.affinity_hits = 0     # DYNAMIC hand-outs landing on a holder
        self.affinity_total = 0    # all DYNAMIC hand-outs (A/B denominator)
        self._init_epoch()

    def _init_epoch(self):
        self.unassigned = list(range(len(self.splits)))
        self.assigned = {}   # split idx -> (worker_id, consumer_id)
        self.completed = set()
        self.pending = {}    # consumer_id -> [split idx] (death reassignments)

    def spec(self):
        return {"splits": self.splits, "num_epochs": self.num_epochs,
                "mode": self.mode}

    # -- consumers ---------------------------------------------------------

    def attach(self, consumer_id):
        """Attach a consumer; True when it is new to this job."""
        if not consumer_id or consumer_id in self.consumers:
            return False
        self.consumers.add(consumer_id)
        return True

    def detach(self, consumer_id, fence=False):
        """Detach a consumer and rebind its in-flight + pending splits to
        the surviving consumers (round-robin) or back to the unassigned
        pool when it was the last one.  ``fence=True`` additionally bans
        the id (liveness fencing — a fenced-but-alive consumer's later
        reports are refused, so its parked DONEs can never race the
        rebound copies).  Returns how many splits moved."""
        self.consumers.discard(consumer_id)
        if fence:
            self.fenced_consumers.add(consumer_id)
        orphans = [s for s, (w, c) in self.assigned.items()
                   if c == consumer_id]
        for s in orphans:
            del self.assigned[s]
        orphans.extend(self.pending.pop(consumer_id, []))
        heirs = sorted(self.consumers)
        moved = 0
        for i, s in enumerate(sorted(set(orphans))):
            if s in self.completed:
                continue
            self._unbind(s)
            if heirs:
                self.pending.setdefault(heirs[i % len(heirs)], []).append(s)
            else:
                self.unassigned.append(s)
            moved += 1
        self.reassigned += moved
        return moved

    def _unbind(self, split):
        """Remove a split from the unassigned pool and every pending list
        (so a rebind never leaves a second copy behind)."""
        if split in self.unassigned:
            self.unassigned.remove(split)
        for pend in self.pending.values():
            if split in pend:
                pend.remove(split)

    # -- assignment --------------------------------------------------------

    def _ensure_static_owners(self, live_workers):
        if self.static_owner is None:
            owners = sorted(live_workers)
            self.static_owner = {
                i: owners[i % len(owners)] if owners else None
                for i in range(len(self.splits))}

    def _pick(self, candidates, worker_id, worker_caches, affinity):
        """The next DYNAMIC split for ``worker_id`` out of ``candidates``
        (non-empty).  With affinity on, prefer (a) a split this worker's
        cache holds, then (b) one no live worker holds — leaving warm
        splits for their holders while they still have cold work — and
        only then (c) the FCFS head.  (c) means a cold worker is never
        starved waiting on a cache holder: availability wins at the tail,
        which is the pull-scheduling analogue of least-loaded fallback."""
        if not affinity or not worker_caches:
            return candidates[0]
        mine = worker_caches.get(worker_id) or ()
        for s in candidates:
            if self.splits[s] in mine:
                return s
        held = set()
        for w, paths in worker_caches.items():
            if w != worker_id:
                held.update(paths)
        if held:
            for s in candidates:
                if self.splits[s] not in held:
                    return s
        return candidates[0]

    def _bind(self, split, worker_id, consumer_id, worker_caches):
        self.assigned[split] = (worker_id, consumer_id)
        if self.mode == SHARD_DYNAMIC:
            # tallied for EVERY dynamic hand-out, affinity knob on or off,
            # so the A/B bench can compare hit rates between the two
            self.affinity_total += 1
            if (worker_caches
                    and self.splits[split] in
                    (worker_caches.get(worker_id) or ())):
                self.affinity_hits += 1
        return {"splits": [[split, self.splits[split]]], "epoch": self.epoch}

    def next_splits(self, worker_id, consumer_id, live_workers,
                    worker_caches=None, affinity=False):
        """One TASK answer: ``{"splits": [[idx, path]], "epoch": e}``, or
        ``{"wait": True}`` (epoch still completing / nothing for this
        worker yet), or ``{"done": True}`` (job exhausted).

        ``worker_caches`` maps worker id → set of cached source paths (the
        heartbeat advertisement); with ``affinity`` DYNAMIC hand-outs —
        fresh and re-pooled alike — prefer cache holders (:meth:`_pick`)."""
        if self.mode == SHARD_OFF:
            key = (worker_id, consumer_id)
            if self.done or key in self.off_served:
                return {"done": True}
            self.off_served.add(key)
            return {"splits": [[i, p] for i, p in enumerate(self.splits)],
                    "epoch": 0, "epochs": self.num_epochs}
        if self.done:
            return {"done": True}
        dyn = self.mode == SHARD_DYNAMIC
        # 1. death-reassigned splits bound to this consumer (any worker may
        #    serve them — the original owner is gone)
        pend = self.pending.get(consumer_id)
        if pend:
            # the zombie's copy already landed / re-pooled twice: drop those
            valid = [s for s in pend
                     if s not in self.completed and s not in self.assigned]
            self.pending[consumer_id] = valid
            if valid:
                s = (self._pick(valid, worker_id, worker_caches, affinity)
                     if dyn else valid[0])
                valid.remove(s)
                return self._bind(s, worker_id, consumer_id, worker_caches)
        # 2. fresh splits
        if self.mode == SHARD_STATIC:
            self._ensure_static_owners(live_workers)
            for i, s in enumerate(self.unassigned):
                owner = self.static_owner.get(s)
                if owner is None or owner == worker_id:
                    self.unassigned.pop(i)
                    return self._bind(s, worker_id, consumer_id,
                                      worker_caches)
        elif self.unassigned:
            s = self._pick(self.unassigned, worker_id, worker_caches,
                           affinity)
            self.unassigned.remove(s)
            return self._bind(s, worker_id, consumer_id, worker_caches)
        return {"wait": True}

    def complete(self, epoch, split, consumer_id):
        """Consumer's ``DONE`` for a committed split; idempotent."""
        if (self.mode == SHARD_OFF or self.done or self.error is not None
                or epoch != self.epoch):
            return {"ok": True, "stale": True}
        if split in self.completed:
            return {"ok": True, "duplicate": True}
        self.completed.add(split)
        self.assigned.pop(split, None)
        for pend in self.pending.values():
            if split in pend:
                pend.remove(split)
        if len(self.completed) == len(self.splits):
            self.epoch += 1
            if self.epoch >= self.num_epochs:
                self.done = True
            else:
                self._init_epoch()
        return {"ok": True}

    def release_worker(self, worker_id, live_workers):
        """Re-pool a dead (or departing) worker's uncompleted splits; STATIC
        ownership of its unstarted splits transfers to survivors.  Returns
        the re-pooled ``(split, consumer)`` bindings (for the journal)."""
        moved = []
        for s, (w, consumer) in list(self.assigned.items()):
            if w == worker_id:
                del self.assigned[s]
                self.pending.setdefault(consumer, []).append(s)
                moved.append((s, consumer))
        if self.mode == SHARD_STATIC and self.static_owner:
            survivors = sorted(w for w in live_workers if w != worker_id)
            n = 0
            for s, owner in list(self.static_owner.items()):
                if owner == worker_id:
                    self.static_owner[s] = (
                        survivors[n % len(survivors)] if survivors else None)
                    n += 1
        self.reassigned += len(moved)
        return moved

    def release_split(self, epoch, split, worker_id, consumer_id):
        """Re-pool one split whose worker→consumer stream broke while the
        worker may still be alive (the consumer's ``LOST`` report) —
        recovery without waiting for a heartbeat fence.  Idempotent and
        stale-safe like :meth:`complete`."""
        if (self.mode == SHARD_OFF or self.done or self.error is not None
                or epoch != self.epoch or split in self.completed):
            return {"ok": True, "stale": True}
        if self.assigned.get(split) != (worker_id, consumer_id):
            return {"ok": True, "stale": True}
        del self.assigned[split]
        self.pending.setdefault(consumer_id, []).append(split)
        self.reassigned += 1
        return {"ok": True}

    def record_split_error(self, epoch, split, worker_id, consumer_id, desc):
        """A worker failed to READ a split (its stream is intact).  Re-pool
        it for another attempt up to :data:`_SPLIT_ERROR_BUDGET`; past the
        budget the job fails carrying the reader's error, so consumers
        surface the cause instead of retrying an unreadable file forever."""
        if (self.mode == SHARD_OFF or self.done or self.error is not None
                or epoch != self.epoch or split in self.completed):
            return {"ok": True, "stale": True}
        if self.assigned.get(split) == (worker_id, consumer_id):
            del self.assigned[split]
        n = self.split_errors.get(split, 0) + 1
        self.split_errors[split] = n
        if n >= _SPLIT_ERROR_BUDGET:
            self.error = ("split {} ({!r}) unreadable after {} attempt(s), "
                          "last on worker {}: {}".format(
                              split, self.splits[split], n, worker_id, desc))
            return {"ok": True, "failed": True}
        self.pending.setdefault(consumer_id, []).append(split)
        self.reassigned += 1
        return {"ok": True}

    def status(self):
        return {"job": self.name, "mode": self.mode, "epoch": self.epoch,
                "num_epochs": self.num_epochs, "error": self.error,
                "num_splits": len(self.splits), "done": self.done,
                "completed": len(self.completed),
                "assigned": len(self.assigned),
                "pending": sum(len(v) for v in self.pending.values()),
                "reassigned": self.reassigned,
                "consumers": len(self.consumers),
                "affinity_hits": self.affinity_hits,
                "affinity_total": self.affinity_total}

    # -- journal state -----------------------------------------------------

    def to_state(self):
        """JSON-serializable full ledger state (snapshot records)."""
        return {
            "name": self.name, "splits": list(self.splits),
            "num_epochs": self.num_epochs, "mode": self.mode,
            "epoch": self.epoch, "done": self.done, "error": self.error,
            "split_errors": sorted(self.split_errors.items()),
            "reassigned": self.reassigned,
            "static_owner": (sorted(self.static_owner.items())
                             if self.static_owner is not None else None),
            "off_served": sorted(list(k) for k in self.off_served),
            "unassigned": list(self.unassigned),
            "assigned": sorted([s, w, c]
                               for s, (w, c) in self.assigned.items()),
            "completed": sorted(self.completed),
            "pending": {c: list(v) for c, v in self.pending.items()},
            "consumers": sorted(self.consumers),
            "fenced_consumers": sorted(self.fenced_consumers),
        }

    @classmethod
    def from_state(cls, state):
        job = cls(state["name"], state["splits"],
                  state["num_epochs"], state["mode"])
        job.epoch = int(state["epoch"])
        job.done = bool(state["done"])
        job.error = state.get("error")
        job.split_errors = {int(k): int(v)
                            for k, v in state.get("split_errors", [])}
        job.reassigned = int(state.get("reassigned", 0))
        so = state.get("static_owner")
        job.static_owner = ({int(k): v for k, v in so}
                            if so is not None else None)
        job.off_served = set(tuple(k) for k in state.get("off_served", []))
        job.unassigned = [int(s) for s in state.get("unassigned", [])]
        job.assigned = {int(s): (w, c)
                        for s, w, c in state.get("assigned", [])}
        job.completed = set(int(s) for s in state.get("completed", []))
        job.pending = {c: [int(s) for s in v]
                       for c, v in (state.get("pending") or {}).items()}
        job.consumers = set(state.get("consumers", []))
        job.fenced_consumers = set(state.get("fenced_consumers", []))
        return job


# ---------------------------------------------------------------------------
# DispatcherServer
# ---------------------------------------------------------------------------

def _env_int(name, default):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring non-integer %s=%r", name, raw)
        return default


def _env_flag(name, default):
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "false", "off", "no")


class DispatcherServer(MessageSocket):
    """Data-service control plane: worker registry + split ledgers.

    Single listener thread multiplexing all connections with ``select``
    (the :class:`~tensorflowonspark_torch.reservation.Server` idiom); worker
    liveness uses the same fencing semantics — a worker past
    ``interval × misses`` of heartbeat silence is declared dead, its beats
    are rejected from then on (``HeartbeatSender`` stops itself on the
    fence answer), and its uncompleted splits are re-pooled.

    Message types (length-prefixed JSON): ``WREG`` (worker registration),
    ``HBEAT``/``BYE`` (byte-compatible with the rendezvous, so workers
    reuse ``HeartbeatSender``), ``JOB`` (attach-or-create job
    registration), ``DETACH`` (consumer departure: rebind its splits),
    ``WORKERS`` (live roster for consumers), ``TASK`` (split request),
    ``DONE`` (consumer's split-visited report), ``LOST`` (consumer's
    broken-stream report: re-pool the mid-flight split without waiting
    for a fence), ``SPLIT_ERR`` (worker's reader-fault report: re-pool up
    to a budget, then fail the job with the cause), ``STATUS``, ``STOP``.

    Durability: with ``journal_dir`` set (or ``TFOS_DS_JOURNAL_DIR``),
    every ledger mutation appends one JSONL record to the current journal
    segment, flushed per record; every ``snapshot_every`` records the
    full state is snapshotted (``snapshot-<seq>.json``, atomic
    tmp+rename) and a fresh segment (``journal-<seq>.jsonl``) starts.
    :meth:`start` recovers from the newest snapshot plus its segment
    before accepting connections — in-flight assignments come back as
    consumer-bound pending splits (the assigned workers' streams died
    with the old process), so the consumer-side dedupe keeps visitation
    exactly-once across the restart.

    ``affinity`` (default on; ``TFOS_DS_AFFINITY=0`` to disable) enables
    cache-affinity DYNAMIC hand-out from the worker cache advertisements
    riding WREG and HBEAT.  ``port`` pins the listen port (0 = ephemeral)
    so a restarted dispatcher is reachable at the old address.
    """

    def __init__(self, heartbeat_interval=1.0, heartbeat_misses=3,
                 host=None, port=0, journal_dir=None, snapshot_every=None,
                 affinity=None, journal_keep=None, journal_keep_bytes=None,
                 beacon_interval=None, takeover_grace=None):
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_misses = heartbeat_misses
        self._host = host
        self._port = int(port)
        if beacon_interval is None:
            beacon_interval = (min(max(heartbeat_interval / 2.0, 0.1), 0.5)
                               if heartbeat_interval else 0.5)
        self.beacon_interval = float(beacon_interval)
        self._takeover_grace = takeover_grace
        # Fencing epoch: 0 until this incarnation claims a journal dir; see
        # reservation.Server — same protocol, same standby module.
        self.fencing_epoch = 0
        self.superseded_by = None
        self.journal_records = 0
        self._beacon_last = 0.0
        self._fence_grace_until = 0.0
        if journal_dir is None:
            journal_dir = os.environ.get("TFOS_DS_JOURNAL_DIR") or None
        self.journal_dir = journal_dir
        if snapshot_every is None:
            snapshot_every = _env_int("TFOS_DS_SNAPSHOT_EVERY", 512)
        self.snapshot_every = max(int(snapshot_every), 1)
        # Compaction policy: keep the newest ``journal_keep`` generations
        # (snapshot + its segment; the historic hardcoded default was 2),
        # or — when ``journal_keep_bytes`` is set — as many newest
        # generations as fit the byte budget (week-long shared jobs want
        # "a disk budget", not "a count"; the newest generation is always
        # kept regardless).
        if journal_keep is None:
            journal_keep = _env_int("TFOS_DS_JOURNAL_KEEP", 2)
        self.journal_keep = max(int(journal_keep), 1)
        if journal_keep_bytes is None:
            journal_keep_bytes = _env_int("TFOS_DS_JOURNAL_KEEP_BYTES", 0)
        self.journal_keep_bytes = max(int(journal_keep_bytes), 0)
        if affinity is None:
            affinity = _env_flag("TFOS_DS_AFFINITY", True)
        self.affinity = bool(affinity)
        self._jobs = {}      # name -> _Job
        self._workers = {}   # worker_id -> {"worker_id","host","port"}
        self._beats = {}     # worker_id -> last beat (monotonic)
        self._dead = {}      # worker_id -> death description
        self._worker_metrics = {}  # worker_id -> latest HBEAT counters
        self._worker_cache = {}    # worker_id -> cached source-path set
        self._consumer_seen = {}   # (job, consumer) -> last contact
        # Live-knob fan-out to workers: the driver-side autopilot can't
        # reach FeedWorkers directly (they beat HERE, not to the
        # reservation server), so a KNOB message queues updates that ride
        # out on worker HBEAT replies exactly-once (the same coordinator
        # the reservation server uses for training nodes).
        self.knobs = KnobCoordinator()
        self._journal_file = None
        self._journal_seq = 0
        self._journal_count = 0
        self.recovered_jobs = 0    # jobs rebuilt from the journal at start
        self._lock = threading.RLock()
        self._stopping = False
        self._socket = None
        self._thread = None

    # -- snapshots (any thread) -------------------------------------------

    def workers(self):
        """Live worker roster: ``{worker_id: {worker_id, host, port}}``."""
        with self._lock:
            return {w: dict(meta) for w, meta in self._workers.items()}

    def dead_workers(self):
        """Fenced-worker descriptions keyed by worker id."""
        with self._lock:
            return dict(self._dead)

    def worker_metrics(self):
        """Latest per-worker HBEAT counters plus a merged aggregate.

        Returns ``{"workers": {worker_id: counters}, "aggregate": counters}``
        where the aggregate follows :func:`telemetry.merge_counters`
        semantics (``_hwm``/``_max`` keys merge by max, the rest sum)."""
        with self._lock:
            per = {w: dict(c) for w, c in self._worker_metrics.items()}
        return {"workers": per,
                "aggregate": telemetry.merge_counters(per.values())}

    def job_status(self, name):
        """Ledger snapshot for one job (``None`` if unknown)."""
        with self._lock:
            job = self._jobs.get(name)
            return job.status() if job is not None else None

    # -- fencing epoch + reply stamping (see reservation.Server) -----------

    def send(self, sock, msg):
        # Stamped under "fence_epoch", NOT "epoch": TASK replies already
        # carry the job's DATA epoch as "epoch", and a client reading a
        # fresh job's epoch 0 as a fencing epoch would refuse a healthy
        # dispatcher (DispatcherClient._fence_epoch_key matches this key).
        if self.fencing_epoch and isinstance(msg, dict):
            msg.setdefault("fence_epoch", self.fencing_epoch)
        MessageSocket.send(self, sock, msg)

    def _check_epoch(self):
        """Ledger-ownership check: a newer fencing epoch on disk means a
        successor (restart or promoted standby) claimed the journal — this
        incarnation fences itself and answers everything ERR."""
        if not self.journal_dir or self.superseded_by is not None:
            return
        on_disk = standby_mod.read_epoch(self.journal_dir)
        if on_disk > self.fencing_epoch:
            self.superseded_by = on_disk
            logger.error(
                "dispatcher fenced: epoch %d on disk supersedes this "
                "incarnation's epoch %d — a successor owns the ledger",
                on_disk, self.fencing_epoch)
            telemetry.get_tracer().instant(
                "dataservice/zombie_fenced", epoch=self.fencing_epoch,
                superseded_by=on_disk)
            if self._journal_file is not None:
                try:
                    self._journal_file.close()
                except OSError:
                    pass
                self._journal_file = None

    def _stamp_beacon(self, addr, force=False):
        if not self.journal_dir or self.superseded_by is not None:
            return
        now = time.monotonic()
        if not force and now - self._beacon_last < self.beacon_interval:
            return
        self._beacon_last = now
        self._check_epoch()
        if self.superseded_by is None:
            standby_mod.write_beacon(self.journal_dir, self.fencing_epoch,
                                     host=addr[0], port=addr[1],
                                     role="dispatcher")

    def ha_status(self):
        """Coordinator-HA block for ``/status`` + ``tfos_coordinator_*``."""
        return {
            "journal_dir": self.journal_dir,
            "epoch": self.fencing_epoch,
            "superseded_by": self.superseded_by,
            "recovered_nodes": self.recovered_jobs,
            "recoveries": 1 if self.recovered_jobs else 0,
            "journal_records": self.journal_records,
            "snapshot_seq": self._journal_seq,
            "grace_remaining_secs": round(
                max(0.0, self._fence_grace_until - time.monotonic()), 3),
        }

    # -- journal (caller holds the lock) -----------------------------------

    def _segment_path(self, kind, seq):
        ext = "jsonl" if kind == "journal" else "json"
        return os.path.join(self.journal_dir,
                            "{}-{:08d}.{}".format(kind, seq, ext))

    def _journal(self, rec):
        """Append one ledger-mutation record; flush-per-record so a SIGKILL
        loses at most the record being written (a torn tail line, skipped
        on replay).  A journal write failure degrades to in-memory-only
        operation with a loud log — availability over durability."""
        if self._journal_file is None:
            return
        self._check_epoch()  # never append past a successor's claim
        if self._journal_file is None:
            return
        try:
            self._journal_file.write(json.dumps(rec, sort_keys=True) + "\n")
            self._journal_file.flush()
        except (OSError, ValueError) as e:
            logger.error("dataservice journal: write failed (%s); ledger "
                         "durability is LOST until restart", e)
            try:
                self._journal_file.close()
            except OSError:
                pass
            self._journal_file = None
            return
        self.journal_records += 1
        self._journal_count += 1
        if self._journal_count >= self.snapshot_every:
            self._write_snapshot()

    def _write_snapshot(self):
        """Full-state snapshot (atomic tmp+rename) + fresh journal segment;
        segments older than the previous generation are pruned."""
        self._journal_seq += 1
        seq = self._journal_seq
        state = {"seq": seq,
                 "jobs": {n: j.to_state() for n, j in self._jobs.items()},
                 "dead_workers": dict(self._dead)}
        path = self._segment_path("snapshot", seq)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(state, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            if self._journal_file is not None:
                self._journal_file.close()
            self._journal_file = open(self._segment_path("journal", seq), "a")
        except OSError as e:
            logger.error("dataservice journal: snapshot %d failed (%s)",
                         seq, e)
            self._journal_file = None
        self._journal_count = 0
        self._prune_segments(seq)

    def _gen_bytes(self, seq):
        """On-disk bytes of one generation (snapshot + journal segment)."""
        total = 0
        for kind in ("snapshot", "journal"):
            try:
                total += os.path.getsize(self._segment_path(kind, seq))
            except OSError:
                pass
        return total

    def _prune_segments(self, seq):
        """Apply the compaction policy after cutting generation ``seq``.

        Byte budget (``journal_keep_bytes`` > 0): keep the newest
        generations whose cumulative on-disk size fits the budget — the
        newest is always kept even when it alone overflows.  Otherwise:
        keep the newest ``journal_keep`` generations.  Everything older
        is unlinked."""
        if self.journal_keep_bytes:
            keep = {seq}
            total = self._gen_bytes(seq)
            for s in range(seq - 1, 0, -1):
                total += self._gen_bytes(s)
                if total > self.journal_keep_bytes:
                    break
                keep.add(s)
            oldest_kept = min(keep)
        else:
            oldest_kept = seq - self.journal_keep + 1
        for old in range(1, oldest_kept):
            for kind in ("snapshot", "journal"):
                try:
                    os.unlink(self._segment_path(kind, old))
                except OSError:
                    pass

    def _replay(self, rec):
        """Apply one journal record to the ledger (same mutation paths as
        the live handlers, so replay and live execution cannot diverge)."""
        t = rec.get("t")
        if t == "job":
            if rec["job"] not in self._jobs:
                self._jobs[rec["job"]] = _Job(
                    rec["job"], rec["splits"], rec["num_epochs"], rec["mode"])
            return
        if t == "fence":
            self._dead[rec["worker"]] = rec.get(
                "why", "fenced before a dispatcher restart")
            return
        job = self._jobs.get(rec.get("job"))
        if job is None:
            return
        if t == "attach":
            job.attach(rec["consumer"])
        elif t == "detach":
            job.detach(rec["consumer"], fence=bool(rec.get("fence")))
        elif t in ("assign", "repool"):
            s = int(rec["split"])
            if (int(rec.get("epoch", 0)) == job.epoch
                    and not job.done and s not in job.completed):
                # the stream (if any) died with the old dispatcher's
                # workers: recover the binding as consumer-bound pending
                job.assigned.pop(s, None)
                job._unbind(s)
                job.pending.setdefault(rec["consumer"], []).append(s)
        elif t == "done":
            job.complete(int(rec.get("epoch", 0)), int(rec["split"]),
                         rec.get("consumer"))
        elif t == "split_err":
            job.record_split_error(
                int(rec.get("epoch", 0)), int(rec["split"]),
                rec.get("worker"), rec.get("consumer"),
                rec.get("error") or "reader failure")

    def _recover(self):
        """Rebuild the ledger from the newest snapshot + its journal
        segment, then re-pool every recovered in-flight assignment (those
        workers' streams are gone) and cut a fresh snapshot so the next
        restart replays from here."""
        os.makedirs(self.journal_dir, exist_ok=True)
        seqs = []
        for name in os.listdir(self.journal_dir):
            if name.startswith("snapshot-") and name.endswith(".json"):
                try:
                    seqs.append(int(name[len("snapshot-"):-len(".json")]))
                except ValueError:
                    pass
        seq = max(seqs) if seqs else 0
        if seq:
            try:
                with open(self._segment_path("snapshot", seq)) as f:
                    state = json.load(f)
                self._jobs = {n: _Job.from_state(s)
                              for n, s in state.get("jobs", {}).items()}
                self._dead.update(state.get("dead_workers") or {})
                self._journal_seq = int(state.get("seq", seq))
            except (OSError, ValueError, KeyError) as e:
                logger.error("dataservice journal: snapshot %d unreadable "
                             "(%s); replaying the journal from scratch",
                             seq, e)
                self._jobs, self._journal_seq = {}, seq
        replayed = 0
        for jseq in sorted(s for s in self._list_segments() if s >= seq):
            try:
                with open(self._segment_path("journal", jseq)) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            break  # torn tail record from the SIGKILL
                        self._replay(rec)
                        replayed += 1
            except OSError:
                continue
        for job in self._jobs.values():
            for s, (w, c) in list(job.assigned.items()):
                del job.assigned[s]
                if s not in job.completed:
                    job._unbind(s)
                    job.pending.setdefault(c, []).append(s)
        # arm consumer liveness for every recovered consumer: one that died
        # while the dispatcher was down never makes contact again and must
        # be fenced by silence like any other
        now = time.monotonic()
        for job in self._jobs.values():
            if job.done or job.mode == SHARD_OFF:
                continue
            for c in job.consumers:
                self._consumer_seen[(job.name, c)] = now
        self.recovered_jobs = len(self._jobs)
        if self.recovered_jobs:
            # Fence-free grace while recovered workers and consumers
            # re-home to this incarnation; a fresh (journal-less history)
            # dispatcher sets none, so first starts behave exactly as
            # before.
            grace = self._takeover_grace
            if grace is None:
                grace = max(
                    self.heartbeat_interval * self.heartbeat_misses, 2.0)
            self._fence_grace_until = now + grace
        if self._jobs or replayed or seq:
            logger.warning(
                "dataservice dispatcher: recovered %d job(s) from %s "
                "(snapshot %d + %d journal record(s))",
                len(self._jobs), self.journal_dir, seq, replayed)
            telemetry.get_tracer().instant(
                "dataservice/dispatcher_recover", jobs=len(self._jobs),
                records=replayed)
        self._write_snapshot()

    def _list_segments(self):
        out = []
        for name in os.listdir(self.journal_dir):
            if name.startswith("journal-") and name.endswith(".jsonl"):
                try:
                    out.append(int(name[len("journal-"):-len(".jsonl")]))
                except ValueError:
                    pass
        return out

    # -- ledger mutation (listener thread, under lock) ---------------------

    def _register_worker(self, meta):
        worker_id = meta.get("worker_id")
        if not worker_id or "host" not in meta or "port" not in meta:
            return "worker registration needs worker_id, host, port"
        if worker_id in self._dead:
            return ("worker {} was fenced by the liveness monitor; a "
                    "replacement must register with a fresh identity"
                    .format(worker_id))
        if worker_id in self._workers:
            return "duplicate worker id {}".format(worker_id)
        self._workers[worker_id] = {"worker_id": worker_id,
                                    "host": meta["host"],
                                    "port": int(meta["port"])}
        self._beats[worker_id] = time.monotonic()
        cached = meta.get("cache_splits")
        if cached is not None:
            self._worker_cache[worker_id] = set(cached)
        telemetry.get_tracer().instant(
            "dataservice/worker_register", worker_id=worker_id,
            workers=len(self._workers))
        return None

    def _release_worker(self, worker_id, why):
        """Drop a worker from the roster and re-pool its splits."""
        self._workers.pop(worker_id, None)
        self._beats.pop(worker_id, None)
        self._worker_cache.pop(worker_id, None)
        live = list(self._workers)
        moved = 0
        for job in self._jobs.values():
            repooled = job.release_worker(worker_id, live)
            for split, consumer in repooled:
                self._journal({"t": "repool", "job": job.name,
                               "epoch": job.epoch, "split": split,
                               "consumer": consumer})
            moved += len(repooled)
        if moved:
            logger.warning("dataservice: re-pooled %d split(s) from worker "
                           "%s (%s)", moved, worker_id, why)
            telemetry.get_tracer().instant(
                "dataservice/split_reassign", worker_id=worker_id,
                splits=moved, why=why)

    def _check_liveness(self):
        if not self.heartbeat_interval:
            return
        now = time.monotonic()
        if now < self._fence_grace_until:
            # Post-takeover grace: recovered workers/consumers were beating
            # at the dead predecessor; their silence is our history, not a
            # death — let them re-home before fencing anyone.
            return
        deadline = self.heartbeat_interval * self.heartbeat_misses
        with self._lock:
            for worker_id, last in list(self._beats.items()):
                age = now - last
                if age > deadline and worker_id in self._workers:
                    desc = ("feed worker {} missed {} heartbeats (last beat "
                            "{:.1f}s ago, interval {:.1f}s)").format(
                                worker_id, self.heartbeat_misses, age,
                                self.heartbeat_interval)
                    logger.error("dataservice liveness: %s", desc)
                    self._dead[worker_id] = desc
                    self._journal({"t": "fence", "worker": worker_id,
                                   "why": desc})
                    telemetry.get_tracer().instant(
                        "dataservice/worker_dead", worker_id=worker_id,
                        age_secs=round(age, 3))
                    self._release_worker(worker_id, "dead")
            # consumer liveness: any JOB/TASK/DONE/LOST/STATUS contact
            # naming a consumer refreshes it; silence past the worker
            # deadline fences the consumer and rebinds its splits to the
            # survivors (or back to the pool) so a shared job never wedges
            # on a crashed run
            for key, last in list(self._consumer_seen.items()):
                if now - last <= deadline:
                    continue
                del self._consumer_seen[key]
                jobname, consumer = key
                job = self._jobs.get(jobname)
                if (job is None or job.done or job.error is not None
                        or job.mode == SHARD_OFF
                        or consumer not in job.consumers):
                    continue
                moved = job.detach(consumer, fence=True)
                self._journal({"t": "detach", "job": jobname,
                               "consumer": consumer, "fence": True})
                logger.error(
                    "dataservice liveness: consumer %s of job %r went "
                    "silent; fenced, %d split(s) rebound", consumer,
                    jobname, moved)
                telemetry.get_tracer().instant(
                    "dataservice/consumer_dead", job=jobname,
                    consumer=consumer, splits=moved)

    def _touch_consumer(self, job, consumer_id):
        """Record consumer contact (liveness only applies to ledger modes;
        OFF-mode jobs have no per-consumer bindings to rebind)."""
        if job is not None and consumer_id and job.mode != SHARD_OFF:
            self._consumer_seen[(job.name, consumer_id)] = time.monotonic()

    def _handle_job(self, sock, data):
        """Attach-or-create job registration.

        ``attach`` in the request is ``"auto"`` (create the job if absent,
        attach otherwise — the shared-job default), ``"create"`` (refuse an
        existing job) or ``"attach"`` (refuse a missing one; ``splits`` may
        be omitted and the reply's ``spec`` adopted).  An existing job with
        an incompatible spec is always an error; so is attaching to a
        finished/failed job or with a fenced consumer id."""
        name = data.get("name")
        consumer = data.get("consumer_id")
        attach_mode = data.get("attach", "auto")
        job = self._jobs.get(name)
        spec = None
        if data.get("splits") is not None:
            spec = {"splits": list(data.get("splits") or []),
                    "num_epochs": int(data.get("num_epochs", 1)),
                    "mode": data.get("mode", SHARD_DYNAMIC)}
            if spec["mode"] not in _MODES:
                self.send(sock, {"type": "ERR",
                                 "error": "unknown sharding mode {!r}"
                                          .format(spec["mode"])})
                return
        if job is not None and consumer in job.fenced_consumers:
            self.send(sock, {"type": "ERR",
                             "error": "consumer {} of job {!r} was fenced "
                                      "by the liveness monitor; a new run "
                                      "must attach with a fresh identity"
                                      .format(consumer, name)})
            return
        if job is None:
            if attach_mode == "attach":
                self.send(sock, {"type": "ERR",
                                 "error": "job {!r} does not exist: nothing "
                                          "to attach to".format(name)})
                return
            if spec is None:
                self.send(sock, {"type": "ERR",
                                 "error": "job {!r} needs splits to be "
                                          "created".format(name)})
                return
            job = _Job(name, spec["splits"], spec["num_epochs"],
                       spec["mode"])
            self._jobs[name] = job
            self._journal({"t": "job", "job": name, "splits": spec["splits"],
                           "num_epochs": spec["num_epochs"],
                           "mode": spec["mode"]})
            telemetry.get_tracer().instant(
                "dataservice/job", job=name, mode=spec["mode"],
                splits=len(spec["splits"]), num_epochs=spec["num_epochs"])
            created = True
        else:
            if attach_mode == "create":
                self.send(sock, {"type": "ERR",
                                 "error": "job {!r} already exists "
                                          "(attach=False)".format(name)})
                return
            if spec is not None and job.spec() != spec:
                self.send(sock, {"type": "ERR",
                                 "error": "job {!r} already exists with a "
                                          "different spec".format(name)})
                return
            if job.error is not None:
                self.send(sock, {"type": "ERR",
                                 "error": "job {!r} failed: {}".format(
                                     name, job.error)})
                return
            created = False
        if job.attach(consumer):
            self._journal({"t": "attach", "job": name, "consumer": consumer})
            telemetry.get_tracer().instant(
                "dataservice/consumer_attach", job=name, consumer=consumer,
                consumers=len(job.consumers))
        self._touch_consumer(job, consumer)
        reply = dict(job.spec())
        self.send(sock, {"type": "OK", "created": created,
                         "spec": reply, "epoch": job.epoch,
                         "done": job.done,
                         "consumers": len(job.consumers)})

    def _handle_message(self, sock, msg):
        mtype = msg.get("type")
        data = msg.get("data") or {}
        with self._lock:
            if mtype in ("WREG", "HBEAT", "BYE", "JOB", "DETACH", "TASK",
                         "DONE", "LOST", "KNOB"):
                # Mutating request: re-verify ledger ownership FIRST so a
                # zombie dispatcher never mutates state its successor
                # doesn't have (and never replies OK for it).
                self._check_epoch()
            if self.superseded_by is not None:
                self.send(sock, {
                    "type": "ERR", "fence_epoch": self.superseded_by,
                    "superseded": self.superseded_by,
                    "error": "dispatcher superseded: epoch {} claimed the "
                             "ledger (this incarnation was epoch {}); "
                             "redial the promoted dispatcher".format(
                                 self.superseded_by, self.fencing_epoch)})
                return True
            if mtype == "WREG":
                err = self._register_worker(data)
                if err:
                    logger.warning("rejecting worker registration: %s", err)
                    self.send(sock, {"type": "ERR", "error": err})
                else:
                    self.send(sock, {"type": "OK"})
            elif mtype == "HBEAT":
                worker_id = data.get("executor_id")
                if worker_id in self._dead:
                    self.send(sock, {"type": "ERR",
                                     "error": "marked dead by the liveness "
                                              "monitor"})
                else:
                    # beats from ids we never saw register are tracked too
                    # (mirrors reservation.Server._beat)
                    reply = {"type": "OK"}
                    if worker_id is not None:
                        self._beats[worker_id] = time.monotonic()
                        beat_metrics = data.get("metrics")
                        if isinstance(beat_metrics, dict):
                            # the cache advertisement rides the metrics dict
                            # but is a path list, not a counter: strip it
                            # before the merge-by-sum vocabulary sees it
                            paths = beat_metrics.pop("cache_paths", None)
                            if paths is not None:
                                self._worker_cache[worker_id] = set(paths)
                            self._worker_metrics.setdefault(
                                worker_id, {}).update(beat_metrics)
                        if worker_id not in self._workers:
                            # a restarted dispatcher has never seen this
                            # worker: tell it to re-register (WREG) so it
                            # re-enters the roster with its data address
                            reply["reregister"] = True
                        # live-knob fan-out: pending KNOB pushes ride the
                        # beat reply exactly-once per worker
                        try:
                            pending = self.knobs.poll(worker_id)
                        except Exception:
                            logger.exception("worker knob poll failed")
                            pending = None
                        if pending:
                            reply["knobs"] = pending
                    self.send(sock, reply)
            elif mtype == "BYE":
                worker_id = data.get("executor_id")
                if worker_id is not None and worker_id in self._workers:
                    self._release_worker(worker_id, "bye")
                self.send(sock, {"type": "OK"})
            elif mtype == "JOB":
                self._handle_job(sock, data)
            elif mtype == "DETACH":
                job = self._jobs.get(data.get("job"))
                consumer = data.get("consumer_id")
                if job is None or not consumer:
                    self.send(sock, {"type": "OK", "stale": True})
                elif consumer not in job.consumers:
                    # duplicate departure (or a never-attached name): stale,
                    # not an error — DETACH is the best-effort exit path
                    self._consumer_seen.pop((job.name, consumer), None)
                    self.send(sock, {"type": "OK", "stale": True})
                else:
                    moved = job.detach(consumer)
                    self._journal({"t": "detach", "job": job.name,
                                   "consumer": consumer})
                    telemetry.get_tracer().instant(
                        "dataservice/consumer_detach", job=job.name,
                        consumer=consumer, splits=moved)
                    self._consumer_seen.pop((job.name, consumer), None)
                    self.send(sock, {"type": "OK", "moved": moved})
            elif mtype == "WORKERS":
                self.send(sock, {"type": "WORKERS",
                                 "data": sorted(self._workers.values(),
                                                key=lambda m: m["worker_id"])})
            elif mtype == "KNOB":
                # queue a {knob: value} update for the worker fleet (or one
                # worker_id); delivery rides the next HBEAT replies.  Sent
                # by ServiceFeed.apply_knob relaying autopilot pushes.
                knobs = data.get("knobs")
                if not isinstance(knobs, dict) or not knobs:
                    self.send(sock, {"type": "ERR",
                                     "error": "KNOB without a knobs dict"})
                else:
                    seq = self.knobs.push(knobs,
                                          executor_id=data.get("worker_id"))
                    telemetry.get_tracer().instant(
                        "dataservice/knob", knobs=",".join(sorted(knobs)),
                        seq=seq)
                    self.send(sock, {"type": "OK", "seq": seq})
            elif mtype == "TASK":
                job = self._jobs.get(data.get("job"))
                worker_id = data.get("worker_id")
                consumer_id = data.get("consumer_id")
                if job is None:
                    self.send(sock, {"type": "ERR",
                                     "error": "unknown job {!r}"
                                              .format(data.get("job"))})
                elif worker_id in self._dead:
                    # a fenced-but-alive zombie must stop serving: its
                    # splits were re-pooled, streaming on would only feed
                    # the consumer-side dedupe
                    self.send(sock, {"type": "ERR",
                                     "error": "marked dead by the liveness "
                                              "monitor"})
                elif consumer_id in job.fenced_consumers:
                    self.send(sock, {"type": "ERR",
                                     "error": "consumer {} of job {!r} was "
                                              "fenced by the liveness "
                                              "monitor".format(
                                                  consumer_id, job.name)})
                elif job.error is not None:
                    self.send(sock, {"type": "ERR",
                                     "error": "job {!r} failed: {}".format(
                                         job.name, job.error)})
                else:
                    self._touch_consumer(job, consumer_id)
                    ans = job.next_splits(worker_id, consumer_id,
                                          list(self._workers),
                                          worker_caches=self._worker_cache,
                                          affinity=self.affinity)
                    ans["type"] = "TASK"
                    if ans.get("splits") and job.mode != SHARD_OFF:
                        for s, _path in ans["splits"]:
                            self._journal({"t": "assign", "job": job.name,
                                           "epoch": job.epoch, "split": s,
                                           "worker": worker_id,
                                           "consumer": consumer_id})
                    if ans.get("splits"):
                        # Trace flow: a fresh id rides the assignment to the
                        # worker, the stream frames, and the consumer commit,
                        # so Perfetto links assignment -> serve -> commit ->
                        # infeed -> dispatch causally across processes.
                        tracer = telemetry.get_tracer()
                        fid = tracer.new_flow_id()
                        if fid:
                            ans["flow"] = fid
                            tracer.flow_start(
                                "dataservice/split_flow", fid,
                                job=job.name, worker_id=worker_id,
                                splits=list(ans["splits"]),
                                epoch=ans.get("epoch"))
                    self.send(sock, ans)
            elif mtype == "LOST":
                job = self._jobs.get(data.get("job"))
                if job is None:
                    self.send(sock, {"type": "ERR",
                                     "error": "unknown job {!r}"
                                              .format(data.get("job"))})
                else:
                    self._touch_consumer(job, data.get("consumer_id"))
                    ans = job.release_split(int(data.get("epoch", 0)),
                                            int(data.get("split", -1)),
                                            data.get("worker_id"),
                                            data.get("consumer_id"))
                    if not ans.get("stale"):
                        self._journal({"t": "repool", "job": job.name,
                                       "epoch": int(data.get("epoch", 0)),
                                       "split": int(data.get("split", -1)),
                                       "consumer": data.get("consumer_id")})
                        logger.warning(
                            "dataservice: split %s of job %r re-pooled "
                            "after a broken stream to worker %s",
                            data.get("split"), job.name,
                            data.get("worker_id"))
                        telemetry.get_tracer().instant(
                            "dataservice/split_lost", job=job.name,
                            split=int(data.get("split", -1)),
                            worker_id=data.get("worker_id"))
                    ans["type"] = "OK"
                    self.send(sock, ans)
            elif mtype == "SPLIT_ERR":
                job = self._jobs.get(data.get("job"))
                if job is None:
                    self.send(sock, {"type": "ERR",
                                     "error": "unknown job {!r}"
                                              .format(data.get("job"))})
                else:
                    ans = job.record_split_error(
                        int(data.get("epoch", 0)),
                        int(data.get("split", -1)),
                        data.get("worker_id"), data.get("consumer_id"),
                        data.get("error") or "reader failure")
                    if not ans.get("stale"):
                        self._journal({
                            "t": "split_err", "job": job.name,
                            "epoch": int(data.get("epoch", 0)),
                            "split": int(data.get("split", -1)),
                            "worker": data.get("worker_id"),
                            "consumer": data.get("consumer_id"),
                            "error": data.get("error") or "reader failure"})
                    if ans.get("failed"):
                        logger.error("dataservice: job %r failed: %s",
                                     job.name, job.error)
                        telemetry.get_tracer().instant(
                            "dataservice/job_failed", job=job.name,
                            error=job.error)
                    ans["type"] = "OK"
                    self.send(sock, ans)
            elif mtype == "DONE":
                job = self._jobs.get(data.get("job"))
                if job is None:
                    self.send(sock, {"type": "ERR",
                                     "error": "unknown job {!r}"
                                              .format(data.get("job"))})
                elif data.get("consumer_id") in job.fenced_consumers:
                    # the fresh-identity rule for consumers: a fenced-but-
                    # alive run's parked DONEs must not land after its
                    # splits were rebound (the co-consumer republish race)
                    self.send(sock, {"type": "ERR",
                                     "error": "consumer {} of job {!r} was "
                                              "fenced by the liveness "
                                              "monitor".format(
                                                  data.get("consumer_id"),
                                                  job.name)})
                else:
                    self._touch_consumer(job, data.get("consumer_id"))
                    ans = job.complete(int(data.get("epoch", 0)),
                                       int(data.get("split", -1)),
                                       data.get("consumer_id"))
                    if not (ans.get("stale") or ans.get("duplicate")):
                        self._journal({"t": "done", "job": job.name,
                                       "epoch": int(data.get("epoch", 0)),
                                       "split": int(data.get("split", -1)),
                                       "consumer": data.get("consumer_id")})
                    if job.done:
                        telemetry.get_tracer().instant(
                            "dataservice/job_done", job=job.name)
                    ans["type"] = "OK"
                    self.send(sock, ans)
            elif mtype == "STATUS":
                job = self._jobs.get(data.get("job"))
                if job is None:
                    self.send(sock, {"type": "ERR",
                                     "error": "unknown job {!r}"
                                              .format(data.get("job"))})
                elif data.get("consumer_id") in job.fenced_consumers:
                    self.send(sock, {"type": "ERR",
                                     "error": "consumer {} of job {!r} was "
                                              "fenced by the liveness "
                                              "monitor".format(
                                                  data.get("consumer_id"),
                                                  job.name)})
                else:
                    self._touch_consumer(job, data.get("consumer_id"))
                    status = job.status()
                    status["workers"] = len(self._workers)
                    status["dead_workers"] = len(self._dead)
                    self.send(sock, {"type": "STATUS", "data": status})
            elif mtype == "STOP":
                self.send(sock, {"type": "OK"})
                self._stopping = True
            else:
                logger.warning("dataservice: ignoring unknown message %r",
                               mtype)
                self.send(sock, {"type": "ERR",
                                 "error": "unknown message type"})
        return True

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Bind, recover the ledger from the journal (when armed), spawn
        the daemon listener thread, return ``(host, port)``."""
        self._socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._socket.bind(("", self._port))
        self._socket.listen(64)
        if self.journal_dir:
            with self._lock:
                # Claim the ledger BEFORE recovering: the epoch bump fences
                # any prior incarnation (restart-in-place or the primary a
                # standby is superseding) out of the journal.
                self.fencing_epoch = standby_mod.advance_epoch(
                    self.journal_dir)
                self._recover()
        host = self._host
        if not host:
            from tensorflowonspark_torch import util

            host = util.get_ip_address()
        addr = (host, self._socket.getsockname()[1])
        if self.journal_dir:
            self._stamp_beacon(addr, force=True)

        def _listen():
            conns = [self._socket]
            while not self._stopping:
                try:
                    readable, _, _ = select.select(conns, [], [], 0.1)
                except (OSError, ValueError):
                    break  # listen socket closed by stop()
                for sock in readable:
                    if sock is self._socket:
                        try:
                            client, _ = sock.accept()
                        except OSError:
                            continue
                        conns.append(client)
                        continue
                    try:
                        keep = self._handle_message(sock, self.receive(sock))
                    except (EOFError, OSError, ValueError):
                        keep = False
                    if not keep:
                        conns.remove(sock)
                        sock.close()
                self._check_liveness()
                self._stamp_beacon(addr)
            for sock in conns:
                try:
                    sock.close()
                except OSError:
                    pass

        self._thread = threading.Thread(target=_listen,
                                        name="dataservice-dispatcher",
                                        daemon=True)
        self._thread.start()
        logger.info("dataservice dispatcher listening on %s:%d",
                    addr[0], addr[1])
        return addr

    def stop(self):
        self._stopping = True
        if self._socket is not None:
            # shutdown() before close(): the listener's select() holds a
            # kernel reference to the listen socket, and a bare close()
            # leaves the port accepting-then-resetting for up to one poll
            # timeout — a failing-over client would waste a dial on it.
            try:
                self._socket.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._socket.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        with self._lock:
            if self._journal_file is not None:
                try:
                    self._journal_file.close()
                except OSError:
                    pass
                self._journal_file = None


# ---------------------------------------------------------------------------
# DispatcherClient
# ---------------------------------------------------------------------------

class DispatcherClient(Client):
    """Typed request helpers over the rendezvous ``Client`` transport
    (connect retries, finite request timeouts, ``HBEAT``/``BYE`` reuse)."""

    # The dispatcher protocol uses "epoch" for the job DATA epoch, so its
    # fencing epoch rides a separate key (see DispatcherServer.send).
    _fence_epoch_key = "fence_epoch"

    def _call(self, mtype, data=None):
        resp = self._request({"type": mtype, "data": data or {}})
        if resp.get("type") == "ERR":
            raise DispatchError(resp.get("error", "dispatcher error"))
        return resp

    def register_worker(self, worker_id, host, port, cache_splits=None):
        data = {"worker_id": worker_id, "host": host, "port": int(port)}
        if cache_splits is not None:
            # the affinity advertisement: source paths this worker's chunk
            # cache can replay (kept fresh by the heartbeat metrics)
            data["cache_splits"] = list(cache_splits)
        self._call("WREG", data)

    def register_job(self, name, splits=None, num_epochs=1,
                     mode=SHARD_DYNAMIC, consumer_id=None, attach="auto"):
        """Attach-or-create a dataset job.

        ``attach="auto"`` (default) creates the job when absent and
        attaches to it otherwise; ``attach=False`` refuses an existing
        job; ``attach=True`` refuses a missing one — and then ``splits``
        may be ``None``, adopting the live job's spec from the reply.
        Returns the dispatcher's answer:
        ``{"created", "spec", "epoch", "done", "consumers"}``.  An
        existing job with an incompatible spec (different splits, epochs
        or mode) raises :class:`DispatchError`."""
        data = {"name": name, "num_epochs": num_epochs, "mode": mode,
                "attach": {True: "attach", False: "create"}.get(
                    attach, "auto")}
        if splits is not None:
            data["splits"] = list(splits)
        if consumer_id:
            data["consumer_id"] = consumer_id
        resp = self._call("JOB", data)
        return {k: resp.get(k)
                for k in ("created", "spec", "epoch", "done", "consumers")}

    def detach_job(self, name, consumer_id):
        """Detach a consumer: its bound splits rebind to the survivors."""
        return self._call("DETACH", {"job": name,
                                     "consumer_id": consumer_id})

    def push_knobs(self, knobs, worker_id=None):
        """Queue a live-knob ``{name: value}`` update for the worker fleet
        (or one ``worker_id``); delivery rides the workers' next heartbeat
        replies exactly-once (see docs/AUTOPILOT.md)."""
        data = {"knobs": dict(knobs)}
        if worker_id is not None:
            data["worker_id"] = worker_id
        return self._call("KNOB", data).get("seq")

    def workers(self):
        """Live worker roster as a list of ``{worker_id, host, port}``."""
        return self._call("WORKERS").get("data") or []

    def request_task(self, job, worker_id, consumer_id):
        return self._call("TASK", {"job": job, "worker_id": worker_id,
                                   "consumer_id": consumer_id})

    def done_split(self, job, epoch, split, consumer_id):
        return self._call("DONE", {"job": job, "epoch": epoch,
                                   "split": split,
                                   "consumer_id": consumer_id})

    def lost_split(self, job, epoch, split, worker_id, consumer_id):
        """Report a broken worker→consumer stream: the dispatcher re-pools
        the mid-flight split immediately (no fence wait)."""
        return self._call("LOST", {"job": job, "epoch": epoch,
                                   "split": split, "worker_id": worker_id,
                                   "consumer_id": consumer_id})

    def split_error(self, job, epoch, split, worker_id, consumer_id, error):
        """Report a worker-side reader fault on a split."""
        return self._call("SPLIT_ERR", {"job": job, "epoch": epoch,
                                        "split": split,
                                        "worker_id": worker_id,
                                        "consumer_id": consumer_id,
                                        "error": error})

    def status(self, job, consumer_id=None):
        data = {"job": job}
        if consumer_id:
            # names the caller so the dispatcher's consumer-liveness clock
            # refreshes on every poll (and a fenced consumer learns loudly)
            data["consumer_id"] = consumer_id
        return self._call("STATUS", data).get("data") or {}


def _default_retry_policy():
    # dial/registration races at service bring-up are connection-shaped and
    # resolve in well under a second on localhost
    return fault.RetryPolicy(max_attempts=4, initial_backoff=0.1,
                             max_backoff=1.0)


# ---------------------------------------------------------------------------
# Worker-side chunk cache
# ---------------------------------------------------------------------------

def _env_cache_bytes():
    raw = os.environ.get("TFOS_DS_CACHE_BYTES", "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring non-integer TFOS_DS_CACHE_BYTES=%r", raw)
        return None


# Spill-file frame record: kind (u8), item count (u32), payload length (u64).
_SPILL_REC = struct.Struct("<BIQ")


class _FrameCache(object):
    """Byte-budgeted LRU of serialized split streams (the tf.data-service
    paper's source cache, at the worker).

    The unit of caching is the exact ``(kind, payload, items)`` frame
    sequence a cold serve produced for one split — colv1 frames
    *post-compression*, pickle-fallback frames included — so an epoch ≥ 2
    (or post-re-pool) serve replays bytes without touching ``FileFeed``,
    the row decoder, or the wire codec.  Entries are keyed by the split's
    source identity ``(path, wire codec)``, which subsumes (job
    signature, split index): a worker's serialized frames depend only on
    the file's content and the negotiated codec, so two jobs over the
    same dataset share entries while different datasets never collide.
    Every lookup re-validates the source file's ``(size, mtime_ns)``
    captured when the cold read *started*; a touched/resized source drops
    the entry (tallied as an invalidation) and the split is re-decoded.

    Overflow: LRU over resident bytes.  With ``spill_dir`` set, evicted
    entries spill to disk under it (their own LRU, ``spill_budget``
    bytes, default 4× the memory budget) and a spill hit promotes the
    entry back to memory; without it they are dropped.  All bookkeeping
    sits behind one lock — serve streams are concurrent, frame lists are
    immutable once inserted.
    """

    def __init__(self, max_bytes, spill_dir=None, spill_budget=None):
        self.max_bytes = int(max_bytes)
        self.spill_dir = spill_dir
        self.spill_budget = (int(spill_budget) if spill_budget is not None
                             else 4 * self.max_bytes)
        self._entries = collections.OrderedDict()  # key -> entry (resident)
        self._spilled = collections.OrderedDict()  # key -> entry (on disk)
        self._resident = 0
        self._spilled_bytes = 0
        self._seq = 0
        self._lock = threading.Lock()
        # tallies (read cross-thread; see FeedWorker heartbeat metrics)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.spills = 0
        self.spill_hits = 0
        self.invalidations = 0
        self.uncacheable = 0
        self.bytes_served = 0
        self.spill_bytes = 0          # cumulative bytes written to spill
        self._unreported_spill = 0    # since the last take_spill_bytes()

    @staticmethod
    def signature(path):
        """``(size, mtime_ns)`` of the source file, or ``None`` when it
        cannot be stat'ed (synthetic reader paths): such entries skip
        freshness validation and rely on LRU turnover alone."""
        try:
            st = os.stat(path)
        except (OSError, TypeError, ValueError):
            return None
        return (st.st_size, getattr(st, "st_mtime_ns", st.st_mtime))

    # -- internal (caller holds the lock) ----------------------------------

    def _drop(self, key, entry):
        self._entries.pop(key, None)
        self._spilled.pop(key, None)
        if entry.get("frames") is not None:
            self._resident -= entry["nbytes"]
        spill = entry.get("spill")
        if spill:
            self._spilled_bytes -= entry["nbytes"]
            try:
                os.unlink(spill)
            except OSError:
                pass

    def _spill_entry(self, key, entry):
        """Move a resident entry to disk; False when spill is off/fails."""
        if (self.spill_dir is None
                or entry["nbytes"] > self.spill_budget):
            return False
        path = os.path.join(self.spill_dir,
                            "split-{:08d}.cache".format(self._seq))
        self._seq += 1
        try:
            os.makedirs(self.spill_dir, exist_ok=True)
            with open(path, "wb") as f:
                for kind, payload, items in entry["frames"]:
                    f.write(_SPILL_REC.pack(kind, items, len(payload)))
                    f.write(payload)
        except OSError as e:
            logger.warning("chunk cache: spill of %r failed (%s)",
                           entry["path"], e)
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        entry["frames"] = None
        entry["spill"] = path
        self._spilled[key] = entry
        self._spilled_bytes += entry["nbytes"]
        self.spill_bytes += entry["nbytes"]
        self._unreported_spill += entry["nbytes"]
        while self._spilled_bytes > self.spill_budget and self._spilled:
            old_key, old = self._spilled.popitem(last=False)
            self._drop(old_key, old)
        return True

    def _load_spill(self, entry):
        """Frames list read back from an entry's spill file, or ``None``."""
        try:
            with open(entry["spill"], "rb") as f:
                frames = []
                while True:
                    rec = f.read(_SPILL_REC.size)
                    if not rec:
                        return frames
                    kind, items, length = _SPILL_REC.unpack(rec)
                    payload = f.read(length)
                    if len(payload) != length:
                        raise OSError("truncated spill record")
                    frames.append((kind, payload, items))
        except OSError as e:
            logger.warning("chunk cache: spill read-back of %r failed (%s)",
                           entry["path"], e)
            return None

    def _evict_overflow(self):
        while self._resident > self.max_bytes and self._entries:
            key, entry = self._entries.popitem(last=False)
            self._resident -= entry["nbytes"]
            self.evictions += 1
            if self._spill_entry(key, entry):
                self.spills += 1

    def set_max_bytes(self, max_bytes):
        """Live budget retune (autopilot ``dataservice_cache_budget``
        knob): a raise takes effect on the next insert; a shrink evicts
        down to the new budget immediately (spilling per the usual rules).
        The spill budget keeps its 4× ratio unless it was set explicitly.
        """
        max_bytes = int(max_bytes)
        with self._lock:
            grew_spill = self.spill_budget == 4 * self.max_bytes
            self.max_bytes = max_bytes
            if grew_spill:
                self.spill_budget = 4 * max_bytes
            self._evict_overflow()

    # -- serve-thread API --------------------------------------------------

    def lookup(self, path, codec):
        """The cached frame list for ``(path, codec)``, or ``None`` (miss /
        stale / unreadable spill).  A hit refreshes LRU order; a spilled
        hit is promoted back to memory first."""
        key = (path, codec or "none")
        with self._lock:
            entry = self._entries.get(key) or self._spilled.get(key)
            if entry is None:
                self.misses += 1
                return None
            if (entry["sig"] is not None
                    and self.signature(path) != entry["sig"]):
                self._drop(key, entry)
                self.invalidations += 1
                self.misses += 1
                return None
            if entry["frames"] is None:
                frames = self._load_spill(entry)
                if frames is None:
                    self._drop(key, entry)
                    self.misses += 1
                    return None
                self.spill_hits += 1
                self._spilled.pop(key, None)
                self._spilled_bytes -= entry["nbytes"]
                try:
                    os.unlink(entry["spill"])
                except OSError:
                    pass
                entry["frames"], entry["spill"] = frames, None
                self._entries[key] = entry
                self._resident += entry["nbytes"]
            self._entries.move_to_end(key)
            self._evict_overflow()
            self.hits += 1
            self.bytes_served += entry["nbytes"]
            return entry["frames"]

    def put(self, path, codec, sig, frames):
        """Insert a completely-served split's frames (``sig`` captured
        before the cold read started).  Returns how many entries this
        insert pushed out of memory — the per-stream eviction delta the
        worker reports on ``split_end``."""
        nbytes = sum(len(p) for _, p, _ in frames)
        key = (path, codec or "none")
        with self._lock:
            old = self._entries.get(key) or self._spilled.get(key)
            if old is not None:
                self._drop(key, old)
            if nbytes > self.max_bytes:
                self.uncacheable += 1
                return 0
            before = self.evictions
            self._entries[key] = {"path": path, "sig": sig,
                                  "frames": list(frames), "nbytes": nbytes,
                                  "spill": None}
            self._resident += nbytes
            self._evict_overflow()
            return self.evictions - before

    # -- observability -----------------------------------------------------

    def resident_bytes(self):
        with self._lock:
            return self._resident

    def take_spill_bytes(self):
        """Spill bytes written since the last call (atomic take-and-reset;
        the per-stream delta a worker rides on ``split_end`` — conserved
        across concurrent serve streams)."""
        with self._lock:
            n, self._unreported_spill = self._unreported_spill, 0
            return n

    def cached_paths(self):
        """Source paths with a resident or spilled entry — the affinity
        advertisement this worker rides on WREG and every heartbeat."""
        with self._lock:
            paths = {k[0] for k in self._entries}
            paths.update(k[0] for k in self._spilled)
            return sorted(paths)

    def counters_flat(self):
        """The ``dataservice_cache_*`` heartbeat vocabulary (``_max``
        suffix = gauge, everything else cumulative counters)."""
        with self._lock:
            return {"dataservice_cache_hit": self.hits,
                    "dataservice_cache_miss": self.misses,
                    "dataservice_cache_bytes": self.bytes_served,
                    "dataservice_cache_evictions": self.evictions,
                    "dataservice_cache_spills": self.spills,
                    "dataservice_cache_spill_hits": self.spill_hits,
                    "dataservice_cache_spill_bytes": self.spill_bytes,
                    "dataservice_cache_invalidations": self.invalidations,
                    "dataservice_cache_resident_max": self._resident}


# ---------------------------------------------------------------------------
# FeedWorker
# ---------------------------------------------------------------------------

class FeedWorker(object):
    """One data-service worker: reads splits, streams framed blocks.

    Listens on ``(host, port)`` for consumer streams; each accepted stream
    sends a JSON hello ``{"job", "consumer"}`` and then receives splits as
    the worker wins them from the dispatcher (``TASK`` poll per stream).
    Rows come from a per-split :class:`~tensorflowonspark_torch.data.FileFeed`
    (or :class:`~tensorflowonspark_torch.data.ProcessPoolFeed` with
    ``use_process_pool=True``) built over ``row_reader``; blocks go out as
    colv1 frames when framable, pickled rows otherwise — exactly the
    ``node._ChunkPutter`` fallback rules, including the
    ``TFOS_WIRE_FORMAT=pickle`` A/B knob.

    Liveness: a ``HeartbeatSender`` pointed at the dispatcher (the
    ``HBEAT``/``BYE`` wire shapes are shared with the rendezvous) carrying
    the worker's cache/compression counters as its piggybacked metrics.
    Chaos: ``fault.FaultInjector`` hooks fire per block
    (``kill_after_items``) and per finished split (``kill_after_splits``)
    — on cached replays too, so chaos coverage survives the cache.

    ``cache_bytes`` arms the worker chunk cache (:class:`_FrameCache`):
    the serialized frames of each completely-served split are kept under
    a byte-budgeted LRU and replayed on later serves of the same source
    (epoch ≥ 2, or a re-pooled split landing back on this worker),
    skipping the reader and codec entirely.  ``None`` reads
    ``TFOS_DS_CACHE_BYTES``; 0/unset disables.  ``cache_spill_dir``
    additionally spills evicted entries to disk under the worker's work
    dir.
    """

    def __init__(self, dispatcher_addr, row_reader=None, host="127.0.0.1",
                 port=0, worker_id=None, heartbeat_interval=1.0,
                 use_process_pool=False, num_procs=2, retry_policy=None,
                 cache_bytes=None, cache_spill_dir=None,
                 advertise_cache=None):
        # Endpoint-list discovery: entry 0 the primary dispatcher, later
        # entries warm standbys at pinned ports; DispatcherClient redials
        # across the list, so a worker survives a dispatcher failover.
        self.dispatcher_endpoints = normalize_endpoints(dispatcher_addr)
        self.dispatcher_addr = self.dispatcher_endpoints[0]
        self.row_reader = row_reader
        self.host = host
        self.port = port
        self.worker_id = worker_id or "worker-{}-{}".format(
            socket.gethostname(), id(self) & 0xffffff)
        self.heartbeat_interval = heartbeat_interval
        self.use_process_pool = use_process_pool
        self.num_procs = num_procs
        self.retry_policy = retry_policy or _default_retry_policy()
        # telemetry/test tallies (plain ints; read cross-thread)
        self.splits_streamed = 0
        self.items_streamed = 0
        self.bytes_streamed = 0
        if cache_bytes is None:
            cache_bytes = _env_cache_bytes()
        self.chunk_cache = (_FrameCache(cache_bytes,
                                        spill_dir=cache_spill_dir)
                            if cache_bytes else None)
        if advertise_cache is None:
            advertise_cache = _env_flag("TFOS_DS_ADVERTISE", True)
        # the affinity advertisement only exists when there is a cache to
        # advertise; --no-cache-advertise is the scheduler A/B knob
        self.advertise_cache = bool(advertise_cache) and (
            self.chunk_cache is not None)
        self._last_rereg = 0.0
        # producer-side wire-compression accounting, incremented in place
        # by wire.frame_bytes (raw_bytes / wire_bytes / cols_* / frames)
        self.compress_stats = {}
        self._framed = wire.enabled()
        self._injector = fault.from_env()
        self._stop = threading.Event()
        self._socket = None
        self._heartbeat = None
        self._accept_thread = None
        self._conns = set()
        self._conns_lock = threading.Lock()
        # (job, consumer) -> (conn, done event) of the stream serving it: a
        # consumer holds one stream per worker, so a second one supersedes
        # the first (see _supersede)
        self._serving = {}

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Bind the data port, register with the dispatcher, start
        heartbeating and accepting consumer streams.  Returns self."""
        self._socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._socket.bind((self.host, self.port))
        self._socket.listen(16)
        self.port = self._socket.getsockname()[1]

        def _register():
            client = DispatcherClient(self.dispatcher_endpoints)
            try:
                client.register_worker(
                    self.worker_id, self.host, self.port,
                    cache_splits=(self.chunk_cache.cached_paths()
                                  if self.advertise_cache else None))
            finally:
                client.close()

        self.retry_policy.call(_register)
        self._heartbeat = HeartbeatSender(
            self.dispatcher_endpoints, self.worker_id,
            self.heartbeat_interval,
            metrics_provider=self._heartbeat_metrics,
            on_reply=self._on_beat_reply).start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name="feedworker-accept-{}".format(self.worker_id), daemon=True)
        self._accept_thread.start()
        logger.info("feed worker %s serving on %s:%d", self.worker_id,
                    self.host, self.port)
        return self

    def stop(self, abrupt=False):
        """Shut down.  ``abrupt=True`` models a crash for tests: streams and
        heartbeats just stop (no ``BYE``), so the dispatcher must fence this
        worker by heartbeat timeout and re-pool its splits."""
        self._stop.set()
        if self._socket is not None:
            try:
                self._socket.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._heartbeat is not None:
            self._heartbeat.stop(goodbye=not abrupt)

    def _on_beat_reply(self, resp):
        """A heartbeat answer carrying ``reregister`` means the dispatcher
        restarted and has never seen this worker: re-send WREG (throttled
        to one attempt per heartbeat interval; best-effort — the next beat
        retries).  A ``knobs`` dict is a live-knob push relayed through
        the dispatcher (autopilot ``dataservice_cache_budget``): applied
        inline — a budget retune is a bounded eviction pass.  Runs on the
        heartbeat thread."""
        knobs = resp.get("knobs")
        if isinstance(knobs, dict):
            budget = knobs.get("dataservice_cache_budget")
            if budget is not None and self.chunk_cache is not None:
                try:
                    self.chunk_cache.set_max_bytes(budget)
                    logger.info("feed worker %s: cache budget retuned to "
                                "%d bytes", self.worker_id, int(budget))
                except Exception:
                    logger.warning("feed worker %s: cache budget knob "
                                   "failed", self.worker_id, exc_info=True)
        if not resp.get("reregister") or self._stop.is_set():
            return
        now = time.monotonic()
        if now - self._last_rereg < self.heartbeat_interval:
            return
        self._last_rereg = now
        try:
            client = DispatcherClient(self.dispatcher_endpoints, retries=0)
            try:
                client.register_worker(
                    self.worker_id, self.host, self.port,
                    cache_splits=(self.chunk_cache.cached_paths()
                                  if self.advertise_cache else None))
            finally:
                client.close()
            logger.info("feed worker %s: re-registered with a restarted "
                        "dispatcher", self.worker_id)
        except DispatchError as e:
            # e.g. a racing beat already re-registered us
            logger.debug("feed worker %s: re-registration refused (%s)",
                         self.worker_id, e)
        except Exception as e:
            logger.warning("feed worker %s: re-registration failed (%s)",
                           self.worker_id, e)

    # -- stream serving ----------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                readable, _, _ = select.select([self._socket], [], [], 0.2)
            except (OSError, ValueError):
                return
            if not readable:
                continue
            try:
                conn, _ = self._socket.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_stream, args=(conn,),
                             name="feedworker-stream-{}".format(
                                 self.worker_id),
                             daemon=True).start()

    def _supersede(self, served, conn, done):
        """Make ``conn`` the stream serving ``served`` = (job, consumer).
        A stream already serving it is one the consumer lost: cut it and
        wait until its thread has reported its in-flight split LOST, so
        that report lands before this stream wins any split (a late report
        would re-pool the split this stream was just handed again)."""
        with self._conns_lock:
            old = self._serving.get(served)
            self._serving[served] = (conn, done)
        if old is not None:
            try:
                old[0].shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            old[1].wait(timeout=_SUPERSEDE_WAIT_SECS)

    def _serve_stream(self, conn):
        client = None
        inflight = None   # (epoch, split) won but not yet ended on the wire
        served, done = None, threading.Event()
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            kind, payload = _recv_frame(conn)
            if kind != _K_JSON:
                raise DispatchError("stream hello must be a JSON frame")
            hello = json.loads(payload)
            job, consumer = hello["job"], hello["consumer"]
            # Dial-time codec negotiation: the consumer's hello offers its
            # codec names in preference order; the first one this worker
            # supports compresses every colv1 frame on this stream (column-
            # wise, pay-off sampled).  A hello without "codecs" — an older
            # consumer — gets raw frames, byte-identical to before.
            codec = wire.negotiate_codec(hello.get("codecs"))
            served = (job, consumer)
            self._supersede(served, conn, done)
            client = DispatcherClient(self.dispatcher_endpoints)
            while not self._stop.is_set():
                task = client.request_task(job, self.worker_id, consumer)
                if task.get("wait"):
                    time.sleep(0.05)
                    continue
                if task.get("done"):
                    _send_json(conn, {"type": "stream_end"})
                    break
                for _ in range(int(task.get("epochs", 1))):
                    for split, path in task["splits"]:
                        inflight = (int(task.get("epoch", 0)), split)
                        self._stream_split(conn, client, job, consumer,
                                           split, int(task.get("epoch", 0)),
                                           path, flow=task.get("flow"),
                                           codec=codec)
                        inflight = None
        except (EOFError, OSError) as e:
            logger.info("feed worker %s: stream closed (%s)",
                        self.worker_id, e)
            if inflight is not None:
                # The stream broke before this split's split_end went out.
                # A consumer that never saw its split_begin (the break fell
                # between two splits) has nothing to report LOST, and this
                # worker stays live, so no fence would ever re-pool it:
                # report it here.  LOST is idempotent and stale-safe (OFF
                # mode keeps no ledger and answers stale), so a consumer's
                # own report of the same split changes nothing.
                self._report_lost(job, inflight, consumer)
        except DispatchError as e:
            # fenced mid-serve, or the job vanished: end the stream; the
            # consumer's partial-split discard handles the rest
            logger.warning("feed worker %s: dispatcher refused (%s)",
                           self.worker_id, e)
        except Exception:
            if not self._stop.is_set():
                logger.exception("feed worker %s: stream failed",
                                 self.worker_id)
        finally:
            if client is not None:
                client.close()
            with self._conns_lock:
                self._conns.discard(conn)
                if self._serving.get(served, (None,))[0] is conn:
                    del self._serving[served]
            done.set()
            try:
                conn.close()
            except OSError:
                pass

    def _report_lost(self, job, key, consumer):
        """Best-effort LOST report of a split this worker won but could not
        finish streaming; the fence stays the backstop if it fails."""
        try:
            client = DispatcherClient(self.dispatcher_endpoints)
            try:
                client.lost_split(job, key[0], key[1], self.worker_id,
                                  consumer)
            finally:
                client.close()
        except Exception as e:
            logger.warning("feed worker %s: LOST report for split %s "
                           "failed (%s)", self.worker_id, key, e)

    def _make_feed(self, path):
        from tensorflowonspark_torch import data

        if self.use_process_pool:
            return data.ProcessPoolFeed([path], row_reader=self.row_reader,
                                        num_procs=self.num_procs, shard=False)
        return data.FileFeed([path], row_reader=self.row_reader,
                             reader_threads=1, shard=False)

    def _stream_split(self, conn, client, job, consumer, split, epoch, path,
                      flow=None, codec=None):
        # Reader faults (unreadable file, bad records) are kept separate
        # from socket faults: the reader calls sit in their own try so an
        # OSError from the filesystem is never mistaken for a dead stream.
        tracer = telemetry.get_tracer()
        if flow:
            # flow ids ride the stream's control frames so the consumer can
            # continue the dispatcher-started trace flow across processes
            tracer.flow_step("dataservice/split_flow", flow,
                             leg="worker_serve", split=split,
                             worker_id=self.worker_id)
        cached = (self.chunk_cache.lookup(path, codec)
                  if self.chunk_cache is not None else None)
        with tracer.span("dataservice/split_stream", split=split,
                         epoch=epoch, worker_id=self.worker_id,
                         cache="hit" if cached is not None else "miss"):
            begin = {"type": "split_begin", "split": split, "epoch": epoch}
            end = {"type": "split_end", "split": split, "epoch": epoch}
            if flow:
                begin["flow"] = end["flow"] = flow
            if codec:
                begin["codec"] = codec
            if self.chunk_cache is not None:
                # the serve verdict rides both control frames so consumers
                # tally dataservice_cache_* without a second channel
                begin["cache"] = end["cache"] = (
                    "hit" if cached is not None else "miss")
            _send_json(conn, begin)
            if cached is not None:
                # replay the serialized frames: no FileFeed, no decode, no
                # codec work — chaos hooks still fire per block/split
                served = 0
                for kind, payload, items in cached:
                    if self._stop.is_set():
                        break
                    _send_frame(conn, kind, payload)
                    self.items_streamed += items
                    self.bytes_streamed += len(payload)
                    served += len(payload)
                    self._injector.on_items(items)
                end["cache_bytes"] = served
            else:
                fill = [] if self.chunk_cache is not None else None
                # freshness signature is captured BEFORE the read starts:
                # a file mutated mid-read mismatches at the next lookup
                sig = (_FrameCache.signature(path) if fill is not None
                       else None)
                feed = None
                complete = False
                try:
                    try:
                        feed = self._make_feed(path)
                        feed._ensure_started()
                    except Exception as e:
                        self._abort_split(conn, client, job, consumer, split,
                                          epoch, e)
                        return
                    while not self._stop.is_set():
                        try:
                            block = feed._next_rows()
                        except Exception as e:
                            self._abort_split(conn, client, job, consumer,
                                              split, epoch, e)
                            return
                        if block is None:
                            complete = True
                            break
                        self._send_block(conn, block, codec=codec,
                                         record=fill)
                finally:
                    if feed is not None:
                        feed.terminate()
                if fill is not None and complete:
                    evicted = self.chunk_cache.put(path, codec, sig, fill)
                    if evicted:
                        end["cache_evicted"] = evicted
            if self.chunk_cache is not None:
                end["cache_resident"] = self.chunk_cache.resident_bytes()
                spilled = self.chunk_cache.take_spill_bytes()
                if spilled:
                    end["cache_spill_bytes"] = spilled
            _send_json(conn, end)
        self.splits_streamed += 1
        self._injector.on_split()

    def _abort_split(self, conn, client, job, consumer, split, epoch, exc):
        """In-band recovery from a reader fault: the stream is healthy, so
        tell the consumer to drop the partial buffer (``split_abort``) and
        the dispatcher to re-pool or fail the split (``SPLIT_ERR``) — the
        alternative, letting the exception kill the stream, would leave
        the split assigned to a live worker forever with no diagnosis."""
        desc = "{}: {}".format(type(exc).__name__, exc)
        logger.warning("feed worker %s: split %s of job %r failed to read "
                       "(%s)", self.worker_id, split, job, desc)
        telemetry.get_tracer().instant(
            "dataservice/split_error", worker_id=self.worker_id,
            split=split, error=desc)
        _send_json(conn, {"type": "split_abort", "split": split,
                          "epoch": epoch, "error": desc})
        try:
            client.split_error(job, epoch, split, self.worker_id, consumer,
                               desc)
        except DispatchError as e:
            logger.warning("feed worker %s: SPLIT_ERR refused (%s)",
                           self.worker_id, e)

    def _send_block(self, conn, block, codec=None, record=None):
        payload = None
        kind = _K_PICKLE
        if self._framed:
            chunk = marker.pack_columnar(block)
            if chunk is not None:
                payload = wire.frame_chunk_bytes(chunk, codec=codec,
                                                 stats=self.compress_stats)
                kind = _K_COLV1
        if payload is None:
            payload = pickle.dumps(block, protocol=pickle.HIGHEST_PROTOCOL)
            kind = _K_PICKLE
        _send_frame(conn, kind, payload)
        if record is not None:
            # the exact wire form (kind + serialized payload) is what the
            # cache replays, so hits skip pack/frame/compress entirely
            record.append((kind, payload, len(block)))
        self.items_streamed += len(block)
        self.bytes_streamed += len(payload)
        self._injector.on_items(len(block))

    def _heartbeat_metrics(self):
        """Counter snapshot riding worker HBEATs to the dispatcher (which
        latches the latest per worker for ``worker_metrics()``)."""
        out = {
            "dataservice_worker_splits": self.splits_streamed,
            "dataservice_worker_items": self.items_streamed,
            "dataservice_worker_bytes": self.bytes_streamed,
        }
        if self.chunk_cache is not None:
            out.update(self.chunk_cache.counters_flat())
            if self.advertise_cache:
                # not a counter: the dispatcher strips this path list off
                # before latching the numeric metrics
                out["cache_paths"] = self.chunk_cache.cached_paths()
        stats = self.compress_stats
        if stats.get("frames"):
            out["wire_compress_raw_bytes"] = int(stats.get("raw_bytes", 0))
            out["wire_compress_wire_bytes"] = int(stats.get("wire_bytes", 0))
        return out


# ---------------------------------------------------------------------------
# ServiceFeed
# ---------------------------------------------------------------------------

def _resolve_codecs(codecs):
    """Normalize a ``ServiceFeed(codecs=...)`` argument into the offer list
    sent in the dial hello.  ``None`` defers to ``TFOS_WIRE_CODEC`` and then
    to every codec this host supports; an explicit list is validated but
    passed through (the worker drops names it can't honour)."""
    if codecs is None:
        env = os.environ.get("TFOS_WIRE_CODEC", "").strip()
        if env:
            if env.lower() in ("off", "0", "none", "pickle"):
                return []
            if not wire.codec_supported(env):
                logger.warning("TFOS_WIRE_CODEC=%r is not supported on this "
                               "host; offering no codecs", env)
                return []
            return [env]
        return [c for c in wire.supported_codecs() if c != "none"]
    out = []
    for name in codecs:
        if not wire.codec_supported(name):
            raise ValueError("unsupported wire codec {!r} (supported: {})"
                             .format(name, wire.supported_codecs()))
        if name != "none":
            out.append(name)
    return out


class ServiceFeed(object):
    """Consumer-side client: a ``DataFeed``-compatible feed whose rows come
    from the data service instead of local files.

    Drop-in for the ``DataFeed`` duck type: ``next_batch`` /
    ``next_batch_arrays`` / ``should_stop`` / ``interrupt`` / ``terminate``
    / ``wire_formats`` / ``counters_snapshot`` — so
    ``parallel.infeed.ShardedFeed`` and ``train.fit_supervised`` consume it
    unchanged (``TPUNodeContext.get_service_feed`` is the node-side
    constructor).

    One receiver thread per worker stream decodes frames ahead of
    consumption into a bounded chunk queue — the client-side double
    buffering: the network receive of chunk N+1 overlaps the trainer's
    consumption of chunk N, ``prefetch`` chunks deep.  A maintainer thread
    tracks the dispatcher's worker roster, dialing workers as they appear
    (late joiners included) and detecting job completion.

    Shared jobs: several runs naming the same ``job_name`` attach to ONE
    ledger and split the read — each split streams to exactly one of the
    attached consumers.  ``attach`` controls the registration stance:
    ``"auto"`` (default) creates the job when absent and attaches
    otherwise; ``True`` requires a live job (``files`` may then be
    ``None`` — the live job's spec is adopted); ``False`` requires to be
    first.  A consumer that terminates early detaches so its in-flight
    splits rebind to the co-consumers; one that crashes silently is
    fenced by the dispatcher after the heartbeat deadline.

    Args:
      dispatcher_addr: ``(host, port)`` or ``"host:port"``.
      files: split paths (the job's dataset; every consumer of a job must
        pass the same list — job registration is attach-or-create).
        ``None`` is allowed with ``attach=True`` only.
      job_name: dataset job identity shared by all its consumers.
      attach: ``"auto"`` | ``True`` | ``False`` (see above).
      mode: :data:`SHARD_OFF` / :data:`SHARD_STATIC` / :data:`SHARD_DYNAMIC`.
      num_epochs: passes over the splits (epoch boundaries are invisible,
        like ``FileFeed``).
      consumer_id: this consumer's identity in the split ledger (defaults
        to ``host-pid``).
      input_mapping: as ``DataFeed`` — ``{column: tensor}``; ``next_batch``
        then returns per-tensor dicts (tuple rows only).
      prefetch: chunk-queue depth (≥2: double buffering).
      min_workers: wait for this many workers before binding (OFF mode
        binds its worker set once, see :data:`SHARD_OFF`).
      timeout: seconds without progress before the feed raises — turns a
        dead service into an error, not a hang.  Progress is any received
        frame, any commit (duplicates included), or any ledger movement
        (a co-consumer's commits count); size it above the worst-case
        stream time of a single split.
      codecs: wire-compression preference list offered at dial (first
        codec the worker supports wins; raw colv1 when nothing matches).
        ``None`` resolves from ``TFOS_WIRE_CODEC`` (a codec name, or
        ``off``/``0``/``pickle`` to offer nothing) and falls back to
        :func:`wire.supported_codecs`; ``[]`` disables the offer.
    """

    def __init__(self, dispatcher_addr, files, job_name="default",
                 mode=SHARD_DYNAMIC, num_epochs=1, consumer_id=None,
                 input_mapping=None, prefetch=2, min_workers=1,
                 retry_policy=None, timeout=60.0, codecs=None,
                 attach="auto"):
        if mode not in _MODES:
            raise ValueError("unknown sharding mode {!r} (one of {})"
                             .format(mode, _MODES))
        if attach not in ("auto", True, False):
            raise ValueError('attach must be "auto", True or False, not {!r}'
                             .format(attach))
        if files is None and attach is not True:
            raise ValueError("files=None needs attach=True (adopting the "
                             "spec of a live job)")
        # Endpoint-list discovery (primary first, standbys after): every
        # DispatcherClient below dials across the list, so the feed
        # follows a promoted standby without losing ledger state.
        self.dispatcher_endpoints = normalize_endpoints(dispatcher_addr)
        self.dispatcher_addr = self.dispatcher_endpoints[0]
        self.files = list(files) if files is not None else None
        self.attach = attach
        self.job_name = job_name
        self.mode = mode
        self.num_epochs = num_epochs
        self.consumer_id = consumer_id or "{}-{}".format(
            socket.gethostname(), id(self) & 0xffffff)
        self.input_tensors = (
            [tensor for _, tensor in sorted(input_mapping.items())]
            if input_mapping is not None else None)
        self.min_workers = min_workers
        self.retry_policy = retry_policy or _default_retry_policy()
        self.timeout = timeout
        self.codecs = _resolve_codecs(codecs)
        # DataFeed-compatible observability surface
        self.wire_formats = {}
        self.items_consumed = 0
        self.stall_secs = 0.0
        self.splits_committed = 0
        self.split_dupes = 0
        self.splits_discarded = 0
        self.bytes_received = 0
        # cache/compression telemetry relayed by workers on split_end
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self.cache_bytes = 0
        self.cache_spill_bytes = 0
        self.compress_raw_bytes = 0
        self.compress_wire_bytes = 0
        self._cache_resident = {}   # worker_id -> latest resident gauge
        self._affinity = {}         # latest job-level affinity counters
        self.created_job = None     # True created / False attached (started)
        self._fault = fault.from_env()
        self._chunks = _queue.Queue(maxsize=max(2, prefetch))
        self._buffer = []
        self._buffer_idx = 0
        self._interrupt = threading.Event()
        self._stop = threading.Event()
        self._done = False          # sentinel consumed (consumer thread only)
        self._sentinel_sent = False
        self._errors = _queue.Queue()
        self._committed = set()     # (epoch, split) commit dedupe
        self._done_pending = set()  # committed keys whose DONE hasn't landed
        self._commit_lock = threading.Lock()
        # Trace-flow ids of recently committed splits, drained by the
        # downstream infeed/trainer (``pop_flow_id``) so the dispatcher-
        # started flow reaches the dispatch leg.  Bounded: an unobserved
        # flow just drops off (flows are best-effort diagnostics).
        self._flow_pending = collections.deque(maxlen=16)
        self._started = False
        self._streams = {}          # worker_id -> receiver thread
        self._stream_socks = {}     # worker_id -> socket
        self._stream_lock = threading.Lock()
        self._dial_failures = {}
        self._last_progress = time.monotonic()
        self._maintainer = None

    # -- service wiring ----------------------------------------------------

    def _ensure_started(self):
        if self._started:
            return
        self._started = True
        client = self.retry_policy.call(
            lambda: DispatcherClient(self.dispatcher_endpoints))
        reply = client.register_job(self.job_name, self.files,
                                    num_epochs=self.num_epochs,
                                    mode=self.mode,
                                    consumer_id=self.consumer_id,
                                    attach=self.attach)
        self.created_job = bool(reply.get("created"))
        if self.files is None:
            # attach=True without files: adopt the live job's spec (the
            # receive plane needs the mode before any stream dials)
            spec = reply.get("spec") or {}
            self.files = list(spec.get("splits") or [])
            mode = spec.get("mode", self.mode)
            if mode in _MODES:
                self.mode = mode
            self.num_epochs = spec.get("num_epochs", self.num_epochs)
        self._maintainer = threading.Thread(
            target=self._maintain, args=(client,),
            name="servicefeed-maintain-{}".format(self.consumer_id),
            daemon=True)
        self._maintainer.start()

    def _maintain(self, client):
        """Roster tracking + completion detection (daemon thread).

        The dispatcher connection is treated as replaceable: any transport
        error drops it and the next tick redials (``retries=0`` per
        attempt — the loop itself is the retry), so a dispatcher restarted
        from its journal is picked up within a tick or two.  Dispatcher
        downtime is NOT progress — the watchdog keeps running, bounding
        how long a dead control plane can stall the feed."""
        off_bound = None  # OFF mode: the worker set frozen at binding time
        last_sig = None   # last observed ledger-progress signature
        job_done = False  # normal completion (no DETACH needed)
        try:
            while not self._stop.is_set():
                if client is None:
                    try:
                        client = DispatcherClient(self.dispatcher_endpoints,
                                                  retries=0)
                    except (OSError, EOFError, TimeoutError,
                            ConnectionError) as e:
                        logger.warning("servicefeed: dispatcher unreachable "
                                       "(%s); redialing", e)
                        if (time.monotonic()
                                - self._last_progress) > self.timeout:
                            raise TimeoutError(
                                "data service made no progress for {}s "
                                "(job {!r}, dispatcher unreachable)".format(
                                    self.timeout, self.job_name))
                        time.sleep(0.2)
                        continue
                try:
                    roster = {m["worker_id"]: m for m in client.workers()}
                except DispatchError as e:
                    logger.warning("servicefeed: worker listing refused "
                                   "(%s)", e)
                    roster = {}
                except (OSError, EOFError, TimeoutError,
                        ConnectionError) as e:
                    logger.warning("servicefeed: worker listing failed (%s)",
                                   e)
                    client.close()
                    client = None
                    roster = {}
                if self.mode == SHARD_OFF:
                    if off_bound is None:
                        if len(roster) >= self.min_workers:
                            off_bound = set(roster)
                    dial = {} if off_bound is None else {
                        w: m for w, m in roster.items() if w in off_bound}
                else:
                    dial = roster
                with self._stream_lock:
                    for worker_id, meta in dial.items():
                        if (worker_id not in self._streams
                                and self._dial_failures.get(worker_id, 0) < 3):
                            t = threading.Thread(
                                target=self._receive_stream,
                                args=(worker_id, meta),
                                name="servicefeed-rx-{}".format(worker_id),
                                daemon=True)
                            self._streams[worker_id] = t
                            t.start()
                if client is not None:
                    self._flush_pending_done(client)
                # completion: ledger modes ask the dispatcher; OFF is purely
                # per-stream (all bound streams finished)
                if self.mode == SHARD_OFF:
                    with self._stream_lock:
                        threads = list(self._streams.values())
                    if (off_bound is not None and threads
                            and all(not t.is_alive() for t in threads)):
                        job_done = True
                        break
                elif client is not None:
                    status = None
                    try:
                        status = client.status(self.job_name,
                                               consumer_id=self.consumer_id)
                    except DispatchError as e:
                        if "fenced" in str(e):
                            # our identity is burnt (we went silent past
                            # the deadline and our splits were rebound):
                            # continuing would double-deliver via parked
                            # DONEs, so fail loudly instead
                            raise
                    except (OSError, EOFError, TimeoutError,
                            ConnectionError):
                        client.close()
                        client = None
                    if status is not None:
                        if status.get("error"):
                            raise DispatchError(
                                "data service job {!r} failed: {}".format(
                                    self.job_name, status["error"]))
                        if status.get("affinity_total"):
                            self._affinity = {
                                "hits": int(status.get("affinity_hits", 0)),
                                "total": int(status["affinity_total"])}
                        if status.get("done"):
                            job_done = True
                            break
                        # any ledger movement is progress: a co-consumer's
                        # commits keep this (possibly idle) consumer's
                        # watchdog quiet while the shared job advances
                        sig = (status.get("epoch"), status.get("completed"),
                               status.get("assigned"), status.get("pending"),
                               status.get("reassigned"))
                        if sig != last_sig:
                            last_sig = sig
                            self._last_progress = time.monotonic()
                if (time.monotonic() - self._last_progress) > self.timeout:
                    raise TimeoutError(
                        "data service made no progress for {}s (job {!r}, "
                        "{} worker(s) listed)".format(self.timeout,
                                                      self.job_name,
                                                      len(roster)))
                time.sleep(0.1)
            self._finish_streams()
        except Exception as e:
            self._errors.put(e)
            # error/terminate path only: delivery is already forfeit, so the
            # sentinel may evict queued chunks to land immediately
            self._publish(_SENTINEL, force=True)
        else:
            # normal completion: every committed chunk is already queued
            # (publish precedes DONE), so the sentinel queues BEHIND them —
            # a slow-draining consumer keeps its tail
            self._publish(_SENTINEL)
        finally:
            if not job_done and self.mode != SHARD_OFF:
                # early exit (terminate / error): detach so our in-flight
                # splits rebind to co-consumers NOW instead of after the
                # liveness deadline; best-effort — the fence is the backstop
                self._detach_quietly(client)
                client = None
            if client is not None:
                client.close()

    def _detach_quietly(self, client):
        """Best-effort DETACH on the early-exit path (reuses the
        maintainer's client when it is still healthy)."""
        try:
            if client is None:
                client = DispatcherClient(self.dispatcher_endpoints, retries=0)
            try:
                client.detach_job(self.job_name, self.consumer_id)
            finally:
                client.close()
        except Exception as e:
            logger.info("servicefeed: detach of %s from job %r not "
                        "delivered (%s)", self.consumer_id, self.job_name, e)

    def _finish_streams(self):
        """Post-completion receiver wind-down — without dropping data.

        At job completion every committed chunk is already in the queue
        (``_commit_split`` publishes before DONE), so receivers are only
        waiting on their ``stream_end`` — or stuck in ``recv`` on a zombie
        stream whose remaining frames are duplicates by construction.
        Give them a short grace to exit cleanly, EOF the stragglers by
        closing their sockets, then join for as long as the consumer is
        alive; the chunk queue is never touched."""
        deadline = time.monotonic() + 2.0
        with self._stream_lock:
            threads = dict(self._streams)
        for worker_id, t in threads.items():
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                self._close_stream(worker_id)
        for t in threads.values():
            while t.is_alive() and not self._stop.is_set():
                t.join(timeout=0.2)

    def _flush_pending_done(self, client):
        """Retry parked DONE reports (maintainer tick; ``DONE`` is
        idempotent, so at-least-once delivery is safe)."""
        with self._commit_lock:
            pend = list(self._done_pending)
        for key in pend:
            try:
                client.done_split(self.job_name, key[0], key[1],
                                  self.consumer_id)
            except DispatchError as e:
                # a non-transient refusal (job vanished): drop the report
                logger.warning("servicefeed: parked DONE for split %s "
                               "refused (%s)", key, e)
            except (OSError, EOFError, TimeoutError) as e:
                logger.warning("servicefeed: parked DONE for split %s still "
                               "failing (%s)", key, e)
                return
            with self._commit_lock:
                self._done_pending.discard(key)

    def _report_lost_split(self, worker_id, key):
        """Best-effort LOST report: re-pools the mid-flight split now; the
        worker-fence path remains the backstop if this fails."""
        try:
            client = DispatcherClient(self.dispatcher_endpoints)
            try:
                client.lost_split(self.job_name, key[0], key[1], worker_id,
                                  self.consumer_id)
            finally:
                client.close()
        except Exception as e:
            logger.warning("servicefeed: LOST report for split %s on %s "
                           "failed (%s)", key, worker_id, e)

    def _close_stream(self, worker_id):
        with self._stream_lock:
            sock = self._stream_socks.pop(worker_id, None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    # -- receive plane -----------------------------------------------------

    def _receive_stream(self, worker_id, meta):
        """One worker stream: dial, hello, then frames until stream_end."""
        tracer = telemetry.get_tracer()
        sock = None
        cur = None       # (epoch, split) being buffered
        pending = []     # buffered chunks of the current split
        retry = False    # lost after a good dial: let the maintainer redial
        try:
            try:
                with tracer.span("dataservice/connect", worker_id=worker_id):
                    sock = self.retry_policy.call(
                        lambda: socket.create_connection(
                            (meta["host"], meta["port"]), timeout=10.0))
            except Exception as e:
                # couldn't reach the worker at all: un-claim the stream slot
                # so the maintainer may retry (bounded by _dial_failures)
                with self._stream_lock:
                    self._dial_failures[worker_id] = (
                        self._dial_failures.get(worker_id, 0) + 1)
                    self._streams.pop(worker_id, None)
                logger.warning("servicefeed: cannot reach worker %s (%s)",
                               worker_id, e)
                return
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._stream_lock:
                self._stream_socks[worker_id] = sock
            hello = {"job": self.job_name, "consumer": self.consumer_id}
            if self.codecs:
                # compression offer: the worker answers by tagging columns
                # with the first codec it supports (raw frames otherwise)
                hello["codecs"] = list(self.codecs)
            _send_json(sock, hello)
            with self._stream_lock:
                # a successful dial+hello proves the worker is healthy:
                # reset its failure budget so a long job survives more
                # than 3 transient stream resets to the same worker
                self._dial_failures.pop(worker_id, None)
            self._last_progress = time.monotonic()
            while not self._stop.is_set():
                kind, payload = _recv_frame(sock)
                # byte-level progress: a single split streaming longer than
                # the watchdog timeout must not trip it while frames flow
                self._last_progress = time.monotonic()
                if kind == _K_JSON:
                    msg = json.loads(payload)
                    mtype = msg.get("type")
                    if mtype == "split_begin":
                        cur = (int(msg["epoch"]), int(msg["split"]))
                        pending = []
                    elif mtype == "split_end":
                        self._tally_split_end(worker_id, msg)
                        self._commit_split(
                            (int(msg["epoch"]), int(msg["split"])), pending,
                            flow=msg.get("flow"))
                        cur, pending = None, []
                    elif mtype == "split_abort":
                        # worker-side reader fault: the stream is healthy
                        # but this split's buffer is incomplete — drop it;
                        # the dispatcher re-pools it or fails the job
                        self.splits_discarded += 1
                        tracer.instant("dataservice/split_abort",
                                       worker_id=worker_id,
                                       split=msg.get("split"))
                        logger.warning(
                            "servicefeed: worker %s aborted split %s (%s)",
                            worker_id, msg.get("split"), msg.get("error"))
                        cur, pending = None, []
                    elif mtype == "stream_end":
                        return
                    continue
                chunk = self._decode(kind, payload)
                if self.mode == SHARD_OFF or cur is None:
                    self._publish(chunk)  # no visitation ledger: commit now
                else:
                    pending.append(chunk)
        except (EOFError, OSError) as e:
            if self._stop.is_set():
                return
            retry = True
            if cur is not None or pending:
                # stream died mid-split: never committed — drop the partial
                # buffer and re-pool it NOW via a LOST report (the worker
                # may be perfectly alive; the fence is only the backstop)
                self.splits_discarded += 1
                tracer.instant("dataservice/split_discard",
                               worker_id=worker_id,
                               split=cur[1] if cur else None)
                if cur is not None and self.mode != SHARD_OFF:
                    self._report_lost_split(worker_id, cur)
            logger.warning("servicefeed: stream to worker %s lost (%s)",
                           worker_id, e)
        except DispatchError as e:
            logger.warning("servicefeed: stream to worker %s aborted (%s)",
                           worker_id, e)
        except Exception as e:
            if not self._stop.is_set():
                self._errors.put(e)
        finally:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            with self._stream_lock:
                self._stream_socks.pop(worker_id, None)
                if retry and not self._stop.is_set():
                    # un-claim the stream slot so the maintainer redials the
                    # still-live worker (bounded by the same dial budget); a
                    # worker that actually died stops being dialable and
                    # burns out the budget harmlessly
                    self._dial_failures[worker_id] = (
                        self._dial_failures.get(worker_id, 0) + 1)
                    self._streams.pop(worker_id, None)

    def _tally_split_end(self, worker_id, msg):
        """Fold the cache fields a worker rides on ``split_end`` into this
        feed's counters (tallied before the commit so a dedupe-dropped
        duplicate still reports the serve it caused upstream)."""
        verdict = msg.get("cache")
        if verdict == "hit":
            self.cache_hits += 1
        elif verdict == "miss":
            self.cache_misses += 1
        self.cache_bytes += int(msg.get("cache_bytes", 0) or 0)
        self.cache_evictions += int(msg.get("cache_evicted", 0) or 0)
        self.cache_spill_bytes += int(msg.get("cache_spill_bytes", 0) or 0)
        if "cache_resident" in msg:
            self._cache_resident[worker_id] = int(msg["cache_resident"])

    def _decode(self, kind, payload):
        if kind == _K_COLV1:
            # zero-copy: the frombuffer views pin `payload`, which is ours
            info = {}
            chunk = wire.decode_chunk(payload, copy=False, info=info)
            codecs = info.get("codecs")
            # per-link codec attribution: compressed frames count under
            # "colv1+<codec>" so telemetry can split raw from compressed
            fmt = (wire.WIRE_COLV1 + "+" + "+".join(codecs) if codecs
                   else wire.WIRE_COLV1)
            if codecs:
                self.compress_raw_bytes += int(info.get("raw_bytes", 0))
                self.compress_wire_bytes += len(payload)
            n = chunk.count
        elif kind == _K_PICKLE:
            rows = pickle.loads(payload)
            chunk = marker.Chunk(rows)
            fmt = wire.WIRE_PICKLE
            n = len(rows)
        else:
            raise DispatchError("unknown data frame kind {}".format(kind))
        self.wire_formats[fmt] = self.wire_formats.get(fmt, 0) + 1
        self.bytes_received += len(payload)
        return chunk

    def _commit_split(self, key, chunks, flow=None):
        """Exactly-once commit: publish once, report ``DONE`` at-least-once.

        The publish happens exactly once per ``(epoch, split)`` (the
        ``_committed`` dedupe drops a re-streamed copy whole), and only
        THEN is ``DONE`` reported — so the dispatcher can never declare
        the job done while committed chunks are still unpublished.  A
        failed ``DONE`` (transient dispatcher unreachability) parks the
        key in ``_done_pending`` for the maintainer to retry each tick:
        the published data is kept, the ledger catches up when the
        control plane returns, and a duplicate copy streamed meanwhile is
        dropped by the dedupe as usual."""
        with self._commit_lock:
            if key in self._committed:
                self.split_dupes += 1
                self._last_progress = time.monotonic()
                return
            self._committed.add(key)
        for chunk in chunks:
            self._publish(chunk)
        self.splits_committed += 1
        self._last_progress = time.monotonic()
        telemetry.get_tracer().instant(
            "dataservice/split_commit", split=key[1], epoch=key[0],
            consumer=self.consumer_id)
        if flow:
            # continue the dispatcher-started flow in this process and park
            # the id for the infeed/trainer to pick up (pop_flow_id)
            telemetry.get_tracer().flow_step(
                "dataservice/split_flow", flow, leg="split_commit",
                split=key[1], epoch=key[0], consumer=self.consumer_id)
            self._flow_pending.append(int(flow))
        try:
            client = self.retry_policy.call(
                lambda: DispatcherClient(self.dispatcher_endpoints))
            try:
                client.done_split(self.job_name, key[0], key[1],
                                  self.consumer_id)
            finally:
                client.close()
        except (DispatchError, OSError, EOFError, TimeoutError) as e:
            with self._commit_lock:
                self._done_pending.add(key)
            logger.warning("servicefeed: DONE for split %s failed (%s); "
                           "parked for maintainer retry", key, e)

    def _publish(self, item, force=False):
        if item is _SENTINEL:
            if self._sentinel_sent:
                return
            self._sentinel_sent = True
        while True:
            if self._stop.is_set() and not force:
                return
            try:
                self._chunks.put(item, timeout=0.2)
                return
            except _queue.Full:
                if force:
                    # end-of-feed must land even against a full queue a
                    # terminated consumer stopped draining
                    try:
                        self._chunks.get_nowait()
                    except _queue.Empty:
                        pass

    # -- consumer surface (DataFeed duck type) -----------------------------

    def _get_interruptible(self):
        if not self._errors.empty():
            raise self._errors.get()
        # chaos hook: ``saturate_consumer_secs`` slow-drains this pop so
        # the prefetch queue pins at capacity (NULL injector: one no-op)
        self._fault.on_consume()
        t0 = time.monotonic()
        try:
            while not self._interrupt.is_set():
                try:
                    item = self._chunks.get(block=True, timeout=0.5)
                except _queue.Empty:
                    if not self._errors.empty():
                        raise self._errors.get()
                    continue
                if item is _SENTINEL:
                    self._done = True
                    if not self._errors.empty():
                        raise self._errors.get()
                return item
            return _INTERRUPTED
        finally:
            self.stall_secs += time.monotonic() - t0

    def _buflen(self):
        buf = self._buffer
        return buf.count if isinstance(buf, marker.ColChunk) else len(buf)

    def _bufrow(self, i):
        buf = self._buffer
        return buf.row(i) if isinstance(buf, marker.ColChunk) else buf[i]

    def _next_chunk(self):
        """Refill the row buffer; False at end-of-feed/interrupt."""
        while True:
            if self._done:
                return False
            item = self._get_interruptible()
            if item is _INTERRUPTED or item is _SENTINEL:
                return False
            self._buffer = (item.items if isinstance(item, marker.Chunk)
                            else item)
            self._buffer_idx = 0
            if self._buflen():
                return True

    def next_batch(self, batch_size):
        """Up to ``batch_size`` rows; a list of items, or a dict of
        per-tensor lists when ``input_mapping`` was given (the
        ``DataFeed.next_batch`` contract)."""
        self._ensure_started()
        tensors = ([] if self.input_tensors is None
                   else {tensor: [] for tensor in self.input_tensors})
        count = 0
        while count < batch_size:
            if self._buffer_idx >= self._buflen():
                if not self._next_chunk():
                    break
            item = self._bufrow(self._buffer_idx)
            self._buffer_idx += 1
            if self.input_tensors is None:
                tensors.append(item)
            else:
                for i, tensor in enumerate(self.input_tensors):
                    tensors[tensor].append(item[i])
            count += 1
        self.items_consumed += count
        self._fault.on_items(count)
        return tensors

    def next_batch_arrays(self, batch_size, dtypes=None):
        """Columnar ``(arrays, count)`` — the ``DataFeed.next_batch_arrays``
        contract: per-tensor dict with ``input_mapping``, tuple of field
        arrays for tuple rows, single array for single-value rows, dict of
        per-key columns for dict rows (the ``FileFeed`` surface)."""
        from tensorflowonspark_torch import datafeed

        self._ensure_started()
        parts = []       # per-part tuple of per-field array slices
        dict_rows = []   # dict-row accumulation (pickle-fallback path)
        tuple_rows = None
        count = 0
        while count < batch_size:
            buflen = self._buflen()
            if self._buffer_idx >= buflen:
                if not self._next_chunk():
                    break
                buflen = self._buflen()
            take = min(batch_size - count, buflen - self._buffer_idx)
            i0 = self._buffer_idx
            buf = self._buffer
            if isinstance(buf, marker.ColChunk):
                fields, tr = tuple(c[i0:i0 + take]
                                   for c in buf.columns), buf.tuple_rows
            elif buf and isinstance(buf[0], dict):
                if parts:
                    raise ValueError("mixed dict and non-dict rows across "
                                     "feed chunks")
                dict_rows.extend(buf[i0:i0 + take])
                self._buffer_idx += take
                count += take
                continue
            else:
                fields, tr = datafeed._rows_to_fields(buf[i0:i0 + take])
            if dict_rows:
                raise ValueError("mixed dict and non-dict rows across feed "
                                 "chunks")
            if tuple_rows is None:
                tuple_rows = tr
            elif tuple_rows != tr or (parts
                                      and len(parts[-1]) != len(fields)):
                raise ValueError(
                    "inconsistent row structure across feed chunks "
                    "(tuple_rows {} vs {})".format(tuple_rows, tr))
            parts.append(fields)
            self._buffer_idx += take
            count += take
        self.items_consumed += count
        self._fault.on_items(count)
        if dict_rows:
            from tensorflowonspark_torch.data import FileFeed

            return FileFeed._columnar(dict_rows, dtypes), count
        if not count:
            return (np.empty((0,)) if self.input_tensors is None
                    else {t: np.empty((0,)) for t in self.input_tensors}), 0
        return datafeed.assemble_columns(parts, tuple_rows, dtypes,
                                         self.input_tensors), count

    def should_stop(self):
        """True once end-of-feed was observed and the buffer is drained."""
        return self._done and self._buffer_idx >= self._buflen()

    def interrupt(self):
        """Unblock a concurrent ``next_batch*`` (ShardedFeed handoff)."""
        self._interrupt.set()

    def terminate(self):
        """Stop receiving, close streams, drop buffered data (early stop /
        preemption drain).  Idempotent."""
        self._interrupt.set()
        self._stop.set()
        with self._stream_lock:
            workers = list(self._stream_socks)
        for worker_id in workers:
            self._close_stream(worker_id)
        if self._maintainer is not None:
            self._maintainer.join(timeout=2.0)
        while True:
            try:
                self._chunks.get_nowait()
            except _queue.Empty:
                break
        self._buffer, self._buffer_idx = [], 0
        self._done = True

    def pop_flow_id(self):
        """Oldest undrained trace-flow id of a committed split (or None).

        Drained by the downstream :class:`~...parallel.infeed.ShardedFeed` /
        :class:`~...train.Trainer` so the dispatcher-started flow event
        chain continues through device infeed and dispatch.  Best-effort:
        ids of splits nobody drained age out of the bounded deque."""
        try:
            return self._flow_pending.popleft()
        except IndexError:
            return None

    def counters_snapshot(self):
        """Flat telemetry counters for heartbeat payloads (the
        ``dataservice_*`` vocabulary merged into
        ``TPUCluster.metrics_snapshot()``)."""
        snap = {"dataservice_items": self.items_consumed,
                "dataservice_stall_secs": round(self.stall_secs, 6),
                "dataservice_splits": self.splits_committed,
                "dataservice_split_dupes": self.split_dupes,
                "dataservice_splits_discarded": self.splits_discarded,
                "dataservice_bytes": self.bytes_received}
        try:
            # Instantaneous prefetch-queue fill percentage, sampled per
            # beat: pinned at 100 the producer outruns the consumer (the
            # watchtower's saturation rule); pinned at 0 with stalls the
            # feed workers are the bottleneck.
            cap = self._chunks.maxsize
            if cap:
                snap["dataservice_queue_sat_pct_max"] = round(
                    100.0 * self._chunks.qsize() / cap, 2)
                # gauge: the CURRENT bound, so the driver can confirm a
                # live autopilot retune landed
                snap["dataservice_queue_bound_max"] = cap
        except Exception:
            pass
        for fmt, n in list(self.wire_formats.items()):
            snap["wire_{}".format(fmt)] = n
        # worker cache telemetry (relayed on split_end): always present so
        # dashboards see zeros, not gaps, when the cache is disabled
        snap["dataservice_cache_hit"] = self.cache_hits
        snap["dataservice_cache_miss"] = self.cache_misses
        snap["dataservice_cache_bytes"] = self.cache_bytes
        snap["dataservice_cache_evictions"] = self.cache_evictions
        snap["dataservice_cache_spill_bytes"] = self.cache_spill_bytes
        if self._cache_resident:
            snap["dataservice_cache_resident_max"] = max(
                self._cache_resident.values())
        # job-level affinity counters (polled off STATUS by the maintainer):
        # hits / total DYNAMIC hand-outs — the scheduler's A/B metric
        aff = self._affinity
        if aff.get("total"):
            snap["dataservice_affinity_hits"] = aff.get("hits", 0)
            snap["dataservice_affinity_total"] = aff["total"]
            snap["dataservice_affinity_hit_pct_max"] = round(
                100.0 * aff.get("hits", 0) / aff["total"], 2)
        if self.compress_wire_bytes:
            # wire's copy of the ratio: the port's metrics module imports
            # torch and registers the flash ops, which a host plane's beat
            # or scrape thread must not do
            snap["wire_compress_saved_bytes"] = (
                self.compress_raw_bytes - self.compress_wire_bytes)
            snap["wire_compress_ratio_max"] = round(wire.compression_ratio(
                self.compress_raw_bytes, self.compress_wire_bytes), 4)
        return snap

    def apply_knob(self, name, value):
        """Live-knob hook (autopilot KNOB pushes; see docs/AUTOPILOT.md).

        - ``dataservice_queue_bound``: rebounds the RUNNING chunk queue in
          place (under its mutex, waking blocked putters), so receiver
          threads can buffer deeper on the very next frame.
        - ``wire_codec``: re-resolves the codec offer (``"off"`` offers
          nothing, ``"auto"`` re-resolves the host default, a codec name
          offers just it); negotiated per stream hello, so it affects
          future dials — late-joining workers, re-dials, the next feed.
        - ``dataservice_cache_budget``: relayed to the dispatcher as a
          KNOB message (on a short-lived thread — this hook runs on the
          node's heartbeat thread) to ride the worker heartbeat replies.

        Returns True when the knob was claimed."""
        if name == "dataservice_queue_bound":
            bound = max(int(value), 2)
            q = self._chunks
            with q.mutex:
                q.maxsize = bound
                q.not_full.notify_all()
            return True
        if name == "wire_codec":
            if value in (None, "auto"):
                self.codecs = _resolve_codecs(None)
            elif str(value).lower() in ("off", "0", "none", "pickle"):
                self.codecs = []
            elif wire.codec_supported(str(value)):
                self.codecs = [str(value)]
            else:
                logger.warning("wire_codec knob: %r unsupported on this "
                               "host; ignored", value)
                return False
            return True
        if name == "dataservice_cache_budget":
            budget = int(value)

            def _relay():
                try:
                    client = DispatcherClient(self.dispatcher_endpoints,
                                              retries=0)
                    try:
                        client.push_knobs(
                            {"dataservice_cache_budget": budget})
                    finally:
                        client.close()
                except Exception as e:
                    logger.warning("cache-budget knob relay failed (%s)", e)

            threading.Thread(target=_relay, name="tfos-knob-relay",
                             daemon=True).start()
            return True
        return False
