"""Cluster-bootstrap rendezvous server/client (reference ``reservation.py``).

The driver runs a :class:`Server`; every executor node registers its metadata
(host, ports, role, manager address) via a :class:`Client`, and all parties
block until ``count`` reservations have arrived, after which everyone receives
the full cluster_info list.  The server also carries a "STOP" flag used for
streaming termination and user-requested early stop (reference
``reservation.py:128-144``, ``examples/utils/stop_streaming.py``).

Design deltas vs the reference (deliberate, TPU-first):

- Messages are length-prefixed **JSON**, not pickles (reference
  ``reservation.py:80-94`` pickled arbitrary objects over the wire — an RCE
  hazard and a cross-language dead end).  Node metadata is restricted to
  JSON-serializable values; binary authkeys travel hex-encoded.
- Clients block on the server with a long-poll ``AWAIT`` message instead of
  reconnecting every second (reference ``reservation.py:261-267`` polled at 1 s
  granularity); the server answers the moment the roster is complete, so a
  TPU-pod bring-up doesn't pay a mean 500 ms rendezvous tax per host.
- The assembled cluster_info is what distributes the
  ``jax.distributed.initialize(coordinator_address, num_processes, process_id)``
  parameters to every host (SURVEY §2.5) — the TPU-native replacement for
  building ``TF_CONFIG``.
"""

import json
import logging
import os
import select
import socket
import struct
import threading
import time

from tensorflowonspark_torch import standby as standby_mod
from tensorflowonspark_torch import telemetry

logger = logging.getLogger(__name__)

# Env overrides for multi-homed / NAT'd drivers (reference reservation.py:23-24).
TFOS_SERVER_HOST = "TFOS_SERVER_HOST"
TFOS_SERVER_PORT = "TFOS_SERVER_PORT"

_HEADER = struct.Struct(">I")  # 4-byte big-endian length prefix

_UNSET = object()  # sentinel: "use the client's default request timeout"


def _env_int(name, default):
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring non-integer %s=%r", name, raw)
        return default


def normalize_endpoints(addr):
    """Normalize a control-plane address into an endpoint LIST.

    Accepts a single ``(host, port)`` / ``[host, port]`` / ``"host:port"``,
    or a sequence of them — the endpoint-list form coordinator HA uses:
    entry 0 is the primary, later entries are warm standbys at pre-agreed
    pinned ports.  Clients dial in order and redial across the list on a
    reset, so a promoted standby is reachable without reconfiguration.
    """
    def one(a):
        if isinstance(a, str):
            host, _, port = a.rpartition(":")
            return (host, int(port))
        return (a[0], int(a[1]))

    if isinstance(addr, str):
        return [one(addr)]
    seq = list(addr)
    if (len(seq) == 2 and isinstance(seq[0], str)
            and not isinstance(seq[1], (list, tuple))
            and (isinstance(seq[1], int)
                 or (isinstance(seq[1], str) and seq[1].isdigit()))):
        return [one(seq)]  # a bare (host, port) pair
    if not seq:
        raise ValueError("empty endpoint list")
    return [one(a) for a in seq]


class Reservations(object):
    """Thread-safe store of node reservations (reference ``reservation.py:29-63``).

    Registrations are validated: a duplicate node identity or a registration
    past ``required`` raises ``ValueError`` (the server answers ``ERR``)
    instead of silently over-filling the roster — a speculatively re-run
    start task or a stale executor from a prior cluster must not corrupt the
    rendezvous every healthy node is blocked on.

    Elastic membership: the roster carries a monotonically increasing
    ``generation``.  When the liveness monitor fences a node, its
    ``(job_name, task_index)`` slot is *released* (:meth:`release`) so a
    replacement registration can claim it; the admission that re-fills a
    released slot bumps the generation, which is how waiters distinguish
    "the original roster" from "the roster after a membership change".
    """

    def __init__(self, required):
        self.required = required
        self.generation = 0
        self._lock = threading.Condition()
        self._reservations = []
        self._released = []  # freed (job_name, task_index) slots awaiting a claim

    @staticmethod
    def _identity(meta):
        """Node identity for dedupe: (host, executor_id) when the meta
        carries an executor identity, else the full sorted payload (so
        bare test metas like ``{"node": 1}`` stay distinct)."""
        if isinstance(meta, dict) and meta.get("executor_id") is not None:
            return ("id", meta.get("host"), meta["executor_id"])
        return ("meta", repr(sorted(meta.items()))
                if isinstance(meta, dict) else repr(meta))

    def add(self, meta):
        with self._lock:
            key = self._identity(meta)
            for existing in self._reservations:
                if self._identity(existing) == key:
                    raise ValueError(
                        "duplicate registration for node {} (executors must "
                        "run exactly one start task each)".format(key[1:]))
            if len(self._reservations) >= self.required:
                raise ValueError(
                    "roster already has {} of {} reservations; rejecting "
                    "extra registration {}".format(
                        len(self._reservations), self.required, key[1:]))
            self._reservations.append(meta)
            replacement = self._claim_released_slot(meta)
            if replacement:
                self.generation += 1
                logger.info(
                    "replacement %s admitted into released slot %s:%s; "
                    "roster generation now %d", key[1:],
                    meta.get("job_name", "?") if isinstance(meta, dict) else "?",
                    meta.get("task_index", "?") if isinstance(meta, dict) else "?",
                    self.generation)
            telemetry.get_tracer().instant(
                "reservation/admission",
                executor_id=(meta.get("executor_id")
                             if isinstance(meta, dict) else None),
                job_name=(meta.get("job_name")
                          if isinstance(meta, dict) else None),
                task_index=(meta.get("task_index")
                            if isinstance(meta, dict) else None),
                replacement=bool(replacement),
                generation=self.generation)
            if self.done():
                self._lock.notify_all()

    def _claim_released_slot(self, meta):
        """If ``meta`` fills a released slot, consume that slot and return
        True (caller holds the lock).  Metas carrying a role claim their own
        ``(job_name, task_index)``; bare metas (tests) claim any freed slot."""
        if not self._released:
            return False
        if isinstance(meta, dict) and meta.get("job_name") is not None:
            slot = (meta.get("job_name"), meta.get("task_index"))
            if slot in self._released:
                self._released.remove(slot)
                return True
            return False
        self._released.pop(0)
        return True

    def release(self, executor_id):
        """Release the slot held by ``executor_id`` (liveness fence): the
        reservation is removed so a *replacement* identity may claim the
        freed ``(job_name, task_index)``.  Returns the removed meta, or
        ``None`` if the executor never held a reservation (e.g. it died
        before registering)."""
        with self._lock:
            for i, meta in enumerate(self._reservations):
                if (isinstance(meta, dict)
                        and meta.get("executor_id") == executor_id):
                    del self._reservations[i]
                    self._released.append(
                        (meta.get("job_name"), meta.get("task_index")))
                    logger.warning(
                        "released slot %s:%s of fenced executor %s for "
                        "replacement admission", meta.get("job_name", "?"),
                        meta.get("task_index", "?"), executor_id)
                    telemetry.get_tracer().instant(
                        "reservation/release",
                        executor_id=executor_id,
                        job_name=meta.get("job_name"),
                        task_index=meta.get("task_index"),
                        generation=self.generation)
                    return meta
        return None

    def find(self, executor_id):
        """Copy of the reservation meta held by ``executor_id``, or ``None``.
        The remediator's eviction action reads the role identity
        (``job_name``/``task_index``) here BEFORE fencing — release/replace
        need it, and ``_reservations`` is otherwise private."""
        with self._lock:
            for meta in self._reservations:
                if (isinstance(meta, dict)
                        and meta.get("executor_id") == executor_id):
                    return dict(meta)
        return None

    def released_slots(self):
        """Snapshot of freed ``(job_name, task_index)`` slots not yet
        reclaimed by a replacement."""
        with self._lock:
            return list(self._released)

    def by_job(self, job_name):
        """Copies of the reservations registered under ``job_name`` — the
        fleet router's discovery read (``job_name="serving"`` rows carry
        ``model``/``model_version`` meta; see fleet.FleetRouter.sync_roster).
        Does not wait for a full roster: serving fleets are elastic, so
        callers see whatever replicas are registered right now."""
        with self._lock:
            return [dict(meta) for meta in self._reservations
                    if isinstance(meta, dict)
                    and meta.get("job_name") == job_name]

    def notify_waiters(self):
        """Wake every ``wait()``er for an out-of-band re-check (used by the
        liveness monitor so a dead node unblocks the driver immediately
        instead of at the next 1 s poll)."""
        with self._lock:
            self._lock.notify_all()

    def done(self):
        with self._lock:
            return len(self._reservations) >= self.required

    def get(self):
        with self._lock:
            return list(self._reservations)

    def remaining(self):
        with self._lock:
            return self.required - len(self._reservations)

    def wait(self, timeout=None):
        """Block until the roster is complete; returns done-ness."""
        deadline = None if timeout is None else time.time() + timeout
        with self._lock:
            while not self.done():
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return False
                self._lock.wait(remaining if remaining is not None else 1.0)
            return True


class MessageSocket(object):
    """Length-prefixed JSON message framing (reference ``reservation.py:66-95``)."""

    def receive(self, sock):
        header = self._recv_exact(sock, _HEADER.size)
        (length,) = _HEADER.unpack(header)
        payload = self._recv_exact(sock, length)
        return json.loads(payload.decode("utf-8"))

    def send(self, sock, msg):
        payload = json.dumps(msg).encode("utf-8")
        sock.sendall(_HEADER.pack(len(payload)) + payload)

    @staticmethod
    def _recv_exact(sock, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("socket closed while receiving message")
            buf.extend(chunk)
        return bytes(buf)


class Server(MessageSocket):
    """Driver-side rendezvous server (reference ``reservation.py:98-202``).

    Single listener thread multiplexing all executor connections with
    ``select``; ``AWAIT`` requests are parked and answered when the roster
    completes (or a client disconnects and retries).
    """

    def __init__(self, count, heartbeat_interval=0, heartbeat_misses=3,
                 on_dead=None, on_bye=None, host=None, port=None,
                 journal_dir=None, snapshot_every=None, journal_keep=None,
                 journal_keep_bytes=None, beacon_interval=None,
                 takeover_grace=None):
        """Args:
          count: required number of reservations.
          heartbeat_interval: expected seconds between node ``HBEAT``s;
            0 disables liveness monitoring (beats are still accepted).
          heartbeat_misses: consecutive missed beats before a node is
            declared dead (deadline = interval × misses).
          on_dead: optional ``fn(meta, age_secs)`` callback fired once per
            dead node from the listener thread (the driver wires it to
            ``tf_status`` latching, backend executor exclusion, and — when
            the backend supports it — slot release + replacement admission).
          on_bye: optional ``fn(executor_id, reason)`` callback fired on a
            clean ``BYE`` deregistration that carries a reason (``done`` /
            ``preempted``) — how the driver tells clean completion from a
            preemption drain in ``tf_status``.
          host/port: advertised host and listen port (default: the
            ``TFOS_SERVER_HOST``/``TFOS_SERVER_PORT`` env, then
            auto-detect/ephemeral).  Pin the port so a restarted or
            promoted coordinator keeps a pre-agreed address.
          journal_dir: journal every ledger mutation (REG, slot
            release/reclaim, BYE, fence, knob push, STOP) as
            flush-per-write JSONL under this dir, with periodic
            tmp+rename+fsync snapshots; ``start()`` then advances the
            fencing epoch and recovers roster, generations, released
            slots, latched metrics, and KnobCoordinator state before
            listening.  Default: ``TFOS_RS_JOURNAL_DIR`` env; unset
            disables durability (the historic in-memory behavior).
          snapshot_every / journal_keep / journal_keep_bytes: snapshot
            cadence and compaction policy, mirroring the data-service
            dispatcher (env fallbacks ``TFOS_RS_SNAPSHOT_EVERY`` 256,
            ``TFOS_RS_JOURNAL_KEEP`` 2, ``TFOS_RS_JOURNAL_KEEP_BYTES``).
          beacon_interval: primary-beacon stamp cadence (None: half the
            heartbeat interval, clamped to [0.1, 0.5]s).
          takeover_grace: seconds after a recovery during which liveness
            fencing is suppressed so healthy nodes can re-home to the new
            coordinator (None: ``heartbeat_interval × heartbeat_misses``,
            at least 2 s).
        """
        assert count > 0
        self.reservations = Reservations(count)
        self.done = False  # set when a STOP was requested (streaming/early-stop)
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_misses = heartbeat_misses
        self.on_dead = on_dead
        self.on_bye = on_bye
        self._host = host
        self._port = port
        if journal_dir is None:
            journal_dir = os.environ.get("TFOS_RS_JOURNAL_DIR") or None
        self.journal_dir = journal_dir
        if snapshot_every is None:
            snapshot_every = _env_int("TFOS_RS_SNAPSHOT_EVERY", 256)
        self.snapshot_every = max(int(snapshot_every), 1)
        if journal_keep is None:
            journal_keep = _env_int("TFOS_RS_JOURNAL_KEEP", 2)
        self.journal_keep = max(int(journal_keep), 1)
        if journal_keep_bytes is None:
            journal_keep_bytes = _env_int("TFOS_RS_JOURNAL_KEEP_BYTES", 0)
        self.journal_keep_bytes = max(int(journal_keep_bytes), 0)
        if beacon_interval is None:
            beacon_interval = (min(max(heartbeat_interval / 2.0, 0.1), 0.5)
                               if heartbeat_interval else 0.5)
        self.beacon_interval = float(beacon_interval)
        self._takeover_grace = takeover_grace
        # Fencing epoch: 0 until this incarnation claims a journal dir.
        # Replies carry it (the send() override) so clients can refuse a
        # zombie's stale answers; superseded_by latches the NEWER epoch a
        # successor stamped, after which every request is answered ERR.
        self.fencing_epoch = 0
        self.superseded_by = None
        self.recovered_nodes = 0   # roster entries restored at start()
        self.recoveries = 0        # 1 when this incarnation recovered state
        self.journal_records = 0   # total ledger records appended (metrics)
        self._journal_file = None
        self._journal_seq = 0
        self._journal_count = 0
        self._journal_lock = threading.Lock()  # push_knobs runs off-thread
        self._beacon_last = 0.0
        self._fence_grace_until = 0.0
        self._stopping = False  # set by stop(): winds the listener down
        self._socket = None
        self._thread = None
        # AWAIT connections waiting for roster completion: sock -> minimum
        # roster generation the client asked to observe (0 = any).
        self._parked = {}
        # Liveness state, touched only by the listener thread plus read-only
        # snapshots below: executor_id -> (last-beat monotonic time, meta).
        self._beats = {}
        self._dead = {}  # executor_id -> human-readable death description
        self._released_ids = set()  # dead executors whose slot was released
        self._byes = {}  # executor_id -> BYE reason (when one was given)
        # Latest HBEAT-carried telemetry counter snapshot per executor
        # (flat JSON dicts; see telemetry.merge_counters for the schema).
        # A BYE keeps the snapshot: the final aggregate must still cover
        # nodes that finished cleanly before the driver latched it.
        self._node_metrics = {}
        # Optional time-series sink (observatory.SampleRing duck type): each
        # latched snapshot is also recorded as a timestamped sample so the
        # observatory can derive rates.  Attached by cluster.run when the
        # observatory is enabled; None costs one attribute load per latch.
        self.sample_ring = None
        # Optional profile-capture coordinator (profiling.CaptureCoordinator
        # duck type): pending capture requests ride OUT on HBEAT replies
        # (``poll(executor_id)``) and per-node artifacts ride BACK on PROF
        # messages (``receive(data)``).  Attached by cluster.run when the
        # observatory is enabled; None keeps the HBEAT path byte-identical.
        self.profile_coordinator = None
        # Optional live-knob coordinator (KnobCoordinator): pending knob
        # updates from the autopilot ride OUT on HBEAT replies
        # (``poll(executor_id)``), each node seeing each push exactly once.
        # Attached by cluster.run when the autopilot is enabled; None keeps
        # the HBEAT path byte-identical.
        self.knob_coordinator = None
        # Executors whose HBEAT-carried trace flow was already stitched into
        # the driver trace (one flow step per node, not one per beat).
        self._hbeat_flow_seen = set()

    # -- liveness ---------------------------------------------------------

    def dead_nodes(self):
        """Snapshot of dead-node descriptions, keyed by executor id."""
        return dict(self._dead)

    def bye_reasons(self):
        """Snapshot of clean-deregistration reasons, keyed by executor id."""
        return dict(self._byes)

    def beat_ages(self):
        """Seconds since each tracked node's last heartbeat, keyed by
        executor id (read-only snapshot; dead nodes excluded).  The
        watchtower's heartbeat-miss rule reads this to flag a silent node
        BEFORE the liveness fence (``heartbeat_misses`` beats) declares it
        dead."""
        now = time.monotonic()
        return {str(ex): now - last
                for ex, (last, _) in list(self._beats.items())
                if ex not in self._dead}

    def metrics_snapshot(self):
        """Cluster metrics view from the HBEAT payloads: per-node snapshots
        plus the merged aggregate (sums, ``_hwm`` keys by max)."""
        nodes = {str(ex): dict(snap)
                 for ex, snap in list(self._node_metrics.items())}
        return {"nodes": nodes,
                "aggregate": telemetry.merge_counters(nodes.values())}

    def release_slot(self, executor_id):
        """Release the fenced executor's roster slot for replacement
        admission (see :meth:`Reservations.release`).  The executor itself
        stays dead — only a *fresh* identity may claim the freed slot; the
        zombie's registrations and beats remain fenced.  Returns the
        released node meta, or ``None``."""
        meta = self.reservations.release(executor_id)
        if meta is not None:
            self._released_ids.add(executor_id)
            self._journal({"t": "release", "executor": executor_id})
        return meta

    # -- fencing epoch + reply stamping -----------------------------------

    def send(self, sock, msg):
        """Every reply from a journal-armed coordinator carries the fencing
        epoch, so clients can tell a promoted successor (higher epoch) from
        a zombie predecessor (lower) and refuse to go backwards."""
        if self.fencing_epoch and isinstance(msg, dict):
            msg.setdefault("epoch", self.fencing_epoch)
        MessageSocket.send(self, sock, msg)

    def _check_epoch(self):
        """Ledger-ownership check: a fencing epoch on disk newer than ours
        means a successor (restart or promoted standby) claimed the
        journal — fence THIS incarnation as a zombie: stop journaling,
        stop stamping the beacon, answer everything ERR."""
        if not self.journal_dir or self.superseded_by is not None:
            return
        on_disk = standby_mod.read_epoch(self.journal_dir)
        if on_disk > self.fencing_epoch:
            self._fence_zombie(on_disk)

    def _fence_zombie(self, newer_epoch):
        self.superseded_by = newer_epoch
        logger.error(
            "reservation server fenced: epoch %d on disk supersedes this "
            "incarnation's epoch %d — a successor owns the ledger; "
            "rejecting all writes from here on", newer_epoch,
            self.fencing_epoch)
        telemetry.get_tracer().instant(
            "reservation/zombie_fenced", epoch=self.fencing_epoch,
            superseded_by=newer_epoch)
        with self._journal_lock:
            if self._journal_file is not None:
                try:
                    self._journal_file.close()
                except OSError:
                    pass
                self._journal_file = None

    def _stamp_beacon(self, addr, force=False):
        """Re-stamp the primary beacon at the configured cadence (listener
        loop tick); doubles as the zombie self-check — a superseded
        incarnation must not keep the beacon looking alive."""
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
                                     role="reservation")

    # -- journal -----------------------------------------------------------

    def _segment_path(self, kind, seq):
        ext = "jsonl" if kind == "journal" else "json"
        return os.path.join(self.journal_dir,
                            "{}-{:08d}.{}".format(kind, seq, ext))

    def _journal(self, rec):
        """Append one ledger-mutation record, flush-per-write (a SIGKILL
        loses at most the torn tail line, skipped on replay).  Each append
        re-verifies ledger ownership via the fencing epoch, so a zombie
        primary's writes are REJECTED rather than interleaved with its
        successor's.  A write failure degrades to in-memory operation with
        a loud log — availability over durability."""
        if self._journal_file is None:
            return
        with self._journal_lock:
            if self._journal_file is None:
                return
            on_disk = standby_mod.read_epoch(self.journal_dir)
            if on_disk > self.fencing_epoch:
                pass  # fenced below, outside the lock
            else:
                try:
                    self._journal_file.write(
                        json.dumps(rec, sort_keys=True) + "\n")
                    self._journal_file.flush()
                except (OSError, ValueError) as e:
                    logger.error(
                        "reservation journal: write failed (%s); ledger "
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
                    self._write_snapshot_locked()
                return
        self._fence_zombie(on_disk)

    def _snapshot_state(self):
        """JSON-serializable full ledger state.  Latched node metrics ride
        snapshots (not per-beat journal records — beats are too chatty for
        flush-per-write), plus the final BYE metrics which ARE journaled;
        a failover loses at most one beat's worth of counter freshness,
        which the cumulative node-side counters repair on the next beat."""
        res = self.reservations
        with res._lock:
            roster = list(res._reservations)
            released = [list(s) for s in res._released]
            generation = res.generation
        state = {
            "seq": self._journal_seq,
            "epoch": self.fencing_epoch,
            "required": res.required,
            "generation": generation,
            "reservations": roster,
            "released": released,
            "released_ids": sorted(str(x) for x in self._released_ids),
            "dead": dict(self._dead),
            "byes": dict(self._byes),
            "node_metrics": {str(ex): dict(snap)
                             for ex, snap in list(self._node_metrics.items())},
            "done": bool(self.done),
        }
        if self.knob_coordinator is not None:
            state["knobs"] = self.knob_coordinator.to_state()
        return state

    def _write_snapshot_locked(self):
        """Full-state snapshot (atomic tmp+rename+fsync) + fresh journal
        segment; old generations pruned per the compaction policy.  Caller
        holds ``_journal_lock``."""
        self._journal_seq += 1
        seq = self._journal_seq
        state = self._snapshot_state()
        state["seq"] = seq
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
            logger.error("reservation journal: snapshot %d failed (%s)",
                         seq, e)
            self._journal_file = None
        self._journal_count = 0
        self._prune_segments(seq)

    def _gen_bytes(self, seq):
        total = 0
        for kind in ("snapshot", "journal"):
            try:
                total += os.path.getsize(self._segment_path(kind, seq))
            except OSError:
                pass
        return total

    def _prune_segments(self, seq):
        """Byte budget (``journal_keep_bytes`` > 0): keep the newest
        generations that fit, the newest always kept; otherwise keep the
        newest ``journal_keep`` generations."""
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

    def _list_segments(self):
        out = []
        for name in os.listdir(self.journal_dir):
            if name.startswith("journal-") and name.endswith(".jsonl"):
                try:
                    out.append(int(name[len("journal-"):-len(".jsonl")]))
                except ValueError:
                    pass
        return out

    def _replay(self, rec):
        """Apply one journal record through the same mutation paths as the
        live handlers, so replay and live execution cannot diverge."""
        t = rec.get("t")
        if t == "reg":
            meta = rec.get("meta")
            try:
                self.reservations.add(meta)
            except ValueError:
                pass  # already present via the snapshot base
            gen = rec.get("generation")
            if gen is not None:
                self.reservations.generation = max(
                    self.reservations.generation, int(gen))
        elif t == "release":
            if self.reservations.release(rec.get("executor")) is not None:
                self._released_ids.add(rec.get("executor"))
        elif t == "fence":
            ex = rec.get("executor")
            self._dead[ex] = rec.get(
                "why", "fenced before a coordinator failover")
            self._beats.pop(ex, None)
        elif t == "bye":
            ex = rec.get("executor")
            self._latch_metrics(ex, rec.get("metrics"))
            self._beats.pop(ex, None)
            if rec.get("reason") is not None:
                self._byes[ex] = rec["reason"]
        elif t == "knob":
            if self.knob_coordinator is None:
                self.knob_coordinator = KnobCoordinator()
            self.knob_coordinator.push(rec.get("knobs") or {},
                                       executor_id=rec.get("target"))
        elif t == "stop":
            self.done = True

    def _recover(self):
        """Rebuild roster, generations, released slots, latched metrics and
        KnobCoordinator state from the newest snapshot plus its journal
        segment (torn tail tolerated), re-arm liveness for the recovered
        roster under a takeover grace window, and cut a fresh snapshot so
        the NEXT restart replays from here."""
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
                res = self.reservations
                with res._lock:
                    res._reservations = list(state.get("reservations") or [])
                    res._released = [tuple(s) for s
                                     in (state.get("released") or [])]
                    res.generation = int(state.get("generation", 0))
                self._released_ids = set(state.get("released_ids") or [])
                self._dead = dict(state.get("dead") or {})
                self._byes = dict(state.get("byes") or {})
                self._node_metrics = {
                    ex: dict(snap) for ex, snap
                    in (state.get("node_metrics") or {}).items()}
                self.done = bool(state.get("done"))
                if state.get("knobs"):
                    self.knob_coordinator = KnobCoordinator.from_state(
                        state["knobs"])
                self._journal_seq = int(state.get("seq", seq))
            except (OSError, ValueError, KeyError) as e:
                logger.error("reservation journal: snapshot %d unreadable "
                             "(%s); replaying the journal from scratch",
                             seq, e)
                self._journal_seq = seq
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
        # Re-arm liveness for the recovered roster at "now", under a grace
        # window suppressing fencing entirely: the nodes are (probably)
        # alive, but their beats were landing on the dead predecessor —
        # fencing them for that silence would turn one coordinator death
        # into a cluster-wide false-fence cascade while they re-home.
        roster = self.reservations.get()
        now = time.monotonic()
        if self.heartbeat_interval:
            for meta in roster:
                if isinstance(meta, dict) \
                        and meta.get("executor_id") is not None \
                        and meta["executor_id"] not in self._dead:
                    self._beats[meta["executor_id"]] = (now, meta)
        self.recovered_nodes = len(roster)
        if roster or replayed or seq:
            self.recoveries = 1
            grace = self._takeover_grace
            if grace is None:
                grace = max(
                    self.heartbeat_interval * self.heartbeat_misses, 2.0)
            self._fence_grace_until = now + grace
            logger.warning(
                "reservation server: recovered %d node(s), generation %d "
                "from %s (snapshot %d + %d journal record(s)); fencing "
                "suppressed for %.1fs while nodes re-home",
                len(roster), self.reservations.generation, self.journal_dir,
                seq, replayed, grace)
            telemetry.get_tracer().instant(
                "reservation/recover", nodes=len(roster), records=replayed,
                generation=self.reservations.generation,
                epoch=self.fencing_epoch)
        with self._journal_lock:
            self._write_snapshot_locked()

    # -- knob plane --------------------------------------------------------

    def push_knobs(self, knobs, executor_id=None):
        """Journaled knob push: queue a live-knob update for the fleet (or
        one executor) AND record it in the ledger, so a recovered or
        promoted coordinator still carries the autopilot's standing intent
        — nodes that re-home drain the same history they would have from
        the dead primary.  The autopilot's actuator in a journal-armed
        cluster (``cluster.run``) points here instead of at the bare
        ``KnobCoordinator.push``."""
        if self.knob_coordinator is None:
            self.knob_coordinator = KnobCoordinator()
        seq = self.knob_coordinator.push(knobs, executor_id=executor_id)
        if knobs:
            self._journal({"t": "knob", "seq": seq, "knobs": dict(knobs),
                           "target": executor_id})
        return seq

    # -- HA observability --------------------------------------------------

    def ha_status(self):
        """The coordinator-HA block for ``/status`` and the
        ``tfos_coordinator_*`` metrics: journal armament, fencing epoch,
        supersession, recovery footprint, and the remaining takeover
        grace."""
        return {
            "journal_dir": self.journal_dir,
            "epoch": self.fencing_epoch,
            "superseded_by": self.superseded_by,
            "recovered_nodes": self.recovered_nodes,
            "recoveries": self.recoveries,
            "journal_records": self.journal_records,
            "snapshot_seq": self._journal_seq,
            "grace_remaining_secs": round(
                max(0.0, self._fence_grace_until - time.monotonic()), 3),
        }

    def _watch(self, meta):
        """Start tracking a registered node (registration counts as beat 0,
        so a node that registers and never beats is still caught)."""
        if self.heartbeat_interval and isinstance(meta, dict) \
                and meta.get("executor_id") is not None:
            self._beats[meta["executor_id"]] = (time.monotonic(), meta)

    def _latch_metrics(self, executor_id, metrics):
        """Fold a piggybacked counter snapshot into the per-executor latch
        KEY-WISE, not wholesale: node counters are cumulative, so the newest
        value per key wins, but keys absent from a later payload keep their
        last-seen value — a metrics source that was garbage collected with
        the user fn (a feed, a trainer) must not erase the counters it
        already reported when the final BYE snapshot arrives without it."""
        if not (isinstance(metrics, dict) and metrics):
            return
        prev = self._node_metrics.get(executor_id)
        if prev:
            merged = dict(prev)
            merged.update(metrics)
            self._node_metrics[executor_id] = merged
        else:
            self._node_metrics[executor_id] = metrics
        if self.sample_ring is not None:
            try:
                # record the folded cumulative view, not the raw payload, so
                # rate derivation never sees a key vanish mid-series
                self.sample_ring.record(executor_id,
                                        self._node_metrics[executor_id])
            except Exception:
                logger.debug("sample ring record failed", exc_info=True)

    def _beat(self, executor_id, metrics=None):
        """Record a heartbeat; False if the node was already declared dead
        (the sender is fenced: a zombie must not resurrect silently).
        ``metrics`` is an optional piggybacked counter snapshot (flat JSON
        dict); latched per executor for :meth:`metrics_snapshot`."""
        if executor_id in self._dead:
            return False
        self._latch_metrics(executor_id, metrics)
        if executor_id in self._beats:
            self._beats[executor_id] = (
                time.monotonic(), self._beats[executor_id][1])
        elif self.heartbeat_interval:
            # beat before/without REG (e.g. a feed task's probe): track it
            self._beats[executor_id] = (time.monotonic(),
                                        {"executor_id": executor_id})
        return True

    def _check_liveness(self):
        """Listener-loop tick: declare nodes dead past the missed-beat
        deadline, fire ``on_dead``, and wake roster waiters immediately."""
        if not self.heartbeat_interval or self.done:
            return
        now = time.monotonic()
        if now < self._fence_grace_until:
            # Post-takeover grace: this incarnation just recovered the
            # roster from the journal; the nodes' beats were landing on the
            # dead predecessor, so their silence is OUR history, not theirs.
            return
        deadline = self.heartbeat_interval * self.heartbeat_misses
        newly_dead = []
        for executor_id, (last, meta) in list(self._beats.items()):
            age = now - last
            if age > deadline:
                desc = ("node {}:{} (executor {}) on {} missed {} heartbeats "
                        "(last beat {:.1f}s ago, interval {:.1f}s)").format(
                            meta.get("job_name", "?"),
                            meta.get("task_index", "?"), executor_id,
                            meta.get("host", "?"), self.heartbeat_misses,
                            age, self.heartbeat_interval)
                logger.error("liveness: %s", desc)
                self._dead[executor_id] = desc
                del self._beats[executor_id]
                self._journal({"t": "fence", "executor": executor_id,
                               "why": desc})
                newly_dead.append((meta, age))
                telemetry.get_tracer().instant(
                    "reservation/fence", executor_id=executor_id,
                    job_name=meta.get("job_name"),
                    task_index=meta.get("task_index"),
                    age_secs=round(age, 3),
                    generation=self.reservations.generation)
        if newly_dead:
            # Fire on_dead BEFORE waking waiters: the callback may release
            # the dead node's slot for replacement (cluster.run), and a
            # waiter woken in between would mis-read the death as
            # unrecoverable and abort a roster a replacement can still fill.
            if self.on_dead is not None:
                for meta, age in newly_dead:
                    try:
                        self.on_dead(meta, age)
                    except Exception:
                        logger.exception("on_dead callback failed")
            # Wake await_reservations NOW rather than at its next poll.
            self.reservations.notify_waiters()

    def _forget(self, executor_id, reason=None):
        """Clean deregistration (``BYE``): the node finished on purpose, so
        silence from here on is not a death.  ``reason`` (``done`` /
        ``preempted``) is recorded and surfaced via ``on_bye``."""
        self._beats.pop(executor_id, None)
        if reason is not None:
            self._byes[executor_id] = reason
            if self.on_bye is not None:
                try:
                    self.on_bye(executor_id, reason)
                except Exception:
                    logger.exception("on_bye callback failed")

    def _unrecovered_dead(self):
        """Dead-node descriptions for nodes whose slot was NOT released for
        replacement — the deaths that make the roster unfillable."""
        return [d for ex, d in self._dead.items()
                if ex not in self._released_ids]

    def await_reservations(self, status=None, timeout=600, generation=None):
        """Block the driver until all nodes registered (reference 111-126).

        ``status`` is a shared dict; if an async job-launcher thread records an
        ``'error'`` key there, waiting aborts immediately (reference
        ``reservation.py:117-120`` + ``TFCluster.py:321-323``).  A node the
        liveness monitor declared dead also aborts immediately — UNLESS its
        slot was released for replacement admission (elastic recovery), in
        which case the wait continues until the replacement fills the slot
        or the timeout expires.  ``generation`` additionally requires the
        roster generation to have reached that value (wait out a specific
        membership change).
        """
        deadline = time.time() + timeout
        # Hang flight recorder: a bring-up stalled for half its budget (or
        # 60 s, whichever is sooner) dumps all-thread stacks + roster state
        # once, so a silent AWAIT hang leaves an attributable report even if
        # nobody gets to send SIGUSR1 before the timeout fires.
        watch = telemetry.StallWatch(
            "await_reservations stalled",
            deadline=min(timeout * 0.5, 60.0) if timeout else 60.0,
            extra_fn=lambda: {
                "registered": (self.reservations.required
                               - self.reservations.remaining()),
                "required": self.reservations.required,
                "generation": self.reservations.generation,
                "dead_nodes": self.dead_nodes(),
                "released_slots": [
                    list(s) for s in self.reservations.released_slots()],
            })
        with telemetry.get_tracer().span(
                "reservation/await", required=self.reservations.required):
            while (not self.reservations.done()
                   or (generation is not None
                       and self.reservations.generation < generation)):
                if status and "error" in status:
                    raise Exception(
                        "Cluster startup failed on an executor: {}".format(status["error"])
                    )
                unrecovered = self._unrecovered_dead()
                if unrecovered:
                    raise Exception(
                        "Cluster startup failed: node(s) died during bring-up: "
                        "{}".format("; ".join(unrecovered)))
                if time.time() > deadline:
                    raise Exception(
                        "Timed out waiting for cluster reservations after {}s: "
                        "{} of {} nodes registered. Check executor logs; common causes "
                        "are insufficient executors or firewalled driver ports.".format(
                            timeout,
                            self.reservations.required - self.reservations.remaining(),
                            self.reservations.required,
                        )
                    )
                self.reservations.wait(timeout=1.0)
                watch.poke()
                logger.info(
                    "waiting for %d reservations", self.reservations.remaining()
                )
        logger.info("all %d reservations completed", self.reservations.required)
        return self.reservations.get()

    def _handle_message(self, sock, msg, parked):
        """Dispatch one client message (reference ``reservation.py:128-144``).

        Returns False if the connection should be closed.
        """
        mtype = msg.get("type")
        if mtype in ("REG", "HBEAT", "BYE", "STOP", "PROF"):
            # Mutating request: re-verify ledger ownership FIRST, so a
            # zombie primary never mutates in-memory state (and replies OK)
            # for a write its successor will not have.
            self._check_epoch()
        if self.superseded_by is not None:
            # "superseded" is a STRUCTURED marker, not just error text:
            # clients must tell this ERR (redial toward the successor)
            # from a liveness fence ERR (stop beating and terminate).
            self.send(sock, {
                "type": "ERR", "epoch": self.superseded_by,
                "superseded": self.superseded_by,
                "error": "coordinator superseded: epoch {} claimed the "
                         "ledger (this incarnation was epoch {}); redial "
                         "the promoted coordinator".format(
                             self.superseded_by, self.fencing_epoch)})
            return True
        if mtype == "REG":
            meta = msg["data"]
            # Zombie fence: a fenced executor_id must never re-enter the
            # roster, even into its own released slot — the replacement has
            # to be a FRESH identity, or a half-dead original racing its
            # replacement could double-claim the role.
            ex = meta.get("executor_id") if isinstance(meta, dict) else None
            if ex is not None and ex in self._dead:
                err = ("executor {} was fenced by the liveness monitor; a "
                       "replacement must register with a fresh identity"
                       .format(ex))
                logger.warning("rejecting registration: %s", err)
                self.send(sock, {"type": "ERR", "error": err})
                return True
            try:
                self.reservations.add(meta)
            except ValueError as e:
                logger.warning("rejecting registration: %s", e)
                self.send(sock, {"type": "ERR", "error": str(e)})
                return True
            self._watch(meta)
            # One record carries the admission AND the generation it
            # produced (replacement admissions bump it), so replay restores
            # both without re-deriving slot-claim order.
            self._journal({"t": "reg", "meta": meta,
                           "generation": self.reservations.generation})
            # Trace-context hop: the node started a flow before dialing
            # (node.run plants "trace_flow" in its meta); stepping it here
            # draws the Perfetto arrow node-register -> driver-admission
            # across the process boundary.
            flow = meta.get("trace_flow") if isinstance(meta, dict) else None
            if flow:
                telemetry.get_tracer().flow_step(
                    "reservation/register_flow", flow, leg="driver_admission",
                    executor_id=ex)
            telemetry.get_tracer().instant(
                "reservation/register",
                executor_id=(meta.get("executor_id")
                             if isinstance(meta, dict) else None),
                job_name=(meta.get("job_name")
                          if isinstance(meta, dict) else None),
                task_index=(meta.get("task_index")
                            if isinstance(meta, dict) else None),
                remaining=self.reservations.remaining())
            self.send(sock, {"type": "OK"})
        elif mtype == "HBEAT":
            data = msg.get("data") or {}
            executor_id = data.get("executor_id")
            if executor_id is None:
                self.send(sock, {"type": "ERR",
                                 "error": "HBEAT without executor_id"})
            elif self._beat(executor_id, metrics=data.get("metrics")):
                flow = data.get("trace_flow")
                if flow and executor_id not in self._hbeat_flow_seen:
                    # terminate the registration flow on the FIRST beat only:
                    # the arrow proves the heartbeat channel came up; one
                    # event per beat would just be ring-buffer pressure
                    self._hbeat_flow_seen.add(executor_id)
                    telemetry.get_tracer().flow_end(
                        "reservation/register_flow", flow, leg="first_hbeat",
                        executor_id=executor_id)
                reply = {"type": "OK"}
                # Capture fan-out: a pending profile request for this
                # executor rides the beat reply (poll marks it delivered,
                # so each node sees each capture exactly once).
                if self.profile_coordinator is not None:
                    try:
                        req = self.profile_coordinator.poll(executor_id)
                    except Exception:
                        logger.exception("profile coordinator poll failed")
                        req = None
                    if req:
                        reply["profile"] = req
                # Knob fan-out: pending live-knob updates for this executor
                # ride the same beat reply (poll marks them delivered, so
                # each node applies each push exactly once).
                if self.knob_coordinator is not None:
                    try:
                        knobs = self.knob_coordinator.poll(executor_id)
                    except Exception:
                        logger.exception("knob coordinator poll failed")
                        knobs = None
                    if knobs:
                        reply["knobs"] = knobs
                self.send(sock, reply)
            else:
                self.send(sock, {"type": "ERR",
                                 "error": "marked dead by the liveness "
                                          "monitor"})
        elif mtype == "BYE":
            data = msg.get("data") or {}
            executor_id = data.get("executor_id")
            if executor_id is not None:
                self._latch_metrics(executor_id, data.get("metrics"))
                self._forget(executor_id, reason=data.get("reason"))
                # Final counters ride the BYE record: a failover right
                # after a node finishes must not lose its totals.
                self._journal({"t": "bye", "executor": executor_id,
                               "reason": data.get("reason"),
                               "metrics": data.get("metrics")})
                telemetry.get_tracer().instant(
                    "reservation/bye", executor_id=executor_id,
                    reason=data.get("reason"))
            self.send(sock, {"type": "OK"})
        elif mtype == "PROF":
            # A node returning (or failing) a profile capture it was handed
            # on a HBEAT reply; the payload carries base64 artifact files.
            data = msg.get("data") or {}
            if self.profile_coordinator is None:
                self.send(sock, {"type": "ERR",
                                 "error": "no capture coordinator"})
            else:
                try:
                    self.profile_coordinator.receive(data)
                    self.send(sock, {"type": "OK"})
                except Exception as e:
                    logger.exception("profile artifact ingest failed")
                    self.send(sock, {"type": "ERR", "error": str(e)})
        elif mtype == "QUERY":
            self.send(sock, {"type": "QUERY", "done": self.reservations.done()})
        elif mtype == "QINFO":
            generation = self.reservations.generation
            if self.reservations.done():
                self.send(sock, {"type": "INFO",
                                 "data": self.reservations.get(),
                                 "generation": generation})
            else:
                self.send(sock, {"type": "INFO", "data": None,
                                 "generation": generation})
        elif mtype == "AWAIT":
            want_gen = (msg.get("data") or {}).get("generation") or 0
            if (self.reservations.done()
                    and self.reservations.generation >= want_gen):
                self.send(sock, {"type": "INFO",
                                 "data": self.reservations.get(),
                                 "generation": self.reservations.generation})
            elif sock not in parked:
                # answered when the roster completes at (or past) want_gen
                parked[sock] = want_gen
        elif mtype == "STOP":
            logger.info("stop requested by client")
            self.done = True
            self._journal({"t": "stop"})
            self.send(sock, {"type": "OK"})
        elif mtype == "STATE":
            # Coordinator-state probe (CI gates, operators, tests): one
            # read answers "who owns the ledger and what does it hold".
            res = self.reservations
            agg = {}
            for snap in self.metrics_snapshot().values():
                for k, v in snap.items():
                    if isinstance(v, (int, float)):
                        agg[k] = agg.get(k, 0) + v
            self.send(sock, {
                "type": "STATE",
                "generation": res.generation,
                "registered": res.required - res.remaining(),
                "required": res.required,
                "dead": dict(self._dead),
                "byes": dict(self._byes),
                "released": sorted(str(x) for x in self._released_ids),
                "done": bool(self.done),
                "metrics": agg,
                "ha": self.ha_status(),
            })
        else:
            logger.warning("ignoring unknown message type: %r", mtype)
            self.send(sock, {"type": "ERR", "error": "unknown message type"})
        return True

    def start(self):
        """Bind, spawn the daemon listener thread, return ``(host, port)``."""
        self._socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self._port is not None:
            port = int(self._port)
        else:
            port = int(os.environ.get(TFOS_SERVER_PORT, 0))
        self._socket.bind(("", port))
        self._socket.listen(64)
        host = self._host or os.environ.get(TFOS_SERVER_HOST)
        if not host:
            from tensorflowonspark_torch import util

            host = util.get_ip_address()
        addr = (host, self._socket.getsockname()[1])

        if self.journal_dir:
            # Claim the ledger BEFORE serving: the epoch bump fences any
            # prior incarnation, recovery restores its state, and only then
            # does the beacon advertise this address as primary.
            self.fencing_epoch = standby_mod.advance_epoch(self.journal_dir)
            self._recover()
            self._stamp_beacon(addr, force=True)

        def _listen():
            conns = [self._socket]
            parked = self._parked  # AWAIT conns waiting for roster completion
            # The listener must keep serving after a STOP message (self.done
            # only *signals* streaming termination; later feed tasks still
            # send STOP/QUERY) — only an explicit stop() winds it down.
            while not self._stopping:
                try:
                    readable, _, _ = select.select(conns, [], [], 0.2)
                except (OSError, ValueError):
                    break  # listen socket closed by stop()
                for sock in readable:
                    if sock is self._socket:
                        try:
                            client, _ = sock.accept()
                        except OSError:
                            continue  # listen socket closed by stop()
                        conns.append(client)
                    else:
                        try:
                            msg = self.receive(sock)
                            keep = self._handle_message(sock, msg, parked)
                        except (EOFError, OSError, ValueError):
                            keep = False
                        if not keep:
                            # Drop the fd from BOTH structures: a parked
                            # AWAIT whose peer disconnected is readable (EOF)
                            # and lands here — leaving it parked would leak
                            # the fd until roster completion on long bring-ups.
                            conns.remove(sock)
                            parked.pop(sock, None)
                            sock.close()
                if parked and self.reservations.done():
                    info = self.reservations.get()
                    generation = self.reservations.generation
                    for sock in [s for s, g in parked.items()
                                 if generation >= g]:
                        try:
                            self.send(sock, {"type": "INFO", "data": info,
                                             "generation": generation})
                        except OSError:
                            pass
                        del parked[sock]
                self._check_liveness()
                self._stamp_beacon(addr)
            # Teardown: close every accepted connection (parked AWAITs
            # included) so clients get a prompt EOF instead of hanging on
            # a dead coordinator until their own timeouts — a parked
            # waiter fails over to the endpoint list the moment its
            # connection resets.
            for sock in conns:
                if sock is not self._socket:
                    try:
                        sock.close()
                    except OSError:
                        pass
            parked.clear()

        self._thread = threading.Thread(
            target=_listen, name="reservation-server", daemon=True
        )
        self._thread.start()
        logger.info("reservation server listening on %s:%d", addr[0], addr[1])
        return addr

    def stop(self):
        """Ask the listener thread to wind down and close the listen socket."""
        self._stopping = True
        if self._socket is not None:
            # shutdown() BEFORE close(): the listener thread's select()
            # holds a kernel reference to the listen socket, so a bare
            # close() leaves the port accepting (then resetting)
            # connections for up to one poll timeout — long enough for a
            # failing-over client to waste a dial on the corpse.  shutdown
            # acts on the socket itself and refuses new connections
            # immediately.
            try:
                self._socket.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._socket.close()
            except OSError:
                pass
        with self._journal_lock:
            if self._journal_file is not None:
                try:
                    self._journal_file.close()
                except OSError:
                    pass
                self._journal_file = None


#: Default control-plane request timeout.  A finite default matters: with
#: ``timeout=None`` a ``register()``/``request_stop()`` against a server
#: process that died mid-request blocks its executor FOREVER (the socket
#: never EOFs through a half-open NAT path) — the whole cluster then hangs
#: on one node with no diagnosis.
DEFAULT_REQUEST_TIMEOUT = 30.0


#: Request types a client may transparently re-send on a fresh connection
#: after a reset: idempotent against the server ledger.  ``REG`` is NOT —
#: a duplicate registration is rejected by identity, so a REG whose reply
#: was lost must surface the error to the caller, not be blindly retried.
_IDEMPOTENT_TYPES = frozenset(
    {"HBEAT", "BYE", "QUERY", "QINFO", "STOP", "PROF", "STATE", "STATUS"})


class Client(MessageSocket):
    """Executor-side rendezvous client (reference ``reservation.py:205-272``).

    ``server_addr`` may be a single ``(host, port)`` / ``"host:port"`` or a
    LIST of endpoints — entry 0 the primary, later entries warm standbys at
    pre-agreed pinned ports.  On a connection reset (primary died) the
    client redials across the list and, for idempotent request types,
    transparently re-sends; replies carry the server's fencing epoch, and
    a reply with a LOWER epoch than the highest already seen is a zombie's
    — the client drops that connection and redials rather than trusting it.
    """

    def __init__(self, server_addr, retries=3, retry_delay=1.0,
                 request_timeout=DEFAULT_REQUEST_TIMEOUT):
        self.endpoints = normalize_endpoints(server_addr)
        self.server_addr = self.endpoints[0]
        self._retries = retries
        self._retry_delay = retry_delay
        self._request_timeout = request_timeout
        #: Highest fencing epoch observed in any reply (0 = un-journaled
        #: server, which never stamps one).
        self.last_epoch = 0
        #: Consecutive failed exchange attempts; RESET TO ZERO on every
        #: healthy request/reply, so transient resets spread over a long
        #: run can never exhaust the budget the way a cumulative counter
        #: would (the PR 13 ServiceFeed dial-budget fix, applied here).
        self._consecutive_failures = 0
        self._sock = self._connect()

    def _connect(self):
        from tensorflowonspark_torch import fault

        fault.from_env().delay_socket()
        last = None
        for attempt in range(self._retries + 1):
            # Walk the endpoint list in order each attempt: the primary
            # first, then the standbys at their pinned ports — after a
            # failover only the promoted standby accepts, so the walk
            # lands there.
            for ep in self.endpoints:
                sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                try:
                    sock.connect(ep)
                    self.server_addr = ep
                    return sock
                except OSError as e:  # reference retry-reconnect 227-240
                    last = e
                    sock.close()
            if attempt < self._retries:
                time.sleep(self._retry_delay * (attempt + 1))
        raise ConnectionError(
            "Unable to reach reservation server at {}: {}".format(
                ", ".join("{}:{}".format(h, p) for h, p in self.endpoints),
                last
            )
        )

    def _redial(self):
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = self._connect()

    def _demote_endpoint(self, ep):
        """Move a known-zombie endpoint to the END of the dial order.  A
        fenced zombie still ACCEPTS connections — without demotion the
        primary-first redial walk would keep landing on it and burn the
        whole redial budget answering its superseded-ERRs."""
        ep = tuple(ep)
        rest = [e for e in self.endpoints if tuple(e) != ep]
        if rest:
            self.endpoints = rest + [ep]

    #: Wire key carrying the server's fencing epoch in replies.  The
    #: dispatcher protocol overrides this ("fence_epoch") because its TASK
    #: replies already use "epoch" for the job's DATA epoch — reading a
    #: job epoch as a fencing epoch would fence healthy dispatchers.
    _fence_epoch_key = "epoch"

    def _check_reply_epoch(self, resp):
        """Track the highest fencing epoch seen; a reply stamped with a
        LOWER one came from a fenced zombie — refuse it (raise so the
        caller redials toward the successor)."""
        if not isinstance(resp, dict):
            return resp
        if resp.get("superseded"):
            # A fenced zombie answered: its successor owns the ledger.
            # This is a routing failure, NOT a liveness fence — raising a
            # connection error makes idempotent requests redial across the
            # endpoint list toward the promoted coordinator (the zombie
            # endpoint demoted so the walk reaches the successor first).
            self._demote_endpoint(self.server_addr)
            raise ConnectionError(
                "coordinator at {}:{} superseded by epoch {}".format(
                    self.server_addr[0], self.server_addr[1],
                    resp["superseded"]))
        epoch = resp.get(self._fence_epoch_key)
        if not isinstance(epoch, int):
            return resp
        if epoch < self.last_epoch:
            self._demote_endpoint(self.server_addr)
            raise ConnectionError(
                "reply from superseded coordinator (epoch {} < {})".format(
                    epoch, self.last_epoch))
        self.last_epoch = epoch
        return resp

    def _request(self, msg, timeout=_UNSET):
        if timeout is _UNSET:
            timeout = self._request_timeout
        redials = 1 + len(self.endpoints) if len(self.endpoints) > 1 else 0
        while True:
            self._sock.settimeout(timeout)
            try:
                self.send(self._sock, msg)
                resp = self._check_reply_epoch(self.receive(self._sock))
                self._consecutive_failures = 0
                return resp
            except socket.timeout:
                # A stalled (not dead) coordinator — SIGSTOP, GC pause,
                # partition — still completes TCP handshakes in the kernel,
                # so plain redialing would land right back on it.  Demote
                # the unresponsive endpoint and retry idempotent requests
                # toward the standbys, exactly like a reset.
                self._consecutive_failures += 1
                if redials > 0 and msg.get("type") in _IDEMPOTENT_TYPES:
                    redials -= 1
                    self._demote_endpoint(self.server_addr)
                    logger.warning(
                        "reservation request %s timed out after %ss; "
                        "redialing across %d endpoint(s)", msg.get("type"),
                        timeout, len(self.endpoints))
                    self._redial()
                    continue
                raise TimeoutError(
                    "reservation server at {}:{} did not answer a {} request "
                    "within {}s — the driver process may have died; check the "
                    "driver logs".format(self.server_addr[0],
                                         self.server_addr[1],
                                         msg.get("type"), timeout))
            except (ConnectionError, EOFError, OSError) as e:
                # Reset mid-exchange: the primary died (or a zombie
                # answered).  For idempotent types, redial across the
                # endpoint list and re-send — a promoted standby at a
                # pinned port answers the retry.
                self._consecutive_failures += 1
                if redials <= 0 or msg.get("type") not in _IDEMPOTENT_TYPES:
                    raise
                redials -= 1
                logger.warning(
                    "reservation request %s reset (%s); redialing across "
                    "%d endpoint(s)", msg.get("type"), e,
                    len(self.endpoints))
                self._redial()
            finally:
                try:
                    self._sock.settimeout(None)
                except OSError:
                    pass

    def register(self, meta):
        """Register this node's metadata (reference ``reservation.py:251-254``)."""
        resp = self._request({"type": "REG", "data": meta})
        if resp.get("type") != "OK":
            raise Exception("registration rejected: {}".format(
                resp.get("error", resp)))

    def heartbeat(self, executor_id, metrics=None, trace_flow=None):
        """Send one liveness beat; returns the (truthy) server reply dict on
        acceptance, or ``False`` if the server fenced this node (declared
        dead — the caller should stop beating and may choose to
        self-terminate rather than run as a zombie).  The reply may carry a
        ``"profile"`` key: a capture request fanned out by the driver's
        profile coordinator (see :class:`HeartbeatSender`).  ``metrics`` is
        an optional flat JSON dict of telemetry counters piggybacked on the
        beat (messages are JSON-only; see module docstring); ``trace_flow``
        is an optional flow id carrying the node's registration trace
        context (the server stitches it on the first beat)."""
        data = {"executor_id": executor_id}
        if metrics:
            data["metrics"] = metrics
        if trace_flow:
            data["trace_flow"] = trace_flow
        resp = self._request({"type": "HBEAT", "data": data})
        return resp if resp.get("type") == "OK" else False

    def profile_result(self, data, timeout=120.0):
        """Upload one capture's artifacts (``PROF``): ``data`` is the
        profiling-module payload (executor_id, capture_id, base64 files or
        an error).  A long explicit timeout — device traces are megabytes
        and must not be clipped by the beat-sized default."""
        resp = self._request({"type": "PROF", "data": data}, timeout=timeout)
        if resp.get("type") != "OK":
            raise Exception("profile upload rejected: {}".format(
                resp.get("error", resp)))

    def goodbye(self, executor_id, reason=None, metrics=None):
        """Clean liveness deregistration: this node is finishing on purpose,
        so the monitor must not read its silence as a death.  ``reason``
        (``done`` / ``preempted``) lets the driver tell clean completion
        from a preemption drain in ``tf_status``.  ``metrics`` carries the
        node's final telemetry counter snapshot — a node that finishes
        between beats would otherwise never report."""
        data = {"executor_id": executor_id}
        if reason is not None:
            data["reason"] = reason
        if metrics:
            data["metrics"] = metrics
        self._request({"type": "BYE", "data": data})

    def get_reservations(self):
        """Non-blocking roster query; None until complete."""
        resp = self._request({"type": "QINFO"})
        return resp.get("data")

    def get_generation(self):
        """Current roster generation (bumps on each replacement admission)."""
        resp = self._request({"type": "QINFO"})
        return resp.get("generation", 0)

    def await_reservations(self, timeout=600, generation=None):
        """Block until the roster is complete; returns cluster_info.

        Long-polls the server (single AWAIT request answered on completion)
        instead of the reference's 1 s reconnect loop (``reservation.py:261-267``).
        The AWAIT is sent exactly once; the client then waits on the socket —
        re-sending would double-park the connection server-side and could
        desync the message framing on a partial read.

        ``generation`` asks for a roster at (or past) that generation: the
        server holds the answer until the replacement admission that bumps
        the generation has landed, so a waiter observing a membership change
        never reads the pre-change roster back.
        """
        deadline = time.time() + timeout
        msg = {"type": "AWAIT"}
        if generation:
            msg["data"] = {"generation": generation}
        self.send(self._sock, msg)
        try:
            while True:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(
                        "Timed out awaiting cluster reservations after {}s".format(
                            timeout))
                self._sock.settimeout(min(remaining, 5.0))
                try:
                    resp = self.receive(self._sock)
                except socket.timeout:
                    continue  # roster still assembling; keep waiting
                except (EOFError, OSError):
                    # Parked connection reset: the coordinator died.  An
                    # AWAIT is a pure read, so re-parking on a fresh
                    # connection (the promoted standby, via the endpoint
                    # list) is safe — NOT the same as re-sending on a LIVE
                    # connection, which would double-park the fd.
                    if len(self.endpoints) <= 1:
                        raise
                    logger.warning("AWAIT connection reset; redialing the "
                                   "coordinator endpoint list")
                    self._redial()
                    self.send(self._sock, msg)
                    continue
                self._check_reply_epoch(resp)
                data = resp.get("data")
                if data is not None:
                    return data
        finally:
            try:
                self._sock.settimeout(None)
            except OSError:
                pass

    def state(self):
        """Full coordinator-state probe (``STATE``): generation, roster
        counts, dead/bye/released sets, aggregated node metrics, and the
        HA block (epoch, journal footprint) — what the CI chaos gate
        asserts exact totals against after a failover."""
        return self._request({"type": "STATE"})

    def request_stop(self):
        """Signal STOP (streaming termination / early stop; reference 269-272)."""
        resp = self._request({"type": "STOP"})
        assert resp.get("type") == "OK"

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class KnobCoordinator(object):
    """Pending live-knob updates, fanned out exactly-once per node on
    heartbeat replies (the ``PROF``/``reregister`` pattern).

    The autopilot calls :meth:`push` with a ``{knob: value}`` dict; the
    reservation server's HBEAT handler calls :meth:`poll` per beat and
    attaches the merged unseen pushes as ``reply["knobs"]``.  Each push
    carries a sequence number and each executor tracks the last sequence
    it drained, so a node sees every push exactly once regardless of when
    it registered — late joiners (and elastic replacements, which beat
    under a fresh identity) drain the full history and converge to the
    controller's current intent.  Thread-safe; values are opaque here.
    """

    def __init__(self, history=256):
        self._lock = threading.Lock()
        self._seq = 0
        self._pushes = []  # [(seq, {knob: value})], bounded
        self._seen = {}    # executor_id -> last drained seq
        self._history = int(history)

    def push(self, knobs, executor_id=None):
        """Queue ``knobs`` for every node (or one ``executor_id``).
        Returns the push's sequence number."""
        if not knobs:
            return self._seq
        with self._lock:
            self._seq += 1
            self._pushes.append((self._seq, dict(knobs), executor_id))
            del self._pushes[:-self._history]
            return self._seq

    def poll(self, executor_id):
        """Merged ``{knob: value}`` of every push this executor has not
        seen (newest wins per knob), or ``None``.  Marks them drained."""
        ex = str(executor_id)
        with self._lock:
            last = self._seen.get(ex, 0)
            merged = {}
            for seq, knobs, target in self._pushes:
                if seq <= last:
                    continue
                if target is not None and str(target) != ex:
                    continue
                merged.update(knobs)
            self._seen[ex] = self._seq
            return merged or None

    def current(self):
        """Newest-wins merge of every broadcast push (the controller's
        standing intent) — the ``/autopilot`` debugging view."""
        with self._lock:
            merged = {}
            for _seq, knobs, target in self._pushes:
                if target is None:
                    merged.update(knobs)
            return merged

    def to_state(self):
        """JSON-serializable full state (push history, per-executor drain
        positions, sequence counter) for coordinator snapshots — a
        recovered/promoted coordinator resumes exactly-once fan-out where
        the dead one stopped, instead of replaying or losing pushes."""
        with self._lock:
            return {"seq": self._seq,
                    "pushes": [[s, dict(k), t] for s, k, t in self._pushes],
                    "seen": dict(self._seen),
                    "history": self._history}

    @classmethod
    def from_state(cls, state):
        """Rebuild from :meth:`to_state` output."""
        kc = cls(history=state.get("history", 256))
        kc._seq = int(state.get("seq", 0))
        kc._pushes = [(int(s), dict(k), t)
                      for s, k, t in (state.get("pushes") or [])]
        kc._seen = {str(ex): int(seq)
                    for ex, seq in (state.get("seen") or {}).items()}
        return kc


class HeartbeatSender(object):
    """Daemon thread beating ``HBEAT`` to the reservation server.

    Runs *inside the process executing the user fn* — not the executor shell —
    so a SIGKILL of the training process silences the beats even though the
    executor (and its manager) survive; that silence is exactly what the
    driver-side monitor turns into a dead-node verdict.

    Failure stance: beats are best-effort.  A send error is retried with a
    fresh connection next tick (the server may be mid-restart); only a fence
    (``ERR`` answer: the monitor already declared us dead) stops the thread,
    because continuing to compute as a zombie would race the retried task.
    A clean ``stop()`` sends ``BYE`` so planned exits aren't counted as deaths.
    """

    def __init__(self, server_addr, executor_id, interval,
                 metrics_provider=None, trace_flow=None, on_profile=None,
                 on_reply=None):
        """``metrics_provider``: optional zero-arg callable returning a flat
        JSON-serializable counter dict to piggyback on each beat (errors are
        swallowed — metrics must never cost a liveness beat).
        ``trace_flow``: optional flow id (the node's registration trace
        context) piggybacked on beats; the server stitches the first one
        into the driver trace.
        ``on_profile``: optional ``fn(request) -> result_data`` handling a
        capture request fanned out on a beat reply (see
        ``profiling.handle_capture_request``).  It runs on a separate
        daemon thread — a capture takes seconds, and blocking the beat loop
        that long would fence the node — and its result is uploaded via
        :meth:`Client.profile_result` on a dedicated connection (the beat
        client is not thread-safe).  Requests are deduped by capture id.
        ``on_reply``: optional ``fn(reply_dict)`` called with every
        accepted beat's reply on the beat thread (servers piggyback
        hints there, e.g. the data-service dispatcher's ``reregister``
        after a restart).  Exceptions are swallowed — a reply hook must
        never cost a liveness beat; keep it fast or hand off to a
        thread."""
        self.server_addr = tuple(server_addr)
        self.executor_id = executor_id
        self.interval = interval
        self.metrics_provider = metrics_provider
        self.trace_flow = trace_flow
        self.on_profile = on_profile
        self.on_reply = on_reply
        self.fenced = False
        self._stop = threading.Event()
        self._client = None
        self._beats_sent = 0
        self._profiles_seen = set()  # capture ids already handed off
        self._thread = threading.Thread(
            target=self._run, name="heartbeat-sender", daemon=True)

    def start(self):
        if self.interval:
            self._thread.start()
        return self

    def _ensure_client(self):
        if self._client is None:
            self._client = Client(self.server_addr, retries=0,
                                  request_timeout=max(self.interval * 2, 5.0))
        return self._client

    def _drop_client(self):
        if self._client is not None:
            self._client.close()
            self._client = None

    def _run(self):
        from tensorflowonspark_torch import fault

        injector = fault.from_env()
        while not self._stop.wait(self.interval):
            self._beats_sent += 1
            if injector.should_drop_heartbeat(self._beats_sent):
                logger.warning("fault injection: dropping heartbeat %d",
                               self._beats_sent)
                continue
            metrics = None
            if self.metrics_provider is not None:
                try:
                    metrics = self.metrics_provider()
                except Exception as e:
                    logger.debug("heartbeat metrics provider failed: %s", e)
            try:
                resp = self._ensure_client().heartbeat(
                    self.executor_id, metrics=metrics,
                    trace_flow=self.trace_flow)
                if not resp:
                    logger.error(
                        "executor %s fenced by the liveness monitor; "
                        "stopping heartbeats", self.executor_id)
                    self.fenced = True
                    return
                if isinstance(resp, dict):
                    if resp.get("profile"):
                        self._maybe_capture(resp["profile"])
                    if self.on_reply is not None:
                        try:
                            self.on_reply(resp)
                        except Exception as e:
                            logger.debug("heartbeat on_reply hook failed: "
                                         "%s", e)
            except Exception as e:
                logger.warning("heartbeat failed (%s); will retry with a "
                               "fresh connection", e)
                self._drop_client()

    def _maybe_capture(self, request):
        """Hand a beat-reply capture request to ``on_profile`` on its own
        daemon thread (once per capture id); the result goes back as a PROF
        message over a fresh connection."""
        capture_id = (request or {}).get("capture_id")
        if (self.on_profile is None or not capture_id
                or capture_id in self._profiles_seen):
            return
        self._profiles_seen.add(capture_id)

        def _capture():
            try:
                result = self.on_profile(request)
            except Exception as e:
                logger.exception("profile capture failed")
                result = {"capture_id": capture_id, "error": repr(e)}
            if not isinstance(result, dict):
                result = {"capture_id": capture_id,
                          "error": "capture handler returned %r" % (result,)}
            result.setdefault("capture_id", capture_id)
            result["executor_id"] = self.executor_id
            client = None
            try:
                client = Client(self.server_addr, retries=1)
                client.profile_result(result)
            except Exception as e:
                logger.warning("profile upload failed: %s", e)
            finally:
                if client is not None:
                    client.close()

        threading.Thread(target=_capture, name="profile-capture",
                         daemon=True).start()

    def stop(self, goodbye=True, reason=None):
        """Stop beating; with ``goodbye`` also deregister from the monitor.
        ``reason`` (``done`` / ``preempted``) travels with the BYE so the
        driver can tell a preemption drain from ordinary completion."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=max(self.interval * 2, 5.0))
        if goodbye and not self.fenced and self.interval:
            metrics = None
            if self.metrics_provider is not None:
                try:
                    metrics = self.metrics_provider()
                except Exception:
                    pass
            try:
                self._ensure_client().goodbye(self.executor_id, reason=reason,
                                              metrics=metrics)
            except Exception as e:
                logger.warning("BYE failed (%s); the driver may log a "
                               "spurious dead node", e)
        self._drop_client()
