"""Coordinator HA primitives: fencing epochs, primary beacons, warm standby.

Both driver-side coordinators — the reservation rendezvous server
(:class:`~tensorflowonspark_torch.reservation.Server`) and the data-service
:class:`~tensorflowonspark_torch.dataservice.DispatcherServer` — journal their
ledgers (JSONL mutations + periodic snapshots) under a ``journal_dir``.
This module adds the three pieces that turn "restartable in place" into
"no single process whose death ends the run":

- **Fencing epoch** (``fencing-epoch.json``): a monotonically increasing
  integer advanced atomically (tmp+rename+fsync) by every coordinator
  incarnation that claims the journal dir — a restart-in-place and a
  standby promotion both bump it.  The incumbent re-reads the file before
  every ledger append (and on every mutating request): an epoch newer
  than its own means a successor claimed the ledger, so the incumbent
  fences itself — it stops journaling and answers every request with an
  ``ERR`` naming the superseding epoch.  A zombie primary therefore
  cannot split-brain the ledger, no matter how long it lingers.
- **Primary beacon** (``primary-beacon.json``): the serving coordinator
  re-stamps this file every ``beacon interval`` with its epoch and
  advertised address.  The file's mtime is the liveness signal a standby
  watches; its content is diagnostic.
- **:class:`WarmStandby`**: a watcher that tails the beacon and, once it
  goes silent past ``takeover_after`` seconds, *promotes*: builds a fresh
  coordinator from the injected factory, whose ``start()`` advances the
  fencing epoch and recovers the ledger from the journal.  Clients reach
  the promoted coordinator through endpoint-list discovery (every
  control-plane client accepts a list of ``(host, port)`` endpoints and
  redials across it on a reset), so the standby's pinned port is simply
  the second entry of that list.

The tf.data-service disaggregation argument (PAPERS.md arXiv:2210.14826)
only pays off when the control plane is as survivable as the workers it
coordinates; this is the survivability half.  See
docs/FAULT_TOLERANCE.md ("Coordinator HA") for the takeover timeline and
the fencing rules.
"""

import json
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

#: Fencing-epoch file name inside a coordinator journal dir.
EPOCH_FILE = "fencing-epoch.json"
#: Primary-beacon file name inside a coordinator journal dir.
BEACON_FILE = "primary-beacon.json"


def read_epoch(journal_dir):
    """Current fencing epoch recorded in ``journal_dir`` (0 when the dir
    has never been claimed, or the file is unreadable/garbled)."""
    try:
        with open(os.path.join(journal_dir, EPOCH_FILE)) as f:
            return int(json.load(f).get("epoch", 0))
    except (OSError, ValueError, TypeError, AttributeError):
        return 0


def advance_epoch(journal_dir, pid=None):
    """Claim the ledger: bump the fencing epoch atomically and return the
    new value.  Every coordinator incarnation (first start, restart in
    place, standby promotion) calls this exactly once before recovering,
    so the previous incarnation — should it still be alive — observes a
    newer epoch on its next ownership check and fences itself."""
    os.makedirs(journal_dir, exist_ok=True)
    epoch = read_epoch(journal_dir) + 1
    path = os.path.join(journal_dir, EPOCH_FILE)
    tmp = path + ".tmp.{}".format(os.getpid())
    with open(tmp, "w") as f:
        json.dump({"epoch": epoch, "pid": pid or os.getpid(),
                   "time": time.time()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return epoch


def write_beacon(journal_dir, epoch, host=None, port=None, role=None):
    """Stamp the primary beacon (atomic tmp+rename; the *mtime* is the
    liveness signal, so no fsync — losing one stamp costs one interval).
    Best-effort: a beacon failure must never take the coordinator down."""
    path = os.path.join(journal_dir, BEACON_FILE)
    tmp = path + ".tmp.{}".format(os.getpid())
    try:
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "host": host, "port": port,
                       "role": role, "pid": os.getpid(),
                       "time": time.time()}, f)
        os.replace(tmp, path)
    except OSError as e:
        logger.warning("primary beacon stamp failed: %s", e)


def read_beacon(journal_dir):
    """The beacon's content dict, or ``None`` when absent/unreadable."""
    try:
        with open(os.path.join(journal_dir, BEACON_FILE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def beacon_age(journal_dir):
    """Seconds since the primary last stamped its beacon, or ``None`` when
    no primary ever claimed this journal dir."""
    try:
        mtime = os.stat(os.path.join(journal_dir, BEACON_FILE)).st_mtime
    except OSError:
        return None
    return max(0.0, time.time() - mtime)


class WarmStandby(object):
    """Tail a coordinator journal dir; promote when the primary goes silent.

    Args:
      factory: zero-arg callable building an UNSTARTED coordinator bound to
        the same ``journal_dir`` (and, for discoverability, a pre-agreed
        pinned port).  Its ``start()`` must advance the fencing epoch and
        recover the ledger — both :class:`reservation.Server` and
        :class:`dataservice.DispatcherServer` do when ``journal_dir`` is
        set.  Called exactly once, at promotion.
      journal_dir: the primary's journal dir (beacon + epoch + ledger).
      takeover_after: beacon silence (seconds) before promotion.  Size it
        above the primary's beacon interval times a few, the way
        ``heartbeat_misses`` sizes node fencing; too low and a GC pause
        causes a spurious — but safe, thanks to fencing — takeover.
      poll_interval: beacon poll cadence.
      on_promote: optional ``fn(server, (host, port))`` fired after the
        promoted coordinator is serving (e.g. print the new endpoint).
      name: label for logs/telemetry (``"reservation"``/``"dispatcher"``).

    A standby never promotes before a primary has stamped the beacon at
    least once (an empty journal dir is nothing to take over); a beacon
    that exists but is stale — the primary died before the standby even
    started — is taken over after ``takeover_after`` like any other
    silence.  Promotion is one-shot: the promoted coordinator IS the new
    primary (it stamps the beacon itself), and this watcher retires.
    """

    def __init__(self, factory, journal_dir, takeover_after=2.0,
                 poll_interval=0.2, on_promote=None, name="coordinator"):
        self.factory = factory
        self.journal_dir = journal_dir
        self.takeover_after = float(takeover_after)
        self.poll_interval = float(poll_interval)
        self.on_promote = on_promote
        self.name = name
        self.server = None       # the promoted coordinator (post-takeover)
        self.address = None      # its (host, port)
        self.promote_error = None
        self._promoted = threading.Event()
        self._stop = threading.Event()
        self._thread = None

    @property
    def promoted(self):
        return self._promoted.is_set()

    def start(self):
        """Start the beacon-tail thread (idempotent); returns self."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="warm-standby-{}".format(self.name),
            daemon=True)
        self._thread.start()
        logger.info("%s warm standby armed on %s (takeover after %.1fs of "
                    "beacon silence)", self.name, self.journal_dir,
                    self.takeover_after)
        return self

    def _run(self):
        while not self._stop.wait(self.poll_interval):
            age = beacon_age(self.journal_dir)
            if age is None:
                continue  # no primary yet: nothing to take over
            if age <= self.takeover_after:
                continue
            try:
                self.promote("beacon silent {:.1f}s".format(age))
            except Exception as e:  # stay armed: the primary may come back
                self.promote_error = repr(e)
                logger.exception("%s standby promotion failed; re-arming",
                                 self.name)
                continue
            return

    def promote(self, reason="manual"):
        """Take over NOW: build the coordinator (``start()`` bumps the
        fencing epoch, recovers the ledger, and begins stamping the
        beacon) and return its ``(host, port)``.  Public so operators and
        tests can force a failover without waiting out the silence."""
        logger.warning("%s standby promoting (%s)", self.name, reason)
        from tensorflowonspark_torch import telemetry

        t0 = time.monotonic()
        server = self.factory()
        addr = server.start()
        self.server, self.address = server, tuple(addr)
        self._promoted.set()
        took = time.monotonic() - t0
        logger.warning("%s standby promoted on %s:%d in %.3fs (epoch %s)",
                       self.name, addr[0], addr[1], took,
                       getattr(server, "fencing_epoch", "?"))
        telemetry.get_tracer().instant(
            "standby/promote", coordinator=self.name, reason=reason,
            host=addr[0], port=addr[1], secs=round(took, 4),
            epoch=getattr(server, "fencing_epoch", None))
        if self.on_promote is not None:
            try:
                self.on_promote(server, self.address)
            except Exception:
                logger.exception("on_promote callback failed")
        return self.address

    def wait_promoted(self, timeout=None):
        """Block until promotion happened; returns promoted-ness."""
        return self._promoted.wait(timeout)

    def stop(self):
        """Disarm the watcher; a promoted coordinator keeps serving (stop
        it via ``standby.server.stop()``)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
