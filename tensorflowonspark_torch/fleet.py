"""Model fleet control plane of the port (the counterpart of
:mod:`tensorflowonspark_tpu.fleet`): registry, router, canary rollout,
train-to-serve handoff.

The reference framework's inference layer (``TFModel.transform``) was a
single-model batch engine — no versions, no routing, no continuous
learning.  This module is the serving control plane layered over the
gateway (:mod:`tensorflowonspark_torch.gateway`):

- :class:`ModelRegistry` — versioned manifest store.  Each ``(model,
  version)`` entry pins a validated export directory, its model_config,
  an optional warm dir, and a lifecycle status (:data:`STATUSES`,
  ``staging -> canary -> live -> retired``).  Every mutation appends to a
  flush-per-write JSONL journal so the registry rebuilds from disk after a
  driver crash, tolerating a torn final line.  The journal's records are
  the JAX package's field for field: either package reads the other's.
  Concurrent publishes of the same version elect a single winner through
  an ``O_CREAT|O_EXCL`` marker file — the loser gets
  :class:`PublishConflict`, never a silent overwrite.
- :class:`FleetRouter` — the admission/routing brain split out of
  ``GatewayServer``.  Maps ``(model, version-or-default)`` to the replica
  set derived from the roster's ``job_name="serving"`` registrations
  (replicas register with ``model``/``model_version`` meta), sheds with
  typed ``unknown_model`` / ``no_capacity`` codes, enforces a per-model
  admission budget so one hot model cannot starve the rest, and spreads
  load power-of-two-choices over healthy replicas, counting picks.
- :class:`CanaryController` — guardrails-vocabulary rollout loop.  A
  staging version is proposed as a canary on ONE replica (the
  ``serving_load_version`` knob rides the heartbeat reply, so the swap is
  an in-place weight copy with no rebuild — see
  ``ModelServer.swap_export``), watched through the version-labeled
  error-rate / nonfinite windows, then auto-promoted to live on clean
  windows or auto-rolled-back on burn.  Every stage is journaled and
  :func:`replay_journal` re-derives the decision stream offline
  (``scripts/metrics_replay_torch.py --kind fleet``).
- :func:`publish_trained` — the train-to-serve handoff:
  ``fit_supervised(publish=...)`` exports its final validated params
  straight into the registry as a staging version, which the canary
  controller walks to live with no operator in the loop.

A registry entry's ``warm_dir`` is recorded and served back as the JAX
package does; a replica that resolves the entry (``inference_cli
--registry``) takes it as its warm-start root unless ``--warm-cache-dir``
names one (:mod:`~tensorflowonspark_torch.compilecache`), and
:func:`publish_trained` passes a spec's ``warm_dir`` through.
"""

import json
import logging
import os
import random
import threading
import time

from .guardrails import Guardrails, JsonlJournal
from .watchtower import json_safe

logger = logging.getLogger(__name__)

#: version lifecycle, in promotion order
STATUSES = ("staging", "canary", "live", "retired")

#: typed shed codes the router adds to the gateway's vocabulary
ROUTER_SHEDS = ("unknown_model", "no_capacity")


class PublishConflict(RuntimeError):
    """A concurrent publisher already won ``(model, version)``."""


class SwapRefused(ValueError):
    """A live swap was refused (incompatible params/signature: applying
    it would rebuild the model or corrupt outputs)."""


def _check_name(kind, value):
    value = str(value)
    if not value or any(c in value for c in "/\\\0\n@"):
        raise ValueError("invalid {} name {!r}".format(kind, value))
    return value


def read_registry_journal(path):
    """Parse a registry journal, stopping at the first torn/garbled line.

    Unlike the watchtower journal (independent snapshot records, skipping
    a bad line is safe), registry records are ordered state transitions:
    everything AFTER a torn line is untrusted, so replay stops there.  A
    crash mid-append therefore loses at most the record being written.
    """
    records = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    logger.warning("%s: torn journal tail; replay stops at "
                                   "record %d", path, len(records))
                    break
                if isinstance(rec, dict):
                    records.append(rec)
    except FileNotFoundError:
        pass
    return records


class ModelRegistry(object):
    """Versioned model manifest store with a crash-safe JSONL journal.

    The journal at ``<root>/registry.jsonl`` is the source of truth;
    construction replays it (torn tail tolerated) into memory.  Publishes
    are made atomic across *processes* by an ``O_CREAT|O_EXCL`` marker
    under ``<root>/.published/`` — exactly one publisher of a given
    ``(model, version)`` wins, all others raise :class:`PublishConflict`.
    """

    def __init__(self, root, publisher=None, clock=time.time):
        self.root = os.path.abspath(str(root))
        os.makedirs(self.root, exist_ok=True)
        self.publisher = publisher or "pid-{}".format(os.getpid())
        self._clock = clock
        self._lock = threading.RLock()
        #: model -> {"versions": {v: entry}, "order": [v, ...], "default": v}
        self._models = {}
        self.journal_path = os.path.join(self.root, "registry.jsonl")
        fresh = not os.path.exists(self.journal_path)
        for rec in read_registry_journal(self.journal_path):
            self._apply(rec)
        self._journal = JsonlJournal(self.journal_path, owner="fleet-registry")
        if fresh:
            self._journal.write({"kind": "meta", "registry": True,
                                 "version": 1, "time": self._clock()})

    # -- journal replay ----------------------------------------------------

    def _apply(self, rec):
        kind = rec.get("kind")
        if kind == "publish":
            slot = self._models.setdefault(
                rec["model"], {"versions": {}, "order": [], "default": None})
            if rec["version"] in slot["versions"]:
                return  # duplicate journal line; first publish won
            slot["versions"][rec["version"]] = {
                k: rec.get(k) for k in
                ("model", "version", "export_dir", "model_config",
                 "warm_dir", "status", "time", "publisher")}
            slot["order"].append(rec["version"])
            if rec.get("status") == "live":
                slot["default"] = rec["version"]
        elif kind == "status":
            slot = self._models.get(rec.get("model"))
            entry = (slot or {"versions": {}})["versions"].get(
                rec.get("version"))
            if entry is None:
                return
            entry["status"] = rec["status"]
            if rec["status"] == "live":
                slot["default"] = rec["version"]
            elif slot["default"] == rec["version"]:
                slot["default"] = rec.get("default")

    # -- writes ------------------------------------------------------------

    @staticmethod
    def validate_export(export_dir):
        """An export is publishable iff its descriptor and its params file
        (:func:`~tensorflowonspark_torch.checkpoint.export_model`'s layout)
        exist."""
        from . import checkpoint

        desc = os.path.join(export_dir, checkpoint._DESCRIPTOR)
        params = os.path.join(export_dir, checkpoint._PARAMS_FILE)
        if not os.path.isfile(desc) or not os.path.isfile(params):
            raise ValueError(
                "not a valid export (missing {}/{}): {}".format(
                    checkpoint._DESCRIPTOR, checkpoint._PARAMS_FILE,
                    export_dir))

    def publish(self, model, version, export_dir, model_config=None,
                warm_dir=None, status="staging", validate=True):
        """Publish ``(model, version)`` pinning ``export_dir``.  Exactly one
        concurrent publisher wins (O_EXCL marker); losers raise
        :class:`PublishConflict`.  Returns the journaled entry."""
        model = _check_name("model", model)
        version = _check_name("version", version)
        if status not in STATUSES:
            raise ValueError("bad status {!r}".format(status))
        export_dir = os.path.abspath(str(export_dir))
        if validate:
            self.validate_export(export_dir)
        marker_dir = os.path.join(self.root, ".published")
        os.makedirs(marker_dir, exist_ok=True)
        marker = os.path.join(marker_dir, "{}@{}".format(model, version))
        try:
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            raise PublishConflict(
                "{}@{} already published".format(model, version))
        try:
            os.write(fd, self.publisher.encode())
        finally:
            os.close(fd)
        with self._lock:
            rec = {"kind": "publish", "model": model, "version": version,
                   "export_dir": export_dir,
                   "model_config": json_safe(model_config),
                   "warm_dir": warm_dir, "status": status,
                   "time": self._clock(), "publisher": self.publisher}
            self._apply(rec)
            self._journal.write(rec)
            logger.info("registry: published %s@%s (%s) -> %s", model,
                        version, status, export_dir)
            return dict(self._models[model]["versions"][version])

    def set_status(self, model, version, status, reason=None):
        """Move ``(model, version)`` to ``status``.  Promoting to ``live``
        retires the previous live version and flips the model's default;
        retiring the default clears it (callers re-promote explicitly)."""
        if status not in STATUSES:
            raise ValueError("bad status {!r}".format(status))
        with self._lock:
            slot = self._models.get(model)
            if not slot or version not in slot["versions"]:
                raise KeyError("{}@{} not in registry".format(model, version))
            if status == "live":
                prev = slot["default"]
                if prev and prev != version and (
                        slot["versions"][prev]["status"] == "live"):
                    self._write_status(model, prev, "retired",
                                       reason="superseded by {}".format(
                                           version))
            self._write_status(model, version, status, reason=reason)
            return dict(slot["versions"][version])

    def _write_status(self, model, version, status, reason=None):
        rec = {"kind": "status", "model": model, "version": version,
               "status": status, "reason": reason, "time": self._clock()}
        self._apply(rec)
        self._journal.write(rec)
        logger.info("registry: %s@%s -> %s%s", model, version, status,
                    " ({})".format(reason) if reason else "")

    # -- reads -------------------------------------------------------------

    def resolve(self, model, version=None):
        """Entry for ``(model, version-or-default)``.  ``KeyError`` when the
        model is unknown; ``LookupError`` when it has no default (no live
        version yet) and no version was pinned."""
        with self._lock:
            slot = self._models.get(model)
            if slot is None:
                raise KeyError("unknown model {!r}".format(model))
            if version is None:
                version = slot["default"]
                if version is None:
                    raise LookupError(
                        "model {!r} has no live version".format(model))
            entry = slot["versions"].get(str(version))
            if entry is None:
                raise KeyError("{}@{} not in registry".format(model, version))
            return dict(entry)

    def versions(self, model):
        """Entries of ``model`` in publish order (copies)."""
        with self._lock:
            slot = self._models.get(model, {"versions": {}, "order": []})
            return [dict(slot["versions"][v]) for v in slot["order"]]

    def default_version(self, model):
        with self._lock:
            slot = self._models.get(model)
            return slot["default"] if slot else None

    def models(self):
        with self._lock:
            return sorted(self._models)

    def snapshot(self):
        """JSON-safe full registry state (``/fleet`` surface)."""
        with self._lock:
            return {m: {"default": slot["default"],
                        "versions": [dict(slot["versions"][v])
                                     for v in slot["order"]]}
                    for m, slot in self._models.items()}

    def close(self):
        self._journal.close()


class _Lease(object):
    """Admission lease: releases the per-model in-flight slot on exit."""

    def __init__(self, router, model):
        self._router = router
        self.model = model
        self._done = False

    def release(self):
        if not self._done:
            self._done = True
            self._router._release(self.model)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class FleetRouter(object):
    """Maps ``(model, version-or-default)`` to a replica, with typed sheds.

    The replica table is fed from roster ``job_name="serving"`` rows
    (:meth:`sync_roster`) whose registrations carry ``model`` /
    ``model_version`` meta, and reconciled live from heartbeat metric
    strings as replicas swap versions (:meth:`note_version`).  Admission
    is budgeted per model (``admit``), canary traffic is split by
    version weight (``set_split``), and within a version the replica is
    chosen power-of-two-choices by in-flight depth — picks are counted
    per replica so balance is observable.
    """

    def __init__(self, registry=None, budget_per_model=256, seed=0x51EE7):
        self.registry = registry
        self.budget_per_model = int(budget_per_model)
        self._lock = threading.Lock()
        self._replicas = {}   # rid -> {model, version, addr, healthy}
        self._split = {}      # model -> {version: weight}
        self._inflight = {}   # rid -> depth
        self._model_inflight = {}
        self.picks = {}       # rid -> routed count
        self.admitted = {}    # model -> admitted count
        self.shed = {code: 0 for code in ROUTER_SHEDS}
        self._rng = random.Random(seed)

    # -- replica table -----------------------------------------------------

    def register_replica(self, replica_id, addr, model, version):
        with self._lock:
            self._replicas[replica_id] = {
                "model": str(model), "version": str(version),
                "addr": addr, "healthy": True}

    def sync_roster(self, rows):
        """Rebuild the table from roster rows (``job_name == "serving"``).
        Rows without model meta land under model ``"default"`` so pre-fleet
        replicas stay routable."""
        table = {}
        for m in rows or []:
            if not isinstance(m, dict) or m.get("job_name") != "serving":
                continue
            rid = m.get("executor_id")
            if rid is None or m.get("host") is None:
                continue
            table[rid] = {
                "model": str(m.get("model") or "default"),
                "version": str(m.get("model_version") or "0"),
                "addr": "{}:{}".format(m["host"], m["port"]),
                "healthy": True}
        with self._lock:
            for rid, row in table.items():
                old = self._replicas.get(rid)
                if old is not None:
                    row["healthy"] = old["healthy"]
            self._replicas = table

    def note_version(self, replica_id, version):
        """Record a confirmed live swap (heartbeat metrics reconcile)."""
        with self._lock:
            row = self._replicas.get(replica_id)
            if row is not None and row["version"] != str(version):
                row["version"] = str(version)

    def set_health(self, replica_id, healthy):
        with self._lock:
            row = self._replicas.get(replica_id)
            if row is not None:
                row["healthy"] = bool(healthy)

    def replicas(self, model=None, version=None, healthy_only=False):
        with self._lock:
            out = {}
            for rid, row in self._replicas.items():
                if model is not None and row["model"] != model:
                    continue
                if version is not None and row["version"] != str(version):
                    continue
                if healthy_only and not row["healthy"]:
                    continue
                out[rid] = dict(row)
            return out

    # -- canary split ------------------------------------------------------

    def set_split(self, model, weights):
        """Weighted version split for ``model`` (``{version: weight}``);
        ``None``/empty clears back to default-version routing."""
        with self._lock:
            if weights:
                self._split[model] = {str(v): float(w)
                                      for v, w in weights.items() if w > 0}
            else:
                self._split.pop(model, None)

    # -- admission ---------------------------------------------------------

    def admit(self, model):
        """Admission lease for one request on ``model``; raises a typed
        ``no_capacity`` shed when the model's budget is exhausted (a hot
        model saturates its own budget, not the fleet's)."""
        from . import gateway
        with self._lock:
            depth = self._model_inflight.get(model, 0)
            if depth >= self.budget_per_model:
                self.shed["no_capacity"] += 1
                raise gateway.OverloadError(
                    "no_capacity",
                    "model {} at its admission budget ({} in flight)".format(
                        model, depth))
            self._model_inflight[model] = depth + 1
            self.admitted[model] = self.admitted.get(model, 0) + 1
        return _Lease(self, model)

    def _release(self, model):
        with self._lock:
            self._model_inflight[model] = max(
                0, self._model_inflight.get(model, 1) - 1)

    # -- routing -----------------------------------------------------------

    def _choose_version(self, model):
        """Caller holds the lock.  Split weights win; else registry
        default; else the single version present in the table."""
        split = self._split.get(model)
        if split:
            # drop weights whose version has no healthy replica so a
            # mid-swap canary never blackholes traffic
            viable = {v: w for v, w in split.items()
                      if any(r["model"] == model and r["version"] == v
                             and r["healthy"]
                             for r in self._replicas.values())}
            if viable:
                total = sum(viable.values())
                roll = self._rng.random() * total
                for v, w in viable.items():
                    roll -= w
                    if roll <= 0:
                        return v
                return next(iter(viable))
        if self.registry is not None:
            try:
                default = self.registry.default_version(model)
            except Exception:
                default = None
            if default:
                return default
        versions = {r["version"] for r in self._replicas.values()
                    if r["model"] == model and r["healthy"]}
        return next(iter(versions)) if len(versions) == 1 else None

    def route(self, model, version=None):
        """Pick a healthy replica for ``(model, version-or-default)``.

        Returns ``(replica_id, addr, version)``.  Sheds typed:
        ``unknown_model`` when neither the table nor the registry knows
        the model, ``no_capacity`` when the model is known but has no
        healthy replica of a routable version.
        """
        from . import gateway
        with self._lock:
            known = any(r["model"] == model
                        for r in self._replicas.values())
            if not known and self.registry is not None:
                known = model in self.registry.models()
            if not known:
                self.shed["unknown_model"] += 1
                raise gateway.OverloadError(
                    "unknown_model", "no such model {!r}".format(model))
            want = str(version) if version is not None else (
                self._choose_version(model))
            cands = [(rid, row) for rid, row in self._replicas.items()
                     if row["model"] == model and row["healthy"]
                     and (want is None or row["version"] == want)]
            if not cands and want is not None and version is None:
                # default version drained mid-swap: serve whatever healthy
                # replicas the model still has rather than shedding
                cands = [(rid, row) for rid, row in self._replicas.items()
                         if row["model"] == model and row["healthy"]]
            if not cands:
                self.shed["no_capacity"] += 1
                raise gateway.OverloadError(
                    "no_capacity",
                    "no healthy replica for {}@{}".format(
                        model, want or "default"))
            if len(cands) == 1:
                rid, row = cands[0]
            else:
                # power of two choices by in-flight depth
                a, b = self._rng.sample(cands, 2)
                rid, row = min(
                    (a, b), key=lambda c: self._inflight.get(c[0], 0))
            self._inflight[rid] = self._inflight.get(rid, 0) + 1
            self.picks[rid] = self.picks.get(rid, 0) + 1
            return rid, row["addr"], row["version"]

    def done(self, replica_id):
        """Return a routed request's replica slot (in-flight accounting)."""
        with self._lock:
            self._inflight[replica_id] = max(
                0, self._inflight.get(replica_id, 1) - 1)

    # -- surfaces ----------------------------------------------------------

    def counters(self):
        with self._lock:
            out = {"fleet_router_shed_unknown_model":
                       self.shed["unknown_model"],
                   "fleet_router_shed_no_capacity": self.shed["no_capacity"],
                   "fleet_router_requests": sum(self.picks.values())}
            for model, n in self.admitted.items():
                out["fleet_admitted_{}".format(model)] = n
            return out

    def status(self):
        with self._lock:
            return json_safe({
                "replicas": {rid: dict(row)
                             for rid, row in self._replicas.items()},
                "picks": dict(self.picks),
                "inflight": dict(self._inflight),
                "model_inflight": dict(self._model_inflight),
                "split": {m: dict(w) for m, w in self._split.items()},
                "admitted": dict(self.admitted),
                "shed": dict(self.shed),
                "budget_per_model": self.budget_per_model})


class FleetClient(object):
    """Multi-model HA client: admission + routing through a
    :class:`FleetRouter`, transport over per-address gateway channels.

    Channels are thread-local so concurrent caller threads don't
    serialize on one socket.  A transport failure marks the replica
    unhealthy in the router and retries elsewhere — the same
    zero-lost-accepted-requests contract as ``ServingClient``, extended
    across models and versions.
    """

    def __init__(self, router, timeout=30.0, client_id=None):
        self.router = router
        self.timeout = timeout
        self.client_id = client_id
        self._tls = threading.local()
        self.failovers = 0
        self.shed = 0

    def _channel(self, addr):
        from . import gateway
        chans = getattr(self._tls, "chans", None)
        if chans is None:
            chans = self._tls.chans = {}
        chan = chans.get(addr)
        if chan is None:
            chan = chans[addr] = gateway.GatewayChannel(
                addr, timeout=self.timeout, client_id=self.client_id)
        return chan

    def _drop(self, addr):
        chans = getattr(self._tls, "chans", None)
        if chans:
            chan = chans.pop(addr, None)
            if chan is not None:
                try:
                    chan.close()
                except OSError:
                    pass

    def predict(self, model, feed, count, version=None, deadline_ms=None):
        """Route + predict.  Raises ``OverloadError`` on typed sheds
        (``unknown_model`` / ``no_capacity`` from the router, or any
        gateway-side shed); transport failures fail over."""
        from . import gateway
        with self.router.admit(model):
            last = None
            for _ in range(max(2, len(self.router.replicas(model)) + 1)):
                rid, addr, _ver = self.router.route(model, version=version)
                chan = self._channel(addr)
                try:
                    return chan.predict(feed, count, deadline_ms=deadline_ms)
                except gateway.OverloadError as e:
                    self.shed += 1
                    raise
                except (OSError, EOFError, RuntimeError) as e:
                    last = e
                    self.failovers += 1
                    self.router.set_health(rid, False)
                    self._drop(addr)
                finally:
                    self.router.done(rid)
            raise (last if last is not None
                   else RuntimeError("no replica reachable"))

    def close(self):
        chans = getattr(self._tls, "chans", None) or {}
        for addr in list(chans):
            self._drop(addr)


#: canary controller defaults — windows sized for test/CI cadence; raise
#: interval/clean_windows for production rollouts
DEFAULT_CANARY_CONFIG = {
    "interval_secs": 0.5,        # tick period
    "canary_weight": 0.1,        # traffic share while in canary
    "clean_windows": 3,          # consecutive clean ticks to promote
    "min_requests": 5,           # a window needs this many to count
    "max_err_rate": 0.05,        # SLO-violation share that burns
    "confirm_windows": 2,        # burn streak before rollback (hysteresis)
    "cooldown_secs": 5.0,        # after a promote
    "revert_cooldown_secs": 30.0,  # after a rollback — don't retry a bad v
    "swap_timeout_secs": 30.0,   # knob pushed -> replica confirms
}


class CanaryController(object):
    """Walks staging versions to live through a canary stage, or back.

    Each tick: (1) reconcile the router's version table against the
    latest heartbeat metric strings; (2) if a canary is in flight, judge
    its version-labeled window (``serving_nonfinite`` delta > 0 is an
    instant rollback; SLO err-rate above ``max_err_rate`` bumps a
    confirm streak; enough clean windows promote); (3) otherwise scan
    the registry for the newest staging version not in cooldown and
    propose it — push the ``serving_load_version`` knob at ONE replica
    of the model, wait for the heartbeat-confirmed version flip, then
    split ``canary_weight`` of traffic onto it.

    ``metrics_fn`` returns ``{node: counters}`` (the reservation server's
    ``metrics_snapshot``); ``push_knobs(knobs, executor_id=)`` is the
    KnobCoordinator push.  All stages ride :class:`Guardrails`
    (one action in flight, confirm streaks, per-model cooldown) and the
    journal, so :func:`replay_journal` re-derives every decision.
    """

    def __init__(self, registry, router, metrics_fn=None, push_knobs=None,
                 config=None, journal_path=None, clock=time.time):
        self.registry = registry
        self.router = router
        self.metrics_fn = metrics_fn or (lambda: {})
        self.push_knobs = push_knobs or (lambda knobs, executor_id=None: None)
        self.config = dict(DEFAULT_CANARY_CONFIG)
        self.config.update(config or {})
        self._clock = clock
        self._guard = Guardrails(self.config["cooldown_secs"],
                                 self.config["revert_cooldown_secs"])
        self._journal = JsonlJournal(journal_path, owner="fleet-canary")
        self._journal.write({"kind": "meta", "canary": True, "version": 1,
                             "time": self._clock(),
                             "config": json_safe(self.config)})
        self._lock = threading.Lock()
        self._seq = 0
        self._alert_flags = []   # standing version-labeled alerts observed
        self.decisions = []      # (stage, model, version) history
        self._thread = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-canary")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._journal.close()

    def _run(self):
        while not self._stop.wait(self.config["interval_secs"]):
            try:
                self.tick()
            except Exception:
                logger.warning("canary tick failed", exc_info=True)

    # -- external signals --------------------------------------------------

    def observe_alert(self, alert):
        """Feed a watchtower alert; version-labeled ``slo_budget_burn`` /
        ``nonfinite`` alerts matching the in-flight canary count as an
        immediate violation window."""
        if not isinstance(alert, dict):
            return
        if alert.get("rule") not in ("slo_budget_burn", "nonfinite"):
            return
        with self._lock:
            self._alert_flags.append({
                "rule": alert.get("rule"),
                "model": alert.get("model"),
                "version": alert.get("version"),
                "executor": alert.get("executor")})
        self._journal.write({"kind": "alert", "time": self._clock(),
                             "rule": alert.get("rule"),
                             "model": alert.get("model"),
                             "version": alert.get("version"),
                             "executor": alert.get("executor")})

    # -- the control loop --------------------------------------------------

    def tick(self, now=None):
        now = self._clock() if now is None else now
        raw = self.metrics_fn() or {}
        if isinstance(raw.get("nodes"), dict):
            raw = raw["nodes"]  # reservation.Server.metrics_snapshot shape
        snapshot = {node: dict(c or {}) for node, c in raw.items()}
        self._reconcile(snapshot)
        self._journal.write({"kind": "sample", "time": now,
                             "nodes": self._sample_view(snapshot)})
        pend = self._guard.pending
        if pend is not None:
            self._advance(pend, snapshot, now)
        else:
            self._propose(now)

    @staticmethod
    def _sample_view(snapshot):
        """Journal only what replay needs: per-node model/version strings
        plus the SLO + nonfinite counters."""
        keep = ("serving_model", "serving_model_version", "serving_requests",
                "serving_slo_good", "serving_slo_total", "serving_nonfinite")
        return {node: {k: c[k] for k in keep if k in c}
                for node, c in snapshot.items() if "serving_model" in c}

    def _reconcile(self, snapshot):
        for node, c in snapshot.items():
            ver = c.get("serving_model_version")
            if ver is not None:
                self.router.note_version(node, ver)

    def _propose(self, now):
        """Scan for the newest staging version of a model not in cooldown
        and start its canary."""
        for model in self.registry.models():
            if self._guard.in_cooldown(model, now):
                continue
            staging = [e for e in self.registry.versions(model)
                       if e["status"] == "staging"]
            if not staging:
                continue
            entry = staging[-1]
            live = self.registry.default_version(model)
            replicas = self.router.replicas(model, healthy_only=True)
            if not replicas:
                continue  # nothing serving the model yet; wait
            # canary on one replica; prefer one running the live version
            target = next((rid for rid, row in sorted(replicas.items())
                           if live is None or row["version"] == live),
                          sorted(replicas)[0])
            prev_version = replicas[target]["version"]
            self._seq += 1
            token = "canary-{}-{}".format(entry["version"], self._seq)
            rec = {"kind": "stage", "stage": "proposed", "time": now,
                   "model": model, "version": entry["version"],
                   "prev_version": prev_version, "replica": target,
                   "token": token}
            self._journal.write(rec)
            self._guard.begin({
                "model": model, "version": entry["version"],
                "prev_version": prev_version, "replica": target,
                "token": token, "state": "swapping", "since": now,
                "clean": 0, "baseline": None})
            self.push_knobs(
                {"serving_load_version": {
                    "model": model, "version": entry["version"],
                    "export_dir": entry["export_dir"],
                    "token": token}},
                executor_id=target)
            logger.info("canary: proposed %s@%s on replica %s (prev %s)",
                        model, entry["version"], target, prev_version)
            return

    def _advance(self, pend, snapshot, now):
        model, version = pend["model"], pend["version"]
        node = snapshot.get(pend["replica"], {})
        if pend["state"] == "swapping":
            if str(node.get("serving_model_version")) == version:
                self.router.note_version(pend["replica"], version)
                live = self.registry.default_version(model)
                weight = self.config["canary_weight"]
                split = {version: weight}
                if live:
                    split[live] = 1.0 - weight
                self.router.set_split(model, split)
                self.registry.set_status(model, version, "canary")
                pend["state"] = "watching"
                pend["baseline"] = self._counters_of(node)
                self._journal.write({
                    "kind": "stage", "stage": "applied", "time": now,
                    "model": model, "version": version,
                    "replica": pend["replica"], "split": json_safe(split)})
            elif now - pend["since"] > self.config["swap_timeout_secs"]:
                self._rollback(pend, now, reason="swap_timeout")
            return
        # watching: judge the canary replica's window
        cur = self._counters_of(node)
        base = pend["baseline"] or cur
        pend["baseline"] = cur
        verdict = judge_window(base, cur, self.config,
                               alerts=self._drain_alerts(model, version))
        self._journal.write({"kind": "stage", "stage": "effect", "time": now,
                            "model": model, "version": version,
                            "replica": pend["replica"],
                            "window": json_safe(verdict)})
        if verdict["verdict"] == "violation":
            if (verdict.get("instant")
                    or self._guard.bump_streak(model)
                    >= self.config["confirm_windows"]):
                self._rollback(pend, now, reason=verdict["reason"])
            return
        self._guard.clear_streak(model)
        if verdict["verdict"] == "clean":
            pend["clean"] += 1
            if pend["clean"] >= self.config["clean_windows"]:
                self._promote(pend, now)

    @staticmethod
    def _counters_of(node):
        return {k: float(node.get(k, 0) or 0)
                for k in ("serving_slo_good", "serving_slo_total",
                          "serving_nonfinite")}

    def _drain_alerts(self, model, version):
        with self._lock:
            flags, self._alert_flags = self._alert_flags, []
        return [a for a in flags
                if (a.get("model") in (None, model))
                and (a.get("version") in (None, version))]

    def _promote(self, pend, now):
        model, version = pend["model"], pend["version"]
        entry = self.registry.resolve(model, version)
        # flip every other replica of the model, then the registry default
        for rid in sorted(self.router.replicas(model)):
            if rid == pend["replica"]:
                continue
            self._seq += 1
            self.push_knobs(
                {"serving_load_version": {
                    "model": model, "version": version,
                    "export_dir": entry["export_dir"],
                    "token": "promote-{}-{}".format(version, self._seq)}},
                executor_id=rid)
        self.registry.set_status(model, version, "live")
        self.router.set_split(model, None)
        self._journal.write({"kind": "stage", "stage": "kept", "time": now,
                            "model": model, "version": version,
                            "clean_windows": pend["clean"]})
        self.decisions.append(("kept", model, version))
        self._guard.settle()
        self._guard.start_cooldown(model, now)
        self._guard.clear_streak(model)
        logger.info("canary: promoted %s@%s to live", model, version)

    def _rollback(self, pend, now, reason):
        model, version = pend["model"], pend["version"]
        prev = pend["prev_version"]
        try:
            entry = self.registry.resolve(model, prev)
        except KeyError:
            entry = None
        if entry is not None:
            self._seq += 1
            self.push_knobs(
                {"serving_load_version": {
                    "model": model, "version": prev,
                    "export_dir": entry["export_dir"],
                    "token": "rollback-{}-{}".format(prev, self._seq)}},
                executor_id=pend["replica"])
        self.router.set_split(model, None)
        try:
            self.registry.set_status(model, version, "retired", reason=reason)
        except KeyError:
            pass
        self._journal.write({"kind": "stage", "stage": "reverted",
                            "time": now, "model": model, "version": version,
                            "reason": reason, "rolled_back_to": prev})
        self.decisions.append(("reverted", model, version))
        self._guard.settle()
        self._guard.start_cooldown(model, now, reverted=True)
        self._guard.clear_streak(model)
        logger.warning("canary: rolled back %s@%s (%s) to %s", model,
                       version, reason, prev)

    def status(self):
        now = self._clock()
        return json_safe({
            "pending": dict(self._guard.pending or {}) or None,
            "cooldowns": self._guard.cooldowns(now),
            "decisions": [{"stage": s, "model": m, "version": v}
                          for s, m, v in self.decisions]})


def judge_window(base, cur, config, alerts=()):
    """Pure canary-window verdict off two counter samples — the single
    decision function both the live controller and offline replay run,
    so journal replay cannot drift from production behavior.

    Returns ``{"verdict": "clean"|"violation"|"insufficient", ...}``.
    A nonfinite delta or a matching standing alert is an *instant*
    violation (no streak); an err-rate above ``max_err_rate`` with at
    least ``min_requests`` in the window is a streaked violation.
    """
    nonfinite = cur.get("serving_nonfinite", 0) - base.get(
        "serving_nonfinite", 0)
    total = cur.get("serving_slo_total", 0) - base.get("serving_slo_total", 0)
    good = cur.get("serving_slo_good", 0) - base.get("serving_slo_good", 0)
    if nonfinite > 0:
        return {"verdict": "violation", "instant": True,
                "reason": "nonfinite", "nonfinite": nonfinite}
    for a in alerts:
        if a.get("rule") == "nonfinite":
            return {"verdict": "violation", "instant": True,
                    "reason": "nonfinite_alert", "alert": a}
    if total < config["min_requests"]:
        return {"verdict": "insufficient", "requests": total}
    err_rate = max(0.0, (total - good) / total) if total else 0.0
    if err_rate > config["max_err_rate"]:
        return {"verdict": "violation", "instant": False,
                "reason": "err_rate", "err_rate": round(err_rate, 4),
                "requests": total}
    for a in alerts:
        return {"verdict": "violation", "instant": False,
                "reason": "burn_alert", "alert": a}
    return {"verdict": "clean", "err_rate": round(err_rate, 4),
            "requests": total}


# -- train-to-serve handoff -------------------------------------------------

def publish_trained(spec, params, step):
    """Publish a training run's final params to a registry as ``staging``.

    ``spec`` (the ``fit_supervised(publish=...)`` value)::

        {"registry": ModelRegistry-or-root-path, "model": name,
         "version": str (default "step-<N>"), "model_name": descriptor name,
         "model_config": {...}, "input_signature": {...},
         "warm_dir": path or None, "module": nn.Module or None}

    ``params`` is the trainer's full params (a ``state_dict``); a detached
    CPU copy is taken first.  The copy is
    finiteness-validated BEFORE export (a poisoned checkpoint must never
    enter the fleet — the quarantine discipline of ``restore_latest_valid``
    applied at the publish boundary), exported with
    ``checkpoint.export_model`` into the registry layout, and journaled as
    a staging version for the canary controller to walk to live.
    ``"module"`` (the JAX spec's ``flax_model``) is the ``nn.Module``
    passed to ``export_model(model=...)``: the published version then
    carries the exported artifact (``apply.pt2``) with the input
    signature.  Returns the registry entry.
    """
    from . import checkpoint

    model = _check_name("model", spec["model"])
    registry = spec["registry"]
    if not isinstance(registry, ModelRegistry):
        registry = ModelRegistry(registry)
    version = _check_name("version",
                          spec.get("version") or "step-{}".format(int(step)))
    host_params = {name: t.detach().to("cpu", copy=True)
                   for name, t in params.items()}
    bad = checkpoint._nonfinite_leaves(host_params)
    if bad:
        raise ValueError(
            "refusing to publish {}@{}: nonfinite leaves {}".format(
                model, version, bad[:4]))
    export_dir = spec.get("export_dir") or os.path.join(
        registry.root, model, version)
    checkpoint.export_model(
        export_dir, host_params,
        spec.get("model_name") or model,
        model_config=spec.get("model_config"),
        input_signature=spec.get("input_signature"),
        model=spec.get("module"))
    return registry.publish(model, version, export_dir,
                            model_config=spec.get("model_config"),
                            warm_dir=spec.get("warm_dir"),
                            status=spec.get("status", "staging"))


# -- offline replay ---------------------------------------------------------

def replay_journal(records, config=None):
    """Re-derive the canary decision stream from a journal.

    ``records`` is a path or a record list.  The replay runs the SAME
    :func:`judge_window` math the live controller ran, over the journaled
    per-tick samples, from each ``proposed``/``applied`` stage forward —
    so a promotion or rollback in the journal is *re-derivable*, not just
    recorded.  Returns::

        {"decisions": [...derived...], "journaled": [...from journal...],
         "matches": bool, "config": {...}}
    """
    from .watchtower import read_journal

    if isinstance(records, str):
        records = read_journal(records)
    cfg = dict(DEFAULT_CANARY_CONFIG)
    for rec in records:
        if rec.get("kind") == "meta" and rec.get("canary"):
            cfg.update(rec.get("config") or {})
    cfg.update(config or {})
    derived, journaled = [], []
    pend = None
    streak = 0
    alerts = []
    last_nodes = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "alert":
            alerts.append(rec)
        elif kind == "stage":
            stage = rec.get("stage")
            if stage in ("kept", "reverted"):
                journaled.append((stage, rec["model"], rec["version"]))
            if stage == "proposed":
                pend = {"model": rec["model"], "version": rec["version"],
                        "replica": rec["replica"], "state": "swapping",
                        "clean": 0, "baseline": None}
                streak = 0
            elif stage == "applied" and pend is not None:
                # the live controller seeded its baseline from the tick
                # that confirmed the swap — that tick's sample record was
                # written just before this stage record
                pend["state"] = "watching"
                node = last_nodes.get(pend["replica"])
                if node is not None:
                    pend["baseline"] = CanaryController._counters_of(node)
        elif kind == "sample":
            last_nodes = rec.get("nodes") or {}
            if pend is None:
                continue
            node = last_nodes.get(pend["replica"])
            if node is None or pend["state"] != "watching":
                continue
            cur = CanaryController._counters_of(node)
            if pend["baseline"] is None:
                pend["baseline"] = cur
                continue
            matched = [a for a in alerts
                       if a.get("model") in (None, pend["model"])
                       and a.get("version") in (None, pend["version"])]
            alerts = []
            verdict = judge_window(pend["baseline"], cur, cfg,
                                   alerts=matched)
            pend["baseline"] = cur
            if verdict["verdict"] == "violation":
                streak += 1
                if verdict.get("instant") or streak >= cfg["confirm_windows"]:
                    derived.append(("reverted", pend["model"],
                                    pend["version"]))
                    pend = None
                continue
            streak = 0
            if verdict["verdict"] == "clean":
                pend["clean"] += 1
                if pend["clean"] >= cfg["clean_windows"]:
                    derived.append(("kept", pend["model"], pend["version"]))
                    pend = None
    return {"decisions": derived, "journaled": journaled,
            "matches": derived == journaled, "config": cfg}
