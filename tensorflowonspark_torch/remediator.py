"""Remediator: the topology action plane that closes detect -> act (the
port's copy of the JAX package's ``remediator`` module).

The watchtower names the guilty executor and the autopilot
turns scalar knobs, but until now the only remediation path was
the liveness fence -> ``release_slot`` -> ``provision_replacement``
chain, which fires exclusively on outright death — a straggling,
NaN-poisoned, or saturated node degraded the run forever while the
alert log narrated.  This module subscribes to admitted watchtower
alerts (the existing ``on_alert`` bridge) and executes **topology**
actions under the same guardrail vocabulary the autopilot uses for
knobs (:mod:`~tensorflowonspark_torch.guardrails` — extracted, not
duplicated):

=====================  ==========================  =====================
action                 fired by                    machinery reused
=====================  ==========================  =====================
``evict_straggler``    persistent ``straggler_*``  graceful self-SIGTERM
                                                   (knob command) +
                                                   ``release_slot`` +
                                                   ``provision_replacement``
``rollback_poison``    ``nonfinite`` (crit)        ``train_rollback`` knob
                                                   -> ``PoisonRollback``
                                                   -> ``restore_latest_
                                                   valid`` (poison step
                                                   quarantined
                                                   ``<step>.corrupt``)
``scale_out_workers``  sustained ``dataservice_    spawn ``dataservice_
                       saturation``/``cache_       worker`` subprocesses
                       thrash``                    (dynamic WREG; cache
                                                   affinity absorbs them)
``scale_out_serving``  ``slo_budget_burn``         spawn a gateway
                                                   replica behind the
                                                   roster (AOT-warmed)
=====================  ==========================  =====================

Guardrails, in gating order: **confirm windows** (the watchtower's
``persists_windows`` streak — or the remediator's own, whichever is
larger — must reach the per-action threshold before a proposal is
minted), **one action in flight** (a second action is never considered
while one is settling, so effects stay attributable), **per-family
cooldown** (scale-out and scale-in share a family key, so the pair
cannot flap), **revert-on-regression** where the action is reversible
(a spawned worker/replica is retired when the objective regressed past
``revert_margin_frac``), and **dry-run** (proposes + journals, never
actuates).  Budgets bound every family: ``max_evictions``,
``max_rollbacks``, ``max_workers``, ``max_replicas``; idle windows
scale added workers/replicas back in, detaching cleanly so splits
re-bind.

Every action stage is journaled to a flush-per-write JSONL
(``<log_dir>/remediator/journal.jsonl``; ``proposed -> applied ->
effect -> kept/reverted``), counted into
``tfos_remediation_actions_total{action,stage}``, served on
``GET /remediations``, traced as ``remediator/<stage>`` instants, and
latched into ``tf_status["remediations"]``.  :func:`replay_journal`
re-derives the proposed-action stream offline from the journal's alert
and snapshot records (``scripts/metrics_replay_torch.py --kind remediator``).
See docs/FAULT_TOLERANCE.md ("Self-healing: the remediator").
"""

import inspect
import logging
import math
import os
import signal
import subprocess
import threading
import time

from . import telemetry
from .guardrails import Guardrails, JsonlJournal, STAGES  # noqa: F401
from .watchtower import read_journal, window_deltas

logger = logging.getLogger(__name__)

JOURNAL_VERSION = 1

def _alert_model_labels(alert):
    """``{"model", "version"}`` spawn substitutions off an alert's
    version labels (the watchtower stamps serving alerts with the
    replica's latched ``serving_model``/``serving_model_version``)."""
    if not isinstance(alert, dict):
        return None
    out = {}
    if alert.get("model") is not None:
        out["model"] = alert["model"]
    if alert.get("version") is not None:
        out["version"] = alert["version"]
    return out or None


#: watchtower rule -> action family
RULE_ACTIONS = {
    "nonfinite": "rollback_poison",
    "straggler_step_time": "evict_straggler",
    "straggler_dispatch_gap": "evict_straggler",
    "straggler_infeed": "evict_straggler",
    "dataservice_saturation": "scale_out_workers",
    "cache_thrash": "scale_out_workers",
    # slo_budget_burn superseded latency_slo_burn; the old name
    # stays mapped so journal replays of earlier runs still resolve
    "latency_slo_burn": "scale_out_serving",
    "slo_budget_burn": "scale_out_serving",
}

#: decision order within a tick: correctness before capacity
ACTION_PRIORITY = ("rollback_poison", "evict_straggler",
                   "scale_out_workers", "scale_out_serving")

#: scale-out/scale-in pairs share one cooldown family so they cannot flap
COOLDOWN_FAMILY = {
    "evict_straggler": "evict",
    "rollback_poison": "rollback",
    "scale_out_workers": "workers",
    "scale_in_workers": "workers",
    "scale_out_serving": "serving",
    "scale_in_serving": "serving",
}

#: actions whose applied effect can be rolled back (retire what we spawned)
REVERSIBLE = ("scale_out_workers", "scale_out_serving")

DEFAULT_CONFIG = {
    # control tick cadence and the sliding measurement window
    "interval_secs": 1.0,
    "window_secs": 15.0,
    # ticks between actuation and judging its effect
    "settle_ticks": 3,
    # per-family freeze after an action settles (longer after a revert)
    "cooldown_secs": 15.0,
    "revert_cooldown_secs": 60.0,
    # objective regression beyond this relative margin reverts a
    # reversible action (lower-is-better objectives, autopilot contract)
    "revert_margin_frac": 0.25,
    # propose + journal but never actuate
    "dry_run": False,
    # a standing alert older than this no longer justifies an action
    "alert_ttl_secs": 30.0,
    # consecutive watchtower windows (persists_windows, or the
    # remediator's own standing-alert streak) before each family acts —
    # eviction is destructive and waits longest; a crit nonfinite acts
    # on the first alert
    "confirm_windows": {"evict_straggler": 3, "rollback_poison": 1,
                        "scale_out_workers": 2, "scale_out_serving": 2,
                        "scale_in_workers": 1, "scale_in_serving": 1},
    # budgets: how much topology the remediator may change on its own
    "max_evictions": 2,
    "max_rollbacks": 2,
    "max_workers": 2,
    "max_replicas": 1,
    # quiet ticks (no standing alert for the family) before an ADDED
    # worker/replica is retired
    "scale_in_idle_windows": 8,
    # evict-family grace after a replacement is dispatched: the fresh
    # node compiles cold and must not be re-flagged while warming up
    "replacement_grace_secs": 30.0,
    # subprocess argv for the scale-out families; None disables the
    # family unless the wiring injects an actuator directly
    "worker_spawn_argv": None,
    "serving_spawn_argv": None,
    # bounded in-memory action log + journal snapshot cadence
    "max_actions": 64,
    "journal_snapshot_secs": 10.0,
}

_EPS = 1e-9


def _is_num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def merge_config(config):
    """Key-wise merge over :data:`DEFAULT_CONFIG`; unknown keys raise so a
    typo'd threshold fails loudly.  ``confirm_windows`` merges per-action
    (override one threshold without restating the rest)."""
    cfg = dict(DEFAULT_CONFIG)
    cfg["confirm_windows"] = dict(DEFAULT_CONFIG["confirm_windows"])
    for k, v in (config or {}).items():
        if k not in DEFAULT_CONFIG:
            raise ValueError("unknown remediator config key: %r (known: %s)"
                             % (k, ", ".join(sorted(DEFAULT_CONFIG))))
        if k == "confirm_windows":
            unknown = set(v or {}) - set(DEFAULT_CONFIG["confirm_windows"])
            if unknown:
                raise ValueError("unknown remediator confirm_windows "
                                 "action(s): %s" % sorted(unknown))
            cfg["confirm_windows"].update(v or {})
        else:
            cfg[k] = v
    return cfg


class _SubprocessPool(object):
    """Bookkeeping for the subprocesses a scale-out family spawned: spawn
    appends, retire pops newest-first (the revert contract: undo the
    thing just added), ``stop_all`` is the teardown sweep.  SIGTERM is
    the retire signal — both the ``dataservice_worker`` and gateway CLIs
    install clean-stop handlers that BYE/detach so splits and in-flight
    batches re-bind instead of fencing."""

    def __init__(self, argv, name):
        self.argv = list(argv) if argv else None
        self.name = name
        self._procs = []

    def size(self):
        self.reap()
        return len(self._procs)

    def reap(self):
        """Drop members that already exited (crashed or externally
        stopped) so budgets reflect live capacity."""
        self._procs = [p for p in self._procs if p.poll() is None]

    def spawn(self, subst=None):
        """Launch one member.  ``subst`` (e.g. ``{"model": ...,
        "version": ...}``) is substituted into ``{model}``-style argv
        placeholders, so a serving scale-out provisions capacity for the
        model the alert names — not a hardcoded one.  Placeholders with
        no substitution are left verbatim (an argv without placeholders
        is unchanged)."""
        if not self.argv:
            raise RuntimeError("no spawn argv configured for %s" % self.name)
        argv = self.argv
        if subst:
            class _Keep(dict):
                def __missing__(self, key):
                    return "{" + key + "}"
            safe = _Keep({k: str(v) for k, v in subst.items()
                          if v is not None})
            argv = [a.format_map(safe) if "{" in a else a for a in argv]
        proc = subprocess.Popen(argv)
        self._procs.append(proc)
        return {"pid": proc.pid, "argv": argv, "pool": self.name,
                "size": len(self._procs)}

    def retire_newest(self, timeout=5.0):
        self.reap()
        if not self._procs:
            return None
        proc = self._procs.pop()
        try:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=timeout)
        except Exception:
            try:
                proc.kill()
            except OSError:
                pass
        return {"pid": proc.pid, "pool": self.name,
                "size": len(self._procs)}

    def stop_all(self, timeout=5.0):
        while self._procs:
            self.retire_newest(timeout=timeout)


class Remediator(object):
    """Driver-side topology action plane over admitted watchtower alerts.

    Args:
      ring: the observatory :class:`~tensorflowonspark_torch.observatory.SampleRing`
        (anything with ``series()``), used only for the settle-window
        objective measurement — decisions act on alert payloads (the
        watchtower ships structured ``evidence`` exactly so the
        remediator never re-queries the ring to decide).
      actions: actuator callables injected by the wiring (tests inject
        stubs).  Recognized keys — ``evict`` ``fn(executor, alert) ->
        detail`` (fence + release + replace), ``rollback`` ``fn(executor,
        alert) -> detail`` (push the ``train_rollback`` knob),
        ``spawn_worker``/``retire_worker`` and ``spawn_replica``/
        ``retire_replica`` (default to :class:`_SubprocessPool` over the
        configured ``*_spawn_argv``).  A family with no actuator never
        proposes.
      snapshot_fn: journaled periodically so replay has the series.
      config: key-wise overrides of :data:`DEFAULT_CONFIG`.
      journal_path: flush-per-write JSONL; ``None`` disables.
      on_action: optional ``fn(record)`` per journaled action stage.
      clock: injectable time source (tests, replay).
    """

    def __init__(self, ring, actions=None, snapshot_fn=None, config=None,
                 journal_path=None, on_action=None, clock=time.time):
        self.config = merge_config(config)
        self.ring = ring
        self._snapshot_fn = snapshot_fn
        self._on_action = on_action
        self._clock = clock
        self.journal_path = journal_path
        self._journal = JsonlJournal(journal_path, owner="remediator")
        self._last_journal_snap = 0.0
        self.dry_run = bool(self.config["dry_run"])
        self._guard = Guardrails(self.config["cooldown_secs"],
                                 self.config["revert_cooldown_secs"])
        self._workers = _SubprocessPool(self.config["worker_spawn_argv"],
                                        "workers")
        self._replicas = _SubprocessPool(self.config["serving_spawn_argv"],
                                         "serving")
        acts = dict(actions or {})
        acts.setdefault("spawn_worker",
                        (lambda: self._workers.spawn())
                        if self._workers.argv else None)
        acts.setdefault("retire_worker",
                        (lambda: self._workers.retire_newest())
                        if self._workers.argv else None)
        acts.setdefault("spawn_replica",
                        (lambda alert=None:
                         self._replicas.spawn(subst=_alert_model_labels(
                             alert)))
                        if self._replicas.argv else None)
        acts.setdefault("retire_replica",
                        (lambda: self._replicas.retire_newest())
                        if self._replicas.argv else None)
        self._actions_fns = acts
        self._standing = {}   # (action, executor) -> latest alert
        self._evicted = set()
        self._evict_grace_until = 0.0
        self._idle_ticks = {"workers": 0, "serving": 0}
        self._added = {"workers": 0, "serving": 0}
        self._budget_spent = {"evict_straggler": 0, "rollback_poison": 0}
        self._seq = 0
        self._ticks = 0
        self._actions = []    # bounded recent action records
        self._counts = {}     # (action, stage) -> count
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Start the control thread (idempotent); returns self."""
        if self._thread is not None:
            return self
        self._journal_meta()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="tfos-remediator", daemon=True)
        self._thread.start()
        telemetry.get_tracer().instant(
            "remediator/start", dry_run=self.dry_run,
            families=len(set(RULE_ACTIONS.values())))
        return self

    def stop(self):
        """Stop the thread, journal a final snapshot, retire every
        subprocess this plane spawned, close the journal.  Idempotent."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
            self._journal_snapshot(force=True)
        self._workers.stop_all()
        self._replicas.stop_all()
        self._journal.close()

    def _loop(self):
        interval = self.config["interval_secs"]
        while not self._stop.wait(interval):
            try:
                self.tick()
            except Exception:  # the remediator must never take the run down
                logger.warning("remediator tick failed", exc_info=True)

    # -- watchtower bridge -------------------------------------------------

    def observe_alert(self, alert):
        """Watchtower ``on_alert`` hook: an admitted alert for a mapped
        rule becomes (or refreshes) the standing alert for its action
        family.  Journaled, so offline replay sees the same stream the
        live plane did.  Unmapped rules are ignored."""
        action = RULE_ACTIONS.get((alert or {}).get("rule"))
        if action is None:
            return
        executor = alert.get("executor")
        with self._lock:
            if action == "evict_straggler" and str(executor) in self._evicted:
                return  # the zombie's drain-out must not re-trigger
            self._standing[(action, str(executor))] = dict(alert)
        self._journal.write(dict(alert, kind="alert"))

    # -- control tick ------------------------------------------------------

    def tick(self, now=None):
        """One control pass; returns the action records journaled this
        tick.  Public so tests and replay drive it directly."""
        now = self._clock() if now is None else now
        with self._lock:
            self._ticks += 1
            tick = self._ticks
            self._expire_standing(now)
        emitted = []
        win = self._measure(now)
        if self._guard.pending is not None:
            emitted.extend(self._judge_pending(win, now, tick))
        else:
            emitted.extend(self._consider(win, now, tick))
        self._journal_snapshot(now=now)
        return emitted

    def _expire_standing(self, now):
        ttl = self.config["alert_ttl_secs"]
        for key in [k for k, a in self._standing.items()
                    if now - a.get("time", now) > ttl]:
            del self._standing[key]

    # -- measurement (settle-window objectives only) -----------------------

    def _measure(self, now):
        window = self.config["window_secs"]
        deltas, gauges, per_node = {}, {}, {}
        span, nodes = 0.0, 0
        series = self.ring.series() if self.ring is not None else {}
        for node, samples in series.items():
            recent = [(ts, c) for ts, c in samples if ts >= now - window]
            wd = window_deltas(recent)
            if wd is not None:
                nodes += 1
                span = max(span, wd["span_secs"])
                per_node[node] = wd
                for k, v in wd["deltas"].items():
                    deltas[k] = deltas.get(k, 0) + v
            for _ts, counters in recent[-5:]:
                for k, v in counters.items():
                    if k.endswith(("_hwm", "_max")) and _is_num(v) \
                            and math.isfinite(v):
                        gauges[k] = max(gauges.get(k, 0), v)
        return {"deltas": deltas, "gauges": gauges, "per_node": per_node,
                "span_secs": span, "nodes": nodes}

    def _objective(self, action, win):
        """Lower-is-better objective per family (the autopilot contract),
        measured around reversible actions to arm revert-on-regression;
        irreversible families return None (their effect is the topology
        change itself)."""
        g = win["gauges"]
        if action in ("scale_out_workers", "scale_in_workers"):
            return g.get("dataservice_queue_sat_pct_max")
        if action in ("scale_out_serving", "scale_in_serving"):
            return g.get("serving_p99_us_max")
        return None

    # -- decision ----------------------------------------------------------

    def _actionable(self, action):
        """The actuator gate: a family with nothing to execute never
        proposes (so a run without a worker argv cannot journal phantom
        scale-outs)."""
        fn = {"evict_straggler": "evict", "rollback_poison": "rollback",
              "scale_out_workers": "spawn_worker",
              "scale_in_workers": "retire_worker",
              "scale_out_serving": "spawn_replica",
              "scale_in_serving": "retire_replica"}[action]
        return self._actions_fns.get(fn) is not None

    def _budget_left(self, action):
        if action == "evict_straggler":
            return self._budget_spent[action] < self.config["max_evictions"]
        if action == "rollback_poison":
            return self._budget_spent[action] < self.config["max_rollbacks"]
        if action == "scale_out_workers":
            return self._added["workers"] < self.config["max_workers"]
        if action == "scale_out_serving":
            return self._added["serving"] < self.config["max_replicas"]
        if action == "scale_in_workers":
            return self._added["workers"] > 0
        if action == "scale_in_serving":
            return self._added["serving"] > 0
        return False

    def _consider(self, win, now, tick):
        with self._lock:
            standing = dict(self._standing)
        by_action = {}
        for (action, executor), alert in standing.items():
            by_action.setdefault(action, []).append(alert)
        for action in ACTION_PRIORITY:
            alerts = by_action.get(action)
            if not alerts:
                continue
            # capacity alerts track idleness per family; any standing
            # alert resets the family's scale-in countdown
            fam = COOLDOWN_FAMILY[action]
            if fam in self._idle_ticks:
                self._idle_ticks[fam] = 0
            if not self._actionable(action) or not self._budget_left(action):
                continue
            if action == "evict_straggler" \
                    and now < self._evict_grace_until:
                continue  # replacement still warming up: do not re-judge
            # newest alert with the deepest persistence wins the slot
            alert = max(alerts, key=lambda a: (
                a.get("persists_windows", 1), a.get("time", 0)))
            streak = max(alert.get("persists_windows", 1),
                         self._guard.bump_streak(
                             (action, str(alert.get("executor")))))
            if self._guard.in_cooldown(fam, now):
                continue
            if streak < self.config["confirm_windows"][action]:
                continue
            return self._act(action, alert, win, now, tick)
        return self._consider_scale_in(win, now, tick)

    def _consider_scale_in(self, win, now, tick):
        """Idle-window scale-in of ADDED capacity: a family with no
        standing alert for ``scale_in_idle_windows`` consecutive ticks
        retires its newest spawn (clean detach — splits re-bind)."""
        for fam, action in (("workers", "scale_in_workers"),
                            ("serving", "scale_in_serving")):
            if not self._budget_left(action) or not self._actionable(action):
                continue
            self._idle_ticks[fam] += 1
            if self._idle_ticks[fam] < self.config["scale_in_idle_windows"]:
                continue
            if self._guard.in_cooldown(fam, now):
                continue
            self._idle_ticks[fam] = 0
            alert = {"rule": "idle", "executor": None,
                     "evidence": {"idle_ticks":
                                  self.config["scale_in_idle_windows"]}}
            return self._act(action, alert, win, now, tick)
        return []

    def _act(self, action, alert, win, now, tick):
        fam = COOLDOWN_FAMILY[action]
        executor = alert.get("executor")
        objective = self._objective(action, win)
        self._seq += 1
        base = {"seq": self._seq, "action": action, "rule": alert.get("rule"),
                "executor": executor, "severity": alert.get("severity"),
                "persists_windows": alert.get("persists_windows"),
                "evidence": alert.get("evidence"),
                "reversible": action in REVERSIBLE, "tick": tick}
        out = [self._record(dict(base, stage="proposed",
                                 objective_before=objective, time=now))]
        self._guard.clear_streak((action, str(executor)))
        with self._lock:
            self._standing.pop((action, str(executor)), None)
        if self.dry_run:
            # dry run: propose + journal, never actuate; cooldown still
            # applies so the journal is a decision stream, not a firehose
            self._guard.start_cooldown(fam, now)
            return out
        try:
            detail = self._execute(action, executor, alert)
        except Exception:
            # actuation failure leaves the action at "proposed" (never
            # "applied" — that stage means the topology really changed)
            logger.warning("remediator actuation failed for %s", action,
                           exc_info=True)
            self._guard.start_cooldown(fam, now)
            return out
        self._account(action, +1)
        self._guard.begin(dict(base, objective_before=objective,
                               applied_tick=tick, applied_time=now,
                               detail=detail))
        out.append(self._record(dict(base, stage="applied", time=now,
                                     objective_before=objective,
                                     detail=detail)))
        return out

    def _execute(self, action, executor, alert):
        fns = self._actions_fns
        if action == "evict_straggler":
            detail = fns["evict"](executor, alert)
            with self._lock:
                self._evicted.add(str(executor))
                # the zombie's remaining alerts are moot
                for key in [k for k in self._standing
                            if k[1] == str(executor)]:
                    del self._standing[key]
            self._evict_grace_until = (self._clock()
                                       + self.config[
                                           "replacement_grace_secs"])
            return detail
        if action == "rollback_poison":
            return fns["rollback"](executor, alert)
        if action == "scale_out_workers":
            return fns["spawn_worker"]()
        if action == "scale_in_workers":
            return fns["retire_worker"]()
        if action == "scale_out_serving":
            # pass the alert when the actuator takes it: its model/version
            # labels steer the spawn argv at the burning model (injected
            # zero-arg test/replay actuators keep working unchanged)
            fn = fns["spawn_replica"]
            try:
                takes_alert = bool(inspect.signature(fn).parameters)
            except (TypeError, ValueError):
                takes_alert = False
            return fn(alert) if takes_alert else fn()
        if action == "scale_in_serving":
            return fns["retire_replica"]()
        raise ValueError("unknown action %r" % action)

    def _account(self, action, delta):
        if action in self._budget_spent:
            self._budget_spent[action] += max(delta, 0)
        elif action == "scale_out_workers":
            self._added["workers"] += delta
        elif action == "scale_in_workers":
            self._added["workers"] -= delta
        elif action == "scale_out_serving":
            self._added["serving"] += delta
        elif action == "scale_in_serving":
            self._added["serving"] -= delta

    def _judge_pending(self, win, now, tick):
        pend = self._guard.pending
        if tick - pend["applied_tick"] < self.config["settle_ticks"]:
            return []
        action = pend["action"]
        fam = COOLDOWN_FAMILY[action]
        before = pend.get("objective_before")
        after = self._objective(action, win)
        base = {k: pend[k] for k in ("seq", "action", "rule", "executor",
                                     "reversible")}
        out = [self._record(dict(base, stage="effect", tick=tick, time=now,
                                 objective_before=before,
                                 objective_after=after,
                                 detail=pend.get("detail")))]
        regressed = False
        if pend["reversible"] and before is not None and after is not None:
            rel = (after - before) / max(abs(before), _EPS)
            if rel > self.config["revert_margin_frac"]:
                regressed = True
        self._guard.settle()
        if regressed:
            try:
                detail = self._execute(
                    {"scale_out_workers": "scale_in_workers",
                     "scale_out_serving": "scale_in_serving"}[action],
                    None, {})
            except Exception:
                logger.warning("remediator revert failed for %s", action,
                               exc_info=True)
                detail = None
            else:
                self._account(action, -1)
            self._guard.start_cooldown(fam, now, reverted=True)
            out.append(self._record(dict(
                base, stage="reverted", tick=tick, time=now,
                objective_before=before, objective_after=after,
                detail=detail)))
        else:
            self._guard.start_cooldown(fam, now)
            out.append(self._record(dict(
                base, stage="kept", tick=tick, time=now,
                objective_before=before, objective_after=after)))
        return out

    def _record(self, record):
        record = dict(record, kind="action")
        with self._lock:
            self._actions.append(record)
            del self._actions[:-int(self.config["max_actions"])]
            key = (record["action"], record["stage"])
            self._counts[key] = self._counts.get(key, 0) + 1
        telemetry.get_tracer().instant(
            "remediator/" + record["stage"], action=record.get("action"),
            rule=record.get("rule"), executor=record.get("executor"))
        logger.warning("remediator %s: %s (rule=%s executor=%s)",
                       record["stage"], record.get("action"),
                       record.get("rule"), record.get("executor"))
        self._journal.write(record)
        if self._on_action is not None:
            try:
                self._on_action(record)
            except Exception:
                logger.warning("remediator on_action callback failed",
                               exc_info=True)
        return record

    # -- read surface (observatory endpoints) ------------------------------

    def actions(self, limit=None):
        """Newest-last copies of the bounded action log."""
        with self._lock:
            out = list(self._actions)
        if limit is not None:
            out = out[-int(limit):]
        return out

    def action_counts(self):
        """``{action: {stage: count}}`` — the
        ``tfos_remediation_actions_total{action,stage}`` source."""
        with self._lock:
            nested = {}
            for (action, stage), n in self._counts.items():
                nested.setdefault(action, {})[stage] = n
            return nested

    def status(self):
        """The ``/status`` ``remediator`` block (also served whole on
        ``/remediations``)."""
        now = self._clock()
        with self._lock:
            standing = [{"action": a, "executor": e,
                         "rule": alert.get("rule"),
                         "persists_windows": alert.get("persists_windows"),
                         "age_secs": round(now - alert.get("time", now), 2)}
                        for (a, e), alert in self._standing.items()]
        pend = self._guard.pending
        return {
            "dry_run": self.dry_run,
            "ticks": self._ticks,
            "interval_secs": self.config["interval_secs"],
            "window_secs": self.config["window_secs"],
            "standing_alerts": standing,
            "cooldowns": self._guard.cooldowns(now),
            "pending": (None if pend is None
                        else {k: pend[k] for k in
                              ("seq", "action", "rule", "executor")}),
            "budgets": {
                "evictions": [self._budget_spent["evict_straggler"],
                              self.config["max_evictions"]],
                "rollbacks": [self._budget_spent["rollback_poison"],
                              self.config["max_rollbacks"]],
                "workers_added": [self._added["workers"],
                                  self.config["max_workers"]],
                "replicas_added": [self._added["serving"],
                                   self.config["max_replicas"]],
            },
            "action_counts": self.action_counts(),
            "actions": self.actions(limit=10),
            "journal": self.journal_path,
        }

    # -- journal -----------------------------------------------------------

    def _journal_meta(self):
        cfg = {k: v for k, v in self.config.items()}
        self._journal.write({
            "kind": "meta", "version": JOURNAL_VERSION,
            "time": self._clock(), "dry_run": self.dry_run,
            "config": cfg,
            # the kind-detection marker metrics_replay_torch.py keys on (an
            # autopilot meta carries "knobs" instead)
            "families": sorted(set(RULE_ACTIONS.values())),
        })

    def _journal_snapshot(self, now=None, force=False):
        if self.journal_path is None:
            return
        now = self._clock() if now is None else now
        every = self.config["journal_snapshot_secs"]
        if not force and now - self._last_journal_snap < every:
            return
        self._last_journal_snap = now
        snap = None
        if self._snapshot_fn is not None:
            try:
                snap = self._snapshot_fn()
            except Exception:
                snap = None
        if not snap or not snap.get("nodes"):
            return
        self._journal.write({"kind": "snapshot", "time": now,
                             "snapshot": snap})


# -- offline replay ---------------------------------------------------------

def replay_journal(records, config=None):
    """Re-run the decision logic over a remediator journal exactly as the
    live plane would have — in dry-run, so replay never actuates.

    The journal's ``meta`` record supplies the run's config unless
    overridden; ``alert`` records re-feed ``observe_alert`` and
    ``snapshot`` records rebuild the measurement series, with the plane
    ticked at each record's timestamp.  Returns::

        {"actions": [...], "journaled_actions": [...],
         "config": {...}, "alerts": N, "snapshots": N}

    ``actions`` is the replay-derived stream (all ``proposed`` — dry-run
    never applies); ``journaled_actions`` is what the live run recorded.
    Comparing the two is the divergence surface
    ``scripts/metrics_replay_torch.py --kind remediator`` prints.
    """
    from .autopilot import _StaticRing

    if isinstance(records, str):
        records = read_journal(records)
    meta_cfg = {}
    for rec in records:
        if rec.get("kind") == "meta":
            meta_cfg = {k: v for k, v in (rec.get("config") or {}).items()
                        if k in DEFAULT_CONFIG}
            break
    merged = dict(meta_cfg, dry_run=True,
                  worker_spawn_argv=None, serving_spawn_argv=None)
    if config:
        merged.update(config)
    journaled = [dict(r) for r in records if r.get("kind") == "action"]
    ring = _StaticRing()
    clock = {"now": 0.0}
    # dry-run still requires the actuator gate to pass, so replay arms
    # every family with inert stubs — a proposal is the terminal stage
    stubs = {k: (lambda *a, **kw: None)
             for k in ("evict", "rollback", "spawn_worker", "retire_worker",
                       "spawn_replica", "retire_replica")}
    plane = Remediator(ring, actions=stubs, config=merged,
                       clock=lambda: clock["now"])
    actions = []
    events = sorted((r for r in records
                     if r.get("kind") in ("alert", "snapshot")),
                    key=lambda r: r.get("time", 0))
    n_alerts = n_snaps = 0
    for rec in events:
        now = rec.get("time", 0.0)
        clock["now"] = now
        if rec.get("kind") == "alert":
            n_alerts += 1
            plane.observe_alert({k: v for k, v in rec.items()
                                 if k != "kind"})
        else:
            n_snaps += 1
            for node, counters in ((rec.get("snapshot") or {})
                                   .get("nodes") or {}).items():
                if isinstance(counters, dict):
                    ring.append(node, now, counters)
            ring.trim(now - 2 * plane.config["window_secs"])
        actions.extend(plane.tick(now=now))
    return {"actions": actions, "journaled_actions": journaled,
            "config": plane.config, "alerts": n_alerts,
            "snapshots": n_snaps}
