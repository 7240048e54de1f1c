"""Autopilot: closed-loop performance controller over live telemetry (the
port's copy of the JAX package's ``autopilot`` module).

The observability stack measures everything — goodput breakdown, infeed
starvation, data-service queue fill, cache evictions, serving batch fill
and p99 — but until now nothing *acted* on it.  This
module closes the loop with a driver-side controller thread that ticks
over the observatory :class:`~tensorflowonspark_torch.observatory.SampleRing`
(the watchtower pattern) and runs gradient-free hill-climbing over live
performance knobs:

===========================  =======================  =====================
knob                         plane                    steered by
===========================  =======================  =====================
``infeed_prefetch``          ShardedFeed (node)       infeed-starved wall
                                                      fraction
``dataservice_queue_bound``  ServiceFeed (node)       ``dataservice_queue_
                                                      sat_pct_max``
``dataservice_cache_budget`` FeedWorker chunk cache   cache-thrash eviction
                                                      evidence
``wire_codec``               stream hello (node)      measured compress
                                                      ratio vs CPU cost
``serving_max_wait_ms``      GatewayServer            p99 vs batch fill
``serving_max_batch``        GatewayServer            p99 vs batch fill
===========================  =======================  =====================

Guardrails, in the order they gate an action:

- **hysteresis** — a sensor must fire on ``confirm_ticks`` consecutive
  control ticks before a proposal is minted (one noisy window never
  turns a knob), and a post-actuation objective move inside
  ``hysteresis_frac`` counts as neutral, never as improvement;
- **per-knob cooldown** — after an action settles (kept OR reverted) the
  knob is frozen for ``cooldown_secs`` (``revert_cooldown_secs`` after a
  revert), so the controller cannot flap;
- **revert-on-regression** — every applied action records the steered
  objective before actuation, waits ``settle_ticks``, re-measures, and
  rolls the knob back within that one control window when the objective
  regressed beyond ``revert_margin_frac`` (the journal records
  ``reverted`` with the measured before/after);
- **one action in flight** — a new proposal is never considered while an
  applied action is still settling, so effects are attributable.

Every action is journaled (``proposed`` → ``applied`` → ``effect`` →
``kept``/``reverted``) to a flush-per-write JSONL next to the watchtower
journal, with a **dry-run mode** that proposes and journals but never
actuates.  Actuation itself rides the existing heartbeat-reply channel:
the controller pushes ``{knob: value}`` into
:class:`~tensorflowonspark_torch.reservation.KnobCoordinator` and each
node's next beat reply carries the ``knobs`` dict exactly once (the
``PROF``/``reregister`` pattern).  See docs/AUTOPILOT.md.
"""

import logging
import math
import threading
import time

from . import telemetry
from .guardrails import STAGES, Guardrails, JsonlJournal
from .watchtower import read_journal as _read_journal, window_deltas

logger = logging.getLogger(__name__)

JOURNAL_VERSION = 1

# STAGES (the proposed→applied→effect→kept/reverted lifecycle vocabulary)
# now lives in guardrails.py, shared with the remediator; re-exported here
# for compatibility.
assert STAGES[0] == "proposed"

#: every tunable threshold in one place; ``cluster.run(..., autopilot={...})``
#: overrides key-wise (unknown keys raise, same contract as the watchtower)
DEFAULT_CONFIG = {
    # control tick cadence and the sliding measurement window
    "interval_secs": 1.0,
    "window_secs": 15.0,
    # hysteresis: consecutive firing ticks before a proposal is minted
    "confirm_ticks": 2,
    # ticks between actuation and judging its effect (the control window)
    "settle_ticks": 3,
    # per-knob freeze after an action settles; longer after a revert so a
    # knob that just hurt the run is not retried while conditions match
    "cooldown_secs": 10.0,
    "revert_cooldown_secs": 60.0,
    # objective moves inside this relative band are neutral (kept, but
    # never counted as improvement); beyond revert_margin_frac the action
    # is rolled back
    "hysteresis_frac": 0.10,
    "revert_margin_frac": 0.25,
    # propose + journal but never actuate
    "dry_run": False,
    # sensor thresholds (vocabulary shared with the watchtower rules)
    "infeed_starved_frac": 0.3,
    "min_events": 5,
    "queue_sat_pct": 90.0,
    "cache_thrash_min_evictions": 8,
    "cache_thrash_evict_hit_ratio": 1.0,
    # a negotiated codec whose measured ratio is below this is not paying
    # for its CPU cost
    "codec_min_ratio": 1.1,
    # serving objective: 0 disarms the SLO comparison (fill-only steering)
    "latency_slo_p99_us": 0.0,
    "batch_fill_lo_pct": 50.0,
    "batch_fill_hi_pct": 90.0,
    # megastep K steering (train_steps_per_call): raise K when the
    # between-dispatch host gap per DISPATCHED step is above the
    # threshold (host overhead a longer scan would amortize); back K off
    # when the feed cannot keep groups full (starved wall fraction at or
    # above the threshold while K > 1)
    "steps_per_call_gap_hi_us": 1500.0,
    "steps_per_call_starved_frac": 0.5,
    # bounded in-memory action log + journal snapshot cadence
    "max_actions": 64,
    "journal_snapshot_secs": 10.0,
    # per-knob overrides of DEFAULT_KNOBS ({"infeed_prefetch": {...}})
    "knobs": {},
}

#: per-knob bounds and driver-side shadow of the current value.  ``initial``
#: None means "unknown" — a numeric knob cannot be stepped from an unknown
#: value, so the cluster wiring (or test) must supply it; categorical knobs
#: (``choices``) actuate absolute values and need no initial.
DEFAULT_KNOBS = {
    "infeed_prefetch": {"initial": None, "min": 1, "max": 16,
                        "integer": True, "target": "node"},
    "train_steps_per_call": {"initial": None, "min": 1, "max": 64,
                             "integer": True, "target": "node"},
    "dataservice_queue_bound": {"initial": 2, "min": 2, "max": 64,
                                "integer": True, "target": "node"},
    "dataservice_cache_budget": {"initial": None, "min": 8 << 20,
                                 "max": 2 << 30, "integer": True,
                                 "target": "worker"},
    "wire_codec": {"initial": None, "choices": ["auto", "off"],
                   "target": "node"},
    "serving_max_wait_ms": {"initial": None, "min": 0.5, "max": 50.0,
                            "integer": False, "target": "gateway"},
    "serving_max_batch": {"initial": None, "min": 1, "max": 1024,
                          "integer": True, "target": "gateway"},
}

#: watchtower rule -> (knob, direction): an admitted alert becomes a
#: standing proposal hint, so the watchtower's own thresholds can arm a
#: knob even when the autopilot's (looser or tighter) sensor has not fired
ALERT_HINTS = {
    "infeed_starved": ("infeed_prefetch", +1),
    "dataservice_saturation": ("dataservice_queue_bound", +1),
    "cache_thrash": ("dataservice_cache_budget", +1),
    # slo_budget_burn superseded latency_slo_burn; the old name
    # stays mapped so journal replays of earlier runs still resolve hints
    "latency_slo_burn": ("serving_max_wait_ms", -1),
    "slo_budget_burn": ("serving_max_wait_ms", -1),
}

_EPS = 1e-9


def _is_num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def merge_config(config):
    """Key-wise merge over :data:`DEFAULT_CONFIG`; unknown keys raise so a
    typo'd threshold fails loudly instead of silently not steering."""
    cfg = dict(DEFAULT_CONFIG)
    cfg["knobs"] = {}
    for k, v in (config or {}).items():
        if k not in DEFAULT_CONFIG:
            raise ValueError("unknown autopilot config key: %r (known: %s)"
                             % (k, ", ".join(sorted(DEFAULT_CONFIG))))
        cfg[k] = v
    knobs = {}
    for name, spec in DEFAULT_KNOBS.items():
        knobs[name] = dict(spec)
    for name, over in (config or {}).get("knobs", {}).items():
        if name not in DEFAULT_KNOBS:
            raise ValueError("unknown autopilot knob: %r (known: %s)"
                             % (name, ", ".join(sorted(DEFAULT_KNOBS))))
        knobs[name].update(over or {})
    cfg["knobs"] = knobs
    return cfg


class Autopilot(object):
    """Driver-side closed-loop controller over the observatory ring.

    Args:
      ring: the :class:`~tensorflowonspark_torch.observatory.SampleRing` the
        reservation server feeds (``server.sample_ring``) — anything with
        a ``series()`` method works (replay uses a static stand-in).
      actuator: ``fn({knob: value})`` that delivers knob updates to the
        cluster — in production ``KnobCoordinator.push``, fanned out on
        heartbeat replies.  ``None`` (or ``dry_run``) journals proposals
        without actuating.
      snapshot_fn: zero-arg callable returning the ``{"nodes", ...}``
        metrics snapshot, journaled periodically so replay has the series.
      config: key-wise overrides of :data:`DEFAULT_CONFIG`.
      journal_path: append-only flush-per-write JSONL; ``None`` disables.
      on_action: optional ``fn(record)`` per journaled action stage.
      clock: injectable time source (tests, replay).
    """

    def __init__(self, ring, actuator=None, snapshot_fn=None, config=None,
                 journal_path=None, on_action=None, clock=time.time,
                 resume_values=None):
        """``resume_values``: optional ``{knob: value}`` overriding each
        knob's configured ``initial`` — a coordinator recovered from its
        journal hands the fleet's standing knob state here
        (``KnobCoordinator.current()``), so a controller restarted after a
        failover resumes from where the fleet actually IS instead of
        re-walking every retune from the configured defaults."""
        self.config = merge_config(config)
        self.ring = ring
        self.actuator = actuator
        self._snapshot_fn = snapshot_fn
        self._on_action = on_action
        self._clock = clock
        self.journal_path = journal_path
        self._journal = JsonlJournal(journal_path, owner="autopilot")
        self._last_journal_snap = 0.0
        self.dry_run = bool(self.config["dry_run"])
        # driver-side shadow of each knob's current value
        self._values = {name: spec.get("initial")
                        for name, spec in self.config["knobs"].items()}
        for name, value in (resume_values or {}).items():
            if name in self._values and value is not None:
                self._values[name] = value
        # shared gating state: streaks + cooldowns + the one in-flight slot
        self._guard = Guardrails(self.config["cooldown_secs"],
                                 self.config["revert_cooldown_secs"])
        self._hints = {}           # knob -> (direction, alert_time, rule)
        self._seq = 0
        self._ticks = 0
        self._actions = []         # bounded recent action records
        self._counts = {}          # stage -> count
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
                                        name="tfos-autopilot", daemon=True)
        self._thread.start()
        telemetry.get_tracer().instant(
            "autopilot/start", dry_run=self.dry_run,
            knobs=len(self._values))
        return self

    def stop(self):
        """Stop the thread, journal a final snapshot, close the journal.
        Idempotent."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
            self._journal_snapshot(force=True)
        self._journal.close()

    def _loop(self):
        interval = self.config["interval_secs"]
        while not self._stop.wait(interval):
            try:
                self.tick()
            except Exception:  # the controller must never take the run down
                logger.warning("autopilot tick failed", exc_info=True)

    # -- watchtower bridge -------------------------------------------------

    def observe_alert(self, alert):
        """Watchtower ``on_alert`` hook: an admitted alert becomes a
        standing proposal hint for the mapped knob (the watchtower's
        threshold arms the sensor even when the autopilot's own has not
        fired).  Unmapped rules are ignored."""
        hint = ALERT_HINTS.get((alert or {}).get("rule"))
        if hint is None:
            return
        knob, direction = hint
        with self._lock:
            self._hints[knob] = (direction, alert.get("time", self._clock()),
                                 alert.get("rule"))

    # -- control tick ------------------------------------------------------

    def tick(self, now=None):
        """One control pass; returns the action records journaled this
        tick.  Public so tests and replay drive it directly."""
        now = self._clock() if now is None else now
        with self._lock:
            self._ticks += 1
            tick = self._ticks
        emitted = []
        win = self._measure(now)
        # settle phase first: while an action is in flight nothing else
        # moves, so its effect stays attributable
        if self._guard.pending is not None:
            emitted.extend(self._judge_pending(win, now, tick))
        elif win["nodes"]:
            emitted.extend(self._consider(win, now, tick))
        self._journal_snapshot(now=now)
        return emitted

    # -- measurement -------------------------------------------------------

    def _measure(self, now):
        """Aggregate the in-window telemetry: summed counter deltas across
        nodes, per-node starved fractions, and recent gauge maxima."""
        window = self.config["window_secs"]
        deltas = {}
        gauges = {}
        per_node = {}
        span = 0.0
        nodes = 0
        for node, samples in self.ring.series().items():
            recent = [(ts, c) for ts, c in samples if ts >= now - window]
            wd = window_deltas(recent)
            if wd is not None:
                nodes += 1
                span = max(span, wd["span_secs"])
                per_node[node] = wd
                for k, v in wd["deltas"].items():
                    deltas[k] = deltas.get(k, 0) + v
            # gauges (_hwm/_max) are per-beat latched values the delta walk
            # skips: take the max over the window's recent samples
            for _ts, counters in recent[-5:]:
                for k, v in counters.items():
                    if k.endswith(("_hwm", "_max")) and _is_num(v) \
                            and math.isfinite(v):
                        gauges[k] = max(gauges.get(k, 0), v)
        return {"deltas": deltas, "gauges": gauges, "per_node": per_node,
                "span_secs": span, "nodes": nodes}

    def _starved_frac(self, win):
        """Worst per-node infeed-starved wall fraction (the starving node
        is the signal; averaging across healthy peers would hide it)."""
        worst = None
        for wd in win["per_node"].values():
            d = wd["deltas"]
            if d.get("dispatch_count", 0) < self.config["min_events"]:
                continue
            span = wd["span_secs"]
            if span <= 0:
                continue
            frac = d.get("goodput_infeed_starved_us", 0) / (span * 1e6)
            if frac >= 0 and (worst is None or frac > worst):
                worst = frac
        return worst

    def _gap_per_step(self, win):
        """Worst per-node between-dispatch host gap per DISPATCHED train
        step (µs) — the host overhead a longer megastep scan amortizes.
        Per-step (not per-dispatch): otherwise raising K would look worse
        as each bigger group legitimately waits longer for its data."""
        worst = None
        for wd in win["per_node"].values():
            d = wd["deltas"]
            steps = d.get("train_steps_total", 0)
            if steps < self.config["min_events"]:
                continue
            gap = d.get("dispatch_gap_us", 0) / steps
            if worst is None or gap > worst:
                worst = gap
        return worst

    # objectives are "lower is better" so kept/reverted logic is uniform
    def _objective(self, knob, win):
        d, g, span = win["deltas"], win["gauges"], max(win["span_secs"],
                                                      _EPS)
        if knob == "infeed_prefetch":
            return self._starved_frac(win)
        if knob == "train_steps_per_call":
            return self._gap_per_step(win)
        if knob == "dataservice_queue_bound":
            return g.get("dataservice_queue_sat_pct_max")
        if knob == "dataservice_cache_budget":
            if "dataservice_cache_evictions" not in d:
                return None
            return d.get("dataservice_cache_evictions", 0) / span
        if knob == "wire_codec":
            if "dataservice_items" not in d:
                return None
            return -(d.get("dataservice_items", 0) / span)
        if knob in ("serving_max_wait_ms", "serving_max_batch"):
            return g.get("serving_p99_us_max")
        return None

    # -- sensors -----------------------------------------------------------

    def _sense(self, knob, win):
        """Return ``{"direction", "signal", "value"}`` when the knob's
        steering signal fires this tick, else ``None``."""
        cfg = self.config
        d, g = win["deltas"], win["gauges"]
        if knob == "infeed_prefetch":
            frac = self._starved_frac(win)
            if frac is not None and frac >= cfg["infeed_starved_frac"]:
                return {"direction": +1, "signal": "infeed_starved",
                        "value": round(frac, 4)}
        elif knob == "train_steps_per_call":
            gap = self._gap_per_step(win)
            if gap is not None and gap >= cfg["steps_per_call_gap_hi_us"]:
                return {"direction": +1, "signal": "dispatch_gap_per_step",
                        "value": round(gap, 1)}
            frac = self._starved_frac(win)
            cur = self._values.get("train_steps_per_call")
            if frac is not None and cur is not None and cur > 1 and \
                    frac >= cfg["steps_per_call_starved_frac"]:
                # groups are waiting on the feed: a smaller K restores
                # overlap instead of parking the device K batches at a time
                return {"direction": -1, "signal": "group_starved",
                        "value": round(frac, 4)}
        elif knob == "dataservice_queue_bound":
            sat = g.get("dataservice_queue_sat_pct_max")
            if sat is not None and sat >= cfg["queue_sat_pct"]:
                return {"direction": +1, "signal": "dataservice_saturation",
                        "value": sat}
        elif knob == "dataservice_cache_budget":
            ev = d.get("dataservice_cache_evictions", 0)
            hits = d.get("dataservice_cache_hit", 0)
            if ev >= cfg["cache_thrash_min_evictions"] and \
                    ev >= cfg["cache_thrash_evict_hit_ratio"] * max(hits, 1):
                return {"direction": +1, "signal": "cache_thrash",
                        "value": ev}
        elif knob == "wire_codec":
            ratio = g.get("wire_compress_ratio_max")
            if ratio and 0 < ratio < cfg["codec_min_ratio"] and \
                    self._values.get("wire_codec") != "off":
                return {"direction": 0, "signal": "codec_not_paying",
                        "value": ratio, "to": "off"}
        elif knob == "serving_max_wait_ms":
            fill = g.get("serving_batch_fill_pct_max")
            p99 = g.get("serving_p99_us_max")
            slo = cfg["latency_slo_p99_us"]
            if d.get("serving_requests", 0) > 0 and fill is not None \
                    and fill < cfg["batch_fill_lo_pct"] \
                    and (not slo or (p99 or 0) > slo):
                # waiting is not filling batches: it only buys latency
                return {"direction": -1, "signal": "p99_vs_batch_fill",
                        "value": fill}
        elif knob == "serving_max_batch":
            fill = g.get("serving_batch_fill_pct_max")
            p99 = g.get("serving_p99_us_max")
            slo = cfg["latency_slo_p99_us"]
            if d.get("serving_requests", 0) > 0 and fill is not None \
                    and fill >= cfg["batch_fill_hi_pct"] \
                    and (not slo or (p99 or 0) < 0.7 * slo):
                # batches leave full with latency headroom: admit more
                return {"direction": +1, "signal": "p99_vs_batch_fill",
                        "value": fill}
        return None

    def _step(self, knob, direction, sensed):
        """Hill-climb step: next value for ``knob`` or ``None`` when it
        cannot move (unknown current value, pinned at a bound)."""
        spec = self.config["knobs"][knob]
        if "choices" in spec:
            to = sensed.get("to")
            return to if to in spec["choices"] else None
        cur = self._values.get(knob)
        if cur is None:
            return None  # numeric knob with no known current value
        nxt = cur * 2 if direction > 0 else cur / 2.0
        if spec.get("integer", True):
            nxt = int(max(nxt, cur + 1) if direction > 0
                      else min(nxt, cur - 1))
        nxt = min(max(nxt, spec["min"]), spec["max"])
        if spec.get("integer", True):
            nxt = int(nxt)
        return None if nxt == cur else nxt

    # -- decision ----------------------------------------------------------

    def _consider(self, win, now, tick):
        emitted = []
        window = self.config["window_secs"]
        for knob in self.config["knobs"]:
            if self._guard.in_cooldown(knob, now):
                continue
            sensed = self._sense(knob, win)
            if sensed is None:
                # a fresh watchtower alert stands in for a local sensor
                hint = self._hints.get(knob)
                if hint and now - hint[1] <= window:
                    sensed = {"direction": hint[0], "signal": hint[2],
                              "value": None, "hint": True}
            if sensed is None:
                self._guard.clear_streak(knob)
                continue
            streak = self._guard.bump_streak(knob)
            if streak < self.config["confirm_ticks"]:
                continue  # hysteresis: one noisy window never turns a knob
            to = self._step(knob, sensed["direction"], sensed)
            if to is None:
                self._guard.clear_streak(knob)
                continue
            emitted.extend(self._act(knob, to, sensed, win, now, tick))
            break  # one action in flight at a time
        return emitted

    def _act(self, knob, to, sensed, win, now, tick):
        frm = self._values.get(knob)
        objective = self._objective(knob, win)
        self._seq += 1
        base = {"seq": self._seq, "knob": knob,
                "target": self.config["knobs"][knob].get("target"),
                "from": frm, "to": to, "signal": sensed["signal"],
                "value": sensed.get("value"), "tick": tick}
        out = [self._record(dict(base, stage="proposed",
                                 objective_before=objective, time=now))]
        self._guard.clear_streak(knob)
        self._hints.pop(knob, None)
        if self.dry_run or self.actuator is None:
            # dry run: propose + journal, never actuate; cooldown still
            # applies so the journal is a decision stream, not a firehose
            self._guard.start_cooldown(knob, now)
            return out
        try:
            self.actuator({knob: to})
        except Exception:
            logger.warning("autopilot actuation failed for %s", knob,
                           exc_info=True)
            self._guard.start_cooldown(knob, now)
            return out
        self._values[knob] = to
        self._guard.begin(dict(base, objective_before=objective,
                               applied_tick=tick, applied_time=now))
        out.append(self._record(dict(base, stage="applied",
                                     objective_before=objective, time=now)))
        return out

    def _judge_pending(self, win, now, tick):
        pend = self._guard.pending
        if tick - pend["applied_tick"] < self.config["settle_ticks"]:
            return []
        knob = pend["knob"]
        before = pend["objective_before"]
        after = self._objective(knob, win)
        base = {k: pend[k] for k in ("seq", "knob", "target", "from", "to",
                                     "signal", "value")}
        out = [self._record(dict(base, stage="effect", tick=tick, time=now,
                                 objective_before=before,
                                 objective_after=after))]
        regressed = False
        if before is not None and after is not None:
            scale = max(abs(before), _EPS)
            # lower is better: positive rel = regression
            rel = (after - before) / scale
            if rel > self.config["revert_margin_frac"]:
                regressed = True
        self._guard.settle()
        if regressed:
            try:
                if self.actuator is not None:
                    self.actuator({knob: pend["from"]})
            except Exception:
                logger.warning("autopilot revert actuation failed for %s",
                               knob, exc_info=True)
            self._values[knob] = pend["from"]
            self._guard.start_cooldown(knob, now, reverted=True)
            out.append(self._record(dict(
                base, stage="reverted", tick=tick, time=now,
                objective_before=before, objective_after=after)))
        else:
            self._guard.start_cooldown(knob, now)
            out.append(self._record(dict(
                base, stage="kept", tick=tick, time=now,
                objective_before=before, objective_after=after)))
        return out

    def _record(self, record):
        record = dict(record, kind="action")
        with self._lock:
            self._actions.append(record)
            del self._actions[:-int(self.config["max_actions"])]
            stage = record["stage"]
            self._counts[stage] = self._counts.get(stage, 0) + 1
        telemetry.get_tracer().instant(
            "autopilot/" + record["stage"], knob=record.get("knob"),
            to=record.get("to"), signal=record.get("signal"))
        logger.info("autopilot %s: %s %r -> %r (%s)", record["stage"],
                    record.get("knob"), record.get("from"),
                    record.get("to"), record.get("signal"))
        self._journal_write(record)
        if self._on_action is not None:
            try:
                self._on_action(record)
            except Exception:
                logger.warning("autopilot on_action callback failed",
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
        """``{stage: count}`` — the ``tfos_autopilot_actions_total``
        source."""
        with self._lock:
            return dict(self._counts)

    def knob_values(self):
        """Driver-side shadow of every knob's current value."""
        with self._lock:
            return dict(self._values)

    def status(self):
        """The ``/status`` ``autopilot`` block (also served whole on
        ``/autopilot``)."""
        now = self._clock()
        with self._lock:
            return {
                "dry_run": self.dry_run,
                "ticks": self._ticks,
                "interval_secs": self.config["interval_secs"],
                "window_secs": self.config["window_secs"],
                "knobs": dict(self._values),
                "cooldowns": self._guard.cooldowns(now),
                "pending": (None if self._guard.pending is None
                            else {k: self._guard.pending[k]
                                  for k in ("seq", "knob", "from", "to",
                                            "signal")}),
                "action_counts": dict(self._counts),
                "actions": list(self._actions)[-10:],
                "journal": self.journal_path,
            }

    # -- journal (shared JsonlJournal — see guardrails.py) ------------------

    def _journal_write(self, record):
        self._journal.write(record)

    def _journal_meta(self):
        cfg = {k: v for k, v in self.config.items() if k != "knobs"}
        self._journal_write({
            "kind": "meta", "version": JOURNAL_VERSION,
            "time": self._clock(), "dry_run": self.dry_run,
            "config": cfg,
            "knobs": {name: spec.get("initial")
                      for name, spec in self.config["knobs"].items()},
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
        self._journal_write({"kind": "snapshot", "time": now,
                             "snapshot": snap})


# -- offline replay ---------------------------------------------------------

read_journal = _read_journal


class _StaticRing(object):
    """Mutable stand-in for SampleRing so replay drives the same
    controller code the live run did."""

    def __init__(self):
        self._series = {}

    def append(self, node, ts, counters):
        self._series.setdefault(str(node), []).append((ts, counters))

    def trim(self, horizon):
        for node in list(self._series):
            self._series[node] = [(ts, c) for ts, c in self._series[node]
                                  if ts >= horizon]

    def series(self):
        return {n: list(s) for n, s in self._series.items()}


def replay_journal(records, config=None):
    """Re-run the decision logic over an autopilot journal exactly as the
    live controller would have — in dry-run, so replay never actuates.

    The journal's ``meta`` record supplies the run's config and initial
    knob values unless overridden; snapshot records rebuild the per-node
    series and the controller is ticked at each snapshot's timestamp.
    Returns::

        {"actions": [...], "journaled_actions": [...],
         "config": {...}, "snapshots": N}

    ``actions`` is the replay-derived stream (all ``proposed`` — dry-run
    never applies); ``journaled_actions`` is what the live run recorded.
    Comparing the two is the live-vs-replay divergence surface
    ``scripts/metrics_replay_torch.py`` prints.
    """
    if isinstance(records, str):
        records = read_journal(records)
    meta_cfg, meta_knobs = {}, {}
    for rec in records:
        if rec.get("kind") == "meta":
            meta_cfg = {k: v for k, v in (rec.get("config") or {}).items()
                        if k in DEFAULT_CONFIG and k != "knobs"}
            meta_knobs = rec.get("knobs") or {}
            break
    merged = dict(meta_cfg, dry_run=True)
    if config:
        merged.update(config)
    merged.setdefault("knobs", {})
    for name, initial in meta_knobs.items():
        if name in DEFAULT_KNOBS and initial is not None:
            merged["knobs"].setdefault(name, {})
            merged["knobs"][name].setdefault("initial", initial)
    journaled = [dict(r) for r in records if r.get("kind") == "action"]
    ring = _StaticRing()
    clock = {"now": 0.0}
    pilot = Autopilot(ring, config=merged, clock=lambda: clock["now"])
    actions = []
    snaps = sorted((r for r in records if r.get("kind") == "snapshot"),
                   key=lambda r: r.get("time", 0))
    for rec in snaps:
        now = rec.get("time", 0.0)
        clock["now"] = now
        for node, counters in ((rec.get("snapshot") or {})
                               .get("nodes") or {}).items():
            if isinstance(counters, dict):
                ring.append(node, now, counters)
        ring.trim(now - 2 * pilot.config["window_secs"])
        actions.extend(pilot.tick(now=now))
    return {"actions": actions, "journaled_actions": journaled,
            "config": pilot.config, "snapshots": len(snaps)}
