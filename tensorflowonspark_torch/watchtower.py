"""Watchtower: streaming straggler/anomaly detection over the observatory
(the port's copy of the JAX package's ``watchtower`` module).

The observability stack so far is *passive*: traces, a ``/metrics`` +
``/status`` exporter, on-demand device profiling — a straggling node or a
NaN'd loss is only visible if a human scrapes at the right moment, and all
metrics history dies with the run.  This module is the layer that watches
the stream:

- :class:`RuleEngine` — pure evaluation of detection rules over a
  per-node timeseries window (the :class:`~tensorflowonspark_torch.observatory.SampleRing`
  ``series()`` shape).  Cross-node straggler detection scores each node's
  windowed step time / dispatch gap / infeed starvation against the
  cluster median of its PEERS (leave-one-out: with the suspect excluded,
  a 2-node cluster still separates cleanly — the critical-path literature's
  "cluster step time is gated by the slowest participant" made actionable).
  Training-health rules watch the ``train_nonfinite_*`` tallies the
  Trainer now ships on heartbeats; plane-level rules watch MFU collapse
  against the run's own baseline, infeed-starved wall fraction, data
  service queue saturation, and heartbeat-miss streaks before the
  liveness fence fires.
- :class:`Watchtower` — the live driver-side wrapper: a daemon thread
  ticking the engine over the reservation server's sample ring, a BOUNDED
  alert log (``GET /alerts`` on the observatory), per-rule
  ``tfos_alerts_total`` counters, ``watchtower/alert`` trace instants (so
  alerts land on the merged Perfetto timeline next to the behavior that
  caused them), an optional suspect-node callback for the elastic
  recovery plane, and an append-only JSONL metrics journal under
  ``log_dir``.
- :func:`replay_journal` — re-runs the same rule engine over a journal
  offline, so post-mortems re-derive the alerts after the cluster is gone
  (``scripts/metrics_replay_torch.py`` is the CLI).

Every rule is deterministic given (series window, engine state), which is
what makes live detection and offline replay provably the same code path.
Alert dedup is time-based (:class:`AlertDeduper`): a (rule, executor) pair
re-fires only after ``cooldown_secs``, so a persistent straggler shows up
as a slow drumbeat instead of one alert per tick.

See docs/OBSERVABILITY.md ("Watchtower & alerting") for the rule
vocabulary, thresholds, journal format, and replay workflow.
"""

import collections
import json
import logging
import math
import os
import threading
import time

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.observatory import effective_window

logger = logging.getLogger(__name__)

__all__ = ["RuleEngine", "Watchtower", "AlertDeduper", "replay_journal",
           "read_journal", "DEFAULT_CONFIG", "JOURNAL_VERSION"]

#: journal format version (the "meta" record's ``version`` field)
JOURNAL_VERSION = 1

#: rules whose alerts carry a suspect-node verdict (fed to ``on_suspect``)
SUSPECT_RULES = ("straggler_step_time", "straggler_dispatch_gap",
                 "straggler_infeed", "heartbeat_miss")

#: every tunable threshold, in one place — docs/OBSERVABILITY.md documents
#: each; ``cluster.run(..., watchtower={...})`` and ``metrics_replay_torch.py
#: --config`` override key-wise
DEFAULT_CONFIG = {
    # sliding evaluation window over the per-node sample series
    "window_secs": 60.0,
    # live tick cadence of the Watchtower thread
    "interval_secs": 2.0,
    # a node needs this many in-window samples before rules score it
    "min_samples": 3,
    # straggler: leave-one-out z threshold and the scale floors that keep
    # tiny absolute jitter from minting infinite z-scores
    "straggler_z": 4.0,
    "straggler_rel_floor": 0.25,   # scale >= rel_floor * peer median
    "straggler_min_nodes": 2,
    # a node's window must contain this many steps/dispatches before its
    # per-event averages count: one mid-compile dispatch with zero accrued
    # gap would otherwise read as a 0ms signal and make healthy peers look
    # like outliers (a stalled node is heartbeat_miss/mfu territory, not a
    # straggler comparison)
    "straggler_min_events": 5,
    # absolute scale floors per straggler signal
    "straggler_step_floor_ms": 1.0,
    "straggler_gap_floor_ms": 1.0,
    "straggler_infeed_floor_frac": 0.05,
    # MFU collapse: alert when the latest window's MFU drops below
    # collapse_frac of the best MFU this run has shown (baseline must
    # clear floor_pct first, so warmup noise can't arm the rule)
    "mfu_collapse_frac": 0.5,
    "mfu_floor_pct": 1.0,
    # infeed starvation: windowed starved-wall fraction above this fires
    "infeed_starved_frac": 0.5,
    # data service: instantaneous prefetch-queue fill percentage at/above
    # this means the consumer is the bottleneck (producer pinned at cap)
    "queue_sat_pct": 95.0,
    # cache thrash: a window must evict at least this many entries, AND
    # evictions must reach this multiple of the window's cache hits, before
    # the worker chunk cache is declared thrashing (budget too small for
    # the working set — every insert evicts the entry the next split needs)
    "cache_thrash_min_evictions": 8,
    "cache_thrash_evict_hit_ratio": 1.0,
    # heartbeat-miss streak: newest sample older than interval * this
    # fires BEFORE the liveness fence (which waits heartbeat_misses beats)
    "heartbeat_miss_beats": 2.0,
    # serving SLO error budget (slo_budget_burn): multi-window burn-rate
    # alerting (the SRE-workbook shape) over each replica's cumulative
    # serving_slo_good/serving_slo_total counters.  slo_objective is the
    # good/total target fraction (e.g. 0.999; 0 disarms the rule — there
    # is no universal objective); burn = windowed error rate / (1 -
    # objective).  The rule PAGES (crit) when BOTH fast windows burn at
    # >= slo_burn_fast and TICKETS (warn) when both slow windows burn at
    # >= slo_burn_slow — the two-window AND is what survives traffic
    # swings: a spike trips the short window but not the long one, a slow
    # leak trips the long window while the short one has already calmed.
    # Window pairs are (short, long) seconds; the engine keeps its own
    # counter history sized to the longest window, so the sample ring's
    # window_secs does not cap the budget math.  A window with fewer than
    # slo_min_requests new requests abstains (no traffic != burning).
    "slo_objective": 0.0,
    "slo_fast_windows_secs": (300.0, 3600.0),
    "slo_slow_windows_secs": (1800.0, 21600.0),
    "slo_burn_fast": 14.4,
    "slo_burn_slow": 6.0,
    "slo_min_requests": 10,
    # alert plumbing
    "cooldown_secs": 30.0,
    "max_alerts": 256,
    # journal cadence for periodic metrics_snapshot records
    "journal_snapshot_secs": 10.0,
}


def _median(values):
    vals = sorted(values)
    n = len(vals)
    if not n:
        return None
    mid = n // 2
    if n % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])


def _is_num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _finite(v):
    return _is_num(v) and math.isfinite(v)


def _model_version_labels(counters):
    """``{"model": ..., "version": ...}`` from a serving node's latched
    ``serving_model`` / ``serving_model_version`` string counters — the
    per-model labels the fleet plane keys alerts on.  Empty for training
    nodes, so train-side alerts are unchanged."""
    out = {}
    if isinstance(counters, dict):
        if counters.get("serving_model") is not None:
            out["model"] = str(counters["serving_model"])
        if counters.get("serving_model_version") is not None:
            out["version"] = str(counters["serving_model_version"])
    return out


def json_safe(obj):
    """Deep-copy ``obj`` with nonfinite floats replaced by ``None`` so
    journal lines and ``GET /alerts`` bodies stay strict JSON (a NaN'd
    loss is exactly the value an alert wants to describe)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def window_deltas(samples):
    """Counter deltas over a post-reset sample window.

    ``samples`` is a node's in-window ``[(ts, counters), ...]`` (newest
    last).  The window restarts after the most recent counter reset
    (see :func:`~tensorflowonspark_torch.observatory.effective_window` — a
    replacement node re-registering with zeroed counters), then each
    numeric non-gauge key's newest-minus-oldest delta is returned along
    with the span::

        {"span_secs": float, "samples": int, "deltas": {key: delta},
         "first": counters, "last": counters}

    Returns ``None`` with fewer than two post-reset samples.
    """
    win = effective_window(samples)
    if len(win) < 2:
        return None
    (t0, c0), (t1, c1) = win[0], win[-1]
    span = t1 - t0
    if span <= 0:
        return None
    deltas = {}
    for key, v1 in c1.items():
        if key.endswith(("_hwm", "_max")) or not _is_num(v1):
            continue
        v0 = c0.get(key, 0)
        if not _is_num(v0):
            v0 = 0
        deltas[key] = v1 - v0
    return {"span_secs": span, "samples": len(win), "deltas": deltas,
            "first": c0, "last": c1}


class AlertDeduper(object):
    """Time-based (rule, executor) dedup shared by live ticking and replay.

    ``admit(alert)`` is True when the pair has not fired within
    ``cooldown_secs`` of the alert's own timestamp — replay feeds journal
    timestamps through the same gate, so the offline alert stream matches
    the live one instead of firing once per journal record.
    """

    def __init__(self, cooldown_secs):
        self.cooldown_secs = float(cooldown_secs)
        self._last = {}

    def admit(self, alert):
        key = (alert.get("rule"), alert.get("executor"))
        now = alert.get("time", 0.0)
        last = self._last.get(key)
        if last is not None and now - last < self.cooldown_secs:
            return False
        self._last[key] = now
        return True


class RuleEngine(object):
    """Deterministic rule evaluation over a per-node sample-series window.

    One instance per run (live or replay): rules keep per-run state here —
    the MFU baseline, the last-reported nonfinite tallies — so evaluation
    is a pure function of (series, now, accumulated state).

    ``heartbeat_interval`` arms the heartbeat-miss rule; ``None``/0 leaves
    it dormant (nothing to define a miss against).
    """

    def __init__(self, config=None, heartbeat_interval=None):
        self.config = dict(DEFAULT_CONFIG)
        if config:
            unknown = set(config) - set(DEFAULT_CONFIG)
            if unknown:
                raise ValueError(
                    "unknown watchtower config keys: {}".format(sorted(unknown)))
            self.config.update(config)
        self.heartbeat_interval = heartbeat_interval or 0.0
        # per-rule persistent state
        self._mfu_baseline = {}      # node -> best mfu_pct seen this run
        self._nonfinite_seen = {}    # node -> last reported tally total
        self._beat_ages = None       # per-evaluate liveness input
        self._coordinator = None     # per-evaluate HA status input
        self._last_epoch = None      # fencing epoch seen at last evaluate
        # (rule, executor) -> consecutive evaluates the pair has fired;
        # stamped on every alert as ``persists_windows`` so consumers (the
        # remediator's confirm gate) can tell one-shot from sustained
        # without keeping their own streak state
        self._persist = {}
        # SLO budget history: node -> [(ts, good, total), ...] newest-last.
        # Engine state (not the sample ring) because the slow burn windows
        # are hours while the ring holds ~8 minutes — and because replay
        # must rebuild the identical history from journal snapshots.
        self._slo_history = {}
        self.rules = (
            ("straggler_step_time", self._rule_straggler_step_time),
            ("straggler_dispatch_gap", self._rule_straggler_dispatch_gap),
            ("straggler_infeed", self._rule_straggler_infeed),
            ("nonfinite", self._rule_nonfinite),
            ("mfu_collapse", self._rule_mfu_collapse),
            ("infeed_starved", self._rule_infeed_starved),
            ("dataservice_saturation", self._rule_dataservice_saturation),
            ("cache_thrash", self._rule_cache_thrash),
            ("slo_budget_burn", self._rule_slo_budget_burn),
            ("heartbeat_miss", self._rule_heartbeat_miss),
            ("coordinator_takeover", self._rule_coordinator_takeover),
        )

    def active_rules(self):
        """Rule names in evaluation order (heartbeat_miss listed only when
        armed with an interval)."""
        names = [n for n, _ in self.rules]
        if not self.heartbeat_interval:
            names.remove("heartbeat_miss")
        return names

    # -- evaluation --------------------------------------------------------

    def evaluate(self, series, now=None, beat_ages=None, coordinator=None):
        """Run every rule over the trailing window of ``series`` (the
        ``SampleRing.series()`` shape: ``{node: [(ts, counters), ...]}``).
        Returns a list of alert dicts, most severe first within a tick.
        Dedup/cooldown is the CALLER's job (:class:`AlertDeduper`) — the
        engine itself is stateless across ticks except for run baselines.

        ``beat_ages`` (``reservation.Server.beat_ages()``): when given,
        the heartbeat-miss rule judges real beat silence — covering nodes
        whose beats carry no metrics — instead of sample-series age (the
        replay fallback, where only the journal's timestamps exist).

        ``coordinator`` (``reservation.Server.ha_status()``): when given,
        the coordinator-takeover rule watches the fencing epoch and fires
        a crit alert the tick it advances (a standby promoted).
        """
        now = time.time() if now is None else now
        w = self.config["window_secs"]
        window = {}
        for node, samples in series.items():
            in_win = [(ts, c) for ts, c in samples if now - ts <= w]
            if in_win:
                window[str(node)] = in_win
        self._beat_ages = beat_ages
        self._coordinator = coordinator
        alerts = []
        for name, rule in self.rules:
            try:
                alerts.extend(rule(window, now))
            except Exception:
                logger.warning("watchtower rule %s failed", name,
                               exc_info=True)
        # persistence streaks: a (rule, executor) pair that fired on the
        # previous evaluate too extends its streak, anything that went
        # quiet resets.  Engine state, so live and replay stamp the same
        # values (every alert is deduped AFTER this, by design — the
        # deduper's cooldown must not starve the streak).
        fresh = {}
        for a in alerts:
            key = (a.get("rule"), a.get("executor"))
            fresh[key] = max(fresh.get(key, 0),
                             self._persist.get(key, 0) + 1)
            a["persists_windows"] = fresh[key]
        self._persist = fresh
        order = {"crit": 0, "warn": 1}
        alerts.sort(key=lambda a: order.get(a.get("severity"), 2))
        return alerts

    def _alert(self, rule, now, executor=None, severity="warn", value=None,
               threshold=None, message="", **extra):
        a = {"rule": rule, "time": now, "executor": executor,
             "severity": severity, "value": value, "threshold": threshold,
             "message": message,
             "window_secs": self.config["window_secs"]}
        a.update(extra)
        return json_safe(a)

    # -- straggler family --------------------------------------------------

    def _signal_step_time_ms(self, d):
        steps = d["deltas"].get("step_ms_count", 0)
        if steps < self.config["straggler_min_events"]:
            return None
        return d["deltas"].get("step_ms_sum_us", 0) / steps / 1000.0

    def _signal_dispatch_gap_ms(self, d):
        n = d["deltas"].get("dispatch_count", 0)
        if n < self.config["straggler_min_events"]:
            return None
        return d["deltas"].get("dispatch_gap_us", 0) / n / 1000.0

    def _signal_infeed_frac(self, d):
        # Starvation accrues via dispatch gaps, so the same activity guard
        # applies: a window with one mid-compile dispatch reads 0s starved.
        starved = d["deltas"].get("goodput_infeed_starved_us")
        if starved is None or d["deltas"].get(
                "dispatch_count", 0) < self.config["straggler_min_events"]:
            return None
        return starved / (d["span_secs"] * 1e6)

    def _straggle(self, rule, window, now, signal, floor, unit):
        """Score each node's windowed signal against the median of its
        PEERS (leave-one-out).  z = (value - median(others)) / scale with
        scale = max(1.4826 * MAD(others), rel_floor * median, floor) — the
        robust z-score of the scheduling-straggler literature, with floors
        so microsecond jitter on an idle cluster cannot mint infinite z.
        """
        cfg = self.config
        values = {}
        windows = {}
        for node, samples in window.items():
            if len(samples) < cfg["min_samples"]:
                continue
            d = window_deltas(samples)
            if d is None:
                continue
            v = signal(d)
            if v is not None and _finite(v):
                values[node] = v
                windows[node] = d
        if len(values) < cfg["straggler_min_nodes"]:
            return []
        alerts = []
        for node, v in values.items():
            peers = [pv for pn, pv in values.items() if pn != node]
            med = _median(peers)
            mad = _median([abs(p - med) for p in peers]) or 0.0
            scale = max(1.4826 * mad, cfg["straggler_rel_floor"] * abs(med),
                        floor)
            z = (v - med) / scale
            if z >= cfg["straggler_z"]:
                d = windows[node]
                alerts.append(self._alert(
                    rule, now, executor=node, severity="warn", value=v,
                    threshold=cfg["straggler_z"], z=round(z, 2),
                    cluster_median=med,
                    # everything an action plane needs, without the ring:
                    # the scored value, the peer field it lost to, and the
                    # suspect's own window deltas
                    evidence={"value": v, "unit": unit,
                              "z": round(z, 2), "threshold_z":
                              cfg["straggler_z"], "peer_median": med,
                              "peers": len(peers),
                              "span_secs": round(d["span_secs"], 3),
                              "deltas": {k: d["deltas"][k] for k in
                                         ("step_ms_count", "step_ms_sum_us",
                                          "dispatch_count", "dispatch_gap_us",
                                          "goodput_infeed_starved_us")
                                         if k in d["deltas"]}},
                    message="executor {} {}={:.3g}{} vs peer median "
                            "{:.3g}{} (z={:.1f})".format(
                                node, rule.replace("straggler_", ""), v,
                                unit, med, unit, z)))
        return alerts

    def _rule_straggler_step_time(self, window, now):
        return self._straggle(
            "straggler_step_time", window, now, self._signal_step_time_ms,
            self.config["straggler_step_floor_ms"], "ms")

    def _rule_straggler_dispatch_gap(self, window, now):
        return self._straggle(
            "straggler_dispatch_gap", window, now,
            self._signal_dispatch_gap_ms,
            self.config["straggler_gap_floor_ms"], "ms")

    def _rule_straggler_infeed(self, window, now):
        return self._straggle(
            "straggler_infeed", window, now, self._signal_infeed_frac,
            self.config["straggler_infeed_floor_frac"], "")

    # -- training health ---------------------------------------------------

    def _rule_nonfinite(self, window, now):
        """Fire whenever a node's cumulative nonfinite tallies (the
        Trainer's ``train_nonfinite_loss`` / ``train_nonfinite_grad``
        window-boundary counters, or a serving replica's
        ``serving_nonfinite`` output-poison counter) grow past what this
        engine already reported — one alert per NEW corruption, not one
        per tick.  Serving alerts carry the replica's latched
        model/version labels so the fleet's canary controller can match
        the poison to the version it is canarying."""
        alerts = []
        for node, samples in window.items():
            _, latest = samples[-1]
            total = 0
            detail = {}
            for key in ("train_nonfinite_loss", "train_nonfinite_grad",
                        "serving_nonfinite"):
                v = latest.get(key, 0)
                if _is_num(v) and v > 0:
                    total += v
                    detail[key] = v
            seen = self._nonfinite_seen.get(node, 0)
            if total > seen:
                self._nonfinite_seen[node] = total
                labels = _model_version_labels(latest)
                alerts.append(self._alert(
                    "nonfinite", now, executor=node, severity="crit",
                    value=total, threshold=0,
                    # the rollback plane needs WHERE the run was when the
                    # corruption surfaced — the step tally bounds the
                    # poison step without another ring query
                    evidence=dict(detail, new=total - seen,
                                  train_steps_total=latest.get(
                                      "train_steps_total"),
                                  train_loss_max=latest.get(
                                      "train_loss_max"),
                                  train_grad_norm_max=latest.get(
                                      "train_grad_norm_max")),
                    message="executor {} reported {} nonfinite "
                            "value(s): {}".format(node, total, detail or
                                                  {"total": total}),
                    **dict(detail, **labels)))
        return alerts

    # -- plane-level rules -------------------------------------------------

    def _rule_mfu_collapse(self, window, now):
        """Alert when a node's latest-window MFU falls below
        ``mfu_collapse_frac`` of the best MFU this run has demonstrated on
        that node (the run is its own baseline; ``mfu_floor_pct`` keeps a
        run that never achieved real MFU from arming the rule)."""
        cfg = self.config
        alerts = []
        for node, samples in window.items():
            _, latest = samples[-1]
            mfu = latest.get("train_mfu_pct_max")
            if not _finite(mfu):
                continue
            base = self._mfu_baseline.get(node, 0.0)
            if mfu > base:
                self._mfu_baseline[node] = base = mfu
            if (base >= cfg["mfu_floor_pct"]
                    and mfu < cfg["mfu_collapse_frac"] * base):
                alerts.append(self._alert(
                    "mfu_collapse", now, executor=node, severity="warn",
                    value=mfu, threshold=cfg["mfu_collapse_frac"] * base,
                    baseline=base,
                    message="executor {} MFU {:.2f}% collapsed below "
                            "{:.0f}% of run baseline {:.2f}%".format(
                                node, mfu, 100 * cfg["mfu_collapse_frac"],
                                base)))
        return alerts

    def _rule_infeed_starved(self, window, now):
        """Alert when a node spends more than ``infeed_starved_frac`` of
        the window's wall time starved for input (the tf.data-service
        paper's first-class production signal)."""
        cfg = self.config
        alerts = []
        for node, samples in window.items():
            if len(samples) < cfg["min_samples"]:
                continue
            d = window_deltas(samples)
            if d is None:
                continue
            frac = self._signal_infeed_frac(d)
            if frac is not None and frac >= cfg["infeed_starved_frac"]:
                alerts.append(self._alert(
                    "infeed_starved", now, executor=node, severity="warn",
                    value=round(frac, 4),
                    threshold=cfg["infeed_starved_frac"],
                    message="executor {} infeed-starved {:.0f}% of the "
                            "last {:.0f}s".format(node, 100 * frac,
                                                  d["span_secs"])))
        return alerts

    def _rule_dataservice_saturation(self, window, now):
        """Alert when a consumer's data-service prefetch queue sits at
        capacity (``dataservice_queue_sat_pct_max`` gauge): the producer is
        pinned against a slow consumer — the inverse of starvation, and the
        signal that feed workers are over-provisioned for this node."""
        cfg = self.config
        alerts = []
        for node, samples in window.items():
            _, latest = samples[-1]
            sat = latest.get("dataservice_queue_sat_pct_max")
            if _finite(sat) and sat >= cfg["queue_sat_pct"]:
                d = window_deltas(samples)
                alerts.append(self._alert(
                    "dataservice_saturation", now, executor=node,
                    severity="warn", value=sat,
                    threshold=cfg["queue_sat_pct"],
                    evidence={"queue_sat_pct": sat,
                              "threshold_pct": cfg["queue_sat_pct"],
                              "queue_bound": latest.get(
                                  "dataservice_queue_bound_max"),
                              "span_secs": (round(d["span_secs"], 3)
                                            if d else None),
                              "items_delta": (d["deltas"].get(
                                  "dataservice_items", 0) if d else None),
                              "stall_delta": (d["deltas"].get(
                                  "dataservice_stall_secs", 0)
                                  if d else None)},
                    message="executor {} data-service prefetch queue at "
                            "{:.0f}% fill".format(node, sat)))
        return alerts

    def _rule_cache_thrash(self, window, now):
        """Alert on a sustained eviction-dominated window of the worker
        chunk cache (``dataservice_cache_evictions`` vs ``_hit`` deltas):
        the byte budget is smaller than the epoch working set, so entries
        are evicted before their epoch-2 replay — all of the cache's memory
        cost, none of its hit rate.  The fix is a bigger ``cache_bytes``
        (or disk spill), not more workers."""
        cfg = self.config
        alerts = []
        for node, samples in window.items():
            if len(samples) < cfg["min_samples"]:
                continue
            d = window_deltas(samples)
            if d is None:
                continue
            evictions = d["deltas"].get("dataservice_cache_evictions", 0)
            hits = d["deltas"].get("dataservice_cache_hit", 0)
            spill_bytes = d["deltas"].get("dataservice_cache_spill_bytes", 0)
            if evictions < cfg["cache_thrash_min_evictions"]:
                continue
            ratio = evictions / max(float(hits), 1.0)
            if ratio >= cfg["cache_thrash_evict_hit_ratio"]:
                # the spill delta separates "entries silently dropped"
                # (no spill dir: capacity loss) from "disk churning under
                # the eviction storm" (spill armed: I/O cost)
                alerts.append(self._alert(
                    "cache_thrash", now, executor=node, severity="warn",
                    value=round(ratio, 3),
                    threshold=cfg["cache_thrash_evict_hit_ratio"],
                    evictions=evictions, hits=hits,
                    spill_bytes=spill_bytes,
                    message="executor {} chunk cache thrashing: {} "
                            "evictions vs {} hits in {:.0f}s{} — raise "
                            "cache_bytes / TFOS_DS_CACHE_BYTES".format(
                                node, evictions, hits, d["span_secs"],
                                (" ({} B spilled)".format(spill_bytes)
                                 if spill_bytes else ""))))
        return alerts

    def _slo_window_burn(self, hist, now, window_secs, budget):
        """Burn rate over the trailing ``window_secs`` of one node's
        ``(ts, good, total)`` history: (bad delta / total delta) / budget.
        Returns ``{"burn", "err_rate", "requests", "span_secs"}`` or None
        when the window holds fewer than two points or fewer than
        ``slo_min_requests`` new requests (abstain, never vote)."""
        base = None
        for point in hist:
            if now - point[0] <= window_secs:
                base = point
                break
        newest = hist[-1]
        if base is None or base is newest:
            return None
        requests = newest[2] - base[2]
        if requests < self.config["slo_min_requests"]:
            return None
        bad = requests - (newest[1] - base[1])
        err_rate = bad / float(requests)
        return {"burn": err_rate / budget,
                "err_rate": err_rate,
                "requests": requests,
                "span_secs": newest[0] - base[0]}

    def _rule_slo_budget_burn(self, window, now):
        """Multi-window SLO error-budget burn (SRE workbook ch.5) over the
        serving counters: every replica's cumulative ``serving_slo_good``
        / ``serving_slo_total`` pair is folded into engine-held history,
        and the burn rate — windowed error rate over the error budget
        ``1 - slo_objective`` — is read over two window pairs.  Both fast
        windows burning at >= ``slo_burn_fast`` is a PAGE (crit: the
        budget dies in hours); both slow windows at >= ``slo_burn_slow``
        is a TICKET (warn: a slow leak).  Disarmed by default
        (``slo_objective`` 0).  The alert carries per-window evidence plus
        the window's shed count so the responder can tell "overloaded and
        shedding" from "slow but admitting"."""
        cfg = self.config
        objective = cfg["slo_objective"]
        if not objective:
            return []
        budget = max(1.0 - float(objective), 1e-9)
        fast_windows = tuple(cfg["slo_fast_windows_secs"])
        slow_windows = tuple(cfg["slo_slow_windows_secs"])
        max_window = max(fast_windows + slow_windows)
        # fold the newest reading per in-window node into the history
        for node, samples in window.items():
            latest = samples[-1][1]
            total = latest.get("serving_slo_total")
            good = latest.get("serving_slo_good")
            if not _finite(total):
                continue
            good = good if _finite(good) else 0
            hist = self._slo_history.setdefault(node, [])
            if hist and total < hist[-1][2]:
                del hist[:]  # replica restarted with zeroed counters
            if hist and now <= hist[-1][0]:
                continue     # duplicate or backwards tick
            hist.append((now, good, total))
            cutoff = now - max_window
            keep = 0
            while (keep < len(hist) - 1 and hist[keep + 1][0] <= cutoff):
                keep += 1
            del hist[:keep]  # keep one point older than the longest window
        alerts = []
        for node, samples in window.items():
            hist = self._slo_history.get(node)
            if not hist or len(hist) < 2:
                continue
            fast = [self._slo_window_burn(hist, now, w, budget)
                    for w in fast_windows]
            slow = [self._slo_window_burn(hist, now, w, budget)
                    for w in slow_windows]
            page = all(b is not None and b["burn"] >= cfg["slo_burn_fast"]
                       for b in fast)
            ticket = all(b is not None and b["burn"] >= cfg["slo_burn_slow"]
                         for b in slow)
            if not page and not ticket:
                continue
            which, windows_secs, threshold = (
                (fast, fast_windows, cfg["slo_burn_fast"]) if page
                else (slow, slow_windows, cfg["slo_burn_slow"]))
            d = window_deltas(samples)
            shed = (d["deltas"].get("serving_shed", 0) if d else 0)
            windows_evidence = {
                "{:g}s".format(w): {"burn": round(b["burn"], 3),
                                    "err_rate": round(b["err_rate"], 5),
                                    "requests": b["requests"]}
                for w, b in zip(fast_windows + slow_windows, fast + slow)
                if b is not None}
            alerts.append(self._alert(
                "slo_budget_burn", now, executor=node,
                severity="crit" if page else "warn",
                value=round(min(b["burn"] for b in which), 3),
                threshold=threshold,
                kind="page" if page else "ticket",
                objective=objective, shed=shed,
                # version-labeled burn: the fleet's canary rollback and
                # the remediator's per-model scale-out both key on these
                **_model_version_labels(samples[-1][1]),
                evidence={"objective": objective,
                          "budget": round(budget, 6),
                          "kind": "page" if page else "ticket",
                          "windows": windows_evidence,
                          "good": hist[-1][1], "total": hist[-1][2],
                          "shed": shed},
                message="replica {} burning SLO error budget ({}): "
                        "{} over {} (objective {:.4%}, err rate "
                        "{:.2%}, {} shed)".format(
                            node, "page" if page else "ticket",
                            " / ".join("{:.1f}x".format(b["burn"])
                                       for b in which),
                            " / ".join("{:g}s".format(w)
                                       for w in windows_secs),
                            objective, which[0]["err_rate"], shed)))
        return alerts

    def _rule_heartbeat_miss(self, window, now):
        """Pre-fence miss-streak detection: a node whose newest
        metrics-bearing sample is older than ``heartbeat_interval *
        heartbeat_miss_beats`` is going silent — the liveness monitor will
        not fence it until ``heartbeat_misses`` (typically 3) intervals
        pass, so this alert leads the fence by design."""
        if not self.heartbeat_interval:
            return []
        cfg = self.config
        deadline = self.heartbeat_interval * cfg["heartbeat_miss_beats"]
        if self._beat_ages is not None:
            ages = dict(self._beat_ages)
        else:
            ages = {node: now - samples[-1][0]
                    for node, samples in window.items()}
        alerts = []
        for node, age in ages.items():
            if age >= deadline:
                alerts.append(self._alert(
                    "heartbeat_miss", now, executor=node, severity="warn",
                    value=round(age, 3), threshold=deadline,
                    missed_beats=round(age / self.heartbeat_interval, 1),
                    message="executor {} silent for {:.1f}s (~{:.1f} "
                            "beats); fence at {:.1f}s".format(
                                node, age, age / self.heartbeat_interval,
                                self.heartbeat_interval * 3)))
        return alerts

    def _rule_coordinator_takeover(self, window, now):
        """Fencing-epoch watch: the epoch advances exactly once per
        coordinator incarnation (``standby.advance_epoch``), so an
        increase mid-run means a warm standby promoted — the primary
        died or stalled past the takeover threshold.  The first epoch
        observed is the baseline (the run's own claim is not a
        takeover)."""
        ha = self._coordinator
        if not ha:
            return []
        epoch = ha.get("epoch")
        if not epoch:
            return []
        if self._last_epoch is None:
            self._last_epoch = epoch
            return []
        if epoch <= self._last_epoch:
            return []
        previous, self._last_epoch = self._last_epoch, epoch
        return [self._alert(
            "coordinator_takeover", now, severity="crit", value=epoch,
            threshold=previous,
            grace_remaining_secs=ha.get("grace_remaining_secs"),
            recovered_nodes=ha.get("recovered_nodes"),
            message="coordinator fencing epoch advanced {} -> {}: a warm "
                    "standby took over; liveness fencing suppressed for "
                    "{}s".format(previous, epoch,
                                 ha.get("grace_remaining_secs")))]


class Watchtower(object):
    """Live driver-side streaming evaluator over the observatory's ring.

    Args:
      ring: the :class:`~tensorflowonspark_torch.observatory.SampleRing` the
        reservation server feeds (``server.sample_ring``).
      snapshot_fn: zero-arg callable returning the
        ``{"nodes", "aggregate"}`` metrics snapshot — journaled
        periodically so replay has the cumulative series.
      heartbeat_interval: arms the heartbeat-miss rule.
      config: key-wise overrides of :data:`DEFAULT_CONFIG`.
      journal_path: append-only JSONL journal file (parent dirs created);
        ``None`` disables journaling.
      on_alert: optional ``fn(alert_dict)`` per admitted alert.  This is
        the watchtower→autopilot bridge: ``cluster.run(autopilot=...)``
        wires ``Autopilot.observe_alert`` here, turning performance alerts
        (``infeed_starved``, ``dataservice_saturation``, ``cache_thrash``,
        ``slo_budget_burn``) into timestamped retune hints the controller
        may act on when its own window sensors are silent (see
        ``autopilot.ALERT_HINTS``).  The callback runs on the watchtower
        tick thread — keep it cheap.
      on_suspect: optional ``fn(executor_id, alert_dict)`` fired for
        :data:`SUSPECT_RULES` verdicts — the hook the elastic-recovery
        plane consumes (see docs/FAULT_TOLERANCE.md).
      beat_ages_fn: optional zero-arg callable returning per-executor
        heartbeat silence (``reservation.Server.beat_ages``) — the
        heartbeat-miss rule then judges real beats instead of
        metrics-sample age.
      coordinator_fn: optional zero-arg callable returning the
        coordinator's HA status (``reservation.Server.ha_status``) — arms
        the coordinator-takeover rule (crit on fencing-epoch advance).
      clock: injectable time source (tests).
    """

    def __init__(self, ring, snapshot_fn=None, heartbeat_interval=None,
                 config=None, journal_path=None, on_alert=None,
                 on_suspect=None, beat_ages_fn=None, coordinator_fn=None,
                 clock=time.time):
        self.engine = RuleEngine(config, heartbeat_interval)
        cfg = self.engine.config
        self.ring = ring
        self._snapshot_fn = snapshot_fn
        self._beat_ages_fn = beat_ages_fn
        self._coordinator_fn = coordinator_fn
        self._on_alert = on_alert
        self._on_suspect = on_suspect
        self._clock = clock
        self.journal_path = journal_path
        self._journal = None
        self._journal_lock = threading.Lock()
        self._last_journal_snap = 0.0
        self._dedup = AlertDeduper(cfg["cooldown_secs"])
        self._alerts = collections.deque(maxlen=int(cfg["max_alerts"]))
        self._counts = {}
        self._suspects = {}
        self._ticks = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Start the evaluation thread (idempotent); returns self."""
        if self._thread is not None:
            return self
        self._journal_meta()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="tfos-watchtower", daemon=True)
        self._thread.start()
        telemetry.get_tracer().instant(
            "watchtower/start", rules=len(self.engine.active_rules()),
            window_secs=self.engine.config["window_secs"])
        return self

    def stop(self):
        """Stop the thread, run one final tick, journal a final snapshot,
        and close the journal.  Idempotent."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
            try:
                self.tick()  # final evaluation over the closing state
            except Exception:
                logger.debug("watchtower final tick failed", exc_info=True)
            self._journal_snapshot(force=True)
        with self._journal_lock:
            j, self._journal = self._journal, None
            if j is not None:
                try:
                    j.close()
                except OSError:
                    pass

    def _loop(self):
        interval = self.engine.config["interval_secs"]
        while not self._stop.wait(interval):
            try:
                self.tick()
            except Exception:  # the watcher must never take the run down
                logger.warning("watchtower tick failed", exc_info=True)

    # -- evaluation tick ---------------------------------------------------

    def tick(self, now=None):
        """One evaluation pass; returns the alerts ADMITTED this tick.
        Public so tests and the final-stop path can drive it directly."""
        now = self._clock() if now is None else now
        series = self.ring.series()
        ages = None
        if self._beat_ages_fn is not None:
            try:
                ages = self._beat_ages_fn()
            except Exception:
                ages = None
        ha = None
        if self._coordinator_fn is not None:
            try:
                ha = self._coordinator_fn()
            except Exception:
                ha = None
        admitted = []
        for alert in self.engine.evaluate(series, now, beat_ages=ages,
                                          coordinator=ha):
            if not self._dedup.admit(alert):
                continue
            admitted.append(alert)
            self._record(alert)
        with self._lock:
            self._ticks += 1
        self._journal_snapshot(now=now)
        return admitted

    def _record(self, alert):
        with self._lock:
            self._alerts.append(alert)
            rule = alert.get("rule", "?")
            self._counts[rule] = self._counts.get(rule, 0) + 1
            if rule in SUSPECT_RULES and alert.get("executor") is not None:
                self._suspects[str(alert["executor"])] = alert
        # flatten for the trace instant: Perfetto args are flat key/values
        telemetry.get_tracer().instant(
            "watchtower/alert", rule=alert.get("rule"),
            executor=alert.get("executor"), severity=alert.get("severity"),
            value=alert.get("value"), message=alert.get("message"))
        logger.warning("watchtower alert [%s] %s", alert.get("rule"),
                       alert.get("message"))
        self._journal_write(dict(alert, kind="alert"))
        if self._on_alert is not None:
            try:
                self._on_alert(alert)
            except Exception:
                logger.warning("watchtower on_alert callback failed",
                               exc_info=True)
        if (self._on_suspect is not None
                and alert.get("rule") in SUSPECT_RULES
                and alert.get("executor") is not None):
            try:
                self._on_suspect(alert["executor"], alert)
            except Exception:
                logger.warning("watchtower on_suspect callback failed",
                               exc_info=True)

    # -- read surface (observatory endpoints) ------------------------------

    def alerts(self, limit=None):
        """Newest-last copies of the bounded alert log."""
        with self._lock:
            out = list(self._alerts)
        if limit is not None:
            out = out[-int(limit):]
        return out

    def alert_counts(self):
        """``{rule: alerts fired}`` — the ``tfos_alerts_total`` source."""
        with self._lock:
            return dict(self._counts)

    def suspects(self):
        """``{executor: latest suspect alert}`` for the recovery plane."""
        with self._lock:
            return dict(self._suspects)

    def status(self):
        """The ``/status`` ``watchtower`` block."""
        with self._lock:
            return {
                "active_rules": self.engine.active_rules(),
                "ticks": self._ticks,
                "window_secs": self.engine.config["window_secs"],
                "interval_secs": self.engine.config["interval_secs"],
                "alert_counts": dict(self._counts),
                "alerts": list(self._alerts)[-10:],
                "suspects": {ex: a.get("rule")
                             for ex, a in self._suspects.items()},
                "journal": self.journal_path,
            }

    def ring_tail(self, depth=32):
        """Last ``depth`` samples per node, JSON-ready — the flight
        recorder's metric trajectory (see telemetry.register_flight_source).
        """
        return {node: [[ts, json_safe(c)] for ts, c in samples[-depth:]]
                for node, samples in self.ring.series().items()}

    # -- journal -----------------------------------------------------------

    def _journal_open(self):
        if self.journal_path is None:
            return None
        if self._journal is None:
            parent = os.path.dirname(os.path.abspath(self.journal_path))
            os.makedirs(parent, exist_ok=True)
            self._journal = open(self.journal_path, "a")
        return self._journal

    def _journal_write(self, record):
        with self._journal_lock:
            try:
                j = self._journal_open()
                if j is None:
                    return
                j.write(json.dumps(json_safe(record), default=str) + "\n")
                j.flush()  # journal must survive a driver crash mid-run
            except Exception:
                logger.warning("watchtower journal write failed",
                               exc_info=True)

    def _journal_meta(self):
        self._journal_write({
            "kind": "meta", "version": JOURNAL_VERSION,
            "time": self._clock(),
            "heartbeat_interval": self.engine.heartbeat_interval,
            "config": self.engine.config,
        })

    def _journal_snapshot(self, now=None, force=False):
        if self.journal_path is None:
            return
        now = self._clock() if now is None else now
        every = self.engine.config["journal_snapshot_secs"]
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
            return  # nothing reported yet: an empty record helps nobody
        self._journal_write({"kind": "snapshot", "time": now,
                             "snapshot": snap})


# -- offline replay --------------------------------------------------------

def read_journal(path):
    """Parse a journal file into records (malformed lines are skipped with
    a warning, so a journal truncated by a crash still replays)."""
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                logger.warning("%s:%d: skipping malformed journal line",
                               path, lineno)
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def replay_journal(records, config=None, heartbeat_interval=None):
    """Re-run the rule engine over journal ``records`` (a path or the
    :func:`read_journal` list) exactly as the live Watchtower would have.

    The journal's own ``meta`` record supplies the run's config and
    heartbeat interval unless overridden.  Snapshot records rebuild the
    per-node cumulative series; the engine is ticked at each snapshot's
    timestamp through the same :class:`AlertDeduper`.  Returns::

        {"alerts": [...], "journaled_alerts": [...],
         "series": {node: [(ts, counters), ...]},
         "config": {...}, "snapshots": N}
    """
    if isinstance(records, str):
        records = read_journal(records)
    meta_cfg, meta_hb = {}, None
    for rec in records:
        if rec.get("kind") == "meta":
            meta_cfg = {k: v for k, v in (rec.get("config") or {}).items()
                        if k in DEFAULT_CONFIG}
            meta_hb = rec.get("heartbeat_interval")
            break
    merged = dict(meta_cfg)
    if config:
        merged.update(config)
    hb = heartbeat_interval if heartbeat_interval is not None else meta_hb
    engine = RuleEngine(merged or None, hb)
    dedup = AlertDeduper(engine.config["cooldown_secs"])
    series = {}
    alerts = []
    journaled = []
    snapshots = 0
    snaps = sorted((r for r in records if r.get("kind") == "snapshot"),
                   key=lambda r: r.get("time", 0))
    for rec in records:
        if rec.get("kind") == "alert":
            journaled.append({k: v for k, v in rec.items() if k != "kind"})
    for rec in snaps:
        now = rec.get("time", 0.0)
        nodes = (rec.get("snapshot") or {}).get("nodes") or {}
        for node, counters in nodes.items():
            if isinstance(counters, dict):
                series.setdefault(str(node), []).append((now, counters))
        snapshots += 1
        # bound memory: rules only look one window back
        horizon = now - 2 * engine.config["window_secs"]
        for node in list(series):
            series[node] = [(ts, c) for ts, c in series[node]
                            if ts >= horizon]
        for alert in engine.evaluate(series, now):
            if dedup.admit(alert):
                alerts.append(alert)
    return {"alerts": alerts, "journaled_alerts": journaled,
            "series": series, "config": engine.config,
            "snapshots": snapshots}
