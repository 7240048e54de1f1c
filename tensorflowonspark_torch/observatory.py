"""Live driver-side observatory: time-series samples + HTTP exporter (the
port's copy of the JAX package's ``observatory`` module; only
:func:`build_info` differs, reporting torch and CUDA in place of jax).

The telemetry plane latches *latest* per-node counter snapshots
into the reservation server at heartbeat cadence and aggregates them on
demand — enough for a post-mortem, useless for watching a run approach the
MFU bar: a single latest value has no rate, and nothing serves it while
the job is alive.  This module closes both gaps without adding a single
dependency:

- :class:`SampleRing` — a bounded ring of ``(wall_ts, counters)`` samples
  per node, fed by the reservation server every time a heartbeat (or BYE)
  carries metrics.  Rates become derivable: ``items/s`` is the first/last
  delta over the window, dispatch-gap and queue-depth trends fall out the
  same way.
- :func:`render_prometheus` — the driver's current snapshot + ring in
  Prometheus text exposition format (version 0.0.4): ``HELP``/``TYPE``
  lines, sanitized metric names, per-executor labels, correct counter vs
  gauge typing (the telemetry ``_hwm``/``_max`` suffix convention maps to
  gauges, everything else to counters), and the Trainer's
  ``step_ms_le_<bound>`` counters folded into one proper histogram.
- :class:`ObservatoryServer` — a stdlib ``ThreadingHTTPServer`` serving
  ``GET /metrics`` (Prometheus text), ``GET /status`` (JSON:
  ``tf_status`` + ``metrics_snapshot`` + ring depths), and — when a
  watchtower is attached — ``GET /alerts`` (the bounded alert log) — and,
  when an autopilot is attached, ``GET /autopilot`` (knob values, pending
  action, bounded action log) — and, when a remediator is attached,
  ``GET /remediations`` (standing alerts, budgets, bounded action log),
  started by ``cluster.run(..., observatory=True)`` next to the
  rendezvous and stopped with it.  Every render works from ONE snapshot
  copy taken at scrape start, so a node dying mid-scrape can never
  produce a half-mutated exposition.

Metric vocabulary: every counter key that rides heartbeats appears as
``tfos_<key>_total`` (counter) or ``tfos_<key>`` (gauge, for ``_hwm`` /
``_max`` keys), labeled ``{executor="<id>"}``, plus the
cluster-level ``tfos_nodes``, ``tfos_scrapes_total``, and the windowed
``tfos_rate{key=...}`` gauges derived from the ring.  The serving
gateway registers in the same roster under ``job_name="serving"``
and exports through the same pipe: ``tfos_serving_requests_total`` /
``_rows_total`` / ``_batches_total`` / ``_compiles_total`` counters, the
``tfos_serving_shed_total{reason=}`` typed-shed family, the per-stage
request-latency histograms (``tfos_serving_{queue,coalesce,dispatch,
serialize,latency}_us``, each labeled ``model``/``version``), plus
``tfos_serving_p50_us_max`` / ``_p99_us_max``,
``tfos_serving_queue_depth_hwm`` and ``tfos_serving_batch_fill_pct_max``
gauges per replica.  ``tfos_up{executor=}`` (from the roster's heartbeat
ages) says which nodes are live, and ``GET /slow`` serves the fleet's
worst-request exemplars with their stage breakdowns.
"""

import json
import logging
import re
import threading
import time

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tensorflowonspark_torch import telemetry

logger = logging.getLogger(__name__)

__all__ = ["SampleRing", "render_prometheus", "ObservatoryServer",
           "effective_window", "build_info", "collect_slow",
           "DEFAULT_RING_CAPACITY"]

#: samples kept per node (at 1 s heartbeats: ~8.5 min of history)
DEFAULT_RING_CAPACITY = 512

# Prometheus metric-name charset ([a-zA-Z_:][a-zA-Z0-9_:]*); every rejected
# character collapses to "_".
_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")

# Keys with gauge semantics: high-water marks and latest-value readings
# (the merge_counters max-suffix convention, plus the runtime accountant's
# percentage/rate gauges which also use the _max suffix).
_GAUGE_SUFFIXES = ("_hwm", "_max")

# Bucketed histograms ride heartbeats as flat cumulative counters
# (``<prefix>_le_<bound>`` + ``<prefix>_count`` + ``<prefix>_sum_us``); the
# renderer reassembles each family per executor.  Spec rows are
# ``(key prefix, metric name, sum divisor, labeled with model/version?,
# help text)`` — the Trainer's step-time histogram plus the serving
# gateway's latency decomposition.  Serving families carry the
# ``model``/``version`` label dimension (stubbed to one value until the
# multi-model fleet) read from the replica's ``serving_model`` /
# ``serving_model_version`` heartbeat strings.
_HISTOGRAMS = (
    ("step_ms", "tfos_step_ms", 1000.0, False,
     "Step wall time per dispatch, milliseconds."),
    ("serving_queue_us", "tfos_serving_queue_us", 1.0, True,
     "Serving stage: queue wait from admission to batch collection, "
     "microseconds."),
    ("serving_coalesce_us", "tfos_serving_coalesce_us", 1.0, True,
     "Serving stage: batch coalescing from collection to dispatch start, "
     "microseconds."),
    ("serving_dispatch_us", "tfos_serving_dispatch_us", 1.0, True,
     "Serving stage: model dispatch (predict_feed), microseconds."),
    ("serving_serialize_us", "tfos_serving_serialize_us", 1.0, True,
     "Serving stage: result slicing + response write, microseconds."),
    ("serving_latency_us", "tfos_serving_latency_us", 1.0, True,
     "End-to-end serving request latency, admission to response written, "
     "microseconds."),
)

# Back-compat aliases (the step-time histogram predates the table above).
_HIST_PREFIX = "step_ms_le_"
_HIST_COUNT = "step_ms_count"
_HIST_SUM_US = "step_ms_sum_us"

# The typed shed split renders as one labeled family instead of four
# metric names; the bare ``serving_shed`` total is skipped on /metrics so
# sum(tfos_serving_shed_total) never double-counts.
_SHED_KEY = re.compile(r"serving_shed_([a-z_]+)\Z")


def _hist_spec_for(key):
    """The ``_HISTOGRAMS`` row owning a flat counter key, or None."""
    for spec in _HISTOGRAMS:
        prefix = spec[0]
        if (key.startswith(prefix + "_le_") or key == prefix + "_count"
                or key == prefix + "_sum_us"):
            return spec
    return None


def _model_labels(counters):
    """``,model="...",version="..."`` label suffix for serving families,
    from the replica's heartbeat strings (stubbed defaults otherwise)."""
    model = counters.get("serving_model")
    version = counters.get("serving_model_version")
    if not isinstance(model, str) or not model:
        model = "default"
    if not isinstance(version, str) or not version:
        version = "0"
    return ',model="%s",version="%s"' % (_escape_label(model),
                                         _escape_label(version))


def _metric_name(key):
    """``tfos_``-prefixed, charset-sanitized Prometheus metric name."""
    name = "tfos_" + _NAME_BAD.sub("_", str(key))
    if not _NAME_OK.match(name):  # first char still illegal after prefix
        name = "tfos_x" + _NAME_BAD.sub("_", str(key))
    return name


def _escape_label(value):
    return (str(value).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _fmt_value(value):
    if isinstance(value, float):
        return repr(value)
    return str(value)


def effective_window(samples):
    """Trim ``samples`` (``[(ts, counters), ...]`` newest-last) to the
    suffix after the most recent counter RESET.

    A replacement executor re-registers into the same slot with fresh
    zeroed counters, so a windowed first/last delta spanning the handover
    goes negative.  A reset is detected when any summing counter key
    present in both adjacent samples decreases; the window restarts at the
    newer sample, so rates reflect only the current incarnation.
    """
    if len(samples) < 2:
        return list(samples)
    start = 0
    for i in range(1, len(samples)):
        prev, cur = samples[i - 1][1], samples[i][1]
        if not isinstance(prev, dict) or not isinstance(cur, dict):
            continue
        for key, v1 in cur.items():
            if key.endswith(_GAUGE_SUFFIXES):
                continue
            if isinstance(v1, bool) or not isinstance(v1, (int, float)):
                continue
            v0 = prev.get(key)
            if (isinstance(v0, (int, float)) and not isinstance(v0, bool)
                    and v1 < v0):
                start = i
                break
    return list(samples[start:])


def build_info():
    """Static build/runtime facts for the ``tfos_build_info`` gauge.

    Reads torch strictly through ``sys.modules`` and names the card only
    where this process already initialized CUDA: a metrics scrape must
    never be what brings CUDA up on the driver, which forks the manager
    and the executors (a forked child of a CUDA process cannot use the
    card).
    """
    import sys

    from tensorflowonspark_torch import __version__

    info = {"version": __version__,
            "python": "%d.%d.%d" % sys.version_info[:3]}
    torch = sys.modules.get("torch")
    if torch is not None:
        info["torch"] = getattr(torch, "__version__", "unknown")
        cuda = getattr(getattr(torch, "version", None), "cuda", None)
        if cuda:
            info["cuda"] = cuda
        try:
            if torch.cuda.is_initialized():
                info["device"] = torch.cuda.get_device_name(
                    torch.cuda.current_device())
        except Exception:
            pass
    return info


class SampleRing(object):
    """Bounded per-node ring of timestamped counter samples.

    ``record`` is called from the reservation listener thread (one writer);
    ``series`` / ``rates`` may be called from any scraper thread.  All state
    lives behind one lock; readers get copies.
    """

    def __init__(self, capacity=DEFAULT_RING_CAPACITY):
        self.capacity = max(int(capacity), 2)
        self._lock = threading.Lock()
        self._rings = {}  # node id -> list of (ts, counters) newest-last

    def record(self, node_id, counters, ts=None):
        if not isinstance(counters, dict):
            return
        ts = time.time() if ts is None else ts
        with self._lock:
            ring = self._rings.setdefault(str(node_id), [])
            ring.append((ts, dict(counters)))
            if len(ring) > self.capacity:
                del ring[:len(ring) - self.capacity]

    def series(self):
        """``{node_id: [(ts, counters), ...]}`` — copies, newest last."""
        with self._lock:
            return {n: list(ring) for n, ring in self._rings.items()}

    def depths(self):
        with self._lock:
            return {n: len(ring) for n, ring in self._rings.items()}

    def rates(self, window_secs=60.0):
        """Per-node per-key rates over the trailing window.

        For each summing counter key (gauge-suffix keys are skipped), the
        delta between the newest sample and the oldest sample inside the
        window, over their timestamp span.  Nodes with fewer than two
        in-window samples contribute nothing.  When a replacement node's
        zeroed counters reset the series mid-window, the window restarts
        at the reset (:func:`effective_window`) so rates describe the
        current incarnation instead of going negative; until the new
        incarnation has two samples, the raw clamped window stands in
        (reset keys read 0.0).
        """
        out = {}
        now = time.time()
        for node_id, ring in self.series().items():
            raw = [(ts, c) for ts, c in ring if now - ts <= window_secs]
            in_window = effective_window(raw)
            if len(in_window) < 2:
                # A reset with only one sample after it can't yield a
                # current-incarnation rate yet; fall back to the raw
                # window, whose clamped deltas report the reset keys as
                # 0.0 (never negative) until a second sample lands.
                in_window = raw
            if len(in_window) < 2:
                continue
            (t0, c0), (t1, c1) = in_window[0], in_window[-1]
            span = t1 - t0
            if span <= 0:
                continue
            node_rates = {}
            for key, v1 in c1.items():
                if key.endswith(_GAUGE_SUFFIXES):
                    continue
                if isinstance(v1, bool) or not isinstance(v1, (int, float)):
                    continue
                v0 = c0.get(key, 0)
                if isinstance(v0, bool) or not isinstance(v0, (int, float)):
                    v0 = 0
                node_rates[key] = max(v1 - v0, 0) / span
            if node_rates:
                out[node_id] = node_rates
        return out


class _Families(object):
    """Accumulates samples grouped by metric family.

    The text format requires every sample of a family to sit in one
    contiguous block under its HELP/TYPE preamble — so samples are
    collected per family first and concatenated at the end, never
    interleaved per executor.
    """

    def __init__(self):
        self._order = []
        self._fam = {}  # name -> (mtype, help, [sample lines])

    def add(self, name, mtype, help_text, sample_line):
        fam = self._fam.get(name)
        if fam is None:
            fam = (mtype, help_text, [])
            self._fam[name] = fam
            self._order.append(name)
        fam[2].append(sample_line)

    def render(self):
        lines = []
        for name in self._order:
            mtype, help_text, samples = self._fam[name]
            lines.append("# HELP %s %s" % (name, help_text))
            lines.append("# TYPE %s %s" % (name, mtype))
            lines.extend(samples)
        return "\n".join(lines) + "\n"


def _render_histogram(fams, executor, counters, spec, extra_labels=""):
    """Reassemble one ``_HISTOGRAMS`` family's flat counters (cumulative
    ``<prefix>_le_<bound>`` keys) into a Prometheus histogram."""
    prefix, name, sum_divisor, _labeled, help_text = spec
    le_prefix = prefix + "_le_"
    buckets = {}
    for key, val in counters.items():
        if key.startswith(le_prefix):
            try:
                bound = float(key[len(le_prefix):].replace("_", "."))
            except ValueError:
                continue
            buckets[bound] = val
    count = counters.get(prefix + "_count")
    if not buckets and not count:
        return
    label = _escape_label(executor)
    cumulative = 0
    for bound in sorted(buckets):
        cumulative = buckets[bound]
        fams.add(name, "histogram", help_text,
                 '%s_bucket{executor="%s"%s,le="%s"} %s'
                 % (name, label, extra_labels, _fmt_value(float(bound)),
                    _fmt_value(buckets[bound])))
    inf_count = count if count is not None else cumulative
    fams.add(name, "histogram", help_text,
             '%s_bucket{executor="%s"%s,le="+Inf"} %s'
             % (name, label, extra_labels, _fmt_value(inf_count)))
    fams.add(name, "histogram", help_text,
             '%s_count{executor="%s"%s} %s'
             % (name, label, extra_labels, _fmt_value(inf_count)))
    sum_us = counters.get(prefix + "_sum_us", 0)
    fams.add(name, "histogram", help_text,
             '%s_sum{executor="%s"%s} %s'
             % (name, label, extra_labels,
                _fmt_value(sum_us / sum_divisor)))


def collect_slow(snapshot, limit=None):
    """Slow-request exemplars from a ``{"nodes": {id: counters}}``
    metrics snapshot, slowest first.

    Each serving replica rides its worst-request ring on heartbeats as the
    ``serving_slow`` list (latched latest-per-node like every other key);
    this flattens the per-node lists, tags each record with its executor,
    and orders by end-to-end latency.  Shared by ``GET /slow`` and the
    driver's ``tf_status`` latch so both views agree.
    """
    out = []
    for executor in sorted((snapshot or {}).get("nodes") or {}):
        counters = (snapshot["nodes"] or {}).get(executor)
        if not isinstance(counters, dict):
            continue
        for rec in counters.get("serving_slow") or ():
            if isinstance(rec, dict):
                out.append(dict(rec, executor=str(executor)))
    out.sort(key=lambda r: -(r.get("latency_us") or 0))
    return out[:limit] if limit else out


def render_prometheus(snapshot, ring=None, window_secs=60.0,
                      scrapes=None, alert_counts=None, info=None,
                      autopilot_counts=None, autopilot_ticks=None,
                      remediation_counts=None, coordinator=None,
                      beat_ages=None):
    """Prometheus text exposition (0.0.4) from one metrics snapshot.

    ``snapshot`` is the ``{"nodes": {id: counters}, "aggregate": {...}}``
    shape of ``Server.metrics_snapshot()`` — the caller takes it ONCE and
    hands it in, so the exposition is internally consistent even while
    nodes die underneath the scrape.  ``ring`` (a :class:`SampleRing`)
    contributes windowed rate gauges; ``alert_counts`` (``{rule: n}``,
    typically ``Watchtower.alert_counts``) the ``tfos_alerts_total``
    family; ``autopilot_counts`` (``{stage: n}``, typically
    ``Autopilot.action_counts``) the ``tfos_autopilot_actions_total``
    family plus ``tfos_autopilot_ticks_total``; ``remediation_counts``
    (``{action: {stage: n}}``, typically ``Remediator.action_counts``)
    the ``tfos_remediation_actions_total{action,stage}`` family; ``info``
    (:func:`build_info`) the ``tfos_build_info`` gauge; ``beat_ages``
    (``{executor: secs}``, typically ``Server.beat_ages`` — fenced/dead
    nodes already excluded) the ``tfos_up{executor=}`` liveness gauges,
    so a scraper can tell a fenced node (0) from a quiet one (1).
    """
    nodes = (snapshot or {}).get("nodes") or {}
    fams = _Families()

    if info:
        labels = ",".join('%s="%s"' % (_NAME_BAD.sub("_", str(k)),
                                       _escape_label(v))
                          for k, v in sorted(info.items()))
        fams.add("tfos_build_info", "gauge",
                 "Build/runtime identity of this observatory "
                 "(value is always 1).",
                 "tfos_build_info{%s} 1" % labels)
    fams.add("tfos_nodes", "gauge",
             "Nodes currently contributing metric snapshots.",
             "tfos_nodes %d" % len(nodes))
    if beat_ages is not None:
        beating = {str(ex) for ex in beat_ages}
        for ex in sorted(beating | {str(ex) for ex in nodes}):
            fams.add("tfos_up", "gauge",
                     "Executor liveness from roster heartbeat ages "
                     "(1 = beating, 0 = fenced or gone silent).",
                     'tfos_up{executor="%s"} %d'
                     % (_escape_label(ex), 1 if ex in beating else 0))
    if scrapes is not None:
        fams.add("tfos_scrapes_total", "counter",
                 "Scrapes served by this observatory endpoint.",
                 "tfos_scrapes_total %d" % scrapes)
    if alert_counts:
        for rule in sorted(alert_counts):
            fams.add("tfos_alerts_total", "counter",
                     "Watchtower alerts fired, by rule.",
                     'tfos_alerts_total{rule="%s"} %s'
                     % (_escape_label(rule),
                        _fmt_value(alert_counts[rule])))
    if autopilot_counts:
        for stage in sorted(autopilot_counts):
            fams.add("tfos_autopilot_actions_total", "counter",
                     "Autopilot control actions, by lifecycle stage "
                     "(proposed/applied/effect/kept/reverted).",
                     'tfos_autopilot_actions_total{stage="%s"} %s'
                     % (_escape_label(stage),
                        _fmt_value(autopilot_counts[stage])))
    if autopilot_ticks is not None:
        fams.add("tfos_autopilot_ticks_total", "counter",
                 "Autopilot controller ticks executed.",
                 "tfos_autopilot_ticks_total %d" % autopilot_ticks)
    if remediation_counts:
        for action in sorted(remediation_counts):
            stages = remediation_counts[action] or {}
            for stage in sorted(stages):
                fams.add("tfos_remediation_actions_total", "counter",
                         "Remediator topology actions, by action family "
                         "and lifecycle stage "
                         "(proposed/applied/effect/kept/reverted).",
                         'tfos_remediation_actions_total{action="%s",'
                         'stage="%s"} %s'
                         % (_escape_label(action), _escape_label(stage),
                            _fmt_value(stages[stage])))
    if coordinator:
        # Coordinator-HA plane (reservation.Server.ha_status): fencing
        # epoch, journal footprint, recovery/supersession state — the
        # takeover alert keys off tfos_coordinator_epoch increasing.
        fams.add("tfos_coordinator_epoch", "gauge",
                 "Fencing epoch of the serving coordinator (bumps on "
                 "every restart-in-place or standby takeover; 0 = "
                 "journal-less).",
                 "tfos_coordinator_epoch %s"
                 % _fmt_value(coordinator.get("epoch") or 0))
        fams.add("tfos_coordinator_journal_records_total", "counter",
                 "Ledger mutation records appended by this coordinator "
                 "incarnation.",
                 "tfos_coordinator_journal_records_total %s"
                 % _fmt_value(coordinator.get("journal_records") or 0))
        fams.add("tfos_coordinator_snapshots_total", "counter",
                 "Journal snapshot generations cut (sequence number).",
                 "tfos_coordinator_snapshots_total %s"
                 % _fmt_value(coordinator.get("snapshot_seq") or 0))
        fams.add("tfos_coordinator_recovered_nodes", "gauge",
                 "Roster entries restored from the journal at this "
                 "incarnation's start.",
                 "tfos_coordinator_recovered_nodes %s"
                 % _fmt_value(coordinator.get("recovered_nodes") or 0))
        fams.add("tfos_coordinator_superseded", "gauge",
                 "1 when this coordinator was fenced by a successor's "
                 "epoch (zombie; all requests answered ERR).",
                 "tfos_coordinator_superseded %d"
                 % (1 if coordinator.get("superseded_by") else 0))
        fams.add("tfos_coordinator_grace_remaining_seconds", "gauge",
                 "Seconds left in the post-takeover window during which "
                 "node liveness fencing is suppressed.",
                 "tfos_coordinator_grace_remaining_seconds %s"
                 % _fmt_value(coordinator.get("grace_remaining_secs") or 0))

    for executor in sorted(nodes):
        counters = nodes[executor]
        if not isinstance(counters, dict):
            continue
        model_labels = _model_labels(counters)
        for spec in _HISTOGRAMS:
            _render_histogram(fams, executor, counters, spec,
                              extra_labels=model_labels if spec[3] else "")
        for key in sorted(counters):
            val = counters[key]
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            if _hist_spec_for(key) is not None:
                continue  # folded into a histogram family above
            if key == "serving_shed":
                continue  # superseded by the labeled by-reason split
            shed = _SHED_KEY.match(key)
            if shed:
                fams.add("tfos_serving_shed_total", "counter",
                         "Requests shed by gateway admission control, by "
                         "typed reason.",
                         'tfos_serving_shed_total{executor="%s",'
                         'reason="%s"%s} %s'
                         % (_escape_label(executor),
                            _escape_label(shed.group(1)), model_labels,
                            _fmt_value(val)))
                continue
            if key.endswith(_GAUGE_SUFFIXES):
                name = _metric_name(key)
                mtype = "gauge"
                help_text = ("Latest %s reading reported per executor."
                             % key)
            else:
                name = _metric_name(key) + "_total"
                mtype = "counter"
                help_text = "Cumulative %s reported per executor." % key
            fams.add(name, mtype, help_text,
                     '%s{executor="%s"} %s'
                     % (name, _escape_label(executor), _fmt_value(val)))

    if ring is not None:
        for executor, node_rates in sorted(ring.rates(window_secs).items()):
            for key in sorted(node_rates):
                name = _metric_name(key) + "_per_sec"
                fams.add(name, "gauge",
                         "Windowed rate of %s (last %gs of heartbeat "
                         "samples)." % (key, window_secs),
                         '%s{executor="%s"} %s'
                         % (name, _escape_label(executor),
                            _fmt_value(node_rates[key])))
    return fams.render()


class ObservatoryServer(object):
    """Dependency-free driver HTTP endpoint: ``/metrics`` + ``/status``.

    ``snapshot_fn`` returns the ``{"nodes", "aggregate"}`` metrics snapshot
    (typically ``reservation.Server.metrics_snapshot``); ``status_fn``
    returns the JSON-ready ``/status`` extras (``tf_status``).  Both are
    called per request on the scraper's thread — they must be cheap and
    thread-safe, which the reservation server's copy-under-iteration
    snapshots are.  A snapshot is taken once per scrape and rendered from
    that copy, so mid-scrape node death yields a stale-but-consistent
    exposition, never a torn one.
    """

    def __init__(self, snapshot_fn, ring=None, status_fn=None,
                 host="0.0.0.0", port=0, window_secs=60.0,
                 profile_fn=None, profiler_addresses_fn=None,
                 capture_status_fn=None, watchtower=None, autopilot=None,
                 remediator=None, coordinator_fn=None, beat_ages_fn=None,
                 fleet=None):
        """``profile_fn(duration_ms=, steps=)`` backs ``GET /profile``
        (typically ``CaptureCoordinator.trigger``; 503 when absent).
        ``profiler_addresses_fn`` / ``capture_status_fn`` enrich ``/status``
        with the per-host profiler capture endpoints and the latest capture
        state — lazy callables, because the observatory starts before the
        roster exists.  ``watchtower`` (a ``watchtower.Watchtower``) backs
        ``GET /alerts``, the ``/status`` watchtower block, and the
        ``tfos_alerts_total`` counters on ``/metrics``.  ``autopilot`` (an
        ``autopilot.Autopilot``) backs ``GET /autopilot``, the ``/status``
        autopilot block, and the ``tfos_autopilot_*`` counters.
        ``remediator`` (a ``remediator.Remediator``) backs ``GET
        /remediations``, the ``/status`` remediator block, and the
        ``tfos_remediation_actions_total`` counters.
        ``coordinator_fn`` (typically ``reservation.Server.ha_status``)
        backs the ``/status`` coordinator block and the
        ``tfos_coordinator_*`` metrics (fencing epoch, journal footprint,
        takeover grace).  ``beat_ages_fn`` (typically
        ``reservation.Server.beat_ages``) backs the per-executor
        ``tfos_up`` liveness gauges."""
        self._snapshot_fn = snapshot_fn
        self._status_fn = status_fn
        self._coordinator_fn = coordinator_fn
        self._beat_ages_fn = beat_ages_fn
        self._profile_fn = profile_fn
        self._profiler_addresses_fn = profiler_addresses_fn
        self._capture_status_fn = capture_status_fn
        self.watchtower = watchtower
        self.autopilot = autopilot
        self.remediator = remediator
        self.fleet = fleet
        self._build_info = None
        self.ring = ring if ring is not None else SampleRing()
        self._window_secs = window_secs
        self._host = host
        self._port = int(port)
        self._httpd = None
        self._thread = None
        self._scrapes = 0
        self.addr = None

    # -- request handling --------------------------------------------------

    def _metrics_text(self):
        self._scrapes += 1
        try:
            snapshot = self._snapshot_fn()
        except Exception:
            logger.warning("observatory: snapshot failed", exc_info=True)
            snapshot = {}
        if self._build_info is None:
            try:
                self._build_info = build_info()
            except Exception:
                self._build_info = {}
        alert_counts = None
        if self.watchtower is not None:
            try:
                alert_counts = self.watchtower.alert_counts()
            except Exception:
                alert_counts = None
        autopilot_counts = None
        autopilot_ticks = None
        if self.autopilot is not None:
            try:
                pilot_status = self.autopilot.status()
                autopilot_counts = pilot_status.get("action_counts")
                autopilot_ticks = pilot_status.get("ticks")
            except Exception:
                autopilot_counts = None
                autopilot_ticks = None
        remediation_counts = None
        if self.remediator is not None:
            try:
                remediation_counts = self.remediator.action_counts()
            except Exception:
                remediation_counts = None
        coordinator = None
        if self._coordinator_fn is not None:
            try:
                coordinator = self._coordinator_fn()
            except Exception:
                coordinator = None
        beat_ages = None
        if self._beat_ages_fn is not None:
            try:
                beat_ages = self._beat_ages_fn()
            except Exception:
                beat_ages = None
        return render_prometheus(snapshot, ring=self.ring,
                                 window_secs=self._window_secs,
                                 scrapes=self._scrapes,
                                 alert_counts=alert_counts,
                                 info=self._build_info,
                                 autopilot_counts=autopilot_counts,
                                 autopilot_ticks=autopilot_ticks,
                                 remediation_counts=remediation_counts,
                                 coordinator=coordinator,
                                 beat_ages=beat_ages)

    def _slow_json(self, query):
        """``GET /slow``: the fleet's worst-request exemplars, slowest
        first — each with its request id, flow id, and stage breakdown."""
        import urllib.parse

        params = urllib.parse.parse_qs(query or "")
        try:
            limit = int(params["limit"][0]) if params.get("limit") else 16
        except ValueError:
            return 400, json.dumps({"error": "limit must be an integer"})
        try:
            snapshot = self._snapshot_fn()
        except Exception:
            logger.warning("observatory: snapshot failed", exc_info=True)
            snapshot = {}
        try:
            slow = collect_slow(snapshot)
            payload = {
                "time": time.time(),
                "count": len(slow),
                "slow": slow[:limit] if limit and limit > 0 else slow,
            }
        except Exception as e:
            logger.exception("observatory: /slow failed")
            return 500, json.dumps({"error": repr(e)})
        return 200, json.dumps(payload, default=str)

    def _alerts_json(self, query):
        if self.watchtower is None:
            return 503, json.dumps(
                {"error": "watchtower is not enabled on this cluster"})
        import urllib.parse

        params = urllib.parse.parse_qs(query or "")
        try:
            limit = int(params["limit"][0]) if params.get("limit") else None
        except ValueError:
            return 400, json.dumps({"error": "limit must be an integer"})
        try:
            payload = {
                "time": time.time(),
                "alerts": self.watchtower.alerts(limit=limit),
                "alert_counts": self.watchtower.alert_counts(),
                "suspects": {ex: a.get("rule") for ex, a
                             in self.watchtower.suspects().items()},
            }
        except Exception as e:
            logger.exception("observatory: /alerts failed")
            return 500, json.dumps({"error": repr(e)})
        return 200, json.dumps(payload, default=str)

    def _autopilot_json(self, query):
        if self.autopilot is None:
            return 503, json.dumps(
                {"error": "autopilot is not enabled on this cluster"})
        import urllib.parse

        params = urllib.parse.parse_qs(query or "")
        try:
            limit = int(params["limit"][0]) if params.get("limit") else None
        except ValueError:
            return 400, json.dumps({"error": "limit must be an integer"})
        try:
            payload = dict(self.autopilot.status(), time=time.time())
            if limit is not None:
                payload["actions"] = self.autopilot.actions(limit=limit)
        except Exception as e:
            logger.exception("observatory: /autopilot failed")
            return 500, json.dumps({"error": repr(e)})
        return 200, json.dumps(payload, default=str)

    def _remediations_json(self, query):
        if self.remediator is None:
            return 503, json.dumps(
                {"error": "remediator is not enabled on this cluster"})
        import urllib.parse

        params = urllib.parse.parse_qs(query or "")
        try:
            limit = int(params["limit"][0]) if params.get("limit") else None
        except ValueError:
            return 400, json.dumps({"error": "limit must be an integer"})
        try:
            payload = dict(self.remediator.status(), time=time.time())
            if limit is not None:
                payload["actions"] = self.remediator.actions(limit=limit)
        except Exception as e:
            logger.exception("observatory: /remediations failed")
            return 500, json.dumps({"error": repr(e)})
        return 200, json.dumps(payload, default=str)

    def _status_json(self):
        try:
            snapshot = self._snapshot_fn()
        except Exception:
            snapshot = {}
        status = {}
        if self._status_fn is not None:
            try:
                status = self._status_fn() or {}
            except Exception:
                status = {}
        payload = {
            "time": time.time(),
            "tf_status": status,
            "metrics_snapshot": snapshot,
            "series_depths": self.ring.depths(),
            "scrapes": self._scrapes,
        }
        # Capture-target discovery without driver access: the per-host
        # profiler capture endpoints (empty until the roster completes) and the
        # latest /profile capture's state.  Both lazy and guarded — the
        # endpoint must answer during bring-up too.
        if self._profiler_addresses_fn is not None:
            try:
                payload["profiler_addresses"] = (
                    self._profiler_addresses_fn() or {})
            except Exception:
                payload["profiler_addresses"] = {}
        if self._capture_status_fn is not None:
            try:
                payload["last_capture"] = self._capture_status_fn()
            except Exception:
                payload["last_capture"] = None
        if self.watchtower is not None:
            try:
                payload["watchtower"] = self.watchtower.status()
            except Exception:
                payload["watchtower"] = None
        if self.autopilot is not None:
            try:
                payload["autopilot"] = self.autopilot.status()
            except Exception:
                payload["autopilot"] = None
        if self.remediator is not None:
            try:
                payload["remediator"] = self.remediator.status()
            except Exception:
                payload["remediator"] = None
        if self._coordinator_fn is not None:
            try:
                payload["coordinator"] = self._coordinator_fn()
            except Exception:
                payload["coordinator"] = None
        # tf_status may hold arbitrary user values; never let one break
        # the endpoint
        return json.dumps(payload, default=str)

    def _profile_response(self, query):
        """Handle ``GET /profile``: parse the query, trigger a capture.
        Returns (http_status, json_body)."""
        if self._profile_fn is None:
            return 503, json.dumps(
                {"error": "profiling is not enabled on this cluster"})
        import urllib.parse

        params = urllib.parse.parse_qs(query or "")

        def _int_param(name):
            vals = params.get(name)
            if not vals:
                return None
            return int(vals[0])

        try:
            duration_ms = _int_param("duration_ms")
            steps = _int_param("steps")
        except ValueError:
            return 400, json.dumps(
                {"error": "duration_ms and steps must be integers"})
        try:
            result = self._profile_fn(duration_ms=duration_ms, steps=steps)
        except RuntimeError as e:
            # no targets yet / capture in flight: caller's problem, not ours
            return 409, json.dumps({"error": str(e)})
        except Exception as e:
            logger.exception("observatory: profile trigger failed")
            return 500, json.dumps({"error": repr(e)})
        return 200, json.dumps(result, default=str)

    def _fleet_json(self):
        """``GET /fleet``: the fleet plane's one-stop JSON — registry
        snapshot (models, versions, statuses, defaults), router status
        (replica table, picks, splits, sheds, budgets), and the canary
        controller's pending action + decision history.  503 until fleet
        objects are attached."""
        if not self.fleet:
            return 503, json.dumps({"error": "no fleet plane attached"})
        doc = {}
        try:
            reg = self.fleet.get("registry")
            if reg is not None:
                doc["registry"] = reg.snapshot()
            router = self.fleet.get("router")
            if router is not None:
                doc["router"] = router.status()
            canary = self.fleet.get("canary")
            if canary is not None:
                doc["canary"] = canary.status()
        except Exception as e:
            logger.exception("observatory: fleet surface failed")
            return 500, json.dumps({"error": repr(e)})
        return 200, json.dumps(doc, default=str)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        """Bind + serve on a daemon thread; returns ``(host, port)``."""
        observatory = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                try:
                    answer = self._answer()
                except Exception as e:
                    # a body that failed to render is answered 500 with its
                    # error: the connection is never dropped unanswered
                    logger.exception("observatory: GET %s failed", self.path)
                    answer = (500, json.dumps({"error": repr(e)}).encode(
                        "utf-8"), "application/json")
                if answer is None:
                    self.send_error(404)
                    return
                code, body, ctype = answer
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _answer(self):
                parts = self.path.split("?", 1)
                path = parts[0]
                query = parts[1] if len(parts) > 1 else ""
                code = 200
                if path == "/metrics":
                    body = observatory._metrics_text().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path in ("/status", "/status/"):
                    body = observatory._status_json().encode("utf-8")
                    ctype = "application/json"
                elif path in ("/profile", "/profile/"):
                    code, text = observatory._profile_response(query)
                    body = text.encode("utf-8")
                    ctype = "application/json"
                elif path in ("/alerts", "/alerts/"):
                    code, text = observatory._alerts_json(query)
                    body = text.encode("utf-8")
                    ctype = "application/json"
                elif path in ("/autopilot", "/autopilot/"):
                    code, text = observatory._autopilot_json(query)
                    body = text.encode("utf-8")
                    ctype = "application/json"
                elif path in ("/remediations", "/remediations/"):
                    code, text = observatory._remediations_json(query)
                    body = text.encode("utf-8")
                    ctype = "application/json"
                elif path in ("/fleet", "/fleet/"):
                    code, text = observatory._fleet_json()
                    body = text.encode("utf-8")
                    ctype = "application/json"
                elif path in ("/slow", "/slow/"):
                    code, text = observatory._slow_json(query)
                    body = text.encode("utf-8")
                    ctype = "application/json"
                elif path == "/":
                    body = (b"tfos observatory: /metrics /status "
                            b"/profile /alerts /autopilot /remediations "
                            b"/fleet /slow\n")
                    ctype = "text/plain; charset=utf-8"
                else:
                    return None
                return code, body, ctype

            def log_message(self, fmt, *args):  # quiet: no stderr per scrape
                logger.debug("observatory: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self._host, self._port), _Handler)
        self._httpd.daemon_threads = True
        self.addr = (self._host, self._httpd.server_address[1])
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.2},
                                        name="tfos-observatory", daemon=True)
        self._thread.start()
        logger.info("observatory serving /metrics and /status on %s:%d",
                    self.addr[0], self.addr[1])
        telemetry.get_tracer().instant("observatory/start",
                                       port=self.addr[1])
        return self.addr

    def stop(self):
        """Idempotent shutdown."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
