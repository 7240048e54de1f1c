"""Cluster-wide telemetry plane: span tracing, counters, flight recorder.

Three legs, all dependency-free:

1. **Lifecycle span tracing** — a process-local :class:`Tracer` with
   ``span(name, **attrs)`` context managers and ``instant`` events, emitting
   Chrome trace-event JSON (loadable in ``chrome://tracing`` / Perfetto).
   One file per process: ``<dir>/trace-<host>-<pid>.json``.  Cross-process
   causality rides *flow events* (``flow_start``/``flow_step``/``flow_end``,
   Chrome ``"s"``/``"t"``/``"f"``): a ``new_flow_id()`` travels on wire
   messages (reservation REG, data-service split assignment and stream
   control frames) and Perfetto draws one arrow through every process that
   touched it — dispatcher assign → worker stream → consumer commit →
   infeed device_put → train dispatch.
2. **Counters** — a flat ``str -> number`` map with ``counter_add`` /
   ``counter_max``; node processes snapshot them into heartbeat payloads
   (``reservation.py``), the driver aggregates with :func:`merge_counters`.
   The step-loop overlap vocabulary rides this leg as always-on plain-int
   tallies kept by their owners (telemetry only reads them):
   ``dispatch_count`` / ``dispatch_gap_us`` (+``_hwm``) on the Trainer —
   host-side time between dispatches — and ``infeed_batches`` /
   ``infeed_assembly_us`` / ``infeed_put_us`` (+``_hwm``) on the
   ShardedFeed — host assembly vs host->device transfer time, both off the
   dispatch path when prefetch is on.
3. **Hang flight recorder** — :meth:`Tracer.dump` writes all-thread
   stacktraces, the open span stack, counters, and caller-supplied state to
   ``<dir>/flight-<host>-<pid>.json``; triggered by SIGUSR1
   (:func:`install_sigusr1`) or programmatically when bring-up stalls.

Zero-cost-when-off: the module global defaults to :data:`NULL`, a null
object whose methods are no-ops (the ``fault._NullInjector`` pattern), so
instrumented call sites cost one global load + one method call when
telemetry is disabled.  The feed-plane hot loops (``shmring.Ring``,
``DataFeed``) do not even pay that: they keep plain integer tallies
unconditionally and telemetry merely *reads* them at heartbeat cadence.

Enablement travels two ways: the driver calls :func:`configure` directly
(``cluster.run(..., telemetry=True)``); remote processes read it from
``cluster_meta["telemetry"]`` via :func:`configure_from_meta` (cloudpickled
closures must reach the process-global tracer through a real module import —
see ``node.py``'s ``_node_state`` precedent).

Events are ring-buffered (``collections.deque(maxlen=...)``) so a
long-running process holds bounded memory; truncation is itself counted
(``events_dropped``).  ``flush()`` is crash-safe (write temp + ``os.replace``)
and idempotent — call it again after more events and the file is rewritten.
"""

import collections
import json
import logging
import os
import signal
import socket
import sys
import threading
import time
import traceback

logger = logging.getLogger(__name__)

# Environment fallbacks so processes not reached by cluster_meta (e.g. a
# standalone tool) can still opt in: TFOS_TELEMETRY=1 [TFOS_TELEMETRY_DIR=...].
TELEMETRY_ENV = "TFOS_TELEMETRY"
TELEMETRY_DIR_ENV = "TFOS_TELEMETRY_DIR"

#: default max buffered events per process (each ~200 bytes serialized)
DEFAULT_CAPACITY = 16384

#: flow-event name for one serving request's journey — client predict ->
#: gateway admission -> batch coalesce -> model dispatch -> response
#: serialize.  The flow id is minted client-side (``ServingClient``) and
#: rides the request frame's transport trace header (``transport.K_TRACED``)
#: so Perfetto draws a single cross-pid arrow per request, the serving
#: analogue of ``dataservice/split_flow``.
SERVING_REQUEST_FLOW = "serving/request_flow"

#: counter keys ending in one of these merge by ``max``; everything else sums
_MAX_SUFFIXES = ("_hwm", "_max")


def wall_time_us():
    """Now, in the plane's timestamp convention: wall-clock microseconds
    (``time.time() * 1e6``).  Every trace event this module emits uses it,
    which is what lets per-process files — and the device traces
    ``scripts/analyze_profile.py`` merges in — line up on one Perfetto
    timeline.  Use this, not a monotonic clock, for any event that must
    co-plot with the traces."""
    return time.time() * 1e6


def merge_counters(snapshots):
    """Merge an iterable of flat counter dicts into one aggregate.

    Keys ending in ``_hwm``/``_max`` (high-water marks) merge by ``max``;
    all other numeric keys sum.  Non-numeric values are dropped (heartbeat
    payloads are JSON round-tripped and must stay schema-tolerant).
    """
    out = {}
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        for key, val in snap.items():
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            if key.endswith(_MAX_SUFFIXES):
                out[key] = max(out.get(key, val), val)
            else:
                out[key] = out.get(key, 0) + val
    return out


class _NullSpan(object):
    """Context manager that does nothing (telemetry off)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _NullTracer(object):
    """No-op tracer: the telemetry-off fast path.

    Same surface as :class:`Tracer`; every method returns immediately so
    instrumentation sites never need an ``if telemetry:`` guard.
    """

    enabled = False

    def span(self, name, **attrs):
        return _NULL_SPAN

    def instant(self, name, **attrs):
        pass

    def counter_add(self, name, delta=1):
        pass

    def counter_max(self, name, value):
        pass

    def counters_snapshot(self):
        return {}

    def new_flow_id(self):
        return 0

    def flow_start(self, name, flow_id, **attrs):
        pass

    def flow_step(self, name, flow_id, **attrs):
        pass

    def flow_end(self, name, flow_id, **attrs):
        pass

    def flush(self):
        pass

    def dump(self, reason="", extra=None):
        return None


NULL = _NullTracer()


class _Span(object):
    """Live span: records a Chrome ``"X"`` (complete) event on exit."""

    __slots__ = ("_tracer", "name", "attrs", "_start")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._start = time.time()
        self._tracer._push_open(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time()
        self._tracer._pop_open(self)
        if exc_type is not None:
            self.attrs = dict(self.attrs, error=repr(exc))
        self._tracer._emit({
            "ph": "X",
            "name": self.name,
            "ts": self._start * 1e6,
            "dur": (end - self._start) * 1e6,
            "args": self.attrs,
        })
        return False


class Tracer(object):
    """Process-local span tracer + counter registry + flight recorder.

    Thread-safe; events ride a bounded deque, counters a plain dict under a
    lock.  Timestamps are wall-clock microseconds (``time.time()``) so traces
    from different processes line up on one Perfetto timeline.
    """

    enabled = True

    def __init__(self, out_dir, capacity=DEFAULT_CAPACITY):
        self.out_dir = out_dir
        self._host = socket.gethostname()
        self._pid = os.getpid()
        self._events = collections.deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self._counters = {}
        self._dropped = 0
        self._flow_seq = 0
        # open-span stacks per thread id, for the flight recorder
        self._open = collections.defaultdict(list)
        self._meta_emitted = False

    # -- events ----------------------------------------------------------

    def span(self, name, **attrs):
        """Context manager timing a region; ``attrs`` become Chrome args."""
        return _Span(self, name, attrs)

    def instant(self, name, **attrs):
        """Point-in-time event (Chrome ``"i"``, process scope)."""
        self._emit({
            "ph": "i",
            "s": "p",
            "name": name,
            "ts": time.time() * 1e6,
            "args": attrs,
        })

    # -- cross-process flow events ---------------------------------------

    def new_flow_id(self):
        """A flow id unique across the cluster's processes.

        Chrome trace flow events bind by ``(cat, id)``; folding the pid into
        the id keeps two processes' concurrent flows from aliasing even
        though each hands out sequence numbers independently.  The id is a
        plain JSON int so it can ride any wire message.
        """
        self._check_fork()
        with self._lock:
            self._flow_seq += 1
            return ((self._pid & 0x3FFFFF) << 20) | (self._flow_seq & 0xFFFFF)

    def _flow(self, ph, name, flow_id, attrs):
        event = {
            "ph": ph,
            "name": name,
            "cat": "tfos_flow",
            "id": int(flow_id),
            "ts": time.time() * 1e6,
            "args": attrs,
        }
        if ph == "f":
            event["bp"] = "e"  # bind to the enclosing slice, not the next
        self._emit(event)

    def flow_start(self, name, flow_id, **attrs):
        """Begin a cross-process flow arrow (Chrome ``"s"``)."""
        self._flow("s", name, flow_id, attrs)

    def flow_step(self, name, flow_id, **attrs):
        """Intermediate hop of a flow (Chrome ``"t"``); same ``name`` and
        ``flow_id`` as the start, possibly in a different process."""
        self._flow("t", name, flow_id, attrs)

    def flow_end(self, name, flow_id, **attrs):
        """Terminate a flow (Chrome ``"f"``, enclosing-slice binding)."""
        self._flow("f", name, flow_id, attrs)

    def _check_fork(self):
        """Re-home after a fork: the child inherits this tracer (module
        global), and without a new identity it would write to the PARENT's
        trace file — whichever process flushed last would silently clobber
        the other's timeline.  Inherited pre-fork events are dropped; the
        parent owns and flushes those."""
        pid = os.getpid()
        if pid != self._pid:
            with self._lock:
                if pid != self._pid:
                    self._pid = pid
                    self._events.clear()
                    self._dropped = 0
                    self._open.clear()
                    self._counters = {}
                    self._meta_emitted = False

    def _emit(self, event):
        self._check_fork()
        event.setdefault("pid", self._pid)
        event.setdefault("tid", threading.get_ident())
        event.setdefault("cat", "tfos")
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(event)

    def _push_open(self, span):
        with self._lock:
            self._open[threading.get_ident()].append(span)

    def _pop_open(self, span):
        with self._lock:
            stack = self._open.get(threading.get_ident())
            if stack and span in stack:
                # remove this span (normally the top; tolerate misnesting)
                stack.remove(span)

    # -- counters --------------------------------------------------------

    def counter_add(self, name, delta=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def counter_max(self, name, value):
        """High-water-mark update: keep the max observed ``value``."""
        with self._lock:
            if value > self._counters.get(name, 0):
                self._counters[name] = value

    def counters_snapshot(self):
        with self._lock:
            snap = dict(self._counters)
            # Surface ring-buffer truncation on the heartbeat channel so a
            # silently-clipped trace is visible in metrics_snapshot(), not
            # just inside the file nobody opened.  Only when nonzero: the
            # healthy case stays byte-identical to the pre-existing shape.
            if self._dropped:
                snap["events_dropped"] = self._dropped
            return snap

    # -- output ----------------------------------------------------------

    def _path(self, kind):
        return os.path.join(
            self.out_dir, "%s-%s-%d.json" % (kind, self._host, self._pid))

    def _write_json(self, path, payload):
        os.makedirs(self.out_dir, exist_ok=True)
        tmp = "%s.tmp.%d" % (path, self._pid)
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path

    def flush(self):
        """Write the Chrome trace file (atomic replace; safe to re-call)."""
        try:
            self._check_fork()
            with self._lock:
                events = list(self._events)
                dropped = self._dropped
            events.insert(0, {
                "ph": "M", "name": "process_name", "pid": self._pid, "ts": 0,
                "args": {"name": "%s:%d" % (self._host, self._pid)},
            })
            payload = {
                "traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {
                    "host": self._host,
                    "pid": self._pid,
                    "events_dropped": dropped,
                    "counters": self.counters_snapshot(),
                },
            }
            return self._write_json(self._path("trace"), payload)
        except Exception as e:  # telemetry must never take the job down
            logger.warning("telemetry flush failed: %s", e)
            return None

    # -- flight recorder -------------------------------------------------

    def dump(self, reason="", extra=None):
        """Write a flight record: all-thread stacks, open spans, counters.

        Returns the path written, or None on failure.  Safe from signal
        handlers (pure-Python introspection + file write).
        """
        try:
            self._check_fork()
            threads = {t.ident: t.name for t in threading.enumerate()}
            stacks = {}
            for ident, frame in sys._current_frames().items():
                stacks["%s (%d)" % (threads.get(ident, "?"), ident)] = (
                    traceback.format_stack(frame))
            with self._lock:
                open_spans = {
                    "%s (%d)" % (threads.get(tid, "?"), tid):
                        [{"name": s.name, "args": s.attrs} for s in stack]
                    for tid, stack in self._open.items() if stack
                }
            payload = {
                "reason": reason,
                "time": time.time(),
                "host": self._host,
                "pid": self._pid,
                "thread_stacks": stacks,
                "open_spans": open_spans,
                "counters": self.counters_snapshot(),
                "extra": extra or {},
            }
            # Registered flight sources (e.g. the driver's sample-ring tail
            # and watchtower alert log): each guarded individually, so one
            # broken source cannot cost the stacks that motivated the dump.
            for name, fn in list(_flight_sources.items()):
                try:
                    payload["extra"][name] = fn()
                except Exception as e:
                    payload["extra"][name] = "unavailable: %r" % (e,)
            path = self._write_json(self._path("flight"), payload)
            logger.warning("telemetry flight record (%s) -> %s", reason, path)
            return path
        except Exception as e:
            logger.warning("telemetry flight dump failed: %s", e)
            return None


# -- flight-source registry ----------------------------------------------

# name -> zero-arg callable returning a JSON-ready object, merged into every
# flight record's "extra" block (SIGUSR1 / stall dumps).  The driver
# registers the observatory sample-ring tail and the watchtower alert log
# here, so hang forensics include the metric trajectory leading into the
# stall.  Process-global like the tracer itself; sources must be cheap and
# signal-safe (copies of in-memory state, no I/O).
_flight_sources = {}


def register_flight_source(name, fn):
    """Register/replace a named flight-record source (see ``Tracer.dump``)."""
    _flight_sources[str(name)] = fn


def unregister_flight_source(name):
    """Remove a flight-record source; unknown names are a no-op."""
    _flight_sources.pop(str(name), None)


# -- process-global tracer ----------------------------------------------

_tracer = NULL
_tracer_lock = threading.Lock()


def get_tracer():
    """The process-global tracer (:data:`NULL` unless configured)."""
    return _tracer


def configure(enabled, out_dir=None, capacity=DEFAULT_CAPACITY):
    """Install the process-global tracer.  Returns it.

    ``enabled=False`` resets to :data:`NULL` (no files are ever written).
    """
    global _tracer
    with _tracer_lock:
        if not enabled:
            _tracer = NULL
        elif not (isinstance(_tracer, Tracer) and _tracer.out_dir == out_dir
                  and _tracer._pid == os.getpid()):
            _tracer = Tracer(out_dir or os.path.join(os.getcwd(), "telemetry"),
                             capacity=capacity)
    return _tracer


def configure_from_meta(cluster_meta):
    """Configure from ``cluster_meta["telemetry"]`` (remote processes).

    Falls back to the ``TFOS_TELEMETRY`` env toggle when the meta carries
    nothing, so standalone tools can opt in too.
    """
    spec = (cluster_meta or {}).get("telemetry")
    if spec and spec.get("enabled"):
        return configure(True, spec.get("dir"),
                         capacity=spec.get("capacity", DEFAULT_CAPACITY))
    if os.environ.get(TELEMETRY_ENV, "") == "1":
        return configure(True, os.environ.get(TELEMETRY_DIR_ENV))
    return get_tracer()


def meta_spec(enabled, out_dir):
    """The dict the driver plants in ``cluster_meta["telemetry"]``."""
    return {"enabled": bool(enabled), "dir": out_dir}


# -- signal + stall triggers ---------------------------------------------

def install_sigusr1():
    """SIGUSR1 -> flight dump + trace flush, where the platform allows.

    Signals can only be installed from the main thread (and SIGUSR1 does not
    exist everywhere) — degrade to a no-op elsewhere, same policy as
    ``node._install_sigterm_drain``.
    """
    if get_tracer() is NULL or not hasattr(signal, "SIGUSR1"):
        return False

    def _on_sigusr1(signum, frame):
        t = get_tracer()
        t.dump(reason="SIGUSR1")
        t.flush()

    try:
        signal.signal(signal.SIGUSR1, _on_sigusr1)
        return True
    except ValueError:  # not the main thread
        return False


class StallWatch(object):
    """One-shot stall detector for bring-up / AWAIT loops.

    The owning poll loop calls :meth:`poke` each iteration; the first poke
    past ``deadline`` seconds triggers a flight dump attributing the stall.
    """

    def __init__(self, reason, deadline, extra_fn=None):
        self.reason = reason
        self.deadline = deadline
        self._extra_fn = extra_fn
        self._start = time.monotonic()
        self._fired = False

    def poke(self):
        if self._fired or self.deadline is None:
            return
        elapsed = time.monotonic() - self._start
        if elapsed >= self.deadline:
            self._fired = True
            extra = {}
            if self._extra_fn is not None:
                try:
                    extra = self._extra_fn()
                except Exception:
                    pass
            extra["stalled_secs"] = round(elapsed, 3)
            get_tracer().dump(reason=self.reason, extra=extra)
