"""Cluster-wide on-demand trace capture (driver + node halves; the port's
copy of the JAX package's ``profiling`` module, capturing with
``torch.profiler`` where the JAX one uses ``jax.profiler``).

The observatory can say *what* the MFU number is; this module captures
*where the step time goes on the card*, from a live cluster, on demand.

How a capture travels (no new connections, no new ports):

1. **Trigger** — ``GET /profile?duration_ms=&steps=`` on the observatory (or
   :meth:`CaptureCoordinator.trigger` directly) creates a capture id and
   resolves the target nodes from the reservation roster (the training
   roles, :data:`CAPTURE_JOBS`).
2. **Fan-out** — the pending request rides OUT on each target's next
   heartbeat *reply* (``reservation.Server`` asks :meth:`CaptureCoordinator.poll`;
   exactly-once per node per capture).
3. **Capture** — the node's ``HeartbeatSender`` hands the request to
   :func:`handle_capture_request` on a dedicated thread (a capture takes
   seconds; the beat loop must not miss its liveness deadline):
   :func:`capture_trace` starts a ``torch.profiler`` profile (CUDA activity
   where the process has a card in use, the CPU ops of every thread where
   torch can), waits out the requested duration or watches the trainer's
   dispatch counter for N dispatches, stops, and the gzipped Chrome trace
   (``*.pt.trace.json.gz``) is base64'd.
4. **Collection** — the node uploads the artifacts as a ``PROF`` control
   message; :meth:`CaptureCoordinator.receive` lands them under
   ``profiles/<capture_id>/node-<executor_id>/`` on the driver and, when the
   last node reports, writes a ``capture.json`` manifest carrying the
   cluster metrics snapshot (including the ``attrib_*`` attribution report)
   so :func:`merge_capture` (``scripts/analyze_profile_torch.py``) can merge
   and explain from one directory.

A ``profiling/capture_flow`` trace flow links trigger -> per-node capture ->
collection on the merged Perfetto timeline (telemetry wall-clock-µs
convention, :func:`telemetry.wall_time_us`).

Concurrency: PyTorch allows ONE active profiler per process, and
LocalBackend test clusters host several "nodes" in one process — node
captures serialize on a module-level lock.  A profiler also never starts,
stops or synchronizes the card while this process captures a CUDA graph,
launches a replay or launches an eager step: the Trainer holds
:data:`cuda_graph_lock` around each capture, each replay and, on the
card, each eager step, and so does every profiler start and stop here and
in :mod:`profiler`.  (On an H100, a synchronize from a side thread broke a
graph capture, a profiler stopped from a side thread while the training
thread launched replays hung both threads, and a node whose capture
endpoint started and stopped a profiler of every thread beside eager steps
died at times with no Python error.)
"""

import base64
import json
import logging
import os
import shutil
import socket
import tempfile
import threading
import time

from tensorflowonspark_torch import profiler as profiler_mod
from tensorflowonspark_torch import telemetry

logger = logging.getLogger(__name__)

#: duration used when a trigger names neither duration_ms nor steps
DEFAULT_DURATION_MS = 2000
#: hard ceiling on a requested duration — a fat-fingered ?duration_ms=9e9
#: must not pin the capture lock (and the node's capture thread) for hours
MAX_DURATION_MS = 60000
#: per-node cap on base64 artifact payload; biggest-last files are dropped
#: (and the drop recorded) rather than stalling the control channel
MAX_ARTIFACT_BYTES = 32 * 1024 * 1024
#: step-mode poll cadence / give-up horizon (a stalled trainer must not pin
#: the capture lock forever)
STEP_POLL_SECS = 0.05
STEP_TIMEOUT_SECS = 60.0
#: an incomplete capture older than this no longer blocks a new trigger
#: (nodes may have died mid-capture; their slots show in the manifest)
STALE_CAPTURE_SECS = 120.0

#: roster job names that train and therefore capture (the node's training
#: roles, restated here to keep this module importable without the node
#: runtime)
CAPTURE_JOBS = ("chief", "master", "worker")

# One active profiler per process (see module docstring).
_capture_lock = threading.Lock()

#: held around every CUDA graph capture and replay launch (``Trainer``) and
#: every profiler start and stop: a profiler must not start, stop or
#: synchronize the card while a graph is being captured or launched
cuda_graph_lock = threading.Lock()

# Latest registered dispatch counter: a zero-arg callable returning a
# cumulative count, registered by Trainer.fit_feed so ?steps=N captures
# know when N more dispatches have happened.
_step_counter = None


def register_step_counter(fn):
    """Register the step-progress source for ``?steps=N`` captures (the
    newest registration wins — one trainer drives a node's step loop)."""
    global _step_counter
    _step_counter = fn


def _await_steps(steps, timeout=STEP_TIMEOUT_SECS):
    """Block until the registered dispatch counter advances by ``steps``
    (or the timeout passes / no counter is registered — then fall back to
    the default duration so the capture still returns *something*)."""
    counter = _step_counter
    if counter is None:
        logger.warning("steps-mode capture without a registered step "
                       "counter; falling back to %d ms", DEFAULT_DURATION_MS)
        time.sleep(DEFAULT_DURATION_MS / 1000.0)
        return False
    try:
        start = counter()
    except Exception:
        logger.warning("step counter failed; falling back to duration",
                       exc_info=True)
        time.sleep(DEFAULT_DURATION_MS / 1000.0)
        return False
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        time.sleep(STEP_POLL_SECS)
        try:
            if counter() - start >= steps:
                return True
        except Exception:
            break
    logger.warning("steps-mode capture timed out waiting for %d steps", steps)
    return False


def _collect_artifacts(tmpdir, max_bytes=MAX_ARTIFACT_BYTES):
    """Walk a stopped trace's output dir into ``[{"name", "b64"}, ...]``.

    Names are tmpdir-relative with forward slashes (the layout is preserved
    on the driver).  The ``*.pt.trace.json.gz`` traces are packed first:
    they are the timeline the merge needs, so if the size cap clips
    anything it clips the auxiliary files.  A file that does not fit whole
    is dropped, and counted.  Returns (files, total_bytes,
    dropped_count)."""
    paths = []
    for root, _, names in os.walk(tmpdir):
        for name in names:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, tmpdir).replace(os.sep, "/")
            paths.append((0 if name.endswith(profiler_mod.TRACE_SUFFIX)
                          else 1,
                          os.path.getsize(full), rel, full))
    paths.sort()
    files, total, dropped = [], 0, 0
    for _, size, rel, full in paths:
        if total + size > max_bytes:
            dropped += 1
            continue
        with open(full, "rb") as f:
            files.append({"name": rel,
                          "b64": base64.b64encode(f.read()).decode("ascii")})
        total += size
    return files, total, dropped


def _read_counter():
    """The registered dispatch counter's value, or None."""
    counter = _step_counter
    if counter is None:
        return None
    try:
        return int(counter())
    except Exception:
        return None


def capture_trace(out_dir, duration_ms=None, steps=None, capture_id=None):
    """One capture in this process: start a profiler, wait ``duration_ms``
    (capped at :data:`MAX_DURATION_MS`) or until the registered dispatch
    counter advanced by ``steps``, stop, and write the gzipped Chrome trace
    into ``out_dir``.  Blocks while another capture runs here.

    The step count starts once the profiler is up (the first start in a
    process pays the CUDA profiler's start-up); where a card is in use the
    profiler starts and stops on an idle card, outside any CUDA graph
    capture or replay launch.  Returns ``{"trace", "start_secs", "steps", "window",
    "all_threads"}``: the trace path, the profiler's start-up seconds, the
    dispatches the window held (None without a registered counter), the
    window's wall-clock ``[start, stop]`` seconds and whether the CPU ops
    of every thread were recorded."""
    duration_ms = min(int(duration_ms or DEFAULT_DURATION_MS),
                      MAX_DURATION_MS)
    tracer = telemetry.get_tracer()
    with _capture_lock, \
            tracer.span("profiling/capture", capture_id=capture_id,
                        steps=steps, duration_ms=duration_ms):
        prof, all_threads = profiler_mod.new_profile(all_threads=True)
        t0 = time.monotonic()
        with cuda_graph_lock:
            profiler_mod.synchronize()
            prof.start()
        start_secs = time.monotonic() - t0
        window = [time.time()]
        first = _read_counter()
        try:
            if steps:
                _await_steps(int(steps))
            else:
                time.sleep(duration_ms / 1000.0)
        finally:
            with cuda_graph_lock:
                profiler_mod.synchronize()
                last = _read_counter()
                window.append(time.time())
                prof.stop()
        path = profiler_mod.write_trace(prof, out_dir)
    return {"trace": path, "start_secs": round(start_secs, 3),
            "steps": (None if first is None or last is None
                      else last - first),
            "window": window, "all_threads": all_threads}


def capture_bytes(duration_ms=None, steps=None):
    """:func:`capture_trace` into a temporary directory; returns ``(the
    gzipped trace's bytes, the capture's info without the path)`` (the
    profiler's ``GET /capture`` endpoint)."""
    tmpdir = tempfile.mkdtemp(prefix="tfos-capture-")
    try:
        info = capture_trace(tmpdir, duration_ms=duration_ms, steps=steps)
        with open(info.pop("trace"), "rb") as f:
            return f.read(), info
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def handle_capture_request(request):
    """Node-side half: run one capture described by a fanned-out request
    dict (``capture_id`` + ``duration_ms`` or ``steps`` [+ ``trace_flow``]);
    returns the PROF payload (artifacts or an error).  Passed to
    ``reservation.HeartbeatSender(on_profile=...)`` by the node runtime;
    runs on the sender's capture thread."""
    capture_id = request.get("capture_id")
    tracer = telemetry.get_tracer()
    flow = request.get("trace_flow")
    if flow:
        tracer.flow_step("profiling/capture_flow", flow, leg="node_capture",
                         capture_id=capture_id)
    tmpdir = tempfile.mkdtemp(prefix="tfos-profile-")
    try:
        t0 = time.monotonic()
        info = capture_trace(tmpdir, duration_ms=request.get("duration_ms"),
                             steps=request.get("steps"),
                             capture_id=capture_id)
        files, total, dropped = _collect_artifacts(tmpdir)
        result = {
            "capture_id": capture_id,
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "elapsed_secs": round(time.monotonic() - t0, 3),
            "start_secs": info["start_secs"],
            "steps": info["steps"],
            "window": info["window"],
            "all_threads": info["all_threads"],
            "files": files,
            "artifact_bytes": total,
        }
        if dropped:
            result["files_dropped"] = dropped
        if not files:
            result["error"] = "capture produced no artifact files"
        return result
    except Exception as e:
        logger.exception("trace capture failed")
        return {"capture_id": capture_id, "host": socket.gethostname(),
                "error": repr(e)}
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _safe_relpath(name):
    """Validate an uploaded artifact name into a safe relative path — the
    node is trusted but the path still crosses a wire; a capture must never
    be able to write outside its own directory."""
    name = str(name or "").replace("\\", "/")
    parts = [p for p in name.split("/") if p not in ("", ".")]
    if not parts or any(p == ".." for p in parts) or name.startswith("/"):
        raise ValueError("unsafe artifact path {!r}".format(name))
    return os.path.join(*parts)


class CaptureCoordinator(object):
    """Driver-side half: owns capture lifecycle + the ``profiles/`` dir.

    Attached to the reservation server (``server.profile_coordinator``) by
    ``cluster.run`` when the observatory is enabled; the observatory's
    ``/profile`` endpoint calls :meth:`trigger`, the server's HBEAT/PROF
    handlers call :meth:`poll` / :meth:`receive` from the listener thread.
    One capture in flight at a time (a stale incomplete one —
    :data:`STALE_CAPTURE_SECS` — stops blocking and is finalized as-is).
    """

    def __init__(self, server, profiles_dir):
        self.server = server
        self.profiles_dir = profiles_dir
        self._lock = threading.Lock()
        self._seq = 0
        self._capture = None  # latest capture state (also the history head)

    # -- trigger ---------------------------------------------------------

    def trigger(self, duration_ms=None, steps=None):
        """Start a capture against every training roster node; returns
        the ``/profile`` response payload.  Raises ``RuntimeError`` when no
        targets are registered yet or a capture is already in flight."""
        targets = []
        for meta in self.server.reservations.get():
            if (isinstance(meta, dict) and meta.get("job_name") in CAPTURE_JOBS
                    and meta.get("executor_id") is not None):
                targets.append(meta["executor_id"])
        if not targets:
            raise RuntimeError("no training nodes registered yet")
        tracer = telemetry.get_tracer()
        with self._lock:
            cur = self._capture
            if cur and not cur["complete"]:
                if time.time() - cur["started"] < STALE_CAPTURE_SECS:
                    raise RuntimeError(
                        "capture {} still in flight (waiting on nodes {})"
                        .format(cur["id"],
                                sorted(map(str, cur["pending"]))))
                logger.warning("abandoning stale capture %s (nodes %s never "
                               "reported)", cur["id"],
                               sorted(map(str, cur["pending"])))
                self._finalize_locked(cur, stale=True)
            self._seq += 1
            capture_id = "{}-{:03d}".format(
                time.strftime("%Y%m%d-%H%M%S"), self._seq)
            request = {"capture_id": capture_id}
            if steps:
                request["steps"] = int(steps)
            else:
                request["duration_ms"] = min(
                    int(duration_ms or DEFAULT_DURATION_MS), MAX_DURATION_MS)
            flow = tracer.new_flow_id()
            if flow:
                request["trace_flow"] = flow
            capture = {
                "id": capture_id,
                "dir": os.path.join(self.profiles_dir, capture_id),
                "started": time.time(),
                "request": request,
                "targets": list(targets),
                "pending": set(targets),
                "nodes": {},
                "errors": {},
                "complete": False,
            }
            os.makedirs(capture["dir"], exist_ok=True)
            self._capture = capture
        if flow:
            tracer.flow_start("profiling/capture_flow", flow, leg="trigger",
                              capture_id=capture_id, targets=len(targets))
        tracer.instant("profiling/trigger", capture_id=capture_id,
                       targets=len(targets), **{
                           k: v for k, v in request.items()
                           if k in ("duration_ms", "steps")})
        logger.info("profile capture %s triggered for %d node(s) -> %s",
                    capture_id, len(targets), capture["dir"])
        return {"capture_id": capture_id, "dir": capture["dir"],
                "targets": [str(t) for t in targets],
                "request": {k: v for k, v in request.items()
                            if k != "trace_flow"}}

    # -- server hooks (listener thread) ----------------------------------

    def poll(self, executor_id):
        """The pending request for ``executor_id``, exactly once per
        capture (the HBEAT reply piggyback); None when there is nothing
        for this node."""
        with self._lock:
            capture = self._capture
            if (capture is None or capture["complete"]
                    or executor_id not in capture["pending"]):
                return None
            # Delivery == removal from the *poll* set, but completion is
            # tracked by receive(); keep a separate handed-out record.
            handed = capture.setdefault("handed", set())
            if executor_id in handed:
                return None
            handed.add(executor_id)
            return dict(capture["request"])

    def receive(self, data):
        """Land one node's PROF payload under the capture directory; when
        the last pending node reports, finalize (manifest + flow end)."""
        capture_id = data.get("capture_id")
        executor_id = data.get("executor_id")
        with self._lock:
            capture = self._capture
            if capture is None or capture["id"] != capture_id:
                raise ValueError(
                    "unknown capture id {!r}".format(capture_id))
        node_dir = os.path.join(capture["dir"],
                                "node-{}".format(executor_id))
        written = []
        for entry in data.get("files") or []:
            rel = _safe_relpath(entry.get("name"))
            path = os.path.join(node_dir, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(base64.b64decode(entry.get("b64") or ""))
            written.append(rel.replace(os.sep, "/"))
        tracer = telemetry.get_tracer()
        flow = capture["request"].get("trace_flow")
        if flow:
            tracer.flow_step("profiling/capture_flow", flow,
                             leg="collect", capture_id=capture_id,
                             executor_id=executor_id, files=len(written))
        with self._lock:
            capture["pending"].discard(executor_id)
            node_record = {
                "host": data.get("host"),
                "files": written,
                "artifact_bytes": data.get("artifact_bytes", 0),
                "elapsed_secs": data.get("elapsed_secs"),
                "start_secs": data.get("start_secs"),
                "steps": data.get("steps"),
                "window": data.get("window"),
                "all_threads": data.get("all_threads"),
            }
            if data.get("files_dropped"):
                node_record["files_dropped"] = data["files_dropped"]
            capture["nodes"][str(executor_id)] = node_record
            if data.get("error"):
                capture["errors"][str(executor_id)] = str(data["error"])
            done = not capture["pending"] and not capture["complete"]
            if done:
                self._finalize_locked(capture)
        logger.info("profile capture %s: node %s reported %d file(s)%s",
                    capture_id, executor_id, len(written),
                    "; capture complete" if done else "")

    def _finalize_locked(self, capture, stale=False):
        """Write the ``capture.json`` manifest and end the trace flow
        (caller holds ``self._lock``)."""
        capture["complete"] = True
        manifest = {
            "capture_id": capture["id"],
            "started_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(capture["started"])),
            "elapsed_secs": round(time.time() - capture["started"], 3),
            "request": {k: v for k, v in capture["request"].items()
                        if k != "trace_flow"},
            "targets": [str(t) for t in capture["targets"]],
            "nodes": capture["nodes"],
            "errors": capture["errors"],
        }
        if stale:
            manifest["stale"] = True
            manifest["unreported"] = sorted(map(str, capture["pending"]))
        # The cluster metrics snapshot (incl. the attrib_* attribution
        # report) rides in the manifest so merge_capture explains the
        # timeline from one directory.
        try:
            manifest["metrics"] = self.server.metrics_snapshot()
        except Exception:
            logger.debug("metrics snapshot unavailable for manifest",
                         exc_info=True)
        path = os.path.join(capture["dir"], "capture.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        flow = capture["request"].get("trace_flow")
        if flow:
            telemetry.get_tracer().flow_end(
                "profiling/capture_flow", flow, leg="manifest",
                capture_id=capture["id"], nodes=len(capture["nodes"]),
                stale=stale)

    # -- status ----------------------------------------------------------

    def status(self):
        """Latest capture's state for the observatory ``/status`` JSON
        (None before the first trigger)."""
        with self._lock:
            capture = self._capture
            if capture is None:
                return None
            return {
                "capture_id": capture["id"],
                "dir": capture["dir"],
                "complete": capture["complete"],
                "pending": sorted(map(str, capture["pending"])),
                "nodes": sorted(capture["nodes"]),
                "errors": dict(capture["errors"]),
            }


# -- merge -------------------------------------------------------------------

#: merged pids of the node traces start here, so a node's processes never
#: alias a telemetry host process (OS pids stay below 2**22 on Linux)
TRACE_PID_BASE = 1 << 22
#: pids reserved for each node trace in the merged file
_PIDS_PER_TRACE = 1024


def _load_trace(path):
    """A Chrome-trace dict from a ``.json`` or gzipped ``.json.gz`` file."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _node_trace_events(payload, index, label):
    """One node trace's events on the merged timeline: ``ts`` moved to
    wall-clock µs (the profiler writes them relative to the file's
    ``baseTimeNanoseconds``, where it names one) and every pid mapped into
    this trace's own range, its processes named after ``label``."""
    offset_us = (payload.get("baseTimeNanoseconds") or 0) / 1000.0
    pids = {}
    out = []
    for ev in payload.get("traceEvents") or ():
        if not isinstance(ev, dict):
            continue
        ev = dict(ev)
        if "pid" in ev:
            key = str(ev["pid"])
            if key not in pids:
                pids[key] = TRACE_PID_BASE + index * _PIDS_PER_TRACE + len(
                    pids)
            ev["pid"] = pids[key]
        if isinstance(ev.get("ts"), (int, float)):
            ev["ts"] = ev["ts"] + offset_us
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            args = dict(ev.get("args") or {})
            args["name"] = "%s: %s" % (label, args.get("name", ""))
            ev["args"] = args
        out.append(ev)
    for key, pid in pids.items():
        out.append({"ph": "M", "name": "process_labels", "pid": pid,
                    "args": {"labels": "%s pid %s" % (label, key)}})
    return out


def attribution_rows(manifest):
    """``attrib_*_pct_max`` gauges from the manifest's aggregate metrics ->
    ``[(bucket, pct), ...]`` in report order (empty when absent)."""
    agg = ((manifest.get("metrics") or {}).get("aggregate")) or {}
    rows = []
    for key in sorted(agg):
        if key.startswith("attrib_") and key.endswith("_pct_max"):
            bucket = key[len("attrib_"):-len("_pct_max")]
            rows.append((bucket, float(agg[key])))
    order = ("device_compute", "collective", "infeed_starved", "ckpt_drain",
             "unattributed")
    rows.sort(key=lambda r: (order.index(r[0]) if r[0] in order else 99))
    return rows


def merge_capture(capture_dir, telemetry_dir=None, out=None):
    """Merge one capture into ONE Perfetto timeline and print what it holds.

    ``capture_dir`` is a ``profiles/<capture_id>/`` directory of a
    ``GET /profile`` capture (each node's ``node-<executor>/**/*.pt.trace
    .json.gz`` and the ``capture.json`` manifest); ``telemetry_dir``
    optionally holds the per-process host traces ``trace-<host>-<pid>.json``.
    Both sides land on one wall-clock-µs axis (telemetry stamps
    :func:`telemetry.wall_time_us`; the profiler's timestamps are offset by
    its file's base time), each node trace's processes in their own pid
    range.  Writes ``out`` (default ``<capture_dir>/merged_timeline.json``),
    prints one note per source and the manifest's ``attrib_*`` step-time
    table, and returns the merged Chrome-trace dict, whose ``otherData``
    names the capture, the sources and the output path."""
    import glob

    notes = []
    merged = []
    manifest = {}
    manifest_path = os.path.join(capture_dir, "capture.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    else:
        notes.append("no capture.json manifest in %s" % capture_dir)

    traces = sorted(glob.glob(os.path.join(
        capture_dir, "node-*", "**", "*" + profiler_mod.TRACE_SUFFIX),
        recursive=True))
    for i, path in enumerate(traces):
        label = os.path.relpath(path, capture_dir).split(os.sep)[0]
        try:
            events = _node_trace_events(_load_trace(path), i, label)
            merged.extend(events)
            notes.append("%s: %d events" % (path, len(events)))
        except Exception as e:
            notes.append("%s: load failed (%s)" % (path, e))

    host_traces = []
    if telemetry_dir:
        host_traces = sorted(glob.glob(os.path.join(telemetry_dir,
                                                    "trace-*.json")))
    for path in host_traces:
        try:
            events = _load_trace(path).get("traceEvents", [])
            merged.extend(events)
            notes.append("%s: %d host events" % (path, len(events)))
        except Exception as e:
            notes.append("%s: load failed (%s)" % (path, e))

    out = out or os.path.join(capture_dir, "merged_timeline.json")
    payload = {"traceEvents": merged, "displayTimeUnit": "ms",
               "otherData": {"capture_id": manifest.get("capture_id"),
                             "sources": len(traces) + len(host_traces),
                             "out": out}}
    with open(out, "w") as f:
        json.dump(payload, f)
    for note in notes:
        print(note)
    print("merged timeline: %s (%d events) — load it in ui.perfetto.dev"
          % (out, len(merged)))
    rows = attribution_rows(manifest)
    if rows:
        # each node's buckets sum to 100%; the aggregate takes the per-
        # bucket MAX across nodes (the _max merge rule), so the total can
        # exceed 100% on a skewed cluster — that skew is itself signal
        print("\nstep-time attribution (per-bucket max across nodes):")
        for bucket, pct in rows:
            print("  %-16s %6.2f%%  %s" % (bucket, pct,
                                           "#" * int(round(pct / 2))))
        print("  %-16s %6.2f%%" % ("total", sum(p for _, p in rows)))
    else:
        print("\nno attrib_* gauges in the manifest (train long enough for "
              "a metrics window to close before triggering the capture)")
    return payload
