"""The port's cluster-wide capture plane
(``tensorflowonspark_torch/profiling.py``), re-pointing the capture half of
``tests/test_profiling.py``: ``_safe_relpath`` against the JAX package's,
the artifact cap with the Chrome traces packed first, ``_await_steps``, a
CPU ``handle_capture_request`` that returns a trace holding another
thread's ops, the coordinator's whole lifecycle against the JAX
coordinator's, bad paths, a stale capture, a capture held off while a CUDA
graph is being captured, and ``merge_capture`` with a telemetry trace,
whose known span lands at its wall-clock place, and the JAX analyzer's
attribution table."""

import base64
import gzip
import json
import os
import threading
import time

import pytest
import torch

from tensorflowonspark_tpu import profiling as jax_profiling
from tensorflowonspark_torch import profiler, profiling, telemetry


@pytest.mark.parametrize("name", ["run/h.pt.trace.json.gz", "a/./b", "x",
                                  "", None, "/etc/passwd", "../x",
                                  "a/../../b", "a/.."])
def test_safe_relpath_matches_jax(name):
    def check(mod):
        try:
            return mod._safe_relpath(name)
        except ValueError:
            return ValueError

    assert check(profiling) == check(jax_profiling)


def test_collect_artifacts_caps_and_packs_traces_first(tmp_path):
    run = tmp_path / "run1"
    run.mkdir()
    (run / ("host" + profiler.TRACE_SUFFIX)).write_bytes(b"x" * 100)
    (run / "aux.json").write_bytes(b"y" * 10_000)
    files, total, dropped = profiling._collect_artifacts(
        str(tmp_path), max_bytes=200)
    # the cap clips the big auxiliary file, never the trace
    assert [f["name"] for f in files] == ["run1/host" + profiler.TRACE_SUFFIX]
    assert total == 100 and dropped == 1
    # a trace that does not fit whole is dropped, and counted
    files, total, dropped = profiling._collect_artifacts(
        str(tmp_path), max_bytes=50)
    assert files == [] and total == 0 and dropped == 2


def test_await_steps_watches_registered_counter():
    ticks = [0]

    def counter():
        ticks[0] += 1
        return ticks[0]

    profiling.register_step_counter(counter)
    try:
        assert profiling._await_steps(2, timeout=5.0) is True
    finally:
        profiling.register_step_counter(None)


def _spin(stop, name):
    """Another thread's ops, as a training thread's, until ``stop``."""
    x = torch.ones(32, 32)
    while not stop.is_set():
        with torch.profiler.record_function(name):
            x = (x @ x).clamp(0, 1)
        time.sleep(0.002)


def test_handle_capture_request_returns_another_threads_ops():
    """The node half on the CPU: a duration capture started on this thread
    returns one gzipped Chrome trace, and (where torch can profile every
    thread) it holds the ops another thread ran meanwhile."""
    profiler.preload()
    stop = threading.Event()
    worker = threading.Thread(target=_spin, args=(stop, "other_thread"))
    worker.start()
    try:
        result = profiling.handle_capture_request(
            {"capture_id": "cap-1", "duration_ms": 200})
    finally:
        stop.set()
        worker.join(timeout=10)
    assert not worker.is_alive()
    assert result["capture_id"] == "cap-1" and "error" not in result, result
    (entry,) = result["files"]
    assert entry["name"].endswith(profiler.TRACE_SUFFIX)
    assert result["artifact_bytes"] > 0 and result["start_secs"] >= 0
    events = json.loads(gzip.decompress(base64.b64decode(entry["b64"])))[
        "traceEvents"]
    spans = [e for e in events if e.get("name") == "other_thread"]
    if result["all_threads"]:
        assert spans
    assert result["steps"] is None    # no dispatch counter registered


def test_capture_waits_out_a_graph_capture():
    """A profiler never starts while a CUDA graph is being captured or
    launched (the Trainer holds ``cuda_graph_lock`` around each capture
    and replay)."""
    profiler.preload()
    done = threading.Event()

    def capture(out):
        out.append(profiling.capture_bytes(duration_ms=10))
        done.set()

    out = []
    with profiling.cuda_graph_lock:
        thread = threading.Thread(target=capture, args=(out,))
        thread.start()
        assert not done.wait(0.3)
    assert done.wait(30)
    thread.join(timeout=5)
    body, info = out[0]
    assert gzip.decompress(body) and info["start_secs"] >= 0


def _lock_probe(device):
    """A Trainer on ``device`` whose loss records whether
    ``profiling.cuda_graph_lock`` is held while the step runs."""
    import functools

    from tensorflowonspark_torch import train

    held = []

    def loss_fn(params, batch, mask):
        held.append(profiling.cuda_graph_lock.locked())
        return ((params["w"] * batch["x"]).sum(-1) ** 2).mean(), {}

    trainer = train.Trainer(loss_fn, {"w": torch.ones(4)},
                            functools.partial(torch.optim.SGD, lr=0.1),
                            batch_size=2, device=device)
    return trainer, held


def test_cpu_eager_step_takes_no_capture_lock():
    """Only on the card does an eager step hold ``cuda_graph_lock`` (see
    ``tests/test_torch_kernels_cuda.py``): on the CPU a capture may start
    mid-step, and several in-process trainers never wait on each other."""
    trainer, held = _lock_probe("cpu")
    for _ in range(2):
        trainer.step({"x": torch.arange(8.0).reshape(2, 4)})
    assert held == [False, False] and trainer.state.step == 2


class _FakeServer(object):
    """Duck-typed reservation server: the roster metas and the metrics
    snapshot, no sockets."""

    def __init__(self, metas):
        self._metas = metas

        class _R(object):
            def get(_self):
                return self._metas

        self.reservations = _R()

    def metrics_snapshot(self):
        return {"nodes": {},
                "aggregate": {"attrib_device_compute_pct_max": 40.0,
                              "attrib_collective_pct_max": 0.0,
                              "attrib_infeed_starved_pct_max": 10.0,
                              "attrib_ckpt_drain_pct_max": 5.0,
                              "attrib_unattributed_pct_max": 45.0}}


METAS = [{"job_name": "chief", "executor_id": 0},
         {"job_name": "worker", "executor_id": 1},
         {"job_name": "ps", "executor_id": 2}]   # never targeted


def _lifecycle(mod, tmp_path):
    """The JAX test's capture sequence on ``mod``'s coordinator; returns
    what each step observed, and the manifest less its times and ids."""
    coord = mod.CaptureCoordinator(_FakeServer(METAS),
                                   str(tmp_path / mod.__name__))
    seen = {}
    out = coord.trigger(duration_ms=500)
    seen["targets"] = sorted(out["targets"])
    seen["request"] = {k: v for k, v in out["request"].items()
                       if k != "capture_id"}
    req = coord.poll(0)
    # (a trace flow id rides along where this process's tracer is on)
    seen["poll0"] = {k: v for k, v in req.items()
                     if k not in ("capture_id", "trace_flow")}
    seen["poll0_again"] = coord.poll(0)
    seen["poll_ps"] = coord.poll(2)
    seen["poll1"] = coord.poll(1) is not None
    with pytest.raises(RuntimeError):
        coord.trigger()
    seen["complete_before"] = coord.status()["complete"]
    coord.receive({"capture_id": out["capture_id"], "executor_id": 0,
                   "host": "a", "artifact_bytes": 2, "elapsed_secs": 0.5,
                   "files": [{"name": "run/a" + profiler.TRACE_SUFFIX,
                              "b64": base64.b64encode(b"hi").decode()}]})
    coord.receive({"capture_id": out["capture_id"], "executor_id": 1,
                   "host": "b", "error": "capture failed", "files": []})
    status = coord.status()
    seen["status"] = {k: status[k] for k in ("complete", "pending", "nodes",
                                             "errors")}
    with open(os.path.join(out["dir"], "node-0", "run",
                           "a" + profiler.TRACE_SUFFIX), "rb") as f:
        seen["artifact"] = f.read()
    with open(os.path.join(out["dir"], "capture.json")) as f:
        manifest = json.load(f)
    seen["manifest"] = {k: v for k, v in manifest.items()
                        if k not in ("capture_id", "started_utc",
                                     "elapsed_secs")}
    seen["readmitted"] = coord.trigger()["capture_id"] != out["capture_id"]
    return seen


def test_capture_lifecycle_matches_jax(tmp_path):
    """Trigger, exactly-once fan-out, refusal while in flight, collection,
    the manifest and re-admission: the same on both coordinators, but that
    the port's node records carry the profiler's start-up, the dispatches
    the window held, its wall-clock bounds and whether every thread was
    recorded."""
    got = _lifecycle(profiling, tmp_path)
    want = _lifecycle(jax_profiling, tmp_path)
    for record in got["manifest"]["nodes"].values():
        assert set(record) - set(want["manifest"]["nodes"]["0"]) <= {
            "start_secs", "steps", "window", "all_threads"}
        for key in ("start_secs", "steps", "window", "all_threads"):
            record.pop(key, None)
    assert got == want
    assert got["status"]["errors"] == {"1": "capture failed"}
    assert got["manifest"]["nodes"]["0"]["files"] == [
        "run/a" + profiler.TRACE_SUFFIX]


class TestCaptureCoordinator:
    def test_trigger_requires_training_nodes(self, tmp_path):
        coord = profiling.CaptureCoordinator(
            _FakeServer([{"job_name": "ps", "executor_id": 2}]),
            str(tmp_path))
        with pytest.raises(RuntimeError):
            coord.trigger()

    def test_receive_rejects_unknown_capture_and_bad_paths(self, tmp_path):
        coord = profiling.CaptureCoordinator(_FakeServer(METAS),
                                             str(tmp_path))
        with pytest.raises(ValueError):
            coord.receive({"capture_id": "nope", "executor_id": 0})
        out = coord.trigger()
        with pytest.raises(ValueError):
            coord.receive({"capture_id": out["capture_id"], "executor_id": 0,
                           "files": [{"name": "../escape", "b64": ""}]})

    def test_stale_capture_stops_blocking(self, tmp_path):
        coord = profiling.CaptureCoordinator(_FakeServer(METAS),
                                             str(tmp_path))
        out = coord.trigger()
        coord._capture["started"] -= profiling.STALE_CAPTURE_SECS + 1
        out2 = coord.trigger()
        assert out2["capture_id"] != out["capture_id"]
        with open(os.path.join(out["dir"], "capture.json")) as f:
            manifest = json.load(f)
        assert manifest["stale"] is True
        assert manifest["unreported"] == ["0", "1"]


def test_merge_capture_places_a_known_span(tmp_path, capsys):
    """A real CPU capture holding a span of known wall-clock bounds, and a
    telemetry host trace: on the merged timeline the span lies inside its
    bounds (the profiler's base time applied), the host span is where the
    telemetry plane stamped it, the node's processes have their own pids,
    and the printed table is the JAX analyzer's."""
    import importlib.util

    cap = tmp_path / "cap-001"
    node_dir = cap / "node-0"
    node_dir.mkdir(parents=True)
    profiler.preload()
    stop = threading.Event()
    bounds = {}

    def known():
        time.sleep(0.05)
        bounds["before"] = telemetry.wall_time_us()
        with torch.profiler.record_function("known_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.02)
        bounds["after"] = telemetry.wall_time_us()
        stop.wait()

    worker = threading.Thread(target=known)
    worker.start()
    try:
        info = profiling.capture_trace(str(node_dir), duration_ms=300)
    finally:
        stop.set()
        worker.join(timeout=10)
    manifest = {"capture_id": "cap-001",
                "metrics": _FakeServer([]).metrics_snapshot()}
    (cap / "capture.json").write_text(json.dumps(manifest))
    tdir = tmp_path / "telemetry"
    tdir.mkdir()
    host_ts = bounds["before"]
    (tdir / "trace-h-1.json").write_text(json.dumps(
        {"traceEvents": [{"ph": "X", "name": "host_span", "pid": os.getpid(),
                          "tid": 1, "ts": host_ts, "dur": 3.0}]}))

    merged = profiling.merge_capture(str(cap), telemetry_dir=str(tdir))
    printed = capsys.readouterr().out
    with open(os.path.join(str(cap), "merged_timeline.json")) as f:
        assert json.load(f) == merged
    assert merged["otherData"]["capture_id"] == "cap-001"
    assert merged["otherData"]["sources"] == 2
    events = merged["traceEvents"]
    (host,) = [e for e in events if e.get("name") == "host_span"]
    assert host["ts"] == host_ts and host["pid"] == os.getpid()
    node_pids = {e["pid"] for e in events if e.get("name") != "host_span"
                 and "pid" in e}
    assert min(node_pids) >= profiling.TRACE_PID_BASE
    if info["all_threads"]:
        (span,) = [e for e in events if e.get("name") == "known_span"]
        # the profiler's clock and the wall clock, 1 ms apart at most
        assert bounds["before"] - 1000 <= span["ts"]
        assert span["ts"] + span["dur"] <= bounds["after"] + 1000
    spec = importlib.util.spec_from_file_location(
        "analyze_profile", os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "scripts",
            "analyze_profile.py"))
    analyze = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(analyze)
    rows = profiling.attribution_rows(manifest)
    assert rows == analyze.attribution_rows(manifest)
    for bucket, pct in rows:
        assert "  %-16s %6.2f%%" % (bucket, pct) in printed


def test_analyze_profile_torch_cli(tmp_path):
    """The thin CLI merges a capture directory into ``--out``."""
    import subprocess
    import sys

    cap = tmp_path / "cap"
    (cap / "node-3").mkdir(parents=True)
    with gzip.open(str(cap / "node-3" / ("h" + profiler.TRACE_SUFFIX)),
                   "wt") as f:
        json.dump({"baseTimeNanoseconds": 2_000_000_000, "traceEvents": [
            {"ph": "X", "name": "k", "pid": 0, "tid": 7, "ts": 5.0,
             "dur": 1.0}]}, f)
    out = tmp_path / "merged.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts",
                                      "analyze_profile_torch.py"),
         str(cap), "--out", str(out)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    (event,) = json.loads(out.read_text())["traceEvents"][:1]
    assert event["ts"] == 2_000_005.0 and event["pid"] == \
        profiling.TRACE_PID_BASE
    assert "no capture.json manifest" in proc.stdout
