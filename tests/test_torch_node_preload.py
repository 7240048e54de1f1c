"""The node keeps beating while it warms the profiler.

Where captures are on (``observatory=True``), the process that runs the
user fn warms ``torch.profiler`` on its main thread (``profiler.preload``)
before the user fn starts.  Its heartbeats start first, so a preload that
outlasts ``heartbeat_interval * heartbeat_misses`` fences nothing, in SPARK
mode (the forked child) and in FILES mode (the executor itself); a capture
asked for during the preload waits for it and then completes.

``profiler.preload`` is slowed in the executor process by a task run there
before ``cluster.run``: the SPARK-mode child is forked from it and inherits
the patch.  The executors unpickle this module's functions by reference:
nothing here imports the JAX package."""

import json
import os
import time
import urllib.request

import pytest

from tensorflowonspark_torch import backend, cluster

# a fence of 5 s: the capture's profiler start-up, after the preload, can
# hold a loaded host's beat thread for seconds; the preload outlasts it
HEARTBEAT_SECS = 1.0
HEARTBEAT_MISSES = 5
PRELOAD_SECS = 6.0


def _slow_preload(paths):
    """Runs in the executor: ``profiler.preload`` writes when it starts,
    sleeps ``PRELOAD_SECS``, warms the real profiler and writes when it
    ends; the capture handler writes when it starts."""
    (root,) = list(paths)
    from tensorflowonspark_torch import profiler, profiling

    real_preload, real_capture = profiler.preload, \
        profiling.handle_capture_request

    def preload():
        with open(os.path.join(root, "preload_start"), "w") as f:
            f.write(repr(time.time()))
        time.sleep(PRELOAD_SECS)
        real_preload()
        with open(os.path.join(root, "preload_end"), "w") as f:
            f.write(repr(time.time()))

    def capture(request):
        with open(os.path.join(root, "capture_start"), "w") as f:
            f.write(repr(time.time()))
        return real_capture(request)

    profiler.preload = preload
    profiling.handle_capture_request = capture
    return []


def _wait_fun(args, ctx):
    """Park until the driver's release file (or a bound)."""
    deadline = time.time() + 60
    while not os.path.exists(args["release"]) and time.time() < deadline:
        time.sleep(0.05)


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=30).read().decode()


def _stamp(root, name):
    with open(os.path.join(root, name)) as f:
        return float(f.read())


@pytest.mark.parametrize("mode", ["spark", "files"])
def test_slow_preload_is_not_fenced_and_capture_waits(tmp_path, mode):
    root = str(tmp_path)
    release = os.path.join(root, "release")
    b = backend.LocalBackend(1)
    try:
        b.run_on(0, _slow_preload, [root]).wait(timeout=60)
        c = cluster.run(
            b, _wait_fun, {"release": release}, num_executors=1,
            input_mode=(cluster.InputMode.SPARK if mode == "spark"
                        else cluster.InputMode.FILES),
            heartbeat_interval=HEARTBEAT_SECS,
            heartbeat_misses=HEARTBEAT_MISSES,
            log_dir=str(tmp_path / "logs"), telemetry=True, observatory=True)
        try:
            base = "http://127.0.0.1:%d" % c.observatory.addr[1]
            deadline = time.time() + 60
            while not os.path.exists(os.path.join(root, "preload_start")):
                assert time.time() < deadline, "the preload never started"
                time.sleep(0.05)
            assert not os.path.exists(os.path.join(root, "preload_end"))
            out = json.loads(_get(base, "/profile?duration_ms=200"))
            assert out["targets"] == ["0"], out
            status = {}
            while not (status.get("last_capture") or {}).get("complete"):
                assert time.time() < deadline, status
                time.sleep(0.25)
                status = json.loads(_get(base, "/status"))
            assert status["last_capture"]["errors"] == {}, status
        finally:
            open(release, "w").close()
        c.shutdown(grace_secs=2)
        dead = c.tf_status.get("dead_nodes")
        replaced = c.tf_status.get("replacements")
    finally:
        b.stop()
    assert not dead, dead
    assert not replaced, replaced
    start, end = _stamp(root, "preload_start"), _stamp(root, "preload_end")
    assert end - start >= PRELOAD_SECS > HEARTBEAT_MISSES * HEARTBEAT_SECS
    # asked for mid-preload, the capture ran only after the preload ended
    assert _stamp(root, "capture_start") >= end
    with open(os.path.join(out["dir"], "capture.json")) as f:
        assert json.load(f)["nodes"]["0"]["artifact_bytes"] > 0
