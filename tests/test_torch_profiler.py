"""The port's step profiler and profiler capture endpoint
(``tensorflowonspark_torch/profiler.py``), re-pointing
``tests/test_profiler.py``: ``parse_profile_steps`` and the StepProfiler's
step window against the JAX package's, a StepProfiler on a CPU Trainer
covering exactly its range, the endpoint idempotent and a failed start not
latching, a LocalBackend cluster with ``profiler=True`` publishing one
address whose ``/capture`` answers (SPARK and FILES mode), and
``observatory=True`` serving ``/metrics`` and a ``GET /profile`` capture
that lands ``capture.json`` and merges.

The JAX package is imported inside the tests only: the executors unpickle
this module's node functions by reference."""

import functools
import glob
import gzip
import json
import os
import re
import time
import urllib.request

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import backend, cluster, profiler, profiling
from tensorflowonspark_torch import train

STEP_RE = re.compile(r"Optimizer\.step#")


def _trace_events(path_or_bytes):
    if isinstance(path_or_bytes, bytes):
        return json.loads(gzip.decompress(path_or_bytes))["traceEvents"]
    with gzip.open(path_or_bytes, "rt") as f:
        return json.load(f)["traceEvents"]


def _optimizer_steps(events):
    """The optimizer steps a trace holds (``torch.optim`` annotates each)."""
    return [e for e in events
            if e.get("ph") == "X" and STEP_RE.match(str(e.get("name", "")))]


@pytest.mark.parametrize("spec", ["10,20", " 0 , 0 ", "", None, "5", "1,2,3",
                                  "-1,4", "9,3", "a,b"])
def test_parse_profile_steps_matches_jax(spec):
    from tensorflowonspark_tpu import profiler as jax_profiler

    def parse(mod):
        try:
            return mod.parse_profile_steps(spec)
        except ValueError as e:
            return "ValueError: %s" % e

    assert parse(profiler) == parse(jax_profiler)


@pytest.mark.parametrize("spec,hooks", [("1,2", "both"), ("1,3", "end"),
                                        ("0,0", "both"), ("2,2", "end")])
def test_step_window_matches_jax(monkeypatch, spec, hooks):
    """The step at which each StepProfiler starts and stops, hooked before
    and after each step or (a dispatch loop) after only: the port's state
    machine is the JAX package's."""
    from tensorflowonspark_tpu import profiler as jax_profiler

    def window(mod):
        events = []
        prof = mod.StepProfiler("unused", spec)
        monkeypatch.setattr(prof, "_start", lambda: (
            events.append(("start", prof.step)),
            setattr(prof, "_prof" if mod is profiler else "_active",
                    object() if mod is profiler else True)))

        def stop():
            if prof._active:
                events.append(("stop", prof.step))
                setattr(prof, "_prof" if mod is profiler else "_active",
                        None if mod is profiler else False)

        monkeypatch.setattr(prof, "stop", stop)
        for _ in range(6):
            if hooks == "both":
                prof.on_step_begin()
            prof.on_step_end()
        prof.stop()
        return events

    assert window(profiler) == window(jax_profiler)


def _loss(params, batch, mask):
    pred = batch["x"] @ params["w"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0), {}


class _Feed(object):
    """``n`` batches of 8 rows of a linear regression (numpy, seeded);
    ``sleep`` seconds before each."""

    def __init__(self, n, seed=0, sleep=0.0):
        rng = np.random.RandomState(seed)
        self.x = rng.rand(n * 8, 4).astype(np.float32)
        self.y = self.x @ np.arange(1, 5, dtype=np.float32)
        self.sleep = sleep

    def batches(self):
        for i in range(len(self.x) // 8):
            if self.sleep:
                time.sleep(self.sleep)
            part = slice(i * 8, (i + 1) * 8)
            yield ({"x": self.x[part], "y": self.y[part]},
                   np.ones(8, np.float32))


def _trainer():
    return train.Trainer(_loss, {"w": np.zeros(4, np.float32)},
                         functools.partial(torch.optim.SGD, lr=0.05),
                         batch_size=8, log_steps=4, device="cpu")


@pytest.mark.parametrize("spec,hooks,expected", [
    ("2,4", "both", 3), ("2,5", "end", 4), ("0,0", "both", 1)])
def test_step_profiler_covers_exactly_its_range(tmp_path, spec, hooks,
                                                expected):
    """On a CPU Trainer the trace holds the optimizer steps of its window:
    ``[start, stop]`` with both hooks, one step late with ``on_step_end``
    alone (the dispatch loop's hook, as ``fit_supervised`` uses it)."""
    prof = profiler.StepProfiler(str(tmp_path), spec)
    tr = _trainer()
    for batch, mask in _Feed(8).batches():
        if hooks == "both":
            prof.on_step_begin()
        tr.step(batch, mask)
        prof.on_step_end()
    prof.stop()
    assert prof.trace_path.endswith(profiler.TRACE_SUFFIX)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    assert len(_optimizer_steps(_trace_events(prof.trace_path))) == expected


def test_step_profiler_stops_on_the_exception_path(tmp_path):
    prof = profiler.StepProfiler(str(tmp_path), "0,5")
    with pytest.raises(ValueError):
        with prof:
            prof.on_step_begin()
            raise ValueError("boom")
    assert not prof._active and os.path.exists(prof.trace_path)


def test_profiler_server_start_idempotent():
    port = profiler.start_server()
    assert port > 0 and profiler.start_server() == port
    assert profiler.server_counters() == {"profiler_server_up_max": 1}
    body = urllib.request.urlopen(
        "http://127.0.0.1:%d/capture?duration_ms=50" % port,
        timeout=30).read()
    assert isinstance(_trace_events(body), list)
    with pytest.raises(urllib.error.HTTPError) as bad:
        urllib.request.urlopen(
            "http://127.0.0.1:%d/capture?steps=x" % port, timeout=5)
    assert bad.value.code == 400


def test_profiler_server_failure_does_not_latch(monkeypatch):
    """A failed start leaves the next call free to retry, while the
    heartbeat counter records the last outcome."""
    monkeypatch.setattr(profiler, "_server_port", None)
    monkeypatch.setattr(profiler, "_server_state", None)
    monkeypatch.setattr(profiler, "_server", None)
    assert profiler.server_counters() == {}

    real_bind = profiler._bind

    def boom(port, sock):
        raise OSError("bind race")

    monkeypatch.setattr(profiler, "_bind", boom)
    assert profiler.start_server() == 0
    assert profiler._server_port is None
    assert profiler.server_counters() == {"profiler_server_up_max": 0}
    monkeypatch.setattr(profiler, "_bind", real_bind)
    port = profiler.start_server()
    assert port > 0
    assert profiler.server_counters() == {"profiler_server_up_max": 1}
    profiler._server.shutdown()
    profiler._server.server_close()


# -- clusters ---------------------------------------------------------------


def _wait_fun(args, ctx):
    """Train a little, then wait until the driver has dialed the node."""
    tr = _trainer()
    tr.fit_feed(_Feed(4))
    deadline = time.time() + 60
    while not os.path.exists(args["release"]) and time.time() < deadline:
        time.sleep(0.05)


def _dial(address, query):
    return urllib.request.urlopen("http://%s/capture?%s" % (address, query),
                                  timeout=60).read()


@pytest.mark.parametrize("mode", ["spark", "files"])
def test_cluster_publishes_profiler_ports(tmp_path, mode):
    """One training node, one published address, served by the process
    that runs the user fn (the forked child in SPARK mode, the executor in
    FILES mode): its ``/capture`` answers with a trace of that process."""
    release = str(tmp_path / "release")
    b = backend.LocalBackend(1)
    try:
        c = cluster.run(b, _wait_fun, {"release": release}, num_executors=1,
                        profiler=True,
                        input_mode=(cluster.InputMode.SPARK if mode == "spark"
                                    else cluster.InputMode.FILES))
        try:
            (address,) = c.profiler_addresses()
            events = _trace_events(_dial(address, "duration_ms=100"))
            assert c.cluster_info[0]["profiler_port"] == int(
                address.rsplit(":", 1)[1])
        finally:
            open(release, "w").close()
        c.shutdown(grace_secs=1)
    finally:
        b.stop()
    (traced_pid,) = {e["pid"] for e in events
                     if e.get("ph") == "M" and e["name"] == "process_name"}
    # the roster's pid is the executor's: the user fn runs there in FILES
    # mode, in a forked child in SPARK mode
    assert (traced_pid == c.cluster_info[0]["pid"]) == (mode == "files")


def _observed_fun(args, ctx):
    """Train long enough for the driver to scrape and capture."""
    tr = _trainer()
    tr.fit_feed(_Feed(160, sleep=0.025))
    time.sleep(1.5)    # the last beats carry the final counters


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=30).read().decode()


def test_observatory_metrics_and_profile_capture(tmp_path):
    """``observatory=True, profiler=True, telemetry=True``: ``/metrics``
    parses and says the node is up, ``/status`` lists the node's profiler
    address, and ``GET /profile?steps=3`` lands ``capture.json`` and the
    node's trace, which ``merge_capture`` puts on one timeline with the
    telemetry host traces."""
    from test_torch_observatory import _parse_exposition

    log_dir = str(tmp_path / "logs")
    b = backend.LocalBackend(1)
    try:
        c = cluster.run(b, _observed_fun, {}, num_executors=1,
                        input_mode=cluster.InputMode.SPARK, log_dir=log_dir,
                        telemetry=True, observatory=True, profiler=True,
                        heartbeat_interval=1.0,
                        # beats ride a loaded host here: liveness is not
                        # what this test holds
                        heartbeat_misses=10)
        base = "http://127.0.0.1:%d" % c.observatory.addr[1]
        deadline = time.time() + 60
        text = ""
        while "tfos_dispatch_count_total" not in text:
            assert time.time() < deadline, text
            time.sleep(0.25)
            text = _get(base, "/metrics")
        families, _ = _parse_exposition(text)
        assert 'tfos_up{executor="0"} 1' in text
        assert families["tfos_profiler_server_up_max"] == "gauge"
        status = json.loads(_get(base, "/status"))
        assert status["profiler_addresses"] == c.profiler_addresses()
        out = json.loads(_get(base, "/profile?steps=3"))
        assert out["targets"] == ["0"] and out["request"]["steps"] == 3
        while not (status.get("last_capture") or {}).get("complete"):
            assert time.time() < deadline, status
            time.sleep(0.25)
            status = json.loads(_get(base, "/status"))
        c.shutdown(grace_secs=1)
    finally:
        b.stop()
    assert status["last_capture"]["errors"] == {}
    with open(os.path.join(out["dir"], "capture.json")) as f:
        manifest = json.load(f)
    node = manifest["nodes"]["0"]
    assert node["steps"] >= 3 and node["artifact_bytes"] > 0
    assert node["files"][0].endswith(profiler.TRACE_SUFFIX)
    merged = profiling.merge_capture(
        out["dir"], telemetry_dir=os.path.join(log_dir, "telemetry"))
    names = [e.get("name") for e in merged["traceEvents"]]
    assert "train/dispatch" in names      # the node's telemetry spans
    if node["all_threads"]:               # the training thread's ops
        assert len(_optimizer_steps(merged["traceEvents"])) >= 3
    assert glob.glob(os.path.join(out["dir"], "merged_timeline.json"))
