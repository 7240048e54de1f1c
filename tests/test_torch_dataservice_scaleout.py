"""The remediator's ``scale_out_workers`` loop on the port, closed with a
real worker process (the twin of ``scripts/ci_assert_remediator.py``'s
worker leg): a one-node FILES cluster consumes a data-service job through
``ctx.get_service_feed`` while the fault injector slow-drains it, the
``dataservice_*`` counters ride the node's beats, the watchtower's
``dataservice_saturation`` rule fires, the remediator spawns a
``python -m tensorflowonspark_torch.dataservice_worker`` from its
``worker_spawn_argv``, that worker registers with the dispatcher and the
roster grows, and the job still delivers every element exactly once.

Every wait is on the event it needs (the first worker on the roster, the
action's stages, the spawned worker's registration, the consumer's
report); the deadline only bounds a hang."""

import json
import os
import socket
import subprocess
import sys
import time
import types
import urllib.request

import pytest

from tensorflowonspark_torch import backend, cluster, dataservice, fault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SPLITS, PER_SPLIT = 12, 40
SAT_SECS = 10.0     # the consumer slow-drains this long after its first pop
SAT_SLEEP = 0.12    # per-chunk drain sleep while saturated
DEADLINE_SECS = 90.0


def _pick_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_argv(port, worker_id):
    return [sys.executable, "-m", "tensorflowonspark_torch.dataservice_worker",
            "--dispatcher", "127.0.0.1:{}".format(port), "--reader", "jsonl",
            "--worker-id", worker_id, "--heartbeat", "0.25"]


def _consume(args, ctx):
    """Drain the shared job through the node's service feed; report what
    arrived."""
    import json as _json
    import os

    from tensorflowonspark_torch import dataservice as ds

    feed = ctx.get_service_feed(args.splits, job_name="scaleout",
                                mode=ds.SHARD_DYNAMIC, num_epochs=1,
                                timeout=DEADLINE_SECS)
    got = []
    while not feed.should_stop():
        arrays, count = feed.next_batch_arrays(64)
        if count:
            got.extend(int(x) for x in arrays[0])
    with open(args.report + ".tmp", "w") as f:
        _json.dump(got, f)
    os.replace(args.report + ".tmp", args.report)


def _stages(base):
    doc = json.loads(urllib.request.urlopen(
        base + "/remediations?limit=100", timeout=5).read().decode())
    stages = {}
    for a in doc.get("actions") or []:
        stages.setdefault(a["action"], set()).add(a["stage"])
    return stages


@pytest.mark.chaos(timeout=180)
def test_saturation_spawns_a_port_worker_that_joins_the_roster(
        tmp_path, monkeypatch):
    # the remediator's spawned worker inherits this environment
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    splits, expect = [], []
    for s in range(N_SPLITS):
        path = str(tmp_path / "split-{:03d}.jsonl".format(s))
        with open(path, "w") as f:
            for i in range(s * PER_SPLIT, (s + 1) * PER_SPLIT):
                expect.append(i)
                f.write(json.dumps([i, [float(i % 7)] * 8]) + "\n")
        splits.append(path)
    port = _pick_port()
    addr = ("127.0.0.1", port)
    disp = dataservice.DispatcherServer(heartbeat_interval=0.25,
                                        heartbeat_misses=8,
                                        host="127.0.0.1", port=port)
    disp.start()
    worker0 = subprocess.Popen(_worker_argv(port, "so-w0"), cwd=REPO,
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
    slowdrain = json.dumps({"saturate_consumer_secs": SAT_SECS,
                            "saturate_consumer_sleep": SAT_SLEEP})
    b = backend.LocalBackend(1, env_per_executor=[
        {fault.FAULT_SPEC_ENV: slowdrain}])
    args = types.SimpleNamespace(splits=splits,
                                 report=str(tmp_path / "consumed.json"))
    c = None
    try:
        t0 = time.time()
        client = dataservice.DispatcherClient(addr)
        while len(client.workers()) < 1:
            assert time.time() - t0 < DEADLINE_SECS, "worker never registered"
            time.sleep(0.05)
        client.close()
        c = cluster.run(
            b, _consume, args, num_executors=1,
            input_mode=cluster.InputMode.FILES,
            heartbeat_interval=0.5, heartbeat_misses=20,
            log_dir=str(tmp_path), telemetry=True, observatory=True,
            data_service="127.0.0.1:{}".format(port),
            watchtower={"interval_secs": 0.5, "window_secs": 8.0,
                        "cooldown_secs": 1.0, "queue_sat_pct": 90.0},
            remediator={"interval_secs": 0.25, "window_secs": 6.0,
                        "settle_ticks": 4, "cooldown_secs": 3.0,
                        "confirm_windows": {"scale_out_workers": 2},
                        "max_workers": 1,
                        "scale_in_idle_windows": 10 ** 6,
                        "alert_ttl_secs": 10.0,
                        "worker_spawn_argv": _worker_argv(port,
                                                          "so-spawn")})
        base = "http://%s:%d" % c.observatory.addr
        stages = {}
        while time.time() - t0 < DEADLINE_SECS:
            stages = _stages(base)
            if {"proposed", "applied", "effect"} <= \
                    stages.get("scale_out_workers", set()):
                break
            time.sleep(0.3)
        assert {"proposed", "applied", "effect"} <= \
            stages.get("scale_out_workers", set()), \
            "worker scale-out never closed its loop: {}".format(stages)
        workers = set()
        while time.time() - t0 < DEADLINE_SECS:
            client = dataservice.DispatcherClient(addr)
            workers = {w.get("worker_id") if isinstance(w, dict) else w
                       for w in client.workers()}
            client.close()
            if "so-spawn" in workers:
                break
            time.sleep(0.1)
        assert {"so-w0", "so-spawn"} <= workers, \
            "the spawned worker never joined the roster: {}".format(workers)
        # the node reports once its feed ended: wait for that, then stop
        while not os.path.exists(args.report):
            assert time.time() - t0 < DEADLINE_SECS, "consumer never ended"
            time.sleep(0.1)
        c.shutdown(grace_secs=1)
        assert "error" not in c.tf_status, c.tf_status["error"]
        c = None
        with open(args.report) as f:
            got = json.load(f)
        assert sorted(got) == sorted(expect), \
            "elements lost or duplicated: {} vs {}".format(len(got),
                                                           len(expect))
    finally:
        if c is not None:
            c.shutdown(grace_secs=5)
        b.stop()
        worker0.terminate()
        worker0.wait(timeout=10)
        disp.stop()
