"""CI gate of the port's serving tier (the twin of
``scripts/ci_assert_serving.py``, on ``tensorflowonspark_torch``; it
imports no jax): the serving gateway must survive a replica kill under
load.

Port modules driven: ``inference_cli --serve --roster --device cpu`` (two
replica subprocesses sharing one ``--warm-cache-dir``), ``serving``
(``ModelServer`` and its AOTInductor warm rungs), ``gateway.ServingClient``,
``reservation`` roster fencing, ``observatory`` and the watchtower's
``slo_budget_burn`` rule, over a ``linear`` export written by
``checkpoint.export_model``.  On the card the same tier runs in
``chip_smoke.py``'s ``gateway`` and ``serve_cli`` phases.

Boots a reservation roster (2 serving slots) with the observatory +
watchtower attached, exports a tiny linear model, and launches TWO gateway
replica SUBPROCESSES (the real ``python -m
tensorflowonspark_torch.inference_cli --serve`` entry).  Concurrent client
threads then drive known inputs through :class:`gateway.ServingClient`
while the gate SIGKILLs the replica the clients are pinned to, asserting
the whole chain inside the budget:

1. both replicas register in the roster and serve coalesced batches,
2. the kill mid-run fences the dead replica by heartbeat timeout and every
   in-flight/subsequent request retries on the survivor — zero accepted
   requests lost, every prediction numerically correct,
3. the serving telemetry made it through heartbeats to ``/metrics``
   (nonzero ``tfos_serving_p99_us*`` and ``tfos_serving_batch_fill*``
   gauges) and the armed ``slo_budget_burn`` rule is visible on
   ``/alerts``.

    python scripts/ci_assert_torch_serving.py

Exit 0 = failover held and the SLO plumbing pages.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUDGET_SECS = 60.0
N_CLIENTS = 4
REQS_PER_CLIENT = 60
KILL_AFTER = 20          # per-client requests before the SIGKILL lands
MAX_BATCH = 8            # replica --max-batch; fixes the bucket ladder
# the first replica's cold warm-up: an AOTInductor compile of each of the
# ladder's 4 rungs, about 30 s alone on the CPU and more on a loaded host,
# where the JAX gate's XLA compiles fit in BUDGET_SECS / 2
WARM_DEADLINE_SECS = 150.0


def _spawn_replica(roster_addr, replica_id, task_index, export_dir,
                   warm_dir=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    # the warm rungs' AOTInductor packages are held for their values:
    # their C++ wrappers build at -O0 and skip the vector-ISA probe, which
    # halves the first replica's cold warm-up on the CPU
    env.setdefault("AOT_INDUCTOR_COMPILE_WRAPPER_OPT_LEVEL", "O0")
    env.setdefault("TORCHINDUCTOR_VEC_ISA_OK", "0")
    cmd = [sys.executable, "-m", "tensorflowonspark_torch.inference_cli",
           "--export_dir", export_dir, "--serve", "--port", "0",
           "--roster", "{}:{}".format(*roster_addr),
           "--replica-id", replica_id, "--task-index", str(task_index),
           "--max-batch", str(MAX_BATCH), "--max-wait-ms", "5",
           "--heartbeat", "0.25", "--slo-latency-us", "1",
           "--device", "cpu"]
    if warm_dir:
        cmd += ["--warm-cache-dir", warm_dir]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=5).read().decode()


def main():
    import numpy as np
    import torch

    from tensorflowonspark_torch import (checkpoint, gateway, observatory,
                                         reservation, watchtower)

    tmp = tempfile.mkdtemp(prefix="ci_serving_")
    export_dir = os.path.join(tmp, "export")
    params = {"dense.weight": torch.tensor([[2.0, 3.0]]),
              "dense.bias": torch.zeros(1)}
    checkpoint.export_model(export_dir, params, "linear",
                            model_config={"architecture": "linear",
                                          "features": 1},
                            input_signature={"x": [None, 2]})

    # roster + observability plane (the cluster.py wiring, minimal form);
    # the replicas run --slo-latency-us 1 — intentionally absurd, every
    # real request violates it, so err_rate ~1.0 burns the 1% budget at
    # ~100x and the gate proves the burn rule's plumbing, not a tuned
    # threshold.  Windows shrink from SRE hours to gate seconds.
    resv = reservation.Server(2, heartbeat_interval=0.25,
                              heartbeat_misses=2)
    ring = observatory.SampleRing()
    resv.sample_ring = ring
    wt = watchtower.Watchtower(
        ring=ring, snapshot_fn=resv.metrics_snapshot,
        heartbeat_interval=0.25,
        config={"interval_secs": 0.25, "min_samples": 3,
                "cooldown_secs": 5.0, "slo_objective": 0.99,
                "slo_fast_windows_secs": (1.0, 3.0),
                "slo_slow_windows_secs": (2.0, 6.0),
                "slo_burn_fast": 2.0, "slo_burn_slow": 1.5,
                "slo_min_requests": 5})
    wt.start()
    obs = observatory.ObservatoryServer(resv.metrics_snapshot, ring=ring,
                                        host="127.0.0.1", watchtower=wt)
    obs.start()
    roster_addr = resv.start()
    base = "http://{}:{}".format(*obs.addr)

    # both replicas share one warm-start root: the first persists each
    # bucket rung's AOTInductor package, the second (spawned once every
    # rung's artifact exists — the restarted-replica shape) loads them
    # instead of compiling.  Readiness is the exact ladder length, not a
    # stability window: warmup writes one artifact per rung, and a slow
    # host's inter-rung compile gap must not fake completion.
    from tensorflowonspark_torch import serving

    expected_rungs = len(serving.bucket_ladder(MAX_BATCH))
    warm_dir = os.path.join(tmp, "warm")
    t_warm = time.time()
    procs = [_spawn_replica(roster_addr, "ci-s0", 0, export_dir, warm_dir)]
    deadline = t_warm + WARM_DEADLINE_SECS
    while True:
        n = (len([f for f in os.listdir(warm_dir) if f.endswith(".aotx")])
             if os.path.isdir(warm_dir) else 0)
        if n >= expected_rungs:
            break
        assert time.time() < deadline, \
            "first replica persisted {}/{} warm rung artifacts".format(
                n, expected_rungs)
        time.sleep(0.1)
    warm_secs = time.time() - t_warm
    procs.append(_spawn_replica(roster_addr, "ci-s1", 1, export_dir,
                                warm_dir))
    t0 = time.time()
    killed = threading.Event()
    try:
        # discovery doubles as the registration barrier: await_reservations
        # blocks until BOTH replicas hold slots (None until complete)
        rc = reservation.Client(roster_addr)
        try:
            info = rc.await_reservations(timeout=BUDGET_SECS / 2)
        finally:
            rc.close()
        rows = [m for m in info
                if isinstance(m, dict) and m.get("job_name") == "serving"]
        assert len(rows) == 2, \
            "roster did not expose 2 serving replicas: {}".format(info)
        # warm-start opt-in: every replica's registration carries its
        # per-rung warmup verdicts, and the second replica — spawned
        # against the first's persisted artifacts — must have warmed
        # entirely by deserialization (zero compiles, the restarted-
        # replica guarantee)
        for m in rows:
            rep = m.get("warmup")
            assert rep and rep.get("buckets"), \
                "replica {} registered without a warmup report: {}".format(
                    m.get("executor_id"), m)
        warm_row = next(m for m in rows if m["executor_id"] == "ci-s1")
        assert warm_row["warmup"]["compiled"] == 0, \
            "second replica recompiled despite the shared warm dir: " \
            "{}".format(warm_row["warmup"])
        assert warm_row["warmup"]["loaded"] == len(
            warm_row["warmup"]["buckets"]), \
            "second replica has non-loaded rungs: {}".format(
                warm_row["warmup"])
        addrs = ["{}:{}".format(m["host"], m["port"]) for m in rows]
        # every fresh client pins to roster index 0 — that's the replica
        # the kill must land on for the failover to be exercised
        pinned_id = rows[0]["executor_id"]
        survivor_id = rows[1]["executor_id"]
        kill_idx = 0 if pinned_id == "ci-s0" else 1
        clients = [gateway.ServingClient(
            replicas=addrs, timeout=10.0,
            client_id="ci-c{}".format(i)) for i in range(N_CLIENTS)]

        rng = np.random.default_rng(11)
        inputs = rng.random((N_CLIENTS, REQS_PER_CLIENT, 2)) * 10.0
        results = [[None] * REQS_PER_CLIENT for _ in range(N_CLIENTS)]
        errors = []

        def drive(ci):
            cl = clients[ci]
            for r in range(REQS_PER_CLIENT):
                if ci == 0 and r == KILL_AFTER and not killed.is_set():
                    # SIGKILL the pinned replica while requests are in
                    # flight on it
                    procs[kill_idx].kill()
                    killed.set()
                row = inputs[ci, r]
                feed = {"x": np.asarray([row], np.float32)}
                for attempt in range(20):
                    try:
                        out = cl.predict(feed, 1)
                        results[ci][r] = float(
                            next(iter(out.values()))[0][0])
                        break
                    except gateway.OverloadError:
                        time.sleep(0.01)  # typed shed: back off and retry
                else:
                    errors.append("client {} request {} never "
                                  "admitted".format(ci, r))

        threads = [threading.Thread(target=drive, args=(ci,), daemon=True)
                   for ci in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(1.0, BUDGET_SECS - (time.time() - t0)))
        assert all(not t.is_alive() for t in threads), \
            "clients did not finish within {}s".format(BUDGET_SECS)
        assert not errors, errors[:3]
        assert killed.is_set() and procs[kill_idx].poll() is not None, \
            "SIGKILL never landed on the pinned replica"

        # zero lost accepted requests, all numerically correct (y=2a+3b)
        lost = wrong = 0
        for ci in range(N_CLIENTS):
            for r in range(REQS_PER_CLIENT):
                got = results[ci][r]
                if got is None:
                    lost += 1
                    continue
                a, b = inputs[ci, r]
                if abs(got - (2.0 * a + 3.0 * b)) > 1e-3:
                    wrong += 1
        assert lost == 0, "{} accepted requests lost".format(lost)
        assert wrong == 0, "{} predictions numerically wrong".format(wrong)
        failovers = sum(c.failovers for c in clients)
        assert failovers >= N_CLIENTS, \
            "clients never failed over ({} failovers)".format(failovers)

        # the dead replica must be fenced by the liveness monitor
        deadline = t0 + BUDGET_SECS
        while pinned_id not in resv.dead_nodes():
            assert time.time() < deadline, \
                "killed replica never fenced: {}".format(resv.dead_nodes())
            time.sleep(0.1)

        # serving telemetry through heartbeats onto /metrics
        metrics = _get(base, "/metrics")
        p99 = fill = None
        for line in metrics.splitlines():
            if (line.startswith("tfos_serving_p99_us")
                    and survivor_id in line):
                p99 = float(line.rsplit(None, 1)[-1])
            if (line.startswith("tfos_serving_batch_fill")
                    and survivor_id in line):
                fill = float(line.rsplit(None, 1)[-1])
        assert p99 and p99 > 0, \
            "no nonzero tfos_serving_p99_us on /metrics"
        assert fill and fill > 0, \
            "no nonzero tfos_serving_batch_fill on /metrics"

        # the armed SLO-burn rule must be paging on /alerts
        burn = None
        while burn is None and time.time() < deadline:
            doc = json.loads(_get(base, "/alerts"))
            for a in doc.get("alerts") or []:
                if a.get("rule") == "slo_budget_burn":
                    burn = a
                    break
            time.sleep(0.2)
        assert burn is not None, "slo_budget_burn never fired on /alerts"

        for c in clients:
            c.close()
        print("serving OK: first replica's {} rungs stored in {:.1f}s, "
              "replica killed under load, fenced, {} client "
              "failover(s), {} requests exact on the survivor, p99 {}us / "
              "fill {}% on /metrics, SLO-burn alert live in {:.1f}s".format(
                  expected_rungs, warm_secs, failovers,
                  N_CLIENTS * REQS_PER_CLIENT, p99, fill,
                  time.time() - t0))
        return 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=5)
        wt.stop()
        obs.stop()
        resv.stop()


if __name__ == "__main__":
    sys.exit(main())
