"""CI gate of the port's request plane (the twin of
``scripts/ci_assert_reqtrace.py``, on ``tensorflowonspark_torch``; it
imports no jax): request-plane observability must explain an injected
slowdown.

Port modules driven: ``inference_cli --serve --roster --device cpu`` (two
replica subprocesses with ``TFOS_TELEMETRY=1``), ``fault``
(``sleep_per_predict_secs``), ``gateway.ServingClient``, ``reservation``,
``observatory`` (``/metrics``, ``/slow``, ``/alerts``), ``watchtower``
(journaled), ``telemetry``, ``profiling.merge_capture`` through
``scripts/analyze_profile_torch.py``, and
``scripts/metrics_replay_torch.py``.  On the card the same request plane
runs in ``chip_smoke.py``'s ``gateway`` phase (stage histograms of the
LM's replies) and ``serve_cli`` phase.

Boots a 2-slot roster + observatory + watchtower (journaled), exports the
tiny linear model, and launches TWO gateway replica subprocesses with
request tracing on (``TFOS_TELEMETRY=1``) — replica ``ci-r0`` additionally
carries ``TFOS_FAULT_SPEC={"sleep_per_predict_secs": 0.05}``, an injected
50ms model-dispatch stall.  Four concurrent :class:`gateway.ServingClient`
threads (half pinned to the slow replica, half to the fast one) drive known
inputs, then the gate asserts the whole request-plane loop:

1. every prediction is numerically exact (y = 2a + 3b) on both replicas,
2. ``/metrics`` exposes the latency decomposition: per-stage histogram
   sums for ``ci-r0`` re-add to the end-to-end ``tfos_serving_latency_us``
   sum within 10%, the slow replica's dispatch stage owns the injected
   stall, the ``tfos_serving_shed_total`` reason family is present, and
   ``tfos_up`` reports both replicas beating,
3. ``GET /slow`` names the slowed requests: worst exemplars come from
   ``ci-r0`` with ``dispatch_us`` carrying the stall, tagged with the
   minting client's request ids,
4. the ``slo_budget_burn`` rule pages for ``ci-r0`` (err rate ~100% vs a
   25ms SLO) and NOT for the healthy ``ci-r1``, live on ``/alerts``,
5. the SIGTERM'd replicas flush their trace buffers and
   ``scripts/analyze_profile_torch.py`` (``profiling.merge_capture``)
   stitches client + replica events into cross-process
   ``serving/request_flow`` tracks,
6. ``metrics_replay_torch.py --json`` over the watchtower journal
   re-derives the identical ``slo_budget_burn`` (rule, executor) verdicts
   offline.

    python scripts/ci_assert_torch_reqtrace.py

Exit 0 = one slow request is
one story: traced end to end, decomposed by stage, named on /slow, paged
on /alerts, and reproducible from the journal.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BUDGET_SECS = 90.0
N_CLIENTS = 4
REQS_PER_CLIENT = 60
MAX_BATCH = 8
SLEEP_SECS = 0.05        # injected per-predict stall on ci-r0
SLO_US = 25000.0         # 25ms: ci-r0 (50ms stall) always bad, ci-r1 good


def _spawn_replica(roster_addr, replica_id, task_index, export_dir,
                   tele_dir, fault_spec=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TFOS_TELEMETRY"] = "1"
    env["TFOS_TELEMETRY_DIR"] = tele_dir
    if fault_spec:
        env["TFOS_FAULT_SPEC"] = json.dumps(fault_spec)
    cmd = [sys.executable, "-m", "tensorflowonspark_torch.inference_cli",
           "--export_dir", export_dir, "--serve", "--port", "0",
           "--roster", "{}:{}".format(*roster_addr),
           "--replica-id", replica_id, "--task-index", str(task_index),
           "--max-batch", str(MAX_BATCH), "--max-wait-ms", "5",
           "--heartbeat", "0.25", "--slo-latency-us", str(SLO_US),
           "--device", "cpu"]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=5).read().decode()


def _sum_for(metrics_text, name, executor):
    """Value of ``<name>{...executor="<executor>"...}`` on /metrics."""
    needle = 'executor="{}"'.format(executor)
    for line in metrics_text.splitlines():
        if line.startswith(name + "{") and needle in line:
            return float(line.rsplit(None, 1)[-1])
    return None


def main():
    import numpy as np
    import torch

    from tensorflowonspark_torch import (checkpoint, gateway, observatory,
                                         reservation, telemetry, watchtower)

    tmp = tempfile.mkdtemp(prefix="ci_reqtrace_")
    tele_dir = os.path.join(tmp, "telemetry")
    journal = os.path.join(tmp, "journal.jsonl")
    capture_dir = os.path.join(tmp, "capture")  # no device capture: host-only merge
    os.makedirs(tele_dir)
    os.makedirs(capture_dir)
    telemetry.configure(True, tele_dir)

    export_dir = os.path.join(tmp, "export")
    params = {"dense.weight": torch.tensor([[2.0, 3.0]]),
              "dense.bias": torch.zeros(1)}
    checkpoint.export_model(export_dir, params, "linear",
                            model_config={"architecture": "linear",
                                          "features": 1},
                            input_signature={"x": [None, 2]})

    # SRE burn-rate windows shrink from hours to gate seconds; thresholds
    # sit far above scheduling noise (page needs >=20x the 1% budget, i.e.
    # err rate >=20% over BOTH fast windows) so only the fault-injected
    # replica can fire, never a jittery-but-healthy one.
    resv = reservation.Server(2, heartbeat_interval=0.25,
                              heartbeat_misses=2)
    ring = observatory.SampleRing()
    resv.sample_ring = ring
    wt = watchtower.Watchtower(
        ring=ring, snapshot_fn=resv.metrics_snapshot,
        heartbeat_interval=0.25, journal_path=journal,
        config={"interval_secs": 0.25, "min_samples": 3,
                "cooldown_secs": 5.0, "journal_snapshot_secs": 0.25,
                "slo_objective": 0.99,
                "slo_fast_windows_secs": (1.0, 3.0),
                "slo_slow_windows_secs": (2.0, 6.0),
                "slo_burn_fast": 20.0, "slo_burn_slow": 10.0,
                "slo_min_requests": 5})
    wt.start()
    obs = observatory.ObservatoryServer(resv.metrics_snapshot, ring=ring,
                                        host="127.0.0.1", watchtower=wt,
                                        beat_ages_fn=resv.beat_ages)
    obs.start()
    roster_addr = resv.start()
    base = "http://{}:{}".format(*obs.addr)

    t0 = time.time()
    procs = [
        _spawn_replica(roster_addr, "ci-r0", 0, export_dir, tele_dir,
                       fault_spec={"sleep_per_predict_secs": SLEEP_SECS}),
        _spawn_replica(roster_addr, "ci-r1", 1, export_dir, tele_dir),
    ]
    try:
        rc = reservation.Client(roster_addr)
        try:
            info = rc.await_reservations(timeout=BUDGET_SECS / 2)
        finally:
            rc.close()
        rows = [m for m in info
                if isinstance(m, dict) and m.get("job_name") == "serving"]
        assert len(rows) == 2, \
            "roster did not expose 2 serving replicas: {}".format(info)
        by_id = {m["executor_id"]: "{}:{}".format(m["host"], m["port"])
                 for m in rows}
        slow_first = [by_id["ci-r0"], by_id["ci-r1"]]
        fast_first = [by_id["ci-r1"], by_id["ci-r0"]]

        # clients pin by replica-list order: 0/1 live on the slow replica,
        # 2/3 on the fast one — both SLO stories run concurrently
        clients = [gateway.ServingClient(
            replicas=(slow_first if i < 2 else fast_first), timeout=15.0,
            client_id="ci-t{}".format(i)) for i in range(N_CLIENTS)]

        rng = np.random.default_rng(23)
        inputs = rng.random((N_CLIENTS, REQS_PER_CLIENT, 2)) * 10.0
        results = [[None] * REQS_PER_CLIENT for _ in range(N_CLIENTS)]
        errors = []

        def drive(ci):
            cl = clients[ci]
            for r in range(REQS_PER_CLIENT):
                row = inputs[ci, r]
                feed = {"x": np.asarray([row], np.float32)}
                try:
                    out = cl.predict(feed, 1)
                    results[ci][r] = float(next(iter(out.values()))[0][0])
                except gateway.OverloadError:
                    time.sleep(0.01)

        threads = [threading.Thread(target=drive, args=(ci,), daemon=True)
                   for ci in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(1.0, BUDGET_SECS - (time.time() - t0)))
        assert all(not t.is_alive() for t in threads), \
            "clients did not finish within {}s".format(BUDGET_SECS)
        assert not errors, errors[:3]

        wrong = lost = 0
        for ci in range(N_CLIENTS):
            for r in range(REQS_PER_CLIENT):
                got = results[ci][r]
                if got is None:
                    lost += 1
                    continue
                a, b = inputs[ci, r]
                if abs(got - (2.0 * a + 3.0 * b)) > 1e-3:
                    wrong += 1
        assert lost == 0, "{} requests lost".format(lost)
        assert wrong == 0, "{} predictions numerically wrong".format(wrong)

        # give the final heartbeat a beat to carry the last counters
        time.sleep(0.6)

        # -- 2: latency decomposition on /metrics --------------------------
        metrics = _get(base, "/metrics")
        stages = {}
        for stage in ("queue", "coalesce", "dispatch", "serialize"):
            v = _sum_for(metrics, "tfos_serving_{}_us_sum".format(stage),
                         "ci-r0")
            assert v is not None, \
                "no tfos_serving_{}_us_sum for ci-r0 on /metrics".format(
                    stage)
            stages[stage] = v
        e2e = _sum_for(metrics, "tfos_serving_latency_us_sum", "ci-r0")
        assert e2e and e2e > 0, "no tfos_serving_latency_us_sum for ci-r0"
        total = sum(stages.values())
        assert abs(total - e2e) <= 0.10 * e2e, \
            "stage sums {} = {} vs e2e {} (>10% apart)".format(
                stages, total, e2e)
        # the injected stall is DISPATCH time on the slow replica: 50ms x
        # every batch dwarfs the other stages' totals combined
        n_reqs = _sum_for(metrics, "tfos_serving_latency_us_count", "ci-r0")
        assert n_reqs and n_reqs > 0, "empty ci-r0 latency histogram"
        assert stages["dispatch"] / n_reqs >= SLEEP_SECS * 1e6 * 0.9, \
            "mean dispatch {}us does not carry the {}s stall".format(
                stages["dispatch"] / n_reqs, SLEEP_SECS)
        assert "tfos_serving_shed_total{" in metrics, \
            "no tfos_serving_shed_total reason family on /metrics"
        for ex in ("ci-r0", "ci-r1"):
            up = _sum_for(metrics, "tfos_up", ex)
            assert up == 1.0, "tfos_up{{executor={}}} != 1".format(ex)

        # -- 3: /slow names the slowed requests ----------------------------
        doc = json.loads(_get(base, "/slow?limit=8"))
        assert doc.get("count", 0) > 0 and doc.get("slow"), \
            "/slow returned no exemplars: {}".format(doc)
        worst = doc["slow"][0]
        for key in ("req", "flow", "latency_us", "queue_us", "coalesce_us",
                    "dispatch_us", "serialize_us", "rows", "batch_rows",
                    "model", "version", "executor"):
            assert key in worst, "/slow exemplar missing {}: {}".format(
                key, worst)
        assert worst["executor"] == "ci-r0", \
            "worst exemplar not from the stalled replica: {}".format(worst)
        assert worst["dispatch_us"] >= SLEEP_SECS * 1e6 * 0.9, \
            "worst exemplar's dispatch does not carry the stall: {}".format(
                worst)
        assert worst["req"].startswith("ci-t"), \
            "exemplar does not carry the minting client's request id: " \
            "{}".format(worst)

        # -- 4: the burn rule pages for the slow replica only --------------
        deadline = t0 + BUDGET_SECS
        burn = None
        while burn is None and time.time() < deadline:
            alerts = json.loads(_get(base, "/alerts")).get("alerts") or []
            for a in alerts:
                if (a.get("rule") == "slo_budget_burn"
                        and a.get("executor") == "ci-r0"):
                    burn = a
                    break
            if burn is None:
                time.sleep(0.25)
        assert burn is not None, \
            "slo_budget_burn never fired for ci-r0 on /alerts"
        assert burn.get("severity") == "crit", \
            "expected a page (crit), got: {}".format(burn)
        healthy = [a for a in json.loads(_get(base, "/alerts"))
                   .get("alerts") or []
                   if a.get("rule") == "slo_budget_burn"
                   and a.get("executor") == "ci-r1"]
        assert not healthy, \
            "burn rule fired for the healthy replica: {}".format(healthy)

        # -- 5: cross-pid request-flow tracks ------------------------------
        for p in procs:
            p.send_signal(signal.SIGTERM)  # clean drain => tracer flush
        for p in procs:
            p.wait(timeout=15)
        for c in clients:
            c.close()
        telemetry.get_tracer().flush()
        merged_path = os.path.join(tmp, "merged_timeline.json")
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "analyze_profile_torch.py"),
             capture_dir, "--telemetry-dir", tele_dir,
             "--out", merged_path],
            capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, \
            "analyze_profile_torch failed: {}".format(out.stderr[-500:])
        with open(merged_path) as f:
            payload = json.load(f)
        flows = payload["otherData"]["request_flows"]
        assert flows["ids"] > 0, "no serving/request_flow ids in the merge"
        assert flows["cross_pid"] >= 1, \
            "no request flow crosses a process boundary: {}".format(flows)

        # -- 6: the journal re-derives the same verdicts -------------------
        wt.stop()
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "metrics_replay_torch.py"),
             journal, "--json"],
            capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, \
            "metrics_replay failed: {}".format(out.stderr[-500:])
        replay = json.loads(out.stdout)
        live_slo = {(a.get("rule"), str(a.get("executor")))
                    for a in replay["journaled_alerts"]
                    if a.get("rule") == "slo_budget_burn"}
        replayed_slo = {(a.get("rule"), str(a.get("executor")))
                        for a in replay["replayed_alerts"]
                        if a.get("rule") == "slo_budget_burn"}
        assert ("slo_budget_burn", "ci-r0") in live_slo, \
            "journal carries no live slo_budget_burn for ci-r0: " \
            "{}".format(live_slo)
        assert live_slo == replayed_slo, \
            "replay diverged from the journal: live {} vs replayed " \
            "{}".format(live_slo, replayed_slo)

        print("reqtrace OK: {} exact predictions, ci-r0 stage sums {}us "
              "== e2e {}us, /slow worst req {} dispatch {}us, "
              "slo_budget_burn paged ci-r0 only, {} request flows "
              "({} cross-pid), replay == journal in {:.1f}s".format(
                  N_CLIENTS * REQS_PER_CLIENT, int(total), int(e2e),
                  worst["req"], int(worst["dispatch_us"]), flows["ids"],
                  flows["cross_pid"], time.time() - t0))
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
