"""CI gate of the port's model fleet (the twin of
``scripts/ci_assert_fleet.py``, on ``tensorflowonspark_torch``; it imports
no jax): the fleet must swap versions live, roll back bad canaries, and
serve a trained checkpoint — with zero lost requests.

Boots a 3-model fleet (alpha/beta/gamma, 2 gateway replica SUBPROCESSES
each, resolved through the model registry via ``python -m
tensorflowonspark_torch.inference_cli --registry --model --device cpu``)
behind a :class:`fleet.FleetRouter`, with the reservation roster,
watchtower, observatory (``fleet={registry, router, canary}``) and a live
:class:`fleet.CanaryController` attached.  Concurrent clients drive known
inputs through :class:`fleet.FleetClient` across all the models while the
gate walks the whole story inside the budget:

1. mid-run, ``beta@2`` is published with finite-but-huge weights — its
   params pass the finiteness validation, but real matmuls overflow to
   ``inf``, so the gateway's output scan bumps ``serving_nonfinite``: the
   canary controller must propose it, swap ONE replica in place (no
   rebuild), see the poison window, and auto-roll the replica back and
   retire ``beta@2`` — no operator,
2. a real ``fit_supervised`` run (the port's ``linear`` model, SGD on the
   CPU) then publishes ``beta@3`` through the train-to-serve handoff
   (``publish=`` spec); the controller walks it staging -> canary -> live
   across every beta replica,
3. throughout: zero accepted requests lost, every answer numerically
   traceable to a published version, ``serving_compiles`` flat on every
   replica through BOTH swaps (weight copies reuse every warm rung),
   client p99 flat through the swap, the version-labeled ``nonfinite``
   alert pages on ``/alerts``, ``/fleet`` serves the control-plane state,
   and ``fleet.replay_journal`` re-derives the exact decision stream from
   the canary journal.

The JAX gate's ``--warm-cache-dir`` (each model's second replica warming
from its first's stored rungs) is left out, so all replicas start at once:
each rung's AOTInductor compile takes about 20 s on the CPU, three models'
worth would triple this gate's time.  Replicas warming from a warm dir, by
flag and by a registry entry's ``warm_dir``, are held by
``tests/test_torch_compilecache_aoti.py``.

    python scripts/ci_assert_torch_fleet.py

Exit 0 = the fleet plane held end to end.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BUDGET_SECS = 240.0
N_CLIENTS = 6
MAX_BATCH = 8
#: fleet model -> v1 linear coefficients (y = k0*a + k1*b)
MODELS = {"alpha": (2.0, 3.0), "beta": (4.0, 5.0), "gamma": (6.0, 7.0)}
MODEL_CONFIG = {"architecture": "linear", "features": 1}
SIGNATURE = {"x": [None, 2]}


def _spawn_replica(roster_addr, registry_root, model, replica_id,
                   task_index):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "tensorflowonspark_torch.inference_cli",
           "--registry", registry_root, "--model", model,
           "--serve", "--port", "0",
           "--roster", "{}:{}".format(*roster_addr),
           "--replica-id", replica_id, "--task-index", str(task_index),
           "--max-batch", str(MAX_BATCH), "--max-wait-ms", "5",
           "--heartbeat", "0.25", "--device", "cpu"]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=5).read().decode()


def _export_version(registry, model, version, kernel, status):
    import torch

    from tensorflowonspark_torch import checkpoint

    export_dir = os.path.join(registry.root, model, version)
    params = {"dense.weight": torch.tensor([[kernel[0], kernel[1]]],
                                           dtype=torch.float32),
              "dense.bias": torch.zeros(1)}
    checkpoint.export_model(export_dir, params, model,
                            model_config=MODEL_CONFIG,
                            input_signature=SIGNATURE)
    return registry.publish(model, version, export_dir,
                            model_config=MODEL_CONFIG, status=status)


def _train_and_publish(registry, tmp):
    """The train-to-serve handoff: fit a real supervised run on y=8a+9b
    and let fit_supervised publish the final checkpoint as beta@3."""
    import functools

    import numpy as np
    import torch

    from tensorflowonspark_torch import checkpoint as ckpt_mod
    from tensorflowonspark_torch import train
    from tensorflowonspark_torch.models import get_model, linear

    rng = np.random.RandomState(7)
    x = rng.rand(32, 2).astype(np.float32)
    y = (8.0 * x[:, 0] + 9.0 * x[:, 1]).astype(np.float32)

    class _Feed(object):
        terminated = False

        def batches(self):
            for lo in range(0, len(x), 8):
                if self.terminated:
                    return
                yield ({"x": x[lo:lo + 8], "y": y[lo:lo + 8]},
                       np.ones(8, np.float32))

        def terminate(self):
            self.terminated = True

    model = get_model("linear", in_features=2)
    params0 = {name: torch.zeros_like(t)
               for name, t in model.state_dict().items()}
    trainer = train.Trainer(linear.loss_fn(model), params0,
                            functools.partial(torch.optim.SGD, lr=0.1),
                            batch_size=8, device="cpu")
    ckpt = ckpt_mod.CheckpointManager(os.path.join(tmp, "ckpt"),
                                      save_interval_steps=1)
    try:
        stats = train.fit_supervised(
            trainer, _Feed, ckpt,
            publish={"registry": registry, "model": "beta",
                     "version": "3", "model_config": MODEL_CONFIG,
                     "input_signature": SIGNATURE})
    finally:
        ckpt.close()
    assert "published" in stats, \
        "fit_supervised did not publish: {}".format(
            stats.get("publish_error"))
    entry = stats["published"]
    assert entry["status"] == "staging" and entry["version"] == "3"
    # the coefficients clients must validate beta@3 answers against come
    # from the export itself, not the (unconverged) true function
    loaded, _desc = ckpt_mod.load_model(entry["export_dir"], validate=True)
    k = loaded["dense.weight"].double().numpy()
    b = float(loaded["dense.bias"][0])
    return (float(k[0][0]), float(k[0][1]), b)


def main():
    import numpy as np

    from tensorflowonspark_torch import (fleet, gateway, observatory,
                                         reservation, watchtower)

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="ci_fleet_")
    registry = fleet.ModelRegistry(os.path.join(tmp, "registry"),
                                   publisher="ci-gate")
    for model, kernel in MODELS.items():
        _export_version(registry, model, "1", kernel, status="live")

    resv = reservation.Server(2 * len(MODELS), heartbeat_interval=0.25,
                              heartbeat_misses=4)
    ring = observatory.SampleRing()
    resv.sample_ring = ring
    wt = watchtower.Watchtower(
        ring=ring, snapshot_fn=resv.metrics_snapshot,
        heartbeat_interval=0.25,
        config={"interval_secs": 0.25, "min_samples": 3,
                "cooldown_secs": 5.0})
    wt.start()
    router = fleet.FleetRouter(registry=registry, budget_per_model=256)
    journal_path = os.path.join(tmp, "canary.jsonl")
    ctl = fleet.CanaryController(
        registry, router, metrics_fn=resv.metrics_snapshot,
        push_knobs=resv.push_knobs, journal_path=journal_path,
        config={"interval_secs": 0.25, "canary_weight": 0.5,
                "clean_windows": 3, "min_requests": 3,
                "confirm_windows": 2, "cooldown_secs": 2.0,
                "revert_cooldown_secs": 2.0, "swap_timeout_secs": 30.0})
    obs = observatory.ObservatoryServer(
        resv.metrics_snapshot, ring=ring, host="127.0.0.1", watchtower=wt,
        fleet={"registry": registry, "router": router, "canary": ctl})
    obs.start()
    roster_addr = resv.start()
    base = "http://{}:{}".format(*obs.addr)

    # 2 replicas per model off the registry (--registry/--model), all
    # started at once: warm starts wait for the compile plane
    procs = []
    for i, model in enumerate(MODELS):
        for j in range(2):
            procs.append(_spawn_replica(
                roster_addr, registry.root, model,
                "ci-{}{}".format(model, j), j * len(MODELS) + i))

    stop = threading.Event()
    try:
        rc = reservation.Client(roster_addr)
        try:
            info = rc.await_reservations(timeout=BUDGET_SECS / 2)
        finally:
            rc.close()
        rows = [m for m in info
                if isinstance(m, dict) and m.get("job_name") == "serving"]
        assert len(rows) == 2 * len(MODELS), \
            "roster did not expose {} serving replicas: {}".format(
                2 * len(MODELS), info)
        # registrations carry the model/version meta the router maps by
        router.sync_roster(info)
        for model in MODELS:
            assert len(router.replicas(model)) == 2, \
                "router did not map 2 replicas for {}: {}".format(
                    model, router.status())

        # steady-state compile counts: flat from here through BOTH swaps
        # (wait for every replica's first metric-carrying heartbeat)
        deadline = time.time() + BUDGET_SECS / 4
        while True:
            nodes0 = resv.metrics_snapshot()["nodes"]
            if all(rid in nodes0 and "serving_compiles" in nodes0[rid]
                   for rid in router.replicas()):
                break
            assert time.time() < deadline, \
                "replicas never heartbeat metrics: {}".format(
                    sorted(nodes0))
            time.sleep(0.1)
        compiles0 = {rid: nodes0[rid].get("serving_compiles")
                     for rid in router.replicas()}

        results = []             # (model, a, b, got, latency_s, t_done)
        errors, sheds = [], [0]
        lock = threading.Lock()
        model_cycle = sorted(MODELS)

        def drive(ci):
            client = fleet.FleetClient(router, timeout=10.0,
                                       client_id="ci-c{}".format(ci))
            rng = np.random.default_rng(100 + ci)
            i = 0
            try:
                while not stop.is_set():
                    model = model_cycle[(ci + i) % len(model_cycle)]
                    i += 1
                    a, b = (float(x) for x in rng.random(2) * 10.0)
                    feed = {"x": np.asarray([[a, b]], np.float32)}
                    t1 = time.time()
                    for _ in range(40):
                        try:
                            out = client.predict(model, feed, 1)
                            with lock:
                                results.append(
                                    (model, a, b,
                                     float(next(iter(out.values()))[0][0]),
                                     time.time() - t1, time.time()))
                            break
                        except gateway.OverloadError:
                            with lock:
                                sheds[0] += 1
                            time.sleep(0.01)
                    else:
                        with lock:
                            errors.append(
                                "client {} request never admitted".format(
                                    ci))
                        return
            except Exception as e:   # a lost accepted request lands here
                with lock:
                    errors.append("client {}: {!r}".format(ci, e))
            finally:
                client.close()

        threads = [threading.Thread(target=drive, args=(ci,), daemon=True)
                   for ci in range(N_CLIENTS)]
        for t in threads:
            t.start()
        ctl.start()

        time.sleep(2.0)          # pre-swap latency baseline window
        t_publish = time.time()

        # -- act 1: poisoned beta@2 must auto-roll back ------------------
        # finite params (pass validation) whose matmul overflows float32
        _export_version(registry, "beta", "2", (1e38, 1e38),
                        status="staging")
        deadline = t0 + BUDGET_SECS
        nonfinite_alert = None
        while ("reverted", "beta", "2") not in ctl.decisions:
            assert time.time() < deadline, \
                "canary never rolled beta@2 back: {}".format(ctl.status())
            if nonfinite_alert is None:
                doc = json.loads(_get(base, "/alerts"))
                nonfinite_alert = next(
                    (a for a in doc.get("alerts") or []
                     if a.get("rule") == "nonfinite"
                     and a.get("model") == "beta"), None)
            time.sleep(0.2)
        assert registry.resolve("beta", "2")["status"] == "retired"
        assert registry.default_version("beta") == "1"
        while nonfinite_alert is None:
            assert time.time() < deadline, \
                "version-labeled nonfinite alert never paged on /alerts"
            doc = json.loads(_get(base, "/alerts"))
            nonfinite_alert = next(
                (a for a in doc.get("alerts") or []
                 if a.get("rule") == "nonfinite"
                 and a.get("model") == "beta"), None)
            time.sleep(0.2)
        t_rollback = time.time()

        # -- act 2: fit_supervised publishes beta@3; canary walks it live
        beta3 = _train_and_publish(registry, tmp)
        while ("kept", "beta", "3") not in ctl.decisions:
            assert time.time() < deadline, \
                "canary never promoted beta@3: {}".format(ctl.status())
            time.sleep(0.2)
        t_promote = time.time()
        assert registry.default_version("beta") == "3"
        assert registry.resolve("beta", "1")["status"] == "retired"

        # every beta replica converges on v3 (heartbeat-confirmed)
        while True:
            nodes = resv.metrics_snapshot()["nodes"]
            vers = [nodes[r].get("serving_model_version")
                    for r in router.replicas("beta")]
            if all(v == "3" for v in vers):
                break
            assert time.time() < deadline, \
                "beta replicas never converged on v3: {}".format(vers)
            time.sleep(0.2)
        time.sleep(1.0)          # post-promote latency window
        stop.set()
        for t in threads:
            t.join(timeout=max(1.0, deadline - time.time()))
        assert all(not t.is_alive() for t in threads), \
            "clients did not finish within the budget"
        ctl.stop()

        # -- zero accepted requests lost, all numerically traceable ------
        assert not errors, errors[:3]
        assert len(results) > 200, \
            "too little traffic to judge: {} requests".format(len(results))
        wrong = 0
        versions = {m: [(k[0], k[1], 0.0)] for m, k in MODELS.items()}
        versions["beta"].append(beta3)
        for model, a, b, got, _lat, _t in results:
            if model == "beta" and (not np.isfinite(got)
                                    or abs(got) > 1e30):
                continue          # an answer from the poisoned canary
            if not any(abs(got - (k0 * a + k1 * b + c)) < 1e-2
                       for k0, k1, c in versions[model]):
                wrong += 1
        assert wrong == 0, \
            "{} answers match no published version".format(wrong)

        # -- both swaps were weight flips: compile counts stayed flat ----
        nodes = resv.metrics_snapshot()["nodes"]
        for rid, before in compiles0.items():
            after = nodes[rid].get("serving_compiles")
            assert after == before, \
                "replica {} recompiled through the swaps: {} -> {}".format(
                    rid, before, after)

        # -- p99 flat through publish/rollback/promote -------------------
        pre = sorted(lat for _m, _a, _b, _g, lat, t in results
                     if t < t_publish)
        post = sorted(lat for _m, _a, _b, _g, lat, t in results
                      if t > t_promote)
        assert len(pre) > 30 and len(post) > 30, \
            "latency windows too thin: {}/{}".format(len(pre), len(post))
        p99_pre = pre[int(len(pre) * 0.99)]
        p99_post = post[int(len(post) * 0.99)]
        assert p99_post < max(5.0 * p99_pre, 0.05), \
            "p99 degraded through the swap: {:.1f}ms -> {:.1f}ms".format(
                p99_pre * 1e3, p99_post * 1e3)

        # -- control-plane surfaces --------------------------------------
        doc = json.loads(_get(base, "/fleet"))
        assert doc["registry"]["beta"]["default"] == "3"
        assert {(d["stage"], d["model"], d["version"])
                for d in doc["canary"]["decisions"]} == {
                    ("reverted", "beta", "2"), ("kept", "beta", "3")}
        assert sum(doc["router"]["picks"].values()) >= len(results)

        # -- the journal re-derives the decision stream offline ----------
        replay = fleet.replay_journal(journal_path)
        assert replay["journaled"] == [("reverted", "beta", "2"),
                                       ("kept", "beta", "3")], \
            "journaled decisions off: {}".format(replay["journaled"])
        assert replay["matches"], \
            "replay diverged: derived={} journaled={}".format(
                replay["decisions"], replay["journaled"])

        print("fleet OK: {} requests across {} models ({} sheds retried), "
              "beta@2 poison rolled back in {:.1f}s (nonfinite alert "
              "labeled), trained beta@3 live in {:.1f}s, compiles flat on "
              "{} replicas through both swaps, p99 {:.1f}ms -> {:.1f}ms, "
              "replay re-derived {} decisions in {:.1f}s total".format(
                  len(results), len(MODELS), sheds[0],
                  t_rollback - t_publish,
                  t_promote - t_rollback, len(compiles0), p99_pre * 1e3,
                  p99_post * 1e3, len(replay["journaled"]),
                  time.time() - t0))
        return 0
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=5)
        wt.stop()
        obs.stop()
        resv.stop()
        registry.close()


if __name__ == "__main__":
    sys.exit(main())
