"""CI gate of the port's remediator (the twin of
``scripts/ci_assert_remediator.py``, on ``tensorflowonspark_torch``; it
imports no jax): the remediator must close the detect -> act loop live,
with zero operator involvement.

Port modules driven: ``remediator`` (``evict_straggler``,
``scale_out_workers``, ``rollback_poison``), ``watchtower``,
``backend.LocalBackend.exclude``, the cluster's replacement path,
``dataservice_dispatcher`` and ``dataservice_worker`` (subprocesses),
``dataservice.ServiceFeed``, ``train.Trainer`` / ``fit_supervised``
(``device="cpu"``), ``checkpoint.restore_latest_valid``.  On the card the
eviction and the poison rollback run in ``chip_smoke.py``'s ``control``
phase (its ``control_evict`` and ``control_rollback`` legs), and the
worker scale-out beside its ``dataservice`` phase's processes.

Phase 1 — fleet reshaping.  Boots a dispatcher + 1 feed-worker subprocess
and a 3-node in-process cluster (``cluster.run(..., telemetry=True,
observatory=True, watchtower={...}, remediator={...})``) where the fault
injector, targeted per executor via ``LocalBackend(env_per_executor=...)``:

- executor 0 sleeps ``SLOW_SECS`` before every dispatch (the persistent
  straggler),
- executors 1 and 2 (the data-service consumers of one shared dynamic
  job) slow-drain their prefetch queues for ``SAT_SECS`` (the
  ``dataservice_saturation`` forcing function),

then asserts, with nobody touching anything:

1. the remediator evicts the straggler — ``evict_straggler`` reaches
   ``proposed -> applied -> effect`` on ``GET /remediations``, executor 0
   is fenced + released, and a REPLACEMENT executor is provisioned
   (``tf_status['replacements']``),
2. the remediator scales the data plane out — ``scale_out_workers``
   applies and a second FeedWorker registers with the dispatcher,
3. the run completes with exact element totals: the union of what the
   consumers saw is every source element exactly once, zero duplicates,
4. ``tfos_remediation_actions_total{action,stage}`` counts the stages on
   a live ``GET /metrics`` scrape and ``tf_status['remediations']``
   latches the totals after shutdown,
5. ``<log_dir>/remediator/journal.jsonl`` accounts for every action
   ``/remediations`` served, and ``scripts/metrics_replay_torch.py
   --json`` autodetects + replays it.

Phase 2 — poison rollback.  A 1-node cluster checkpoints EVERY step while
the injector NaNs one batch at step ``NAN_AT_STEP``; the watchtower's
``nonfinite`` crit alert drives the remediator's ``train_rollback`` knob,
the trainer raises ``PoisonRollback``, and ``restore_latest_valid``
quarantines every poisoned step as ``<step>.corrupt`` and restores the
last finite one.  Asserts the run still completes ALL its steps, at least
one ``.corrupt`` quarantine exists on disk, and the journal carries the
applied ``rollback_poison`` action.

The poisoned run's feed waits (bounded by ``DEADLINE_SECS``) a few steps
past the poison for the rollback to be armed, so the alert's arrival is
waited for, not raced against the run's end.

    python scripts/ci_assert_torch_remediator.py

Exit 0 = alerts became actions, actions reshaped the fleet, and the run
never needed a human.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SLOW_SECS = 0.06         # injected per step on executor 0: ~6x its peers
BASE_STEP_SECS = 0.012   # common per-step cost so peers have signal
SAT_SECS = 12.0          # consumer slow-drain duration (then recovers)
SAT_SLEEP = 0.12         # per-chunk drain sleep while saturated
N_SPLITS, PER_SPLIT = 12, 40
NAN_AT_STEP = 6
ROLLBACK_STEPS = 30
DEADLINE_SECS = 60.0
# beats every 0.5 s, fenced after 8 misses (4 s): no check here reads
# the fence, and at the JAX gate's default of 3 a healthy node was fenced
# when its beat thread stalled 1.6 s on a loaded host (the user fn's
# process sends the beats while it imports torch and trains)
HEARTBEAT_MISSES = 8


def _pick_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _spawn_dispatcher(port, journal_dir):
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "tensorflowonspark_torch.dataservice_dispatcher",
         "--host", "127.0.0.1", "--port", str(port),
         "--heartbeat", "0.25", "--misses", "4",
         "--journal-dir", journal_dir],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    line = proc.stdout.readline().decode("utf-8", "replace")
    assert "dispatcher ready" in line, \
        "dispatcher never came up: {!r}".format(line)
    return proc


def _worker_argv(port, worker_id):
    return [sys.executable, "-m",
            "tensorflowonspark_torch.dataservice_worker",
            "--dispatcher", "127.0.0.1:{}".format(port),
            "--reader", "jsonl", "--worker-id", worker_id,
            "--heartbeat", "0.25"]


def _get_json(base, path):
    return json.loads(urllib.request.urlopen(
        base + path, timeout=5).read().decode())


def _node_fn(args, ctx):
    """Every node trains (the cross-node step-time signal); executors 1
    and 2 additionally drain the shared data-service job in a background
    thread and persist exactly what they consumed."""
    import functools
    import json as _json
    import os as _os
    import threading as _threading
    import time as _time

    import numpy as np
    import torch

    from tensorflowonspark_torch import dataservice
    from tensorflowonspark_torch import train as train_mod

    torch.set_num_threads(1)
    stop_file = args["stop_file"]
    drain_thread = None
    if ctx.executor_id in (1, 2):
        feed = ctx.get_service_feed(
            args["splits"], job_name="remgate",
            mode=dataservice.SHARD_DYNAMIC, num_epochs=1,
            timeout=DEADLINE_SECS)
        got = []

        def _drain():
            while not feed.should_stop():
                arrays, count = feed.next_batch_arrays(64)
                if count:
                    got.extend(int(x) for x in arrays[0])
            with open("consumed.json.tmp", "w") as f:
                _json.dump(got, f)
            _os.replace("consumed.json.tmp", "consumed.json")

        drain_thread = _threading.Thread(target=_drain, daemon=True)
        drain_thread.start()

    rng = np.random.RandomState(1 + ctx.executor_id)

    class _Feed:
        def batches(self):
            mask = np.ones((8,), dtype=np.float32)
            while not _os.path.exists(stop_file):
                _time.sleep(BASE_STEP_SECS)
                x = rng.rand(8, 2).astype(np.float32)
                y = x @ np.asarray([3.14, 1.618], dtype=np.float32)
                yield {"x": x, "y": y}, mask

    def loss(params, batch, mask):
        pred = batch["x"] @ params["w"]
        err = (pred - batch["y"]) ** 2 * mask
        return err.sum() / mask.sum().clamp_min(1.0), {}

    trainer = train_mod.Trainer(loss, {"w": torch.zeros(2)},
                                functools.partial(torch.optim.SGD, lr=0.05),
                                batch_size=8, log_steps=10 ** 6,
                                device="cpu")
    trainer.fit_feed(_Feed())
    if drain_thread is not None:
        drain_thread.join(timeout=DEADLINE_SECS)


def _phase_fleet():
    from tensorflowonspark_torch import backend, cluster, dataservice, fault
    from tensorflowonspark_torch import remediator as remediator_mod

    tmp = tempfile.mkdtemp(prefix="ci_remediator_")
    stop_file = os.path.join(tmp, "stop")
    splits, expect = [], []
    for s in range(N_SPLITS):
        path = os.path.join(tmp, "split-{:03d}.jsonl".format(s))
        with open(path, "w") as f:
            for i in range(s * PER_SPLIT, (s + 1) * PER_SPLIT):
                expect.append(i)
                f.write(json.dumps([i, [float(i % 7)] * 8]) + "\n")
        splits.append(path)

    port = _pick_port()
    addr = ("127.0.0.1", port)
    disp = _spawn_dispatcher(port, os.path.join(tmp, "ds-journal"))
    worker0 = subprocess.Popen(_worker_argv(port, "rem-w0"), env=_env(),
                               stdout=subprocess.DEVNULL,
                               stderr=subprocess.DEVNULL)
    straggle = json.dumps({"sleep_per_step_secs": SLOW_SECS})
    slowdrain = json.dumps({"saturate_consumer_secs": SAT_SECS,
                            "saturate_consumer_sleep": SAT_SLEEP})
    b = backend.LocalBackend(3, env_per_executor=[
        {fault.FAULT_SPEC_ENV: straggle},
        {fault.FAULT_SPEC_ENV: slowdrain},
        {fault.FAULT_SPEC_ENV: slowdrain}])
    try:
        t0 = time.time()
        while len(dataservice.DispatcherClient(addr).workers()) < 1:
            assert time.time() - t0 < DEADLINE_SECS, "worker never registered"
            time.sleep(0.05)
        c = cluster.run(
            b, _node_fn,
            tf_args={"stop_file": stop_file, "splits": splits},
            # SPARK mode: nodes run the user fn in a background child, so
            # the elastic plane can admit a replacement mid-run (FILES-mode
            # workers hold their slot for the whole run — no replacements)
            num_executors=3, input_mode=cluster.InputMode.SPARK,
            heartbeat_interval=0.5, heartbeat_misses=HEARTBEAT_MISSES,
            log_dir=tmp,
            telemetry=True, observatory=True,
            data_service="127.0.0.1:{}".format(port),
            watchtower={"interval_secs": 0.5, "window_secs": 8.0,
                        "cooldown_secs": 1.0, "queue_sat_pct": 90.0,
                        "journal_snapshot_secs": 1.0},
            remediator={"interval_secs": 0.25, "window_secs": 6.0,
                        "settle_ticks": 4, "cooldown_secs": 3.0,
                        "confirm_windows": {"evict_straggler": 2,
                                            "scale_out_workers": 2},
                        "max_evictions": 1, "max_workers": 1,
                        "scale_in_idle_windows": 10 ** 6,
                        "replacement_grace_secs": 30.0,
                        "alert_ttl_secs": 10.0,
                        "journal_snapshot_secs": 1.0,
                        "worker_spawn_argv": _worker_argv(port, "rem-spawn")})
        base = "http://%s:%d" % c.observatory.addr
        print("[gate] cluster up at {} ({:.1f}s)".format(base, time.time() - t0), flush=True)
        assert c.remediator is not None and not c.remediator.dry_run, \
            "remediator did not engage"

        # Leg 1+2: poll /remediations until BOTH families have closed
        # their loop (proposed -> applied -> effect), zero operator input.
        deadline = time.time() + DEADLINE_SECS
        stages = {}
        while time.time() < deadline:
            doc = _get_json(base, "/remediations?limit=100")
            stages = {}
            for a in doc.get("actions") or []:
                stages.setdefault(a["action"], set()).add(a["stage"])
            if {"proposed", "applied", "effect"} <= \
                    stages.get("evict_straggler", set()) and \
                    {"proposed", "applied", "effect"} <= \
                    stages.get("scale_out_workers", set()):
                break
            time.sleep(0.3)
        assert {"proposed", "applied", "effect"} <= \
            stages.get("evict_straggler", set()), \
            "eviction never closed its loop: {}".format(stages)
        assert {"proposed", "applied", "effect"} <= \
            stages.get("scale_out_workers", set()), \
            "worker scale-out never closed its loop: {}".format(stages)
        loop_secs = time.time() - t0
        print("[gate] both action loops closed ({:.1f}s): {}".format(loop_secs, {k: sorted(v) for k, v in stages.items()}), flush=True)

        evict = [a for a in _get_json(base, "/remediations?limit=100")
                 ["actions"] if a["action"] == "evict_straggler"
                 and a["stage"] == "applied"][0]
        assert str(evict["executor"]) == "0", \
            "evicted the wrong node: {}".format(evict)
        assert evict["detail"]["replaced"], \
            "eviction did not provision a replacement: {}".format(evict)
        workers = {w.get("worker_id") if isinstance(w, dict) else w
                   for w in dataservice.DispatcherClient(addr).workers()}
        assert len(workers) >= 2, \
            "spawned FeedWorker never registered: {}".format(workers)

        # Leg 4a: the Prometheus family, scraped live.
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=5).read().decode()
        assert ('tfos_remediation_actions_total{action="evict_straggler",'
                'stage="applied"} 1') in text, "metrics family missing"

        # Replacement admitted (the PR 3 chain, driven by the remediator
        # rather than a death).
        t_rep = time.time() + 15.0
        while not c.tf_status.get("replacements") and time.time() < t_rep:
            time.sleep(0.2)
        assert c.tf_status.get("replacements"), \
            "no replacement recorded: {}".format(c.tf_status)
        print("[gate] replacement admitted: {}".format(c.tf_status["replacements"]), flush=True)

        # Let the replacement finish bring-up (manager registered, beats
        # flowing) before the run is allowed to stop: poisoning a node
        # that is still mid-rendezvous reads as a vanished executor.
        t_join = time.time() + 30.0
        while time.time() < t_join:
            nodes = (c.metrics_snapshot() or {}).get("nodes") or {}
            if any(str(k) == "3" for k in nodes):
                break
            time.sleep(0.2)
        assert any(str(k) == "3"
                   for k in (c.metrics_snapshot() or {}).get("nodes") or {}), \
            "replacement executor 3 never started beating"
        print("[gate] replacement beating ({:.1f}s)".format(time.time() - t0),
              flush=True)

        # Leg 3: the shared job completes exactly-once while all this
        # chaos is in flight.
        while not dataservice.DispatcherClient(addr).status("remgate")\
                .get("done"):
            assert time.time() - t0 < 2 * DEADLINE_SECS, \
                "shared job never completed"
            time.sleep(0.2)
        print("[gate] shared job done ({:.1f}s)".format(time.time() - t0), flush=True)
        live_actions = [(a["seq"], a["stage"]) for a in
                        _get_json(base, "/remediations?limit=100")["actions"]]
        with open(stop_file, "w") as f:
            f.write("done")
        c.shutdown(grace_secs=30)
        print("[gate] shutdown complete ({:.1f}s)".format(time.time() - t0), flush=True)
        assert "error" not in c.tf_status, c.tf_status["error"]
        assert c.tf_status.get("remediations"), \
            "tf_status did not latch the remediation totals"

        got = []
        for i in (1, 2):
            path = os.path.join(b.workdir_root,
                                "executor-{}".format(i), "consumed.json")
            assert os.path.exists(path), \
                "consumer {} never persisted its elements".format(i)
            with open(path) as f:
                got.extend(json.load(f))
        assert sorted(got) == sorted(expect), \
            "elements lost or duplicated: {} consumed vs {} expected " \
            "({} unique)".format(len(got), len(expect), len(set(got)))

        # Leg 5: the journal accounts for every served action; replay
        # autodetects it.
        jpath = os.path.join(tmp, "remediator", "journal.jsonl")
        records = remediator_mod.read_journal(jpath)
        kinds = {r.get("kind") for r in records}
        assert {"meta", "alert", "snapshot", "action"} <= kinds, \
            "journal incomplete: {}".format(sorted(kinds))
        journaled = {(r.get("seq"), r.get("stage")) for r in records
                     if r.get("kind") == "action"}
        missing = [a for a in live_actions if tuple(a) not in journaled]
        assert not missing, \
            "actions on /remediations missing from the journal: {}".format(
                missing)
        out = subprocess.run(
            [sys.executable,
             os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "metrics_replay_torch.py"), jpath, "--json"],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, \
            "metrics_replay failed: {}\n{}".format(out.stdout, out.stderr)
        doc = json.loads(out.stdout)
        assert doc.get("kind") == "remediator", doc.get("kind")
        assert doc["journaled_actions"], "replay saw no journaled actions"
        assert doc["alerts"] > 0, "replay saw no alert records"
        print("remediator fleet OK in {:.1f}s: straggler evicted + "
              "replaced, worker scaled out, {} elements exactly once, "
              "{} journal action(s) replayed".format(
                  loop_secs, len(got), len(doc["journaled_actions"])))
    finally:
        try:
            with open(stop_file, "w") as f:
                f.write("done")
        except OSError:
            pass
        b.stop()
        for proc in (worker0, disp):
            try:
                proc.terminate()
                proc.wait(timeout=5)
            except Exception:
                proc.kill()


def _rollback_node_fn(args, ctx):
    """Checkpoint EVERY step under supervision; the injector NaNs one
    batch mid-run and the remediator's rollback must carry the run to its
    full step count anyway."""
    import functools
    import json as _json
    import os as _os
    import threading as _threading
    import time as _time

    import numpy as np
    import torch

    from tensorflowonspark_torch import checkpoint as ckpt_mod
    from tensorflowonspark_torch import fault as fault_mod
    from tensorflowonspark_torch import train as train_mod

    torch.set_num_threads(1)
    rng = np.random.RandomState(7)

    def _rollback_seen():
        return trainer._rollback_req is not None or trainer._rollbacks > 0

    class _Feed:
        def batches(self):
            mask = np.ones((8,), dtype=np.float32)
            for i in range(10 * ROLLBACK_STEPS):
                _time.sleep(0.25)
                if i == NAN_AT_STEP + 4:
                    # wait (bounded) for the rollback the poison must
                    # bring, so that a loaded host's later alert still
                    # lands before the run's last step
                    deadline = _time.time() + DEADLINE_SECS
                    while not _rollback_seen() and _time.time() < deadline:
                        _time.sleep(0.05)
                x = rng.rand(8, 2).astype(np.float32)
                y = x @ np.asarray([3.14, 1.618], dtype=np.float32)
                yield {"x": x, "y": y}, mask

    def loss(params, batch, mask):
        pred = batch["x"] @ params["w"]
        err = (pred - batch["y"]) ** 2 * mask
        return err.sum() / mask.sum().clamp_min(1.0), {}

    # log_steps=2: nonfinite tallies are folded at TimeHistory window
    # boundaries (_sync_health), so windows must close DURING the short
    # run for the watchtower's nonfinite rule to ever see the poison.
    trainer = train_mod.Trainer(loss, {"w": torch.zeros(2)},
                                functools.partial(torch.optim.SGD, lr=0.05),
                                batch_size=8, log_steps=2, device="cpu")
    mgr = ckpt_mod.CheckpointManager(_os.path.abspath("ckpt"),
                                     save_interval_steps=1,
                                     max_to_keep=2 * ROLLBACK_STEPS)

    def _disarm():
        # A poisoned batch is transient: the post-rollback replay of the
        # same steps reads clean data.  The env-spec'd injector would
        # re-arm on the retry attempt's fresh feed (an artifact of
        # injection-by-env, not of the fault model), so drop the spec the
        # moment the rollback command lands.
        while not _rollback_seen():
            _time.sleep(0.01)
        _os.environ.pop(fault_mod.FAULT_SPEC_ENV, None)

    _threading.Thread(target=_disarm, daemon=True).start()
    train_mod.fit_supervised(trainer, lambda: _Feed(), mgr,
                             max_steps=ROLLBACK_STEPS)
    with open("result.json", "w") as f:
        _json.dump({"step": int(trainer.state.step),
                    "rollbacks": int(trainer._rollbacks),
                    "ckpt_entries": sorted(_os.listdir("ckpt"))}, f)


def _phase_rollback():
    from tensorflowonspark_torch import backend, cluster, fault
    from tensorflowonspark_torch import remediator as remediator_mod

    tmp = tempfile.mkdtemp(prefix="ci_remediator_rb_")
    spec = json.dumps({"nan_batch_at_step": NAN_AT_STEP})
    b = backend.LocalBackend(1, env_per_executor=[
        {fault.FAULT_SPEC_ENV: spec}])
    try:
        t0 = time.time()
        c = cluster.run(
            b, _rollback_node_fn, tf_args={}, num_executors=1,
            input_mode=cluster.InputMode.FILES,
            heartbeat_interval=0.5, heartbeat_misses=HEARTBEAT_MISSES,
            log_dir=tmp,
            telemetry=True, observatory=True,
            watchtower={"interval_secs": 0.5, "window_secs": 6.0,
                        "cooldown_secs": 1.0,
                        "journal_snapshot_secs": 1.0},
            remediator={"interval_secs": 0.25,
                        "confirm_windows": {"rollback_poison": 1},
                        "settle_ticks": 2, "cooldown_secs": 5.0,
                        "max_rollbacks": 1, "max_evictions": 0,
                        "journal_snapshot_secs": 1.0})
        c.shutdown(grace_secs=5)
        elapsed = time.time() - t0
        assert "error" not in c.tf_status, c.tf_status["error"]

        path = os.path.join(b.workdir_root, "executor-0", "result.json")
        assert os.path.exists(path), "rollback node never wrote its result"
        with open(path) as f:
            result = json.load(f)
        assert result["step"] >= ROLLBACK_STEPS, \
            "run did not complete past the poison step: {}".format(result)
        assert result["rollbacks"] >= 1, \
            "no rollback happened: {}".format(result)
        corrupt = [e for e in result["ckpt_entries"]
                   if e.endswith(".corrupt")]
        assert corrupt, \
            "no poisoned checkpoint quarantined: {}".format(
                result["ckpt_entries"])
        records = remediator_mod.read_journal(
            os.path.join(tmp, "remediator", "journal.jsonl"))
        rb = {r["stage"] for r in records if r.get("kind") == "action"
              and r.get("action") == "rollback_poison"}
        assert "applied" in rb, \
            "rollback_poison never applied: journal stages {}".format(rb)
        print("remediator rollback OK in {:.1f}s: NaN at step {} -> "
              "{} rollback(s), {} checkpoint(s) quarantined, run "
              "completed {} steps".format(elapsed, NAN_AT_STEP,
                                          result["rollbacks"], len(corrupt),
                                          result["step"]))
    finally:
        b.stop()


def main():
    _phase_fleet()
    _phase_rollback()
    return 0


if __name__ == "__main__":
    sys.exit(main())
