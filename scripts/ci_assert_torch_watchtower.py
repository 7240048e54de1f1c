"""CI gate of the port's watchtower (the twin of
``scripts/ci_assert_watchtower.py``, on ``tensorflowonspark_torch``; it
imports no jax): the watchtower must catch an injected straggler AND an
injected NaN loss while the run is live, attribute each to the right
executor on every alert surface, and the metrics journal must reproduce
the same alerts offline after the cluster is gone.

Boots a 2-node in-process cluster (``cluster.run(..., telemetry=True,
observatory=True)``) of the port, every node a ``train.Trainer`` on the
CPU (``device="cpu"``), where the fault injector (``fault.py``), targeted
per executor via ``backend.LocalBackend(env_per_executor=...)``:

- executor 0 sleeps ``SLOW_SECS`` before every dispatch (the straggler),
- executor 1 gets one all-NaN batch at step ``NAN_AT_STEP`` (the poisoned
  loss — NaN propagates into params, so every later window counts too),

then asserts, while the run is live:

1. **GET /alerts** — a ``straggler_*`` alert names executor 0 (and no
   straggler alert ever names executor 1), a ``nonfinite`` alert names
   executor 1, and ``suspects`` carries executor 0,
2. **GET /metrics** — ``tfos_alerts_total{rule=...}`` counts both rules
   and the ``tfos_build_info`` gauge is present,
3. **GET /status** — the ``watchtower`` block reports active rules and
   alert counts,

and after shutdown, with the cluster gone:

4. the driver trace contains ``watchtower/alert`` instants for both rules,
5. ``<log_dir>/watchtower/journal.jsonl`` parses (meta + snapshots +
   alert records), and ``scripts/metrics_replay_torch.py --json``
   re-derives a correctly-attributed straggler AND nonfinite alert from
   the journal alone.

Port modules driven: ``cluster``, ``backend``, ``fault``, ``train``,
``watchtower``, ``observatory``, ``telemetry``.  On the card the same
planes run in ``chip_smoke.py``'s ``control`` phase (its eviction leg
fires a straggler alert at a node slowed by ``TFOS_FAULT_SPEC``) and its
``observability`` phase.

    python scripts/ci_assert_torch_watchtower.py

Exit 0 = detection, attribution, and offline replay all hold.
"""

import glob
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 120
BASE_STEP_SECS = 0.012   # common per-step cost so the fast node has signal
SLOW_SECS = 0.06         # injected on executor 0 only: ~6x the peer
NAN_AT_STEP = 6          # poisons executor 1's loss from step 6 on
ALERT_DEADLINE_SECS = 45.0
# beats every 0.5 s, fenced after 8 misses (4 s): no check here reads
# the fence, and at the JAX gate's default of 3 a healthy node was fenced
# when its beat thread stalled 1.6 s on a loaded host (the user fn's
# process sends the beats while it imports torch and trains)
HEARTBEAT_MISSES = 8


def _node_fn(args, ctx):
    """Linear fit over a local synthetic feed; the fault injector (spec via
    the per-executor env) makes executor 0 slow and executor 1 NaN."""
    import functools
    import os as _os
    import time as _time

    import numpy as np
    import torch

    from tensorflowonspark_torch import train as train_mod

    torch.set_num_threads(1)
    rng = np.random.RandomState(1 + ctx.executor_id)

    class _Feed:
        def batches(self):
            mask = np.ones((8,), dtype=np.float32)
            for _ in range(STEPS):
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
                                batch_size=8, log_steps=5, device="cpu")
    trainer.fit_feed(_Feed())
    # Park until the driver has confirmed the alerts (or the deadline): the
    # straggler comparison needs BOTH nodes registered and beating while
    # executor 0 is still slow-stepping.
    deadline = _time.time() + ALERT_DEADLINE_SECS
    while not _os.path.exists(args["stop_file"]) and _time.time() < deadline:
        _time.sleep(0.25)


class _AlertPoller(threading.Thread):
    """Polls /alerts, /metrics and /status until both injected faults show
    up correctly attributed (or the deadline passes)."""

    def __init__(self, addr):
        super().__init__(daemon=True)
        self.base = "http://%s:%d" % addr
        self.stop_evt = threading.Event()
        self.straggler_ok = False       # straggler_* alert names executor 0
        self.nonfinite_ok = False       # nonfinite alert names executor 1
        self.suspect_ok = False         # suspects map carries executor 0
        self.metrics_ok = False         # tfos_alerts_total for both rules
        self.build_info_ok = False      # tfos_build_info gauge present
        self.status_ok = False          # /status has the watchtower block
        self.misattributed = []         # straggler alerts naming executor 1
        self.errors = []

    def _get_json(self, path):
        return json.loads(urllib.request.urlopen(
            self.base + path, timeout=5).read().decode())

    def run(self):
        deadline = time.time() + ALERT_DEADLINE_SECS
        while not self.stop_evt.is_set() and time.time() < deadline:
            try:
                doc = self._get_json("/alerts")
            except Exception as e:
                self.errors.append("alerts poll: %s" % e)
                time.sleep(0.3)
                continue
            for a in doc.get("alerts") or []:
                rule, ex = a.get("rule", ""), str(a.get("executor"))
                if rule.startswith("straggler_"):
                    if ex == "0":
                        self.straggler_ok = True
                    else:
                        self.misattributed.append((rule, ex))
                if rule == "nonfinite" and ex == "1":
                    self.nonfinite_ok = True
            if (doc.get("suspects") or {}).get("0", "").startswith(
                    "straggler_"):
                self.suspect_ok = True
            if self.straggler_ok and self.nonfinite_ok \
                    and not self.metrics_ok:
                try:
                    text = urllib.request.urlopen(
                        self.base + "/metrics", timeout=5).read().decode()
                    rules = set()
                    for line in text.splitlines():
                        if line.startswith("tfos_build_info{"):
                            self.build_info_ok = True
                        if line.startswith("tfos_alerts_total{"):
                            rules.add(line.split('rule="', 1)[1]
                                      .split('"', 1)[0])
                    self.metrics_ok = (
                        any(r.startswith("straggler_") for r in rules)
                        and "nonfinite" in rules)
                except Exception as e:
                    self.errors.append("metrics poll: %s" % e)
            if not self.status_ok:
                try:
                    st = self._get_json("/status")
                    wt = st.get("watchtower") or {}
                    self.status_ok = bool(wt.get("active_rules")) \
                        and "alert_counts" in wt
                except Exception as e:
                    self.errors.append("status poll: %s" % e)
            if self.straggler_ok and self.nonfinite_ok and self.suspect_ok \
                    and self.metrics_ok and self.build_info_ok \
                    and self.status_ok:
                return
            time.sleep(0.3)


def main():
    from tensorflowonspark_torch import backend, cluster, watchtower

    tmp = tempfile.mkdtemp(prefix="ci_watchtower_")
    tdir = os.path.join(tmp, "telemetry")
    os.makedirs(tdir, exist_ok=True)
    stop_file = os.path.join(tmp, "stop")

    b = backend.LocalBackend(2, env_per_executor=[
        {"TFOS_FAULT_SPEC": json.dumps(
            {"sleep_per_step_secs": SLOW_SECS})},
        {"TFOS_FAULT_SPEC": json.dumps(
            {"nan_batch_at_step": NAN_AT_STEP})},
    ])
    poller = None
    try:
        c = cluster.run(b, _node_fn, tf_args={"stop_file": stop_file},
                        num_executors=2, input_mode=cluster.InputMode.FILES,
                        heartbeat_interval=0.5,
                        heartbeat_misses=HEARTBEAT_MISSES, log_dir=tmp,
                        telemetry=True, telemetry_dir=tdir,
                        observatory=True,
                        watchtower={"interval_secs": 0.5,
                                    "window_secs": 30.0,
                                    "cooldown_secs": 5.0,
                                    "journal_snapshot_secs": 1.0})
        assert c.observatory is not None and c.observatory.addr, \
            "observatory did not start"
        assert c.watchtower is not None, "watchtower did not start"
        poller = _AlertPoller(c.observatory.addr)
        poller.start()
        poller.join(timeout=ALERT_DEADLINE_SECS + 5)
        with open(stop_file, "w") as f:
            f.write("done")
        c.shutdown(grace_secs=10)
        assert "error" not in c.tf_status, c.tf_status["error"]

        # Leg 1: live attribution on /alerts.
        assert poller.straggler_ok, \
            "no straggler_* alert named executor 0 ({})".format(
                poller.errors[-3:])
        assert not poller.misattributed, \
            "straggler alert named the wrong executor: {}".format(
                poller.misattributed)
        assert poller.nonfinite_ok, \
            "no nonfinite alert named executor 1 ({})".format(
                poller.errors[-3:])
        assert poller.suspect_ok, "suspects map never carried executor 0"

        # Leg 2+3: the other live surfaces.
        assert poller.metrics_ok, \
            "tfos_alerts_total missing straggler_*/nonfinite rules"
        assert poller.build_info_ok, "tfos_build_info gauge never scraped"
        assert poller.status_ok, "/status never served the watchtower block"
        # The live suspect rule was already checked on /alerts; by shutdown
        # a heartbeat_miss may have overwritten the rule name here.
        assert "0" in c.tf_status.get("suspects", {}), \
            "tf_status['suspects'] missing executor 0: {}".format(
                c.tf_status.get("suspects"))

        # Leg 4: watchtower/alert instants in the driver trace.
        rules_in_trace = set()
        for path in sorted(glob.glob(os.path.join(tdir, "trace-*.json"))):
            with open(path) as f:
                doc = json.load(f)
            for ev in doc.get("traceEvents") or []:
                if ev.get("ph") == "i" and \
                        ev.get("name") == "watchtower/alert":
                    rules_in_trace.add((ev.get("args") or {}).get("rule"))
        assert any(str(r).startswith("straggler_") for r in rules_in_trace), \
            "no straggler watchtower/alert instant in {} (saw {})".format(
                tdir, sorted(rules_in_trace))
        assert "nonfinite" in rules_in_trace, \
            "no nonfinite watchtower/alert instant (saw {})".format(
                sorted(rules_in_trace))

        # Leg 5: the journal parses and the offline replay re-derives both
        # alerts with the same attribution — cluster processes are gone.
        jpath = os.path.join(tmp, "watchtower", "journal.jsonl")
        records = watchtower.read_journal(jpath)
        kinds = {r.get("kind") for r in records}
        assert {"meta", "snapshot", "alert"} <= kinds, \
            "journal {} incomplete: kinds={}".format(jpath, sorted(kinds))
        out = subprocess.run(
            [sys.executable,
             os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "metrics_replay_torch.py"), jpath, "--json"],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, \
            "metrics_replay failed: {}\n{}".format(out.stdout, out.stderr)
        doc = json.loads(out.stdout)
        replayed = {(a.get("rule"), str(a.get("executor")))
                    for a in doc["replayed_alerts"]}
        assert any(r.startswith("straggler_") and ex == "0"
                   for r, ex in replayed), \
            "replay lost the straggler alert: {}".format(sorted(replayed))
        assert ("nonfinite", "1") in replayed, \
            "replay lost the nonfinite alert: {}".format(sorted(replayed))
        assert not any(r.startswith("straggler_") and ex == "1"
                       for r, ex in replayed), \
            "replay misattributed a straggler: {}".format(sorted(replayed))
        assert doc["timeline"], "replay produced no timeline rows"

        print("watchtower OK: straggler->executor 0 and nonfinite->"
              "executor 1 on /alerts, tfos_alerts_total + build_info on "
              "/metrics, {} alert instants in trace, replay re-derived "
              "{} alert(s) offline from {} snapshot(s)".format(
                  len(rules_in_trace), len(replayed), doc["snapshots"]))
        return 0
    finally:
        if poller is not None:
            poller.stop_evt.set()
        try:
            with open(stop_file, "w") as f:
                f.write("done")
        except OSError:
            pass
        b.stop()


if __name__ == "__main__":
    sys.exit(main())
