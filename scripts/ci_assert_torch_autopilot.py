"""CI gate of the port's autopilot (the twin of
``scripts/ci_assert_autopilot.py``, on ``tensorflowonspark_torch``; it
imports no jax): the autopilot must close the loop live — a 2-node
cluster whose infeed prefetch is pinned low (depth 1 over a bursty
source, the injected starvation) gets its depth raised by the driver-side
controller mid-run, the measured starvation wall-fraction drops, and every
action is accounted for on every surface.

Port modules driven: ``autopilot``, ``guardrails``,
``reservation.Server.push_knobs`` -> ``node.apply_knobs`` ->
``parallel.infeed.ShardedFeed(prefetch=1)``, ``train.Trainer.fit_feed``
(``device="cpu"``), ``observatory``.  On the card the same loop closes in
``chip_smoke.py``'s ``control`` phase (its autopilot leg retunes
``train_steps_per_call`` on a live LM cluster).

Boots a 2-node in-process cluster (``cluster.run(..., telemetry=True,
observatory=True, autopilot={...})``) where each node trains over a
``ShardedFeed(prefetch=1)`` fed by a bursty synthetic source (fast
batches with a periodic slow straggler, mean production just under the
consumer's step cadence — prefetch depth is exactly what rides through
the burst), then asserts, while the run is live:

1. **GET /autopilot** — the controller proposes AND applies an
   ``infeed_prefetch`` raise off the ``infeed_starved`` signal, and a
   ``kept`` action records ``objective_after < objective_before`` (the
   starved wall-fraction measurably dropped),
2. the driver's aggregate heartbeat metrics confirm the retune landed on
   the nodes: ``infeed_prefetch_depth_max`` rises above the pinned depth
   and ``autopilot_knobs_applied`` counts the node-side applications,
3. **GET /metrics** — ``tfos_autopilot_actions_total{stage=...}`` counts
   the stages; **GET /status** — carries the autopilot block,

and after shutdown, with the cluster gone:

4. ``<log_dir>/autopilot/journal.jsonl`` parses (meta + snapshot +
   action records) and contains every action /autopilot served,
5. ``scripts/metrics_replay_torch.py --json`` autodetects the journal as
   an autopilot journal and replays it.

    python scripts/ci_assert_torch_autopilot.py

Exit 0 = the loop closed: sensed, actuated, measured, kept, journaled.
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

FAST_SECS = 0.001    # common batch production cost
SLOW_SECS = 0.048    # every EVERY-th batch: the burst prefetch must absorb
EVERY = 8
DRAIN_SECS = 0.008   # consumer cadence (on_steps hook, excluded from the
                     # starved accounting by design)
DEADLINE_SECS = 45.0
# beats every 0.5 s, fenced after 8 misses (4 s): no check here reads
# the fence, and at the JAX gate's default of 3 a healthy node was fenced
# when its beat thread stalled 1.6 s on a loaded host (the user fn's
# process sends the beats while it imports torch and trains)
HEARTBEAT_MISSES = 8


def _node_fn(args, ctx):
    """Train over a ShardedFeed pinned at prefetch=1; the bursty source
    starves the dispatch loop until the controller deepens the buffer."""
    import functools
    import os as _os
    import time as _time

    import numpy as np
    import torch

    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.parallel import infeed

    torch.set_num_threads(1)
    stop_file = args["stop_file"]

    class _BurstySource:
        def __init__(self):
            self.n = 0

        def next_batch_arrays(self, n):
            self.n += 1
            _time.sleep(SLOW_SECS if self.n % EVERY == 0 else FAST_SECS)
            return (np.ones((n, 4), np.float32),), n

        def should_stop(self):
            return _os.path.exists(stop_file)

        def interrupt(self):
            pass

    sf = infeed.ShardedFeed(_BurstySource(), 8, prefetch=1,
                            device="cpu")

    def loss(params, batch, mask):
        pred = batch[0] @ params["w"]
        err = (pred - 1.0) ** 2 * mask
        return err.sum() / mask.sum().clamp_min(1.0), {}

    trainer = train_mod.Trainer(loss, {"w": torch.zeros(4)},
                                functools.partial(torch.optim.SGD, lr=0.01),
                                batch_size=8, log_steps=10 ** 6,
                                device="cpu")
    trainer.fit_feed(sf, on_steps=lambda n: _time.sleep(DRAIN_SECS))


class _Poller(threading.Thread):
    """Polls /autopilot, the aggregate metrics, /metrics and /status until
    the loop has demonstrably closed (or the deadline passes)."""

    def __init__(self, cluster_obj):
        super().__init__(daemon=True)
        self.c = cluster_obj
        self.base = "http://%s:%d" % cluster_obj.observatory.addr
        self.stop_evt = threading.Event()
        self.kept_drop = None      # kept action with after < before
        self.applied_ok = False    # an applied infeed_prefetch action
        self.depth_ok = False      # node gauge rose above the pinned depth
        self.node_applied = 0      # autopilot_knobs_applied aggregate
        self.prom_ok = False       # tfos_autopilot_actions_total present
        self.status_ok = False     # /status autopilot block
        self.last_doc = {}
        self.errors = []

    def _get_json(self, path):
        return json.loads(urllib.request.urlopen(
            self.base + path, timeout=5).read().decode())

    def run(self):
        deadline = time.time() + DEADLINE_SECS
        while not self.stop_evt.is_set() and time.time() < deadline:
            try:
                doc = self._get_json("/autopilot")
                self.last_doc = doc
            except Exception as e:
                self.errors.append("autopilot poll: %s" % e)
                time.sleep(0.3)
                continue
            for a in doc.get("actions") or []:
                if a.get("knob") != "infeed_prefetch":
                    continue
                if a.get("stage") == "applied":
                    self.applied_ok = True
                if a.get("stage") == "kept" and \
                        a.get("objective_before") is not None and \
                        a.get("objective_after") is not None and \
                        a["objective_after"] < a["objective_before"]:
                    self.kept_drop = a
            try:
                agg = self.c.metrics_snapshot().get("aggregate") or {}
                if agg.get("infeed_prefetch_depth_max", 0) > 1:
                    self.depth_ok = True
                self.node_applied = max(
                    self.node_applied,
                    agg.get("autopilot_knobs_applied", 0))
            except Exception as e:
                self.errors.append("metrics_snapshot: %s" % e)
            if self.kept_drop is not None and not self.prom_ok:
                try:
                    text = urllib.request.urlopen(
                        self.base + "/metrics", timeout=5).read().decode()
                    self.prom_ok = (
                        'tfos_autopilot_actions_total{stage="applied"}'
                        in text and "tfos_autopilot_ticks_total" in text)
                except Exception as e:
                    self.errors.append("metrics poll: %s" % e)
            if not self.status_ok:
                try:
                    st = self._get_json("/status")
                    ap = st.get("autopilot") or {}
                    self.status_ok = "action_counts" in ap \
                        and not ap.get("dry_run", True)
                except Exception as e:
                    self.errors.append("status poll: %s" % e)
            if self.kept_drop is not None and self.applied_ok \
                    and self.depth_ok and self.node_applied >= 1 \
                    and self.prom_ok and self.status_ok:
                return
            time.sleep(0.3)


def main():
    from tensorflowonspark_torch import autopilot, backend, cluster

    tmp = tempfile.mkdtemp(prefix="ci_autopilot_")
    stop_file = os.path.join(tmp, "stop")
    b = backend.LocalBackend(2)
    poller = None
    try:
        t0 = time.time()
        c = cluster.run(
            b, _node_fn, tf_args={"stop_file": stop_file},
            num_executors=2, input_mode=cluster.InputMode.FILES,
            heartbeat_interval=0.5, heartbeat_misses=HEARTBEAT_MISSES,
            log_dir=tmp,
            telemetry=True, observatory=True,
            autopilot={"interval_secs": 0.25, "window_secs": 3.0,
                       "confirm_ticks": 2, "settle_ticks": 2,
                       "cooldown_secs": 1.0, "revert_cooldown_secs": 5.0,
                       "infeed_starved_frac": 0.05, "min_events": 5,
                       "journal_snapshot_secs": 1.0,
                       "knobs": {"infeed_prefetch": {"initial": 1}}})
        assert c.observatory is not None and c.observatory.addr, \
            "observatory did not start"
        assert c.autopilot is not None and not c.autopilot.dry_run, \
            "autopilot did not engage"
        poller = _Poller(c)
        poller.start()
        poller.join(timeout=DEADLINE_SECS + 5)
        loop_secs = time.time() - t0
        live_actions = [(a.get("seq"), a.get("stage"))
                        for a in poller.last_doc.get("actions") or []]
        with open(stop_file, "w") as f:
            f.write("done")
        c.shutdown(grace_secs=15)
        assert "error" not in c.tf_status, c.tf_status["error"]

        # Leg 1: the control loop closed, with measured evidence.
        assert poller.applied_ok, \
            "no applied infeed_prefetch action on /autopilot ({})".format(
                poller.errors[-3:])
        assert poller.kept_drop is not None, \
            "no kept action with a measured starvation drop ({})".format(
                poller.errors[-3:])
        drop = poller.kept_drop
        assert drop["objective_after"] < drop["objective_before"], drop

        # Leg 2: the retune landed on the nodes and was tallied.
        assert poller.depth_ok, \
            "infeed_prefetch_depth_max never rose above the pinned depth"
        assert poller.node_applied >= 1, \
            "autopilot_knobs_applied never counted a node application"

        # Leg 3: the other live surfaces.
        assert poller.prom_ok, "tfos_autopilot_* counters never scraped"
        assert poller.status_ok, "/status never served the autopilot block"

        # Leg 4: the journal accounts for every action /autopilot served.
        jpath = os.path.join(tmp, "autopilot", "journal.jsonl")
        records = autopilot.read_journal(jpath)
        kinds = {r.get("kind") for r in records}
        assert {"meta", "snapshot", "action"} <= kinds, \
            "journal {} incomplete: kinds={}".format(jpath, sorted(kinds))
        journaled = {(r.get("seq"), r.get("stage")) for r in records
                     if r.get("kind") == "action"}
        missing = [a for a in live_actions if a not in journaled]
        assert not missing, \
            "actions on /autopilot missing from the journal: {}".format(
                missing)

        # Leg 5: offline replay autodetects and parses the journal.
        out = subprocess.run(
            [sys.executable,
             os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "metrics_replay_torch.py"), jpath, "--json"],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, \
            "metrics_replay failed: {}\n{}".format(out.stdout, out.stderr)
        doc = json.loads(out.stdout)
        assert doc.get("kind") == "autopilot", doc.get("kind")
        assert doc["snapshots"] > 0, "replay saw no snapshots"
        assert doc["journaled_actions"], "replay saw no journaled actions"

        print("autopilot OK in {:.1f}s: starved frac {:.3f} -> {:.3f} "
              "after {} live action(s), depth raised on {} node "
              "application(s), {} journal action(s) replayed".format(
                  loop_secs, drop["objective_before"],
                  drop["objective_after"], len(live_actions),
                  poller.node_applied, len(doc["journaled_actions"])))
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
