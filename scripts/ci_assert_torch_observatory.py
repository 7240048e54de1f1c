"""CI gate of the port's observatory (the twin of
``scripts/ci_assert_observatory.py``, on ``tensorflowonspark_torch``; it
imports no jax): the driver observatory must be scrapeable mid-run,
publish the runtime MFU/goodput accountant, and the trace plane must link
a data-service split to a consumer-side dispatch with flow events.

Port modules driven: ``dataservice`` (an in-process ``DispatcherServer``,
``ServiceFeed``), ``python -m tensorflowonspark_torch.dataservice_worker``,
``cluster`` (``observatory=True``), ``parallel.infeed.ShardedFeed`` ->
``train.Trainer.fit_feed`` (``device="cpu"``), ``metrics`` (the
accountant), ``observatory`` (``/metrics``, ``/status``) and
``telemetry`` (``dataservice/split_flow``).  The port's
``metrics.peak_flops_per_device`` has no CPU figure (the card's peak is
the MFU denominator), so the node function names the JAX package's
nominal CPU peaks (1e11 FLOP/s, 5e10 B/s) on the port's ``metrics`` module
before it builds its Trainer, as ``tests/test_torch_observatory.py``
does, and fits its weight as a [2, 1] matrix: the port counts a step's
FLOPs with ``FlopCounterMode``, which sees no matrix-vector product.  On
the card the same gauge reads the H100's peak in ``chip_smoke.py``'s
``observability`` and ``observability_cluster`` phases, and the split
flows cross its ``dataservice`` phase's processes.

Boots the full cross-process stack on localhost:

- an in-process :class:`DispatcherServer` (driver pid) over 16 jsonl splits,
- ONE real feed-worker subprocess (``python -m
  tensorflowonspark_torch.dataservice_worker``) with telemetry enabled,
- a 2-node in-process cluster (``cluster.run(..., telemetry=True,
  observatory=True)``) whose node fn trains a linear model through
  ``ServiceFeed -> ShardedFeed -> Trainer.fit_feed`` on the shared job,

then asserts, while the run is live:

1. **mid-run scrapes** — ``GET /metrics`` answers 200 with parseable
   Prometheus text the whole time; ``GET /status`` serves ``tf_status`` +
   ``metrics_snapshot``,
2. **accountant** — the ``tfos_train_mfu_pct_max`` gauge and the
   ``tfos_goodput_*_total`` breakdown appear per executor, and every
   counter family is monotone across successive scrapes,

and after shutdown:

3. **flow chain** — the per-process trace files contain
   ``dataservice/split_flow`` flow events (ph ``s``/``t``/``f``) where one
   flow id crosses at least three pids: dispatcher start (driver), a
   ``worker_serve`` step (worker subprocess), and the consumer-side
   ``split_commit`` -> ``train_dispatch`` end (executor).

    python scripts/ci_assert_torch_observatory.py

Exit 0 = the observatory answers live and the trace plane links the
planes causally.
"""

import glob
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SPLITS, PER_SPLIT = 16, 24
SCRAPE_DEADLINE_SECS = 60.0
#: the JAX package's nominal CPU figures (its ``metrics.py`` keys "cpu")
CPU_PEAK_FLOPS = 1e11
CPU_PEAK_BYTES_PER_SEC = 5e10

#: gauges/counters a healthy run must expose mid-run, per executor
REQUIRED_GAUGE = "tfos_train_mfu_pct_max"
REQUIRED_COUNTERS = ("tfos_goodput_dispatch_us_total",
                     "tfos_goodput_infeed_starved_us_total")
# beats every 0.5 s, fenced after 8 misses (4 s): no check here reads
# the fence, and at the JAX gate's default of 3 a healthy node was fenced
# when its beat thread stalled 1.6 s on a loaded host (the user fn's
# process sends the beats while it imports torch and trains)
HEARTBEAT_MISSES = 8


def _node_fn(args, ctx):
    """Linear fit over the data service; both executors share the job."""
    import functools
    import time as _time

    import torch

    from tensorflowonspark_torch import dataservice
    from tensorflowonspark_torch import metrics as metrics_mod
    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.parallel import infeed

    torch.set_num_threads(1)
    # the JAX package's nominal CPU peaks: the MFU gauge needs a peak
    metrics_mod.peak_flops_per_device = lambda device=None: CPU_PEAK_FLOPS
    metrics_mod.peak_bytes_per_sec_per_device = \
        lambda device=None: CPU_PEAK_BYTES_PER_SEC
    feed = dataservice.ServiceFeed(
        tuple(args["dispatcher"]), args["splits"], job_name="obs",
        mode=dataservice.SHARD_DYNAMIC,
        consumer_id="obs-c%d" % ctx.executor_id,
        input_mapping={"a_x": "x", "b_y": "y"}, timeout=30.0)
    sharded = infeed.ShardedFeed(feed, 8, prefetch=0, device="cpu")

    def loss(params, batch, mask):
        # w is a [2, 1] matrix: FlopCounterMode counts a matrix product
        # but no matrix-vector product, and the MFU gauge needs a count
        pred = (batch["x"] @ params["w"])[:, 0]
        err = (pred - batch["y"]) ** 2 * mask
        return err.sum() / mask.sum().clamp_min(1.0), {}

    # the jsonl rows arrive as float64; jax's default float32 is the
    # Trainer's compute dtype here
    trainer = train_mod.Trainer(loss, {"w": torch.zeros(2, 1)},
                                functools.partial(torch.optim.SGD, lr=0.05),
                                compute_dtype=torch.float32, batch_size=8,
                                log_steps=2, device="cpu")
    trainer.fit_feed(sharded)
    feed.terminate()
    # Stay registered across a few heartbeats: the accountant's gauges ride
    # the heartbeat channel, and the driver-side scraper must catch them
    # while the cluster is alive.
    _time.sleep(3.0)


class _Scraper(threading.Thread):
    """Polls /metrics and /status until the accountant shows up; records
    counter samples for the monotonicity assertion."""

    def __init__(self, addr):
        super().__init__(daemon=True)
        self.base = "http://%s:%d" % addr
        self.stop_evt = threading.Event()
        self.scrapes = 0
        self.saw_gauge = False
        self.saw_counters = False
        self.status_ok = False
        self.errors = []
        self.history = {}   # (name, labels) -> [values in scrape order]

    def run(self):
        deadline = time.time() + SCRAPE_DEADLINE_SECS
        sample_re = re.compile(
            r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)')
        while not self.stop_evt.is_set() and time.time() < deadline:
            try:
                text = urllib.request.urlopen(
                    self.base + "/metrics", timeout=5).read().decode()
            except Exception as e:
                self.errors.append("metrics scrape: %s" % e)
                time.sleep(0.2)
                continue
            self.scrapes += 1
            names = set()
            for line in text.splitlines():
                if line.startswith("#") or not line:
                    continue
                m = sample_re.match(line)
                if not m:
                    self.errors.append("unparseable line: %r" % line)
                    continue
                name, labels, value = m.group(1), m.group(2) or "", m.group(3)
                names.add(name)
                if name.endswith("_total"):
                    self.history.setdefault((name, labels),
                                            []).append(float(value))
            if REQUIRED_GAUGE in names:
                self.saw_gauge = True
            if all(c in names for c in REQUIRED_COUNTERS):
                self.saw_counters = True
            if not self.status_ok:
                try:
                    st = json.loads(urllib.request.urlopen(
                        self.base + "/status", timeout=5).read().decode())
                    self.status_ok = ("tf_status" in st
                                      and "metrics_snapshot" in st)
                except Exception as e:
                    self.errors.append("status scrape: %s" % e)
            if self.saw_gauge and self.saw_counters and self.status_ok \
                    and self.scrapes >= 3:
                return
            time.sleep(0.2)


def main():
    from tensorflowonspark_torch import backend, cluster

    tmp = tempfile.mkdtemp(prefix="ci_observatory_")
    tdir = os.path.join(tmp, "telemetry")
    os.makedirs(tdir, exist_ok=True)
    rows_x = [[(i % 7) / 7.0, (i % 5) / 5.0]
              for i in range(N_SPLITS * PER_SPLIT)]
    splits = []
    it = iter(rows_x)
    for s in range(N_SPLITS):
        path = os.path.join(tmp, "split-%03d.jsonl" % s)
        with open(path, "w") as f:
            for _ in range(PER_SPLIT):
                x = next(it)
                y = 3.14 * x[0] + 1.618 * x[1]
                f.write(json.dumps([x, y]) + "\n")
        splits.append(path)

    from tensorflowonspark_torch import dataservice
    disp = dataservice.DispatcherServer(heartbeat_interval=0.25,
                                        heartbeat_misses=3, host="127.0.0.1")
    addr = disp.start()

    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    env["TFOS_TELEMETRY"] = "1"
    env["TFOS_TELEMETRY_DIR"] = tdir
    worker = subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_torch.dataservice_worker",
         "--dispatcher", "{}:{}".format(*addr), "--reader", "jsonl",
         "--worker-id", "obs-w0", "--heartbeat", "0.25"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    b = backend.LocalBackend(2)
    scraper = None
    try:
        c = cluster.run(b, _node_fn,
                        tf_args={"dispatcher": list(addr), "splits": splits},
                        num_executors=2, input_mode=cluster.InputMode.FILES,
                        heartbeat_interval=0.5,
                        heartbeat_misses=HEARTBEAT_MISSES,
                        telemetry=True, telemetry_dir=tdir,
                        observatory=True)
        assert c.observatory is not None and c.observatory.addr, \
            "observatory did not start"
        scraper = _Scraper(c.observatory.addr)
        scraper.start()
        scraper.join(timeout=SCRAPE_DEADLINE_SECS + 5)
        c.shutdown(grace_secs=5)
        assert "error" not in c.tf_status, c.tf_status["error"]

        # Leg 1+2: the scraper saw the accountant mid-run.
        assert scraper.scrapes >= 3, \
            "too few successful scrapes: {} ({})".format(
                scraper.scrapes, scraper.errors[-3:])
        assert scraper.saw_gauge, \
            "no {} gauge scraped mid-run ({})".format(
                REQUIRED_GAUGE, scraper.errors[-3:])
        assert scraper.saw_counters, \
            "goodput counters never scraped: {}".format(REQUIRED_COUNTERS)
        assert scraper.status_ok, "/status never served tf_status"
        bad = [k for k, vals in scraper.history.items()
               if any(b < a for a, b in zip(vals, vals[1:]))]
        assert not bad, "counters went backwards: {}".format(bad)

        # The worker's trace flushes on clean SIGTERM shutdown; stop it
        # BEFORE reading the trace files or its worker_serve hops are
        # invisible to the chain assertion below.
        worker.send_signal(signal.SIGTERM)
        worker.wait(timeout=10)

        # Leg 3: one split flow crosses dispatcher -> worker -> consumer.
        flows = {}   # id -> {"pids": set, "legs": set, "phases": set}
        for path in sorted(glob.glob(os.path.join(tdir, "trace-*.json"))):
            with open(path) as f:
                doc = json.load(f)
            for ev in doc.get("traceEvents") or []:
                if ev.get("cat") != "tfos_flow" or \
                        ev.get("name") != "dataservice/split_flow":
                    continue
                rec = flows.setdefault(ev["id"], {"pids": set(),
                                                  "legs": set(),
                                                  "phases": set()})
                rec["pids"].add(ev.get("pid"))
                rec["phases"].add(ev.get("ph"))
                leg = (ev.get("args") or {}).get("leg")
                if leg:
                    rec["legs"].add(leg)
        assert flows, "no dataservice/split_flow events in {}".format(tdir)
        chains = [fid for fid, rec in flows.items()
                  if {"s", "t", "f"} <= rec["phases"]
                  and {"worker_serve", "split_commit",
                       "train_dispatch"} <= rec["legs"]
                  and len(rec["pids"]) >= 3]
        assert chains, \
            "no flow links dispatcher->worker->consumer dispatch; saw " \
            "{}".format({fid: (sorted(rec["legs"]), len(rec["pids"]))
                         for fid, rec in list(flows.items())[:8]})

        print("observatory OK: {} scrapes, MFU gauge + goodput breakdown "
              "live, {} counter series monotone, {} complete split "
              "flow(s) across >=3 pids".format(
                  scraper.scrapes, len(scraper.history), len(chains)))
        return 0
    finally:
        if scraper is not None:
            scraper.stop_evt.set()
        if worker.poll() is None:
            worker.send_signal(signal.SIGTERM)   # clean stop flushes trace
            try:
                worker.wait(timeout=10)
            except subprocess.TimeoutExpired:
                worker.kill()
                worker.wait(timeout=5)
        disp.stop()
        b.stop()


if __name__ == "__main__":
    sys.exit(main())
