"""CI gate of the port's warm-start compile plane (the twin of
``scripts/ci_assert_warmstart.py``, on ``tensorflowonspark_torch``; it
imports no jax): a replacement node must rejoin WARM.

Boots a real 2-node in-process cluster on the CPU with a cluster-shared
compile root (``cluster.run(compile_cache_dir=)``: the kernels' build
cache and the Trainers' AOT artifact store), SIGKILLs one worker's node
process mid-run, and asserts the replacement rejoins on the warm path:

1. every node trains a few real steps of a tiny model through a Trainer
   whose store lives under the compile root, so each resolves its step
   program,
2. the replacement's step program resolves to verdict ``loaded`` — it
   found a fingerprint-matched artifact its predecessor stored,
3. the replacement's ``tfos_compile_cache_aot_load_total`` is nonzero on
   a live ``/metrics`` scrape (the counters ride heartbeats into the
   observatory),
4. every fed element is accounted for exactly once (the elastic-recovery
   guarantee survives the new plumbing).

The JAX gate also asserts a persistent-cache hit and a replacement compile
debt of at most a third of the cold nodes'.  On the port both come from
the kernels' ``nvcc`` builds, which need a CUDA toolkit: on the CPU a step
builds nothing, so there is no hit to count and no debt to divide.  They
are held on the card by ``chip_smoke.py``'s ``warmstart`` phase (hits and
no ``nvcc`` on the warm cluster, ``train_compile_us_max`` cold and warm).

    python scripts/ci_assert_torch_warmstart.py

Exit 0 = warm rejoin proven; any assertion names the stage that broke.
"""

import json
import os
import sys
import tempfile
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_ITEMS = 40   # 4 partitions of 10: the kill (after 5) always interrupts
               # executor 0 MID-partition, so its feed task fails its join
               # and the partition is re-fed wholesale (exactly-once math)
SCRAPE_DEADLINE_SECS = 60.0
REPLACEMENT_DEADLINE_SECS = 120.0   # its fresh process imports torch first
# a node's beats every 0.5 s, fenced after 8 misses: the JAX gate's 2 would
# fence a healthy node whose torch import holds its beat thread off on a
# loaded host; the SIGKILLed node is still named within 4 s
HEARTBEAT_MISSES = 8


def _node_fn(args, ctx):
    """Train a few real steps (the step program's resolution), then consume
    this node's feed for the exactly-once total.  The steps run BEFORE the
    feed loop so the replacement — which may receive no re-dispatched
    partitions — still proves its warm step path."""
    import functools
    import time as _time

    import torch

    from tensorflowonspark_torch import compilecache
    from tensorflowonspark_torch import train as train_mod

    cache_root = (compilecache.configured_dir()
                  or os.environ[compilecache.CACHE_DIR_ENV])

    def loss(params, batch, mask):
        pred = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
        err = (pred - batch["y"]) ** 2 * mask
        return err.sum() / mask.sum().clamp_min(1.0), {}

    trainer = train_mod.Trainer(
        loss, {"w1": torch.zeros(8, 16), "w2": torch.zeros(16)},
        functools.partial(torch.optim.Adam, lr=1e-2), batch_size=4,
        log_steps=2, device="cpu",
        aot_cache=os.path.join(cache_root, "aot"))
    batch = {"x": torch.ones(4, 8), "y": torch.ones(4)}
    mask = torch.ones(4)

    def report(total):
        doc = {
            "executor_id": ctx.executor_id,
            "total": int(total),
            "train_compile_us": int(trainer.counters_snapshot().get(
                "train_compile_us_max", 0)),
            "verdicts": dict(trainer._aot_verdicts),
            "cache": compilecache.stats.counters_snapshot(),
        }
        tmp = "report.json.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, "report.json")   # SIGKILL-safe: never half-written

    for _ in range(3):
        trainer.step(batch, mask)
    report(0)

    feed = ctx.get_data_feed()
    total = 0
    while not feed.should_stop():
        for x in feed.next_batch(2):
            total += int(x)
        report(total)
    report(total)
    # Stay registered across a few beats so the /metrics scrape
    # catches the compile-cache counters while the cluster is live.
    _time.sleep(3.0)


def _scrape_metric(base, name, deadline_secs):
    """Poll /metrics until ``name`` shows a positive sample; returns the
    value (summed over label sets) or None on deadline."""
    deadline = time.time() + deadline_secs
    while time.time() < deadline:
        try:
            text = urllib.request.urlopen(
                base + "/metrics", timeout=5).read().decode()
        except Exception:
            time.sleep(0.3)
            continue
        total = 0.0
        for line in text.splitlines():
            if line.startswith(name) and not line.startswith("#"):
                try:
                    total += float(line.rsplit(None, 1)[-1])
                except ValueError:
                    pass
        if total > 0:
            return total
        time.sleep(0.3)
    return None


def main():
    from tensorflowonspark_torch import backend, cluster, fault
    from tensorflowonspark_torch.cluster import InputMode

    cache_dir = tempfile.mkdtemp(prefix="ci_torch_warmstart_cache_")
    spec = json.dumps({"kill_after_items": 5})
    b = backend.LocalBackend(
        2, env_per_executor=[{fault.FAULT_SPEC_ENV: spec}, None])
    try:
        c = cluster.run(b, _node_fn, tf_args=[], num_executors=2,
                        input_mode=InputMode.SPARK,
                        heartbeat_interval=0.5,
                        heartbeat_misses=HEARTBEAT_MISSES,
                        telemetry=True,
                        telemetry_dir=os.path.join(cache_dir, "telemetry"),
                        observatory=True, log_dir=cache_dir,
                        compile_cache_dir=cache_dir)
        # A partition task the backend queued before the kill can start on
        # the replacement executor before the roster names it ("No cluster
        # node found"): it fed nothing, so the retry on the refreshed roster
        # keeps the exactly-once totals (a race of the cluster layer, seen
        # on a loaded host, not of the compile plane).
        policy = fault.RetryPolicy(max_attempts=5, initial_backoff=1.5,
                                   multiplier=1.5, jitter=0.3,
                                   extra_retryable=["No cluster node found"])
        t0 = time.time()
        c.train(backend.partition(range(N_ITEMS), 4), retry_policy=policy)
        elapsed = time.time() - t0

        # Stage 1: the elastic chain closed (death -> replacement).  The
        # retried partitions can all land on the survivor before the
        # liveness monitor has counted HEARTBEAT_MISSES silent beats (on a
        # loaded host it did, and train() returned first): wait for the
        # death and the replacement's admission themselves, not for train().
        deadline = time.time() + REPLACEMENT_DEADLINE_SECS
        while not (c.tf_status.get("dead_nodes")
                   and c.tf_status.get("replacements")) \
                and "error" not in c.tf_status and time.time() < deadline:
            time.sleep(0.1)
        dead = c.tf_status.get("dead_nodes")
        assert dead and "executor 0" in dead[0], \
            "liveness monitor missed the death: {}".format(c.tf_status)
        assert c.tf_status.get("replacements"), \
            "no replacement admitted: {}".format(c.tf_status)
        assert "replacement_errors" not in c.tf_status, \
            "replacement start task failed: {}".format(c.tf_status)
        assert "error" not in c.tf_status, c.tf_status["error"]

        # Stage 2: the replacement's compile-plane counters reached
        # /metrics while live (the feed may end before the replacement's
        # process is up: wait for its first report, then for its beat).
        replacement = os.path.join(b.workdir_root, "executor-2",
                                   "report.json")
        deadline = time.time() + REPLACEMENT_DEADLINE_SECS
        while not os.path.exists(replacement) and time.time() < deadline:
            time.sleep(0.2)
        assert c.observatory is not None and c.observatory.addr, \
            "observatory did not start"
        loads = _scrape_metric("http://%s:%d" % c.observatory.addr,
                               'tfos_compile_cache_aot_load_total'
                               '{executor="2"}', SCRAPE_DEADLINE_SECS)
        assert loads, "the replacement's tfos_compile_cache_aot_load_total " \
            "never nonzero on /metrics"

        c.shutdown(grace_secs=1)

        # Stage 3: the replacement's verdicts from the on-disk reports.
        reports = {}
        for i in (0, 1, 2):
            path = os.path.join(b.workdir_root,
                                "executor-{}".format(i), "report.json")
            if os.path.exists(path):
                with open(path) as f:
                    reports[i] = json.load(f)
        print("per-node reports:", {
            i: {"total": r["total"], "compile_us": r["train_compile_us"],
                "verdicts": r["verdicts"]}
            for i, r in sorted(reports.items())})
        assert 2 in reports, \
            "replacement wrote no report: {}".format(sorted(reports))
        warm = reports[2]
        assert warm["verdicts"].get("step") == "loaded", \
            "replacement compiled its step program again: {}".format(
                warm["verdicts"])
        assert warm["cache"]["compile_cache_aot_load"] > 0, \
            "replacement loaded no artifact: {}".format(warm["cache"])

        # Stage 4: exactly-once totals across the survivors (executor 0's
        # partial progress is re-fed wholesale after the kill).
        total = sum(reports[i]["total"] for i in (1, 2) if i in reports)
        assert total == sum(range(N_ITEMS)), \
            "partitions lost or double-fed: {} != {}".format(
                total, sum(range(N_ITEMS)))

        print("warm start OK: replacement rejoined with a loaded step "
              "artifact, {} AOT load(s) on /metrics, run completed in "
              "{:.1f}s".format(int(loads), elapsed))
        return 0
    finally:
        b.stop()


if __name__ == "__main__":
    sys.exit(main())
