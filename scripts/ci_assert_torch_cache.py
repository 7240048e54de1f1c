"""CI gate of the port's data-plane cache (the twin of
``scripts/ci_assert_cache.py``, on ``tensorflowonspark_torch``; it imports
no jax): the caching + compression tier must pay off live.

Boots an in-process dispatcher plus TWO cache-armed feed-worker
SUBPROCESSES (the real ``python -m tensorflowonspark_torch.dataservice_worker``
entry with ``--cache-bytes``) and ONE consumer running a 2-epoch
STATIC-sharded job on localhost, with a driver-side observatory over the
consumer's counters.  Every wait is on the event it needs; the deadlines
only bound a hang.  The gate asserts:

1. exact element totals — every source element arrives exactly twice
   (once per epoch), the exactly-once-per-epoch ledger holding with the
   cache on,
2. epoch 2 serves >= 90% of splits from the worker chunk cache
   (``dataservice_cache_hit`` on the consumer; STATIC sharding pins each
   split to the worker that cached it),
3. the negotiated wire codec engaged: ``wire_colv1+<codec>`` frames on
   the link and a nonzero ``tfos_wire_compress_ratio_max`` gauge on a
   live ``GET /metrics`` scrape.

    python scripts/ci_assert_torch_cache.py

Exit 0 = cached epochs and compressed frames verified end to end.
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

BUDGET_SECS = 120.0   # bounds a hang; nothing waits on it
HEARTBEAT_MISSES = 8  # 2 s of silence: no false fence on a loaded host
N_SPLITS, PER_SPLIT = 12, 25


def _spawn_worker(addr, worker_id):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_torch.dataservice_worker",
         "--dispatcher", "{}:{}".format(*addr), "--reader", "jsonl",
         "--worker-id", worker_id, "--heartbeat", "0.25",
         "--cache-bytes", str(64 << 20)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def main():
    from tensorflowonspark_torch import dataservice, observatory

    tmp = tempfile.mkdtemp(prefix="ci_cache_")
    splits, expect = [], []
    for s in range(N_SPLITS):
        path = os.path.join(tmp, "split-{:03d}.jsonl".format(s))
        with open(path, "w") as f:
            for i in range(s * PER_SPLIT, (s + 1) * PER_SPLIT):
                expect.append(i)
                # a repeating payload column keeps zlib's pay-off check
                # engaged (a bare int column is too small to compress)
                f.write(json.dumps([i, [float(i % 7)] * 64]) + "\n")
        splits.append(path)

    disp = dataservice.DispatcherServer(heartbeat_interval=0.25,
                                        heartbeat_misses=HEARTBEAT_MISSES,
                                        host="127.0.0.1")
    addr = disp.start()
    procs = [_spawn_worker(addr, "ci-w0"), _spawn_worker(addr, "ci-w1")]
    t0 = time.time()
    obs = None
    try:
        # STATIC ownership freezes over the live roster at the first task
        # request: both workers must be registered before the job starts
        # or a slow startup pins every split to one worker
        while len(dataservice.DispatcherClient(addr).workers()) < 2:
            assert time.time() - t0 < BUDGET_SECS, \
                "workers never registered"
            time.sleep(0.05)
        feed = dataservice.ServiceFeed(
            addr, splits, job_name="ci-cache", mode=dataservice.SHARD_STATIC,
            consumer_id="ci-cache-c0", num_epochs=2, timeout=BUDGET_SECS)
        obs = observatory.ObservatoryServer(
            lambda: {"nodes": {"ci-cache-c0": feed.counters_snapshot()},
                     "aggregate": feed.counters_snapshot()},
            host="127.0.0.1")
        obs_addr = obs.start()
        got = []

        def drain():
            while not feed.should_stop():
                arrays, count = feed.next_batch_arrays(64)
                if count:
                    got.extend(int(x) for x in arrays[0])

        t = threading.Thread(target=drain, daemon=True)
        t.start()
        t.join(timeout=BUDGET_SECS)
        elapsed = time.time() - t0
        assert not t.is_alive(), \
            "consumer did not complete within {}s".format(BUDGET_SECS)

        status = dataservice.DispatcherClient(addr).status("ci-cache")
        assert status["done"], "job never completed: {}".format(status)
        combined = sorted(got)
        assert combined == sorted(expect * 2), \
            ("element totals wrong: {} items vs {} expected (exactly "
             "twice each)".format(len(combined), 2 * len(expect)))

        # epoch 2 must come from the worker chunk cache: STATIC sharding
        # pins splits to their caching worker, so anything under 90% means
        # the cache (or its freshness check) broke
        assert feed.cache_hits >= int(0.9 * N_SPLITS), \
            "epoch 2 mostly missed the cache: {} hits / {} splits".format(
                feed.cache_hits, N_SPLITS)
        compressed = sum(n for fmt, n in feed.wire_formats.items()
                         if fmt.startswith("colv1+"))
        assert compressed > 0, \
            "no compressed colv1 frames on the link: {}".format(
                feed.wire_formats)

        # the ratio must be visible to a scraper, not just in-process
        body = urllib.request.urlopen(
            "http://{}:{}/metrics".format(*obs_addr), timeout=5).read()
        text = body.decode("utf-8")
        ratio = None
        for line in text.splitlines():
            if line.startswith("tfos_wire_compress_ratio_max{"):
                ratio = float(line.rsplit(None, 1)[1])
        assert ratio is not None and ratio > 1.0, \
            "no usable tfos_wire_compress_ratio_max gauge on /metrics " \
            "(got {!r})".format(ratio)

        feed.terminate()
        print("cache OK: {} elements exactly twice over 2 epochs, {}/{} "
              "epoch-2 cache hits, {} compressed frames, wire ratio "
              "{:.2f}x in {:.1f}s".format(
                  len(combined), feed.cache_hits, N_SPLITS, compressed,
                  ratio, elapsed))
        return 0
    finally:
        if obs is not None:
            obs.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=5)
        disp.stop()


if __name__ == "__main__":
    sys.exit(main())
