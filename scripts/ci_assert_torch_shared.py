"""CI gate of the port's shared jobs and journaled dispatcher (the twin of
``scripts/ci_assert_shared.py``, on ``tensorflowonspark_torch``; it imports
no jax): the multi-tenant data-service tier must survive chaos live.

Boots a dispatcher SUBPROCESS (the real
``python -m tensorflowonspark_torch.dataservice_dispatcher`` entry with
``--journal-dir``), two cache-armed feed-worker subprocesses, and TWO
consumers that share ONE 2-epoch DYNAMIC job (the second run attaches to
the first run's job with ``attach=True``).  Mid-run the dispatcher is
SIGKILLed — a real kill -9, not a clean stop — and restarted on the same
port from its journal.  Every wait is on the event it needs (the ready
line, the roster, the splits streamed, the consumers' end); the deadlines
only bound a hang.  The gate asserts:

1. exact element totals — the union of what the two consumers see is
   every source element exactly twice (once per epoch), zero duplicates,
   across the crash,
2. the restarted dispatcher recovered the job from the journal (same job,
   both consumers still attached, ledger resumed — not restarted),
3. the cache + affinity plane is visible to a scraper: nonzero
   ``tfos_dataservice_cache_hit_total`` and a nonzero affinity tally
   (``tfos_dataservice_affinity_total_total`` with its hit-rate gauge) on
   a live ``GET /metrics`` scrape.

    python scripts/ci_assert_torch_shared.py

Exit 0 = shared jobs, journal recovery, and affinity scheduling verified
end to end.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUDGET_SECS = 120.0   # bounds a hang; nothing waits on it
N_SPLITS, PER_SPLIT = 12, 40


def _pick_port():
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
         "--heartbeat", "0.25", "--misses", "8",
         "--journal-dir", journal_dir, "--snapshot-every", "16"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    line = proc.stdout.readline().decode("utf-8", "replace")
    assert "dispatcher ready" in line, \
        "dispatcher never came up: {!r}".format(line)
    return proc


def _spawn_worker(port, worker_id):
    return subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_torch.dataservice_worker",
         "--dispatcher", "127.0.0.1:{}".format(port), "--reader", "jsonl",
         "--worker-id", worker_id, "--heartbeat", "0.25",
         "--cache-bytes", str(64 << 20)],
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def main():
    from tensorflowonspark_torch import dataservice, observatory

    tmp = tempfile.mkdtemp(prefix="ci_shared_")
    journal_dir = os.path.join(tmp, "journal")
    splits, expect = [], []
    for s in range(N_SPLITS):
        path = os.path.join(tmp, "split-{:03d}.jsonl".format(s))
        with open(path, "w") as f:
            for i in range(s * PER_SPLIT, (s + 1) * PER_SPLIT):
                expect.append(i)
                f.write(json.dumps([i, [float(i % 7)] * 64]) + "\n")
        splits.append(path)

    port = _pick_port()
    addr = ("127.0.0.1", port)
    disp = _spawn_dispatcher(port, journal_dir)
    procs = [_spawn_worker(port, "ci-sw0"), _spawn_worker(port, "ci-sw1")]
    t0 = time.time()
    obs = None
    feeds = []
    try:
        while len(dataservice.DispatcherClient(addr).workers()) < 2:
            assert time.time() - t0 < BUDGET_SECS, "workers never registered"
            time.sleep(0.05)

        # run 1 creates the job; run 2 attaches to it (files=None: the
        # attached consumer adopts the registered spec wholesale)
        feed_a = dataservice.ServiceFeed(
            addr, splits, job_name="ci-shared",
            mode=dataservice.SHARD_DYNAMIC, consumer_id="ci-shared-a",
            num_epochs=2, timeout=BUDGET_SECS)
        feed_a._ensure_started()
        assert feed_a.created_job, "first run did not create the job"
        feed_b = dataservice.ServiceFeed(
            addr, None, job_name="ci-shared", attach=True,
            consumer_id="ci-shared-b", timeout=BUDGET_SECS)
        feeds = [feed_a, feed_b]

        def _merged():
            agg = {}
            for f in feeds:
                for k, v in f.counters_snapshot().items():
                    agg[k] = agg.get(k, 0) + v
            return agg

        obs = observatory.ObservatoryServer(
            lambda: {"nodes": {"ci-shared-a": feed_a.counters_snapshot(),
                               "ci-shared-b": feed_b.counters_snapshot()},
                     "aggregate": _merged()},
            host="127.0.0.1")
        obs_addr = obs.start()

        got = {0: [], 1: []}

        def drain(feed, key):
            while not feed.should_stop():
                arrays, count = feed.next_batch_arrays(64)
                if count:
                    got[key].extend(int(x) for x in arrays[0])

        threads = [threading.Thread(target=drain, args=(f, k), daemon=True)
                   for k, f in enumerate(feeds)]
        for t in threads:
            t.start()

        # chaos: once a few splits have streamed, SIGKILL the dispatcher
        # (no BYE, no snapshot flush) and restart it on the same port
        while _merged().get("dataservice_splits", 0) < 3:
            assert time.time() - t0 < BUDGET_SECS, \
                "no splits streamed before the kill window"
            time.sleep(0.02)
        disp.send_signal(signal.SIGKILL)
        disp.wait(timeout=10)
        kill_at = time.time()
        disp = _spawn_dispatcher(port, journal_dir)
        recovery_secs = time.time() - kill_at

        for t in threads:
            t.join(timeout=BUDGET_SECS)
        elapsed = time.time() - t0
        assert not any(t.is_alive() for t in threads), \
            "consumers did not complete within {}s of start".format(
                BUDGET_SECS)

        status = dataservice.DispatcherClient(addr).status("ci-shared")
        assert status["done"], "job never completed: {}".format(status)
        assert status["consumers"] == 2, \
            "restart dropped a consumer: {}".format(status)
        combined = sorted(got[0] + got[1])
        assert combined == sorted(expect * 2), \
            ("element totals wrong across the crash: {} items vs {} "
             "expected (exactly twice each)".format(
                 len(combined), 2 * len(expect)))
        assert got[0] and got[1], \
            "one consumer starved: {} / {} items".format(
                len(got[0]), len(got[1]))

        agg = _merged()
        assert agg.get("dataservice_cache_hit", 0) > 0, \
            "no warm cache hits despite a 2-epoch cached job: {}".format(agg)
        assert agg.get("dataservice_affinity_total", 0) > 0, \
            "no affinity tally reached the consumers: {}".format(agg)

        # the same facts must be visible to a scraper, not just in-process
        body = urllib.request.urlopen(
            "http://{}:{}/metrics".format(*obs_addr), timeout=5).read()
        scraped = {}
        for line in body.decode("utf-8").splitlines():
            for key in ("tfos_dataservice_cache_hit_total{",
                        "tfos_dataservice_affinity_hits_total{",
                        "tfos_dataservice_affinity_total_total{",
                        "tfos_dataservice_affinity_hit_pct_max{"):
                if line.startswith(key):
                    # one sample PER EXECUTOR: counters sum across the
                    # fleet, gauges take the max — a plain overwrite would
                    # let whichever consumer scored zero (warm hits land
                    # on ONE of them) clobber the other's tally
                    name = key.rstrip("{")
                    value = float(line.rsplit(None, 1)[1])
                    if name.endswith("_max"):
                        scraped[name] = max(scraped.get(name, 0.0), value)
                    else:
                        scraped[name] = scraped.get(name, 0.0) + value
        assert scraped.get("tfos_dataservice_cache_hit_total", 0) > 0, \
            "no tfos_dataservice_cache_hit_total on /metrics"
        assert scraped.get("tfos_dataservice_affinity_total_total", 0) > 0, \
            "no affinity tally on /metrics: {}".format(scraped)
        hit_rate = scraped.get("tfos_dataservice_affinity_hit_pct_max", 0.0)
        assert 0.0 <= hit_rate <= 100.0, \
            "affinity hit-rate gauge out of range: {}".format(hit_rate)

        for f in feeds:
            f.terminate()
        feeds = []
        print("shared OK: {} elements exactly twice across a dispatcher "
              "SIGKILL (recovered in {:.2f}s), split {}/{} between 2 "
              "consumers, {} cache hits, affinity {:.0f}/{:.0f} "
              "({:.0f}%) in {:.1f}s".format(
                  len(combined), recovery_secs, len(got[0]), len(got[1]),
                  int(agg["dataservice_cache_hit"]),
                  scraped.get("tfos_dataservice_affinity_hits_total", 0),
                  scraped["tfos_dataservice_affinity_total_total"],
                  hit_rate, elapsed))
        return 0
    finally:
        for f in feeds:
            f.terminate()
        if obs is not None:
            obs.stop()
        for p in procs + [disp]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=5)


if __name__ == "__main__":
    sys.exit(main())
