"""CI gate of the port's data service (the twin of
``scripts/ci_assert_dataservice.py``, on ``tensorflowonspark_torch``; it
imports no jax): the disaggregated data service must survive a worker kill.

Boots an in-process dispatcher plus TWO feed-worker SUBPROCESSES (the real
``python -m tensorflowonspark_torch.dataservice_worker`` entry) and TWO
consumers on localhost.  One worker carries ``TFOS_FAULT_SPEC
{"kill_after_items": 10}`` — a genuine SIGKILL that lands MID-split (after
a data block, before its ``split_end``) on the FIRST split that worker
wins, so the job cannot complete until the dead worker is fenced and its
in-flight split re-pools.  (The threshold sits under one split's row
count on purpose: a higher one made the gate racy — on a loaded host the
other worker could drain this tiny job before the armed worker streamed
enough items to die.)  Every wait is on the event it needs (the roster,
the consumers' end, the fence); the deadlines only bound a hang, so a
loaded host slows the gate without failing it.  The gate asserts:

1. both workers register and stream colv1 frames,
2. the killed worker is fenced by heartbeat timeout, the consumer discards
   the partial split, and the dispatcher re-pools it,
3. the survivor re-streams it and BOTH consumers together receive the
   dataset with exact element totals — nothing lost, nothing duplicated.

    python scripts/ci_assert_torch_dataservice.py

Exit 0 = the visitation guarantee held under failure.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUDGET_SECS = 120.0   # bounds a hang; nothing waits on it
# the dispatcher fences after 8 silent beats of 0.25 s: a healthy worker
# whose beat thread a loaded host holds off is not fenced, the SIGKILLed
# one still is within 2 s
HEARTBEAT_MISSES = 8
N_SPLITS, PER_SPLIT = 12, 25


def _spawn_worker(addr, worker_id, fault_spec=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    if fault_spec:
        env["TFOS_FAULT_SPEC"] = json.dumps(fault_spec)
    return subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_torch.dataservice_worker",
         "--dispatcher", "{}:{}".format(*addr), "--reader", "jsonl",
         "--worker-id", worker_id, "--heartbeat", "0.25"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def main():
    from tensorflowonspark_torch import dataservice

    tmp = tempfile.mkdtemp(prefix="ci_dataservice_")
    splits, expect = [], []
    for s in range(N_SPLITS):
        path = os.path.join(tmp, "split-{:03d}.jsonl".format(s))
        with open(path, "w") as f:
            for i in range(s * PER_SPLIT, (s + 1) * PER_SPLIT):
                expect.append(i)
                f.write(json.dumps(i) + "\n")
        splits.append(path)

    disp = dataservice.DispatcherServer(heartbeat_interval=0.25,
                                        heartbeat_misses=HEARTBEAT_MISSES,
                                        host="127.0.0.1")
    addr = disp.start()
    procs = [_spawn_worker(addr, "ci-w0",
                           fault_spec={"kill_after_items": 10}),
             _spawn_worker(addr, "ci-w1")]
    t0 = time.time()
    try:
        # both workers must be on the roster before the job starts: on a
        # loaded host a slow python startup would otherwise let the other
        # worker drain this tiny job alone, and the fault-armed worker
        # would never reach its kill threshold
        while len(dataservice.DispatcherClient(addr).workers()) < 2:
            assert time.time() - t0 < BUDGET_SECS, \
                "workers never registered"
            time.sleep(0.05)
        feeds = [dataservice.ServiceFeed(
            addr, splits, job_name="ci", mode=dataservice.SHARD_DYNAMIC,
            consumer_id="ci-c{}".format(i), timeout=BUDGET_SECS)
            for i in range(2)]
        got = [[], []]

        def drain(i):
            feed = feeds[i]
            while not feed.should_stop():
                arrays, count = feed.next_batch_arrays(64)
                if count:
                    got[i].extend(int(x) for x in arrays)

        threads = [threading.Thread(target=drain, args=(i,), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(0.5, BUDGET_SECS - (time.time() - t0)))
        elapsed = time.time() - t0
        assert all(not t.is_alive() for t in threads), \
            "consumers did not complete within {}s".format(BUDGET_SECS)

        # the consumers' LOST report can re-pool the killed worker's split
        # before its silence reaches the fence: wait for the fence itself
        client = dataservice.DispatcherClient(addr)
        status = client.status("ci")
        while status["dead_workers"] < 1 and time.time() - t0 < BUDGET_SECS:
            time.sleep(0.05)
            status = client.status("ci")
        client.close()
        assert status["done"], "job never completed: {}".format(status)
        assert status["dead_workers"] == 1, \
            "killed worker not fenced: {}".format(status)
        assert status["reassigned"] >= 1, \
            "mid-split kill never re-pooled a split: {}".format(status)
        assert procs[0].wait(timeout=5) != 0, \
            "fault injection never killed worker 0"
        combined = sorted(got[0] + got[1])
        assert combined == sorted(expect), \
            "element totals wrong: {} items vs {} expected".format(
                len(combined), len(expect))
        dupes = sum(f.split_dupes for f in feeds)
        colv1 = sum(n for f in feeds
                    for fmt, n in f.wire_formats.items()
                    if fmt.startswith("colv1"))
        assert colv1 > 0, "transport never used colv1 frames"
        for f in feeds:
            f.terminate()
        print("data service OK: worker killed mid-split, {} split(s) "
              "re-pooled, {} elements exactly once over 2 consumers "
              "({} dupes discarded, {} colv1 frames) in {:.1f}s".format(
                  status["reassigned"], len(combined), dupes, colv1,
                  elapsed))
        return 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=5)
        disp.stop()


if __name__ == "__main__":
    sys.exit(main())
