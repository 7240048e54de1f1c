"""CI gate of the port's cluster-wide on-demand profiling and MFU
attribution (the twin of ``scripts/ci_assert_profiling.py``, on
``tensorflowonspark_torch``; it imports no jax).

Port modules driven: ``cluster`` (``profiler=True``, ``observatory=True``,
``telemetry=True``), ``profiler`` (each node's ``torch.profiler``
endpoint), ``profiling.CaptureCoordinator`` (``GET /profile``,
``capture.json``), ``train.Trainer.fit_feed`` (``device="cpu"``) and its
attribution report, and ``scripts/analyze_profile_torch.py``
(``profiling.merge_capture``).  Two legs change form on the CPU:

- the ``attrib_*`` buckets read the step's roofline, which needs peak
  rates the port has only for a card: the node function names the JAX
  package's nominal CPU peaks (1e11 FLOP/s, 5e10 B/s) on the port's
  ``metrics`` module, as ``tests/test_torch_observatory.py`` does, and
  fits its weight as a [2, 1] matrix (``FlopCounterMode`` sees no
  matrix-vector product);
- ``torch.profiler`` on the CPU records the node's CPU ops, not a device's
  kernels: the merged timeline must hold the node trace's op events
  (``cpu_op``, or ``kernel`` on a card) beside the host telemetry events.

The JAX gate keeps the node hot with jitted steps after ``fit_feed``; the
twin runs eager ones on a side thread beside it (a SPARK-mode ``fit_feed``
returns only at shutdown, after the capture).  On the card
``chip_smoke.py``'s ``observability`` phase captures the flash kernels
themselves and reads the attribution against the H100's peaks.

Boots a 2-node in-process cluster (``cluster.run(..., telemetry=True,
observatory=True, profiler=True)``) whose node fn trains a linear model
through ``Trainer.fit_feed`` while a side thread holds the process alive
running small eager steps, and asserts the device-plane observability
legs:

1. **attribution gauges** — the ``tfos_attrib_*_pct_max`` gauges appear on
   ``/metrics`` mid-run and the buckets sum to 100% (+-5), and ``/status``
   lists the per-node ``profiler_addresses``,
2. **on-demand capture** — ``GET /profile?duration_ms=...`` mid-run answers
   with a capture id, every node's artifacts land under
   ``profiles/<capture_id>/node-<executor>/`` on the driver, and the
   ``capture.json`` manifest carries the metrics snapshot; ``/status``
   reports the capture complete,
3. **one merged timeline** — ``scripts/analyze_profile_torch.py`` merges
   the per-node ``torch.profiler`` traces with the host-side telemetry
   traces into one Chrome-trace JSON containing both node-trace op events
   and host events.

    python scripts/ci_assert_torch_profiling.py

Exit 0 = a live cluster can explain where its step time goes, on demand,
from one HTTP endpoint.
"""

import glob
import json
import os
import sys
import tempfile
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

ATTRIB_DEADLINE_SECS = 60.0
CAPTURE_DEADLINE_SECS = 45.0
HOLD_TIMEOUT_SECS = 90.0   # node-side backstop: never outlive the driver
#: the JAX package's nominal CPU figures (its ``metrics.py`` keys "cpu")
CPU_PEAK_FLOPS = 1e11
CPU_PEAK_BYTES_PER_SEC = 5e10
#: the node trace's op events: CPU ops here, kernels on a card
NODE_OP_CATS = ("cpu_op", "kernel")
# beats every 1.0 s, fenced after 8 misses (8 s): no check here reads
# the fence, and a capture adds work to a node whose process also sends
# its beats while it imports torch and trains; at 0.5 s and the default
# 3 misses, a healthy node was fenced when its beat thread stalled 1.6 s
# on a loaded host
HEARTBEAT_MISSES = 8


def _node_fn(args, ctx):
    """Linear fit via fit_feed (closes accountant windows -> attrib gauges)
    while a side thread holds the process hot until the driver's release
    file appears, so the capture has a live node to profile."""
    import functools
    import os as _os
    import threading
    import time as _time

    import numpy as np
    import torch

    from tensorflowonspark_torch import metrics as metrics_mod
    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.parallel import infeed

    torch.set_num_threads(1)
    # the JAX package's nominal CPU peaks: the attribution needs a roofline
    metrics_mod.peak_flops_per_device = lambda device=None: CPU_PEAK_FLOPS
    metrics_mod.peak_bytes_per_sec_per_device = \
        lambda device=None: CPU_PEAK_BYTES_PER_SEC

    def loss(params, batch, mask):
        # w is a [2, 1] matrix: FlopCounterMode counts a matrix product
        # but no matrix-vector product
        pred = (batch["x"] @ params["w"])[:, 0] + params["b"]
        err = (pred - batch["y"]) ** 2 * mask
        return err.sum() / mask.sum().clamp_min(1.0), pred

    trainer = train_mod.Trainer(loss, {"w": torch.zeros(2, 1),
                                       "b": torch.zeros(())},
                                functools.partial(torch.optim.SGD, lr=0.1),
                                batch_size=8, log_steps=2, device="cpu")

    def preprocess(items):
        arr = np.asarray(items, np.float32).reshape(-1)
        return {"x": np.stack([arr, arr * 0.5], axis=1), "y": arr * 2.0}

    sharded = infeed.ShardedFeed(ctx.get_data_feed(), 8,
                                 preprocess=preprocess, device="cpu")

    # Keep issuing work while the driver triggers the capture: an idle
    # node yields an empty (but valid) trace; a hot one proves the merge
    # on real events.  In SPARK mode fit_feed returns only once shutdown
    # ends the feed, after the capture, so the work runs on a side thread
    # from the start (the capture records every thread's CPU ops).
    def _hold():
        x = torch.ones(32, 32)
        deadline = _time.monotonic() + HOLD_TIMEOUT_SECS
        while (_time.monotonic() < deadline
               and not _os.path.exists(args["release_file"])):
            float((x @ x).sum())
            _time.sleep(0.05)

    hold = threading.Thread(target=_hold, daemon=True)
    hold.start()
    trainer.fit_feed(sharded)
    hold.join()


def _get(base, path, timeout=5):
    return urllib.request.urlopen(base + path, timeout=timeout).read().decode()


def main():
    from tensorflowonspark_torch import backend, cluster, profiling
    from tensorflowonspark_torch.cluster import InputMode

    tmp = tempfile.mkdtemp(prefix="tfos-profiling-")
    tdir = os.path.join(tmp, "telemetry")
    release_file = os.path.join(tmp, "release")
    b = backend.LocalBackend(2)
    try:
        c = cluster.run(b, _node_fn, tf_args={"release_file": release_file},
                        num_executors=2, input_mode=InputMode.SPARK,
                        # 1s beats (3s liveness tolerance): a capture adds
                        # real CPU work on the nodes, and on a loaded 1-core
                        # CI box the tight 0.5s cadence false-fences a node
                        # whose beat thread gets starved mid-capture
                        log_dir=tmp, heartbeat_interval=1.0,
                        heartbeat_misses=HEARTBEAT_MISSES,
                        telemetry=True, telemetry_dir=tdir,
                        observatory=True, profiler=True)
        assert c.observatory is not None and c.observatory.addr, \
            "observatory did not start"
        base = "http://%s:%d" % c.observatory.addr
        c.train(backend.partition(range(256), 2))

        # Leg 1: attribution gauges + profiler addresses, mid-run.
        attrib = {}
        deadline = time.time() + ATTRIB_DEADLINE_SECS
        while time.time() < deadline:
            text = _get(base, "/metrics")
            attrib = {}
            for line in text.splitlines():
                if line.startswith("tfos_attrib_") and " " in line:
                    name, value = line.rsplit(" ", 1)
                    attrib[name.split("{")[0]] = float(value)
            if attrib:
                break
            time.sleep(0.5)
        assert attrib, "no tfos_attrib_* gauges appeared on /metrics " \
            "within %.0fs" % ATTRIB_DEADLINE_SECS
        total = sum(attrib.values())
        assert abs(total - 100.0) <= 5.0, \
            "attribution buckets sum to {:.2f}%, not 100+-5: {}".format(
                total, attrib)
        status = json.loads(_get(base, "/status"))
        addrs = status.get("profiler_addresses") or []
        assert len(addrs) == 2 and all(":" in a for a in addrs), \
            "/status profiler_addresses wrong: {}".format(addrs)

        # Leg 2: trigger a capture over the live cluster and wait for both
        # nodes' artifacts to land.
        trig = json.loads(_get(base, "/profile?duration_ms=800"))
        capture_id, capture_dir = trig["capture_id"], trig["dir"]
        assert sorted(trig["targets"]) == ["0", "1"], trig
        deadline = time.time() + CAPTURE_DEADLINE_SECS
        last = None
        while time.time() < deadline:
            last = json.loads(_get(base, "/status")).get("last_capture")
            if last and last.get("complete"):
                break
            time.sleep(0.5)
        assert last and last.get("complete"), \
            "capture {} never completed: {}".format(capture_id, last)
        assert not last.get("errors"), \
            "capture reported node errors: {}".format(last["errors"])
        for ex in (0, 1):
            files = glob.glob(os.path.join(capture_dir,
                                           "node-%d" % ex, "**", "*"),
                              recursive=True)
            assert any(os.path.isfile(p) for p in files), \
                "node %d delivered no artifacts under %s" % (ex, capture_dir)
        with open(os.path.join(capture_dir, "capture.json")) as f:
            manifest = json.load(f)
        assert manifest["capture_id"] == capture_id
        agg = (manifest.get("metrics") or {}).get("aggregate") or {}
        assert any(k.startswith("attrib_") for k in agg), \
            "manifest metrics snapshot has no attribution report"

        # Release the nodes, then shut down so every telemetry trace
        # flushes before the merge.
        with open(release_file, "w") as f:
            f.write("done")
        c.shutdown(grace_secs=5)
        assert "error" not in c.tf_status, c.tf_status["error"]

        # Leg 3: one merged Perfetto timeline, node-trace + host events.
        import analyze_profile_torch
        merged_path = os.path.join(capture_dir, "merged_timeline.json")
        rc = analyze_profile_torch.main([capture_dir, "--telemetry-dir", tdir,
                                         "--out", merged_path])
        assert rc == 0, "analyze_profile_torch failed with rc=%s" % rc
        with open(merged_path) as f:
            merged = json.load(f)
        events = merged.get("traceEvents") or []
        node_ops = [e for e in events
                    if isinstance(e.get("pid"), int)
                    and e["pid"] >= profiling.TRACE_PID_BASE
                    and e.get("cat") in NODE_OP_CATS]
        assert node_ops, \
            "merged timeline has no node-trace op events (cats: %s)" % sorted(
                {x for x in (e.get("cat") for e in events) if x})
        host_events = [e for e in events
                       if isinstance(e.get("pid"), int)
                       and e["pid"] < profiling.TRACE_PID_BASE]
        assert host_events, "merged timeline has no host-side events"

        print("profiling OK: attrib sum {:.2f}%, capture {} collected "
              "{} node dir(s), merged timeline has {} events "
              "({} node ops, {} host-side)".format(
                  total, capture_id, len(manifest.get("nodes") or {}),
                  len(events), len(node_ops), len(host_events)))
        return 0
    finally:
        try:
            with open(release_file, "w") as f:
                f.write("done")
        except OSError:
            pass
        b.stop()


if __name__ == "__main__":
    sys.exit(main())
