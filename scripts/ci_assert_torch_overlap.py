"""CI gate of the port's device-resident step loop (the twin of
``scripts/ci_assert_overlap.py``, on ``tensorflowonspark_torch``; it
imports no jax): the loop must actually overlap.

Port modules driven: ``cluster`` (SPARK mode, ``telemetry=True``),
``datafeed.DataFeed`` -> ``parallel.infeed.ShardedFeed`` ->
``train.Trainer.fit_feed`` (``device="cpu"``) under
``TFOS_TRANSFER_GUARD=disallow`` (``train._TransferGuard``), and the async
``checkpoint.CheckpointManager``, whose own write
(``CheckpointManager._write_files``) the node slows by the JAX gate's
0.4 s where that gate slows orbax's save.  On the CPU the host is the
device, so the guard has no host->device copy to refuse: its refusal is
held by ``tests/test_torch_transfer_guard.py`` and on the card by
``chip_smoke.py``'s ``observability`` phase (``transfer_guard="disallow"``
at K = 1 and K = 5); its ``train`` phase saves asynchronously beside the
card's steps.

Boots a real 2-node in-process cluster on the built-in backend with
``telemetry=True`` and ``TFOS_TRANSFER_GUARD=disallow`` exported to the
executors, trains a small linear model through the full data plane
(DataFeed -> ShardedFeed -> Trainer.fit_feed), and asserts the three
overlap legs this repo's MFU story depends on:

1. **device residency** — every dispatch runs under the transfer guard
   at ``"disallow"``; a host->device copy sneaking back onto the dispatch
   path fails the run,
2. **async checkpointing** — a forced ``maybe_save`` whose write is
   artificially slowed (0.4 s) returns in well under that, has NOT landed
   at return time, keeps training (steps complete while the save is in
   flight), and is flushed by ``wait_until_finished``,
3. **overlap telemetry** — the ``dispatch_gap_us`` / ``infeed_*`` counters
   ride heartbeats into ``tf_status["telemetry"]["aggregate"]`` and the
   per-process trace files carry the ``train/dispatch`` /
   ``infeed/device_put`` / ``checkpoint/save`` spans.

    python scripts/ci_assert_torch_overlap.py

Exit 0 = the loop overlaps; any assertion names the leg that broke.
"""

import glob
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Inherited by the executor processes: every fit_feed dispatch in the node
# fn runs under the h2d transfer guard (leg 1).
os.environ["TFOS_TRANSFER_GUARD"] = "disallow"

#: Overlap-specific span/instant names a healthy run must emit somewhere
#: across the per-process trace files.
REQUIRED_EVENTS = (
    "train/dispatch",
    "infeed/device_put",
    "checkpoint/save_requested",
    "checkpoint/save",
)

SAVE_LATENCY_SECS = 0.4   # artificial checkpoint write latency in the node fn
FAST_RETURN_SECS = 0.25   # maybe_save must return well under SAVE_LATENCY
# beats every 0.5 s, fenced after 8 misses (4 s): no check here reads
# the fence, and at the JAX gate's default of 3 a healthy node was fenced
# when its beat thread stalled 1.6 s on a loaded host (the user fn's
# process sends the beats while it imports torch and trains)
HEARTBEAT_MISSES = 8


def _node_fn(args, ctx):
    """Linear-regression fit over the cluster data plane with a slowed
    async checkpoint; records request/landing evidence for the driver."""
    import functools
    import time

    import numpy as np
    import torch

    from tensorflowonspark_torch import checkpoint
    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.parallel import infeed

    torch.set_num_threads(1)
    params = {"w": torch.zeros(2), "b": torch.zeros(())}

    def loss(params, batch, mask):
        pred = batch["x"] @ params["w"] + params["b"]
        err = (pred - batch["y"]) ** 2 * mask
        return err.sum() / mask.sum().clamp_min(1.0), pred

    trainer = train_mod.Trainer(loss, params,
                                functools.partial(torch.optim.SGD, lr=0.1),
                                batch_size=8, device="cpu")

    def preprocess(items):
        arr = np.asarray(items, np.float32).reshape(-1)
        return {"x": np.stack([arr, arr * 0.5], axis=1),
                "y": arr * 2.0}

    sharded = infeed.ShardedFeed(ctx.get_data_feed(), 8,
                                 preprocess=preprocess, device="cpu")

    mgr = checkpoint.CheckpointManager(
        os.path.join(os.getcwd(), "ckpt"),
        save_interval_steps=10000,    # only the forced save below fires
        async_save=True)
    evidence = {}
    progress = {"steps": 0}
    orig_write = mgr._write_files

    def slow_write(*a, **kw):
        time.sleep(SAVE_LATENCY_SECS)
        result = orig_write(*a, **kw)
        # Worker thread: how far training got while the write was in flight.
        evidence["steps_when_save_landed"] = progress["steps"]
        return result

    mgr._write_files = slow_write

    def on_steps(steps_done):
        progress["steps"] = steps_done
        if steps_done >= 4 and "request_step" not in evidence:
            t0 = time.perf_counter()
            accepted = mgr.maybe_save(steps_done, trainer.state, force=True)
            evidence["request_step"] = steps_done
            evidence["request_secs"] = time.perf_counter() - t0
            evidence["accepted"] = bool(accepted)
            # Raw view of the committed steps, no drain: must still be
            # empty (async).
            evidence["landed_at_request"] = mgr._latest_saved()

    stats = trainer.fit_feed(sharded, on_steps=on_steps)
    mgr.wait_until_finished()
    evidence["final_latest"] = mgr.latest_step()
    evidence["final_steps"] = progress["steps"]
    evidence["overlap"] = stats.get("overlap", {})
    mgr.close()
    with open("overlap.json", "w") as f:
        json.dump(evidence, f)
    # Keep the registered counter sources alive across a few heartbeats so
    # the driver's telemetry aggregate latches the final tallies (leg 3).
    time.sleep(1.5)


def main():
    from tensorflowonspark_torch import backend, cluster
    from tensorflowonspark_torch.cluster import InputMode

    tdir = os.path.join(tempfile.mkdtemp(prefix="tfos-overlap-"), "t")
    b = backend.LocalBackend(2)
    try:
        c = cluster.run(b, _node_fn, tf_args=[], num_executors=2,
                        input_mode=InputMode.SPARK,
                        heartbeat_interval=0.5,
                        heartbeat_misses=HEARTBEAT_MISSES,
                        telemetry=True, telemetry_dir=tdir)
        c.train(backend.partition(range(256), 2))
        c.shutdown(grace_secs=3)
        assert "error" not in c.tf_status, c.tf_status["error"]

        # Legs 1+2: per-executor evidence files.  The run completing at all
        # under TFOS_TRANSFER_GUARD=disallow is the device-residency proof;
        # the recorded timings are the async-save proof.
        for i in (0, 1):
            path = os.path.join(b.workdir_root,
                                "executor-{}".format(i), "overlap.json")
            assert os.path.exists(path), \
                "executor {} wrote no overlap evidence (transfer guard " \
                "trip or crash?)".format(i)
            with open(path) as f:
                ev = json.load(f)
            assert ev.get("accepted"), "save request rejected: {}".format(ev)
            assert ev["request_secs"] < FAST_RETURN_SECS, \
                "maybe_save blocked {:.3f}s (>= {}s): not async".format(
                    ev["request_secs"], FAST_RETURN_SECS)
            assert ev["landed_at_request"] is None, \
                "save already landed when maybe_save returned: {}".format(ev)
            assert ev["final_latest"] == ev["request_step"], \
                "wait_until_finished did not flush the save: {}".format(ev)
            assert ev.get("steps_when_save_landed", 0) >= \
                ev["request_step"], \
                "no training progress while save in flight: {}".format(ev)
            ov = ev.get("overlap", {})
            assert ov.get("dispatch_count", 0) >= 2, \
                "too few dispatches recorded: {}".format(ov)
            assert ov.get("dispatch_gap_us", 0) > 0, \
                "dispatch_gap_us not measured: {}".format(ov)
            assert ov.get("infeed_batches", 0) > 0, \
                "infeed_batches not measured: {}".format(ov)
            assert ov.get("infeed_put_us", 0) > 0, \
                "infeed_put_us not measured: {}".format(ov)

        # Leg 3a: counters rode heartbeats into the driver aggregate.
        tele = c.tf_status.get("telemetry")
        assert tele and tele.get("nodes"), \
            "tf_status['telemetry'] missing or empty: {}".format(tele)
        agg = tele["aggregate"]
        for key in ("dispatch_count", "dispatch_gap_us",
                    "infeed_batches", "infeed_put_us"):
            assert agg.get(key, 0) > 0, \
                "aggregate {} not positive: {}".format(key, agg)

        # Leg 3b: the overlap span vocabulary is in the trace files.
        names = set()
        for path in sorted(glob.glob(os.path.join(tdir, "trace-*.json"))):
            with open(path) as f:
                doc = json.load(f)
            names.update(e.get("name")
                         for e in doc.get("traceEvents") or [])
        missing = [n for n in REQUIRED_EVENTS if n not in names]
        assert not missing, \
            "trace files missing overlap events {}; saw {}".format(
                missing, sorted(n for n in names if n))

        print("overlap OK: guard-clean dispatches, async save returned "
              "<{:.2f}s with {:.1f}s write in flight, aggregate "
              "dispatch_gap_us={} infeed_put_us={}".format(
                  FAST_RETURN_SECS, SAVE_LATENCY_SECS,
                  agg["dispatch_gap_us"], agg["infeed_put_us"]))
        return 0
    finally:
        b.stop()


if __name__ == "__main__":
    sys.exit(main())
