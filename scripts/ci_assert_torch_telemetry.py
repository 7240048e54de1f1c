"""CI gate of the port's telemetry plane (the twin of
``scripts/ci_assert_telemetry.py``, on ``tensorflowonspark_torch``; it
imports no jax): the plane must produce a usable cluster timeline.

Port modules driven: ``telemetry`` (per-process Chrome traces, the
lifecycle span names of the JAX package), ``cluster``, ``reservation``,
``node``, ``datafeed`` and the heartbeat-carried counter aggregate in
``tf_status["telemetry"]``.  On the card the same plane is read in
``chip_smoke.py``'s ``observability`` and ``observability_cluster``
phases.

Boots a real 2-node in-process cluster on the built-in backend with
``telemetry=True``, feeds it, and asserts the three telemetry legs:

1. every process wrote a Chrome-trace JSON file that ``json.loads`` and
   carries ``traceEvents``,
2. the required lifecycle span names are present across the files
   (reservation await/register/admission, node bring-up, feed dispatch),
3. the driver latched a non-zero per-node feed-counter aggregate from the
   heartbeat stream into ``tf_status["telemetry"]``.

    python scripts/ci_assert_torch_telemetry.py

Exit 0 = the plane works; any assertion names the leg that broke.
"""

import glob
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: Span/instant names a healthy bring-up + feed + shutdown must emit
#: somewhere across the per-process trace files.
REQUIRED_EVENTS = (
    "cluster/start",
    "cluster/ready",
    "reservation/await",
    "reservation/register",
    "reservation/admission",
    "node/register",
    "node/await",
    "node/user_fn",
    "feed/partition",
)
# beats every 0.5 s, fenced after 8 misses (4 s): no check here reads
# the fence, and at the JAX gate's default of 3 a healthy node was fenced
# when its beat thread stalled 1.6 s on a loaded host (the user fn's
# process sends the beats while it imports torch and trains)
HEARTBEAT_MISSES = 8


def _node_fn(args, ctx):
    feed = ctx.get_data_feed()
    total = 0
    while not feed.should_stop():
        for x in feed.next_batch(2):
            total += x
    with open("sum.txt", "w") as f:
        f.write(str(total))


def main():
    from tensorflowonspark_torch import backend, cluster
    from tensorflowonspark_torch.cluster import InputMode

    tdir = os.path.join(tempfile.mkdtemp(prefix="tfos-telemetry-"), "t")
    b = backend.LocalBackend(2)
    try:
        c = cluster.run(b, _node_fn, tf_args=[], num_executors=2,
                        input_mode=InputMode.SPARK,
                        heartbeat_interval=0.5,
                        heartbeat_misses=HEARTBEAT_MISSES,
                        telemetry=True, telemetry_dir=tdir)
        c.train(backend.partition(range(20), 2))

        live = c.metrics_snapshot()
        assert isinstance(live, dict) and "nodes" in live, live

        c.shutdown(grace_secs=1)

        # Leg 1: every trace file is valid Chrome-trace JSON.
        traces = sorted(glob.glob(os.path.join(tdir, "trace-*.json")))
        assert traces, "no trace files written under {}".format(tdir)
        names = set()
        for path in traces:
            with open(path) as f:
                doc = json.load(f)  # raises on a torn/invalid file
            events = doc.get("traceEvents")
            assert isinstance(events, list) and events, \
                "{} has no traceEvents".format(path)
            names.update(e.get("name") for e in events)

        # Leg 2: the lifecycle vocabulary is present.
        missing = [n for n in REQUIRED_EVENTS if n not in names]
        assert not missing, \
            "trace files missing required events {}; saw {}".format(
                missing, sorted(n for n in names if n))

        # Leg 3: the HBEAT-carried counter aggregate reached tf_status.
        tele = c.tf_status.get("telemetry")
        assert tele and tele.get("nodes"), \
            "tf_status['telemetry'] missing or empty: {}".format(tele)
        agg = tele["aggregate"]
        assert agg.get("feed_items", 0) > 0, \
            "aggregate feed_items not positive: {}".format(agg)
        assert agg.get("feeder_items", 0) > 0, \
            "aggregate feeder_items not positive: {}".format(agg)

        print("telemetry OK: {} trace files, {} event names, aggregate "
              "feed_items={} feeder_items={}".format(
                  len(traces), len(names), agg["feed_items"],
                  agg["feeder_items"]))
        return 0
    finally:
        b.stop()


if __name__ == "__main__":
    sys.exit(main())
