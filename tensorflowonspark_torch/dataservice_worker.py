"""CLI entry for a data-service feed worker process.

The port's copy of :mod:`tensorflowonspark_tpu.dataservice_worker`.

Runs one :class:`~tensorflowonspark_torch.dataservice.FeedWorker` until
SIGTERM / Ctrl-C, then deregisters cleanly (``BYE``).  Chaos specs ride the
usual ``TFOS_FAULT_SPEC`` environment variable (e.g.
``{"kill_after_splits": 2}`` for the CI worker-kill gate).

Usage::

    python -m tensorflowonspark_torch.dataservice_worker \\
        --dispatcher HOST:PORT [--reader jsonl|tfrecord] [--host H] \\
        [--port P] [--worker-id ID] [--heartbeat SECS] [--process-pool] \\
        [--cache-bytes N] [--cache-spill-dir DIR] [--no-cache-advertise] \\
        [--fields NAME,NAME,...]

``--fields`` (the port's own option) serves each record as a tuple of
those features in that order.  A TFRecord record parses to a dict row,
which the worker can only send pickled; a tuple row of arrays frames as
colv1 (zero-copy, compressible, cacheable in its wire form), and the
consumer reads it as columns in that order.

The standalone dispatcher lives in
:mod:`~tensorflowonspark_torch.dataservice_dispatcher` (journal + affinity
knobs are dispatcher-side).
"""

import argparse
import logging
import signal
import sys
import threading


class FieldRows(object):
    """Row reader adapter: ``reader(path)``'s dict rows as tuples of the
    ``names`` fields, in that order (picklable, so ``--process-pool``
    decoders get it too)."""

    def __init__(self, reader, names):
        self.reader = reader
        self.names = tuple(names)

    def __call__(self, path):
        for row in self.reader(path):
            yield tuple(row[name] for name in self.names)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="tensorflowonspark_torch data-service feed worker")
    parser.add_argument("--dispatcher", required=True,
                        help="dispatcher address, host:port")
    parser.add_argument("--reader", choices=("jsonl", "tfrecord"),
                        default="tfrecord",
                        help="row reader for split files (default: tfrecord)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="data-port bind/advertise host")
    parser.add_argument("--port", type=int, default=0,
                        help="data port (default: ephemeral)")
    parser.add_argument("--worker-id", default=None,
                        help="worker identity (default: generated)")
    parser.add_argument("--heartbeat", type=float, default=1.0,
                        help="heartbeat interval seconds")
    parser.add_argument("--process-pool", action="store_true",
                        help="read splits with ProcessPoolFeed")
    parser.add_argument("--cache-bytes", type=int, default=None,
                        help="chunk-cache byte budget (default: "
                             "TFOS_DS_CACHE_BYTES env, 0/unset disables); "
                             "a starting value only — the driver autopilot "
                             "can retune it live over the dispatcher "
                             "heartbeat (dataservice_cache_budget knob)")
    parser.add_argument("--cache-spill-dir", default=None,
                        help="spill LRU-evicted cache entries to this dir")
    parser.add_argument("--no-cache-advertise", dest="advertise_cache",
                        action="store_false", default=None,
                        help="do not advertise cached splits to the "
                             "dispatcher (disables cache-affinity "
                             "scheduling for this worker; default: "
                             "TFOS_DS_ADVERTISE env, on)")
    parser.add_argument("--fields", default=None,
                        help="comma-separated field names: serve each "
                             "record as a tuple of these fields in this "
                             "order (colv1-framed; dict rows go pickled)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    from tensorflowonspark_torch import data, dataservice, telemetry

    # Standalone workers opt into telemetry via TFOS_TELEMETRY /
    # TFOS_TELEMETRY_DIR (no cluster_meta hop reaches a CLI process), and
    # get the SIGUSR1 flight recorder either way the cluster shells do:
    # a hung worker can then be asked for stacks (`kill -USR1 <pid>`)
    # instead of diagnosed post-mortem.
    tracer = telemetry.configure_from_meta({})
    telemetry.install_sigusr1()

    row_reader = (data.jsonl_rows if args.reader == "jsonl"
                  else data.tfrecord_rows)
    if args.fields:
        row_reader = FieldRows(row_reader, [
            name.strip() for name in args.fields.split(",") if name.strip()])
    worker = dataservice.FeedWorker(
        args.dispatcher, row_reader=row_reader, host=args.host,
        port=args.port, worker_id=args.worker_id,
        heartbeat_interval=args.heartbeat,
        use_process_pool=args.process_pool,
        cache_bytes=args.cache_bytes,
        cache_spill_dir=args.cache_spill_dir,
        advertise_cache=args.advertise_cache)
    worker.start()
    print("worker {} ready on {}:{}".format(worker.worker_id, worker.host,
                                            worker.port), flush=True)

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: done.set())
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    worker.stop()
    tracer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
