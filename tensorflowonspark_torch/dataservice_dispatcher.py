"""CLI entry for a standalone data-service dispatcher process.

The port's copy of :mod:`tensorflowonspark_tpu.dataservice_dispatcher`.

Runs one :class:`~tensorflowonspark_torch.dataservice.DispatcherServer`
until SIGTERM / Ctrl-C.  With ``--journal-dir`` the split ledger is
journaled (JSONL mutations + periodic snapshots) and a restarted
dispatcher — same ``--port``, same ``--journal-dir`` — recovers every
job's ledger before accepting connections, so SIGKILLing this process is
survivable: workers re-register off the heartbeat ``reregister`` hint,
consumers reconnect lazily, and in-flight splits resume exactly-once.

Usage::

    python -m tensorflowonspark_torch.dataservice_dispatcher \\
        [--host H] [--port P] [--heartbeat SECS] [--misses N] \\
        [--journal-dir DIR] [--snapshot-every N] \\
        [--journal-keep N | --journal-keep-bytes N] \\
        [--affinity | --no-affinity]

Env fallbacks (flags win): ``TFOS_DS_JOURNAL_DIR``,
``TFOS_DS_SNAPSHOT_EVERY``, ``TFOS_DS_JOURNAL_KEEP``,
``TFOS_DS_JOURNAL_KEEP_BYTES``, ``TFOS_DS_AFFINITY`` — the same shape as
the worker CLI's ``TFOS_DS_CACHE_BYTES``.
"""

import argparse
import logging
import signal
import sys
import threading


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="tensorflowonspark_torch data-service dispatcher")
    parser.add_argument("--host", default=None,
                        help="advertise host (default: auto-detected)")
    parser.add_argument("--port", type=int, default=0,
                        help="listen port (default: ephemeral; pin it so a "
                             "restarted dispatcher keeps its address)")
    parser.add_argument("--heartbeat", type=float, default=1.0,
                        help="worker heartbeat interval seconds")
    parser.add_argument("--misses", type=int, default=3,
                        help="missed heartbeats before fencing")
    parser.add_argument("--journal-dir", default=None,
                        help="journal ledger mutations under this dir "
                             "(default: TFOS_DS_JOURNAL_DIR env; unset "
                             "disables durability)")
    parser.add_argument("--snapshot-every", type=int, default=None,
                        help="journal records between full snapshots "
                             "(default: TFOS_DS_SNAPSHOT_EVERY env, 512)")
    parser.add_argument("--journal-keep", type=int, default=None,
                        help="snapshot generations kept after compaction "
                             "(default: TFOS_DS_JOURNAL_KEEP env, 2)")
    parser.add_argument("--journal-keep-bytes", type=int, default=None,
                        help="byte budget for retired generations instead "
                             "of a count; the newest generation is always "
                             "kept (default: TFOS_DS_JOURNAL_KEEP_BYTES "
                             "env, 0 = use --journal-keep)")
    parser.add_argument("--affinity", dest="affinity", action="store_true",
                        default=None,
                        help="cache-affinity DYNAMIC scheduling (default: "
                             "TFOS_DS_AFFINITY env, on)")
    parser.add_argument("--no-affinity", dest="affinity",
                        action="store_false",
                        help="plain FCFS DYNAMIC scheduling")
    parser.add_argument("--standby", action="store_true",
                        help="arm as a warm standby: tail the primary's "
                             "beacon in --journal-dir and promote when it "
                             "goes silent past --takeover-after")
    parser.add_argument("--takeover-after", type=float, default=2.0,
                        help="beacon silence (seconds) before a standby "
                             "promotes itself")
    parser.add_argument("--poll", type=float, default=0.2,
                        help="standby beacon poll interval seconds")
    parser.add_argument("--takeover-grace", type=float, default=None,
                        help="seconds after a recovery during which worker/"
                             "consumer fencing is suppressed (default: "
                             "heartbeat × misses, at least 2s)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    from tensorflowonspark_torch import dataservice, fault, standby, telemetry

    tracer = telemetry.configure_from_meta({})
    telemetry.install_sigusr1()

    if args.standby and not args.journal_dir:
        parser.error("--standby requires --journal-dir (the standby tails "
                     "the primary's beacon and recovers its ledger there)")

    def build():
        return dataservice.DispatcherServer(
            heartbeat_interval=args.heartbeat, heartbeat_misses=args.misses,
            host=args.host, port=args.port, journal_dir=args.journal_dir,
            snapshot_every=args.snapshot_every, affinity=args.affinity,
            journal_keep=args.journal_keep,
            journal_keep_bytes=args.journal_keep_bytes,
            takeover_grace=args.takeover_grace)

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: done.set())

    watcher = None
    dispatcher = None
    if args.standby:
        def announce(promoted, addr):
            print("dispatcher promoted on {}:{} epoch={}".format(
                addr[0], addr[1], promoted.fencing_epoch), flush=True)
            fault.from_env().arm_coordinator_kill("dispatcher")

        watcher = standby.WarmStandby(
            build, args.journal_dir, takeover_after=args.takeover_after,
            poll_interval=args.poll, on_promote=announce,
            name="dispatcher").start()
        print("dispatcher standby armed on {} (takeover after {:.1f}s)"
              .format(args.journal_dir, args.takeover_after), flush=True)
    else:
        dispatcher = build()
        host, port = dispatcher.start()
        print("dispatcher ready on {}:{}".format(host, port), flush=True)
        # Chaos scripting: kill_coordinator_after_secs in TFOS_FAULT_SPEC
        # SIGKILLs this process on schedule, like node faults kill nodes.
        fault.from_env().arm_coordinator_kill("dispatcher")

    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    if watcher is not None:
        watcher.stop()
        if watcher.server is not None:
            watcher.server.stop()
    if dispatcher is not None:
        dispatcher.stop()
    tracer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
