"""CLI entry for a standalone (or standby) reservation coordinator.

The port's copy of :mod:`tensorflowonspark_tpu.reservation_server`.

Runs one :class:`~tensorflowonspark_torch.reservation.Server` until
SIGTERM / Ctrl-C.  With ``--journal-dir`` every ledger mutation (REG,
slot release, fence, BYE, knob push, STOP) is journaled and a restarted
coordinator — same ``--port``, same ``--journal-dir`` — recovers the
roster, generations, released slots, latched metrics and knob state
before accepting connections, under a fencing epoch that locks any
earlier incarnation out of the ledger.

With ``--standby`` the process does NOT serve immediately: it arms a
:class:`~tensorflowonspark_torch.standby.WarmStandby` that tails the
primary's beacon in the journal dir and promotes itself — recovering the
ledger and fencing the (possibly zombie) primary — once the beacon goes
silent past ``--takeover-after`` seconds.  Give the standby a pinned
``--port`` and list it after the primary in every client's endpoint list
(``reservation.Client([(h, p_primary), (h, p_standby)])``) so nodes
re-home by simply redialing.

Usage::

    python -m tensorflowonspark_torch.reservation_server \\
        --count N [--host H] [--port P] [--heartbeat SECS] [--misses N] \\
        [--journal-dir DIR] [--snapshot-every N] \\
        [--journal-keep N | --journal-keep-bytes N] \\
        [--standby] [--takeover-after SECS] [--poll SECS] \\
        [--takeover-grace SECS]

Env fallbacks (flags win): ``TFOS_RS_JOURNAL_DIR``,
``TFOS_RS_SNAPSHOT_EVERY``, ``TFOS_RS_JOURNAL_KEEP``,
``TFOS_RS_JOURNAL_KEEP_BYTES`` — the same shape as the dispatcher CLI.
"""

import argparse
import logging
import signal
import sys
import threading


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="tensorflowonspark_torch reservation coordinator")
    parser.add_argument("--count", type=int, required=True,
                        help="required number of node reservations")
    parser.add_argument("--host", default=None,
                        help="advertise host (default: auto-detected)")
    parser.add_argument("--port", type=int, default=None,
                        help="listen port (default: ephemeral; pin it so a "
                             "restarted or promoted coordinator keeps a "
                             "pre-agreed address)")
    parser.add_argument("--heartbeat", type=float, default=0.0,
                        help="node heartbeat interval seconds (0 disables "
                             "liveness monitoring)")
    parser.add_argument("--misses", type=int, default=3,
                        help="missed heartbeats before fencing a node")
    parser.add_argument("--journal-dir", default=None,
                        help="journal ledger mutations under this dir "
                             "(default: TFOS_RS_JOURNAL_DIR env; unset "
                             "disables durability AND standby mode)")
    parser.add_argument("--snapshot-every", type=int, default=None,
                        help="journal records between full snapshots "
                             "(default: TFOS_RS_SNAPSHOT_EVERY env, 256)")
    parser.add_argument("--journal-keep", type=int, default=None,
                        help="snapshot generations kept after compaction "
                             "(default: TFOS_RS_JOURNAL_KEEP env, 2)")
    parser.add_argument("--journal-keep-bytes", type=int, default=None,
                        help="byte budget for retired generations instead "
                             "of a count; the newest generation is always "
                             "kept (default: TFOS_RS_JOURNAL_KEEP_BYTES "
                             "env, 0 = use --journal-keep)")
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
                        help="seconds after a recovery during which node "
                             "liveness fencing is suppressed (default: "
                             "heartbeat × misses, at least 2s)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    from tensorflowonspark_torch import fault, reservation, standby, telemetry

    tracer = telemetry.configure_from_meta({})
    telemetry.install_sigusr1()

    if args.standby and not args.journal_dir:
        parser.error("--standby requires --journal-dir (the standby tails "
                     "the primary's beacon and recovers its ledger there)")

    def build():
        return reservation.Server(
            args.count, heartbeat_interval=args.heartbeat,
            heartbeat_misses=args.misses, host=args.host, port=args.port,
            journal_dir=args.journal_dir,
            snapshot_every=args.snapshot_every,
            journal_keep=args.journal_keep,
            journal_keep_bytes=args.journal_keep_bytes,
            takeover_grace=args.takeover_grace)

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: done.set())

    watcher = None
    server = None
    if args.standby:
        def announce(promoted, addr):
            # The chaos gate (and operators) key off this line.
            print("reservation server promoted on {}:{} epoch={}".format(
                addr[0], addr[1], promoted.fencing_epoch), flush=True)
            fault.from_env().arm_coordinator_kill("reservation")

        watcher = standby.WarmStandby(
            build, args.journal_dir, takeover_after=args.takeover_after,
            poll_interval=args.poll, on_promote=announce,
            name="reservation").start()
        print("reservation standby armed on {} (takeover after {:.1f}s)"
              .format(args.journal_dir, args.takeover_after), flush=True)
    else:
        server = build()
        host, port = server.start()
        print("reservation server ready on {}:{} epoch={}".format(
            host, port, server.fencing_epoch), flush=True)
        # Chaos scripting: a TFOS_FAULT_SPEC with kill_coordinator_after_secs
        # SIGKILLs this process on schedule, like node faults kill nodes.
        fault.from_env().arm_coordinator_kill("reservation")

    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    if watcher is not None:
        watcher.stop()
        if watcher.server is not None:
            watcher.server.stop()
    if server is not None:
        server.stop()
    tracer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
