"""CI gate of the port's coordinator HA (the twin of
``scripts/ci_assert_ha.py``, on ``tensorflowonspark_torch``; it imports
no jax): no single process death ends the run.

Port modules driven: ``python -m tensorflowonspark_torch.reservation_server``
as primary and ``--standby`` (``standby.py``: the beacon watch, promotion
and epoch fencing), ``reservation.Client`` over an endpoint list and
``reservation.HeartbeatSender``.  The coordinator runs no kernel, and no
card phase runs a standby: on the card every ``chip_smoke.py`` cluster
phase (``cluster``, ``control``, ``warmstart``) registers through the
same ``reservation.Server``.

Boots the REAL coordinator entrypoints as subprocesses: a journal-armed
primary reservation server (``python -m
tensorflowonspark_torch.reservation_server``) plus a warm standby tailing
the same journal dir at a pinned second port.  Two in-process nodes
register through the endpoint list, heartbeat with live item counters,
and keep producing items while the gate murders the control plane:

1. SIGSTOP the primary mid-run — a stall, the nastier death: the kernel
   keeps completing TCP handshakes for it, so clients cannot tell it from
   a slow server until their request times out,
2. the standby's beacon watch fires and it promotes itself: bumps the
   fencing epoch, recovers the full roster from the journal, and serves
   at its pinned port — nodes re-home via endpoint-list redial,
3. SIGCONT the primary: it is now a ZOMBIE — the gate asserts a direct
   request to it is answered with a structured superseded-by-epoch
   rejection (ledger writes fenced), then SIGKILLs it,
4. both nodes finish and BYE with final counters; the gate asserts EXACT
   item totals on the successor, a fully recovered roster, and that no
   healthy node was false-fenced during the takeover grace window.

Budget: the whole run must finish inside 15 s.

    python scripts/ci_assert_torch_ha.py

Exit 0 = a coordinator SIGKILL is survivable end to end.
"""

import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUDGET_SECS = 15.0
N_NODES = 2
ITEMS_PER_NODE = 60
ITEM_SECS = 0.1          # per-item work: ~6s of run, spanning the failover
HEARTBEAT = 0.25
MISSES = 4
TAKEOVER_AFTER = 1.0
GRACE = 5.0


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(extra, lines, name):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_torch.reservation_server",
         "--count", str(N_NODES), "--host", "127.0.0.1",
         "--heartbeat", str(HEARTBEAT), "--misses", str(MISSES),
         "--takeover-grace", str(GRACE)] + extra,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)

    def _tail():
        for line in proc.stdout:
            lines.append(line.strip())

    threading.Thread(target=_tail, name="tail-" + name, daemon=True).start()
    return proc


def _await_line(lines, needle, deadline, what):
    while time.time() < deadline:
        if any(needle in line for line in lines):
            return
        time.sleep(0.05)
    raise AssertionError("{}: never saw {!r} (got {})".format(
        what, needle, lines))


def main():
    from tensorflowonspark_torch import reservation

    jdir = tempfile.mkdtemp(prefix="ci_ha_")
    p1, p2 = _free_port(), _free_port()
    endpoints = [("127.0.0.1", p1), ("127.0.0.1", p2)]
    t0 = time.time()
    deadline = t0 + BUDGET_SECS

    primary_lines, standby_lines = [], []
    primary = _spawn(["--port", str(p1), "--journal-dir", jdir],
                     primary_lines, "primary")
    standby = _spawn(["--port", str(p2), "--journal-dir", jdir,
                      "--standby", "--takeover-after", str(TAKEOVER_AFTER),
                      "--poll", "0.1"], standby_lines, "standby")
    items = [0] * N_NODES
    senders = []
    try:
        _await_line(primary_lines, "reservation server ready", deadline,
                    "primary")
        _await_line(standby_lines, "standby armed", deadline, "standby")

        def node(i):
            client = reservation.Client(endpoints, retries=3,
                                        retry_delay=0.1)
            client.register({"executor_id": i, "host": "127.0.0.1",
                             "job_name": "worker", "task_index": i,
                             "port": 7000 + i})
            sender = reservation.HeartbeatSender(
                endpoints, i, HEARTBEAT,
                metrics_provider=lambda: {"items": items[i]}).start()
            senders.append(sender)
            client.await_reservations(timeout=BUDGET_SECS)
            client.close()
            for _ in range(ITEMS_PER_NODE):
                time.sleep(ITEM_SECS)
                items[i] += 1
            sender.stop(goodbye=True, reason="done")
            assert not sender.fenced, \
                "node {} was false-fenced during the failover".format(i)

        threads = [threading.Thread(target=node, args=(i,), daemon=True)
                   for i in range(N_NODES)]
        for t in threads:
            t.start()

        # Let the run get going, then stall the primary mid-run.
        while sum(items) < 5:
            assert time.time() < deadline, "nodes never started producing"
            time.sleep(0.05)
        os.kill(primary.pid, signal.SIGSTOP)
        stalled_at = time.time()

        _await_line(standby_lines, "promoted", deadline,
                    "standby takeover")
        takeover_secs = time.time() - stalled_at

        for t in threads:
            t.join(timeout=max(0.5, deadline - time.time()))
        assert all(not t.is_alive() for t in threads), \
            "nodes did not finish within {}s".format(BUDGET_SECS)

        # Wake the zombie: its very next mutating request must observe the
        # successor's epoch on disk and answer a STRUCTURED rejection —
        # the ledger write path is fenced, not interleaved.
        os.kill(primary.pid, signal.SIGCONT)
        zombie = reservation.Client(("127.0.0.1", p1), retries=1,
                                    retry_delay=0.1)
        try:
            zombie.heartbeat(0)
            raise AssertionError("zombie primary accepted a write after "
                                 "the standby claimed the ledger")
        except ConnectionError as e:
            assert "superseded" in str(e), e
        finally:
            zombie.close()
        os.kill(primary.pid, signal.SIGKILL)

        # Exact totals + recovered roster + no false fence, all read off
        # the promoted successor.
        probe = reservation.Client(("127.0.0.1", p2), retries=1,
                                   retry_delay=0.1)
        st = probe.state()
        probe.close()
        assert st["ha"]["epoch"] >= 2, st["ha"]
        assert st["ha"]["recovered_nodes"] == N_NODES, st["ha"]
        assert st["registered"] == N_NODES, st
        assert st["dead"] == {}, \
            "healthy node false-fenced during grace: {}".format(st["dead"])
        assert len(st["byes"]) == N_NODES, st
        expect = N_NODES * ITEMS_PER_NODE
        assert st["metrics"].get("items") == expect, \
            "item totals wrong across the failover: {} vs {}".format(
                st["metrics"].get("items"), expect)
        elapsed = time.time() - t0
        assert elapsed < BUDGET_SECS, \
            "budget blown: {:.1f}s".format(elapsed)
        print("coordinator HA OK: primary stalled mid-run, standby "
              "promoted in {:.1f}s (epoch {}), zombie write rejected by "
              "epoch, {} items exactly once over {} nodes, no false "
              "fences, in {:.1f}s".format(
                  takeover_secs, st["ha"]["epoch"], expect, N_NODES,
                  elapsed))
        return 0
    finally:
        for sender in senders:
            sender._stop.set()
        for proc in (primary, standby):
            if proc.poll() is None:
                try:
                    os.kill(proc.pid, signal.SIGCONT)
                except OSError:
                    pass
                proc.kill()
                proc.wait(timeout=5)


if __name__ == "__main__":
    sys.exit(main())
