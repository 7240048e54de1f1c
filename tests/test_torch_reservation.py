"""The JAX package's rendezvous tests (``tests/test_reservation.py``), re-pointed
at the port's copy of ``reservation``."""

import os
import threading
import time
from unittest import mock

import pytest

from tensorflowonspark_torch import reservation


def test_reservations_counting():
    r = reservation.Reservations(3)
    assert not r.done()
    assert r.remaining() == 3
    r.add({"node": 1})
    r.add({"node": 2})
    assert not r.done()
    assert r.remaining() == 1
    r.add({"node": 3})
    assert r.done()
    assert len(r.get()) == 3


def test_reservations_wait_timeout():
    r = reservation.Reservations(1)
    assert not r.wait(timeout=0.2)
    r.add({"node": 1})
    assert r.wait(timeout=0.2)


def test_single_client_register_await():
    server = reservation.Server(1)
    addr = server.start()
    client = reservation.Client(addr)
    meta = {"executor_id": 0, "host": "127.0.0.1", "job_name": "worker",
            "task_index": 0, "port": 2222}
    client.register(meta)
    info = client.await_reservations(timeout=10)
    assert info == [meta]
    assert server.reservations.done()
    client.close()
    server.stop()


def test_query_before_complete():
    server = reservation.Server(2)
    addr = server.start()
    client = reservation.Client(addr)
    assert client.get_reservations() is None  # roster incomplete
    client.register({"executor_id": 0})
    client.register({"executor_id": 1})  # same socket, second node's worth
    assert len(client.get_reservations()) == 2
    client.close()
    server.stop()


def test_env_overrides():
    # Reference test_reservation.py:58-75 — the only env mocking in the suite.
    with mock.patch.dict(os.environ, {reservation.TFOS_SERVER_HOST: "127.0.0.1"}):
        server = reservation.Server(1)
        addr = server.start()
        assert addr[0] == "127.0.0.1"
        server.stop()


def test_multi_client_threaded_rendezvous():
    """All clients block in await until the last registers (reference 77-110)."""
    num = 4
    server = reservation.Server(num)
    addr = server.start()
    results = [None] * num

    def _node(i):
        client = reservation.Client(addr)
        client.register({"executor_id": i, "job_name": "worker", "task_index": i})
        results[i] = client.await_reservations(timeout=15)
        client.close()

    threads = [threading.Thread(target=_node, args=(i,)) for i in range(num)]
    for i, t in enumerate(threads):
        t.start()
        if i == 0:
            time.sleep(0.3)  # stagger: first client parks in AWAIT
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive()
    for r in results:
        assert r is not None and len(r) == num
    server.stop()


def test_stop_flag():
    server = reservation.Server(1)
    addr = server.start()
    client = reservation.Client(addr)
    assert not server.done
    client.request_stop()
    assert server.done
    client.close()
    server.stop()


def test_server_survives_multiple_stops():
    """Feed tasks may each send STOP after terminate(); the listener must keep
    serving rather than deadlocking the second sender."""
    server = reservation.Server(1)
    addr = server.start()
    for _ in range(3):
        c = reservation.Client(addr)
        c.request_stop()
        c.close()
    assert server.done
    server.stop()


def test_await_timeout():
    server = reservation.Server(2)
    addr = server.start()
    client = reservation.Client(addr)
    client.register({"executor_id": 0})
    with pytest.raises(TimeoutError):
        client.await_reservations(timeout=1)
    client.close()
    server.stop()


def test_server_await_aborts_on_status_error():
    server = reservation.Server(2)
    server.start()
    with pytest.raises(Exception, match="boom"):
        server.await_reservations(status={"error": "boom"}, timeout=5)
    server.stop()


# ---------------------------------------------------------------------------
# registration validation (dedupe / overfill)
# ---------------------------------------------------------------------------

def test_duplicate_registration_rejected():
    """A speculatively re-run start task must get ERR, not a roster slot."""
    server = reservation.Server(2)
    addr = server.start()
    client = reservation.Client(addr)
    meta = {"executor_id": 0, "host": "h", "job_name": "worker",
            "task_index": 0}
    client.register(meta)
    with pytest.raises(Exception, match="duplicate registration"):
        client.register(dict(meta))
    assert server.reservations.remaining() == 1  # roster uncorrupted
    client.close()
    server.stop()


def test_registration_past_required_rejected():
    """A stale executor from a prior cluster must not over-fill the roster."""
    server = reservation.Server(1)
    addr = server.start()
    client = reservation.Client(addr)
    client.register({"executor_id": 0, "host": "h"})
    with pytest.raises(Exception, match="roster already has"):
        client.register({"executor_id": 9, "host": "h"})
    assert len(server.reservations.get()) == 1
    client.close()
    server.stop()


def test_query_still_answered_after_stop():
    """Late feed tasks QUERY/QINFO after streaming STOP; the listener must
    keep serving them, not treat `done` as shutdown."""
    server = reservation.Server(1)
    addr = server.start()
    c1 = reservation.Client(addr)
    c1.register({"executor_id": 0, "host": "h"})
    c1.request_stop()
    c1.close()
    assert server.done
    c2 = reservation.Client(addr)
    assert len(c2.get_reservations()) == 1
    resp = c2._request({"type": "QUERY"})
    assert resp == {"type": "QUERY", "done": True}
    c2.close()
    server.stop()


# ---------------------------------------------------------------------------
# heartbeat liveness
# ---------------------------------------------------------------------------

def _register_worker(client, executor_id=0):
    meta = {"executor_id": executor_id, "host": "hostA",
            "job_name": "worker", "task_index": executor_id}
    client.register(meta)
    return meta


def test_heartbeat_accepted_and_keeps_node_alive():
    server = reservation.Server(2, heartbeat_interval=0.2, heartbeat_misses=2)
    addr = server.start()
    client = reservation.Client(addr)
    _register_worker(client)
    deadline = time.time() + 1.2  # 3x the 0.4s missed-beat deadline
    while time.time() < deadline:
        assert client.heartbeat(0)
        time.sleep(0.1)
    assert server.dead_nodes() == {}
    client.close()
    server.stop()


def test_missed_beats_mark_node_dead_with_identity():
    server = reservation.Server(2, heartbeat_interval=0.2, heartbeat_misses=2)
    addr = server.start()
    client = reservation.Client(addr)
    _register_worker(client)  # registration seeds beat 0; then silence
    deadline = time.time() + 5
    while not server.dead_nodes() and time.time() < deadline:
        time.sleep(0.05)
    dead = server.dead_nodes()
    assert list(dead) == [0]
    # the driver-facing description names the node, not just a socket
    assert "worker:0" in dead[0] and "executor 0" in dead[0]
    assert "hostA" in dead[0] and "missed 2 heartbeats" in dead[0]
    client.close()
    server.stop()


def test_await_reservations_aborts_on_dead_node():
    """A roster that can never complete (a registrant died during bring-up)
    must fail the driver immediately with the dead node's identity, not
    burn the full rendezvous timeout."""
    server = reservation.Server(2, heartbeat_interval=0.2, heartbeat_misses=2)
    addr = server.start()
    client = reservation.Client(addr)
    _register_worker(client)  # 1 of 2 registered, then goes silent
    t0 = time.time()
    with pytest.raises(Exception, match="died during bring-up.*worker:0"):
        server.await_reservations(timeout=30)
    assert time.time() - t0 < 10  # aborted on death, not the 30s timeout
    client.close()
    server.stop()


def test_heartbeat_after_death_is_fenced():
    """A zombie (marked dead, then beats again) must get ERR so it stops
    computing rather than racing its replacement."""
    server = reservation.Server(2, heartbeat_interval=0.1, heartbeat_misses=2)
    addr = server.start()
    client = reservation.Client(addr)
    _register_worker(client)
    deadline = time.time() + 5
    while not server.dead_nodes() and time.time() < deadline:
        time.sleep(0.05)
    assert not client.heartbeat(0)  # fenced
    client.close()
    server.stop()


def test_bye_prevents_spurious_death():
    """A node that finishes cleanly sends BYE; its silence afterwards must
    not be declared a death."""
    server = reservation.Server(2, heartbeat_interval=0.1, heartbeat_misses=2)
    addr = server.start()
    client = reservation.Client(addr)
    _register_worker(client)
    client.goodbye(0)
    time.sleep(0.5)  # well past the 0.2s missed-beat deadline
    assert server.dead_nodes() == {}
    client.close()
    server.stop()


def test_heartbeat_sender_keeps_node_alive_then_bye():
    server = reservation.Server(2, heartbeat_interval=0.1, heartbeat_misses=3)
    addr = server.start()
    client = reservation.Client(addr)
    _register_worker(client)
    sender = reservation.HeartbeatSender(addr, 0, interval=0.1).start()
    time.sleep(1.0)  # 3x the deadline: only the sender keeps node 0 alive
    assert server.dead_nodes() == {}
    sender.stop()  # clean exit: BYE deregisters
    time.sleep(0.5)
    assert server.dead_nodes() == {}
    assert not sender.fenced
    client.close()
    server.stop()


def test_heartbeat_sender_dropped_beats_trigger_death(monkeypatch):
    """FaultInjector drop_heartbeats_after: the process lives but goes
    silent — exactly the partition/hang case the monitor must catch."""
    import json

    from tensorflowonspark_torch import fault

    monkeypatch.setenv(fault.FAULT_SPEC_ENV,
                       json.dumps({"drop_heartbeats_after": 1}))
    server = reservation.Server(2, heartbeat_interval=0.1, heartbeat_misses=3)
    addr = server.start()
    client = reservation.Client(addr)
    _register_worker(client)
    sender = reservation.HeartbeatSender(addr, 0, interval=0.1).start()
    deadline = time.time() + 5
    while not server.dead_nodes() and time.time() < deadline:
        time.sleep(0.05)
    assert 0 in server.dead_nodes()
    sender.stop(goodbye=False)
    client.close()
    server.stop()


def test_interval_zero_disables_monitoring():
    server = reservation.Server(2)  # heartbeat_interval defaults to 0
    addr = server.start()
    client = reservation.Client(addr)
    _register_worker(client)
    assert client.heartbeat(0)  # beats still accepted
    time.sleep(0.5)
    assert server.dead_nodes() == {}
    sender = reservation.HeartbeatSender(addr, 0, interval=0).start()
    assert not sender._thread.is_alive()  # no-op sender
    sender.stop()
    client.close()
    server.stop()


# ---------------------------------------------------------------------------
# connection hygiene
# ---------------------------------------------------------------------------

def test_parked_await_pruned_on_disconnect():
    """An AWAIT long-poller whose peer died must be dropped from the parked
    list (fd leak + send-to-dead-socket at roster completion otherwise)."""
    server = reservation.Server(2)
    addr = server.start()
    waiter = reservation.Client(addr)
    waiter.send(waiter._sock, {"type": "AWAIT"})  # park without blocking
    deadline = time.time() + 5
    while not server._parked and time.time() < deadline:
        time.sleep(0.05)
    assert len(server._parked) == 1
    waiter.close()  # peer disconnects while parked
    deadline = time.time() + 5
    while server._parked and time.time() < deadline:
        time.sleep(0.05)
    assert not server._parked
    server.stop()


def test_client_request_times_out_with_clear_error():
    """A server process that accepted the connection then wedged (or died
    behind NAT) must fail the request with a finite, descriptive timeout —
    not block the executor forever."""
    import socket as socket_mod
    import threading

    wedge = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_STREAM)
    wedge.bind(("127.0.0.1", 0))
    wedge.listen(1)
    addr = wedge.getsockname()
    held = []
    t = threading.Thread(  # accept, read nothing, answer nothing
        target=lambda: held.append(wedge.accept()), daemon=True)
    t.start()
    try:
        client = reservation.Client(addr, request_timeout=0.5)
        with pytest.raises(TimeoutError, match="did not answer a QINFO "
                                               "request within 0.5s"):
            client.get_reservations()
        client.close()
    finally:
        wedge.close()
    assert reservation.DEFAULT_REQUEST_TIMEOUT == 30.0  # finite by default


# ---------------------------------------------------------------------------
# elastic recovery: slot reclamation, generations, replacement admission
# ---------------------------------------------------------------------------

def test_release_and_replacement_bumps_generation():
    """Releasing a fenced node's slot lets a FRESH executor id claim the
    same role; admission bumps the roster generation."""
    server = reservation.Server(2)
    addr = server.start()
    client = reservation.Client(addr)
    client.register({"executor_id": 0, "host": "h", "job_name": "worker",
                     "task_index": 0})
    client.register({"executor_id": 1, "host": "h", "job_name": "worker",
                     "task_index": 1})
    assert server.reservations.generation == 0
    released = server.release_slot(0)
    assert released["job_name"] == "worker" and released["task_index"] == 0
    assert not server.reservations.done()
    assert server.reservations.released_slots() == [("worker", 0)]
    client.register({"executor_id": 7, "host": "h2", "job_name": "worker",
                     "task_index": 0})  # replacement, fresh identity
    assert server.reservations.done()
    assert server.reservations.generation == 1
    assert client.get_generation() == 1
    roles = sorted((m["executor_id"], m["task_index"])
                   for m in server.reservations.get())
    assert roles == [(1, 1), (7, 0)]
    client.close()
    server.stop()


def test_release_unknown_executor_is_noop():
    server = reservation.Server(1)
    server.start()
    assert server.release_slot(42) is None
    assert server.reservations.generation == 0
    server.stop()


def test_fenced_executor_id_cannot_reregister():
    """The zombie fence extends to REG: the dead id must not reclaim its own
    released slot — only a fresh identity may."""
    server = reservation.Server(2, heartbeat_interval=0.1, heartbeat_misses=2)
    addr = server.start()
    client = reservation.Client(addr)
    client.register({"executor_id": 0, "host": "h", "job_name": "worker",
                     "task_index": 0})
    deadline = time.time() + 5
    while not server.dead_nodes() and time.time() < deadline:
        time.sleep(0.05)
    server.release_slot(0)
    with pytest.raises(Exception, match="fenced by the liveness monitor"):
        client.register({"executor_id": 0, "host": "h", "job_name": "worker",
                         "task_index": 0})
    client.register({"executor_id": 5, "host": "h", "job_name": "worker",
                     "task_index": 0})  # fresh identity: admitted
    assert server.reservations.generation == 1
    client.close()
    server.stop()


def test_await_survives_recovered_death():
    """await_reservations must NOT abort on a death whose slot was released
    for elastic replacement — only unrecovered deaths abort bring-up."""
    server = reservation.Server(2, heartbeat_interval=0.1, heartbeat_misses=2)
    addr = server.start()
    client = reservation.Client(addr)
    client.register({"executor_id": 0, "host": "h", "job_name": "worker",
                     "task_index": 0})
    deadline = time.time() + 5
    while not server.dead_nodes() and time.time() < deadline:
        time.sleep(0.05)
    server.release_slot(0)

    def _replace():
        time.sleep(0.3)
        c = reservation.Client(addr)
        c.register({"executor_id": 9, "host": "h", "job_name": "worker",
                    "task_index": 0})
        c.register({"executor_id": 1, "host": "h", "job_name": "worker",
                    "task_index": 1})
        c.close()

    t = threading.Thread(target=_replace, daemon=True)
    t.start()
    info = server.await_reservations(timeout=10)
    assert len(info) == 2
    t.join(timeout=5)
    client.close()
    server.stop()


def test_await_generation_blocks_until_replacement():
    """Client AWAIT with a target generation parks past roster completion
    until a replacement admission bumps the generation."""
    server = reservation.Server(1)
    addr = server.start()
    client = reservation.Client(addr)
    client.register({"executor_id": 0, "host": "h", "job_name": "worker",
                     "task_index": 0})
    results = []

    def _wait_gen1():
        c = reservation.Client(addr)
        results.append(c.await_reservations(timeout=10, generation=1))
        c.close()

    t = threading.Thread(target=_wait_gen1, daemon=True)
    t.start()
    time.sleep(0.4)
    assert not results  # roster done, but generation 0 < 1: still parked
    server.release_slot(0)
    client.register({"executor_id": 3, "host": "h", "job_name": "worker",
                     "task_index": 0})
    t.join(timeout=10)
    assert not t.is_alive()
    assert results and results[0][0]["executor_id"] == 3
    client.close()
    server.stop()


def test_bye_reason_recorded_and_surfaced():
    server = reservation.Server(2, heartbeat_interval=0.1, heartbeat_misses=2)
    addr = server.start()
    reasons = {}
    server.on_bye = lambda ex, reason: reasons.update({ex: reason})
    client = reservation.Client(addr)
    client.register({"executor_id": 0, "host": "h", "job_name": "worker",
                     "task_index": 0})
    client.register({"executor_id": 1, "host": "h", "job_name": "worker",
                     "task_index": 1})
    client.goodbye(0, reason="preempted")
    client.goodbye(1)  # plain BYE: deregisters but records no reason
    assert server.bye_reasons() == {0: "preempted"}
    assert reasons == {0: "preempted"}
    time.sleep(0.5)
    assert server.dead_nodes() == {}  # preempted exit is NOT a death
    client.close()
    server.stop()


def test_heartbeat_sender_stop_reason():
    server = reservation.Server(1, heartbeat_interval=0.1, heartbeat_misses=3)
    addr = server.start()
    client = reservation.Client(addr)
    client.register({"executor_id": 0, "host": "h", "job_name": "worker",
                     "task_index": 0})
    sender = reservation.HeartbeatSender(addr, 0, interval=0.1).start()
    time.sleep(0.3)
    sender.stop(reason="preempted")
    assert server.bye_reasons() == {0: "preempted"}
    client.close()
    server.stop()


def test_metrics_latch_is_keywise_not_wholesale():
    """A later HBEAT/BYE payload that LOST a metrics source (the feed or
    trainer was garbage collected with the user fn) must not erase the
    counters earlier beats already reported — the latch folds key-wise,
    newest value per key wins."""
    server = reservation.Server(2, heartbeat_interval=0.2,
                                heartbeat_misses=50)
    addr = server.start()
    client = reservation.Client(addr)
    _register_worker(client)
    assert client.heartbeat(0, metrics={"feed_items": 10,
                                        "infeed_batches": 4})
    assert client.heartbeat(0, metrics={"feed_items": 25})  # source GC'd
    node = server.metrics_snapshot()["nodes"]["0"]
    assert node == {"feed_items": 25, "infeed_batches": 4}
    # the final BYE snapshot folds the same way
    client.goodbye(0, reason="done", metrics={"feed_items": 30})
    snap = server.metrics_snapshot()
    assert snap["nodes"]["0"] == {"feed_items": 30, "infeed_batches": 4}
    assert snap["aggregate"]["infeed_batches"] == 4
    client.close()
    server.stop()
