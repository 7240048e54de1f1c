"""The port's data-service tests, re-pointed from ``tests/test_dataservice.py``
(its control plane, sharding modes, review fixes and transport parity) on
``tensorflowonspark_torch``: dispatcher ledger semantics, framed TCP
transport parity, exactly-once visitation under worker death, and the
ServiceFeed drop-in contract — all on localhost, CPU-only.

The wall-clock-sensitive tests carry the ``chaos`` marker's SIGALRM limit
so a broken recovery path fails with stacks instead of hanging the suite."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tensorflowonspark_torch import data, dataservice, wire
from tensorflowonspark_torch.dataservice import (
    SHARD_DYNAMIC, SHARD_OFF, SHARD_STATIC, DispatchError, DispatcherClient,
    DispatcherServer, FeedWorker, ServiceFeed)
from torch_dataservice_util import _Service, _drain, _write_jsonl


# ---------------------------------------------------------------------------
# Dispatcher control plane
# ---------------------------------------------------------------------------

def test_worker_registration_roster_and_bye():
    disp = DispatcherServer(heartbeat_interval=0, host="127.0.0.1")
    addr = disp.start()
    try:
        client = DispatcherClient(addr)
        client.register_worker("wa", "127.0.0.1", 1111)
        client.register_worker("wb", "127.0.0.1", 2222)
        roster = client.workers()
        assert [m["worker_id"] for m in roster] == ["wa", "wb"]
        assert roster[0]["port"] == 1111
        # duplicate live id is a configuration error, not a silent replace
        with pytest.raises(DispatchError, match="duplicate"):
            client.register_worker("wa", "127.0.0.1", 3333)
        # clean BYE (the HeartbeatSender wire shape) leaves the roster
        client.goodbye("wa")
        assert [m["worker_id"] for m in client.workers()] == ["wb"]
        client.close()
    finally:
        disp.stop()


def test_fenced_worker_is_rejected_and_splits_reassigned():
    """Liveness fence: a silent worker is declared dead, its identity is
    burned (no re-registration, no more TASKs), and its assigned splits
    re-pool bound to the same consumer."""
    disp = DispatcherServer(heartbeat_interval=0.1, heartbeat_misses=2,
                            host="127.0.0.1")
    addr = disp.start()
    try:
        client = DispatcherClient(addr)
        client.register_worker("wz", "127.0.0.1", 1111)
        client.register_job("j", ["s0", "s1"], mode=SHARD_DYNAMIC)
        task = client.request_task("j", "wz", "c0")
        assert task["splits"] == [[0, "s0"]]
        deadline = time.monotonic() + 5
        while "wz" not in disp.dead_workers():
            assert time.monotonic() < deadline, "worker never fenced"
            time.sleep(0.05)
        status = client.status("j")
        assert status["reassigned"] == 1 and status["pending"] == 1
        with pytest.raises(DispatchError, match="fresh identity"):
            client.register_worker("wz", "127.0.0.1", 1111)
        with pytest.raises(DispatchError, match="marked dead"):
            client.request_task("j", "wz", "c0")
        # a survivor picks the orphan up FOR THE SAME consumer...
        client.register_worker("wy", "127.0.0.1", 2222)
        assert client.request_task("j", "wy", "other")["splits"] == \
            [[1, "s1"]]  # ...so another consumer only gets fresh splits
        assert client.request_task("j", "wy", "c0")["splits"] == [[0, "s0"]]
        client.close()
    finally:
        disp.stop()


def test_job_registration_is_attach_or_create():
    disp = DispatcherServer(heartbeat_interval=0, host="127.0.0.1")
    addr = disp.start()
    try:
        client = DispatcherClient(addr)
        first = client.register_job("j", ["a", "b"], num_epochs=2,
                                    consumer_id="c0")
        assert first["created"] is True
        assert first["consumers"] == 1
        # same spec, second run: attaches instead of erroring
        second = client.register_job("j", ["a", "b"], num_epochs=2,
                                     consumer_id="c1")
        assert second["created"] is False
        assert second["consumers"] == 2
        assert second["spec"]["splits"] == ["a", "b"]
        # incompatible re-attach is a typed error
        with pytest.raises(DispatchError, match="different spec"):
            client.register_job("j", ["a", "b"], num_epochs=3)
        with pytest.raises(DispatchError, match="sharding mode"):
            client.register_job("k", ["a"], mode="bogus")
        # attach=True demands a live job; attach=False demands to be first
        with pytest.raises(DispatchError, match="nothing to attach"):
            client.register_job("nope", ["a"], attach=True)
        with pytest.raises(DispatchError, match="already exists"):
            client.register_job("j", ["a", "b"], num_epochs=2, attach=False)
        # attach=True without splits adopts the live job's spec
        adopted = client.register_job("j", consumer_id="c2", attach=True)
        assert adopted["spec"] == {"splits": ["a", "b"], "num_epochs": 2,
                                   "mode": "dynamic"}
        assert adopted["consumers"] == 3
        client.close()
    finally:
        disp.stop()


def test_done_split_is_idempotent_and_epochs_advance():
    disp = DispatcherServer(heartbeat_interval=0, host="127.0.0.1")
    addr = disp.start()
    try:
        client = DispatcherClient(addr)
        client.register_worker("w", "127.0.0.1", 1)
        client.register_job("j", ["s0"], num_epochs=2)
        assert client.request_task("j", "w", "c")["epoch"] == 0
        client.done_split("j", 0, 0, "c")
        client.done_split("j", 0, 0, "c")  # duplicate: harmless
        client.done_split("j", 5, 0, "c")  # stale epoch: harmless
        assert client.status("j")["epoch"] == 1
        assert client.request_task("j", "w", "c")["epoch"] == 1
        client.done_split("j", 1, 0, "c")
        assert client.status("j")["done"]
        assert client.request_task("j", "w", "c") == {"type": "TASK",
                                                      "done": True}
        client.close()
    finally:
        disp.stop()


# ---------------------------------------------------------------------------
# Sharding modes end to end
# ---------------------------------------------------------------------------

def test_off_mode_each_stream_delivers_full_dataset(tmp_path):
    splits, rows = _write_jsonl(tmp_path, 3, 10)
    with _Service(n_workers=2) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="off", mode=SHARD_OFF,
                           min_workers=2, timeout=20.0)
        try:
            got = _drain(feed)
            # W workers × the dataset: OFF trades the visitation guarantee
            # for coordination-free streams
            assert sorted(got) == sorted(list(rows) * 2)
        finally:
            feed.terminate()


def test_static_mode_exactly_once_with_frozen_ownership(tmp_path):
    splits, rows = _write_jsonl(tmp_path, 6, 10)
    with _Service(n_workers=2) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="st",
                           mode=SHARD_STATIC, timeout=20.0)
        try:
            got = _drain(feed)
            assert sorted(got) == sorted(rows)
            # round-robin ownership over 2 live workers: 3 splits each
            assert sorted(w.splits_streamed for w in svc.workers) == [3, 3]
        finally:
            feed.terminate()


def test_dynamic_mode_multi_epoch_exactly_once(tmp_path):
    splits, rows = _write_jsonl(tmp_path, 5, 8)
    with _Service(n_workers=2) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="dyn",
                           mode=SHARD_DYNAMIC, num_epochs=3, timeout=20.0)
        try:
            got = _drain(feed)
            assert sorted(got) == sorted(list(rows) * 3)
            snap = feed.counters_snapshot()
            assert snap["dataservice_splits"] == 15
            assert snap["dataservice_split_dupes"] == 0
        finally:
            feed.terminate()


@pytest.mark.chaos(timeout=60)
def test_dynamic_worker_killed_mid_epoch_exactly_once(tmp_path):
    """The visitation guarantee under failure (the tentpole's acceptance
    bar): a worker dies mid-epoch after streaming some splits; the
    dispatcher fences it and re-pools its uncompleted splits; the survivor
    re-streams them; the consumer sees every element exactly once —
    nothing lost, nothing duplicated (the test_chaos counting idiom)."""
    splits, rows = _write_jsonl(tmp_path, 10, 40)
    with _Service(n_workers=2, heartbeat=0.2, misses=2) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="kill",
                           mode=SHARD_DYNAMIC, timeout=30.0)

        def killer():
            deadline = time.monotonic() + 20
            while (svc.workers[0].splits_streamed < 1
                   and time.monotonic() < deadline):
                time.sleep(0.002)
            svc.workers[0].stop(abrupt=True)  # crash: no BYE, beats stop

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        try:
            got = _drain(feed, timeout=40.0)
            kt.join(timeout=10)
            assert sorted(got) == sorted(rows)
            status = DispatcherClient(svc.addr).status("kill")
            assert status["done"]
            # the consumer's LOST report re-pools the mid-flight split
            # immediately, so the job may finish BEFORE the heartbeat fence
            # lands; the fence must still fire for the silent worker
            deadline = time.monotonic() + 5
            while "w0" not in svc.dispatcher.dead_workers():
                assert time.monotonic() < deadline, "worker never fenced"
                time.sleep(0.05)
            snap = feed.counters_snapshot()
            assert snap["dataservice_split_dupes"] == 0
        finally:
            feed.terminate()


# ---------------------------------------------------------------------------
# Review fixes: completion drain, watchdog progress, stream loss, DONE retry,
# reader faults
# ---------------------------------------------------------------------------

def test_lost_split_repools_for_same_consumer():
    """A consumer's LOST report re-pools the mid-flight split immediately
    (no fence wait), bound to the same consumer; duplicates are stale."""
    disp = DispatcherServer(heartbeat_interval=0, host="127.0.0.1")
    addr = disp.start()
    try:
        client = DispatcherClient(addr)
        client.register_worker("w", "127.0.0.1", 1)
        client.register_job("j", ["s0", "s1"])
        assert client.request_task("j", "w", "c")["splits"] == [[0, "s0"]]
        resp = client.lost_split("j", 0, 0, "w", "c")
        assert resp["ok"] and not resp.get("stale")
        status = client.status("j")
        assert status["pending"] == 1 and status["reassigned"] == 1
        # duplicate report, and a report naming the wrong worker: stale
        assert client.lost_split("j", 0, 0, "w", "c").get("stale")
        # the (still-live) worker may re-win the re-pooled split
        assert client.request_task("j", "w", "c")["splits"] == [[0, "s0"]]
        assert client.lost_split("j", 0, 0, "other", "c").get("stale")
        client.close()
    finally:
        disp.stop()


def test_commit_survives_transient_done_failure(monkeypatch):
    """A failed DONE report must not drop the published chunks nor wedge
    the split: the data stays committed (published exactly once), the DONE
    parks and the maintainer-side flush retries it until the ledger hears
    it."""
    from tensorflowonspark_torch import marker

    disp = DispatcherServer(heartbeat_interval=0, host="127.0.0.1")
    addr = disp.start()
    try:
        client = DispatcherClient(addr)
        client.register_worker("w", "127.0.0.1", 1)
        client.register_job("j", ["s0"])
        client.request_task("j", "w", "c")
        feed = ServiceFeed(addr, ["s0"], job_name="j", consumer_id="c")
        calls = {"n": 0}
        real = DispatcherClient.done_split

        def flaky(self, *args, **kwargs):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("transient dispatcher outage")
            return real(self, *args, **kwargs)

        monkeypatch.setattr(DispatcherClient, "done_split", flaky)
        chunk = marker.Chunk([1, 2, 3])
        feed._commit_split((0, 0), [chunk])
        # published despite the failed DONE, and parked for retry
        assert feed._chunks.qsize() == 1
        assert (0, 0) in feed._committed
        assert (0, 0) in feed._done_pending
        assert not client.status("j")["done"]
        # a re-streamed duplicate copy is dropped, not re-published
        feed._commit_split((0, 0), [chunk])
        assert feed._chunks.qsize() == 1 and feed.split_dupes == 1
        # the maintainer's flush lands the parked DONE
        feed._flush_pending_done(client)
        assert not feed._done_pending
        assert client.status("j")["done"]
        client.close()
    finally:
        disp.stop()


def test_duplicate_commit_counts_as_watchdog_progress():
    """OFF-mode epoch>=2 replays commit duplicates; the watchdog must see
    them as progress, not as a stall."""
    feed = ServiceFeed(("127.0.0.1", 9), ["s0"], job_name="x")
    feed._committed.add((0, 0))
    feed._last_progress = 0.0
    feed._commit_split((0, 0), [])  # duplicate: no dispatcher dial needed
    assert feed._last_progress > 0.0
    assert feed.split_dupes == 1


def test_slow_single_split_does_not_trip_watchdog(tmp_path):
    """One split that streams LONGER than the watchdog timeout must not
    raise: every received frame is progress (frames arrive per 256-row
    reader block while the split is still uncommitted)."""
    splits, rows = _write_jsonl(tmp_path, 1, 900)

    def slow_rows(path):
        for row in data.jsonl_rows(path):
            time.sleep(0.004)  # ~3.6s total stream, frames every ~1s
            yield row

    disp = DispatcherServer(heartbeat_interval=0.5, host="127.0.0.1")
    addr = disp.start()
    worker = FeedWorker(addr, row_reader=slow_rows, worker_id="slow",
                        heartbeat_interval=0.5).start()
    try:
        feed = ServiceFeed(addr, splits, job_name="slowsplit",
                           mode=SHARD_DYNAMIC, timeout=2.0)
        try:
            got = _drain(feed, timeout=30.0)
            assert sorted(got) == sorted(rows)
        finally:
            feed.terminate()
    finally:
        worker.stop()
        disp.stop()


@pytest.mark.chaos(timeout=60)
def test_stream_loss_recovers_without_worker_death(tmp_path):
    """A TCP reset after a successful dial must not hang the job: the
    consumer reports the mid-flight split LOST (immediate re-pool) and the
    maintainer redials the still-live worker.  Heartbeats here are so slow
    the fence can never be the rescuer."""
    import socket as socket_mod

    splits, rows = _write_jsonl(tmp_path, 6, 50)

    def slowish_rows(path):
        for row in data.jsonl_rows(path):
            time.sleep(0.002)
            yield row

    disp = DispatcherServer(heartbeat_interval=60.0, heartbeat_misses=100,
                            host="127.0.0.1")
    addr = disp.start()
    worker = FeedWorker(addr, row_reader=slowish_rows, worker_id="reset",
                        heartbeat_interval=60.0).start()
    try:
        feed = ServiceFeed(addr, splits, job_name="reset",
                           mode=SHARD_DYNAMIC, timeout=20.0)

        def breaker():
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if feed.splits_committed >= 1:
                    with feed._stream_lock:
                        socks = list(feed._stream_socks.values())
                    for s in socks:
                        try:
                            s.shutdown(socket_mod.SHUT_RDWR)
                        except OSError:
                            pass
                    return
                time.sleep(0.002)

        bt = threading.Thread(target=breaker, daemon=True)
        bt.start()
        try:
            got = _drain(feed, timeout=40.0)
            bt.join(timeout=5)
            assert sorted(got) == sorted(rows)
            assert feed.split_dupes == 0
        finally:
            feed.terminate()
    finally:
        worker.stop()
        disp.stop()


def test_stream_cut_between_splits_repools_the_won_split(tmp_path):
    """The break falls after a split_end and before the next split_begin:
    the worker has already won the next split, the consumer has nothing
    in flight to report LOST, and heartbeats are too slow for a fence.
    The worker reports the split it could not start LOST itself, so the
    maintainer's redial drains the job exactly once.  (The cut is made
    deterministically inside the worker, on its second split.)"""
    import socket as socket_mod

    splits, rows = _write_jsonl(tmp_path, 4, 20)
    disp = DispatcherServer(heartbeat_interval=60.0, heartbeat_misses=100,
                            host="127.0.0.1")
    addr = disp.start()
    worker = FeedWorker(addr, row_reader=data.jsonl_rows, worker_id="cut",
                        heartbeat_interval=60.0)
    stream_split = worker._stream_split
    calls = []

    def cut_before_second(conn, *args, **kwargs):
        calls.append(args[3])
        if len(calls) == 2:
            conn.shutdown(socket_mod.SHUT_RDWR)
        return stream_split(conn, *args, **kwargs)

    worker._stream_split = cut_before_second
    worker.start()
    try:
        feed = ServiceFeed(addr, splits, job_name="cut", mode=SHARD_DYNAMIC,
                           timeout=15.0)
        try:
            got = _drain(feed, timeout=30.0)
            assert sorted(got) == sorted(rows)
            assert feed.split_dupes == 0
            assert disp._jobs["cut"].reassigned >= 1
        finally:
            feed.terminate()
    finally:
        worker.stop()
        disp.stop()


def test_new_stream_waits_for_the_superseded_streams_lost_report():
    """A consumer holds one stream per worker, so a second stream for the
    same (job, consumer) means it lost the first.  The worker cuts the old
    stream's socket and the new stream waits until the old stream's
    thread is done (its LOST report of an in-flight split included)
    before it asks for a split: a late report can then never re-pool a
    split the new stream was just handed (a second stream of it)."""
    import socket as socket_mod

    worker = FeedWorker(("127.0.0.1", 1), row_reader=data.jsonl_rows,
                        worker_id="w")
    old_conn, peer = socket_mod.socketpair()
    old_done, new_done = threading.Event(), threading.Event()
    worker._supersede(("j", "c"), old_conn, old_done)
    order = []

    def new_stream():
        worker._supersede(("j", "c"), "new-conn", new_done)
        order.append("new stream asks for a split")

    t = threading.Thread(target=new_stream, daemon=True)
    t.start()
    # the old stream's socket is cut: its thread's next read ends
    peer.settimeout(5)
    assert peer.recv(1) == b""
    time.sleep(0.2)
    assert t.is_alive() and order == []
    order.append("old stream reported LOST")
    old_done.set()
    t.join(5)
    assert order == ["old stream reported LOST", "new stream asks for a split"]
    assert worker._serving[("j", "c")] == ("new-conn", new_done)
    # another consumer's stream supersedes nothing
    worker._supersede(("j", "other"), "conn-2", threading.Event())
    old_conn.close()
    peer.close()


@pytest.mark.chaos(timeout=120)
def test_stream_lost_mid_split_restreams_once(tmp_path):
    """The consumer loses its stream mid-split and reports the split LOST
    while the worker's thread of that stream is still inside the split:
    the redialed stream supersedes it, and every row arrives once, with
    no duplicate stream of the split."""
    import socket as socket_mod

    splits, rows = _write_jsonl(tmp_path, 4, 10)
    disp = DispatcherServer(heartbeat_interval=60.0, heartbeat_misses=100,
                            host="127.0.0.1")
    addr = disp.start()
    worker = FeedWorker(addr, row_reader=data.jsonl_rows, worker_id="slow",
                        heartbeat_interval=60.0)
    send_block = worker._send_block
    blocked, release = threading.Event(), threading.Event()
    calls = []

    def stall_second_block(conn, block, **kwargs):
        send_block(conn, block, **kwargs)
        calls.append(len(block))
        if len(calls) == 2:
            blocked.set()
            release.wait(30)

    worker._send_block = stall_second_block
    worker.start()
    try:
        feed = ServiceFeed(addr, splits, job_name="midsplit",
                           mode=SHARD_DYNAMIC, timeout=20.0)

        def breaker():
            assert blocked.wait(15)
            time.sleep(0.3)   # the consumer reads split_begin and the block
            with feed._stream_lock:
                socks = list(feed._stream_socks.values())
            for sock in socks:
                sock.shutdown(socket_mod.SHUT_RDWR)
            job = disp._jobs["midsplit"]
            deadline = time.monotonic() + 15
            while job.reassigned < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.5)   # the redial reaches the worker meanwhile
            release.set()

        bt = threading.Thread(target=breaker, daemon=True)
        bt.start()
        try:
            got = _drain(feed, timeout=30.0)
            bt.join(timeout=20)
            assert sorted(got) == sorted(rows)
            assert feed.split_dupes == 0
        finally:
            release.set()
            feed.terminate()
    finally:
        worker.stop()
        disp.stop()


def test_reader_fault_fails_job_with_cause(tmp_path):
    """An unreadable split surfaces the reader's error to the consumer
    (split_abort in-band + SPLIT_ERR -> re-pool budget -> job failure)
    instead of wedging into an opaque watchdog timeout."""
    splits, _ = _write_jsonl(tmp_path, 2, 10)
    splits.append(os.path.join(str(tmp_path), "missing.jsonl"))
    with _Service(n_workers=2) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="bad",
                           mode=SHARD_DYNAMIC, timeout=20.0)
        try:
            with pytest.raises(DispatchError, match="missing"):
                _drain(feed, timeout=30.0)
            assert feed.splits_discarded >= 1
        finally:
            feed.terminate()
        status = DispatcherClient(svc.addr).status("bad")
        assert status["error"] and "missing.jsonl" in status["error"]
        assert not status["done"]


def test_slow_consumer_drains_tail_after_job_done(tmp_path):
    """End-of-job must not evict queued chunks: a consumer draining much
    slower than the maintainer's completion detection still receives every
    element (the sentinel queues BEHIND committed data, never over it)."""
    splits, rows = _write_jsonl(tmp_path, 8, 256)  # 1 reader block each
    with _Service(n_workers=2) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="slowdrain",
                           mode=SHARD_DYNAMIC, prefetch=2, timeout=20.0)
        got = []
        deadline = time.monotonic() + 60
        try:
            while not feed.should_stop():
                assert time.monotonic() < deadline, "feed did not complete"
                arrays, count = feed.next_batch_arrays(64)
                if count:
                    got.extend(arrays.tolist())
                time.sleep(0.15)  # job completes long before the drain does
            assert sorted(got) == sorted(rows)
        finally:
            feed.terminate()


# ---------------------------------------------------------------------------
# Transport parity
# ---------------------------------------------------------------------------

def test_colv1_transport_parity_with_local_filefeed(tmp_path):
    """Element-identical to reading the same files with a local FileFeed,
    and the transport really was colv1 frames (no pickle fallback)."""
    splits, _ = _write_jsonl(tmp_path, 4, 25)
    local = data.FileFeed(splits, row_reader=data.jsonl_rows,
                          reader_threads=1, shard=False)
    expected = []
    while not local.should_stop():
        arrays, count = local.next_batch_arrays(32)
        if count:
            expected.extend(arrays.tolist())
    with _Service(n_workers=2) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="parity",
                           mode=SHARD_DYNAMIC, timeout=20.0)
        try:
            got = _drain(feed)
            assert sorted(got) == sorted(expected)
            # compressed streams count under "colv1+<codec>" — any colv1-
            # prefixed key proves the framed transport carried the rows
            assert sum(n for fmt, n in feed.wire_formats.items()
                       if fmt.startswith(wire.WIRE_COLV1)) > 0
            assert wire.WIRE_PICKLE not in feed.wire_formats
        finally:
            feed.terminate()


def test_dict_rows_fall_back_to_pickle_and_assemble_columnar(tmp_path):
    """Object/dict rows aren't colv1-framable: the worker pickles them (the
    _ChunkPutter fallback rule) and the consumer still assembles columnar
    batches keyed by field name."""
    splits, rows = _write_jsonl(
        tmp_path, 3, 10, row_fn=lambda i: {"x": [float(i), 2.0 * i],
                                           "y": float(i)})
    with _Service(n_workers=2) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="dicts",
                           mode=SHARD_DYNAMIC, timeout=20.0)
        try:
            got_y = []
            deadline = time.monotonic() + 30
            while not feed.should_stop():
                assert time.monotonic() < deadline
                arrays, count = feed.next_batch_arrays(16)
                if count:
                    assert set(arrays) == {"x", "y"}
                    assert arrays["x"].shape == (count, 2)
                    got_y.extend(arrays["y"].tolist())
            assert sorted(got_y) == sorted(r["y"] for r in rows)
            assert feed.wire_formats.get(wire.WIRE_PICKLE, 0) > 0
            assert wire.WIRE_COLV1 not in feed.wire_formats
        finally:
            feed.terminate()


def test_next_batch_with_input_mapping_and_pickle_env_knob(tmp_path, monkeypatch):
    """TFOS_WIRE_FORMAT=pickle forces the pickled transport end to end (the
    A/B knob), and next_batch honors the input_mapping per-tensor-dict
    contract for tuple rows."""
    monkeypatch.setenv("TFOS_WIRE_FORMAT", "pickle")
    splits, rows = _write_jsonl(tmp_path, 2, 8,
                                row_fn=lambda i: [float(i), float(-i)])
    with _Service(n_workers=1) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="nb",
                           mode=SHARD_DYNAMIC,
                           input_mapping={"a": "x", "b": "y"}, timeout=20.0)
        try:
            got_x, got_y = [], []
            deadline = time.monotonic() + 30
            while not feed.should_stop():
                assert time.monotonic() < deadline
                batch = feed.next_batch(5)
                assert set(batch) == {"x", "y"}
                got_x.extend(batch["x"])
                got_y.extend(batch["y"])
            assert sorted(got_x) == sorted(r[0] for r in rows)
            assert sorted(got_y) == sorted(r[1] for r in rows)
            assert feed.wire_formats.get(wire.WIRE_PICKLE, 0) > 0
            assert wire.WIRE_COLV1 not in feed.wire_formats
        finally:
            feed.terminate()


def test_frame_chunk_bytes_round_trip():
    from tensorflowonspark_torch import marker

    chunk = marker.ColChunk(
        (np.arange(12, dtype=np.float32).reshape(6, 2),
         np.arange(6, dtype=np.int64)), 6, True)
    buf = wire.frame_chunk_bytes(chunk)
    out = wire.decode_chunk(buf)
    assert out.count == 6 and out.tuple_rows
    np.testing.assert_array_equal(out.columns[0], chunk.columns[0])
    np.testing.assert_array_equal(out.columns[1], chunk.columns[1])
    # object columns aren't framable -> None (callers fall back to pickle)
    ragged = marker.ColChunk(
        (np.array([[1], [2, 3]], dtype=object),), 2, False)
    assert wire.frame_chunk_bytes(ragged) is None


def test_jsonl_rows_row_shapes(tmp_path):
    path = os.path.join(str(tmp_path), "rows.jsonl")
    with open(path, "w") as f:
        f.write('{"a": 1}\n')
        f.write("[1.5, 2.5]\n")
        f.write("\n")          # blank lines skipped
        f.write("7\n")
    rows = list(data.jsonl_rows(path))
    # top-level arrays become TUPLE rows (fields), not list values
    assert rows == [{"a": 1}, (1.5, 2.5), 7]


# ---------------------------------------------------------------------------
# ServiceFeed drop-in: fit_supervised on a 2-consumer run
# ---------------------------------------------------------------------------

@pytest.mark.chaos(timeout=120)
def test_fit_supervised_two_consumers_share_the_job(tmp_path):
    """The drop-in acceptance on the port's Trainer: consumer 0 trains with
    fit_supervised through the port's ShardedFeed on a ServiceFeed (on the
    CPU); consumer 1 is a plain drain loop on the SAME job.  DYNAMIC
    sharding splits the dataset between them first-come-first-served, and
    their combined consumption is the dataset exactly once."""
    import functools

    import torch

    from tensorflowonspark_torch import checkpoint as ckpt_mod
    from tensorflowonspark_torch.parallel.infeed import ShardedFeed
    from tensorflowonspark_torch.train import Trainer, fit_supervised

    rng = np.random.RandomState(0)

    def row_fn(i):
        x = [float(v) for v in rng.rand(2)]
        return [x, float(np.dot(x, [3.14, 1.618]))]

    splits, rows = _write_jsonl(tmp_path, 12, 8, row_fn=row_fn)

    with _Service(n_workers=2) as svc:
        other = ServiceFeed(svc.addr, splits, job_name="fit",
                            mode=SHARD_DYNAMIC, consumer_id="c-drain",
                            timeout=60.0)
        drained = []

        def drain_other():
            while not other.should_stop():
                _, count = other.next_batch_arrays(16)
                drained.append(count)

        dt = threading.Thread(target=drain_other, daemon=True)
        dt.start()

        trainer_feed = ServiceFeed(svc.addr, splits, job_name="fit",
                                   mode=SHARD_DYNAMIC, consumer_id="c-fit",
                                   input_mapping={"a_x": "x", "b_y": "y"},
                                   timeout=60.0)
        sharded = ShardedFeed(trainer_feed, 8, prefetch=0, device="cpu")

        def loss(params, batch, mask):
            pred = batch["x"].float() @ params["w"]
            err = (pred - batch["y"].float()) ** 2 * mask
            return err.sum() / mask.sum().clamp_min(1.0), {}

        trainer = Trainer(loss, {"w": torch.zeros(2)},
                          functools.partial(torch.optim.SGD, lr=0.05),
                          batch_size=8, log_steps=2, device="cpu")
        ckpt = ckpt_mod.CheckpointManager(str(tmp_path / "ckpt"),
                                          save_interval_steps=1)
        try:
            fit_supervised(trainer, lambda: sharded, ckpt)
            dt.join(timeout=60)
            assert not dt.is_alive()
            total = trainer_feed.items_consumed + sum(drained)
            assert total == len(rows)
            assert (trainer_feed.splits_committed + other.splits_committed
                    == len(splits))
            assert trainer_feed.split_dupes == other.split_dupes == 0
            assert trainer.state.step == -(-trainer_feed.items_consumed // 8)
            assert torch.isfinite(trainer.state.params["w"]).all()
        finally:
            ckpt.close()
            trainer_feed.terminate()
            other.terminate()


def test_worker_cli_fields_frame_tfrecord_rows_as_colv1(tmp_path):
    """The port worker CLI's ``--fields``: TFRecord records (dict rows,
    which go pickled) served as ``(id, tokens)`` tuple rows, framed colv1,
    and read as columns in that order."""
    from tensorflowonspark_torch import dfutil

    files = []
    for s in range(3):
        files += dfutil.save_as_tfrecords(
            [{"id": i, "tokens": list(range(i, i + 6))}
             for i in range(s * 4, (s + 1) * 4)],
            str(tmp_path / "split-{}".format(s)),
            schema={"id": "int64", "tokens": "array<int64>"})
    disp = DispatcherServer(heartbeat_interval=0.2, host="127.0.0.1")
    addr = disp.start()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_torch.dataservice_worker",
         "--dispatcher", "{}:{}".format(*addr), "--reader", "tfrecord",
         "--fields", "id,tokens", "--heartbeat", "0.2"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        assert "ready on" in proc.stdout.readline()
        feed = ServiceFeed(addr, files, job_name="fields",
                           mode=SHARD_DYNAMIC, timeout=30.0)
        ids, tokens = [], []
        try:
            while not feed.should_stop():
                arrays, count = feed.next_batch_arrays(5)
                if count:
                    assert isinstance(arrays, tuple) and len(arrays) == 2
                    assert arrays[1].shape == (count, 6)
                    ids.extend(int(i) for i in arrays[0])
                    tokens.extend(arrays[1].tolist())
            assert feed.wire_formats.get(wire.WIRE_PICKLE, 0) == 0
            assert sum(n for fmt, n in feed.wire_formats.items()
                       if fmt.startswith(wire.WIRE_COLV1)) > 0
        finally:
            feed.terminate()
        assert sorted(ids) == list(range(12))
        assert all(row == list(range(i, i + 6))
                   for i, row in zip(ids, tokens))
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
        disp.stop()


def test_node_service_feed_takes_the_cluster_spec_and_live_knobs(tmp_path):
    """``ctx.get_service_feed`` on the port's node: the cluster spec's
    dispatcher and pinned codecs, the consumer named after the executor,
    the feed registered so that ``node.apply_knobs`` reaches its
    ``dataservice_queue_bound`` (as the JAX node's does), every row
    delivered; with no spec and no ``dispatcher=`` it refuses."""
    from tensorflowonspark_torch import node

    splits, rows = _write_jsonl(tmp_path, 3, 10)

    def ctx(spec):
        return node.TPUNodeContext(3, "worker", 0, {}, "file://",
                                   str(tmp_path), None, None, 1, 0,
                                   data_service=spec)

    with pytest.raises(ValueError, match="no data service configured"):
        ctx(None).get_service_feed(splits)
    with _Service(n_workers=1) as svc:
        feed = ctx({"dispatcher": list(svc.addr), "codecs": ["zlib"]}) \
            .get_service_feed(splits, job_name="node", mode=SHARD_DYNAMIC,
                              timeout=20.0)
        try:
            assert feed.consumer_id == "executor-3"
            assert feed.codecs == ["zlib"]
            assert node.apply_knobs({"dataservice_queue_bound": 7}) >= 1
            assert feed._chunks.maxsize == 7
            assert sorted(_drain(feed)) == sorted(rows)
        finally:
            feed.terminate()
            # get_service_feed registered the feed's drain with this
            # process's preemption handler: a node's child exits, this
            # pytest worker runs other files after this one
            node.remove_preemption_callback(feed.terminate)


@pytest.mark.parametrize("k", [1, 2])
def test_split_flow_ends_at_each_dispatch(tmp_path, k):
    """The split-flow relay on the port: the dispatcher starts a flow per
    assignment, the consumer steps it at commit, ``ShardedFeed`` at the
    device copy, and ``Trainer.fit_feed`` ends one at each dispatch, a
    group of K batches included (K = 2: one dispatch a group)."""
    import functools

    import torch

    from tensorflowonspark_torch import telemetry, train
    from tensorflowonspark_torch.parallel.infeed import ShardedFeed

    splits, rows = _write_jsonl(tmp_path, 4, 4,
                                row_fn=lambda i: [[float(i), 1.0], float(i)])
    tracer = telemetry.configure(True, str(tmp_path / "telemetry"))
    try:
        with _Service(n_workers=1) as svc:
            feed = ServiceFeed(svc.addr, splits, job_name="flows",
                               mode=SHARD_DYNAMIC,
                               input_mapping={"a_x": "x", "b_y": "y"},
                               timeout=20.0)
            sharded = ShardedFeed(feed, 4, prefetch=0, device="cpu")

            def loss(params, batch, mask):
                err = (batch["x"].float() @ params["w"]
                       - batch["y"].float()) ** 2 * mask
                return err.sum() / mask.sum().clamp_min(1.0), {}

            trainer = train.Trainer(
                loss, {"w": torch.zeros(2)},
                functools.partial(torch.optim.SGD, lr=0.01), batch_size=4,
                device="cpu")
            try:
                trainer.fit_feed(sharded, steps_per_call=k)
            finally:
                feed.terminate()
        ends = [e for e in tracer._events
                if e.get("name") == "dataservice/split_flow"
                and e.get("ph") == "f"]
        legs = {(e.get("ph"), (e.get("args") or {}).get("leg"))
                for e in tracer._events
                if e.get("name") == "dataservice/split_flow"}
    finally:
        telemetry.configure(False)
    assert trainer.state.step == len(rows) // 4
    assert len(ends) == trainer._dispatch_count == len(rows) // 4 // k
    assert {e["args"]["leg"] for e in ends} == {"train_dispatch"}
    assert {("s", None), ("t", "split_commit")} <= legs
