"""The port's data-service tests, re-pointed from ``tests/test_dataservice.py``
(data-plane v2 and multi-tenant v3) on ``tensorflowonspark_torch``: the
worker chunk cache and negotiated wire compression, shared jobs,
cache-affinity scheduling and the journaled ledger — all on localhost,
CPU-only."""

import json
import os
import threading
import time

import pytest

from tensorflowonspark_torch import data, dataservice, wire
from tensorflowonspark_torch.dataservice import (
    SHARD_DYNAMIC, SHARD_STATIC, DispatchError, DispatcherClient,
    DispatcherServer, FeedWorker, ServiceFeed)
from torch_dataservice_util import _Service, _drain, _write_jsonl


# ---------------------------------------------------------------------------
# Data-plane v2: worker chunk cache + negotiated wire compression
# ---------------------------------------------------------------------------

def _payload_row(i):
    """(id, 64-float payload) rows: wide enough for colv1 framing AND for
    the zlib pay-off check to keep the payload column compressed."""
    return [i, [float(i % 7)] * 64]


def _drain_ids(feed, batch_size=64, timeout=30.0):
    """The id column out of a feed of ``_payload_row`` tuples."""
    got = []
    deadline = time.monotonic() + timeout
    while not feed.should_stop():
        assert time.monotonic() < deadline, "feed did not complete"
        arrays, count = feed.next_batch_arrays(batch_size)
        if count:
            got.extend(int(x) for x in arrays[0])
    return got


def _frames(nbytes, items=10, kind=1):
    return [(kind, b"\x5a" * nbytes, items)]


def test_frame_cache_hit_then_stale_source_invalidates(tmp_path):
    from tensorflowonspark_torch.dataservice import _FrameCache

    path = str(tmp_path / "src.jsonl")
    with open(path, "w") as f:
        f.write("old\n")
    cache = _FrameCache(max_bytes=1 << 20)
    sig = _FrameCache.signature(path)
    assert cache.lookup(path, "zlib") is None and cache.misses == 1
    cache.put(path, "zlib", sig, _frames(100))
    assert cache.lookup(path, "zlib") == _frames(100) and cache.hits == 1
    # the codec is part of the key: a raw-link serve never sees zlib frames
    assert cache.lookup(path, None) is None
    # touch/resize the source between serves: the entry must drop
    time.sleep(0.01)
    with open(path, "w") as f:
        f.write("newer and longer\n")
    assert cache.lookup(path, "zlib") is None
    assert cache.invalidations == 1
    assert cache.resident_bytes() == 0


def test_frame_cache_lru_eviction_and_uncacheable(tmp_path):
    from tensorflowonspark_torch.dataservice import _FrameCache

    cache = _FrameCache(max_bytes=250)
    cache.put("a", None, None, _frames(100))
    cache.put("b", None, None, _frames(100))
    assert cache.lookup("a", None) is not None  # refresh a's LRU slot
    assert cache.put("c", None, None, _frames(100)) == 1  # b (LRU) evicted
    assert cache.lookup("b", None) is None and cache.evictions == 1
    assert cache.lookup("a", None) is not None
    assert cache.lookup("c", None) is not None
    # an entry over the whole budget is never admitted (and evicts nothing)
    assert cache.put("big", None, None, _frames(300)) == 0
    assert cache.uncacheable == 1 and cache.lookup("big", None) is None


def test_frame_cache_spills_to_disk_and_promotes_back(tmp_path):
    from tensorflowonspark_torch.dataservice import _FrameCache

    cache = _FrameCache(max_bytes=150, spill_dir=str(tmp_path / "spill"))
    frames_a = [(1, b"\x11" * 60, 5), (2, b"\x22" * 40, 7)]
    cache.put("a", "zlib", None, frames_a)
    cache.put("b", "zlib", None, _frames(100))
    assert cache.evictions == 1 and cache.spills == 1  # a hit the disk
    # a spilled hit reads the exact frame sequence back and re-residents it
    # (which pushes b over the budget in turn: b evicts and spills)
    assert cache.lookup("a", "zlib") == frames_a
    assert cache.spill_hits == 1
    assert cache.evictions == 2 and cache.spills == 2
    assert cache.lookup("b", "zlib") is not None  # b promotes back too
    assert cache.spill_hits == 2
    flat = cache.counters_flat()
    assert flat["dataservice_cache_spills"] == cache.spills
    assert flat["dataservice_cache_spill_hits"] == cache.spill_hits


def test_epoch2_serves_from_worker_cache_with_compression(tmp_path):
    """The tentpole end to end on one worker: epoch 1 cold-serves and
    fills the cache, epoch 2 replays every split from it; the negotiated
    zlib codec engages on the link and every counter reaches the
    consumer's snapshot."""
    splits, rows = _write_jsonl(tmp_path, 6, 30, row_fn=_payload_row)
    disp = DispatcherServer(heartbeat_interval=0.2, heartbeat_misses=2,
                            host="127.0.0.1")
    addr = disp.start()
    w = FeedWorker(addr, row_reader=data.jsonl_rows, worker_id="cw0",
                   heartbeat_interval=0.2, cache_bytes=32 << 20).start()
    try:
        feed = ServiceFeed(addr, splits, job_name="cached",
                           mode=SHARD_STATIC, num_epochs=2, timeout=30.0)
        got = _drain_ids(feed, timeout=40.0)
        assert sorted(got) == sorted([r[0] for r in rows] * 2)
        assert w.chunk_cache.hits == len(splits)
        assert w.chunk_cache.misses == len(splits)
        assert feed.cache_hits == len(splits)
        assert feed.cache_misses == len(splits)
        snap = feed.counters_snapshot()
        assert snap["dataservice_cache_hit"] == len(splits)
        assert snap["dataservice_cache_bytes"] > 0
        assert snap["dataservice_cache_resident_max"] > 0
        assert snap["dataservice_split_dupes"] == 0
        # compressed colv1 frames on the link, visible as a ratio gauge
        assert sum(n for fmt, n in feed.wire_formats.items()
                   if fmt.startswith("colv1+")) > 0
        assert snap["wire_compress_ratio_max"] > 1.0
        assert snap["wire_compress_saved_bytes"] > 0
        feed.terminate()
    finally:
        w.stop()
        disp.stop()


def test_cache_invalidates_when_source_file_changes(tmp_path):
    """Freshness: a source file rewritten between jobs must not replay
    stale frames — the worker re-reads it and the consumer sees the new
    content (entries are shared across jobs over the same files)."""
    splits, rows = _write_jsonl(tmp_path, 4, 20, row_fn=_payload_row)
    disp = DispatcherServer(heartbeat_interval=0.2, heartbeat_misses=2,
                            host="127.0.0.1")
    addr = disp.start()
    w = FeedWorker(addr, row_reader=data.jsonl_rows, worker_id="iw0",
                   heartbeat_interval=0.2, cache_bytes=32 << 20).start()
    try:
        feed_a = ServiceFeed(addr, splits, job_name="fresh-a",
                             mode=SHARD_STATIC, timeout=30.0)
        assert sorted(_drain_ids(feed_a)) == sorted(r[0] for r in rows)
        feed_a.terminate()
        assert w.chunk_cache.misses == len(splits)

        # rewrite split 0 with different ids and a different byte size
        time.sleep(0.01)
        with open(splits[0], "w") as f:
            for i in range(1000, 1025):
                f.write(json.dumps(_payload_row(i)) + "\n")
        expect_b = [r[0] for r in rows if r[0] >= 20] + list(range(1000, 1025))

        feed_b = ServiceFeed(addr, splits, job_name="fresh-b",
                             mode=SHARD_STATIC, timeout=30.0)
        assert sorted(_drain_ids(feed_b)) == sorted(expect_b)
        # splits 1-3 replayed from the first job's entries; split 0 dropped
        assert w.chunk_cache.invalidations == 1
        assert w.chunk_cache.hits == len(splits) - 1
        assert feed_b.cache_hits == len(splits) - 1
        assert feed_b.cache_misses == 1
        feed_b.terminate()
    finally:
        w.stop()
        disp.stop()


@pytest.mark.chaos(timeout=60)
def test_worker_killed_mid_cached_epoch_exactly_once(tmp_path):
    """The exactly-once ledger with the cache armed: a worker crashes
    while replaying epoch 2 from its cache; STATIC ownership re-pins its
    splits to the survivor, which cold-serves them; the consumer still
    sees every element exactly twice — the cache must not relax the
    split_begin/split_end/abort protocol."""
    splits, rows = _write_jsonl(tmp_path, 10, 40, row_fn=_payload_row)
    disp = DispatcherServer(heartbeat_interval=0.2, heartbeat_misses=2,
                            host="127.0.0.1")
    addr = disp.start()
    workers = [FeedWorker(addr, row_reader=data.jsonl_rows,
                          worker_id="kw{}".format(i), heartbeat_interval=0.2,
                          cache_bytes=32 << 20).start() for i in range(2)]
    try:
        feed = ServiceFeed(addr, splits, job_name="cache-kill",
                           mode=SHARD_STATIC, num_epochs=2, timeout=30.0)

        def killer():
            deadline = time.monotonic() + 20
            # wait until epoch 2 is being replayed from the cache
            while (workers[0].chunk_cache.hits < 1
                   and time.monotonic() < deadline):
                time.sleep(0.002)
            workers[0].stop(abrupt=True)  # crash: no BYE, beats stop

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        try:
            got = _drain_ids(feed, timeout=40.0)
            kt.join(timeout=10)
            assert sorted(got) == sorted([r[0] for r in rows] * 2)
            status = DispatcherClient(addr).status("cache-kill")
            assert status["done"]
            snap = feed.counters_snapshot()
            assert snap["dataservice_split_dupes"] == 0
        finally:
            feed.terminate()
    finally:
        for w in workers:
            w.stop()
        disp.stop()


def test_wire_codec_env_knob_and_explicit_list(tmp_path, monkeypatch):
    """TFOS_WIRE_CODEC=off forces raw colv1 frames end to end (the A/B
    parity knob); an unsupported explicit ``codecs=`` list raises."""
    splits, rows = _write_jsonl(tmp_path, 3, 20, row_fn=_payload_row)
    monkeypatch.setenv("TFOS_WIRE_CODEC", "off")
    with _Service(n_workers=1) as svc:
        feed = ServiceFeed(svc.addr, splits, job_name="rawlink",
                           mode=SHARD_DYNAMIC, timeout=30.0)
        assert feed.codecs == []
        assert sorted(_drain_ids(feed)) == sorted(r[0] for r in rows)
        assert set(feed.wire_formats) == {wire.WIRE_COLV1}
        snap = feed.counters_snapshot()
        assert "wire_compress_ratio_max" not in snap
        feed.terminate()
    with pytest.raises(ValueError, match="unsupported wire codec"):
        ServiceFeed(("127.0.0.1", 1), splits, job_name="bad",
                    codecs=["snappy"])


# ---------------------------------------------------------------------------
# Multi-tenant v3: shared jobs, cache-affinity scheduling, journaled ledger
# ---------------------------------------------------------------------------

def test_concurrent_register_job_race_single_creator():
    """N consumers race register_job for the same name: the dispatcher lock
    serializes them into exactly one create and N-1 attaches — never a
    duplicate ledger, never an error."""
    disp = DispatcherServer(heartbeat_interval=0, host="127.0.0.1")
    addr = disp.start()
    try:
        results, errors = [], []
        barrier = threading.Barrier(4)

        def attempt(i):
            client = DispatcherClient(addr)
            try:
                barrier.wait(timeout=10)
                results.append(client.register_job(
                    "race", ["s0", "s1"], consumer_id="c{}".format(i)))
            except Exception as e:  # surfaced below, not swallowed
                errors.append(e)
            finally:
                client.close()

        threads = [threading.Thread(target=attempt, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        assert not errors
        assert sum(1 for r in results if r["created"]) == 1
        assert all(r["spec"]["splits"] == ["s0", "s1"] for r in results)
        client = DispatcherClient(addr)
        assert client.status("race")["consumers"] == 4
        client.close()
    finally:
        disp.stop()


def test_detach_rebinds_inflight_splits_to_survivor():
    """A clean DETACH re-binds the leaver's splits to a surviving
    co-consumer (not back to the free pool: the heir keeps the warm
    stream); a duplicate DETACH is stale, not an error."""
    disp = DispatcherServer(heartbeat_interval=0, host="127.0.0.1")
    addr = disp.start()
    try:
        client = DispatcherClient(addr)
        client.register_worker("w", "127.0.0.1", 1)
        client.register_job("j", ["s0", "s1", "s2"], consumer_id="c0")
        reply = client.register_job("j", consumer_id="c1", attach=True)
        assert not reply["created"] and reply["consumers"] == 2
        assert client.request_task("j", "w", "c0")["splits"] == [[0, "s0"]]
        assert client.detach_job("j", "c0")["moved"] == 1
        status = client.status("j")
        assert status["consumers"] == 1 and status["pending"] == 1
        assert client.request_task("j", "w", "c1")["splits"] == [[0, "s0"]]
        assert client.detach_job("j", "c0").get("stale")
        client.close()
    finally:
        disp.stop()


def test_silent_consumer_is_fenced_and_rejected():
    """Consumer liveness: a consumer that goes silent past the heartbeat
    deadline is fenced — its splits re-bind to the survivor, its identity
    is dead (DONE and re-attach answer a typed 'fenced' error), and a
    fresh identity attaches fine."""
    disp = DispatcherServer(heartbeat_interval=0.1, heartbeat_misses=2,
                            host="127.0.0.1")
    addr = disp.start()
    try:
        client = DispatcherClient(addr)
        client.register_worker("w", "127.0.0.1", 1)
        client.register_job("j", ["s0", "s1"], consumer_id="c0")
        client.register_job("j", consumer_id="c1", attach=True)
        assert client.request_task("j", "w", "c0")["splits"] == [[0, "s0"]]
        deadline = time.monotonic() + 5
        while client.status("j", consumer_id="c1")["consumers"] > 1:
            assert time.monotonic() < deadline, "consumer never fenced"
            time.sleep(0.03)
        with pytest.raises(DispatchError, match="fenced"):
            client.done_split("j", 0, 0, "c0")
        with pytest.raises(DispatchError, match="fenced"):
            client.register_job("j", consumer_id="c0", attach=True)
        # fresh-identity rule: a new name attaches fine
        assert client.register_job("j", consumer_id="c0b",
                                   attach=True)["consumers"] == 2
        # the orphan re-bound to the survivor ("w" got fenced for the same
        # silence, so a fresh worker drains it)
        client.register_worker("w2", "127.0.0.1", 2)
        assert client.request_task("j", "w2", "c1")["splits"] == [[0, "s0"]]
        client.close()
    finally:
        disp.stop()


def test_shared_job_two_consumers_split_the_read(tmp_path):
    """The tentpole e2e: a second run attaches to the first run's job
    (files=None adopts the registered spec) and the two consumers split
    the read — the union of what they see is the dataset exactly once."""
    splits, rows = _write_jsonl(tmp_path, 8, 25)
    with _Service(n_workers=2) as svc:
        feed_a = ServiceFeed(svc.addr, splits, job_name="shared",
                             mode=SHARD_DYNAMIC, timeout=30.0)
        feed_a._ensure_started()  # deterministic create-before-attach
        assert feed_a.created_job is True
        feed_b = ServiceFeed(svc.addr, None, job_name="shared",
                             attach=True, timeout=30.0)
        got = {}

        def run(feed, key):
            got[key] = _drain(feed)

        threads = [threading.Thread(target=run, args=(f, k), daemon=True)
                   for f, k in ((feed_a, "a"), (feed_b, "b"))]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=40)
            assert sorted(got["a"] + got["b"]) == sorted(rows)
            assert feed_b.created_job is False
            assert feed_b.mode == SHARD_DYNAMIC  # adopted from the spec
            for f in (feed_a, feed_b):
                assert f.counters_snapshot()["dataservice_split_dupes"] == 0
        finally:
            feed_a.terminate()
            feed_b.terminate()


@pytest.mark.chaos(timeout=60)
def test_consumer_death_mid_epoch_co_consumer_drains(tmp_path):
    """A consumer crashes mid-epoch without DETACH (its streams simply go
    quiet) while holding in-flight splits: the fence re-binds them to the
    co-consumer, which drains the whole dataset exactly once."""
    splits, rows = _write_jsonl(tmp_path, 8, 30)
    with _Service(n_workers=2, heartbeat=0.2, misses=2) as svc:
        client = DispatcherClient(svc.addr)
        assert client.register_job("share", splits,
                                   consumer_id="ghost")["created"]
        # the ghost wins two splits, then crashes: no DETACH, no streams
        assert client.request_task("share", "w0", "ghost")["splits"]
        assert client.request_task("share", "w1", "ghost")["splits"]
        feed = ServiceFeed(svc.addr, splits, job_name="share",
                           consumer_id="survivor", mode=SHARD_DYNAMIC,
                           timeout=30.0)
        try:
            got = _drain(feed, timeout=40.0)
            assert sorted(got) == sorted(rows)
            status = client.status("share")
            assert status["done"]
            assert status["consumers"] == 1  # ghost fenced off the job
            assert status["reassigned"] >= 2
            assert feed.counters_snapshot()["dataservice_split_dupes"] == 0
        finally:
            feed.terminate()
            client.close()


def test_job_state_round_trip():
    """_Job.to_state()/from_state(): the full ledger (epoch position,
    completion, in-flight bindings, per-consumer pend queues, attach and
    fence sets) survives a JSON round trip."""
    from tensorflowonspark_torch.dataservice import _Job

    job = _Job("j", ["a", "b", "c", "d"], 2, SHARD_DYNAMIC)
    job.attach("c0")
    job.attach("c1")
    job.next_splits("w0", "c0", {"w0"})       # a in flight
    job.completed.add(1)                      # b committed
    job.pending["c1"] = [2]                   # c re-pooled for c1
    job.fenced_consumers.add("cx")
    job.split_errors[3] = 1
    state = json.loads(json.dumps(job.to_state()))  # must be JSON-safe
    clone = _Job.from_state(state)
    assert clone.name == job.name and clone.mode == job.mode
    assert clone.epoch == job.epoch and clone.num_epochs == job.num_epochs
    assert clone.splits == job.splits
    assert clone.completed == job.completed
    assert clone.assigned == job.assigned
    assert clone.pending == job.pending
    assert list(clone.unassigned) == list(job.unassigned)
    assert clone.consumers == job.consumers
    assert clone.fenced_consumers == job.fenced_consumers
    assert clone.split_errors == job.split_errors


def test_journal_recovery_restores_ledger(tmp_path):
    """Journaled dispatcher: after a simulated SIGKILL (no stop(), no
    final snapshot) a restarted dispatcher replays the ledger — committed
    splits stay committed, in-flight splits re-pool for their consumer,
    and a fresh worker drains them."""
    jdir = str(tmp_path / "journal")
    disp = DispatcherServer(heartbeat_interval=0, host="127.0.0.1",
                            journal_dir=jdir, snapshot_every=4)
    addr = disp.start()
    client = DispatcherClient(addr)
    client.register_worker("w", "127.0.0.1", 1)
    client.register_job("j", ["s0", "s1", "s2"], num_epochs=2,
                        consumer_id="c0")
    assert client.request_task("j", "w", "c0")["splits"] == [[0, "s0"]]
    client.done_split("j", 0, 0, "c0")
    assert client.request_task("j", "w", "c0")["splits"] == [[1, "s1"]]
    client.close()
    disp._stopping = True      # SIGKILL analogue: drop the socket and
    disp._socket.close()       # leave the journal tail as-is
    disp2 = DispatcherServer(heartbeat_interval=0, host="127.0.0.1",
                             journal_dir=jdir)
    addr2 = disp2.start()
    try:
        assert disp2.recovered_jobs == 1
        client = DispatcherClient(addr2)
        status = client.status("j")
        assert status["completed"] == 1
        assert status["assigned"] == 0 and status["pending"] == 1
        assert status["consumers"] == 1
        client.register_worker("w2", "127.0.0.1", 2)
        assert client.request_task("j", "w2", "c0")["splits"] == [[1, "s1"]]
        client.close()
    finally:
        disp2.stop()


def _fabricate_generations(disp, seqs, journal_bytes=100):
    """Write a snapshot + journal segment pair for each generation."""
    os.makedirs(disp.journal_dir, exist_ok=True)
    for s in seqs:
        with open(disp._segment_path("snapshot", s), "w") as f:
            f.write("{}")
        with open(disp._segment_path("journal", s), "w") as f:
            f.write("x" * journal_bytes)


def _kept_generations(disp, seqs):
    return sorted(s for s in seqs
                  if os.path.exists(disp._segment_path("snapshot", s)))


def test_journal_compaction_keeps_newest_count(tmp_path):
    """journal_keep=N: compaction after cutting generation 6 unlinks every
    snapshot/journal pair older than the newest N generations."""
    disp = DispatcherServer(heartbeat_interval=0,
                            journal_dir=str(tmp_path / "j"), journal_keep=3)
    _fabricate_generations(disp, range(1, 7))
    disp._prune_segments(6)
    assert _kept_generations(disp, range(1, 7)) == [4, 5, 6]
    for kind in ("snapshot", "journal"):
        assert not os.path.exists(disp._segment_path(kind, 1))


def test_journal_compaction_byte_budget(tmp_path):
    """journal_keep_bytes: keep the newest generations that fit the
    budget — and the newest generation survives even when it alone
    overflows the budget."""
    disp = DispatcherServer(heartbeat_interval=0,
                            journal_dir=str(tmp_path / "j"),
                            journal_keep_bytes=250)
    # each generation is 102 bytes (2-byte snapshot + 100-byte journal):
    # 6 fits, 6+5 = 204 fits, 6+5+4 = 306 overflows
    _fabricate_generations(disp, range(1, 7))
    disp._prune_segments(6)
    assert _kept_generations(disp, range(1, 7)) == [5, 6]

    tight = DispatcherServer(heartbeat_interval=0,
                             journal_dir=str(tmp_path / "tight"),
                             journal_keep_bytes=50)
    _fabricate_generations(tight, range(1, 4))
    tight._prune_segments(3)
    assert _kept_generations(tight, range(1, 4)) == [3]


def test_journal_compaction_live_snapshot_cycle(tmp_path):
    """End-to-end over the real snapshot path: with snapshot_every=2 and
    journal_keep=2 a long mutation stream leaves exactly the two newest
    generations on disk, and recovery from the compacted tail still
    restores the ledger."""
    jdir = str(tmp_path / "journal")
    disp = DispatcherServer(heartbeat_interval=0, host="127.0.0.1",
                            journal_dir=jdir, snapshot_every=2,
                            journal_keep=2)
    addr = disp.start()
    client = DispatcherClient(addr)
    client.register_worker("w", "127.0.0.1", 1)
    splits = ["s{}".format(i) for i in range(8)]
    client.register_job("j", splits, consumer_id="c0")
    for i in range(8):
        assert client.request_task("j", "w", "c0")["splits"] == \
            [[i, splits[i]]]
        client.done_split("j", 0, i, "c0")
    client.close()

    def _ledger(status):
        # affinity_* are scheduling stats, not ledger state: not journaled
        return {k: v for k, v in status.items()
                if not k.startswith("affinity_")}

    live_status = _ledger(disp.job_status("j"))
    seq = disp._journal_seq
    assert seq >= 3            # enough generations cut to force pruning
    kept = _kept_generations(disp, range(1, seq + 1))
    assert kept == [seq - 1, seq]
    disp._stopping = True      # SIGKILL analogue, recover off the tail
    disp._socket.close()
    disp2 = DispatcherServer(heartbeat_interval=0, host="127.0.0.1",
                             journal_dir=jdir)
    disp2.start()
    try:
        assert disp2.recovered_jobs == 1
        assert _ledger(disp2.job_status("j")) == live_status
    finally:
        disp2.stop()


@pytest.mark.chaos(timeout=90)
def test_dispatcher_crash_restart_mid_job_exactly_once(tmp_path):
    """The journal tentpole e2e: the dispatcher is crashed mid-job (socket
    dropped, no BYE, no snapshot flush) and restarted on the same port
    from the journal; workers re-register off the heartbeat hint, the
    consumer's maintainer reconnects, and the drain still delivers every
    element exactly once."""
    jdir = str(tmp_path / "journal")
    datadir = tmp_path / "data"
    datadir.mkdir()
    splits, rows = _write_jsonl(datadir, 10, 40)
    disp = DispatcherServer(heartbeat_interval=0.2, heartbeat_misses=3,
                            host="127.0.0.1", journal_dir=jdir,
                            snapshot_every=8)
    addr = disp.start()
    port = addr[1]
    workers = [FeedWorker(addr, row_reader=data.jsonl_rows,
                          worker_id="w{}".format(i),
                          heartbeat_interval=0.2).start()
               for i in range(2)]
    feed = ServiceFeed(addr, splits, job_name="crash",
                       mode=SHARD_DYNAMIC, timeout=60.0)
    restarted = {}

    def crash_and_restart():
        deadline = time.monotonic() + 20
        while (sum(w.splits_streamed for w in workers) < 2
               and time.monotonic() < deadline):
            time.sleep(0.005)
        disp._stopping = True
        disp._socket.close()
        # the crashed listener's select() holds the listen socket until its
        # next poll: wait for that thread to end (the port is free then)
        # instead of racing the restart's bind against it
        disp._thread.join(timeout=5)
        d2 = DispatcherServer(heartbeat_interval=0.2, heartbeat_misses=3,
                              host="127.0.0.1", port=port,
                              journal_dir=jdir, snapshot_every=8)
        d2.start()
        restarted["disp"] = d2

    t = threading.Thread(target=crash_and_restart, daemon=True)
    t.start()
    try:
        got = _drain(feed, timeout=60.0)
        t.join(timeout=15)
        assert "disp" in restarted, "dispatcher never restarted"
        # elements exactly once — the (epoch, split) dedupe absorbs any
        # split whose DONE was in flight when the dispatcher died
        assert sorted(got) == sorted(rows)
        assert restarted["disp"].recovered_jobs == 1
        client = DispatcherClient(("127.0.0.1", port))
        assert client.status("crash")["done"]
        client.close()
    finally:
        feed.terminate()
        for w in workers:
            w.stop()
        if "disp" in restarted:
            restarted["disp"].stop()


def test_affinity_prefers_cache_holder_unit():
    """The 3-tier DYNAMIC pick: a worker gets its own cached splits first,
    a cache-cold worker is steered to splits cached nowhere (so it never
    poaches another worker's warm split while cold ones remain), and the
    FCFS head is the never-stall fallback."""
    from tensorflowonspark_torch.dataservice import _Job

    job = _Job("j", ["a", "b", "c", "d"], 1, SHARD_DYNAMIC)
    job.attach("c0")
    caches = {"w1": {"c", "d"}, "w2": set()}

    def grab(worker):
        out = job.next_splits(worker, "c0", {"w1", "w2"},
                              worker_caches=caches, affinity=True)
        return out["splits"][0][1] if out and out["splits"] else None

    assert grab("w2") == "a"   # cold worker → split cached nowhere
    assert grab("w1") == "c"   # cache holder → its own splits first
    assert grab("w1") == "d"
    assert grab("w2") == "b"
    assert job.affinity_hits == 2 and job.affinity_total == 4

    # re-pooled splits are re-handed with the same preference
    job2 = _Job("j2", ["a", "b", "c"], 1, SHARD_DYNAMIC)
    job2.attach("c0")
    job2.unassigned = []
    job2.pending["c0"] = [0, 2]
    out = job2.next_splits("w1", "c0", {"w1"},
                           worker_caches={"w1": {"c"}}, affinity=True)
    assert out["splits"][0] == [2, "c"]

    # affinity off: plain FCFS, but the hit/total tally still runs so an
    # affinity-off A/B leg reports its (lower) would-be hit rate
    job3 = _Job("j3", ["a", "b"], 1, SHARD_DYNAMIC)
    job3.attach("c0")
    out = job3.next_splits("w1", "c0", {"w1"},
                           worker_caches={"w1": {"b"}}, affinity=False)
    assert out["splits"][0] == [0, "a"]
    assert job3.affinity_total == 1 and job3.affinity_hits == 0


def test_affinity_e2e_second_job_hits_cache(tmp_path):
    """Affinity end to end: job 1 fills two worker caches, the heartbeat
    advertises them, and job 2's DYNAMIC hand-outs steer splits back to
    their cache holders — visible in the job status and in the consumer's
    counter snapshot."""
    splits, rows = _write_jsonl(tmp_path, 6, 20, row_fn=_payload_row)
    with _Service(n_workers=2, cache_bytes=32 << 20) as svc:
        feed1 = ServiceFeed(svc.addr, splits, job_name="warmup",
                            mode=SHARD_DYNAMIC, timeout=30.0)
        assert sorted(_drain_ids(feed1)) == sorted(r[0] for r in rows)
        feed1.terminate()
        deadline = time.monotonic() + 5
        while sum(len(v) for v in
                  svc.dispatcher._worker_cache.values()) < len(splits):
            assert time.monotonic() < deadline, "cache never advertised"
            time.sleep(0.05)
        feed2 = ServiceFeed(svc.addr, splits, job_name="warm",
                            mode=SHARD_DYNAMIC, timeout=30.0)
        try:
            assert sorted(_drain_ids(feed2)) == sorted(r[0] for r in rows)
            client = DispatcherClient(svc.addr)
            status = client.status("warm")
            client.close()
            assert status["affinity_total"] == len(splits)
            assert status["affinity_hits"] >= 1
            snap = feed2.counters_snapshot()
            assert snap["dataservice_cache_hit"] > 0
            assert snap["dataservice_affinity_total"] == len(splits)
            assert snap["dataservice_affinity_hits"] == \
                status["affinity_hits"]
            assert 0 < snap["dataservice_affinity_hit_pct_max"] <= 100.0
        finally:
            feed2.terminate()


def test_frame_cache_spill_bytes_and_cached_paths(tmp_path):
    """Spill accounting and the advertisement view: spilled bytes tally
    (and drain once via take_spill_bytes for the per-split report), and
    cached_paths() lists resident AND spilled sources — a spilled entry
    is still a cheap local re-serve, so affinity should still steer to
    it."""
    from tensorflowonspark_torch.dataservice import _FrameCache

    cache = _FrameCache(max_bytes=150, spill_dir=str(tmp_path / "spill"))
    cache.put("a", "zlib", None, _frames(100))
    cache.put("b", "zlib", None, _frames(100))  # a evicts → spills to disk
    assert cache.spills == 1
    assert cache.spill_bytes >= 100
    assert cache.cached_paths() == ["a", "b"]
    taken = cache.take_spill_bytes()
    assert taken == cache.spill_bytes
    assert cache.take_spill_bytes() == 0        # drained exactly once
    flat = cache.counters_flat()
    assert flat["dataservice_cache_spill_bytes"] == cache.spill_bytes


_HOST_ONLY = """
import json, os, sys, tempfile
sys.path.insert(0, {repo!r})
from tensorflowonspark_torch import data, dataservice
tmp = tempfile.mkdtemp()
splits = []
for s in range(3):
    path = os.path.join(tmp, "s%d.jsonl" % s)
    with open(path, "w") as f:
        for i in range(s * 10, s * 10 + 10):
            f.write(json.dumps([i, [float(i % 7)] * 64]) + "\\n")
    splits.append(path)
disp = dataservice.DispatcherServer(heartbeat_interval=0.2, host="127.0.0.1")
addr = disp.start()
worker = dataservice.FeedWorker(addr, row_reader=data.jsonl_rows,
                                heartbeat_interval=0.2).start()
feed = dataservice.ServiceFeed(addr, splits, mode=dataservice.SHARD_DYNAMIC,
                               codecs=["zlib"], timeout=20.0)
n = 0
while not feed.should_stop():
    n += feed.next_batch_arrays(16)[1]
snap = feed.counters_snapshot()
feed.terminate(); worker.stop(); disp.stop()
print(json.dumps({{"rows": n, "ratio": snap.get("wire_compress_ratio_max"),
                   "torch": "torch" in sys.modules}}))
"""


def test_compressed_feed_counters_import_no_torch():
    """A data-service process (dispatcher, worker, consumer) imports no
    torch, even once its counters report the wire's compression ratio:
    the port's ``metrics`` module imports torch and registers the flash
    ops, and a scrape thread that imported it raced another import of it
    (``operator tfos::flash_bwd_dkv does not exist``)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _HOST_ONLY.format(repo=repo)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rows"] == 30 and out["ratio"] > 1.0
    assert out["torch"] is False
