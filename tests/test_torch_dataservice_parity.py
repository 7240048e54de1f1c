"""The port's data service against the JAX package's, on the CPU: the same
bytes on the wire, the same ledger and the same journal.

- A JAX ``ServiceFeed`` drains a port ``FeedWorker`` (behind a port
  dispatcher), and a port ``ServiceFeed`` drains a JAX ``FeedWorker``
  (behind a JAX dispatcher): the same rows, in the same dtypes, as each
  package's own consumer reads.
- One op sequence on the port's ``_Job`` and on the JAX one gives equal
  ``to_state()``, and each side's state loads in the other.
- A journal written by one package's dispatcher recovers the same ledger
  in the other's (both directions).
- STATIC sharding with one worker gives ``next_batch_arrays`` batches equal
  to the JAX consumer's, batch by batch.

Tests import both packages; the port itself imports no jax."""

import json
import os
import shutil
import time

import numpy as np
import pytest

from tensorflowonspark_torch import data as t_data
from tensorflowonspark_torch import dataservice as t_ds


def _jax_ds():
    from tensorflowonspark_tpu import data as j_data
    from tensorflowonspark_tpu import dataservice as j_ds

    return j_data, j_ds


def _write_rows(dirpath, n_splits, per_split):
    """jsonl splits of ``[id, [64 floats], label]`` rows: an int column, a
    wide float column (colv1-framed, zlib-worthy) and a float column."""
    splits, ids = [], []
    for s in range(n_splits):
        path = os.path.join(str(dirpath), "split-{:03d}.jsonl".format(s))
        with open(path, "w") as f:
            for i in range(s * per_split, (s + 1) * per_split):
                ids.append(i)
                f.write(json.dumps([i, [float(i % 7) * 0.5] * 64,
                                    i / 3.0]) + "\n")
        splits.append(path)
    return splits, ids


def _drain_batches(feed, batch_size=16, timeout=30.0):
    """Every ``next_batch_arrays`` batch of a feed, as tuples of arrays."""
    out = []
    deadline = time.monotonic() + timeout
    while not feed.should_stop():
        assert time.monotonic() < deadline, "feed did not complete"
        arrays, count = feed.next_batch_arrays(batch_size)
        if count:
            out.append(tuple(np.asarray(a) for a in arrays))
    return out


def _serve(ds, data_mod, n_workers=1, cache_bytes=None, **disp_kwargs):
    """``(dispatcher, addr, workers)`` of one package."""
    disp = ds.DispatcherServer(heartbeat_interval=0.2, heartbeat_misses=3,
                               host="127.0.0.1", **disp_kwargs)
    addr = disp.start()
    workers = [ds.FeedWorker(addr, row_reader=data_mod.jsonl_rows,
                             worker_id="w{}".format(i),
                             heartbeat_interval=0.2,
                             cache_bytes=cache_bytes).start()
               for i in range(n_workers)]
    return disp, addr, workers


def _stop(disp, workers):
    for w in workers:
        w.stop()
    disp.stop()


def _rows_of(batches):
    """``{id: (payload, label)}`` and the per-column dtypes of batches."""
    rows, dtypes = {}, None
    for cols in batches:
        kinds = tuple(c.dtype for c in cols)
        assert dtypes in (None, kinds)
        dtypes = kinds
        for i, payload, label in zip(*cols):
            assert int(i) not in rows
            rows[int(i)] = (tuple(np.asarray(payload).tolist()),
                            float(label))
    return rows, dtypes


@pytest.mark.parametrize("server", ["torch", "jax"])
def test_cross_package_stream_same_rows_and_dtypes(server, tmp_path):
    """A consumer of the OTHER package drains a job that this package's
    dispatcher and worker serve, with zlib negotiated on the wire: the
    rows and column dtypes equal what the serving package's own consumer
    reads from the same splits."""
    j_data, j_ds = _jax_ds()
    splits, ids = _write_rows(tmp_path, 6, 20)
    srv_ds, srv_data = (t_ds, t_data) if server == "torch" else (j_ds, j_data)
    cli_ds = j_ds if server == "torch" else t_ds
    disp, addr, workers = _serve(srv_ds, srv_data, n_workers=2)
    try:
        results = {}
        for name, ds in (("same", srv_ds), ("other", cli_ds)):
            feed = ds.ServiceFeed(addr, splits, job_name="x-" + name,
                                  mode=srv_ds.SHARD_DYNAMIC,
                                  codecs=["zlib"], timeout=30.0)
            try:
                results[name] = _rows_of(_drain_batches(feed))
                assert feed.split_dupes == 0
                # the zlib codec was negotiated across the packages
                assert feed.wire_formats.get("colv1+zlib", 0) > 0, \
                    feed.wire_formats
            finally:
                feed.terminate()
        (same, same_dt), (other, other_dt) = results["same"], results["other"]
        assert sorted(other) == sorted(same) == ids
        assert other == same
        assert other_dt == same_dt
    finally:
        _stop(disp, workers)


def _job_ops(ds):
    """One op sequence on a package's ``_Job``: attach two consumers, hand
    out, commit, lose a split, record a reader error, kill a worker,
    detach a consumer; returns the job."""
    job = ds._Job("j", ["a", "b", "c", "d", "e"], 2, ds.SHARD_DYNAMIC)
    job.attach("c0")
    job.attach("c1")
    live = {"w0", "w1"}
    job.next_splits("w0", "c0", live)              # a -> w0/c0
    job.next_splits("w1", "c1", live)              # b -> w1/c1
    job.complete(0, 0, "c0")                       # a committed
    job.next_splits("w0", "c0", live)              # c -> w0/c0
    job.release_split(0, 2, "w0", "c0")            # c LOST, re-pooled
    job.next_splits("w1", "c1", live)              # d -> w1/c1
    job.record_split_error(0, 3, "w1", "c1", "bad record")
    job.release_worker("w1", {"w0"})               # b re-pooled for c1
    job.detach("c1")
    job.next_splits("w0", "c0", {"w0"})
    return job


def test_job_state_equal_after_the_same_ops():
    """The same ops give the same ledger state on both sides, and each
    side's state loads in the other to the same state."""
    _, j_ds = _jax_ds()
    t_state = json.loads(json.dumps(_job_ops(t_ds).to_state()))
    j_state = json.loads(json.dumps(_job_ops(j_ds).to_state()))
    assert t_state == j_state

    def reloaded(ds, state):
        return json.loads(json.dumps(ds._Job.from_state(state).to_state()))

    assert reloaded(t_ds, j_state) == j_state
    assert reloaded(j_ds, t_state) == t_state
    for mode in ("off", "static"):
        t_job = t_ds._Job("m", ["a", "b", "c"], 1, mode)
        j_job = j_ds._Job("m", ["a", "b", "c"], 1, mode)
        for job in (t_job, j_job):
            job.attach("c0")
            job.next_splits("w0", "c0", {"w0", "w1"})
            job.next_splits("w1", "c0", {"w0", "w1"})
        assert t_job.to_state() == j_job.to_state()


def _journal_ops(addr, ds):
    """Register a worker and a two-epoch job, commit one split and leave
    one in flight."""
    client = ds.DispatcherClient(addr)
    client.register_worker("w", "127.0.0.1", 1)
    client.register_job("j", ["s0", "s1", "s2"], num_epochs=2,
                        consumer_id="c0")
    assert client.request_task("j", "w", "c0")["splits"] == [[0, "s0"]]
    client.done_split("j", 0, 0, "c0")
    assert client.request_task("j", "w", "c0")["splits"] == [[1, "s1"]]
    client.close()


def _crash(disp):
    """SIGKILL analogue: drop the listen socket, leave the journal tail as
    it is, and wait for the listener thread to let the port go."""
    disp._stopping = True
    disp._socket.close()
    disp._thread.join(timeout=5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_recovers_in_the_other_package(writer, tmp_path):
    """A journal written by one package's dispatcher (snapshots and the
    record tail) recovers the same ledger in the other's as in its own:
    committed splits stay committed, the in-flight split re-pools for its
    consumer and a fresh worker is handed it."""
    _, j_ds = _jax_ds()
    w_ds, r_ds = (j_ds, t_ds) if writer == "jax" else (t_ds, j_ds)
    jdir = str(tmp_path / "journal")
    disp = w_ds.DispatcherServer(heartbeat_interval=0, host="127.0.0.1",
                                 journal_dir=jdir, snapshot_every=2)
    _journal_ops(disp.start(), w_ds)
    _crash(disp)
    shutil.copytree(jdir, str(tmp_path / "journal-own"))
    states = {}
    for name, ds, d in (("own", w_ds, str(tmp_path / "journal-own")),
                        ("other", r_ds, jdir)):
        disp2 = ds.DispatcherServer(heartbeat_interval=0, host="127.0.0.1",
                                    journal_dir=d)
        addr2 = disp2.start()
        try:
            assert disp2.recovered_jobs == 1
            states[name] = disp2._jobs["j"].to_state()
            client = ds.DispatcherClient(addr2)
            status = client.status("j")
            assert status["completed"] == 1
            assert status["assigned"] == 0 and status["pending"] == 1
            client.register_worker("w2", "127.0.0.1", 2)
            assert client.request_task("j", "w2", "c0")["splits"] == \
                [[1, "s1"]]
            client.close()
        finally:
            disp2.stop()
    assert states["other"] == states["own"]


def test_static_one_worker_batches_equal_jax(tmp_path):
    """STATIC sharding with one worker: the port's consumer hands out the
    same ``next_batch_arrays`` batches as the JAX consumer, batch by batch,
    each package on its own dispatcher and worker."""
    j_data, j_ds = _jax_ds()
    splits, ids = _write_rows(tmp_path, 5, 12)
    out = {}
    for name, ds, data_mod in (("torch", t_ds, t_data),
                               ("jax", j_ds, j_data)):
        disp, addr, workers = _serve(ds, data_mod, n_workers=1)
        try:
            feed = ds.ServiceFeed(addr, splits, job_name="static",
                                  mode=ds.SHARD_STATIC, timeout=30.0)
            try:
                out[name] = _drain_batches(feed, batch_size=7)
                assert feed.splits_committed == len(splits)
            finally:
                feed.terminate()
        finally:
            _stop(disp, workers)
    assert len(out["torch"]) == len(out["jax"])
    for t_cols, j_cols in zip(out["torch"], out["jax"]):
        assert len(t_cols) == len(j_cols)
        for t_col, j_col in zip(t_cols, j_cols):
            assert t_col.dtype == j_col.dtype
            np.testing.assert_array_equal(t_col, j_col)
    assert sorted(int(i) for cols in out["torch"] for i in cols[0]) == ids
