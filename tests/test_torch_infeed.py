"""The port's ShardedFeed against the JAX package's: the same rows through a
stub feed give the same batches and masks (padded tails, dropped tails,
both assembly paths, with and without prefetch); the uneven-partition
drain modes across two gloo processes; the counters' names; terminate();
and no silent fall back to the CPU."""

import time

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.parallel import build_mesh
from tensorflowonspark_tpu.parallel.infeed import ShardedFeed as JaxShardedFeed
from tensorflowonspark_torch import manager
from tensorflowonspark_torch.datafeed import DataFeed
from tensorflowonspark_torch.parallel.infeed import ShardedFeed

from torch_world import run_world

GLOBAL_BATCH = 8


class StubFeed(object):
    """Rows ``(x[3], label)`` served like a DataFeed: ``should_stop`` turns
    true once a read asked for more rows than were left."""

    def __init__(self, rows):
        self.rows = list(rows)
        self.pos = 0
        self.done = False
        self.terminated = False

    def next_batch(self, n):
        items = self.rows[self.pos:self.pos + n]
        self.pos += len(items)
        if len(items) < n:
            self.done = True
        return items

    def next_batch_arrays(self, n):
        items = self.next_batch(n)
        xs = np.asarray([r[0] for r in items], np.float32).reshape(-1, 3)
        labels = np.asarray([r[1] for r in items], np.int64)
        return (xs, labels), len(items)

    def should_stop(self):
        return self.done

    def interrupt(self):
        pass

    def terminate(self):
        self.terminated = True


def _rows(n, offset=0):
    return [([float(i), 2.0 * i, -1.0 * i], (i + offset) % 10)
            for i in range(offset, offset + n)]


def _columnar(arrays):
    return {"x": arrays[0] * 0.5, "label": arrays[1]}


def _row_list(items):
    return {"x": np.asarray([r[0] for r in items], np.float32),
            "label": np.asarray([r[1] for r in items], np.int64)}


def _as_numpy(batches):
    return [({k: np.asarray(v) for k, v in b.items()}, np.asarray(m))
            for b, m in batches]


@pytest.mark.parametrize("n_rows", [16, 12, 5])
@pytest.mark.parametrize("pad_final", [True, False])
@pytest.mark.parametrize("path", ["transform", "preprocess"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_batches_match_jax(n_rows, pad_final, path, prefetch):
    kwargs = ({"transform": _columnar} if path == "transform"
              else {"preprocess": _row_list})
    want = _as_numpy(JaxShardedFeed(
        StubFeed(_rows(n_rows)), build_mesh(), GLOBAL_BATCH,
        pad_final=pad_final, prefetch=prefetch, **kwargs).batches())
    got = _as_numpy(ShardedFeed(
        StubFeed(_rows(n_rows)), GLOBAL_BATCH, pad_final=pad_final,
        prefetch=prefetch, device="cpu", **kwargs).batches())
    assert len(got) == len(want)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gm.dtype == np.float32 and np.array_equal(gm, wm)
        assert set(gb) == set(wb)
        for k in gb:
            assert gb[k].shape == wb[k].shape
            assert np.array_equal(gb[k], wb[k]), k
    # every row once, padded rows masked out
    rows = sum(int(m.sum()) for _, m in got)
    assert rows == (n_rows if pad_final
                    else n_rows - n_rows % GLOBAL_BATCH)


def test_counters_have_the_jax_keys():
    jax_feed = JaxShardedFeed(StubFeed(_rows(12)), build_mesh(), GLOBAL_BATCH,
                              transform=_columnar, prefetch=0)
    feed = ShardedFeed(StubFeed(_rows(12)), GLOBAL_BATCH, transform=_columnar,
                       prefetch=0, device="cpu")
    list(feed.batches())
    snap = feed.counters_snapshot()
    assert set(snap) == set(jax_feed.counters_snapshot())
    assert snap["infeed_batches"] == 2
    assert snap["infeed_prefetch_depth_max"] == 0
    assert feed.apply_knob("infeed_prefetch", 3) is True
    assert feed.counters_snapshot()["infeed_prefetch_depth_max"] == 3
    # grouped batches are ported (tests/test_torch_megastep.py holds them
    # against the JAX package's): the knob is claimed, groups come out
    assert feed.apply_knob("train_steps_per_call", 4) is True
    grouped = ShardedFeed(StubFeed(_rows(16)), GLOBAL_BATCH,
                          transform=_columnar, prefetch=0, device="cpu")
    out = list(grouped.grouped_batches(2))
    assert [kind for kind, _, _ in out] == ["multi"]
    assert out[0][1]["x"].shape == (2, GLOBAL_BATCH, 3)


def test_prefetch_depth_from_env(monkeypatch):
    monkeypatch.setenv("TFOS_INFEED_PREFETCH", "5")
    feed = ShardedFeed(StubFeed([]), GLOBAL_BATCH, device="cpu")
    assert feed.counters_snapshot()["infeed_prefetch_depth_max"] == 5


def test_no_card_and_no_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedFeed(StubFeed([]), GLOBAL_BATCH)


def test_global_batch_must_split():
    # a single process: any batch splits; the check is the world's
    feed = ShardedFeed(StubFeed([]), 7, device="cpu")
    assert feed.local_batch_size == 7


def _drain(rank, drain):
    rows = _rows(20 if rank == 0 else 12, offset=100 * rank)
    feed = ShardedFeed(StubFeed(rows), 16, transform=_columnar, prefetch=2,
                       device="cpu")
    return [(int(m.sum()), batch["label"].tolist())
            for batch, m in feed.batches(drain=drain)]


@pytest.mark.parametrize("drain,want_counts", [
    # any: stop when any host runs out; rank 0's 4-row tail drops
    ("any", ([8, 8], [8, 4])),
    # all: run until every host is out; rank 1 steps with a zero mask
    ("all", ([8, 8, 4], [8, 4, 0])),
])
def test_drain_on_uneven_partitions(drain, want_counts):
    ranks = run_world(_drain, 2, drain)
    for rank, (steps, want) in enumerate(zip(ranks, want_counts)):
        assert [count for count, _ in steps] == list(want)
        # every real row is the rank's own, in order
        real = [lab for count, labels in steps for lab in labels[:count]]
        first = [(i + 100 * rank) % 10
                 for i in range(100 * rank, 100 * rank + len(real))]
        assert real == first
    if drain == "all":   # the dummy repeats the last real batch, masked
        assert ranks[1][2][1] == ranks[1][1][1]


@pytest.fixture
def mgr():
    m = manager.start(b"torch-infeed-test", ["input", "output", "error"])
    yield m
    m.shutdown()


def test_datafeed_partial_tail_and_stop(mgr):
    q = mgr.get_queue("input")
    for i in range(12):
        q.put([float(i)])
    q.put(None)
    feed = ShardedFeed(DataFeed(mgr), GLOBAL_BATCH, prefetch=2, device="cpu")
    out = list(feed.batches())
    assert [int(m.sum()) for _, m in out] == [8, 4]
    assert out[1][0].shape == (8, 1)
    assert out[1][0][:4, 0].tolist() == [8.0, 9.0, 10.0, 11.0]


def test_terminate_stops_the_prefetch_thread(mgr):
    q = mgr.get_queue("input")
    for i in range(8):       # exactly one batch, no end marker
        q.put([float(i)])
    feed = ShardedFeed(DataFeed(mgr), GLOBAL_BATCH, prefetch=2, device="cpu")
    gen = feed.batches()
    next(gen)                # the prefetch thread now blocks on the queue
    time.sleep(0.3)
    t0 = time.monotonic()
    feed.terminate()
    assert time.monotonic() - t0 < 10
    thread = feed._prefetch_thread
    assert thread is not None and not thread.is_alive()
    gen.close()
    assert mgr.get("state") == "terminating"
