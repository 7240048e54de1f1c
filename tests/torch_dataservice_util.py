"""Shared helpers of the port's data-service tests (the helpers of
``tests/test_dataservice.py``, on ``tensorflowonspark_torch``)."""

import json
import os
import time

from tensorflowonspark_torch import data
from tensorflowonspark_torch.dataservice import DispatcherServer, FeedWorker


def _write_jsonl(dirpath, n_splits, per_split, row_fn=None):
    """``n_splits`` jsonl files of ``per_split`` rows; returns
    ``(split_paths, all_rows)``.  Default rows are globally-unique ints
    (single-value rows → framable colv1 columns)."""
    row_fn = row_fn or (lambda i: i)
    splits, rows = [], []
    for s in range(n_splits):
        path = os.path.join(str(dirpath), "split-{:03d}.jsonl".format(s))
        with open(path, "w") as f:
            for i in range(s * per_split, (s + 1) * per_split):
                row = row_fn(i)
                rows.append(tuple(row) if isinstance(row, list) else row)
                f.write(json.dumps(row) + "\n")
        splits.append(path)
    return splits, rows


class _Service(object):
    """In-process dispatcher + N feed workers with fast heartbeats."""

    def __init__(self, n_workers=2, heartbeat=0.2, misses=2,
                 cache_bytes=None, **dispatcher_kwargs):
        self.dispatcher = DispatcherServer(heartbeat_interval=heartbeat,
                                           heartbeat_misses=misses,
                                           host="127.0.0.1",
                                           **dispatcher_kwargs)
        self.addr = self.dispatcher.start()
        self.workers = [
            FeedWorker(self.addr, row_reader=data.jsonl_rows,
                       worker_id="w{}".format(i),
                       heartbeat_interval=heartbeat,
                       cache_bytes=cache_bytes).start()
            for i in range(n_workers)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for w in self.workers:
            w.stop()
        self.dispatcher.stop()


def _drain(feed, batch_size=32, timeout=30.0):
    """All rows out of a feed via next_batch_arrays (single-value rows)."""
    got = []
    deadline = time.monotonic() + timeout
    while not feed.should_stop():
        assert time.monotonic() < deadline, "feed did not complete"
        arrays, count = feed.next_batch_arrays(batch_size)
        if count:
            got.extend(arrays.tolist())
    return got
