"""The JAX package's backend tests (``tests/test_backend.py``), re-pointed at
the port's copy of ``backend``."""

import os

import pytest

from tensorflowonspark_torch import backend


def test_partition_even_spread():
    assert backend.partition(range(10), 3) == [[0, 1, 2], [3, 4, 5], [6, 7, 8, 9]]
    assert backend.partition([], 2) == [[], []]
    assert backend.partition([1], 3) == [[], [], [1]]


@pytest.fixture(scope="module")
def local_backend():
    b = backend.LocalBackend(2)
    yield b
    b.stop()


def test_map_partitions(local_backend):
    parts = backend.partition(range(8), 4)
    results = local_backend.map_partitions(parts, lambda it: [x * x for x in it])
    assert results == [[0, 1], [4, 9], [16, 25], [36, 49]]


def test_task_error_propagates(local_backend):
    def boom(it):
        raise ValueError("injected failure")

    with pytest.raises(RuntimeError, match="injected failure"):
        local_backend.foreach_partition([[1]], boom)


def test_executors_persist_across_jobs(local_backend):
    """State written by one job is visible to the next on the same executor —
    the property the executor-id handshake relies on (reference
    ``util.py:66-75``, ``test/README.md:10``)."""

    def write_marker(it):
        import time

        with open("marker.txt", "w") as f:
            f.write(str(os.getpid()))
        # Hold the task slot briefly so the second task must use the other
        # executor (cluster start tasks get this for free from the rendezvous
        # barrier; see node.run).
        time.sleep(1.0)
        return [os.getcwd()]

    def read_marker(it):
        with open("marker.txt") as f:
            return [(os.getcwd(), f.read())]

    cwds = [r[0] for r in
            local_backend.map_partitions([[0], [1]], write_marker)]
    assert len(set(cwds)) == 2  # each executor has its own working dir
    seen = [r[0][0] for r in local_backend.map_partitions([[0], [1]], read_marker)]
    assert sorted(seen) == sorted(cwds)


def test_async_job_handle(local_backend):
    handle = local_backend.foreach_partition_async(
        [[1], [2]], lambda it: [sum(it)])
    results = handle.wait(timeout=30)
    assert sorted(r[0] for r in results) == [1, 2]
    assert handle.done()


def test_more_partitions_than_executors(local_backend):
    parts = backend.partition(range(12), 6)
    results = local_backend.map_partitions(parts, lambda it: [sum(it)])
    assert [r[0] for r in results] == [1, 5, 9, 13, 17, 21]


def test_large_result_arrives_whole(local_backend):
    """A result of tens of MB (the shape of a transform's Python-float
    rows) comes back equal through the driver's one-buffer read."""
    def big(it):
        import numpy as np

        return [np.arange(n * 1_000_000, dtype=np.float32).tolist()
                for n in it]

    (got,) = local_backend.map_partitions([[3]], big)
    assert len(got) == 1 and len(got[0]) == 3_000_000
    assert got[0][:3] == [0.0, 1.0, 2.0] and got[0][-1] == 2_999_999.0


@pytest.mark.parametrize("long_header", [False, True])
def test_recv_result_reads_both_length_headers(long_header):
    """``Connection.send``'s framing: a ``!i`` length, or -1 and a ``!Q``
    length (messages of 2 GiB and more)."""
    import multiprocessing
    import pickle
    import struct

    a, b = multiprocessing.Pipe()
    payload = (7, True, list(range(2000)))
    try:
        if long_header:
            data = pickle.dumps(payload)
            os.write(b.fileno(), struct.pack("!i", -1)
                     + struct.pack("!Q", len(data)))
            view = memoryview(data)
            while view:
                view = view[os.write(b.fileno(), view):]
        else:
            b.send(payload)
        assert backend._recv_result(a) == payload
    finally:
        a.close()
        b.close()
