"""The JAX package's manager and DataFeed tests (``tests/test_datafeed.py``),
re-pointed at the port's copies of ``manager``, ``marker`` and ``datafeed``."""

import pytest

from tensorflowonspark_torch import manager, marker
from tensorflowonspark_torch.datafeed import DataFeed, absolute_path


@pytest.fixture
def mgr():
    m = manager.start(b"test-authkey", ["input", "output", "error"])
    yield m
    m.shutdown()


def _feed(m, items, end_of_feed=True):
    q = m.get_queue("input")
    for item in items:
        q.put(item)
    if end_of_feed:
        q.put(None)


class TestDataFeed:
    def test_full_and_partial_batches(self, mgr):
        # Reference test_TFNode.py:27-58 — partial final batch + end-of-feed.
        _feed(mgr, list(range(10)))
        feed = DataFeed(mgr)
        batch = feed.next_batch(4)
        assert batch == [0, 1, 2, 3]
        assert not feed.should_stop()
        assert feed.next_batch(4) == [4, 5, 6, 7]
        assert feed.next_batch(4) == [8, 9]  # partial: end-of-feed hit
        assert feed.should_stop()

    def test_end_partition_alignment(self, mgr):
        q = mgr.get_queue("input")
        for i in range(3):
            q.put(i)
        q.put(marker.EndPartition())
        for i in range(3, 5):
            q.put(i)
        q.put(None)
        feed = DataFeed(mgr, train_mode=False)
        # batch stops early at the partition boundary (reference TFNode.py:135-140)
        assert feed.next_batch(10) == [0, 1, 2]
        assert feed.next_batch(10) == [3, 4]
        assert feed.should_stop()

    def test_input_mapping_columns(self, mgr):
        _feed(mgr, [(1, "a"), (2, "b")])
        feed = DataFeed(mgr, input_mapping={"col_x": "x", "col_y": "y"})
        batch = feed.next_batch(2)
        # columns keyed by tensor name, ordered by sorted column name
        assert batch == {"x": [1, 2], "y": ["a", "b"]}

    def test_next_batch_arrays(self, mgr):
        _feed(mgr, [([1.0, 2.0], 3), ([4.0, 5.0], 6)])
        feed = DataFeed(mgr, input_mapping={"a_features": "x", "b_label": "y"})
        arrays, count = feed.next_batch_arrays(2)
        assert count == 2
        assert arrays["x"].shape == (2, 2)
        assert arrays["y"].tolist() == [3, 6]

    def test_batch_results_roundtrip(self, mgr):
        feed = DataFeed(mgr, train_mode=False)
        feed.batch_results([10, 20, 30])
        out = mgr.get_queue("output")
        chunk = out.get()  # whole batch travels as one Chunk
        assert isinstance(chunk, marker.Chunk)
        assert chunk.items == [10, 20, 30]

    def test_chunked_feed_transparent(self, mgr):
        # Feeders send Chunk blocks; consumers still see items, and markers
        # (EndPartition / None) keep their alignment semantics.
        q = mgr.get_queue("input")
        q.put(marker.Chunk([0, 1, 2]))
        q.put(marker.Chunk([3, 4]))
        q.put(marker.EndPartition())
        q.put(marker.Chunk([5, 6]))
        q.put(None)
        feed = DataFeed(mgr)
        assert feed.next_batch(4) == [0, 1, 2, 3]
        assert feed.next_batch(4) == [4]       # stops at partition boundary
        assert feed.next_batch(4) == [5, 6]    # then end-of-feed
        assert feed.should_stop()

    def test_terminate_drains(self, mgr):
        _feed(mgr, list(range(50)))
        feed = DataFeed(mgr)
        feed.next_batch(5)
        feed.terminate()
        assert mgr.get("state") == "terminating"
        q = mgr.get_queue("input")
        assert q.qsize() == 0  # drained through the end-of-feed marker

    def test_terminate_survives_dead_manager(self, mgr):
        # Cluster shutdown can kill the manager while (or just before) a
        # node drains in terminate(); a dead manager means there is
        # nothing left to drain — terminate must finish quietly, not
        # surface EOFError/BrokenPipeError as a user-code failure.  The
        # feed must hold a CONNECTED proxy (the executor's view) whose
        # server dies under it — that's the production shape of the race.
        # (The fixture's teardown shutdown is a no-op second Finalize.)
        client = manager.connect(mgr.address, b"test-authkey")
        _feed(mgr, list(range(10)))
        feed = DataFeed(client)
        feed.next_batch(2)
        mgr.shutdown()
        feed.terminate()  # must not raise

    def test_terminate_survives_manager_dying_mid_drain(self, mgr):
        # Same race one window later: the pre-loop calls succeed, then the
        # manager dies under the drain loop's queue.get.
        _feed(mgr, list(range(5)), end_of_feed=False)
        feed = DataFeed(mgr)
        feed.next_batch(2)

        class _DyingQueue:
            def __init__(self, inner, mgr_to_kill):
                self._inner, self._mgr = inner, mgr_to_kill

            def get(self, *a, **k):
                self._mgr.shutdown()
                raise EOFError  # what the dead proxy raises

            def task_done(self):
                pass

        real_get_queue = mgr.get_queue
        mgr.get_queue = lambda name: _DyingQueue(real_get_queue(name), mgr)
        feed.terminate()  # must not raise


class TestManager:
    def test_kv_state(self, mgr):
        mgr.set("state", "running")
        assert mgr.get("state") == "running"

    def test_connect_local(self, mgr):
        m2 = manager.connect(mgr.address, b"test-authkey")
        m2.get_queue("input").put("hello")
        assert mgr.get_queue("input").get() == "hello"

    def test_remote_mode_tcp(self):
        m = manager.start(b"remote-key", ["control"], mode="remote")
        host, port = m.address
        assert isinstance(port, int) and port > 0
        m2 = manager.connect(("127.0.0.1", port), b"remote-key")
        m2.get_queue("control").put(None)
        assert m.get_queue("control").get() is None
        m.shutdown()


class TestAbsolutePath:
    """Path normalization matrix (reference ``test/test_TFNode.py:8-25``)."""

    def _ctx(self, default_fs, working_dir="/wd"):
        return type("MockContext", (), {
            "default_fs": default_fs, "working_dir": working_dir})()

    def test_schemes_passthrough(self):
        ctx = self._ctx("file://")
        for p in ("file:///tmp/x", "hdfs://nn/x", "gs://bucket/x",
                  "viewfs://cl/x", "s3://b/x"):
            assert absolute_path(ctx, p) == p

    def test_absolute_local(self):
        ctx = self._ctx("file://")
        assert absolute_path(ctx, "/tmp/x") == "file:///tmp/x"

    def test_relative_local_uses_working_dir(self):
        ctx = self._ctx("file://", working_dir="/wd")
        assert absolute_path(ctx, "model") == "file:///wd/model"

    def test_relative_hdfs_user_home(self):
        import getpass

        ctx = self._ctx("hdfs://namenode:8020")
        assert absolute_path(ctx, "model") == \
            "hdfs://namenode:8020/user/{}/model".format(getpass.getuser())

    def test_absolute_on_hdfs_fs(self):
        ctx = self._ctx("hdfs://nn:8020")
        assert absolute_path(ctx, "/data/x") == "/data/x"


class TestColumnarPlane:
    """The columnar data plane: ColChunk packing at the feeder, zero-object
    consumption in next_batch_arrays, row compat in next_batch."""

    def test_pack_columnar_tuple_rows(self):
        import numpy as np

        block = [(np.arange(4, dtype=np.float32) + i, i) for i in range(6)]
        ck = marker.pack_columnar(block)
        assert isinstance(ck, marker.ColChunk)
        assert ck.count == 6 and ck.tuple_rows
        assert ck.columns[0].shape == (6, 4)
        assert ck.columns[1].tolist() == list(range(6))
        img, lab = ck.row(2)
        assert lab == 2 and img.tolist() == [2.0, 3.0, 4.0, 5.0]

    def test_pack_columnar_vector_list_rows(self):
        # A [1.0, 2.0] list row is a length-2 vector, not two fields.
        ck = marker.pack_columnar([[1.0, 2.0], [3.0, 4.0]])
        assert ck.count == 2 and not ck.tuple_rows
        assert ck.columns[0].shape == (2, 2)

    def test_pack_columnar_ragged_falls_back(self):
        import numpy as np

        assert marker.pack_columnar(
            [(np.zeros(3),), (np.zeros(4),)]) is None
        assert marker.pack_columnar([]) is None

    def test_next_batch_unpacks_colchunk_rows(self, mgr):
        import numpy as np

        q = mgr.get_queue("input")
        q.put(marker.pack_columnar([(np.full(2, i, np.float32), i)
                                    for i in range(5)]))
        q.put(None)
        feed = DataFeed(mgr)
        batch = feed.next_batch(3)
        assert [int(lab) for _, lab in batch] == [0, 1, 2]
        batch = feed.next_batch(3)
        assert [int(lab) for _, lab in batch] == [3, 4]
        assert feed.should_stop()

    def test_next_batch_arrays_columnar_native(self, mgr):
        import numpy as np

        q = mgr.get_queue("input")
        for start in (0, 4):
            q.put(marker.pack_columnar(
                [(np.full(3, i, np.float32), i) for i in range(start, start + 4)]))
        q.put(None)
        feed = DataFeed(mgr)
        arrays, count = feed.next_batch_arrays(6)  # spans chunk boundary
        assert count == 6
        x, y = arrays
        assert x.shape == (6, 3) and y.tolist() == [0, 1, 2, 3, 4, 5]
        arrays, count = feed.next_batch_arrays(6)  # partial tail + end of feed
        assert count == 2
        assert arrays[1].tolist() == [6, 7]
        assert feed.should_stop()

    def test_next_batch_arrays_mixed_chunk_kinds(self, mgr):
        import numpy as np

        q = mgr.get_queue("input")
        q.put(marker.pack_columnar([(np.zeros(2, np.float32), 0),
                                    (np.ones(2, np.float32), 1)]))
        q.put(marker.Chunk([(np.full(2, 2.0, np.float32), 2)]))  # object chunk
        q.put((np.full(2, 3.0, np.float32), 3))                  # loose item
        q.put(None)
        feed = DataFeed(mgr, input_mapping={"a_img": "x", "b_lab": "y"})
        arrays, count = feed.next_batch_arrays(10)
        assert count == 4
        assert arrays["x"].shape == (4, 2)
        assert arrays["y"].tolist() == [0, 1, 2, 3]

    def test_next_batch_arrays_dtype_cast(self, mgr):
        import numpy as np

        q = mgr.get_queue("input")
        q.put(marker.pack_columnar([(np.zeros(2, np.uint8), 1)] * 3))
        q.put(None)
        feed = DataFeed(mgr)
        (x, y), count = feed.next_batch_arrays(3, dtypes=[np.float32, np.int32])
        assert x.dtype == np.float32 and y.dtype == np.int32

    def test_end_partition_respected_on_arrays_path(self, mgr):
        import numpy as np

        q = mgr.get_queue("input")
        q.put(marker.pack_columnar([(np.zeros(1, np.float32), i)
                                    for i in range(3)]))
        q.put(marker.EndPartition())
        q.put(marker.pack_columnar([(np.zeros(1, np.float32), i)
                                    for i in range(3, 5)]))
        q.put(None)
        feed = DataFeed(mgr, train_mode=False)
        _, count = feed.next_batch_arrays(10)
        assert count == 3                       # stops at partition boundary
        arrays, count = feed.next_batch_arrays(10)
        assert count == 2 and arrays[1].tolist() == [3, 4]


def test_assemble_columns_module_function():
    """``datafeed.assemble_columns`` (``tests/test_dataservice.py``'s
    datafeed case, re-pointed here with the port's datafeed tests)."""
    import numpy as np

    from tensorflowonspark_torch.datafeed import assemble_columns

    # empty parts honor the input_tensors shape contract
    empty = assemble_columns([], True, None, None)
    assert empty.shape == (0,)
    assert set(assemble_columns([], True, None, ["x"])) == {"x"}
    parts = [(np.arange(3), np.ones(3)), (np.arange(3, 5), np.ones(2))]
    out = assemble_columns(parts, True, None, None)
    assert isinstance(out, tuple) and out[0].shape == (5,)
    named = assemble_columns(parts, True, None, ["x", "y"])
    np.testing.assert_array_equal(named["x"], np.arange(5))
    with pytest.raises(ValueError, match="fields"):
        assemble_columns(parts, True, None, ["only_one"])
