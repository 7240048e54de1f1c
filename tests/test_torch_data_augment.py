"""The port's FILES-mode data plane against the JAX package's: the copied
``data`` module (``list_shards``, ``shard_for_process`` with an explicit
index and count and from a ``torch.distributed`` world, the row streams of
``FileFeed`` and ``ProcessPoolFeed`` under the same seed, the LM readers,
``ShardedFeed`` over a ``FileFeed``), ``ops.augment.crop_and_flip``
against JAX ``ops.augment`` and against the host crop, and the ResNet
example's input module (``examples/resnet/imagenet_input_torch.py``):
``normalize_on_device`` and the JPEG and predecoded readers against
``examples/resnet/imagenet_input.py``.  The re-pointed cases of
``tests/test_data.py`` and ``tests/test_imagenet_input.py``."""

import os
import sys
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import data as data_mod
from tensorflowonspark_torch import dfutil
from tensorflowonspark_torch.ops import augment
from tensorflowonspark_torch.parallel.infeed import ShardedFeed

from torch_world import run_world

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "examples", "resnet"))
import imagenet_input_torch  # noqa: E402


@pytest.fixture
def shards(tmp_path):
    rows = dfutil.Rows([{"id": i, "val": float(i) * 0.5} for i in range(100)],
                       schema={"id": "int64", "val": "float32"})
    out = str(tmp_path / "tfr")
    dfutil.save_as_tfrecords(rows, out, num_shards=4)
    return out


def _drain(feed, batch_size=16):
    batches = []
    while not feed.should_stop():
        arrays, count = feed.next_batch_arrays(batch_size)
        if count == 0:
            break
        batches.append((arrays, count))
    return batches


def _ids(batches):
    return [int(v) for arrays, count in batches
            for v in np.asarray(arrays["id"])[:count]]


def test_list_shards_matches_jax(shards, tmp_path):
    from tensorflowonspark_tpu import data as jax_data

    assert data_mod.list_shards(shards) == jax_data.list_shards(shards)
    assert len(data_mod.list_shards(shards)) == 4
    # the *.tfrecord* fallback, a glob, a single file
    other = tmp_path / "other"
    other.mkdir()
    for name in ("b.tfrecord", "a.tfrecord.gz"):
        (other / name).write_bytes(b"")
    # ... and a path that matches nothing passes through as itself
    for path in (str(other), str(other / "*.tfrecord"),
                 str(other / "b.tfrecord"), str(tmp_path / "none" / "*")):
        assert data_mod.list_shards(path) == jax_data.list_shards(path)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        data_mod.list_shards(str(empty))


@pytest.mark.parametrize("index,count", [(0, 2), (1, 2), (2, 3), (3, 8)])
def test_shard_for_process_explicit_matches_jax(index, count):
    from tensorflowonspark_tpu import data as jax_data

    files = ["a", "b", "c", "d", "e"]
    assert data_mod.shard_for_process(files, index, count) == \
        jax_data.shard_for_process(files, index, count)
    # fewer files than processes: everyone reads everything (warned)
    assert data_mod.shard_for_process(["a"], index, max(count, 2)) == ["a"]


def _rank_shards(rank, files):
    return (data_mod.shard_for_process(files),
            data_mod.FileFeed(files, row_reader=lambda p: iter(())).files)


def test_shard_for_process_reads_the_torch_world():
    """No index given: the rank and world size of the torch.distributed
    world (the JAX package reads jax.process_index()); one process when
    none is up."""
    files = ["a", "b", "c", "d", "e"]
    assert data_mod.shard_for_process(files) == files
    ranks = run_world(_rank_shards, 2, files)
    assert ranks == [(["a", "c", "e"], ["a", "c", "e"]),
                     (["b", "d"], ["b", "d"])]


@pytest.mark.parametrize("shuffle,epochs", [(0, 1), (32, 1), (16, 3)])
def test_file_feed_stream_matches_jax(shards, shuffle, epochs):
    """One reader thread, the same seed: the port's FileFeed yields the JAX
    FileFeed's rows in the JAX FileFeed's order (file reshuffle per epoch,
    reservoir shuffle), batch by batch."""
    from tensorflowonspark_tpu import data as jax_data

    def make(mod):
        return mod.FileFeed(mod.list_shards(shards), shard=False,
                            shuffle_buffer=shuffle, num_epochs=epochs,
                            reader_threads=1, seed=7)

    got, want = _drain(make(data_mod), 30), _drain(make(jax_data), 30)
    assert [c for _, c in got] == [c for _, c in want]
    assert _ids(got) == _ids(want)
    assert sorted(_ids(got)) == sorted(list(range(100)) * epochs)
    for (a, _), (b, _) in zip(got, want):
        assert set(a) == {"id", "val"}
        np.testing.assert_array_equal(a["val"], b["val"])


def test_file_feed_partial_final_batch_terminate_and_errors(shards):
    feed = data_mod.FileFeed(data_mod.list_shards(shards), shard=False)
    assert [c for _, c in _drain(feed, 30)] == [30, 30, 30, 10]
    assert feed.should_stop()
    feed = data_mod.FileFeed(data_mod.list_shards(shards), shard=False,
                             num_epochs=50, queue_size=2)
    feed.next_batch_arrays(8)
    t0 = time.time()
    feed.terminate()
    assert time.time() - t0 < 10 and feed.should_stop()

    def bad_reader(path):
        raise RuntimeError("corrupt shard " + path)
        yield  # pragma: no cover

    with pytest.raises(RuntimeError, match="corrupt shard"):
        _drain(data_mod.FileFeed(["x"], row_reader=bad_reader, shard=False))


def test_lm_readers_match_jax(tmp_path):
    from tensorflowonspark_torch import example_proto, tfrecord
    from tensorflowonspark_tpu import data as jax_data

    text = tmp_path / "doc.txt"
    text.write_bytes(bytes(range(256)) * 5)
    toks = str(tmp_path / "toks.tfrecord")
    with tfrecord.TFRecordWriter(toks) as w:
        for doc in ([1, 2, 3], [4, 5], [6, 7, 8, 9]):
            w.write(example_proto.encode_example({"tokens": ("int64", doc)}))
    for path, make in ((str(text), lambda m: m.byte_lm_reader(100)),
                       (toks, lambda m: m.packed_lm_reader(4, eos_id=0))):
        got = [r["tokens"].tolist() for r in make(data_mod)(path)]
        want = [r["tokens"].tolist() for r in make(jax_data)(path)]
        assert got == want and got
    assert [r["tokens"].tolist() for r in data_mod.packed_lm_reader(
        4, eos_id=0)(toks)] == [[1, 2, 3, 0], [4, 5, 0, 6], [7, 8, 9, 0]]


def test_sharded_feed_over_file_feed(shards):
    """ShardedFeed (padding, mask, consensus, groups) composes on a FileFeed
    unchanged: 6 full batches of 16 and a padded 4-row tail; K = 3 groups
    then the tail single."""
    def sharded():
        feed = data_mod.FileFeed(data_mod.list_shards(shards), shard=False)
        return ShardedFeed(
            feed, 16, device="cpu",
            transform=lambda a: {"id": np.asarray(a["id"], np.int32)})

    out = list(sharded().batches())
    assert len(out) == 7 and int(out[-1][1].sum()) == 4
    assert sum(int(m.sum()) for _, m in out) == 100
    ids = sorted(int(i) for b, m in out for i, v in zip(b["id"], m) if v)
    assert ids == list(range(100))
    kinds = [k for k, _, _ in sharded().grouped_batches(3)]
    assert kinds == ["multi", "multi", "single"]


def test_process_pool_feed_matches_jax_and_spawns(shards):
    """The pool's rows are the JAX pool's (the same multiset; worker
    interleaving orders them), over two epochs with a shuffle buffer; its
    workers are spawned, never forked (a process that has initialised CUDA
    forks nothing)."""
    from tensorflowonspark_tpu import data as jax_data

    def make(mod):
        return mod.ProcessPoolFeed(mod.list_shards(shards), num_procs=2,
                                   shard=False, num_epochs=2,
                                   shuffle_buffer=16, block_rows=8, seed=3)

    feed = make(data_mod)
    got = _ids(_drain(feed))
    assert all(type(p).__name__ == "SpawnProcess" for p in feed._procs)
    feed.terminate()
    want_feed = make(jax_data)
    want = _ids(_drain(want_feed))
    want_feed.terminate()
    assert sorted(got) == sorted(want) == sorted(list(range(100)) * 2)


@pytest.fixture(scope="module")
def raw_shards(tmp_path_factory):
    """Synthetic JPEG shards (80 px) predecoded to 64 px rows by the port's
    copy of the input module."""
    tmp = tmp_path_factory.mktemp("imagenet")
    imagenet_input_torch.write_synthetic_shards(
        str(tmp / "jpeg"), num_examples=12, num_shards=2, image_size=80)
    src = data_mod.list_shards(str(tmp / "jpeg"), pattern="train-*")
    return src, imagenet_input_torch.predecode_shards(
        src, str(tmp / "raw"), store_px=64)


def _jax_input():
    import imagenet_input

    return imagenet_input


def test_predecoded_shards_and_readers_match_jax(raw_shards, tmp_path):
    """``predecode_shards`` writes the JAX module's bytes; the predecoded
    reader yields its rows, host crop and device-crop ints alike."""
    src, raw = raw_shards
    jax_input = _jax_input()
    want_raw = jax_input.predecode_shards(src, str(tmp_path / "raw"),
                                          store_px=64)
    for a, b in zip(raw, want_raw):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    for kwargs in (dict(train=True, seed=1), dict(train=False),
                   dict(train=True, seed=1, device_crop=True)):
        got = list(imagenet_input_torch.predecoded_reader(
            image_size=48, store_px=64, **kwargs)(raw[0]))
        want = list(jax_input.predecoded_reader(
            image_size=48, store_px=64, **kwargs)(raw[0]))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])


def test_crop_and_flip_matches_jax_and_the_host_crop(raw_shards):
    """``crop_and_flip`` on the device-crop rows equals JAX
    ``ops.augment.crop_and_flip`` and, byte for byte, the host crop of
    ``predecoded_reader(device_crop=False)`` under the same seed: the two
    modes are one augmentation."""
    import jax.numpy as jnp

    from tensorflowonspark_tpu.ops import augment as jax_augment

    _, raw = raw_shards

    def reader(device):
        return imagenet_input_torch.predecoded_reader(
            train=True, image_size=48, store_px=64, seed=7,
            device_crop=device)

    host = list(reader(False)(raw[0]))
    dev = list(reader(True)(raw[0]))
    images = np.stack([r["image"] for r in dev])
    xs, ys, flips = (np.asarray([r[k] for r in dev], np.int32)
                     for k in ("cropx", "cropy", "flip"))
    assert 0 < flips.sum() < len(flips) and len(set(xs.tolist())) > 1
    got = augment.crop_and_flip(torch.from_numpy(images),
                                torch.from_numpy(xs), torch.from_numpy(ys),
                                torch.from_numpy(flips), 48)
    assert got.dtype == torch.uint8 and got.shape == (len(dev), 48, 48, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([r["image"] for r in host]))
    want = jax_augment.crop_and_flip(jnp.asarray(images), xs, ys, flips, 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # out-of-range corners clamp, as lax.dynamic_slice clamps
    far = np.full_like(xs, 60)
    np.testing.assert_array_equal(
        augment.crop_and_flip(torch.from_numpy(images), far, far, flips,
                              48).numpy(),
        np.asarray(jax_augment.crop_and_flip(jnp.asarray(images), far, far,
                                             flips, 48)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_normalize_on_device_matches_jax(dtype):
    """uint8 -> ``dtype`` less the channel means rounded to ``dtype``, as
    the JAX function computes it, bit for bit."""
    import jax.numpy as jnp

    images = np.random.default_rng(0).integers(0, 256, (4, 8, 8, 3),
                                               np.uint8)
    got = imagenet_input_torch.normalize_on_device(
        torch.from_numpy(images), getattr(torch, dtype))
    want = _jax_input().normalize_on_device(jnp.asarray(images),
                                            getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert imagenet_input_torch.CHANNEL_MEANS == _jax_input().CHANNEL_MEANS


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_jpeg_reader_matches_jax(raw_shards, train):
    """The JPEG ``imagenet_reader`` (random resized crop and flip, or the
    center crop) yields the JAX example's rows on the same shards and seed
    (both decode with OpenCV or PIL, which the test needs)."""
    src, _ = raw_shards
    got = list(imagenet_input_torch.imagenet_reader(
        train=train, image_size=40, seed=5)(src[1]))
    want = list(_jax_input().imagenet_reader(
        train=train, image_size=40, seed=5)(src[1]))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["image"].shape == (40, 40, 3) and g["image"].dtype == np.uint8
        np.testing.assert_array_equal(g["image"], w["image"])
        assert int(g["label"]) == int(w["label"])
