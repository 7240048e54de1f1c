"""The port's copies of ``summary``, ``tfrecord`` and ``example_proto``:
the JAX package's ``tests/test_summary.py`` cases re-pointed (hand-encoded
tfevents files must parse with the real TensorBoard event loader), and
the port's encoders give the JAX package's bytes at a fixed wall time."""

import numpy as np
import pytest

from tensorflowonspark_tpu import example_proto as jax_example_proto
from tensorflowonspark_tpu import summary as jax_summary
from tensorflowonspark_tpu import tfrecord as jax_tfrecord
from tensorflowonspark_torch import example_proto, summary, tfrecord


def _load_events(path):
    loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    return list(loader.EventFileLoader(path).Load())


def _value(v):
    """TensorBoard's loader migrates simple_value -> tensor.float_val."""
    if v.HasField("tensor"):
        return v.tensor.float_val[0]
    return v.simple_value


def test_scalar_events_parse_with_tensorboard(tmp_path):
    w = summary.SummaryWriter(str(tmp_path))
    w.add_scalar("loss", 1.25, step=1)
    w.add_scalar("loss", 0.5, step=2)
    w.add_scalars({"lr": 0.1, "mfu": 0.42}, step=2)
    w.close()

    events = _load_events(w.path)
    assert events[0].file_version == "brain.Event:2"
    scalars = [(e.step, v.tag, _value(v))
               for e in events[1:] for v in e.summary.value]
    assert (1, "loss", 1.25) in scalars
    assert (2, "loss", 0.5) in scalars
    tags = {t for _, t, _ in scalars}
    assert tags == {"loss", "lr", "mfu"}
    mfu = [v for s, t, v in scalars if t == "mfu"]
    np.testing.assert_allclose(mfu, [0.42], rtol=1e-6)
    assert all(e.wall_time > 1e9 for e in events)


def test_negative_and_extreme_values(tmp_path):
    w = summary.SummaryWriter(str(tmp_path), filename_suffix=".x")
    w.add_scalar("g", -3.5, step=0)
    w.add_scalar("g", 1e30, step=10**12)  # huge step exercises varint
    w.close()
    events = _load_events(w.path)
    vals = [(e.step, _value(e.summary.value[0])) for e in events[1:]]
    assert vals[0] == (0, -3.5)
    assert vals[1][0] == 10**12
    np.testing.assert_allclose(vals[1][1], 1e30, rtol=1e-6)


@pytest.mark.parametrize("tag,value,step", [
    ("loss", 1.25, 1), ("g", -3.5, 0), ("mfu", 1e30, 10**12),
    ("ünïcode", 0.0, 7)])
def test_scalar_event_bytes_match_jax(tag, value, step):
    assert summary.encode_scalar_event(tag, value, step, wall_time=1.5e9) \
        == jax_summary.encode_scalar_event(tag, value, step, wall_time=1.5e9)


def test_text_and_version_event_bytes_match_jax():
    text = "```json\n{\"a\": 1}\n```"
    assert summary.encode_text_event("run_metadata", text, 3, 1.5e9) == \
        jax_summary.encode_text_event("run_metadata", text, 3, 1.5e9)
    assert summary.encode_file_version_event(1.5e9) == \
        jax_summary.encode_file_version_event(1.5e9)


def test_run_metadata_and_tfrecord_framing_match_jax(tmp_path):
    """The port's writer frames records as the JAX package's reader
    expects, and reads the JAX package's files back."""
    w = summary.SummaryWriter(str(tmp_path / "port"))
    w.add_run_metadata({"cluster_size": 2}, step=0)
    w.add_scalar("loss", 2.0, 5)
    w.close()
    records = list(jax_tfrecord.tfrecord_iterator(w.path))
    assert len(records) == 3
    assert records == list(tfrecord.tfrecord_iterator(w.path))
    jax_path = str(tmp_path / "jax.tfrecord")
    with jax_tfrecord.TFRecordWriter(jax_path) as jw:
        for r in (b"a", b"", b"xyz" * 100):
            jw.write(r)
    assert list(tfrecord.tfrecord_iterator(jax_path)) == \
        [b"a", b"", b"xyz" * 100]
    assert tfrecord.masked_crc32c(b"abc") == jax_tfrecord.masked_crc32c(b"abc")


def test_example_proto_matches_jax():
    features = {"label": ("int64", [3, -1]), "x": ("float", [0.5, 2.0]),
                "name": ("bytes", [b"row"])}
    encoded = example_proto.encode_example(features)
    assert encoded == jax_example_proto.encode_example(features)
    got = example_proto.decode_example(encoded)
    want = jax_example_proto.decode_example(encoded)
    assert sorted(got) == sorted(want) == ["label", "name", "x"]
    for name in want:
        assert got[name][0] == want[name][0]
        np.testing.assert_array_equal(np.asarray(got[name][1]),
                                      np.asarray(want[name][1]))
