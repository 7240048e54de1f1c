"""The port's metrics against the JAX package's on the same inputs:
``roofline``, ``attribute_step_time`` (the proportional downscale
included), ``compression_ratio`` and ``TimeHistory.on_steps_end`` with a
summary writer; the byte counter of ``estimate_step_cost`` on one matmul;
the peaks on the CPU; and the Trainer's attribution report."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu import metrics as jax_metrics
from tensorflowonspark_torch import metrics, train


@pytest.mark.parametrize("flops,nbytes", [
    (7.04e12, 3.1e10), (1e9, 1e9), (5e11, 2e12), (None, 1e9), (1e9, 0)])
@pytest.mark.parametrize("peaks", [(989e12, 3.35e12), (67e12, 3.35e12),
                                   (None, 3.35e12)])
def test_roofline_matches_jax(flops, nbytes, peaks):
    peak_flops, peak_bps = peaks
    got = metrics.roofline(flops, nbytes, peak_flops=peak_flops or 0,
                           peak_bps=peak_bps)
    want = jax_metrics.roofline(flops, nbytes, peak_flops=peak_flops or 0,
                                peak_bps=peak_bps)
    assert got == want
    if got is not None:
        assert set(got) == {"arithmetic_intensity", "ridge_point", "bound",
                            "ceiling_flops_per_sec", "ideal_step_seconds"}


def test_roofline_on_the_cpu_is_none():
    """No peak rates on the CPU: the roofline is unknowable, not made up."""
    assert metrics.peak_bytes_per_sec_per_device("cpu") is None
    assert metrics.roofline(1e9, 1e9) is None or torch.cuda.is_available()


@pytest.mark.parametrize("args", [
    (1000.0, 250.0),
    (1000.0, 250.0, 0.0, 100.0, 50.0),
    (1000.0, 800.0, 100.0, 300.0, 200.0),     # overshoot: scaled down
    (1000.0, -5.0, 0.0, 10.0, 0.0),           # negatives count as 0
    (0.0, 10.0),
    (-1.0, 10.0),
])
def test_attribute_step_time_matches_jax(args):
    got = metrics.attribute_step_time(*args)
    assert got == jax_metrics.attribute_step_time(*args)
    if got is not None:
        assert [k[:-4] for k in got] == list(metrics.ATTRIBUTION_BUCKETS)
        assert sum(got.values()) == pytest.approx(100.0)
    assert metrics.ATTRIBUTION_BUCKETS == jax_metrics.ATTRIBUTION_BUCKETS


@pytest.mark.parametrize("raw,wire", [(1000, 250), (0, 10), (10, 0),
                                      (None, 5), (7, 7), (3, 4)])
def test_compression_ratio_matches_jax(raw, wire):
    assert metrics.compression_ratio(raw, wire) == \
        jax_metrics.compression_ratio(raw, wire)


def test_byte_counter_states_one_matmul():
    """[M, K] @ [K, N] in fp32 is one aten.mm: it reads 4·M·K + 4·K·N bytes
    and writes 4·M·N, and does 2·M·K·N FLOPs; a view moves nothing."""
    m, k, n = 8, 16, 4
    a, b = torch.randn(m, k), torch.randn(k, n)
    cost, out = metrics.estimate_step_cost(lambda: a @ b)
    assert torch.equal(out, a @ b)
    assert cost == {"flops": 2 * m * k * n,
                    "bytes_accessed": 4 * (m * k + k * n + m * n),
                    "compile_secs": None}
    view_cost, _ = metrics.estimate_step_cost(lambda: a.view(k, m).t())
    assert view_cost["bytes_accessed"] is None and view_cost["flops"] is None


class _CaptureWriter(object):
    def __init__(self):
        self.points = []

    def add_scalars(self, scalars, step):
        self.points.append((dict(scalars), step))

    def flush(self):
        pass


def test_on_steps_end_matches_jax(monkeypatch):
    """The same dispatches (groups of 3, a single, a group of 2 across a
    boundary) give the JAX recorder's windows, synced values and per-step
    loss curve."""
    monkeypatch.setattr(jax_metrics, "peak_flops_per_device", lambda: 1e12)
    dispatches = [np.array([3.0, 2.5, 2.0], np.float32),
                  np.array([1.5], np.float32),
                  np.array([1.25, 1.0], np.float32)]
    recorders = {}
    for side in ("torch", "jax"):
        writer = _CaptureWriter()
        if side == "torch":
            hist = metrics.TimeHistory(batch_size=4, log_steps=4,
                                       step_flops=1e9, peak_flops=1e12,
                                       summary_writer=writer)
            def as_value(x):
                return torch.from_numpy(np.asarray(x))
        else:
            hist = jax_metrics.TimeHistory(batch_size=4, log_steps=4,
                                           step_flops=1e9, num_devices=1,
                                           summary_writer=writer)
            as_value = jnp.asarray
        hist.on_train_begin()
        synced = []
        for losses in dispatches:
            value = as_value(losses)
            hist.on_steps_end(len(losses), value,
                              window_value=as_value(losses.mean()))
            synced.append(hist.last_synced_value)
        hist.on_train_end(None)
        hist.log_stats(loss=1.0)
        recorders[side] = (hist, writer, synced)
    (hist, writer, synced), (ref, ref_writer, ref_synced) = (
        recorders["torch"], recorders["jax"])
    assert [s for s, _ in hist.timestamp_log] == \
        [s for s, _ in ref.timestamp_log] == [0, 4]
    # the boundary (step 4) synced the second dispatch's mean
    assert synced[0] is None and ref_synced[0] is None
    np.testing.assert_allclose(synced[1:], np.asarray(ref_synced[1:],
                                                      np.float64), rtol=1e-7)

    def loss_curve(w):
        return [(s, sc["loss"]) for sc, s in w.points if set(sc) == {"loss"}]

    assert loss_curve(writer) == loss_curve(ref_writer)
    assert [s for s, _ in loss_curve(writer)] == [1, 2, 3, 4, 5, 6]
    assert [sorted(sc) for sc, _ in writer.points] == \
        [sorted(sc) for sc, _ in ref_writer.points]


def _loss(params, batch, mask):
    pred = (batch["x"] @ params["w"])[:, 0]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0), pred


def test_trainer_attribution_report():
    """The report's buckets sum to 100 once a window closed and ride the
    counters as attrib_<bucket>_pct_max; with the roofline of given peaks
    the device bucket is the closed steps' ideal time."""
    tr = train.Trainer(_loss, {"w": np.zeros((2, 1), np.float32)},
                       functools.partial(torch.optim.SGD, lr=0.1),
                       batch_size=8, log_steps=2, device="cpu")
    assert tr.attribution_report() is None
    rng = np.random.default_rng(0)
    for _ in range(4):
        x = rng.random((8, 2)).astype(np.float32)
        tr.step({"x": x, "y": x.sum(1)})
        tr._account_windows()
    report = tr.attribution_report()
    assert sum(report.values()) == pytest.approx(100.0)
    assert report["device_compute_pct"] == 0.0      # no CPU peaks
    snap = tr.counters_snapshot()
    assert {"attrib_%s_pct_max" % b for b in metrics.ATTRIBUTION_BUCKETS} \
        <= set(snap)
    assert snap["train_step_bytes_max"] > 0
    assert "train_compile_us_max" not in snap       # nothing captured
    tr._roofline = metrics.roofline(tr.history.step_flops,
                                    snap["train_step_bytes_max"],
                                    peak_flops=1e6, peak_bps=1e6)
    ideal = tr._roofline["ideal_step_seconds"]
    want = 100.0 * min(1.0, tr._step_ms_count * ideal * 1e6
                       / tr._step_ms_sum_us)
    assert tr.attribution_report()["device_compute_pct"] == \
        pytest.approx(want)
