"""K steps per dispatch on the CPU: the port's ``Trainer.multi_step`` and
``repeat_step`` against K single steps and against the JAX Trainer's
``multi_step`` (twins of ``tests/test_train.py``'s ``TestMultiStep`` and
``TestPerStepLossCurve``), ``ShardedFeed.grouped_batches`` against the JAX
package's (twins of ``tests/test_infeed.py``'s grouped cases), and
``fit_feed(steps_per_call=4)`` and ``TFOS_STEPS_PER_CALL=4`` against
K = 1.  The model is the JAX tests' linear regression; inputs come from
numpy seeds and reach both sides as numpy."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import train as jax_train
from tensorflowonspark_tpu.parallel import batch_sharding, build_mesh
from tensorflowonspark_tpu.parallel import mesh as jax_mesh
from tensorflowonspark_tpu.parallel.infeed import ShardedFeed as JaxShardedFeed
from tensorflowonspark_torch import train
from tensorflowonspark_torch.parallel.infeed import ShardedFeed

TRUE_W = np.array([3.14, 1.618], dtype=np.float32)
BATCH = 16
# fp32 on both sides, the same arithmetic in another order: 1e-5 relative
RTOL = 1e-5


def _jax_loss(params, batch, mask):
    pred = batch["x"] @ params["w"] + params["b"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / jnp.maximum(mask.sum(), 1.0), pred


def _torch_loss(params, batch, mask):
    pred = batch["x"] @ params["w"] + params["b"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0), pred


def _batch(seed, n=BATCH):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    return {"x": x, "y": x @ TRUE_W}


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _trainer(log_steps=100, **kwargs):
    return train.Trainer(
        _torch_loss, {"w": np.zeros(2, np.float32),
                      "b": np.zeros((), np.float32)},
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        batch_size=BATCH, log_steps=log_steps, device="cpu", **kwargs)


def _jax_trainer(**kwargs):
    return jax_train.Trainer(
        _jax_loss, {"w": jnp.zeros((2,)), "b": jnp.zeros(())},
        optax.sgd(0.1, momentum=0.9), mesh=build_mesh(), batch_size=BATCH,
        log_steps=100, **kwargs)


def _jax_group(batches):
    sharding = jax_mesh.scan_batch_sharding(build_mesh())
    stacked = {k: jax.device_put(v, sharding)
               for k, v in _stack(batches).items()}
    masks = jax.device_put(np.ones((len(batches), BATCH), np.float32),
                           sharding)
    return stacked, masks


def _params(tr):
    return {k: v.detach().numpy() for k, v in tr.state.params.items()}


class _CaptureWriter(object):
    """SummaryWriter stand-in: records ``(scalars, step)`` pairs."""

    def __init__(self):
        self.points = []

    def add_scalars(self, scalars, step):
        self.points.append((dict(scalars), step))

    def flush(self):
        pass

    def losses(self):
        return [(step, sc["loss"]) for sc, step in self.points
                if "loss" in sc]


def test_multi_step_matches_single_steps_and_jax():
    batches = [_batch(s) for s in range(4)]
    single = _trainer()
    for b in batches:
        want, _ = single.step(b)
    multi = _trainer()
    got = multi.multi_step(_stack(batches), np.ones((4, BATCH), np.float32))
    assert got.dim() == 0
    np.testing.assert_allclose(got.item(), want.item(), rtol=RTOL)
    jax_tr = _jax_trainer()
    jax_last = jax_tr.multi_step(*_jax_group(batches))
    np.testing.assert_allclose(got.item(), float(jax_last), rtol=RTOL)
    for name, value in _params(multi).items():
        np.testing.assert_allclose(value, _params(single)[name], rtol=RTOL,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(
            value, np.asarray(jax_tr.state.params[name]), rtol=RTOL,
            atol=1e-6, err_msg=name)
    assert multi.state.step == 4 and multi.history.global_steps == 4
    snap = multi.counters_snapshot()
    assert snap["train_steps_total"] == 4
    assert snap["train_steps_per_call_max"] == 4


def test_multi_step_padded_group_matches_masked_single_steps():
    """A group whose slots carry their own masks (a padded row) equals the
    single steps with those masks."""
    batches = [_batch(s) for s in (5, 6)]
    masks = np.ones((2, BATCH), np.float32)
    masks[1, 11:] = 0.0
    single = _trainer()
    for b, m in zip(batches, masks):
        single.step(b, m)
    multi = _trainer()
    multi.multi_step(_stack(batches), masks)
    for name, value in _params(multi).items():
        np.testing.assert_allclose(value, _params(single)[name], rtol=RTOL,
                                   atol=1e-6, err_msg=name)


def test_repeat_step_matches_k_steps_and_jax():
    b = _batch(3)
    single = _trainer()
    for _ in range(3):
        want, _ = single.step(b)
    rep = _trainer()
    got = rep.repeat_step(b, np.ones(BATCH, np.float32), 3)
    np.testing.assert_allclose(got.item(), want.item(), rtol=RTOL)
    mesh = build_mesh()
    jax_tr = _jax_trainer()
    jax_last = jax_tr.repeat_step(
        {k: jax.device_put(v, batch_sharding(mesh)) for k, v in b.items()},
        jax.device_put(np.ones(BATCH, np.float32), batch_sharding(mesh)), 3)
    np.testing.assert_allclose(got.item(), float(jax_last), rtol=RTOL)
    for name, value in _params(rep).items():
        np.testing.assert_allclose(value, _params(single)[name], rtol=RTOL,
                                   atol=1e-6, err_msg=name)
    assert rep.state.step == 3 and rep.history.global_steps == 3


def test_multi_step_writes_dense_loss_curve():
    """A K = 4 group with log_steps = 4 writes four loss points at steps
    1..4, equal to the single-step losses (the JAX twin's contract)."""
    batches = [_batch(s) for s in range(4)]
    ref = _trainer()
    want = [ref.step(b)[0].item() for b in batches]
    writer = _CaptureWriter()
    tr = _trainer(log_steps=4, summary_writer=writer)
    last = tr.multi_step(_stack(batches), np.ones((4, BATCH), np.float32))
    assert [s for s, _ in writer.losses()] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in writer.losses()], want,
                               rtol=RTOL)
    np.testing.assert_allclose(last.item(), want[-1], rtol=RTOL)
    # the window's other scalars, at its boundary
    scalars = [sc for sc, s in writer.points if s == 4 and "ms_per_step" in sc]
    assert scalars and scalars[0]["examples_per_sec"] > 0


def test_train_end_flushes_curve_tail_and_stays_quiet_mid_window():
    """Mid-window nothing is synced or written; ending training writes the
    buffered per-step curve."""
    writer = _CaptureWriter()
    tr = _trainer(log_steps=100, summary_writer=writer)
    for s in (0, 2, 4):
        tr.multi_step(_stack([_batch(s), _batch(s + 1)]),
                      np.ones((2, BATCH), np.float32))
    assert len(tr.history.timestamp_log) == 1 and not writer.points
    assert tr.history.last_synced_value is None
    tr.history.on_train_end(None)
    assert [s for s, _ in writer.losses()] == list(range(1, 7))
    stats = tr.history.log_stats(loss=1.0)
    final = [sc for sc, s in writer.points if "avg_exp_per_second" in sc]
    assert final and "loss" not in final[0]      # the curve has step 6
    assert stats["global_steps"] == 6


def _matrix_loss(params, batch, mask):
    """The linear model with a [2, 1] weight: a matrix product, which
    FlopCounterMode counts (a matrix-vector product it does not)."""
    pred = (batch["x"] @ params["w"])[:, 0] + params["b"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0), pred


def test_multi_step_flop_accounting_is_per_step():
    def make():
        return train.Trainer(
            _matrix_loss, {"w": np.zeros((2, 1), np.float32),
                           "b": np.zeros((), np.float32)},
            functools.partial(torch.optim.SGD, lr=0.1), device="cpu")

    b = _batch(0)
    multi = make()
    multi.multi_step(_stack([b, b]), np.ones((2, BATCH), np.float32))
    single = make()
    single.step(b)
    # [16, 2] @ [2, 1] forward, and the weight's gradient [2, 16] @ [16, 1]
    # backward: 2 FLOPs a product
    assert multi.history.step_flops == single.history.step_flops == \
        2 * (2 * BATCH * 2)
    assert multi.counters_snapshot()["train_step_bytes_max"] == \
        single.counters_snapshot()["train_step_bytes_max"] > 0


def test_window_boundary_mid_group_syncs_the_group_mean():
    """A boundary inside a group syncs the group's on-device loss mean,
    and the health gauges read it."""
    batches = [_batch(s) for s in range(3)]
    ref = _trainer()
    want = [ref.step(b)[0].item() for b in batches]
    tr = _trainer(log_steps=2)
    tr.multi_step(_stack(batches), np.ones((3, BATCH), np.float32))
    tr._account_windows()
    np.testing.assert_allclose(tr.history.last_synced_value, np.mean(want),
                               rtol=RTOL)
    assert [s for s, _ in tr.history.timestamp_log] == [0, 3]
    snap = tr.counters_snapshot()
    assert snap["train_health_windows"] == 1
    assert snap["train_nonfinite_loss"] == 0


# -- grouped infeed ----------------------------------------------------------

class StubFeed(object):
    """Rows ``[float]`` served like a DataFeed: ``should_stop`` turns true
    once a read asked for more rows than were left."""

    def __init__(self, n):
        self.rows = [[float(i)] for i in range(n)]
        self.pos = 0
        self.done = False

    def next_batch(self, n):
        items = self.rows[self.pos:self.pos + n]
        self.pos += len(items)
        if len(items) < n:
            self.done = True
        return items

    def next_batch_arrays(self, n):
        items = self.next_batch(n)
        return np.asarray(items, np.float32).reshape(-1, 1), len(items)

    def should_stop(self):
        return self.done

    def interrupt(self):
        pass

    def terminate(self):
        pass


def _feed(n, **kwargs):
    kwargs.setdefault("prefetch", 0)
    return ShardedFeed(StubFeed(n), 8, device="cpu", **kwargs)


def _as_numpy(items):
    return [(kind, np.asarray(b), np.asarray(m)) for kind, b, m in items]


@pytest.mark.parametrize("n_rows,k", [(32, 2), (20, 2), (16, 4), (44, 3)])
@pytest.mark.parametrize("assembly", ["device", "host"])
def test_grouped_batches_match_jax(n_rows, k, assembly):
    """The same rows give the JAX package's group/single sequence, stacks
    and masks: full groups, a padded tail degraded to singles, a pending
    group that cannot fill flushed as singles."""
    want = _as_numpy(JaxShardedFeed(
        StubFeed(n_rows), build_mesh(), 8, prefetch=0,
        group_assembly=assembly).grouped_batches(k))
    got = _as_numpy(_feed(n_rows, group_assembly=assembly,
                          prefetch=2).grouped_batches(k))
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, gb, gm), (_, wb, wm) in zip(got, want):
        assert gb.shape == wb.shape and np.array_equal(gb, wb)
        assert gm.dtype == np.float32 and np.array_equal(gm, wm)


def test_grouped_batches_kinds_and_rows():
    out = _as_numpy(_feed(20).grouped_batches(2))
    assert [kind for kind, _, _ in out] == ["multi", "single"]
    assert out[0][1].shape == (2, 8, 1) and out[0][2].sum() == 16
    assert out[1][1].shape == (8, 1) and out[1][2].sum() == 4
    pending = _as_numpy(_feed(16).grouped_batches(4))
    assert [kind for kind, _, _ in pending] == ["single", "single"]
    got = np.concatenate([b.ravel() for _, b, _ in pending])
    np.testing.assert_array_equal(np.sort(got), np.arange(16,
                                                          dtype=np.float32))


def test_device_assembly_counters_and_donation():
    feed = _feed(32)
    assert feed.group_assembly == "device" and feed.group_donation_safe
    out = list(feed.grouped_batches(2))
    assert [kind for kind, _, _ in out] == ["multi", "multi"]
    snap = feed.counters_snapshot()
    assert snap["train_group_assemble_us"] > 0
    assert snap["train_group_assemble_us_hwm"] > 0
    assert snap["infeed_batches"] == 4
    host = _feed(32, group_assembly="host")
    assert not host.group_donation_safe
    list(host.grouped_batches(2))
    assert host.counters_snapshot()["infeed_batches"] == 4


def test_group_assembly_from_env(monkeypatch):
    monkeypatch.setenv("TFOS_GROUP_ASSEMBLY", "host")
    assert _feed(8).group_assembly == "host"
    with pytest.raises(ValueError, match="group_assembly"):
        _feed(8, group_assembly="disk")


def test_knob_retunes_group_size_on_a_boundary():
    feed = _feed(48)                                 # 6 batches of 8
    it = feed.grouped_batches(2)
    kind, stack, _ = next(it)
    assert kind == "multi" and stack.shape[0] == 2
    assert feed.apply_knob("train_steps_per_call", 4)
    assert [s.shape[0] for kind, s, _ in it if kind == "multi"] == [4]


def test_knob_refused_in_a_multi_process_world():
    feed = _feed(8)
    feed._num_processes = 2
    assert feed.apply_knob("train_steps_per_call", 4) is False
    tr = _trainer()
    assert tr.apply_knob("train_steps_per_call", 4) is True
    # the rollback command is the trainer's own (fit_feed halts on it)
    assert tr.apply_knob("train_rollback", "t1") is True
    assert tr.apply_knob("serving_batch_size", 4) is False


# -- fit_feed with K > 1 -----------------------------------------------------

class _RegressionFeed(StubFeed):
    """Columnar regression rows ``(x[2], y)`` from a seed."""

    def __init__(self, n):
        super().__init__(n)
        data = _batch(42, n)
        self.rows = list(zip(data["x"], data["y"]))

    def next_batch_arrays(self, n):
        items = self.next_batch(n)
        return ({"x": np.asarray([r[0] for r in items], np.float32),
                 "y": np.asarray([r[1] for r in items], np.float32)},
                len(items))


def _fit(k=1, n_rows=164, **kwargs):
    tr = _trainer(log_steps=5)
    feed = ShardedFeed(_RegressionFeed(n_rows), BATCH, device="cpu")
    seen = []
    stats = tr.fit_feed(feed, steps_per_call=k, on_steps=seen.append,
                        **kwargs)
    return tr, stats, seen


@pytest.mark.parametrize("source", ["argument", "env"])
def test_fit_feed_steps_per_call_matches_k1(source, monkeypatch):
    """164 rows in batches of 16: 2 groups of 4, then 2 full singles and a
    padded single of 4 rows; the params equal the K = 1 run's."""
    want_tr, want_stats, want_seen = _fit(1)
    if source == "env":
        monkeypatch.setenv(train.STEPS_PER_CALL_ENV, "4")
        tr, stats, seen = _fit(1)
    else:
        tr, stats, seen = _fit(4)
    assert want_seen == list(range(1, 12))
    assert seen == [4, 8, 9, 10, 11]                 # once per dispatch
    assert tr.state.step == want_tr.state.step == 11
    for name, value in _params(tr).items():
        np.testing.assert_allclose(value, _params(want_tr)[name], rtol=RTOL,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(stats["loss"], want_stats["loss"], rtol=RTOL)
    assert stats["megastep"] == {
        "steps_per_call": 4, "steps_per_call_last": 1,
        "group_assembly": "device", "donate_state": False,
        "donate_batches": False}
    overlap = stats["overlap"]
    assert overlap["dispatch_count"] == 5
    assert overlap["train_steps_per_call_max"] == 4
    assert overlap["train_steps_total"] == 11
    assert want_stats["megastep"]["steps_per_call"] == 1


def test_fit_feed_max_steps_overshoots_by_less_than_k():
    tr, _, seen = _fit(4, max_steps=6)
    assert seen == [4, 8] and tr.state.step == 8


def test_fit_feed_nan_batch_goes_through_the_group(monkeypatch):
    """The fault injector hooks each dispatch on the stacked batch: the NaN
    group's losses are nonfinite, and the health gauges count them."""
    monkeypatch.setenv("TFOS_FAULT_SPEC", '{"nan_batch_at_step": 4}')
    tr, stats, _ = _fit(4, n_rows=128)
    snap = stats["overlap"]
    assert snap["train_nonfinite_loss"] >= 1
    assert not np.isfinite(_params(tr)["w"]).all()


class _StubGraph(object):
    """A captured step's stand-in: counts its replays, runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _stub_captured(tr):
    """Put a stub graph for the signature of ``_batch``'s batches into
    ``tr``'s graph cache, as a capture would leave it: the optimizer's
    hyperparameters recorded now, the group armed capturable."""
    batch, mask = tr._prepare(_batch(0), None)
    for group in tr.state.optimizer.param_groups:
        group["capturable"] = True
    entry = train._StepGraph(
        _StubGraph(), {k: v.clone() for k, v in batch.items()},
        mask.clone(), torch.zeros(()), torch.zeros(()), [], {},
        train._frozen_hyperparameters(tr.state.optimizer))
    tr._graphs[train._signature(batch, mask)] = entry
    return entry, (lambda i: (batch, mask))


def test_replay_refuses_a_changed_float_hyperparameter():
    """A replay keeps the float hyperparameters it was captured with, so
    one changed after the capture (a scheduler or hook writing
    group["lr"]) raises, naming the group, the key, both values and the
    tensor way out; unchanged ones, the capturable flag and tensor
    hyperparameters replay."""
    tr = _trainer()
    entry, slot = _stub_captured(tr)
    assert "lr" in entry.hyperparameters[0]
    assert "capturable" not in entry.hyperparameters[0]
    assert "params" not in entry.hyperparameters[0]
    tr._graph_steps(2, slot)
    assert entry.graph.replays == 2
    tr.state.optimizer.param_groups[0]["lr"] = 0.05
    with pytest.raises(RuntimeError) as err:
        tr._graph_steps(1, slot)
    message = str(err.value)
    for part in ("param group 0", "'lr'", "0.1", "0.05", "tensor",
                 "in place"):
        assert part in message, (part, message)
    assert entry.graph.replays == 2
    tr.state.optimizer.param_groups[0]["lr"] = 0.1
    tr._graph_steps(1, slot)
    assert entry.graph.replays == 3
    # a float hyperparameter replaced by a tensor after the capture: the
    # graph still holds the float
    tr.state.optimizer.param_groups[0]["momentum"] = torch.tensor(0.9)
    with pytest.raises(RuntimeError, match="'momentum'"):
        tr._graph_steps(1, slot)


def test_replay_follows_tensor_hyperparameters():
    """A tensor lr is left out of the record: writing it in place between
    dispatches is what a replay reads."""
    tr = train.Trainer(
        _torch_loss, {"w": np.zeros(2, np.float32),
                      "b": np.zeros((), np.float32)},
        lambda params: torch.optim.SGD(params, lr=torch.tensor(0.1),
                                       momentum=0.9),
        batch_size=BATCH, log_steps=100, device="cpu")
    entry, slot = _stub_captured(tr)
    assert "lr" not in entry.hyperparameters[0]
    tr.state.optimizer.param_groups[0]["lr"].fill_(0.01)
    tr._graph_steps(3, slot)
    assert entry.graph.replays == 3
