"""The Trainer's extra-state contract (``Trainer(extra_state=...)``) on the
port's ResNet against the JAX Trainer: three SGD-momentum steps (losses,
params and BatchNorm running averages), ``accum_steps=2`` (the statistics
threaded through the micro-batches), ``multi_step`` against single steps,
``evaluate`` with ``metric_fn(params, extra, batch, mask)``, and a
checkpoint round trip of the extra state with a NaN in it quarantined
(``tests/test_torch_resnet_dist.py`` holds two gloo ranks against the JAX
Trainer).  The CIFAR ResNet, one basic block a stage (the contract is the
model's BatchNorm state; ``tests/test_torch_resnet.py`` holds every model
to flax), 32 px, batch 8 (the 8-device CPU mesh of tests/conftest.py takes
one row a device), in float64
on both sides (``jax.enable_x64`` around the JAX side): the loss is not
differentiable where a pre-activation sits on a ReLU's kink, and in fp32
some pre-activation of a run lies within rounding of one, where the two
frameworks take different sides and one kernel's gradient moves by a
percent.  In float64 none does.  The final Dense runs in fp32 in both (flax
``Dense(dtype=float32)``)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import train as jax_train
from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_tpu.parallel import batch_sharding, build_mesh
from tensorflowonspark_torch import checkpoint, convert, train
from tensorflowonspark_torch.models import resnet


PX, BATCH, CLASSES = 32, 8, 5
CFG = dict(num_classes=CLASSES, blocks_per_stage=1, dtype="float64")
LR, MOMENTUM, WD, SMOOTH = 0.1, 0.9, 1e-4, 0.1
# float64 on both sides but the fp32 logits (rounded in the last of 24
# bits, 6e-8): losses within 1e-6 relative; after the steps, that rounding
# carried through the backward and the momentum, the params and the running
# averages within 1e-5 of each tensor's largest value (a wrong weighting or
# a stale statistic is off by percents)
LOSS_RTOL = 1e-6
STATE_TOL = 1e-5
# the global batch of a padded final step: 6 valid rows of 8
PADDED_MASK = np.array([1, 1, 1, 0, 1, 1, 1, 0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(scope="module")
def flax_state():
    """A flax ResNet and its params and batch_stats as float64 numpy, the
    leaves perturbed by 10% of their spread (zero scales and means
    included)."""
    with jax.enable_x64(True):
        model = jax_resnet.build_resnet56(**CFG)
        variables = jax.jit(lambda k: model.init(
            k, jnp.zeros((1, PX, PX, 3)), train=False))(
                jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(x):
        x = np.asarray(x, np.float64)
        return x + 0.1 * (np.std(x) or 1.0) * rng.standard_normal(x.shape)

    params = jax.tree_util.tree_map(perturb, variables["params"])
    stats = jax.tree_util.tree_map(lambda x: np.abs(perturb(x)),
                                   variables["batch_stats"])
    return model, params, stats


def _batch(seed, batch=BATCH):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((batch, PX, PX, 3)),
            "label": rng.integers(0, CLASSES, batch).astype(np.int32)}


def _jax_trainer(flax_state, weight_decay=WD, label_smoothing=SMOOTH,
                 **kwargs):
    model, params, stats = flax_state
    return jax_train.Trainer(
        jax_resnet.loss_fn(model, weight_decay=weight_decay,
                           label_smoothing=label_smoothing),
        params, optax.sgd(LR, momentum=MOMENTUM), mesh=build_mesh(),
        extra_state=stats, batch_size=BATCH, step_flops_override=1,
        **kwargs)


def _jax_step(tr, batch, mask):
    mesh = tr.mesh
    b = {"image": jax.device_put(batch["image"], batch_sharding(mesh, 3)),
         "label": jax.device_put(batch["label"], batch_sharding(mesh))}
    loss, _ = tr.step(b, jax.device_put(mask, batch_sharding(mesh)))
    return float(loss)


def _port_state(flax_state):
    _, params, stats = flax_state
    sd, extra = convert.resnet_params_from_flax(params, stats)
    return ({k: v.numpy() for k, v in sd.items()},
            {k: v.numpy() for k, v in extra.items()})


def _port_trainer(state, weight_decay=WD, label_smoothing=SMOOTH,
                  **kwargs):
    sd, extra = state
    kwargs.setdefault("device", "cpu")
    model = resnet.build_resnet56(**CFG)
    return train.Trainer(
        resnet.loss_fn(model, weight_decay=weight_decay,
                       label_smoothing=label_smoothing),
        {k: torch.from_numpy(v) for k, v in sd.items()},
        functools.partial(torch.optim.SGD, lr=LR, momentum=MOMENTUM),
        extra_state={k: torch.from_numpy(v) for k, v in extra.items()},
        batch_size=BATCH, **kwargs)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _assert_state_matches(params, extra, want_params, want_stats):
    """The port's ``params``/``extra`` dicts (tensors or arrays) against a
    flax params and batch_stats tree, each tensor within STATE_TOL of its
    largest value."""
    got_params, got_stats = convert.resnet_params_to_flax(
        {k: torch.as_tensor(v) for k, v in params.items()},
        {k: torch.as_tensor(v) for k, v in extra.items()})
    for got, want in ((got_params, want_params), (got_stats, want_stats)):
        got, want = _flat(got), _flat(jax.device_get(want))
        assert sorted(got) == sorted(want)
        for path, arr in want.items():
            np.testing.assert_allclose(
                got[path], arr, rtol=0,
                atol=STATE_TOL * max(np.abs(arr).max(), 1e-3),
                err_msg=str(path))


def test_three_steps_match_jax_trainer(flax_state):
    """Three steps, the last on a padded batch: losses, params and the
    running averages (the Trainer copies the new statistics in place: the
    same tensors, new values), and ``aux`` without the extra state."""
    jax_tr = _jax_trainer(flax_state)
    tr = _port_trainer(_port_state(flax_state))
    extra_ids = {k: id(v) for k, v in tr.state.extra.items()}
    before = {k: v.clone() for k, v in tr.state.extra.items()}
    masks = [np.ones(BATCH, np.float32)] * 2 + [PADDED_MASK]
    for seed, mask in enumerate(masks):
        want = _jax_step(jax_tr, _batch(seed), mask)
        got, aux = tr.step(_batch(seed), mask)
        np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)
    assert sorted(aux) == ["accuracy"]
    assert {k: id(v) for k, v in tr.state.extra.items()} == extra_ids
    assert all(not torch.equal(before[k], v)
               for k, v in tr.state.extra.items())
    assert tr.state.step == int(jax_tr.state.step) == 3
    _assert_state_matches(tr.state.params, tr.state.extra,
                          jax_tr.state.params, jax_tr.state.extra)


def test_accum_steps_threads_the_statistics_like_jax(flax_state):
    """accum_steps=2: two micro-batches of 4 rows against the same params,
    the second seeing the first's running averages, as in the JAX scan.
    No weight decay and no label smoothing here: the JAX scan carries an
    fp32 loss, and the L2 term of float64 params or float64 smoothed labels
    would make it float64."""
    jax_tr = _jax_trainer(flax_state, weight_decay=0.0, label_smoothing=0.0,
                          accum_steps=2)
    tr = _port_trainer(_port_state(flax_state), weight_decay=0.0,
                       label_smoothing=0.0, accum_steps=2)
    for seed, mask in enumerate([np.ones(BATCH, np.float32), PADDED_MASK]):
        want = _jax_step(jax_tr, _batch(10 + seed), mask)
        got, _ = tr.step(_batch(10 + seed), mask)
        np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)
    _assert_state_matches(tr.state.params, tr.state.extra,
                          jax_tr.state.params, jax_tr.state.extra)


def test_multi_step_equals_single_steps(flax_state):
    """multi_step of K = 3 stacked batches (a padded one last) ends where
    three single steps end, the running averages included (on the CPU the
    same eager steps; the card replays a captured graph)."""
    state = _port_state(flax_state)
    single, multi = _port_trainer(state), _port_trainer(state)
    batches = [_batch(20 + i) for i in range(3)]
    masks = [np.ones(BATCH, np.float32)] * 2 + [PADDED_MASK]
    for b, m in zip(batches, masks):
        want, _ = single.step(b, m)
    got = multi.multi_step({k: np.stack([b[k] for b in batches])
                            for k in batches[0]}, np.stack(masks))
    assert got.item() == want.item()
    for name, t in single.state.params.items():
        assert torch.equal(multi.state.params[name], t), name
    for name, t in single.state.extra.items():
        assert torch.equal(multi.state.extra[name], t), name
    rep = _port_trainer(state)
    rep.repeat_step(batches[0], masks[0], 2)
    assert rep.state.step == 2
    assert not torch.equal(rep.state.extra["stem_norm.running_mean"],
                           multi.state.extra["stem_norm.running_mean"])


class _EvalFeed(object):
    """``batches(drain=...)`` of fixed ``(batch, mask)`` pairs, the feed
    ``Trainer.evaluate`` takes on both sides."""

    def __init__(self, items, to):
        self.items = [(to(b), to(m)) for b, m in items]

    def batches(self, drain="any"):
        assert drain == "all"
        return iter(self.items)


def test_evaluate_passes_the_extra_state(flax_state):
    """``evaluate(metric_fn)`` calls ``metric_fn(params, extra, batch,
    mask)`` with the trainer's running averages (eval-mode BatchNorm) and
    gives the JAX Trainer's top-1 and mean loss over two batches, one
    padded."""
    model, _, _ = flax_state
    jax_tr = _jax_trainer(flax_state)
    tr = _port_trainer(_port_state(flax_state))
    port_model = resnet.build_resnet56(**CFG)
    items = [(_batch(30), np.ones(BATCH, np.float32)),
             (_batch(31), PADDED_MASK)]

    def jax_metric(params, stats, batch, mask):
        logits = model.apply({"params": params, "batch_stats": stats},
                             batch["image"], train=False)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["label"])
        return {"accuracy": ((logits.argmax(-1) == batch["label"])
                             * mask).sum(),
                "loss": (ce * mask).sum()}, mask.sum()

    seen = []

    def port_metric(params, extra, batch, mask):
        seen.append(extra)
        logits = torch.func.functional_call(port_model, {**params, **extra},
                                            (batch["image"],))
        ce = torch.nn.functional.cross_entropy(
            logits, batch["label"].long(), reduction="none")
        return {"accuracy": ((logits.argmax(-1) == batch["label"])
                             * mask).sum(),
                "loss": (ce * mask).sum()}, mask.sum()

    want = jax_tr.evaluate(_EvalFeed(items, lambda x: x), jax_metric)
    got = tr.evaluate(_EvalFeed(items, lambda x: x), port_metric)
    assert len(seen) == 2 and seen[0] is tr.state.extra
    assert got["accuracy"] == pytest.approx(float(want["accuracy"]))
    assert got["loss"] == pytest.approx(float(want["loss"]), rel=LOSS_RTOL)


def test_checkpoint_round_trip_and_nan_quarantine(flax_state, tmp_path):
    """A save carries the extra state; ``restore_latest(validate=True)``
    copies it back in place (a captured graph keeps its addresses); a NaN
    in the newest step's running averages quarantines that step and the
    previous one is restored."""
    state = _port_state(flax_state)
    tr = _port_trainer(state)
    ckpt = checkpoint.CheckpointManager(str(tmp_path), save_interval_steps=1,
                                        async_save=False)
    tr.step(_batch(40))
    ckpt.maybe_save(1, tr.state)
    saved = {k: v.clone() for k, v in tr.state.extra.items()}
    saved_params = {k: v.detach().clone() for k, v in tr.state.params.items()}
    tr.step(_batch(41))
    # step 2's save, poisoned in its extra state only
    tr.state.extra["blocks.1.norms.0.running_var"][3] = float("nan")
    ckpt.maybe_save(2, tr.state)
    fresh = _port_trainer(state)
    ids = {k: id(v) for k, v in fresh.state.extra.items()}
    assert fresh.restore_latest(ckpt, validate=True) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1", "2.corrupt"]
    assert {k: id(v) for k, v in fresh.state.extra.items()} == ids
    for name, t in saved.items():
        assert torch.equal(fresh.state.extra[name], t), name
    for name, t in saved_params.items():
        assert torch.equal(fresh.state.params[name].detach(), t), name
    # the restored trainer steps exactly as the original did from step 1
    again = _port_trainer(state)
    again.step(_batch(40))
    want, _ = again.step(_batch(41))
    got, _ = fresh.step(_batch(41))
    assert got.item() == want.item()


def test_compile_and_measure_leaves_the_extra_state(flax_state):
    tr = _port_trainer(_port_state(flax_state))
    before = {k: v.clone() for k, v in tr.state.extra.items()}
    assert tr.compile_and_measure(_batch(50)) > 0
    for name, t in before.items():
        assert torch.equal(tr.state.extra[name], t), name


def test_step_cost_counters_and_attribution_for_a_conv_model(flax_state):
    """``estimate_step_cost`` counts the conv model's first step (the
    convolutions' FLOPs, forward and backward), and ``fit_feed``'s
    ``counters_snapshot`` and ``attribution_report`` come out as for the
    LM: buckets that sum to 100 once a window closed."""
    class Feed(object):
        def batches(self):
            for seed in range(3):
                yield _batch(70 + seed), np.ones(BATCH, np.float32)

    tr = _port_trainer(_port_state(flax_state), log_steps=1)
    stats = tr.fit_feed(Feed())
    assert stats["global_steps"] == 3
    # the stem conv alone: 2 x B x 32 x 32 x 16 x (3 x 3 x 3) FLOP forward
    assert tr.history.step_flops > 2 * BATCH * PX * PX * 16 * 27
    snap = tr.counters_snapshot()
    assert snap["train_steps_total"] == 3
    assert snap["train_step_bytes_max"] > 0
    report = tr.attribution_report()
    assert report and sum(report.values()) == pytest.approx(100.0)
    assert snap["train_health_windows"] >= 2
