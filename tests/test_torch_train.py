"""The port's training path against the JAX package's: the LM loss, three
Trainer steps from converted weights under Adam and SGD with momentum,
``fit_feed``, resume from a checkpoint and the step-FLOP count.  Inputs
come from numpy seeds and reach both sides as numpy.
``tests/test_torch_checkpoint.py`` holds the metrics recorder and the
checkpoint manager."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import train as jax_train
from tensorflowonspark_tpu.models import transformer as jax_transformer
from tensorflowonspark_tpu.parallel import batch_sharding, build_mesh
from tensorflowonspark_torch import checkpoint, convert, train
from tensorflowonspark_torch.models import transformer

from torch_world import run_world

# batch 8: the 8-device CPU mesh of tests/conftest.py shards it one row per
# device on the JAX side
CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=16,
           max_seq_len=32)
SEQ, BATCH = 32, 8
# fp32 on both sides; the frameworks sum matmuls and the cross entropy in
# another order: 1e-5 relative on the loss
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes run as fast on one, and the suite's
    parallel workers share the machine's cores with timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def flax_params():
    """An initialised flax param tree as numpy, every leaf perturbed so that
    zero biases and unit LayerNorm scales are exercised too."""
    model = jax_transformer.build_transformer(**CFG, attention="full")
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x))
                   ).astype(np.float32), params)


def _tokens(seed, batch=BATCH):
    """The JAX LM example's learnable n-gram stream: rows of consecutive
    tokens from random offsets."""
    offs = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                                (batch, 1))
    return ((np.arange(SEQ)[None] + offs) % CFG["vocab_size"]).astype(np.int32)


def _torch_model(attention="flash", dtype="float32"):
    return transformer.build_transformer(**CFG, attention=attention,
                                         dtype=dtype)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_loss_matches_jax(flax_params, attention):
    jax_model = jax_transformer.build_transformer(**CFG, attention=attention)
    tokens = _tokens(1)
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)   # rows zeroed
    want, _ = jax.jit(jax_transformer.loss_fn(jax_model))(
        flax_params, {"tokens": jnp.asarray(tokens)}, jnp.asarray(mask))
    params = convert.transformer_params_from_flax(flax_params)
    loss = transformer.loss_fn(_torch_model(attention))
    got, aux = loss(params, {"tokens": torch.from_numpy(tokens)},
                    torch.from_numpy(mask))
    assert aux == {} and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    # all rows masked: the mask-weighted mean divides by max(sum, 1)
    zero, _ = loss(params, {"tokens": torch.from_numpy(tokens)},
                   torch.zeros(BATCH))
    assert zero.item() == 0.0


# after 3 steps: fp32 gradients agree to about 1e-6 relative, and both
# optimizers turn that into parameter differences far inside 1e-5.  One
# exception: the key bias of the qkv projection has a gradient that is zero
# in exact arithmetic (adding a constant to every key's score leaves each
# softmax row unchanged), so both frameworks compute rounding noise there,
# and Adam, which divides by the gradient's own scale, turns noise of either
# sign into steps of up to about lr.  That slice is held to 3 steps x lr x 2.
OPTIMIZERS = {
    "adam": (lambda: optax.adam(1e-3),
             functools.partial(torch.optim.Adam, lr=1e-3), 1e-5, 6e-3),
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
                     1e-5, 1e-5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_steps_match_jax_trainer(flax_params, name):
    make_optax, make_torch, param_atol, key_bias_atol = OPTIMIZERS[name]
    mesh = build_mesh()
    jax_model = jax_transformer.build_transformer(**CFG, attention="flash")
    # step_flops_override: skips the JAX Trainer's cost-analysis compile,
    # a second compile of the step this test does not need
    jax_tr = jax_train.Trainer(jax_transformer.loss_fn(jax_model),
                               flax_params, make_optax(), mesh=mesh,
                               batch_size=BATCH, step_flops_override=1)
    tr = train.Trainer(transformer.loss_fn(_torch_model("flash")),
                       convert.transformer_params_from_flax(flax_params),
                       make_torch, batch_size=BATCH, device="cpu")
    for seed in range(3):
        tokens = _tokens(10 + seed)
        want, _ = jax_tr.step(
            {"tokens": jax.device_put(tokens, batch_sharding(mesh, 1))},
            jax.device_put(np.ones(BATCH, np.float32), batch_sharding(mesh)))
        got, _ = tr.step({"tokens": tokens})
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert tr.state.step == int(jax_tr.state.step) == 3
    want = _flat(jax.device_get(jax_tr.state.params))
    got = _flat(convert.transformer_params_to_flax(tr.state.params,
                                                   CFG["num_heads"]))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        if path[1:] == ("Attention_0", "qkv", "bias"):   # (3, H, Dh)
            np.testing.assert_allclose(got[path][1], arr[1], rtol=0,
                                       atol=key_bias_atol, err_msg=str(path))
            got[path], arr = got[path][::2], arr[::2]     # q and v biases
        np.testing.assert_allclose(got[path], arr, rtol=0, atol=param_atol,
                                   err_msg=str(path))


class _Feed(object):
    """A feed as ``fit_feed`` duck-types it: ``batches()`` of ``(batch,
    mask)``, ``terminate()`` and ``counters_snapshot()``."""

    def __init__(self, n):
        self.n = n
        self.yielded = 0
        self.terminated = False

    def batches(self):
        for i in range(self.n):
            if self.terminated:
                return
            self.yielded += 1
            yield {"tokens": _tokens(100 + i)}, np.ones(BATCH, np.float32)

    def grouped_batches(self, k):
        """K-step groups of the same batches, as ``ShardedFeed`` yields
        them, the last group short of K as singles."""
        items = list(self.batches())
        for start in range(0, len(items) - len(items) % k, k):
            group = items[start:start + k]
            yield ("multi",
                   {"tokens": np.stack([b["tokens"] for b, _ in group])},
                   np.stack([m for _, m in group]))
        for batch, mask in items[len(items) - len(items) % k:]:
            yield ("single", batch, mask)

    def terminate(self):
        self.terminated = True

    def counters_snapshot(self):
        return {"infeed_batches": self.yielded}


def _trainer(flax_params, **kwargs):
    kwargs.setdefault("device", "cpu")
    return train.Trainer(transformer.loss_fn(_torch_model()),
                         convert.transformer_params_from_flax(flax_params),
                         functools.partial(torch.optim.SGD, lr=0.1),
                         batch_size=BATCH, **kwargs)


def test_fit_feed_max_steps_hook_and_stats(flax_params):
    tr = _trainer(flax_params, log_steps=2)
    tr.step({"tokens": _tokens(99)})         # counts toward max_steps
    seen, feed = [], _Feed(10)
    stats = tr.fit_feed(feed, max_steps=5, on_steps=seen.append)
    assert seen == [2, 3, 4, 5] and tr.state.step == 5
    assert feed.terminated and feed.yielded == 4
    assert stats["global_steps"] == 5 and np.isfinite(stats["loss"])
    overlap = stats["overlap"]
    assert overlap["dispatch_count"] == 4 and overlap["infeed_batches"] == 4
    assert overlap["train_steps_total"] == 5
    assert overlap["train_health_windows"] == 2      # windows at steps 2, 4
    assert np.isfinite(overlap["train_loss_max"])
    assert stats["megastep"]["steps_per_call"] == 1
    # a feed that ends before max_steps ends the loop without terminate()
    short = _Feed(2)
    tr.fit_feed(short, max_steps=100)
    assert tr.state.step == 7 and not short.terminated
    # four steps a dispatch: one group of 4, then a single
    grouped, seen = _Feed(5), []
    stats = tr.fit_feed(grouped, steps_per_call=4, on_steps=seen.append)
    assert seen == [11, 12] and tr.state.step == 12
    assert stats["megastep"]["steps_per_call"] == 4
    assert stats["overlap"]["train_steps_per_call_max"] == 4


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_step_flops_count_plus_extra(flax_params, attention):
    """FlopCounterMode counts every matmul of a step (forward and
    backward); ``extra_step_flops`` adds what it cannot see.  On CPU
    tensors the flash plain version runs as einsums and is counted too."""
    d = CFG["num_heads"] * CFG["head_dim"]
    layers, vocab = CFG["num_layers"], CFG["vocab_size"]
    dense = BATCH * SEQ * (24 * d * d * layers + 2 * d * vocab)
    # one [B, H, S, S, D] contraction, counted at 2 FLOPs per product
    contraction = 2 * BATCH * CFG["num_heads"] * SEQ * SEQ * CFG["head_dim"]
    # full: QK^T and PV forward, twice each backward; flash plain: the
    # same 2 forward, 7 backward (P and dP recomputed in each of dQ and
    # dK/dV, then dQ, dK, dV)
    attn = {"full": 6, "flash": 9}[attention] * contraction * layers
    extra = 12345
    tr = train.Trainer(
        transformer.loss_fn(_torch_model(attention)),
        convert.transformer_params_from_flax(flax_params),
        functools.partial(torch.optim.SGD, lr=0.1), device="cpu",
        extra_step_flops=extra)
    tr.step({"tokens": _tokens(3)})
    assert tr.history.step_flops == 3 * dense + attn + extra
    tr.reset_history()
    assert tr.history.step_flops == 3 * dense + attn + extra
    override = train.Trainer(
        transformer.loss_fn(_torch_model(attention)),
        convert.transformer_params_from_flax(flax_params),
        functools.partial(torch.optim.SGD, lr=0.1), device="cpu",
        extra_step_flops=extra, step_flops_override=777)
    assert override.compile_and_measure({"tokens": _tokens(3)}) == 777


def test_compile_and_measure_leaves_params(flax_params):
    tr = _trainer(flax_params, extra_step_flops=5)
    before = {k: v.detach().clone() for k, v in tr.state.params.items()}
    flops = tr.compile_and_measure({"tokens": _tokens(4)})
    assert flops > 5 and tr.history.step_flops == flops
    assert tr.state.step == 0
    assert all(p.grad is None for p in tr.state.params.values())
    for name, t in tr.state.params.items():
        assert torch.equal(t, before[name]), name


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_resume_equals_continue(flax_params, tmp_path, name):
    """Train 4 steps with a checkpoint every 2; a fresh Trainer restored
    from step 4 takes steps 5 and 6 exactly as the original does (params
    and optimizer state come back)."""
    make_torch = OPTIMIZERS[name][1]

    def fresh():
        return train.Trainer(transformer.loss_fn(_torch_model()),
                             convert.transformer_params_from_flax(flax_params),
                             make_torch, batch_size=BATCH, device="cpu")

    tr = fresh()
    mgr = checkpoint.CheckpointManager(str(tmp_path), save_interval_steps=2)
    tr.fit_feed(_Feed(4), on_steps=lambda s: mgr.maybe_save(s, tr.state))
    mgr.wait_until_finished()
    resumed = fresh()
    assert resumed.restore_latest(mgr) == 4 and resumed.state.step == 4
    for seed in (50, 51):
        want, _ = tr.step({"tokens": _tokens(seed)})
        got, _ = resumed.step({"tokens": _tokens(seed)})
        assert got.item() == want.item()
    for key, t in tr.state.params.items():
        assert torch.equal(resumed.state.params[key], t), key
    assert resumed.state.step == tr.state.step == 6
    mgr.close()
    assert fresh().restore_latest(
        checkpoint.CheckpointManager(str(tmp_path / "none"))) is None


def test_trainer_without_cpu_raises_when_no_cuda(flax_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _trainer(flax_params, device=None)


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()}, {"param_sharding": "fsdp"}, {"accum_steps": 2},
    {"aot_cache": "/nonexistent"}, {"summary_writer": "tfevents"},
])
def test_unported_trainer_arguments_raise(flax_params, kwargs, tmp_path):
    name = next(iter(kwargs))
    if name == "accum_steps":
        # ported: two micro-batches of 4 rows give the full-batch step
        # (tests/test_torch_evaluate_accum.py holds it against the JAX
        # Trainer)
        tr, full = _trainer(flax_params, **kwargs), _trainer(flax_params)
        got, _ = tr.step({"tokens": _tokens(5)})
        want, _ = full.step({"tokens": _tokens(5)})
        np.testing.assert_allclose(got.item(), want.item(), rtol=LOSS_RTOL)
        return
    if name == "summary_writer":
        # ported: a real writer is accepted and gets the window's scalars
        from tensorflowonspark_torch import summary

        with summary.SummaryWriter(str(tmp_path)) as writer:
            tr = _trainer(flax_params, summary_writer=writer, log_steps=1)
            tr.step({"tokens": _tokens(5)})
        assert os.path.getsize(writer.path) > 100
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _trainer(flax_params, **kwargs)
    # the JAX defaults are accepted
    _trainer(flax_params, **{name: train._UNPORTED[name][0]})


def test_unported_trainer_methods_raise(flax_params, tmp_path):
    """multi_step and repeat_step are ported (K steps equal K single
    steps; tests/test_torch_megastep.py holds them against the JAX
    Trainer); so is restore_latest(validate=True)
    (tests/test_torch_supervised.py), which finds nothing in an empty
    directory."""
    single, multi, rep = (_trainer(flax_params) for _ in range(3))
    batches = [{"tokens": _tokens(60 + i)} for i in range(2)]
    for b in batches:
        want, _ = single.step(b)
    got = multi.multi_step(
        {"tokens": np.stack([b["tokens"] for b in batches])},
        np.ones((2, BATCH), np.float32))
    np.testing.assert_allclose(got.item(), want.item(), rtol=LOSS_RTOL)
    rep.repeat_step(batches[0], None, 2)
    assert multi.state.step == rep.state.step == 2
    for name, t in single.state.params.items():
        np.testing.assert_allclose(multi.state.params[name].detach().numpy(),
                                   t.detach().numpy(), rtol=0, atol=1e-6)
    assert single.restore_latest(checkpoint.CheckpointManager(
        str(tmp_path)), validate=True) is None
    assert single.state.step == 2


def test_corrupt_batch_maps_over_the_whole_tree(monkeypatch):
    """The NaN-batch fault reaches every floating leaf of a nested batch
    (tensors and arrays, in dicts, lists and tuples), leaves integer leaves
    alone, and fires once."""
    from tensorflowonspark_torch import fault

    monkeypatch.setenv("TFOS_FAULT_SPEC", '{"nan_batch_at_step": 3}')
    injector = fault.from_env()
    batch = {"x": (torch.ones(2, 3), torch.arange(4)),
             "y": {"z": np.ones((2,), np.float32),
                   "ids": [np.arange(3)]}}
    assert injector.corrupt_batch(batch, 2) is batch      # not yet
    out = injector.corrupt_batch(batch, 3)
    assert torch.isnan(out["x"][0]).all() and isinstance(out["x"], tuple)
    assert torch.equal(out["x"][1], torch.arange(4))
    assert np.isnan(out["y"]["z"]).all()
    assert np.array_equal(out["y"]["ids"][0], np.arange(3))
    assert injector.corrupt_batch(batch, 4) is batch      # fired once


# the global batch of a padded final step: 6 valid rows of 8
_PADDED_MASK = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)


def _sgd_trainer(state):
    return train.Trainer(
        transformer.loss_fn(_torch_model()),
        {k: torch.from_numpy(v) for k, v in state.items()},
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        batch_size=BATCH, device="cpu")


def _dist_step(rank, state, tokens, mask):
    """One Trainer step of this rank's half of the global batch (rows
    ``4 * rank`` on), twice so momentum carries; returns the losses and
    params."""
    torch.set_num_threads(1)
    tr = _sgd_trainer(state)
    rows = slice(4 * rank, 4 * rank + 4)
    losses = [tr.step({"tokens": tokens[rows]}, mask[rows])[0].item()
              for _ in range(2)]
    return losses, {k: v.detach().numpy() for k, v in tr.state.params.items()}


def test_two_process_step_equals_global_batch_step(flax_params):
    """Two gloo ranks, each with half of a padded global batch (4 and 2
    valid rows), step exactly as one process on the whole batch: the
    masked mean is over the global valid rows (not a mean of the local
    means), and both ranks apply the same gradients."""
    state = {k: v.numpy() for k, v in
             convert.transformer_params_from_flax(flax_params).items()}
    tokens = _tokens(7)
    tr = _sgd_trainer(state)
    want_losses = [tr.step({"tokens": tokens}, _PADDED_MASK)[0].item()
                   for _ in range(2)]
    ranks = run_world(_dist_step, 2, state, tokens, _PADDED_MASK)
    for losses, params in ranks:
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-6)
        for name, want in tr.state.params.items():
            np.testing.assert_allclose(params[name], want.detach().numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
    for name in ranks[0][1]:
        assert np.array_equal(ranks[0][1][name], ranks[1][1][name]), name
