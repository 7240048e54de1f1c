"""The Trainer's remaining options on the CPU against the JAX package's:
``accum_steps`` (twins of ``tests/test_train.py``'s ``TestGradAccum``,
then the JAX ``accum_steps=4`` step on the tiny flash LM), ``evaluate``
over ``ShardedFeed.batches(drain="all")`` on the tiny flash LM, and
``TransformerLM(remat=True)`` (logits and gradients against the JAX
``remat=True`` LM, bit-equal to the port's own ``remat=False``, the
converter, the registry and the server).  The JAX flash path runs as its
own tests run it on the CPU (interpret mode).  Inputs come from numpy
seeds and reach both sides as numpy."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import train as jax_train
from tensorflowonspark_tpu.models import transformer as jax_transformer
from tensorflowonspark_tpu.parallel import batch_sharding, build_mesh
from tensorflowonspark_tpu.parallel.infeed import ShardedFeed as JaxShardedFeed
from tensorflowonspark_torch import checkpoint, convert, serving, train
from tensorflowonspark_torch.models import get_model, transformer
from tensorflowonspark_torch.parallel.infeed import ShardedFeed

CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=16,
           max_seq_len=32)
SEQ, BATCH = 32, 8
# fp32 on both sides; the frameworks sum matmuls and the cross entropy in
# another order: 1e-5 relative on losses and metrics, 1e-5 absolute on
# params after 3 SGD steps (tests/test_torch_train.py's figures)
RTOL = 1e-5
PARAM_ATOL = 1e-5
# gradients of one step, relative to each tensor's largest entry: fp32
# sums in another order, through 2 layers
GRAD_RTOL = 1e-4
TRUE_W = np.array([3.14, 1.618], dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def flax_params():
    """An initialised flax param tree as numpy, every leaf perturbed."""
    model = jax_transformer.build_transformer(**CFG, attention="full")
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x))
                   ).astype(np.float32), params)


def _tokens(seed, batch=BATCH):
    """The JAX LM example's learnable n-gram stream."""
    offs = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                                (batch, 1))
    return ((np.arange(SEQ)[None] + offs) % CFG["vocab_size"]).astype(np.int32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree)}


# -- accum_steps on the linear regression --------------------------------------

def _jax_linear(params, batch, mask):
    pred = batch["x"] @ params["w"] + params["b"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / jnp.maximum(mask.sum(), 1.0), pred


def _torch_linear(params, batch, mask):
    pred = batch["x"] @ params["w"] + params["b"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0), pred


def _linear_batch(n=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    return {"x": x, "y": x @ TRUE_W}


def _linear_trainer(**kwargs):
    return train.Trainer(
        _torch_linear, {"w": np.zeros(2, np.float32),
                        "b": np.zeros((), np.float32)},
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        batch_size=32, log_steps=100, device="cpu", **kwargs)


def _params(tr):
    return {k: v.detach().numpy() for k, v in tr.state.params.items()}


def test_accum_matches_full_batch_and_jax():
    """accum_steps=4 gives the full-batch update, padded rows in the final
    micro-batch included, and the JAX accum_steps=4 Trainer's."""
    b = _linear_batch()
    mask = np.ones(32, np.float32)
    mask[27:] = 0.0
    full, accum = _linear_trainer(), _linear_trainer(accum_steps=4)
    mesh = build_mesh()
    jax_accum = jax_train.Trainer(
        _jax_linear, {"w": jnp.zeros((2,)), "b": jnp.zeros(())},
        optax.sgd(0.1, momentum=0.9), mesh=mesh, batch_size=32,
        accum_steps=4, log_steps=100)
    sharding = batch_sharding(mesh)
    jax_b = {k: jax.device_put(v, sharding) for k, v in b.items()}
    for _ in range(3):
        loss_f, _ = full.step(b, mask)
        loss_a, aux = accum.step(b, mask)
        want, _ = jax_accum.step(jax_b, jax.device_put(mask, sharding))
    np.testing.assert_allclose(loss_a.item(), loss_f.item(), rtol=RTOL)
    np.testing.assert_allclose(loss_a.item(), float(want), rtol=RTOL)
    assert aux.shape == (8,)                   # the last micro-batch's aux
    got = _params(accum)
    for name, value in _params(full).items():
        np.testing.assert_allclose(got[name], value, rtol=RTOL, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(
            got[name], np.asarray(jax_accum.state.params[name]), rtol=RTOL,
            atol=1e-7, err_msg=name)
    # every row masked: the weights sum to 0, divided by max(0, 1)
    zero = _linear_trainer(accum_steps=4)
    loss, _ = zero.step(b, np.zeros(32, np.float32))
    assert loss.item() == 0.0
    assert all((p == 0).all() for p in _params(zero).values())


def test_accum_rejects_indivisible_batch():
    tr = _linear_trainer(accum_steps=5)
    with pytest.raises(ValueError, match="divisible by accum_steps"):
        tr.step(_linear_batch(24))
    with pytest.raises(ValueError, match="accum_steps must be"):
        _linear_trainer(accum_steps=0)


def _matrix_loss(params, batch, mask):
    pred = batch["x"] @ params["w"]                  # (B, 128) @ (128, 128)
    err = ((pred - 1.0) ** 2).mean(-1) * mask
    return err.sum() / mask.sum().clamp_min(1.0), {}


def test_accum_step_flops_are_the_full_batch_steps():
    """The MFU numerator is the plain full-batch step's: the micro-batches'
    matrix products add up to it (the JAX Trainer counts its accumulation-
    free step)."""
    x = np.random.RandomState(0).rand(32, 128).astype(np.float32)

    def make(**kwargs):
        return train.Trainer(_matrix_loss,
                             {"w": np.zeros((128, 128), np.float32)},
                             functools.partial(torch.optim.SGD, lr=0.1),
                             device="cpu", **kwargs)

    base, acc = make(), make(accum_steps=4)
    base.step({"x": x})
    acc.step({"x": x})
    # the forward and the weight's gradient: 2 products of 2 x 32 x 128
    # x 128 (the input needs no gradient)
    assert acc.history.step_flops == base.history.step_flops == (
        2 * 2 * 32 * 128 * 128)


def test_multi_step_with_accum_equals_k_eager_steps():
    batches = [_linear_batch(32, seed) for seed in range(4)]
    eager, multi = (_linear_trainer(accum_steps=2) for _ in range(2))
    for b in batches:
        want, _ = eager.step(b)
    got = multi.multi_step({k: np.stack([b[k] for b in batches])
                            for k in batches[0]},
                           np.ones((4, 32), np.float32))
    assert got.item() == want.item()
    assert multi.state.step == eager.state.step == 4
    for name, value in _params(eager).items():
        np.testing.assert_array_equal(_params(multi)[name], value)


# -- the tiny flash LM ---------------------------------------------------------

def test_accum_lm_matches_jax_accum(flax_params):
    """Three SGD-momentum steps of the flash LM at accum_steps=4 (micro-
    batches of 2 rows; one row masked in each of two of them) against the
    JAX Trainer's accum_steps=4 step."""
    mesh = build_mesh()
    jax_tr = jax_train.Trainer(
        jax_transformer.loss_fn(jax_transformer.build_transformer(
            **CFG, attention="flash")),
        flax_params, optax.sgd(0.1, momentum=0.9), mesh=mesh,
        batch_size=BATCH, accum_steps=4, step_flops_override=1)
    tr = train.Trainer(
        transformer.loss_fn(transformer.build_transformer(
            **CFG, attention="flash")),
        convert.transformer_params_from_flax(flax_params),
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        batch_size=BATCH, accum_steps=4, device="cpu")
    mask = np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32)
    for seed in range(3):
        tokens = _tokens(20 + seed)
        want, _ = jax_tr.step(
            {"tokens": jax.device_put(tokens, batch_sharding(mesh, 1))},
            jax.device_put(mask, batch_sharding(mesh)))
        got, _ = tr.step({"tokens": tokens}, mask)
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    want = _flat(jax.device_get(jax_tr.state.params))
    got = _flat(convert.transformer_params_to_flax(tr.state.params,
                                                   CFG["num_heads"]))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        np.testing.assert_allclose(got[path], arr, rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(path))


class _TokenRows(object):
    """``n`` rows of the n-gram stream served like a DataFeed's columnar
    path (``next_batch_arrays``)."""

    def __init__(self, n, seed=7):
        self.tokens = _tokens(seed, n)
        self.pos = 0
        self.done = False

    def next_batch_arrays(self, n):
        rows = self.tokens[self.pos:self.pos + n]
        self.pos += len(rows)
        if len(rows) < n:
            self.done = True
        return {"tokens": rows}, len(rows)

    def should_stop(self):
        return self.done

    def interrupt(self):
        pass

    def terminate(self):
        pass


def _jax_metric(model):
    def metric(params, batch, mask):
        tokens = batch["tokens"]
        logits = model.apply({"params": params}, tokens)
        targets = jnp.roll(tokens, -1, axis=1)
        pos = jnp.ones(SEQ).at[-1].set(0.0)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
        hit = (logits.argmax(-1) == targets).astype(jnp.float32)
        row_ce = (ce * pos).sum(-1) / pos.sum()
        row_acc = (hit * pos).sum(-1) / pos.sum()
        return ({"loss": (row_ce * mask).sum(),
                 "accuracy": (row_acc * mask).sum()}, mask.sum())
    return metric


def _torch_metric(model):
    def metric(params, batch, mask):
        tokens = batch["tokens"].long()
        logits = torch.func.functional_call(model, params, (tokens,))
        targets = torch.roll(tokens, -1, dims=1)
        pos = (torch.arange(SEQ) < SEQ - 1).float()
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1),
                             reduction="none").reshape(tokens.shape)
        hit = (logits.argmax(-1) == targets).float()
        row_ce = (ce * pos).sum(-1) / pos.sum()
        row_acc = (hit * pos).sum(-1) / pos.sum()
        return ({"loss": (row_ce * mask).sum(),
                 "accuracy": (row_acc * mask).sum()}, mask.sum())
    return metric


def test_evaluate_matches_jax_on_the_flash_lm(flax_params):
    """20 rows in batches of 8 (two full, one padded to 4 real rows) with
    drain="all": every real row counts once, padded rows not at all."""
    mesh = build_mesh()
    jax_tr = jax_train.Trainer(
        jax_transformer.loss_fn(jax_transformer.build_transformer(
            **CFG, attention="flash")),
        flax_params, optax.sgd(0.1), mesh=mesh, batch_size=BATCH,
        step_flops_override=1)
    want = jax_tr.evaluate(
        JaxShardedFeed(_TokenRows(20), mesh, BATCH, prefetch=0),
        _jax_metric(jax_transformer.build_transformer(**CFG,
                                                      attention="flash")),
        cache_key="lm")
    model = transformer.build_transformer(**CFG, attention="flash")
    tr = train.Trainer(transformer.loss_fn(model),
                       convert.transformer_params_from_flax(flax_params),
                       functools.partial(torch.optim.SGD, lr=0.1),
                       batch_size=BATCH, device="cpu")
    seen = []
    metric = _torch_metric(model)

    def counted(params, batch, mask):
        seen.append((torch.is_grad_enabled(), float(mask.sum())))
        return metric(params, batch, mask)

    got = tr.evaluate(ShardedFeed(_TokenRows(20), BATCH, device="cpu"),
                      counted, cache_key="lm")
    assert seen == [(False, 8.0), (False, 8.0), (False, 4.0)]
    assert sorted(got) == sorted(want) == ["accuracy", "loss"]
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=RTOL, err_msg=name)
    # the same over the 20 rows in one pass, by hand
    params = convert.transformer_params_from_flax(flax_params)
    sums, weight = metric(params, {"tokens": torch.from_numpy(
        _tokens(7, 20))}, torch.ones(20))
    for name, value in sums.items():
        np.testing.assert_allclose(got[name], value.item() / weight.item(),
                                   rtol=RTOL, err_msg=name)
    assert tr.state.step == 0
    assert all(p.grad is None for p in tr.state.params.values())


# -- remat ---------------------------------------------------------------------

def _jax_remat_run(model, flax_params, tokens, mask):
    """Loss, gradients and logits of the JAX LM, in one compile."""
    def fn(p):
        loss = jax_transformer.loss_fn(model)(p, {"tokens": tokens}, mask)[0]
        return loss, model.apply({"params": p}, tokens)

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        fn, has_aux=True))(flax_params)
    return float(loss), _flat(jax.device_get(grads)), np.asarray(logits)


def _torch_loss_and_grads(params, tokens, mask, remat):
    model = transformer.build_transformer(**CFG, attention="flash",
                                          remat=remat)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = transformer.loss_fn(model)(
        params, {"tokens": torch.from_numpy(tokens)}, torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, dict(zip(params, grads))


def test_remat_matches_jax_remat_and_plain_to_the_bit(flax_params):
    """The flax ``nn.remat(Block)`` tree has the plain tree's names (the
    converter maps it as is); the port's remat LM gives the JAX remat LM's
    loss and gradients, and its own remat=False gradients bit for bit."""
    jax_remat = jax_transformer.build_transformer(**CFG, attention="flash",
                                                  remat=True)
    tree = jax.eval_shape(jax_remat.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, SEQ), jnp.int32))["params"]
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(flax_params))
    tokens = _tokens(31)
    mask = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
    params = convert.transformer_params_from_flax(flax_params)
    loss, grads = _torch_loss_and_grads(params, tokens, mask, remat=True)
    plain_loss, plain_grads = _torch_loss_and_grads(params, tokens, mask,
                                                    remat=False)
    assert loss.item() == plain_loss.item()
    for name, g in grads.items():
        assert torch.equal(g, plain_grads[name]), name
    want_loss, want, want_logits = _jax_remat_run(jax_remat, flax_params,
                                                  tokens, mask)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=RTOL)
    got = _flat(convert.transformer_params_to_flax(grads, CFG["num_heads"]))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        scale = max(float(np.abs(arr).max()), 1e-6)
        np.testing.assert_allclose(got[path], arr, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=str(path))
    # the logits: the forward is the plain model's
    model = transformer.build_transformer(**CFG, attention="flash",
                                          remat=True)
    with torch.no_grad():
        logits = torch.func.functional_call(model, params,
                                            (torch.from_numpy(tokens),))
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=1e-4)


def test_remat_trains_like_plain_and_serves_without_recompute(
        flax_params, tmp_path, monkeypatch):
    """A remat=True Trainer takes the plain Trainer's steps bit for bit;
    its export rebuilds through the registry with remat=True, and the
    server, which records no gradients, never calls the checkpoint."""
    config = dict(CFG, attention="flash", remat=True)
    trainers = {}
    for remat in (False, True):
        model = get_model("transformer_lm", **dict(config, remat=remat))
        assert model.remat is remat
        trainers[remat] = train.Trainer(
            transformer.loss_fn(model),
            convert.transformer_params_from_flax(flax_params),
            functools.partial(torch.optim.Adam, lr=1e-3), batch_size=BATCH,
            device="cpu")
        for seed in range(2):
            trainers[remat].step({"tokens": _tokens(40 + seed)})
    for name, t in trainers[False].state.params.items():
        assert torch.equal(trainers[True].state.params[name], t), name
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    checkpoint.export_model(
        str(tmp_path), trainers[True].state.params, "transformer_lm",
        model_config=config,
        input_signature={"tokens": {"shape": [None, SEQ], "dtype": "int32"}})
    server = serving.ModelServer(str(tmp_path), batch_size=4, device="cpu")
    assert server.model.remat is True
    request = _tokens(50, 4)
    served = server.predict_feed({"tokens": request}, 4)["output"]
    assert calls == []
    with torch.no_grad():
        want = torch.func.functional_call(
            server.model, trainers[True].state.params,
            (torch.from_numpy(request),)).numpy()
    np.testing.assert_array_equal(served, want)
    # a training step does go through it, once per block
    trainers[True].step({"tokens": _tokens(42)})
    assert len(calls) == CFG["num_layers"]
