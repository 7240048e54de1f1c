"""The MoE transformer LM (``mlp="moe"``) trained and served by the port
against the JAX package: three Adam steps of the Trainer against the JAX
Trainer, ``accum_steps=2`` against the JAX accumulation (the last
micro-batch's aux term), ``remat=True`` against the JAX remat LM, and the
export served by ``ModelServer`` against the JAX ``ModelServer`` over two
rungs, with a row's logits the same alone and in a padded batch.  Sizes of
``tests/test_models.py::TestMoE``; inputs from numpy seeds; the JAX flash
path in interpret mode."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu import train as jax_train
from tensorflowonspark_tpu.models import transformer as jax_transformer
from tensorflowonspark_tpu.parallel import batch_sharding, build_mesh
from tensorflowonspark_torch import checkpoint, convert, serving, train
from tensorflowonspark_torch.models import transformer

CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
           max_seq_len=16, mlp="moe", num_experts=4)
SEQ, BATCH = 16, 8     # batch 8: one row per device of the 8-device CPU mesh
# fp32 on both sides (tests/test_torch_train.py's figures): losses to 1e-5
# relative, params after 3 steps to 1e-5 absolute; under Adam the qkv key
# bias (an exactly-zero gradient: both sides step on rounding noise) to 3
# steps x lr x 2; gradients to 1e-4 of each tensor's largest entry
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
KEY_BIAS_ATOL = 6e-3
GRAD_RTOL = 1e-4
# served logits: fp32 on both sides, 1e-4 of the largest (the dense LM's
# serving tolerance, tests/test_torch_serving.py)
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def flax_params():
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


def _assert_params_match(tr, jax_tr, key_bias_atol):
    want = _flat(jax.device_get(jax_tr.state.params))
    got = _flat(convert.transformer_params_to_flax(tr.state.params,
                                                   CFG["num_heads"]))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        if path[1:] == ("Attention_0", "qkv", "bias"):   # (3, H, Dh)
            np.testing.assert_allclose(got[path][1], arr[1], rtol=0,
                                       atol=key_bias_atol, err_msg=str(path))
            got[path], arr = got[path][::2], arr[::2]     # q and v biases
        np.testing.assert_allclose(got[path], arr, rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_steps_match_jax_trainer(flax_params, accum_steps):
    """Three steps of the flash MoE LM from the same params: Adam at
    accum_steps=1, SGD with momentum at accum_steps=2 (a masked row in
    each micro-batch of one step); the losses, the aux term (the last
    micro-batch's under accumulation) and the params."""
    if accum_steps == 1:
        make_optax = lambda: optax.adam(1e-3)
        make_torch = functools.partial(torch.optim.Adam, lr=1e-3)
        key_bias_atol = KEY_BIAS_ATOL
    else:
        make_optax = lambda: optax.sgd(0.1, momentum=0.9)
        make_torch = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
        key_bias_atol = PARAM_ATOL
    mesh = build_mesh()
    jax_tr = jax_train.Trainer(
        jax_transformer.loss_fn(jax_transformer.build_transformer(
            **CFG, attention="flash")),
        flax_params, make_optax(), mesh=mesh, batch_size=BATCH,
        accum_steps=accum_steps, step_flops_override=1)
    tr = train.Trainer(
        transformer.loss_fn(transformer.build_transformer(
            **CFG, attention="flash")),
        convert.transformer_params_from_flax(flax_params), make_torch,
        batch_size=BATCH, accum_steps=accum_steps, device="cpu")
    masks = [np.ones(BATCH, np.float32),
             np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32),
             np.ones(BATCH, np.float32)]
    for seed, mask in enumerate(masks):
        tokens = _tokens(10 + seed)
        want, want_aux = jax_tr.step(
            {"tokens": jax.device_put(tokens, batch_sharding(mesh, 1))},
            jax.device_put(mask, batch_sharding(mesh)))
        got, aux = tr.step({"tokens": tokens}, mask)
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
        np.testing.assert_allclose(aux["moe_aux_loss"].item(),
                                   float(want_aux["moe_aux_loss"]),
                                   rtol=LOSS_RTOL)
    assert tr.state.step == int(jax_tr.state.step) == 3
    _assert_params_match(tr, jax_tr, key_bias_atol)


def test_remat_matches_jax_remat_and_plain_to_the_bit(flax_params):
    """The remat MoE LM's loss, aux term and gradients against the JAX
    remat LM's, and bit-equal to the port's own remat=False: the block's
    recompute in the backward counts its aux term once."""
    tokens = _tokens(31)
    mask = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
    jax_model = jax_transformer.build_transformer(**CFG, attention="flash",
                                                  remat=True)
    (want_loss, want_aux), want = jax.jit(jax.value_and_grad(
        lambda p: jax_transformer.loss_fn(jax_model)(
            p, {"tokens": tokens}, mask), has_aux=True))(flax_params)
    want = _flat(jax.device_get(want))
    results = {}
    for remat in (True, False):
        model = transformer.build_transformer(**CFG, attention="flash",
                                              remat=remat)
        params = {k: v.requires_grad_() for k, v in
                  convert.transformer_params_from_flax(flax_params).items()}
        loss, aux = transformer.loss_fn(model)(
            params, {"tokens": torch.from_numpy(tokens)},
            torch.from_numpy(mask))
        grads = torch.autograd.grad(loss, list(params.values()))
        results[remat] = (loss, aux["moe_aux_loss"], dict(zip(params, grads)))
    (loss, aux, grads), (p_loss, p_aux, p_grads) = results[True], results[
        False]
    assert loss.item() == p_loss.item() and aux.item() == p_aux.item()
    for name, g in grads.items():
        assert torch.equal(g, p_grads[name]), name
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux.item(), float(want_aux["moe_aux_loss"]),
                               rtol=LOSS_RTOL)
    got = _flat(convert.transformer_params_to_flax(grads, CFG["num_heads"]))
    for path, arr in want.items():
        scale = max(float(np.abs(arr).max()), 1e-6)
        np.testing.assert_allclose(got[path], arr, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=str(path))


def test_served_export_matches_jax_server_per_row(flax_params, tmp_path):
    """The same MoE params exported by each package and served at batch 4
    (rungs 4 and 1 here, the 3-row request padded with a zero row): the
    logits agree, and a row's logits alone equal its logits in the
    padded batch (routing and capacity are per row)."""
    config = dict(CFG, attention="flash", capacity_factor=1.25,
                  dtype="float32")
    signature = {"tokens": {"shape": [None, SEQ], "dtype": "int32"}}
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_checkpoint.export_model(jax_dir, flax_params, "transformer_lm",
                                model_config=config,
                                input_signature=signature)
    checkpoint.export_model(
        torch_dir, convert.transformer_params_from_flax(flax_params),
        "transformer_lm", model_config=config, input_signature=signature)
    jax_server = jax_serving.ModelServer(jax_dir, batch_size=4)
    server = serving.ModelServer(torch_dir, batch_size=4, device="cpu")
    assert server.buckets == jax_server.buckets == (1, 2, 4)
    assert server.model.blocks[0].moe is not None
    rows = np.random.default_rng(3).integers(0, CFG["vocab_size"], (3, SEQ),
                                             dtype=np.int32)
    got3 = server.predict_feed({"tokens": rows}, 3)["output"]
    want3 = np.asarray(jax_server.predict_feed({"tokens": rows}, 3)[
        "output"])
    got1 = server.predict_feed({"tokens": rows[1:2]}, 1)["output"]
    want1 = np.asarray(jax_server.predict_feed({"tokens": rows[1:2]}, 1)[
        "output"])
    assert got3.shape == (3, SEQ, CFG["vocab_size"])
    for got, want in ((got3, want3), (got1, want1)):
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    assert np.abs(got1[0] - got3[1]).max() <= 1e-6 * np.abs(got3[1]).max()
    assert server.compile_count == 2
