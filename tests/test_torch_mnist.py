"""The port's MNIST CNN against the flax one: the same converted weights
and numpy inputs give the same logits, loss, accuracy and gradients, and
the conv kernel conversion round-trips exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import mnist as jax_mnist
from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import get_model, mnist

# fp32 on both sides; the convs and matmuls sum in other orders: 1e-5 of
# max|logit|, and 1e-4 of each gradient tensor's norm
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    images = rng.random((6, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)   # a padded batch
    flax_model = jax_mnist.build_mnist()
    params = flax_model.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 28, 28, 1)))["params"]
    params = jax.device_get(params)
    model = get_model("mnist_cnn")
    state = {k: v.requires_grad_() for k, v in
             convert.mnist_params_from_flax(params).items()}
    return images, labels, mask, flax_model, params, model, state


def test_logits_match_flax(setup):
    images, _, _, flax_model, params, model, state = setup
    want = np.asarray(flax_model.apply({"params": params}, images))
    got = torch.func.functional_call(model, state,
                                     (torch.from_numpy(images),))
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max()


def test_loss_aux_and_grads_match_flax(setup):
    images, labels, mask, flax_model, params, model, state = setup
    jax_loss = jax_mnist.loss_fn(flax_model)
    batch = {"image": images, "label": labels}
    (want_loss, want_aux), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params, batch, mask)
    got_loss, got_aux = mnist.loss_fn(model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(mask))
    grads = dict(zip(state, torch.autograd.grad(got_loss,
                                                list(state.values()))))
    assert abs(got_loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    assert got_aux["accuracy"].item() == float(want_aux["accuracy"])
    want_sd = convert.mnist_params_from_flax(jax.device_get(want_grads))
    for name, g in grads.items():
        want = want_sd[name]
        assert (g - want).norm() <= GRAD_TOL * want.norm(), name


def test_conv_kernel_round_trip_is_exact():
    kernel = np.random.default_rng(1).standard_normal(
        (3, 3, 5, 7)).astype(np.float32)
    weight = convert.conv_kernel_to_torch(kernel)
    assert tuple(weight.shape) == (7, 5, 3, 3)
    assert np.array_equal(convert.conv_weight_to_flax(weight), kernel)


def test_mnist_state_dict_round_trip_is_exact():
    state = get_model("mnist_cnn").state_dict()
    back = convert.mnist_params_from_flax(convert.mnist_params_to_flax(state))
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)


def test_bfloat16_model_keeps_fp32_logits():
    model = get_model("mnist_cnn", dtype="bfloat16")
    out = model(torch.rand(2, 28, 28, 1))
    assert out.dtype == torch.float32 and out.shape == (2, 10)
