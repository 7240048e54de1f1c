"""The port's ResNet loss (``tensorflowonspark_torch.models.resnet.loss_fn``)
and its BatchNorm statistics against the JAX package's: the running
averages after a train-mode forward, and the loss, accuracy, new statistics
and every gradient against ``jax.value_and_grad`` with label smoothing,
weight decay and a mask with zeros.  The models, weights and inputs are
``tests/test_torch_resnet.py``'s."""

import numpy as np
import pytest
import torch

import jax

from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import resnet

from test_torch_resnet import (MODELS, TOL, _flax_outputs, _images, _leaves,
                               _port, _variables)

# gradients, fp32: 1e-4 of each tensor's largest entry, at 32 px and batch
# 8.  The loss is not differentiable where a pre-activation sits on a ReLU's
# kink, and with about a million pre-activations (64 px, batch 16) one of
# them lies within fp32 rounding of it: the frameworks then take different
# sides and one kernel's gradient moves by a few percent of its largest
# entry.  At 32 px none does, and every gradient agrees within 2e-5.
GRAD_TOL = 1e-4
GRAD_PX, GRAD_BATCH = 32, 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_updated_batch_stats_match_flax(name):
    """The running averages after one train-mode forward: momentum 0.9 and
    the BIASED batch variance, reduced in fp32, as flax updates them."""
    _, params, stats = _variables(name)
    x = _images()
    new_stats = _flax_outputs(name, "float32")[2]
    sd, extra = convert.resnet_params_from_flax(params, stats)
    _, got = torch.func.functional_call(
        _port(name), {**sd, **extra}, (torch.from_numpy(x),),
        {"train": True})
    assert sorted(got) == sorted(extra)
    _, got_stats = convert.resnet_params_to_flax(sd, got)
    want, got_flat = _leaves(new_stats), _leaves(got_stats)
    assert sorted(want) == sorted(got_flat)
    for path, arr in want.items():
        np.testing.assert_allclose(got_flat[path], arr, rtol=0,
                                   atol=TOL["float32"] * np.abs(arr).max(),
                                   err_msg=str(path))
        # they moved: momentum 0.9 keeps 0.9 of the old value
        assert not np.allclose(arr, _leaves(stats)[path])


@pytest.mark.parametrize("name", ["resnet50_s2d", "resnet56_cifar"])
def test_loss_and_grads_match_jax(name):
    """``loss_fn`` with label smoothing 0.1 and weight decay 1e-4 on a batch
    whose mask has zeros (those rows still enter the batch statistics):
    the loss, the accuracy, the new statistics and every gradient against
    ``jax.value_and_grad`` of the JAX loss."""
    model, params, stats = _variables(name)
    x = _images(5, GRAD_BATCH, GRAD_PX)
    labels = np.random.default_rng(6).integers(
        0, MODELS[name][2]["num_classes"], GRAD_BATCH).astype(np.int32)
    mask = (np.arange(GRAD_BATCH) % 3 != 1).astype(np.float32)
    jax_loss = jax_resnet.loss_fn(model, weight_decay=1e-4,
                                  label_smoothing=0.1)
    (want, want_aux), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(params, stats,
                                {"image": x, "label": labels}, mask)
    sd, extra = convert.resnet_params_from_flax(params, stats)
    sd = {k: v.requires_grad_(True) for k, v in sd.items()}
    port_loss = resnet.loss_fn(_port(name), weight_decay=1e-4,
                               label_smoothing=0.1)
    got, aux = port_loss(sd, extra, {"image": torch.from_numpy(x),
                                     "label": torch.from_numpy(labels)},
                         torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(aux["accuracy"].item(),
                               float(want_aux["accuracy"]), rtol=1e-6)
    _, got_stats = convert.resnet_params_to_flax(sd, aux["extra_state"])
    for path, arr in _leaves(want_aux["extra_state"]).items():
        np.testing.assert_allclose(_leaves(got_stats)[path], arr, rtol=0,
                                   atol=TOL["float32"] * np.abs(arr).max())
    names = list(sd)
    grads = torch.autograd.grad(got, [sd[n] for n in names])
    got_grads, _ = convert.resnet_params_to_flax(
        dict(zip(names, grads)), extra)
    want_flat, got_flat = _leaves(want_grads), _leaves(got_grads)
    assert sorted(want_flat) == sorted(got_flat)
    for path, arr in want_flat.items():
        np.testing.assert_allclose(got_flat[path], arr, rtol=0,
                                   atol=GRAD_TOL * np.abs(arr).max(),
                                   err_msg=str(path))
