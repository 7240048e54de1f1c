"""The port's U-Net (``tensorflowonspark_torch.models.unet``) against the
flax model of the JAX package: the same numpy inputs and the same params
(converted from the flax tree) through both.

- The logits at 32 px with encoder widths (16, 32) and at 64 px with (32,
  64, 128): fp32 within 1e-5 of the largest logit, bf16 within 2e-2 (each
  framework rounds its bf16 convs, sums and casts on its own).
- ``DownBlock``, ``UpBlock`` and ``GroupNorm`` alone, at the same
  tolerances: the stride-2 SAME pads (0, 1), the transpose conv's flip and
  crop, GroupNorm's epsilon 1e-6 and fp32 statistics.
- The converter both ways, and the registry's rebuild from a state dict's
  shapes (``widths=``).
- ``loss_fn``'s loss, accuracy and gradients, and one Adam step of the
  port's Trainer against the JAX Trainer with ``optax.adam``: in float64 on
  both sides (``jax.enable_x64``) but the fp32 classifier both models
  keep, so a pre-activation within fp32 rounding of a ReLU's kink cannot
  send the two sides' gradients apart.  Loss within 1e-6 relative,
  gradients and the stepped params within 1e-5 of each tensor's largest
  value.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import train as jax_train
from tensorflowonspark_tpu.models import unet as jax_unet
from tensorflowonspark_tpu.parallel import batch_sharding, build_mesh
from tensorflowonspark_torch import convert, train
from tensorflowonspark_torch.models import get_model, unet

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [(32, (16, 32)), (64, (32, 64, 128))]
BATCH = 8          # the 8-device CPU mesh of tests/conftest.py: a row each
LR = 1e-3
LOSS_RTOL = 1e-6
STATE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _perturbed(params, seed=1, dtype=np.float32):
    """A flax tree as numpy, each leaf moved by 10% of its spread (the zero
    biases and unit scales included)."""
    rng = np.random.default_rng(seed)

    def perturb(x):
        x = np.asarray(x, dtype)
        return (x + 0.1 * (np.std(x) or 1.0)
                * rng.standard_normal(x.shape)).astype(dtype)

    return jax.tree_util.tree_map(perturb, jax.device_get(params))


@functools.lru_cache(maxsize=None)
def _flax_init(size, filters, dtype):
    model = jax_unet.build_unet(num_classes=3, dtype=dtype,
                                encoder_filters=filters)
    return model, jax.device_get(jax.jit(lambda k: model.init(
        k, jnp.zeros((1, size, size, 3)))["params"])(jax.random.PRNGKey(0)))


def _flax_unet(size, filters, dtype="float32"):
    model, params = _flax_init(size, filters, dtype)
    return model, _perturbed(params)


def _images(size, n=2, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= tol, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size,filters", CASES)
def test_logits_match_flax(size, filters, dtype):
    model, params = _flax_unet(size, filters, dtype)
    x = _images(size)
    want = np.asarray(jax.jit(model.apply)({"params": params}, x),
                      np.float32)
    sd = convert.unet_params_from_flax(params)
    port = unet.build_unet(num_classes=3, dtype=dtype,
                           encoder_filters=filters)
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == (2, size, size, 3)
    _close(got.numpy(), want, TOL[dtype])


def _nchw(x):
    """An NHWC numpy array as the port's NCHW view (channels_last)."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_down_block_matches_flax(dtype):
    x = np.random.default_rng(2).standard_normal((2, 16, 16, 12),
                                                 np.float32)
    block = jax_unet.DownBlock(24, dtype=jnp.dtype(dtype))
    params = _perturbed(block.init(jax.random.PRNGKey(0), x)["params"])
    want = block.apply({"params": params}, x)
    port = unet.DownBlock(12, 24, dtype=getattr(torch, dtype))
    port.conv.weight.data = convert.conv_kernel_to_torch(
        params["Conv_0"]["kernel"])
    port.norm.weight.data = torch.from_numpy(params["GroupNorm_0"]["scale"])
    port.norm.bias.data = torch.from_numpy(params["GroupNorm_0"]["bias"])
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.dtype == getattr(torch, dtype)
    _close(_nhwc(got), np.asarray(want, np.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [7, 8])
def test_up_block_matches_flax(dtype, size):
    """The transpose conv doubles the size (odd inputs too), flipped and
    cropped as flax's SAME aligns it, then the skip concatenated."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, size, size, 16), np.float32)
    skip = rng.standard_normal((2, 2 * size, 2 * size, 8), np.float32)
    block = jax_unet.UpBlock(8, dtype=jnp.dtype(dtype))
    params = _perturbed(block.init(jax.random.PRNGKey(0), x, skip)["params"])
    want = block.apply({"params": params}, x, skip)
    port = unet.UpBlock(16, 8, dtype=getattr(torch, dtype))
    port.conv.weight.data = convert.conv_transpose_kernel_to_torch(
        params["ConvTranspose_0"]["kernel"])
    port.norm.weight.data = torch.from_numpy(params["GroupNorm_0"]["scale"])
    port.norm.bias.data = torch.from_numpy(params["GroupNorm_0"]["bias"])
    with torch.no_grad():
        got = port(_nchw(x), _nchw(skip))
    assert got.shape == (2, 16, 2 * size, 2 * size)
    _close(_nhwc(got), np.asarray(jnp.asarray(want, jnp.float32)),
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("features", [4, 16, 32])
def test_group_norm_matches_flax(dtype, features):
    """min(8, features) groups, epsilon 1e-6, statistics in fp32 on bf16
    inputs.  A mean beside a spread a third of it shows a wrong epsilon
    (1e-5 moves the fp32 output by 5e-5) or a statistic taken in bf16; a
    spread much smaller than the mean would compare the two frameworks'
    fp32 rounding of E[x^2] - E[x]^2, not the layer."""
    rng = np.random.default_rng(4)
    x = (1.0 + 0.3 * rng.standard_normal((2, 6, 6, features))).astype(
        np.float32)
    norm = nn.GroupNorm(num_groups=min(8, features), dtype=jnp.dtype(dtype))
    params = _perturbed(norm.init(jax.random.PRNGKey(0), x)["params"])
    xin = jnp.asarray(x, jnp.dtype(dtype))
    want = norm.apply({"params": params}, xin)
    port = unet.GroupNorm(features, min(8, features),
                          dtype=getattr(torch, dtype))
    port.weight.data = torch.from_numpy(params["scale"])
    port.bias.data = torch.from_numpy(params["bias"])
    with torch.no_grad():
        got = port(_nchw(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(_nhwc(got), np.asarray(jnp.asarray(want, jnp.float32)),
           TOL[dtype])


def test_converter_round_trip_and_names():
    _, params = _flax_unet(32, (16, 32))
    sd = convert.unet_params_from_flax(params)
    port = unet.build_unet(encoder_filters=(16, 32))
    assert sorted(sd) == sorted(port.state_dict())
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    back = convert.unet_params_to_flax(sd)
    flat = jax.tree_util.tree_leaves_with_path
    got = {jax.tree_util.keystr(p): v for p, v in flat(back)}
    want = {jax.tree_util.keystr(p): v for p, v in flat(params)}
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("filters", [(16, 32), (32, 64, 128)])
def test_registry_rebuilds_widths_from_a_state_dict(filters):
    """An export's descriptor holds only ``num_classes`` and ``dtype`` (the
    JAX example's): ``get_model("unet", state_dict=sd, ...)`` reads the
    encoder widths from the shapes."""
    sd = unet.build_unet(encoder_filters=filters).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    model = get_model("unet", state_dict=sd, num_classes=3,
                      dtype="bfloat16")
    assert tuple(b.conv.weight.shape[0] for b in model.down) == filters
    model.load_state_dict(sd)
    assert model.dtype == torch.bfloat16


def test_init_follows_flax():
    """flax's initialisers: lecun-normal kernels (variance 1/fan_in, fan-in
    from the flax layout), zero biases, unit GroupNorm scales."""
    model = unet.build_unet(encoder_filters=(32, 64)).init_weights(
        torch.Generator().manual_seed(0))
    assert model.conv_in.bias.abs().max() == 0
    assert torch.all(model.down[0].norm.weight == 1)
    for w, fan_in in ((model.down[1].conv.weight, 32 * 9),
                      (model.up[0].conv.weight, 64 * 9)):
        np.testing.assert_allclose(w.var().item(), 1.0 / fan_in, rtol=0.15)
    again = unet.build_unet(encoder_filters=(32, 64)).init_weights(
        torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), again.state_dict().values()))


@pytest.fixture
def _x64():
    with jax.enable_x64(True):
        yield


def _seg_batch(size, seed, n=BATCH):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((n, size, size, 3)),
            "mask": rng.integers(0, 3, (n, size, size)).astype(np.int32)}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_tree_close(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_allclose(
            got[key], arr, rtol=0,
            atol=STATE_TOL * max(np.abs(arr).max(), 1e-3), err_msg=key)


@pytest.mark.usefixtures("_x64")
def test_loss_accuracy_and_gradients_match_jax():
    size, filters = 32, (16, 32)
    model = jax_unet.build_unet(num_classes=3, dtype="float64",
                                encoder_filters=filters)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, size, size, 3)))["params"])(jax.random.PRNGKey(0))
    params = _perturbed(params, dtype=np.float64)
    batch = _seg_batch(size, 5, n=4)
    mask = np.array([1, 1, 0, 1], np.float64)
    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(
        jax_unet.loss_fn(model), has_aux=True))(params, batch, mask)

    port = unet.build_unet(num_classes=3, dtype="float64",
                           encoder_filters=filters)
    sd = {k: v.requires_grad_() for k, v in
          convert.unet_params_from_flax(params).items()}
    assert all(v.dtype == torch.float64 for v in sd.values())
    loss, aux = unet.loss_fn(port)(
        sd, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["accuracy"].item(),
                               float(want_aux["accuracy"]), rtol=1e-6)
    grads = convert.unet_params_to_flax(
        {k: v.grad.double() for k, v in sd.items()})
    _assert_tree_close(grads, want_grads)


@pytest.mark.usefixtures("_x64")
def test_one_adam_step_matches_jax_trainer():
    """The port's Trainer with ``torch.optim.Adam`` against the JAX Trainer
    with ``optax.adam``: the loss of the step and the params after it."""
    size, filters = 32, (16, 32)
    model = jax_unet.build_unet(num_classes=3, dtype="float64",
                                encoder_filters=filters)
    params = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, size, size, 3)))["params"])(jax.random.PRNGKey(0))
    params = _perturbed(params, dtype=np.float64)
    batch = _seg_batch(size, 6)
    mask = np.ones(BATCH, np.float32)

    mesh = build_mesh()
    jax_tr = jax_train.Trainer(jax_unet.loss_fn(model), params,
                               optax.adam(LR), mesh=mesh, batch_size=BATCH,
                               step_flops_override=1)
    want, _ = jax_tr.step(
        {"image": jax.device_put(batch["image"], batch_sharding(mesh, 3)),
         "mask": jax.device_put(batch["mask"], batch_sharding(mesh, 2))},
        jax.device_put(mask, batch_sharding(mesh)))

    port = unet.build_unet(num_classes=3, dtype="float64",
                           encoder_filters=filters)
    tr = train.Trainer(unet.loss_fn(port),
                       convert.unet_params_from_flax(params),
                       functools.partial(torch.optim.Adam, lr=LR),
                       batch_size=BATCH, device="cpu")
    got, aux = tr.step(batch, mask)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert sorted(aux) == ["accuracy"]
    _assert_tree_close(convert.unet_params_to_flax(tr.state.params),
                       jax.device_get(jax_tr.state.params))
