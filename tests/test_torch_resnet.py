"""The port's ResNets (``tensorflowonspark_torch.models.resnet``) against the
flax models of the JAX package: forward logits of ``resnet50`` with both
stems and of ``resnet56_cifar`` in eval and train mode, the updated
s2d stem's kernel map, the converter round trip and the port's own init
(``tests/test_torch_resnet_loss.py`` holds the updated BatchNorm statistics
and the loss with its gradients).  Inputs and weights come from numpy
seeds; small shapes (one block a stage, 64 px)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import resnet as jax_resnet
from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import get_model
from tensorflowonspark_torch.models import resnet

PX, BATCH, CLASSES = 64, 16, 7
# fp32 on both sides, sums in another order: 1e-4 of the largest logit (and
# of each statistic's largest value).  bf16: the frameworks round the
# activations to bf16 at the same points from fp32 values that differ in
# the last bits, and a flip of one bf16 step carries through the layers:
# 2e-2 of the largest logit.  Batch 16 at 64 px: train-mode BatchNorm
# divides by the batch's spread, which at 32 px and batch 6 the last stage
# takes from 6 values a channel and bf16 rounding then moves by percents.
# In train mode each side's bf16 logits are 1.1-2.7% of the largest logit
# from its own fp32 logits (measured over 3 inputs, both stems), XLA
# keeping some fused intermediates in fp32 that the port rounds to bf16:
# the two are held to 3e-2 of each other, and the port's to 3e-2 of the
# fp32 reference
TRAIN_BF16_TOL = 3e-2
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

MODELS = {
    "resnet50_conv7": (jax_resnet.build_resnet50, "resnet50",
                       dict(num_classes=CLASSES, blocks_per_stage=1,
                            stem="conv7")),
    "resnet50_s2d": (jax_resnet.build_resnet50, "resnet50",
                     dict(num_classes=CLASSES, blocks_per_stage=1,
                          stem="s2d")),
    "resnet56_cifar": (jax_resnet.build_resnet56, "resnet56_cifar",
                       dict(num_classes=10, blocks_per_stage=1)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _init(name):
    """``MODELS[name]``'s fp32 flax init (params are fp32 whatever the
    compute dtype) as numpy, every leaf perturbed (so zero BatchNorm
    scales, zero biases, zero means and unit variances are exercised
    too)."""
    build, _, kw = MODELS[name]
    model = build(**kw, dtype="float32")
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, PX, PX, 3)), train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(x):
        # 10% of the leaf's spread (of 1 for a constant leaf): kernels keep
        # their init scale, so the logits stay O(1)
        x = np.asarray(x)
        return x + 0.1 * (np.std(x) or 1.0) * rng.standard_normal(x.shape)

    params = jax.tree_util.tree_map(
        lambda x: perturb(x).astype(np.float32), variables["params"])
    stats = jax.tree_util.tree_map(
        lambda x: np.abs(perturb(x)).astype(np.float32),
        variables["batch_stats"])
    return params, stats


def _variables(name, dtype="float32"):
    """A flax model of ``MODELS[name]`` computing in ``dtype``, with the
    params and batch_stats of :func:`_init`."""
    build, _, kw = MODELS[name]
    return (build(**kw, dtype=dtype),) + _init(name)


@functools.lru_cache(maxsize=None)
def _flax_outputs(name, dtype, model_dtype=None):
    """The flax model's eval logits, train logits and updated batch_stats
    on ``_images()`` with ``_variables(name, dtype)``, from one jitted call
    (an eager apply runs op by op); ``model_dtype`` computes them in
    another dtype (the fp32 reference of a bf16 case)."""
    model = _variables(name, model_dtype or dtype)[0]
    _, params, stats = _variables(name, dtype)

    def both(v, x):
        logits, new = model.apply(v, x, train=True, mutable=["batch_stats"])
        return model.apply(v, x, train=False), logits, new["batch_stats"]

    out = jax.jit(both)({"params": params, "batch_stats": stats}, _images())
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), out)


def _port(name, dtype="float32"):
    _, registered, kw = MODELS[name]
    return get_model(registered, dtype=dtype, **kw)


def _images(seed=1, batch=BATCH, px=PX):
    return np.random.default_rng(seed).standard_normal(
        (batch, px, px, 3)).astype(np.float32)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_leaves(val, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


# the CIFAR model is fp32 (build_resnet56's default); bf16 is held on the
# two ImageNet stems
LOGIT_CASES = [("resnet50_conv7", "float32"), ("resnet50_conv7", "bfloat16"),
               ("resnet50_s2d", "float32"), ("resnet50_s2d", "bfloat16"),
               ("resnet56_cifar", "float32")]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,dtype", LOGIT_CASES)
def test_logits_match_flax(name, dtype, train):
    _, params, stats = _variables(name, dtype)
    x = _images()
    sd, extra = convert.resnet_params_from_flax(params, stats)
    port = _port(name, dtype)
    want = _flax_outputs(name, dtype)[1 if train else 0]
    if train:
        got, _ = torch.func.functional_call(
            port, {**sd, **extra}, (torch.from_numpy(x),), {"train": True})
    else:
        got = torch.func.functional_call(port, {**sd, **extra},
                                         (torch.from_numpy(x),))
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.detach().numpy()
    tol = TOL[dtype]
    if train and dtype == "bfloat16":
        tol = TRAIN_BF16_TOL
        exact = _flax_outputs(name, dtype, model_dtype="float32")[1]
        np.testing.assert_allclose(got, exact, rtol=0,
                                   atol=tol * np.abs(exact).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_s2d_stem_kernel_is_the_jax_map_and_equivalent():
    """The port's numpy copy of ``s2d_stem_kernel`` equals the JAX one, and
    a conv7 model and an s2d model whose stem kernel is its image give the
    same logits (fp32), in both packages' sense of the s2d layout."""
    k7 = np.random.default_rng(3).standard_normal((7, 7, 3, 64)).astype(
        np.float32)
    np.testing.assert_array_equal(resnet.s2d_stem_kernel(k7),
                                  np.asarray(jax_resnet.s2d_stem_kernel(k7)))
    x = torch.from_numpy(_images(4))
    gen = torch.Generator().manual_seed(0)
    conv7 = _port("resnet50_conv7").init_weights(gen)
    s2d = _port("resnet50_s2d")
    state = dict(conv7.state_dict())
    stem = convert.conv_weight_to_flax(state["stem_conv.weight"])
    state["stem_conv.weight"] = convert.conv_kernel_to_torch(
        resnet.s2d_stem_kernel(stem))
    s2d.load_state_dict(state)
    want = conv7(x).detach().numpy()
    np.testing.assert_allclose(s2d(x).detach().numpy(), want, rtol=0,
                               atol=TOL["float32"] * np.abs(want).max())
    # the layout: pixel (2i+a, 2j+b, c) in channel (2a+b)*C + c
    img = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    np.testing.assert_array_equal(
        resnet.space_to_depth(img).numpy(),
        np.asarray(jax_resnet.space_to_depth(jnp.asarray(img.numpy()))))
    with pytest.raises(ValueError, match="divisible"):
        resnet.space_to_depth(torch.zeros(1, 5, 4, 3))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_converter_round_trip(name):
    """flax params and batch_stats -> the port's params and extra state
    (exactly the model's parameters and buffers) -> flax, bit for bit."""
    _, params, stats = _variables(name)
    sd, extra = convert.resnet_params_from_flax(params, stats)
    port_params, port_extra = resnet.split_state(_port(name))
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in port_params.items()}
    assert {k: tuple(v.shape) for k, v in extra.items()} == \
        {k: tuple(v.shape) for k, v in port_extra.items()}
    back_params, back_stats = convert.resnet_params_to_flax(sd, extra)
    for want, got in ((params, back_params), (stats, back_stats)):
        want, got = _leaves(want), _leaves(got)
        assert sorted(want) == sorted(got)
        for path, arr in want.items():
            np.testing.assert_array_equal(got[path], arr, err_msg=str(path))


def test_init_follows_flax():
    """The port's own init (chip_smoke.py's models have no flax to convert
    from): zero scale on each block's last BatchNorm, unit scales
    elsewhere, zero biases and means, unit variances, kernels of variance
    about 1/fan_in."""
    port = get_model("resnet50", num_classes=CLASSES, blocks_per_stage=1,
                     dtype="float32").init_weights(
                         torch.Generator().manual_seed(0))
    sd = dict(port.state_dict())
    for i in range(4):
        assert float(sd["blocks.%d.norms.2.weight" % i].abs().max()) == 0.0
        assert float(sd["blocks.%d.norms.0.weight" % i].min()) == 1.0
        assert float(sd["blocks.%d.norms.3.running_var" % i].min()) == 1.0
    assert float(sd["stem_norm.running_mean"].abs().max()) == 0.0
    w = sd["blocks.3.convs.1.weight"]
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.var()) * fan_in - 1.0) < 0.05


def test_unknown_stem_raises():
    with pytest.raises(ValueError, match="stem"):
        get_model("resnet50", stem="conv3")
