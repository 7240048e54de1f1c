"""The port's ``linear`` and ``two_tower`` models against the flax ones:
a converted flax init gives the same outputs and the same masked MSE
(fp32: 1e-6), the converters round-trip, and the registry sizes each model
from a state dict's shapes while the descriptor keeps the JAX
``model_config``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import get_model as jax_get_model
from tensorflowonspark_tpu.models import linear as jax_linear
from tensorflowonspark_tpu.models import twotower as jax_twotower
from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import get_model, linear, twotower

# fp32 on both sides, sums of a handful of products: 1e-6
TOL = 1e-6
# bf16 towers: both sides round inputs, params and products to bf16 (8
# mantissa bits) and may sum in another order: 2e-2 of the largest value
BF16_TOL = 2e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, n, width):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, width)).astype(np.float32)


def _mask(n):
    return np.asarray([1.0] * (n - 2) + [0.0, 0.0], np.float32)


@pytest.mark.parametrize("features", [1, 3])
def test_linear_matches_flax(features):
    flax_model = jax_get_model("linear", features=features)
    params = _np_tree(flax_model.init(jax.random.PRNGKey(3),
                                      jnp.zeros((1, 5)))["params"])
    state = convert.linear_params_from_flax(params)
    model = get_model("linear", state_dict=state, features=features)
    model.load_state_dict(state)
    x = _batch(0, 6, 5)
    want = np.asarray(flax_model.apply({"params": params}, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, features)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the masked MSE of the Trainer contract
    y = _batch(1, 6, 1)[:, 0]
    mask = _mask(6)
    want_loss, _ = jax_linear.loss_fn(flax_model)(
        params, {"x": x, "y": y}, mask)
    got_loss, aux = linear.loss_fn(model)(
        dict(model.named_parameters()),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        torch.from_numpy(mask))
    assert aux == {}
    assert abs(got_loss.item() - float(want_loss)) <= TOL * max(
        1.0, abs(float(want_loss)))


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_two_tower_matches_flax(dtype, tol):
    flax_model = jax_get_model("two_tower", embed_dim=4, dtype=dtype)
    params = _np_tree(flax_model.init(
        jax.random.PRNGKey(0), user=jnp.zeros((1, 3)),
        item=jnp.zeros((1, 5)))["params"])
    state = convert.two_tower_params_from_flax(params)
    model = get_model("two_tower", state_dict=state, embed_dim=4, dtype=dtype)
    model.load_state_dict(state)
    user, item = _batch(2, 7, 3), _batch(3, 7, 5)
    want = flax_model.apply({"params": params}, user=user, item=item)
    with torch.no_grad():
        got = model(user=torch.from_numpy(user), item=torch.from_numpy(item))
    assert sorted(got) == sorted(want) == ["score", "user_embedding"]
    for name in got:
        w = np.asarray(want[name], np.float32)
        g = got[name].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max())
    label = _batch(4, 7, 1)[:, 0]
    mask = _mask(7)
    want_loss, _ = jax_twotower.loss_fn(flax_model)(
        params, {"user": user, "item": item, "label": label}, mask)
    got_loss, _ = twotower.loss_fn(model)(
        dict(model.named_parameters()),
        {"user": torch.from_numpy(user), "item": torch.from_numpy(item),
         "label": torch.from_numpy(label)}, torch.from_numpy(mask))
    assert abs(got_loss.item() - float(want_loss)) <= tol * max(
        1.0, abs(float(want_loss)))


def test_converters_round_trip():
    flax_model = jax_get_model("linear")
    tree = _np_tree(flax_model.init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 2)))["params"])
    back = convert.linear_params_to_flax(convert.linear_params_from_flax(tree))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    model = get_model("two_tower", user_features=3, item_features=6,
                      embed_dim=4)
    state = model.state_dict()
    again = convert.two_tower_params_from_flax(
        convert.two_tower_params_to_flax(state))
    assert sorted(again) == sorted(state)
    for name in state:
        assert torch.equal(again[name], state[name])
    # Dense kernel [in, out] <-> weight [out, in]
    flax_tree = convert.two_tower_params_to_flax(state)
    assert flax_tree["item_tower"]["kernel"].shape == (6, 4)
    assert state["item_tower.weight"].shape == (4, 6)


def test_widths_come_from_the_state_dict():
    state = {"dense.weight": torch.zeros(2, 7), "dense.bias": torch.zeros(2)}
    with torch.device("meta"):
        model = get_model("linear", state_dict=state, features=2)
    model.load_state_dict(state, assign=True)
    assert model.dense.in_features == 7 and model.dense.out_features == 2
    with pytest.raises(ValueError, match="in_features"):
        get_model("linear", features=1)
    with pytest.raises(ValueError, match="user_features"):
        get_model("two_tower", embed_dim=4)
