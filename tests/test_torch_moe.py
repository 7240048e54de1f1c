"""The port's Switch MoE layer and MoE transformer LM (``mlp="moe"``)
against the JAX package's flax model: the layer alone (output, each token's
expert, the load-balance term, tokens dropped at capacity), the whole LM's
logits, loss and gradients, bf16 routing, the init scale, the converter
and the expert-parallel options the layer refuses.  The sizes are
``tests/test_models.py::TestMoE``'s; inputs come from numpy seeds and
reach both sides as numpy; the JAX flash path runs in interpret mode, as
its own tests run it on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.models import transformer as jax_transformer
from tensorflowonspark_torch import convert
from tensorflowonspark_torch.models import get_model, transformer

CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
           max_seq_len=16, mlp="moe", num_experts=4)
SEQ, BATCH = 16, 4
D_MODEL = CFG["num_heads"] * CFG["head_dim"]
# fp32 on both sides, matmuls summed in another order: the layer's output
# and the aux term to 1e-5 absolute (values of order 1), the logits to 1e-5
# of the largest, the loss to 1e-5 relative, gradients to 1e-4 of each
# tensor's largest entry (2 layers of backward sums)
ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# bf16: the two frameworks round the LayerNorm output the router reads at
# their own places, so a token within rounding of a tie may pick another
# expert in each; the share of tokens routed alike must stay above 99%,
# and rows where every token of every layer routed alike are held to the
# dense LM's bf16 logit tolerance (tests/test_torch_transformer.py)
BF16_AGREE = 0.99
BF16_LOGIT_TOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _perturbed(tree, seed=0):
    """A flax tree as numpy, every leaf perturbed so that zero biases and
    unit LayerNorm scales are exercised too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x))
                   ).astype(np.float32), tree)


@pytest.fixture(scope="module")
def flax_params():
    model = jax_transformer.build_transformer(**CFG, attention="full")
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, SEQ), jnp.int32))["params"]
    return _perturbed(params)


def _tokens(seed, batch=BATCH):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (batch, SEQ), dtype=np.int32)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree)}


# -- the layer alone -----------------------------------------------------------

def _layer_pair(capacity_factor=1.25, router_bias=None, seed=3):
    """A flax MoEMlp's perturbed params and the port's layer loaded with
    them; ``router_bias`` overrides the router's bias."""
    flax_layer = jax_transformer.MoEMlp(num_experts=CFG["num_experts"],
                                        capacity_factor=capacity_factor)
    x0 = jnp.zeros((BATCH, SEQ, D_MODEL), jnp.float32)
    params = _perturbed(flax_layer.init(jax.random.PRNGKey(seed),
                                        x0)["params"], seed)
    if router_bias is not None:
        params["router"]["bias"] = np.asarray(router_bias, np.float32)
    layer = transformer.MoEMlp(D_MODEL, CFG["num_experts"],
                               capacity_factor=capacity_factor)
    layer.load_state_dict({
        "router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
        "router.bias": torch.from_numpy(params["router"]["bias"]),
        **{k: torch.from_numpy(params[k]) for k in ("w1", "b1", "w2", "b2")}})
    return flax_layer, params, layer


def _flax_layer(flax_layer, params, x):
    """Output, aux term and each token's expert of the flax layer."""
    y, state = flax_layer.apply({"params": params}, jnp.asarray(x),
                                mutable=["intermediates"])
    logits = (jnp.asarray(x) @ params["router"]["kernel"]
              + params["router"]["bias"])
    idx = jnp.argmax(jax.nn.softmax(logits, axis=-1), axis=-1)
    return (np.asarray(y), float(state["intermediates"]["moe_aux_loss"][0]),
            np.asarray(idx))


def test_layer_matches_flax():
    flax_layer, params, layer = _layer_pair()
    x = np.random.default_rng(4).standard_normal(
        (BATCH, SEQ, D_MODEL)).astype(np.float32)
    want_y, want_aux, want_idx = _flax_layer(flax_layer, params, x)
    with torch.no_grad():
        y, aux = layer(torch.from_numpy(x))
        _, idx, _, pos = layer.route(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    # at capacity_factor 1.25 some experts overflow their 5 slots here
    assert int((pos >= layer.capacity(SEQ)).sum()) > 0
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=ATOL)
    np.testing.assert_allclose(aux.item(), want_aux, rtol=0, atol=ATOL)


def test_tokens_past_capacity_are_dropped_like_flax():
    """capacity_factor 0.25 gives each expert one slot of 16 tokens, and a
    router bias sends every token to expert 2: in each row only the first
    token is processed, the others contribute exactly zero (no index out of
    range for the positions past capacity)."""
    flax_layer, params, layer = _layer_pair(
        capacity_factor=0.25, router_bias=[0.0, 0.0, 50.0, 0.0])
    x = np.random.default_rng(5).standard_normal(
        (BATCH, SEQ, D_MODEL)).astype(np.float32)
    want_y, want_aux, want_idx = _flax_layer(flax_layer, params, x)
    with torch.no_grad():
        y, aux = layer(torch.from_numpy(x))
        _, idx, _, pos = layer.route(torch.from_numpy(x))
    assert layer.capacity(SEQ) == 1
    assert (want_idx == 2).all() and (idx.numpy() == 2).all()
    np.testing.assert_array_equal(pos.numpy(), np.tile(np.arange(SEQ),
                                                       (BATCH, 1)))
    assert (y[:, 1:] == 0).all() and (y[:, 0] != 0).any()
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=ATOL)
    np.testing.assert_allclose(aux.item(), want_aux, rtol=0, atol=ATOL)


def test_init_scale_matches_flax():
    """flax's lecun_normal counts the expert dim into a 3-D kernel's
    fan-in: w1 ~ 1/sqrt(E*D), w2 ~ 1/sqrt(E*H), the router ~ 1/sqrt(D).
    At D = 64, H = 256, E = 8 both inits' stds agree within 3% (w1 and w2
    hold 131072 draws each, the router 512)."""
    d, e = 64, 8
    flax_params = jax_transformer.MoEMlp(num_experts=e).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, d)))["params"]
    model = transformer.build_transformer(
        vocab_size=16, num_layers=1, num_heads=4, head_dim=16,
        max_seq_len=4, mlp="moe", num_experts=e)
    model.init_weights(torch.Generator().manual_seed(0))
    layer = model.blocks[0].moe
    want = {"w1": 1 / np.sqrt(e * d), "w2": 1 / np.sqrt(e * 4 * d),
            "router": 1 / np.sqrt(d)}
    got = {"w1": layer.w1, "w2": layer.w2, "router": layer.router.weight}
    flax_std = {"w1": np.std(flax_params["w1"]),
                "w2": np.std(flax_params["w2"]),
                "router": np.std(flax_params["router"]["kernel"])}
    for name, std in want.items():
        assert abs(float(got[name].detach().std()) / std - 1) < 0.03, name
        tol = 0.1 if name == "router" else 0.03
        assert abs(flax_std[name] / std - 1) < tol, name
    assert not layer.b1.any() and not layer.b2.any()


class _Mesh(object):
    """A stand-in for a mesh: its axis names and sizes, all the model reads
    before it refuses one."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, dim):
        return self._sizes[dim]


# expert parallelism is ported (tests/test_torch_ep.py): the explicit
# schedule needs a mesh with an expert axis, and the experts must split
# evenly over it, as the JAX layer asserts
@pytest.mark.parametrize("kwargs,match", [
    ({"ep_mode": "shard_map"}, "expert"),
    ({"mesh": _Mesh(data=1, expert=3)}, "not divisible")])
def test_expert_parallel_options_raise(kwargs, match):
    with pytest.raises(ValueError, match=match):
        transformer.build_transformer(**dict(CFG, **kwargs))


# -- the LM --------------------------------------------------------------------

def test_converter_round_trip_and_names(flax_params):
    sd = convert.transformer_params_from_flax(flax_params)
    model = transformer.build_transformer(**CFG)
    assert sorted(sd) == sorted(model.state_dict())
    assert "blocks.0.moe.router.weight" in sd and not any(
        "mlp_in" in k for k in sd)
    model.load_state_dict(sd)      # strict: every name and shape
    back = convert.transformer_params_to_flax(sd, num_heads=CFG["num_heads"])
    want, got = _flat(dict(flax_params)), _flat(back)
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].shape == arr.shape, path
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))
    # and the port's own init, through flax's layout and back
    model.init_weights(torch.Generator().manual_seed(1))
    again = convert.transformer_params_from_flax(
        convert.transformer_params_to_flax(model.state_dict(),
                                           CFG["num_heads"]))
    for name, t in model.state_dict().items():
        assert torch.equal(again[name], t), name


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_logits_and_loss_match_flax(flax_params, attention):
    jax_model = jax_transformer.build_transformer(**CFG, attention=attention)
    tokens = _tokens(1)
    mask = np.array([1, 0, 1, 1], np.float32)
    want_logits = np.asarray(jax.jit(jax_model.apply)(
        {"params": flax_params}, jnp.asarray(tokens)))
    want, want_aux = jax.jit(jax_transformer.loss_fn(jax_model))(
        flax_params, {"tokens": jnp.asarray(tokens)}, jnp.asarray(mask))
    model = transformer.build_transformer(**CFG, attention=attention)
    params = convert.transformer_params_from_flax(flax_params)
    model.load_state_dict(params)
    with torch.no_grad():
        logits, balance = model(torch.from_numpy(tokens), return_aux=True)
        plain = model(torch.from_numpy(tokens))
        got, aux = transformer.loss_fn(model)(
            params, {"tokens": torch.from_numpy(tokens)},
            torch.from_numpy(mask))
    assert torch.equal(plain, logits)
    assert np.abs(logits.numpy() - want_logits).max() <= (
        ATOL * np.abs(want_logits).max())
    assert sorted(aux) == ["moe_aux_loss"]
    assert aux["moe_aux_loss"] is not None and torch.equal(
        aux["moe_aux_loss"], balance)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["moe_aux_loss"].item(),
                               float(want_aux["moe_aux_loss"]),
                               rtol=LOSS_RTOL)


def test_gradients_match_jax(flax_params):
    """One backward through the flash LM, the router's gradient (through
    the combine weights and the load-balance term) included."""
    jax_model = jax_transformer.build_transformer(**CFG, attention="flash")
    tokens = _tokens(2)
    mask = np.array([1, 1, 0, 1], np.float32)
    want = _flat(jax.device_get(jax.jit(jax.grad(
        lambda p: jax_transformer.loss_fn(jax_model)(
            p, {"tokens": jnp.asarray(tokens)}, jnp.asarray(mask))[0]))(
        flax_params)))
    model = transformer.build_transformer(**CFG, attention="flash")
    params = {k: v.requires_grad_() for k, v in
              convert.transformer_params_from_flax(flax_params).items()}
    loss, _ = transformer.loss_fn(model)(
        params, {"tokens": torch.from_numpy(tokens)}, torch.from_numpy(mask))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    got = _flat(convert.transformer_params_to_flax(grads, CFG["num_heads"]))
    assert sorted(got) == sorted(want)
    assert np.abs(got[("block_0", "moe", "router", "kernel")]).max() > 0
    for path, arr in want.items():
        scale = max(float(np.abs(arr).max()), 1e-6)
        np.testing.assert_allclose(got[path], arr, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=str(path))


def test_bf16_routing_agrees_and_matching_rows_match(flax_params):
    """bf16 compute over fp32 params: the share of (layer, token) routing
    decisions that agree between the frameworks, then the logits of the
    rows whose every decision agreed."""
    tokens = _tokens(6, batch=8)
    jax_model = jax_transformer.build_transformer(**CFG, attention="full",
                                                  dtype="bfloat16")
    want, state = jax_model.apply({"params": flax_params},
                                  jnp.asarray(tokens),
                                  capture_intermediates=True)
    inter = state["intermediates"]
    want_idx = np.stack([
        np.asarray(jnp.argmax(inter["block_%d" % i]["moe"]["router"][
            "__call__"][0], axis=-1)) for i in range(CFG["num_layers"])])
    model = transformer.build_transformer(**CFG, attention="full",
                                          dtype="bfloat16")
    model.load_state_dict(convert.transformer_params_from_flax(flax_params))
    routed = []
    hooks = [block.moe.router.register_forward_hook(
        lambda mod, inp, out: routed.append(out.argmax(-1)))
        for block in model.blocks]
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    for h in hooks:
        h.remove()
    got_idx = torch.stack(routed).numpy()
    agree = got_idx == want_idx                 # [layers, B, S]
    assert agree.mean() >= BF16_AGREE, agree.mean()
    rows = agree.all(axis=(0, 2))
    assert rows.sum() >= BATCH
    want = np.asarray(want)[rows]
    assert np.abs(got[rows] - want).max() <= BF16_LOGIT_TOL * np.abs(
        want).max()


def test_registry_and_dense_blocks_unchanged():
    """get_model builds the MoE LM from an export's config; a dense block
    keeps its MLP and returns no aux term."""
    model = get_model("transformer_lm", **dict(CFG, capacity_factor=2.0))
    assert model.blocks[0].moe.capacity(SEQ) == 8
    dense = transformer.build_transformer(**dict(CFG, mlp="dense"))
    assert dense.blocks[0].moe is None
    dense.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, balance = dense(torch.from_numpy(_tokens(0)), return_aux=True)
    assert balance is None
    with pytest.raises(ValueError, match="mlp"):
        transformer.build_transformer(**dict(CFG, mlp="sparse"))
