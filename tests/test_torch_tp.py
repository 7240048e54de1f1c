"""Tensor parallelism of the port (``parallel/tp.py``, the heads- and
MLP-split LM, ``Trainer(param_sharding=tp_param_shardings(...))``) against
the JAX package on the CPU: ``tests/test_parallel.py``'s
``TestTensorParallel`` re-pointed.  The placements leaf by leaf against
JAX's specs on the same LM, the JAX rules and the divisibility error, the
TP LM's logits against the replicated model's, and three Adam steps in
fp32 against the JAX dp x tp step on its mesh of 8 virtual devices.

The port runs in a gloo world of 4 (``tests/torch_world.run_world``)."""

import functools

import numpy as np
import pytest
import torch

from tensorflowonspark_torch.models import transformer
from tensorflowonspark_torch.parallel import mesh as mesh_mod
from tensorflowonspark_torch.parallel import tp

from test_torch_parallel_train import (BATCH, CFG, LR, LOSS_RTOL, MASK,
                                       _assert_params, _block, _init_state,
                                       _params, _tokens, _trainer)
from torch_world import run_world

TP_MESHES = {"tp_d2t2": {"data": 2, "tensor": 2}, "tp_t4": {"tensor": 4}}


class _Mesh(object):
    """A stand-in with the axis names and sizes the rule reads."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, dim):
        return self._sizes[dim]


def _port_state():
    return {k: torch.from_numpy(v) for k, v in _init_state().items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


# the JAX package's own trees and rules (test_parallel.py)
JAX_TREE = {"dense": {"kernel": np.zeros((16, 32)), "bias": np.zeros((32,))},
            "odd": {"kernel": np.zeros((7, 5))}}
JAX_RULES_TREE = {"mlp_out": {"kernel": np.zeros((32, 16))},
                  "emb": {"table": np.zeros((10, 32))}}
JAX_RULES = [("mlp_out/kernel", 0), ("emb/.*", None)]


def _jax_specs(tree, sizes, rules=None):
    from tensorflowonspark_tpu.parallel import build_mesh
    from tensorflowonspark_tpu.parallel import tp as jax_tp

    import jax

    mesh = build_mesh(sizes)
    sh = jax_tp.tp_param_shardings(tree, mesh, rules=rules)
    return {path: tuple(s.spec) for path, s in _flat(
        jax.tree_util.tree_map(lambda x: x, sh,
                               is_leaf=lambda x: hasattr(x, "spec"))).items()}


def _port_dict(tree):
    return {k.replace("/", "."): torch.from_numpy(v)
            for k, v in _flat(tree).items()}


def _views():
    """The LM's flax views (``TransformerLM.flax_views``)."""
    return transformer.build_transformer(**CFG).flax_views()


def _jax_spec(placement, name, params, views=None):
    """A placement of ``tp_param_shardings`` read as the JAX
    ``PartitionSpec`` (a tuple over the flax leaf's dims)."""
    shape, place = tp.flax_view(name, params, views)
    spec = [None] * len(shape)
    if placement.sharded:
        for d in range(len(shape)):
            if place(d) == (placement.dim, placement.shape):
                spec[d] = placement.axis
    return tuple(spec)


def _normalize(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return spec


@pytest.mark.parametrize("tree,rules", [(JAX_TREE, None),
                                        (JAX_RULES_TREE, JAX_RULES)])
def test_rule_matches_jax_on_its_trees(tree, rules):
    """``test_heuristic_shards_trailing_divisible_dim`` and
    ``test_rules_override_and_divisibility_error``: on JAX's own trees and
    rules the port places every leaf as JAX does."""
    want = _jax_specs(tree, {"data": 4, "tensor": 2}, rules)
    params = _port_dict(tree)
    got = tp.tp_param_shardings(params, _Mesh(data=4, tensor=2),
                                rules=rules)
    for path, spec in want.items():
        name = path.replace("/", ".")
        have = _jax_spec(got[name], name, params)
        assert have == _normalize(spec, len(have)), (path, have, spec)


def test_divisibility_error_matches_jax():
    """A ruled dim that does not divide by the axis raises, as in JAX."""
    with pytest.raises(ValueError, match="not divisible"):
        tp.tp_param_shardings({"w": torch.zeros(7, 6)},
                              _Mesh(data=4, tensor=2), rules=[("w", 0)])


def _flax_paths(state):
    """Port name -> flax path, through the converter's own mapping."""
    from tensorflowonspark_torch import convert

    names = {}
    for name in state:
        marked = dict(state)
        marked[name] = torch.full_like(state[name], 7.0)
        flat = _flat(convert.transformer_params_to_flax(marked,
                                                        CFG["num_heads"]))
        names[name] = next(p for p, v in flat.items()
                           if np.all(np.asarray(v) == 7.0))
    return names


@pytest.mark.parametrize("size", [2, 4])
def test_lm_placements_match_jax_leaf_by_leaf(size):
    """The heuristic on the LM, read through the model's flax views: the
    port's placement of every leaf, read as a JAX spec over the flax leaf,
    is what JAX ``tp_param_shardings`` gives the same tree (the qkv kernel
    on its input dim, the token table on the vocabulary, the MLP's first
    kernel on its output dim)."""
    from tensorflowonspark_torch import convert

    state = _port_state()
    tree = convert.transformer_params_to_flax(state, CFG["num_heads"])
    want = _jax_specs(tree, {"data": 8 // size, "tensor": size})
    got = tp.tp_param_shardings(state, _Mesh(data=8 // size, tensor=size),
                                views=_views())
    names = _flax_paths(state)
    for name, path in names.items():
        have = _jax_spec(got[name], name, state, _views())
        assert have == _normalize(want[path], len(have)), (name, have,
                                                           want[path])
    assert got["blocks.0.attn.qkv.weight"].spec() == (None,) * 3 + (
        "tensor",)


def test_flax_views_match_the_converter():
    """The model's flax views are the converter's layout: every param seen
    through its view (``param.view(shape).permute(perm)``), or as it is
    when it has none, is its flax leaf, value for value; the views name
    only the LM's params."""
    from tensorflowonspark_torch import convert

    state = _port_state()
    views = _views()
    assert set(views) <= set(state)
    flat = _flat(convert.transformer_params_to_flax(state, CFG["num_heads"]))
    for name, path in _flax_paths(state).items():
        shape, perm = views.get(name, (None, None))
        seen = state[name]
        if perm is not None:
            seen = seen.view(shape or seen.shape).permute(perm)
        np.testing.assert_array_equal(seen.numpy(), np.asarray(flat[path]),
                                      err_msg=name)


def _world4(rank, state):
    torch.set_num_threads(1)
    out = {}
    for key, spec in TP_MESHES.items():
        mesh = mesh_mod.build_mesh(spec, keep_trivial_axes=True,
                                   device="cpu")
        params = {k: torch.from_numpy(v) for k, v in state.items()}
        tree = tp.tp_param_shardings(params, mesh, views=_views())
        tr = _trainer(state, mesh, param_sharding=tree)
        losses = [tr.step({"tokens": _block(_tokens(10 + i), mesh)},
                          _block(MASK, mesh))[0].item() for i in range(3)]
        opt = tr.state.optimizer
        out[key] = {
            "losses": losses, "params": _params(tr),
            "grad_norm": float(tr._health_grad_norm),
            "opt_shapes": {name: tuple(opt.state[p]["exp_avg"].shape)
                           for name, p in zip(
                               tr.state.params,
                               opt.param_groups[0]["params"])},
            "shard": tr.state.sharding.shards[
                "blocks.0.mlp_in.weight"].detach().numpy().copy()}
        model = transformer.build_transformer(**CFG, mesh=mesh)
        model.load_state_dict(params)
        with torch.no_grad():
            out[key]["logits"] = model(torch.from_numpy(
                _block(_tokens(50), mesh))).numpy()
    return out


@pytest.fixture(scope="module")
def state():
    return _init_state()


@pytest.fixture(scope="module")
def world4(state):
    return run_world(_world4, 4, state)


@pytest.mark.parametrize("key", sorted(TP_MESHES))
def test_tp_lm_logits_match_replicated(world4, state, key):
    """``test_tp_transformer_matches_replicated``: the LM with its heads
    and MLP split over the tensor axis gives the replicated model's logits
    (each rank its rows)."""
    model = transformer.build_transformer(**CFG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        base = model(torch.from_numpy(_tokens(50))).numpy()
    rows = BATCH // (2 if key == "tp_d2t2" else 1)
    for rank, got in enumerate(world4):
        index = (rank // 2) if key == "tp_d2t2" else 0
        np.testing.assert_allclose(got[key]["logits"],
                                   base[index * rows:(index + 1) * rows],
                                   rtol=2e-5, atol=2e-5)


@functools.lru_cache(maxsize=None)
def _jax_tp_steps():
    """Three steps of the JAX dp x tp step (data 4 x tensor 2, params and
    Adam state under ``tp_param_shardings``, batch over data): the losses
    and the params under the port's names."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    from tensorflowonspark_tpu.models import transformer as jax_transformer
    from tensorflowonspark_tpu.parallel import build_mesh
    from tensorflowonspark_tpu.parallel import tp as jax_tp
    from tensorflowonspark_torch import convert

    mesh = build_mesh({"data": 4, "tensor": 2})
    model = jax_transformer.build_transformer(**CFG)
    params = convert.transformer_params_to_flax(_port_state(),
                                                CFG["num_heads"])
    params = jax.device_put(params, jax_tp.tp_param_shardings(params, mesh))
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)
    loss = jax_transformer.loss_fn(model)

    @jax.jit
    def step(params, opt_state, tokens, mask):
        (lv, _), grads = jax.value_and_grad(loss, has_aux=True)(
            params, {"tokens": tokens}, mask)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, lv

    losses = []
    with mesh:
        for i in range(3):
            tokens = jax.device_put(_tokens(10 + i), NamedSharding(
                mesh, PartitionSpec("data", None)))
            mask = jax.device_put(MASK, NamedSharding(mesh,
                                                      PartitionSpec("data")))
            params, opt_state, lv = step(params, opt_state, tokens, mask)
            losses.append(float(lv))
    got = convert.transformer_params_from_flax(jax.device_get(params))
    return losses, {k: np.asarray(v) for k, v in got.items()}


@pytest.mark.parametrize("key", sorted(TP_MESHES))
def test_tp_three_adam_steps_match_jax(world4, key):
    """``Trainer(param_sharding=tp_param_shardings(...))`` over four ranks
    (data 2 x tensor 2, and tensor 4) steps as the JAX dp x tp step in
    fp32: the losses within 1e-5, every rank's gathered params within
    1e-5 (the qkv key bias within 3 x lr x 2, as in
    ``tests/test_torch_parallel_train.py``)."""
    want_losses, want_params = _jax_tp_steps()
    for rank in world4:
        np.testing.assert_allclose(rank[key]["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        _assert_params(rank[key]["params"], want_params)


@functools.lru_cache(maxsize=None)
def _one_process_grad_norm():
    """The grad norm after the same three steps on one process."""
    tr = _trainer(_init_state())
    for i in range(3):
        tr.step({"tokens": _tokens(10 + i)}, MASK)
    return float(tr._health_grad_norm)


@pytest.mark.parametrize("key", sorted(TP_MESHES))
def test_tp_ranks_hold_their_shards(world4, key):
    """Each rank holds only its block of a sharded leaf and of its Adam
    moments (the first MLP kernel on its output dim, the token table on
    the vocabulary, the qkv kernel on its input dim); small leaves
    replicate; the grad norm is the global one on every rank, the
    one-process run's (an error of scale in a leaf's gradient, which
    Adam's update would hide, shows here)."""
    n = 2 if key == "tp_d2t2" else 4
    d, v = CFG["num_heads"] * CFG["head_dim"], CFG["vocab_size"]
    shapes = world4[0][key]["opt_shapes"]
    assert shapes["embed.weight"] == (v // n, d)
    assert shapes["blocks.0.mlp_in.weight"] == (4 * d // n, d)
    assert shapes["blocks.0.mlp_out.weight"] == (d, 4 * d // n)
    assert shapes["blocks.0.attn.qkv.weight"] == (3, CFG["num_heads"],
                                                   CFG["head_dim"], d // n)
    assert shapes["blocks.0.ln1.weight"] == (d,)
    for rank, got in enumerate(world4):
        t = rank % n
        full = got[key]["params"]["blocks.0.mlp_in.weight"]
        rows = full.shape[0] // n
        np.testing.assert_array_equal(got[key]["shard"],
                                      full[t * rows:(t + 1) * rows])
    norms = [r[key]["grad_norm"] for r in world4]
    np.testing.assert_allclose(norms, norms[0], rtol=1e-6)
    np.testing.assert_allclose(norms[0], _one_process_grad_norm(), rtol=1e-5)
