"""Expert parallelism of the port (``parallel/ep.py``, ``MoEMlp`` on an
``expert`` axis, MoE under ``seq``) against the JAX package on the CPU:
``tests/test_parallel.py``'s ``TestExpertParallel`` and
``tests/test_models.py``'s ``test_expert_parallel_sharding_matches_replicated``
and ``test_ep_mode_shard_map_matches_gspmd`` re-pointed.

``moe_ffn`` against the dense layer (the JAX package's and the port's),
forward and gradients, with and without ``batch_axes``; the placements of
``ep_param_shardings`` and ``merge_ep_shardings`` against JAX's; the fp32
routing against JAX's; the MoE layer under seq 2 against the one-process
layer; three Adam steps of the MoE LM under ``merge_ep_shardings`` in both
ep modes against the JAX dp x ep step, each rank holding its experts.

The port runs in a gloo world of 4 (``tests/torch_world.run_world``).  A
rank's loss is its share of the one program's (the sum over ranks, see
``parallel/comm.py``): ranks that hold the same rows each take 1/n of it,
and a gradient is the sum over the ranks."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tensorflowonspark_torch.models import transformer
from tensorflowonspark_torch.parallel import ep, fsdp
from tensorflowonspark_torch.parallel import mesh as mesh_mod

from test_torch_parallel_train import (BATCH, LR, LOSS_RTOL, MASK,
                                       _assert_params, _tokens)
from torch_world import run_world

# tests/test_parallel.py's layer: 4 experts, mlp_ratio 2, capacity 1.0
E, D, S = 4, 8, 16
LAYER = dict(num_experts=E, mlp_ratio=2, capacity_factor=1.0)
MOE_CFG = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16,
               max_seq_len=32, mlp="moe", num_experts=4)
NAMES = ("router.weight", "router.bias", "w1", "b1", "w2", "b2")


def _layer_params(seed=0):
    """The port layer's params (perturbed, so zero biases count) as numpy."""
    layer = transformer.MoEMlp(D, **LAYER)
    with torch.no_grad():
        layer.router.reset_parameters(torch.Generator().manual_seed(seed))
        layer.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return {k: (v.detach().numpy() + 0.05 * rng.standard_normal(v.shape))
            .astype(np.float32) for k, v in layer.state_dict().items()}


def _flax_params(params):
    return {"router": {"kernel": params["router.weight"].T.copy(),
                       "bias": params["router.bias"]},
            **{k: params[k] for k in ("w1", "b1", "w2", "b2")}}


def _x(seed, groups):
    return np.random.default_rng(seed).standard_normal(
        (groups, S, D)).astype(np.float32)


def _dense(params, x):
    """The JAX dense layer: output, aux, and the gradients of
    ``sum(y**2) + aux`` under the port's names."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models.transformer import MoEMlp

    model = MoEMlp(**LAYER)
    flax = _flax_params(params)

    def run(p):
        y, state = model.apply({"params": p}, jnp.asarray(x),
                               mutable=["intermediates"])
        aux = state["intermediates"]["moe_aux_loss"][0]
        return (y ** 2).sum() + aux, (y, aux)

    (_, (y, aux)), g = jax.value_and_grad(run, has_aux=True)(flax)
    grads = {"router.weight": np.asarray(g["router"]["kernel"]).T,
             "router.bias": np.asarray(g["router"]["bias"]),
             **{k: np.asarray(g[k]) for k in ("w1", "b1", "w2", "b2")}}
    return np.asarray(y), float(aux), grads


def _sum_grads(grads):
    for g in grads:
        dist.all_reduce(g)
    return [g.numpy().copy() for g in grads]


def _ffn_case(rank, params, mesh, x, rows, batch_axes, weight):
    """``moe_ffn`` on this rank's ``rows`` of ``x``: the output, the aux
    and the gradients of this rank's ``weight`` share of ``sum(y**2)``
    plus 1/world of the aux, summed over the world."""
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    xs = torch.from_numpy(x[rows]).requires_grad_(True)
    y, aux = ep.moe_ffn(xs, p, mesh, E, capacity_factor=1.0,
                        batch_axes=batch_axes)
    ((y ** 2).sum() * weight + aux / dist.get_world_size()).backward()
    grads = _sum_grads([p[k].grad for k in NAMES])
    return {"y": y.detach().numpy(), "aux": aux.item(),
            "grads": dict(zip(NAMES, grads))}


def _seq_case(rank, params, mesh, x):
    """The port layer (gspmd) on this rank's ``seq`` chunk of its data
    block: output chunk, aux and the gradients of sum(y**2) + aux/4."""
    layer = transformer.MoEMlp(D, mesh=mesh, **LAYER)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    rows = mesh_mod.row_shard(mesh)
    block = x.shape[0] // rows[1]
    chunk = S // 2
    r = mesh.get_local_rank("seq")
    xs = x[rows[0] * block:(rows[0] + 1) * block, r * chunk:(r + 1) * chunk]
    y, aux = layer(torch.from_numpy(np.ascontiguousarray(xs)))
    ((y ** 2).sum() + aux / dist.get_world_size()).backward()
    grads = _sum_grads([dict(layer.named_parameters())[k].grad
                        for k in NAMES])
    return {"y": y.detach().numpy(), "aux": aux.item(),
            "grads": dict(zip(NAMES, grads))}


def _lm_case(state, mesh):
    """The MoE LM on data 2 x expert 2, each rank its rows: the logits with
    the expert leaves sharded over expert (``shard_params`` with the EP
    rule: each rank holds its 2 of 4 experts), and the loss and aux of
    ``ep_mode="gspmd"`` and ``"shard_map"`` from the same params."""
    from tensorflowonspark_torch.parallel import tp

    params = {k: torch.from_numpy(v) for k, v in state.items()}
    tokens = torch.from_numpy(_rows(_tokens(60), mesh, None))
    mask = torch.from_numpy(_rows(MASK, mesh, None))
    out = {}
    gspmd = transformer.build_transformer(**MOE_CFG, mesh=mesh)
    local = tp.shard_params(params, mesh, axis="expert",
                            rules=[(ep.MOE_PARAM_RE.pattern, 0), ("", None)])
    with torch.no_grad():
        out["logits"] = torch.func.functional_call(
            gspmd, local, (tokens,)).numpy()
        out["local_w1"] = tuple(local["blocks.0.moe.w1"].shape)
        for mode in ("gspmd", "shard_map"):
            model = transformer.build_transformer(**MOE_CFG, mesh=mesh,
                                                  ep_mode=mode)
            loss, aux = transformer.loss_fn(model)(params, {"tokens": tokens},
                                                   mask)
            out[mode] = (loss.item(), aux["moe_aux_loss"].item())
    return out


def _rows(x, mesh, batch_axes):
    """This rank's block of the global rows over ``batch_axes``."""
    index, count = mesh_mod.row_shard(mesh, batch_axes)
    n = x.shape[0] // count
    return x[index * n:(index + 1) * n]


def _lm_state():
    model = transformer.build_transformer(**MOE_CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _lm_trainer(state, mesh, ep_mode, batch_axes, fsdp_base):
    from tensorflowonspark_torch import train

    model = transformer.build_transformer(**MOE_CFG, ep_mode=ep_mode,
                                          mesh=mesh,
                                          ep_batch_axes=batch_axes)
    params = {k: torch.from_numpy(v) for k, v in state.items()}
    base = (fsdp.tree_shardings(params, mesh, min_size=2 ** 8) if fsdp_base
            else {})
    tree = ep.merge_ep_shardings(base, params, mesh)
    return train.Trainer(
        transformer.loss_fn(model), params,
        functools.partial(torch.optim.Adam, lr=LR), batch_size=BATCH,
        device="cpu", mesh=mesh, param_sharding=tree, batch_axes=batch_axes)


# the Trainer cases: (mesh, ep_mode, the axes carrying distinct rows, an
# FSDP base under the expert overlay)
TRAIN_CASES = {
    "shard_map_d2e2": ({"data": 2, "expert": 2}, "shard_map",
                       ("data", "expert"), False),
    "gspmd_d2e2": ({"data": 2, "expert": 2}, "gspmd", None, False),
    "shard_map_e4": ({"expert": 4}, "shard_map", ("expert",), False),
    "gspmd_f2e2": ({"fsdp": 2, "expert": 2}, "gspmd", None, True),
}


def _world4(rank, params, x4, x8, state):
    torch.set_num_threads(1)
    out = {}
    mesh = mesh_mod.build_mesh({"data": 2, "expert": 2}, device="cpu")
    # without batch_axes: every rank holds all 4 groups, as JAX's input
    # replicated over data; the expert group splits them
    out["plain"] = _ffn_case(rank, params, mesh, x4, slice(None), None,
                             1.0 / 4)
    # the groups over data and expert: each rank its 2 of 8
    out["data_expert"] = _ffn_case(rank, params, mesh, x8,
                                   slice(2 * rank, 2 * rank + 2),
                                   ("data", "expert"), 1.0)
    # over data only (expert appended): each data rank its 4 of 8
    d = mesh.get_local_rank("data")
    out["data"] = _ffn_case(rank, params, mesh, x8,
                            slice(4 * d, 4 * d + 4), ("data",), 0.5)
    seq_mesh = mesh_mod.build_mesh({"data": 2, "seq": 2}, device="cpu")
    out["seq"] = _seq_case(rank, params, seq_mesh, x8)
    out["lm"] = _lm_case(state, mesh)
    for key, (spec, mode, axes, base) in TRAIN_CASES.items():
        mesh = mesh_mod.build_mesh(spec, keep_trivial_axes=True,
                                   device="cpu")
        tr = _lm_trainer(state, mesh, mode, axes, base)
        losses = [tr.step({"tokens": _rows(_tokens(10 + i), mesh, axes)},
                          _rows(MASK, mesh, axes))[0].item()
                  for i in range(3)]
        opt = tr.state.optimizer
        out[key] = {
            "losses": losses,
            "params": {k: v.detach().numpy().copy() for k, v in
                       tr.state.state_dict()["params"].items()},
            "local": tuple(tr.state.params["blocks.0.moe.w1"].shape),
            "exp_avg": tuple(opt.state[tr.state.params[
                "blocks.0.moe.w1"]]["exp_avg"].shape),
            "grad_norm": float(tr._health_grad_norm)}
    out["batch_axes"] = _batch_axes_case(state)
    return out


def _batch_axes_case(state):
    """One answer to which axes carry distinct rows: a Trainer without
    ``batch_axes`` adopts the model's, one with other axes raises, and
    ``fit_feed`` refuses a feed whose rows are laid out otherwise."""
    from tensorflowonspark_torch import train
    from tensorflowonspark_torch.parallel import infeed

    mesh = mesh_mod.build_mesh({"data": 2, "expert": 2},
                               keep_trivial_axes=True, device="cpu")
    model = transformer.build_transformer(**MOE_CFG, ep_mode="shard_map",
                                          mesh=mesh,
                                          ep_batch_axes=("data", "expert"))
    params = {k: torch.from_numpy(v) for k, v in state.items()}

    def trainer(**kwargs):
        return train.Trainer(transformer.loss_fn(model), params,
                             functools.partial(torch.optim.Adam, lr=LR),
                             device="cpu", mesh=mesh, **kwargs)

    out = {"adopted": trainer().batch_axes}
    try:
        trainer(batch_axes=("data", "fsdp"))
    except ValueError as e:
        out["trainer_refused"] = str(e)
    feed = infeed.ShardedFeed(None, BATCH, prefetch=0, device="cpu",
                              mesh=mesh)
    try:
        trainer(batch_axes=("expert", "data")).fit_feed(feed, max_steps=1)
    except ValueError as e:
        out["feed_refused"] = str(e)
    return out


@pytest.fixture(scope="module")
def layer_params():
    return _layer_params()


@pytest.fixture(scope="module")
def lm_state():
    return _lm_state()


@pytest.fixture(scope="module")
def world4(layer_params, lm_state):
    return run_world(_world4, 4, layer_params, _x(1, 4), _x(2, 8), lm_state)


def _assert_grads(got, want, rtol=5e-5, atol=5e-5):
    for k in NAMES:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_moe_ffn_matches_dense(world4, layer_params):
    """``test_moe_ffn_matches_dense`` and ``test_moe_ffn_grads_match_dense``:
    every rank holds the same 4 groups (no batch_axes, pure EP): the
    output and aux of the dense layer, and the gradients of
    ``sum(y**2) + aux``."""
    y, aux, grads = _dense(layer_params, _x(1, 4))
    for rank in world4:
        np.testing.assert_allclose(rank["plain"]["y"], y, rtol=2e-5,
                                   atol=2e-5)
        assert rank["plain"]["aux"] == pytest.approx(aux, rel=1e-5)
        _assert_grads(rank["plain"]["grads"], grads)


@pytest.mark.parametrize("key,rows", [("data_expert", 2), ("data", 4)])
def test_moe_ffn_batch_axes_matches_dense(world4, layer_params, key, rows):
    """``test_moe_ffn_batch_axes_matches_dense``: the 8 groups sharded over
    data AND expert, and over data alone (the expert axis appended): each
    rank's rows of the dense output, the global aux, and the gradients."""
    y, aux, grads = _dense(layer_params, _x(2, 8))
    for r, rank in enumerate(world4):
        start = (r if rows == 2 else r // 2) * rows
        np.testing.assert_allclose(rank[key]["y"], y[start:start + rows],
                                   rtol=2e-5, atol=2e-5)
        assert rank[key]["aux"] == pytest.approx(aux, rel=1e-5)
        _assert_grads(rank[key]["grads"], grads)


def test_moe_under_seq_matches_one_process_layer(world4, layer_params):
    """The layer under data 2 x seq 2: each rank's chunk of its rows is the
    one-process layer's on the whole sequences (the capacity from the
    global sequence), the aux the batch's (averaged over data), and the
    gradients the one-process layer's."""
    layer = transformer.MoEMlp(D, **LAYER)
    layer.load_state_dict({k: torch.from_numpy(v)
                           for k, v in layer_params.items()})
    x = torch.from_numpy(_x(2, 8))
    y, aux = layer(x)
    ((y ** 2).sum() + aux).backward()
    grads = {k: dict(layer.named_parameters())[k].grad.numpy()
             for k in NAMES}
    y = y.detach().numpy()
    for r, rank in enumerate(world4):
        d, s = r // 2, r % 2
        np.testing.assert_allclose(rank["seq"]["y"],
                                   y[4 * d:4 * d + 4, 8 * s:8 * s + 8],
                                   rtol=2e-5, atol=2e-5)
        assert rank["seq"]["aux"] == pytest.approx(aux.item(), rel=1e-5)
        _assert_grads(rank["seq"]["grads"], grads)


def test_expert_parallel_sharding_matches_replicated(world4, lm_state):
    """``test_expert_parallel_sharding_matches_replicated``: the MoE LM on
    data 2 x expert 2 with its expert leaves sharded over expert (each
    rank its 2 experts) gives the replicated model's logits, each rank its
    rows."""
    model = transformer.build_transformer(**MOE_CFG)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in lm_state.items()})
    with torch.no_grad():
        base = model(torch.from_numpy(_tokens(60))).numpy()
    for r, rank in enumerate(world4):
        d = r // 2
        assert rank["lm"]["local_w1"][0] == 2
        np.testing.assert_allclose(rank["lm"]["logits"],
                                   base[4 * d:4 * d + 4], rtol=2e-5,
                                   atol=2e-5)


def test_trainer_and_feed_share_the_models_batch_axes(world4):
    """The model's ``ep_batch_axes`` is the one answer to which axes carry
    distinct rows: a Trainer without ``batch_axes`` adopts it, a Trainer
    given others raises ``ValueError`` (its rows would be laid out one way
    and routed another), and ``fit_feed`` raises on a ``ShardedFeed`` over
    the default axes."""
    for rank in world4:
        got = rank["batch_axes"]
        assert tuple(got["adopted"]) == ("data", "expert")
        assert "differ from the model's" in got.get("trainer_refused", "")
        assert "the feed's rows" in got.get("feed_refused", "")


def test_ep_mode_shard_map_matches_gspmd(world4):
    """``test_ep_mode_shard_map_matches_gspmd``: the same params give the
    same loss and folded aux term in both ep modes (the aux the global
    batch's in both), on every rank."""
    for rank in world4:
        np.testing.assert_allclose(rank["lm"]["shard_map"],
                                   rank["lm"]["gspmd"], rtol=2e-5)
    auxes = [rank["lm"]["gspmd"][1] for rank in world4]
    np.testing.assert_allclose(auxes, auxes[0], rtol=1e-6)


def test_routing_matches_jax_in_fp32(layer_params):
    """``ep._route`` (the routing of both modes and of ``MoEMlp``) against
    JAX ``ep._route``: the dispatch tensor exactly, each token's
    probability and the load-balance ingredients to fp32 rounding."""
    import jax.numpy as jnp

    from tensorflowonspark_tpu.parallel import ep as jax_ep

    x = _x(3, 4)
    flax = _flax_params(layer_params)
    want_d, want_p, (want_f, want_m) = jax_ep._route(
        jnp.asarray(x), flax["router"]["kernel"], flax["router"]["bias"],
        E, 4)
    xt = torch.from_numpy(x)
    got_d, got_p, (got_f, got_m) = ep._route(xt, ep.router_logits(
        xt, torch.from_numpy(layer_params["router.weight"]),
        torch.from_numpy(layer_params["router.bias"])), E, 4)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-6)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-6)


class _Mesh(object):
    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = tuple(sizes.values())

    def size(self, dim):
        return self._sizes[dim]


@pytest.mark.parametrize("base", ["replicated", "fsdp"])
def test_merge_ep_shardings_matches_jax(lm_state, base):
    """``test_ep_param_shardings_places_expert_dim`` and the moe/fsdp/ep
    layout: the expert-stacked leaves of the MoE LM on the expert axis,
    dim 0, as JAX places them; the router and every other leaf keep the
    base (replicated, or the FSDP rule's placement)."""
    import jax

    from tensorflowonspark_tpu.parallel import build_mesh
    from tensorflowonspark_tpu.parallel import ep as jax_ep
    from tensorflowonspark_torch import convert

    params = {k: torch.from_numpy(v) for k, v in lm_state.items()}
    tree = convert.transformer_params_to_flax(params, MOE_CFG["num_heads"])
    jax_mesh = build_mesh({"data": 2, "fsdp": 2, "expert": 2})
    jax_tree = jax_ep.ep_param_shardings(tree, jax_mesh)
    port_mesh = _Mesh(data=2, fsdp=2, expert=2)
    base_tree = (fsdp.tree_shardings(params, port_mesh) if base == "fsdp"
                 else {})
    got = ep.merge_ep_shardings(base_tree, params, port_mesh)
    for i in range(MOE_CFG["num_layers"]):
        jax_block = jax_tree["block_%d" % i]["moe"]
        for k in ("w1", "b1", "w2", "b2"):
            name = "blocks.%d.moe.%s" % (i, k)
            want = tuple(jax_block[k].spec)
            assert got[name].spec(params[name].dim()) == want + (None,) * (
                params[name].dim() - len(want)), name
        assert "expert" not in str(jax_block["router"]["kernel"].spec)
    for name, p in got.items():
        if not ep.MOE_PARAM_RE.search(name.replace(".", "/")):
            assert p == mesh_mod.as_placement(base_tree.get(name)), name
    del jax


@functools.lru_cache(maxsize=None)
def _jax_steps(mesh_items, expert):
    """Three steps of the JAX dp x ep step (the expert leaves over
    ``expert`` by ``merge_ep_shardings`` when ``expert``, batch over data):
    the losses and the params under the port's names."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    from tensorflowonspark_tpu.models import transformer as jax_transformer
    from tensorflowonspark_tpu.parallel import build_mesh
    from tensorflowonspark_tpu.parallel import ep as jax_ep
    from tensorflowonspark_tpu.parallel import mesh as jax_mesh_mod
    from tensorflowonspark_torch import convert

    mesh = build_mesh(dict(mesh_items))
    model = jax_transformer.build_transformer(**MOE_CFG)
    params = convert.transformer_params_to_flax(
        {k: torch.from_numpy(v) for k, v in _lm_state().items()},
        MOE_CFG["num_heads"])
    layout = jax.tree_util.tree_map(
        lambda _: jax_mesh_mod.replicated(mesh), params)
    if expert:
        layout = jax_ep.merge_ep_shardings(layout, params, mesh)
    params = jax.device_put(params, layout)
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
            mask = jax.device_put(MASK, NamedSharding(
                mesh, PartitionSpec("data")))
            params, opt_state, lv = step(params, opt_state, tokens, mask)
            losses.append(float(lv))
    got = convert.transformer_params_from_flax(jax.device_get(params))
    return losses, {k: np.asarray(v) for k, v in got.items()}


@functools.lru_cache(maxsize=None)
def _one_process_steps():
    """The same three steps of the port on one process, no mesh."""
    from tensorflowonspark_torch import train

    model = transformer.build_transformer(**MOE_CFG)
    tr = train.Trainer(
        transformer.loss_fn(model),
        {k: torch.from_numpy(v) for k, v in _lm_state().items()},
        functools.partial(torch.optim.Adam, lr=LR), device="cpu")
    losses = [tr.step({"tokens": _tokens(10 + i)}, MASK)[0].item()
              for i in range(3)]
    return losses, {k: v.detach().numpy().copy()
                    for k, v in tr.state.params.items()}, float(
        tr._health_grad_norm)


@pytest.mark.parametrize("key", sorted(TRAIN_CASES))
def test_ep_three_adam_steps_match_jax(world4, key):
    """``Trainer(param_sharding=merge_ep_shardings(...))`` on four ranks
    steps as the JAX dp x ep step (data 4 x expert 2) in fp32:
    ``shard_map`` with the rows over data and expert and over expert
    alone, ``gspmd`` with the expert ranks sharing rows, and over an FSDP
    base (the moe/fsdp/ep dry run's layout).  The losses within 1e-5 of
    JAX's and of the port's one-process steps; the gathered params within
    1e-5 of both (the qkv key bias within 3 x lr x 2) where the three
    exact reference runs (JAX's expert-parallel and replicated steps, the
    port's one process) agree: elsewhere Adam has amplified rounding noise
    of a near-zero gradient (up to 5e-5 in an expert's w1 between JAX's two
    runs, 1.2e-5 in one element of the position table between the port's
    one process and JAX), and the port is held to twice their spread, as
    ``tests/test_torch_parallel_train.py`` holds it."""
    want_losses, want_params = _jax_steps((("data", 4), ("expert", 2)), True)
    _, replicated = _jax_steps((("data", 8),), False)
    one_losses, one_params, _ = _one_process_steps()
    # the spread of the three exact runs, elementwise, as a run at that
    # distance from each reference (what _assert_params reads)
    spread = {name: np.maximum(np.abs(replicated[name] - w),
                               np.abs(one_params[name] - w))
              for name, w in want_params.items()}
    for rank in world4:
        np.testing.assert_allclose(rank[key]["losses"], want_losses,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(rank[key]["losses"], one_losses,
                                   rtol=LOSS_RTOL)
        for ref in (want_params, one_params):
            _assert_params(rank[key]["params"], ref,
                           {n: ref[n] + d for n, d in spread.items()})


@pytest.mark.parametrize("key", sorted(TRAIN_CASES))
def test_ep_ranks_hold_their_experts(world4, key):
    """Each rank holds E/ep experts of every expert leaf and their Adam
    moments, and the grad norm is the global one: the one-process run's
    (an error of scale in a leaf's gradient, which Adam's update would
    hide, shows here)."""
    ep_size = TRAIN_CASES[key][0]["expert"]
    d = MOE_CFG["num_heads"] * MOE_CFG["head_dim"]
    want = (MOE_CFG["num_experts"] // ep_size, d, 4 * d)
    for rank in world4:
        assert rank[key]["local"] == want
        assert rank[key]["exp_avg"] == want
    norms = [r[key]["grad_norm"] for r in world4]
    np.testing.assert_allclose(norms, norms[0], rtol=1e-6)
    np.testing.assert_allclose(norms[0], _one_process_steps()[2], rtol=1e-4)

