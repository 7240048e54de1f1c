"""The port's Trainer on a mesh in a gloo world of 2, on the CPU:
``mesh=build_mesh()`` data parallelism is today's step bit for bit; an
FSDP world, a tensor-parallel one (``tp_param_shardings``) and an
expert-parallel MoE one (``merge_ep_shardings``) checkpoint in the
one-card format, which one process restores and continues exactly as an
uninterrupted one-process run, and which another mesh restores too (each
rank its shards, in place); ``param_sharding="fsdp"`` needs an fsdp axis,
as in the JAX package, and a sharding tree a mesh.  The helpers are
``tests/test_torch_parallel_train.py``'s."""

import functools

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import checkpoint, train
from tensorflowonspark_torch.models import transformer
from tensorflowonspark_torch.parallel import ep, tp
from tensorflowonspark_torch.parallel import mesh as mesh_mod

from test_torch_parallel_train import (CFG, LOSS_RTOL, LR, MASK,
                                       _assert_params, _block, _init_state,
                                       _params, _tokens, _trainer)
from torch_world import run_world


@pytest.fixture(scope="module")
def state():
    return _init_state()


MOE_CFG = dict(CFG, mlp="moe", num_experts=4)


def _moe_state():
    model = transformer.build_transformer(**MOE_CFG)
    model.init_weights(torch.Generator().manual_seed(1))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _moe_trainer(state, mesh=None, param_sharding=None, ep_mode="gspmd"):
    model = transformer.build_transformer(**MOE_CFG, mesh=mesh,
                                          ep_mode=ep_mode)
    return train.Trainer(
        transformer.loss_fn(model),
        {k: torch.from_numpy(v) for k, v in state.items()},
        functools.partial(torch.optim.Adam, lr=LR), device="cpu", mesh=mesh,
        param_sharding=param_sharding)


def _tp_tree(state, mesh):
    return tp.tp_param_shardings(
        state, mesh, views=transformer.build_transformer(**CFG).flax_views())


def _ep_tree(state, mesh):
    return ep.merge_ep_shardings({}, state, mesh)


def _save_and_restore(make, mesh, directory, rank, other, make_other):
    """Two steps under ``make()`` with a checkpoint at step 2, a third
    step uninterrupted, and the checkpoint restored in place by ``make()``
    and by ``make_other()`` on the ``other`` mesh, each stepping once more:
    their losses and params."""
    tr = make()
    ckpt = checkpoint.CheckpointManager(directory, save_interval_steps=2,
                                        is_chief=rank == 0,
                                        async_save=False)
    for i in range(2):
        tr.step({"tokens": _block(_tokens(40 + i), mesh)}, _block(MASK,
                                                                 mesh))
        ckpt.maybe_save(tr.state.step, tr.state)
    torch.distributed.barrier()
    out = {"uninterrupted_losses": [tr.step(
        {"tokens": _block(_tokens(42), mesh)}, _block(MASK, mesh))[0].item()],
        "uninterrupted_params": {
            k: v.detach().numpy().copy()
            for k, v in tr.state.full_params().items()}}
    for key, build, where in (("same", make, mesh),
                              ("other", make_other, other)):
        restored = build()
        assert restored.restore_latest(ckpt) == 2
        out[key + "_losses"] = [restored.step(
            {"tokens": _block(_tokens(42), where)},
            _block(MASK, where))[0].item()]
        out[key + "_params"] = {
            k: v.detach().numpy().copy()
            for k, v in restored.state.full_params().items()}
        out[key + "_local"] = {
            k: tuple(v.shape) for k, v in restored.state.params.items()}
    return out


def _world2(rank, state, moe_state, directory):
    """A world of two: ``mesh=build_mesh()`` against no mesh, bit for bit;
    FSDP steps with a checkpoint at step 2; the TP LM and the EP MoE LM
    with checkpoints at step 2, restored in place and on another mesh."""
    torch.set_num_threads(1)
    out = {}
    for key, mesh in (("plain", None),
                      ("mesh", mesh_mod.build_mesh(device="cpu"))):
        tr = _trainer(state, mesh)
        rows = slice(4 * rank, 4 * rank + 4)
        out[key] = [tr.step({"tokens": _tokens(30 + i)[rows]},
                            MASK[rows])[0].item() for i in range(2)]
        out[key + "_params"] = _params(tr)
    mesh = mesh_mod.build_mesh({"fsdp": 2}, device="cpu")
    tr = _trainer(state, mesh, param_sharding="fsdp")
    ckpt = checkpoint.CheckpointManager(directory, save_interval_steps=2,
                                        is_chief=rank == 0,
                                        async_save=False)
    for i in range(2):
        tr.step({"tokens": _block(_tokens(40 + i), mesh)}, _block(MASK,
                                                                 mesh))
        ckpt.maybe_save(tr.state.step, tr.state)
    torch.distributed.barrier()
    # every rank restores its shards in place and steps on
    restored = _trainer(state, mesh, param_sharding="fsdp")
    assert restored.restore_latest(ckpt) == 2
    out["restored_losses"] = [restored.step(
        {"tokens": _block(_tokens(42), mesh)}, _block(MASK, mesh))[0].item()]
    out["restored_params"] = _params(restored)
    tensor = mesh_mod.build_mesh({"tensor": 2}, device="cpu")
    data = mesh_mod.build_mesh({"data": 2}, device="cpu")
    out["tp"] = _save_and_restore(
        lambda: _trainer(state, tensor, param_sharding=_tp_tree(
            state, tensor)), tensor, directory + "_tp", rank, mesh,
        lambda: _trainer(state, mesh, param_sharding="fsdp"))
    expert = mesh_mod.build_mesh({"expert": 2}, device="cpu")
    out["ep"] = _save_and_restore(
        lambda: _moe_trainer(moe_state, expert, _ep_tree(moe_state, expert),
                             "shard_map"), expert, directory + "_ep", rank,
        data, lambda: _moe_trainer(moe_state, data))
    return out


@pytest.fixture(scope="module")
def moe_state():
    return _moe_state()


@pytest.fixture(scope="module")
def world2(state, moe_state, tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    return directory, run_world(_world2, 2, state, moe_state, directory)


def test_build_mesh_data_parallel_is_todays_step(world2):
    """``mesh=build_mesh()`` over two ranks: the same losses and params as
    the Trainer without a mesh, bit for bit."""
    for rank in world2[1]:
        assert rank["mesh"] == rank["plain"]
        for name, t in rank["plain_params"].items():
            assert np.array_equal(rank["mesh_params"][name], t), name


def test_fsdp_checkpoint_restores_across_world_sizes(world2, state):
    """An fsdp world of 2 checkpoints at step 2 in the one-card format;
    one process restores it and steps on, exactly as an uninterrupted
    one-process run; each rank of the world restores its shards and steps
    the same."""
    directory, ranks = world2
    ckpt = checkpoint.CheckpointManager(directory)
    saved, step = ckpt.restore_latest()
    assert step == 2
    assert saved["params"]["embed.weight"].shape == (CFG["vocab_size"], 64)
    exp_avg = [s["exp_avg"].shape for s in saved["opt_state"]["state"]
               .values()]
    assert (CFG["vocab_size"], 64) in exp_avg        # gathered, not a shard

    torch.set_num_threads(1)
    one = _trainer(state)
    for i in range(2):
        one.step({"tokens": _tokens(40 + i)}, MASK)
    resumed = _trainer(state)
    assert resumed.restore_latest(ckpt) == 2
    want = one.step({"tokens": _tokens(42)}, MASK)[0].item()
    got = resumed.step({"tokens": _tokens(42)}, MASK)[0].item()
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    want_params = _params(one)
    _assert_params(_params(resumed), want_params)
    for rank in ranks:
        _assert_params(rank["restored_params"], want_params)
    for rank in ranks:
        assert rank["restored_losses"][0] == pytest.approx(want,
                                                           rel=LOSS_RTOL)


def test_tensor_axis_names_j2(world2, state):
    """A mesh with a tensor axis of 2 (once refused as ROADMAP.md's item
    J2) trains: the TP Trainer's losses are the one-process run's, each
    rank holding half of a sharded leaf, and a restore in place continues
    the TP run as if uninterrupted."""
    one = _trainer(state)
    for i in range(3):
        want = one.step({"tokens": _tokens(40 + i)}, MASK)[0].item()
    for rank in world2[1]:
        tp_run = rank["tp"]
        assert tp_run["uninterrupted_losses"][0] == pytest.approx(
            want, rel=LOSS_RTOL)
        assert tp_run["same_local"]["embed.weight"] == (
            CFG["vocab_size"], 64)
        assert tp_run["same_losses"] == tp_run["uninterrupted_losses"]
        _assert_params(tp_run["same_params"], tp_run["uninterrupted_params"])


@pytest.mark.parametrize("kind", ["tp", "ep"])
def test_tp_and_ep_checkpoints_restore_across_meshes(world2, state,
                                                     moe_state, kind):
    """The TP checkpoint (tensor 2) and the EP one (the MoE LM on expert 2,
    ``shard_map``) are one-card checkpoints: full shapes and full Adam
    moments.  One process restores either and steps on with the losses of
    an uninterrupted one-process run; the world restores it on its own mesh
    and continues its run as if uninterrupted, and on another mesh (fsdp 2
    for TP, data 2 replicated for EP) steps as the one process does from
    the checkpoint.  (Params are held run to run from one state: across
    layouts Adam turns the rounding of a near-zero gradient into steps of
    up to lr, see tests/test_torch_ep.py.)"""
    directory = world2[0] + "_" + kind
    ckpt = checkpoint.CheckpointManager(directory)
    saved, step = ckpt.restore_latest()
    assert step == 2
    w1 = "blocks.0.moe.w1" if kind == "ep" else "blocks.0.mlp_in.weight"
    full = (moe_state if kind == "ep" else state)[w1].shape
    assert tuple(saved["params"][w1].shape) == full
    assert full in [tuple(s["exp_avg"].shape)
                    for s in saved["opt_state"]["state"].values()]
    torch.set_num_threads(1)
    make = (functools.partial(_moe_trainer, moe_state) if kind == "ep"
            else functools.partial(_trainer, state))
    one = make()
    for i in range(3):
        want = one.step({"tokens": _tokens(40 + i)}, MASK)[0].item()
    resumed = make()
    assert resumed.restore_latest(ckpt) == 2
    got = resumed.step({"tokens": _tokens(42)}, MASK)[0].item()
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    for rank in world2[1]:
        run = rank[kind]
        for where in ("same", "other"):
            assert run[where + "_losses"][0] == pytest.approx(
                want, rel=LOSS_RTOL)
        _assert_params(run["same_params"], run["uninterrupted_params"])
        _assert_params(run["other_params"], _params(resumed))
    if kind == "ep":
        assert world2[1][0]["ep"]["same_local"][w1][0] == 2   # E/ep


def test_param_sharding_needs_an_fsdp_axis(state):
    """As in the JAX package, ``param_sharding="fsdp"`` needs a mesh with
    an fsdp axis (the Trainer without one raises ``ValueError``), and an
    explicit sharding tree needs a mesh to place it on."""
    with pytest.raises(ValueError, match="fsdp"):
        _trainer(state, param_sharding="fsdp")
    with pytest.raises(ValueError, match="mesh"):
        _trainer(state, param_sharding={"embed.weight": None})
