"""The port's Trainer on a mesh in a gloo world of 2, on the CPU:
``mesh=build_mesh()`` data parallelism is today's step bit for bit; an
FSDP world checkpoints in the one-card format, which one process restores
and continues exactly as an uninterrupted one-process run, and each rank
of the world restores its shards in place; a tensor axis waits for
ROADMAP.md's item J2; ``param_sharding="fsdp"`` needs an fsdp axis, as in
the JAX package.  The helpers are ``tests/test_torch_parallel_train.py``'s."""

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import checkpoint
from tensorflowonspark_torch.models import transformer
from tensorflowonspark_torch.parallel import mesh as mesh_mod

from test_torch_parallel_train import (CFG, LOSS_RTOL, MASK, _assert_params,
                                       _block, _init_state, _params,
                                       _tokens, _trainer)
from torch_world import run_world


@pytest.fixture(scope="module")
def state():
    return _init_state()


def _world2(rank, state, directory):
    """A world of two: ``mesh=build_mesh()`` against no mesh, bit for bit;
    FSDP steps with a checkpoint at step 2; the J2 axes raise."""
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
    errors = []
    tensor = mesh_mod.build_mesh({"tensor": 2}, device="cpu")
    for make in (lambda: _trainer(state, tensor),
                 lambda: transformer.build_transformer(**CFG, mesh=tensor)):
        try:
            make()
            errors.append(None)
        except NotImplementedError as err:
            errors.append(str(err))
    out["tensor_errors"] = errors
    return out


@pytest.fixture(scope="module")
def world2(state, tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    return directory, run_world(_world2, 2, state, directory)


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


def test_tensor_axis_names_j2(world2):
    """A mesh with a tensor axis of 2: the Trainer and the model raise
    ``NotImplementedError`` naming ROADMAP.md's item J2."""
    for rank in world2[1]:
        assert all(err and "J2" in err for err in rank["tensor_errors"])


def test_param_sharding_needs_an_fsdp_axis(state):
    """As in the JAX package, ``param_sharding="fsdp"`` needs a mesh with
    an fsdp axis (the Trainer without one raises ``ValueError``), and an
    explicit sharding tree waits for J2."""
    with pytest.raises(ValueError, match="fsdp"):
        _trainer(state, param_sharding="fsdp")
    with pytest.raises(NotImplementedError, match="J2"):
        _trainer(state, param_sharding={"embed.weight": None})
