"""The port's metrics recorder and checkpoint manager: ``TimeHistory``
windows and MFU against the JAX package's; ``CheckpointManager`` intervals,
retention, async snapshots, worker errors and restore."""

import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu import metrics as jax_metrics
from tensorflowonspark_torch import checkpoint, metrics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes run as fast on one, and the suite's
    parallel workers share the machine's cores with timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_time_history_windows_match_jax(monkeypatch):
    losses = [torch.tensor(float(i)) for i in range(7)]
    hist = metrics.TimeHistory(batch_size=4, log_steps=3, step_flops=1e9,
                               peak_flops=1e12)
    ref = jax_metrics.TimeHistory(batch_size=4, log_steps=3, step_flops=1e9,
                                  num_devices=1)
    monkeypatch.setattr(jax_metrics, "peak_flops_per_device", lambda: 1e12)
    for h in (hist, ref):
        h.on_train_begin()
        for loss in losses:
            h.on_step_end(loss if h is hist else jnp.asarray(loss.item()))
        h.on_train_end(losses[-1] if h is hist else jnp.asarray(6.0))
    assert [s for s, _ in hist.timestamp_log] == \
        [s for s, _ in ref.timestamp_log] == [0, 3, 6]
    assert hist.last_synced_value == 6.0
    assert hist.mfu(0.5) == pytest.approx(ref.mfu(0.5)) == pytest.approx(
        1e9 / 1e12 / 0.5)
    got, want = hist.build_stats(loss=6.0), ref.build_stats(loss=6.0)
    assert sorted(got) == sorted(want)
    assert got["global_steps"] == 7
    # on the CPU there is no peak: MFU is None, never a made-up figure
    assert metrics.TimeHistory(4, step_flops=1e9).mfu(0.5) is None
    assert metrics.peak_flops_per_device("cpu") is None


def test_mfu_formulas_match_jax(monkeypatch):
    monkeypatch.setattr(jax_metrics, "peak_flops_per_device", lambda: 2e12)
    for flops, secs in ((1e12, 2.0), (None, 1.0), (1e12, 0.0)):
        assert metrics.mfu_from_step_time(flops, secs, peak=2e12) == \
            jax_metrics.mfu_from_step_time(flops, secs)
        assert metrics.achieved_flops_per_sec(flops, secs) == \
            jax_metrics.achieved_flops_per_sec(flops, secs)


@pytest.mark.parametrize("async_save", [True, False])
def test_checkpoint_interval_retention_restore(tmp_path, async_save):
    mgr = checkpoint.CheckpointManager(str(tmp_path), save_interval_steps=3,
                                       max_to_keep=2, async_save=async_save)
    saved = []
    for step in range(1, 11):
        state = {"step": step, "w": torch.full((4,), float(step))}
        if mgr.maybe_save(step, state):
            saved.append(step)
    assert saved == [3, 6, 9]            # every crossed multiple of 3
    mgr.wait_until_finished()
    assert mgr.latest_step() == 9
    assert sorted(p.name for p in tmp_path.iterdir()) == ["6", "9"]
    state, step = mgr.restore_latest()
    assert step == 9 and state["step"] == 9
    assert torch.equal(state["w"], torch.full((4,), 9.0))
    # boundary crossing at a stride: 9 -> 13 crosses 12
    assert mgr.maybe_save(13, {"w": torch.zeros(1)})
    assert not mgr.maybe_save(13, {"w": torch.zeros(1)}, force=True)
    mgr.close()
    empty = checkpoint.CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest() == (None, None)


def test_async_snapshot_is_taken_at_save_time(tmp_path):
    """The async save writes the values of its step, even if the caller
    updates the tensors in place right after ``maybe_save``."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), save_interval_steps=1,
                                       max_to_keep=5, async_save=True)
    w = torch.zeros(1000)
    for step in range(1, 6):
        w.add_(1.0)
        mgr.maybe_save(step, {"w": w})
    mgr.wait_until_finished()
    for step in range(1, 6):
        state = torch.load(str(tmp_path / str(step) / "state.pt"))
        assert torch.equal(state["w"], torch.full((1000,), float(step)))
    mgr.close()


def test_async_worker_error_surfaces(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), save_interval_steps=1,
                                       async_save=True)
    mgr.maybe_save(1, {"bad": lambda: None})   # torch.save cannot pickle it
    with pytest.raises(Exception):
        mgr.wait_until_finished()
    assert mgr.maybe_save(2, {"w": torch.ones(1)})
    mgr.wait_until_finished()
    assert mgr.latest_step() == 2
    mgr.close()


def _rank_saves(rank, directory):
    """Both ranks of a world call ``maybe_save`` at the same steps on one
    directory; only rank 0, the chief, writes.  After the chief's writes
    land (and a barrier) both restore the newest step."""
    import os

    import torch.distributed as dist

    mgr = checkpoint.CheckpointManager(directory, save_interval_steps=2,
                                       max_to_keep=2, is_chief=rank == 0)
    accepted = []
    w = torch.zeros(3)
    for step in range(1, 7):
        w += 1.0                       # the same on both ranks
        accepted.append(mgr.maybe_save(step, {"w": w, "step": step}))
    mgr.wait_until_finished()
    dist.barrier()
    state, at = mgr.restore_latest()
    # the save gate stays in step: no error, nothing accepted mid-interval
    again = mgr.maybe_save(7, {"w": w, "step": 7})
    mgr.close()
    return (accepted, at, state["w"].tolist(), again,
            sorted(os.listdir(directory)))


def test_only_the_chief_writes_and_every_rank_restores(tmp_path):
    """Two gloo ranks save on one directory: exactly one copy of each step
    lands (retention keeps two), the next ``maybe_save`` raises nothing on
    either rank, and both ranks restore the chief's state."""
    from torch_world import run_world

    ranks = run_world(_rank_saves, 2, str(tmp_path))
    for accepted, at, w, again, listing in ranks:
        assert accepted == [False, True, False, True, False, True]
        assert at == 6 and w == [6.0, 6.0, 6.0] and again is False
        assert listing == ["4", "6"]
    assert checkpoint.CheckpointManager(str(tmp_path)).is_chief
