"""Supervised training on the CPU: the port's validated restore
(``restore_latest_valid``, the ``<step>.corrupt`` quarantine, the nested
nonfinite scan, the ``corrupt_checkpoint`` fault hook), the
``train_rollback`` knob and ``fit_supervised`` against the JAX package's.
Twins of ``tests/test_train.py``'s restore_latest_valid cases,
``tests/test_chaos.py``'s supervised-restart, fatal-error and preemption
cases and ``tests/test_checkpoint_async.py``'s final-save barrier.  The
model is those tests' linear regression; inputs come from numpy seeds and
reach both sides as numpy."""

import functools
import json
import os
import re
import signal
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import fault as jax_fault
from tensorflowonspark_tpu import node as jax_node
from tensorflowonspark_tpu import train as jax_train
from tensorflowonspark_tpu.parallel import build_mesh
from tensorflowonspark_torch import checkpoint, fault, node, train

TRUE_W = np.array([3.14, 1.618], dtype=np.float32)
BATCH = 8
# fp32 on both sides, the same arithmetic in another order, over 6-7 SGD
# steps: 1e-6 absolute on params of size about 1
PARAM_ATOL = 1e-6


def _rows(seed, n=32):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    return x, x @ TRUE_W


def _jax_loss(params, batch, mask):
    pred = jnp.asarray(batch["x"]) @ params["w"]
    err = (pred - jnp.asarray(batch["y"])) ** 2 * mask
    return err.sum() / jnp.maximum(mask.sum(), 1.0), {}


def _torch_loss(params, batch, mask):
    pred = batch["x"] @ params["w"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0), {}


class _Feed(object):
    """A fresh feed of ``n`` rows in batches of 8, as both ``fit_feed``s
    duck-type it.  ``crash_after`` raises a retryable injected failure
    before batch ``crash_after``; ``preempt_after`` SIGTERMs this process
    there; ``knob_after`` pushes ``train_rollback`` through ``apply_knobs``
    there (the remediator's command, after the poisoned step) and drops the
    fault spec, so that the replay after the rollback reads clean data."""

    def __init__(self, seed, n=32, fail=None, crash_after=None,
                 preempt_after=None, knob_after=None, apply_knobs=None):
        self.x, self.y = _rows(seed, n)
        self.fail = fail
        self.crash_after = crash_after
        self.preempt_after = preempt_after
        self.knob_after = knob_after
        self.apply_knobs = apply_knobs
        self.terminated = False

    def batches(self):
        for i in range(len(self.x) // BATCH):
            if self.terminated:
                return
            if i == self.crash_after:
                self.fail("injected feed-plane loss")
            if i == self.preempt_after:
                os.kill(os.getpid(), signal.SIGTERM)
            if i == self.knob_after:
                os.environ.pop(fault.FAULT_SPEC_ENV, None)
                self.apply_knobs({"train_rollback": "rb-1"})
            part = slice(i * BATCH, (i + 1) * BATCH)
            yield ({"x": self.x[part], "y": self.y[part]},
                   np.ones(BATCH, np.float32))

    def terminate(self):
        self.terminated = True


def _factory(side, seed=0, crash_first=None, **kwargs):
    """A feed factory for ``side`` ("jax" or "torch"); the first feed
    crashes before batch ``crash_first``.  ``made`` counts the feeds."""
    mod_fault, mod_node = ((jax_fault, jax_node) if side == "jax"
                           else (fault, node))
    made = []

    def make():
        made.append(1)
        return _Feed(seed, fail=mod_fault.fail,
                     crash_after=crash_first if len(made) == 1 else None,
                     apply_knobs=mod_node.apply_knobs, **kwargs)

    return make, made


def _jax_trainer():
    return jax_train.Trainer(_jax_loss, {"w": jnp.zeros((2,))},
                             optax.sgd(0.05), mesh=build_mesh(),
                             batch_size=BATCH, log_steps=2)


def _torch_trainer(**kwargs):
    return train.Trainer(_torch_loss, {"w": np.zeros(2, np.float32)},
                         functools.partial(torch.optim.SGD, lr=0.05),
                         batch_size=BATCH, log_steps=2, device="cpu",
                         **kwargs)


def _policy(mod):
    return mod.RetryPolicy(max_attempts=3, initial_backoff=0.05,
                           extra_retryable=["injected"])


# -- the nonfinite scan -------------------------------------------------------

def _jax_path(keystr):
    """A JAX key path as the port writes it: ``['opt_state']['state'][3]``
    -> ``opt_state.state.3``."""
    return ".".join(m[1] for m in re.findall(r"\[('?)([^\]']*)\1\]", keystr))


def test_nonfinite_leaves_walk_the_train_state_tree():
    """A TrainState's checkpoint tree is nested (Adam's state by param
    index): one NaN in an ``exp_avg`` is reported by its key path, the
    leaf the JAX scan reports for the same numbers in the same tree."""
    tr = train.Trainer(
        lambda p, b, m: ((p["a"] * b["x"]).sum() + p["b"].sum()
                         + p["c"].sum() + p["d"].sum(), {}),
        {k: np.ones(3, np.float32) for k in "abcd"},
        functools.partial(torch.optim.Adam, lr=1e-3), device="cpu")
    tr.step({"x": np.ones(3, np.float32)})
    state = tr.state.state_dict()
    state["opt_state"]["state"][3]["exp_avg"][1] = float("nan")
    got = checkpoint._nonfinite_leaves(state)
    assert got == ["opt_state.state.3.exp_avg"]

    def to_jax(tree):
        if isinstance(tree, dict):
            return {k: to_jax(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to_jax(v) for v in tree)
        if isinstance(tree, torch.Tensor):
            return jnp.asarray(tree.detach().numpy())
        return tree

    want = jax_checkpoint._nonfinite_leaves(to_jax(state))
    assert [_jax_path(p) for p in want] == got
    # a flat state_dict (load_model(validate=True)): the param's name
    flat = {"w": torch.tensor([1.0, float("inf")]), "b": torch.ones(2),
            "i": torch.tensor([3])}
    assert checkpoint._nonfinite_leaves(flat) == ["w"]
    assert checkpoint._nonfinite_leaves(state["params"]) == []


# -- restore_latest_valid ----------------------------------------------------

def _garble(step_dir, data=b"\xde\xad\xbe\xef"):
    for root, _, files in os.walk(step_dir):
        for fname in files:
            with open(os.path.join(root, fname), "wb") as f:
                f.write(data)


def test_restore_latest_valid_falls_back_past_corrupt_newest(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"),
                                       save_interval_steps=1, max_to_keep=3)
    for step in (1, 2, 3):
        assert mgr.maybe_save(step, {"w": torch.arange(4.0) * step},
                              force=True)
    mgr.wait_until_finished()
    step_dir = os.path.join(mgr.directory, "3")
    _garble(step_dir)
    restored, step = mgr.restore_latest_valid()
    assert step == 2
    assert torch.equal(restored["w"], torch.arange(4.0) * 2)
    # renamed out of the listing, kept for inspection
    assert not os.path.exists(step_dir)
    assert os.path.isdir(step_dir + ".corrupt")
    assert mgr.latest_step() == 2
    # a later save keeps the quarantined step out of retention
    for step in (3, 4, 5):
        mgr.maybe_save(step, {"w": torch.arange(4.0) * step}, force=True)
    mgr.wait_until_finished()
    assert sorted(os.listdir(mgr.directory)) == ["3", "3.corrupt", "4", "5"]
    mgr.close()


def test_restore_latest_valid_empty_when_nothing_valid(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"),
                                       save_interval_steps=1)
    assert mgr.maybe_save(1, {"w": torch.ones(2)}, force=True)
    mgr.wait_until_finished()
    step_dir = os.path.join(mgr.directory, "1")
    _garble(step_dir, b"junk")
    assert mgr.restore_latest_valid() == (None, None)
    assert os.path.isdir(step_dir + ".corrupt")
    # a second bad step 1 takes the next suffix
    assert mgr.maybe_save(1, {"w": torch.ones(2)}, force=True)
    mgr.wait_until_finished()
    os.remove(os.path.join(step_dir, "state.pt"))       # empty step dir
    assert mgr.restore_latest_valid() == (None, None)
    assert os.path.isdir(step_dir + ".corrupt.1")
    mgr.close()


def test_restore_latest_valid_quarantines_nonfinite_state(tmp_path):
    """A step saved after a poisoned update: NaN in the optimizer state of
    the nested tree is enough to quarantine it."""
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"),
                                       save_interval_steps=1)
    good = {"step": 1, "params": {"w": torch.ones(2)},
            "opt_state": {"state": {0: {"momentum_buffer": torch.ones(2)}}}}
    bad = {"step": 2, "params": {"w": torch.ones(2)},
           "opt_state": {"state": {0: {"momentum_buffer":
                                       torch.tensor([1.0, float("nan")])}}}}
    mgr.maybe_save(1, good, force=True)
    mgr.maybe_save(2, bad, force=True)
    restored, step = mgr.restore_latest_valid()
    assert step == 1 and restored["step"] == 1
    assert os.path.isdir(os.path.join(mgr.directory, "2.corrupt"))
    mgr.close()


def test_corrupt_checkpoint_injector_fires_once_after_the_save_lands(
        tmp_path, monkeypatch):
    """The fault hook garbles exactly one landed step (the manager resolves
    the injector once): a later save stays clean and the validated restore
    returns it; an async save is garbled only once it is written."""
    monkeypatch.setenv(fault.FAULT_SPEC_ENV,
                       json.dumps({"corrupt_checkpoint": True}))
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"),
                                       save_interval_steps=1, async_save=True)
    monkeypatch.delenv(fault.FAULT_SPEC_ENV)
    assert mgr.maybe_save(1, {"w": torch.ones(2)}, force=True)   # garbled
    mgr.wait_until_finished()
    with open(os.path.join(mgr.directory, "1", "state.pt"), "rb") as f:
        assert f.read() == b"\xde\xad\xbe\xef"
    assert mgr.maybe_save(2, {"w": torch.ones(2) * 2}, force=True)  # clean
    restored, step = mgr.restore_latest_valid()
    assert step == 2 and torch.equal(restored["w"], torch.ones(2) * 2)
    assert mgr.restore_latest_valid()[1] == 2
    mgr.close()


def test_trainer_restore_latest_validate_skips_a_bad_step(tmp_path):
    tr = _torch_trainer()
    mgr = checkpoint.CheckpointManager(str(tmp_path), save_interval_steps=1)
    assert tr.restore_latest(mgr, validate=True) is None
    tr.fit_feed(_Feed(0), on_steps=lambda s: mgr.maybe_save(s, tr.state))
    mgr.wait_until_finished()
    _garble(os.path.join(mgr.directory, "4"))
    fresh = _torch_trainer()
    assert fresh.restore_latest(mgr, validate=True) == 3
    assert fresh.state.step == 3
    mgr.close()


# -- the train_rollback knob -------------------------------------------------

def test_rollback_token_is_one_shot_and_halts_at_a_dispatch_boundary():
    tr = _torch_trainer()
    assert tr.apply_knob("train_rollback", "rb-1") is True
    assert tr._rollback_req == "rb-1"
    tr._rollback_req = None             # a fit_feed consumed it
    # a heartbeat re-broadcast of the same token: acknowledged, not re-armed
    assert tr.apply_knob("train_rollback", "rb-1") is True
    assert tr._rollback_req is None
    assert tr.apply_knob("train_rollback", "rb-2") is True
    feed = _Feed(0)
    with pytest.raises(fault.PoisonRollback) as info:
        tr.fit_feed(feed)
    assert info.value.step == 0 and info.value.token == "rb-2"
    assert feed.terminated and tr.state.step == 0
    # pushed through node.apply_knobs while the feed reads batch 3: at
    # K = 1 the next dispatch halts, at K = 2 the group of batches 2 and 3
    # never runs (the halt falls on a group boundary)
    for k, want in ((1, 3), (2, 2)):
        tr = _torch_trainer()
        feed = _Feed(0, knob_after=3, apply_knobs=node.apply_knobs)
        with pytest.raises(fault.PoisonRollback) as info:
            tr.fit_feed(_Grouped(feed) if k > 1 else feed,
                        steps_per_call=k)
        assert info.value.step == want == tr.state.step
        assert tr._rollback_req is None


class _Grouped(object):
    """K-step groups of a feed's batches, as ``ShardedFeed`` yields them."""

    def __init__(self, feed):
        self.feed = feed

    def grouped_batches(self, k):
        pending = []
        for batch, mask in self.feed.batches():
            pending.append((batch, mask))
            if len(pending) == k:
                yield ("multi",
                       {n: np.stack([b[n] for b, _ in pending])
                        for n in pending[0][0]},
                       np.stack([m for _, m in pending]))
                pending = []
        for batch, mask in pending:
            yield ("single", batch, mask)

    def terminate(self):
        self.feed.terminate()


# -- fit_supervised ------------------------------------------------------------

def _params(tr):
    return {k: v.detach().numpy() for k, v in tr.state.params.items()}


def test_fit_supervised_crash_once_resumes_like_jax(tmp_path):
    """Attempt 1 crashes before its third batch (after step 2, which is
    checkpointed); attempt 2 restores step 2 and consumes its fresh feed:
    6 steps, the JAX run's params at 1e-6."""
    results = {}
    for side in ("jax", "torch"):
        make, made = _factory(side, crash_first=2)
        if side == "jax":
            tr = _jax_trainer()
            mgr = jax_checkpoint.CheckpointManager(
                str(tmp_path / side), save_interval_steps=1)
            stats = jax_train.fit_supervised(tr, make, mgr,
                                             retry_policy=_policy(jax_fault))
            results[side] = np.asarray(tr.state.params["w"])
        else:
            tr = _torch_trainer()
            mgr = checkpoint.CheckpointManager(str(tmp_path / side),
                                               save_interval_steps=1)
            stats = train.fit_supervised(tr, make, mgr,
                                         retry_policy=_policy(fault))
            results[side] = _params(tr)["w"]
            assert tr.counters_snapshot()["goodput_recovery_us"] > 0
        assert len(made) == 2 and int(tr.state.step) == 6
        assert mgr.latest_step() == 6 and "loss" in stats
        mgr.close()
    np.testing.assert_allclose(results["torch"], results["jax"], rtol=0,
                               atol=PARAM_ATOL)


def test_fit_supervised_fatal_error_raises_without_retry(tmp_path):
    calls = []

    def feed_factory():
        calls.append(1)
        raise ValueError("user bug in feed construction")

    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="user bug"):
        train.fit_supervised(_torch_trainer(), feed_factory, mgr,
                             retry_policy=fault.RetryPolicy(
                                 max_attempts=5, initial_backoff=0.05))
    assert len(calls) == 1
    assert not node._preempt_callbacks     # the emergency save went too
    mgr.close()


@pytest.mark.parametrize("name", ["profiler", "transfer_guard", "publish"])
def test_fit_supervised_unported_options_raise(name, tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.fit_supervised(_torch_trainer(), _Feed, mgr,
                             **{name: object()})


def test_preemption_emergency_checkpoint_then_resume(tmp_path):
    """SIGTERM after 2 steps: the drain runs fit_supervised's emergency
    save past the interval gate and unwinds with SystemExit; a replacement
    run resumes at step 2 and takes its fresh feed's 4 steps."""
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"),
                                       save_interval_steps=100)
    old_handler = signal.getsignal(signal.SIGTERM)
    try:
        node._reset_preemption()
        assert node._install_sigterm_drain()
        with pytest.raises(SystemExit):
            train.fit_supervised(_torch_trainer(),
                                 lambda: _Feed(1, preempt_after=2), mgr,
                                 retry_policy=fault.RetryPolicy(
                                     max_attempts=2))
        assert node.preempted()
        assert mgr.latest_step() == 2
        assert not node._preempt_callbacks
        node._reset_preemption()
        tr = _torch_trainer()
        stats = train.fit_supervised(tr, lambda: _Feed(1), mgr,
                                     retry_policy=fault.RetryPolicy(
                                         max_attempts=2))
        assert tr.state.step == 6 and mgr.latest_step() == 6
        assert "loss" in stats
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        node._reset_preemption()
        mgr.close()


def test_fit_supervised_flushes_final_save_before_return(tmp_path):
    """When fit_supervised returns, the final forced save has landed on
    disk (not merely been queued), though every write takes 0.2 s."""
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"),
                                       save_interval_steps=100,
                                       async_save=True)
    write = mgr._write_files

    def slow_write(*args):
        time.sleep(0.2)
        return write(*args)

    mgr._write_files = slow_write
    tr = _torch_trainer()
    train.fit_supervised(tr, lambda: _Feed(2), mgr)
    final = tr.state.step
    assert final == 4
    # on disk, committed, with no write in flight
    assert os.listdir(mgr.directory) == [str(final)]
    state = torch.load(os.path.join(mgr.directory, str(final), "state.pt"),
                       weights_only=True)
    assert state["step"] == final
    assert mgr._save_queue.unfinished_tasks == 0
    mgr.close()


def test_poison_rollback_quarantines_and_resumes_like_jax(tmp_path,
                                                          monkeypatch):
    """A NaN batch at step 3 poisons the params (step 4 is saved NaN);
    the rollback knob pushed before batch 4 halts the run, the validated
    restore quarantines step 4 and resumes from step 3 on a fresh feed of
    6 batches: 9 steps, finite, one rollback, the JAX run's params at
    1e-6."""
    results = {}
    for side in ("jax", "torch"):
        monkeypatch.setenv(fault.FAULT_SPEC_ENV,
                           json.dumps({"nan_batch_at_step": 3}))
        make, made = _factory(side, seed=3, n=48, knob_after=4)
        if side == "jax":
            tr = _jax_trainer()
            mgr = jax_checkpoint.CheckpointManager(
                str(tmp_path / side), save_interval_steps=1, max_to_keep=10)
            jax_train.fit_supervised(tr, make, mgr)
            results[side] = np.asarray(tr.state.params["w"])
            jax_node._feeds[:] = []
        else:
            tr = _torch_trainer()
            mgr = checkpoint.CheckpointManager(
                str(tmp_path / side), save_interval_steps=1, max_to_keep=10)
            train.fit_supervised(tr, make, mgr)
            results[side] = _params(tr)["w"]
            assert tr.counters_snapshot()["train_rollbacks_total"] == 1
        assert len(made) == 2 and int(tr.state.step) == 9
        assert tr._rollbacks == 1
        assert os.path.isdir(os.path.join(mgr.directory, "4.corrupt"))
        mgr.close()
    assert np.isfinite(results["torch"]).all()
    np.testing.assert_allclose(results["torch"], results["jax"], rtol=0,
                               atol=PARAM_ATOL)
