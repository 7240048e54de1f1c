"""The remediator's poison rollback live on the CPU (the port's twin of
the JAX remediator gate's rollback phase, ``scripts/ci_assert_remediator.py``):
one FILES-mode node checkpoints every step, the fault injector NaNs one
batch, and the watchtower's ``nonfinite`` crit drives the rollback that
carries the run to its step count.  The executor unpickles this module's
node function by reference: nothing here imports the JAX package."""

import json
import os
import time

from tensorflowonspark_torch import remediator
from test_torch_remediator import _linear_trainer, _xy


def _rollback_node_fn(args, ctx):
    """FILES mode: ``fit_supervised`` with a checkpoint every step; the
    executor's fault spec NaNs one batch, and the remediator's rollback
    must still carry the run to its full step count."""
    import numpy as np

    from tensorflowonspark_torch import checkpoint, fault, train

    rng = np.random.RandomState(7)

    class _Feed(object):
        def __init__(self, hold_at):
            self.terminated = False
            self.step = trainer.state.step
            self.hold_at = hold_at

        def batches(self):
            while not self.terminated:
                time.sleep(0.1)     # paced: the alert lands mid-run
                if self.step == self.hold_at:
                    # past the poison, the first stream waits (bounded) for
                    # the rollback to be armed, so a loaded host's slower
                    # alert still lands before the run's last step
                    deadline = time.monotonic() + 90.0
                    while (trainer._rollback_req is None
                           and time.monotonic() < deadline):
                        time.sleep(0.05)
                self.step += 1
                yield _xy(rng), np.ones(8, np.float32)

        def terminate(self):
            self.terminated = True

    # log_steps=2: nonfinite tallies fold at window boundaries, so windows
    # must close during the run for the watchtower to see the poison
    trainer = _linear_trainer(log_steps=2)
    mgr = checkpoint.CheckpointManager(os.path.abspath("ckpt"),
                                       save_interval_steps=1,
                                       max_to_keep=2 * args["steps"])
    made = []

    def factory():
        if made:
            # the poison was in the data: the replay reads clean batches
            os.environ.pop(fault.FAULT_SPEC_ENV, None)
        made.append(trainer.state.step)
        return _Feed(None if len(made) > 1 else args["hold_at"])

    train.fit_supervised(trainer, factory, mgr, max_steps=args["steps"])
    with open("result.json", "w") as f:
        json.dump({"step": int(trainer.state.step), "starts": made,
                   "rollbacks": trainer.counters_snapshot().get(
                       "train_rollbacks_total", 0),
                   "ckpt_entries": sorted(os.listdir("ckpt"))}, f)


def test_e2e_files_mode_poison_rollback(tmp_path):
    """FILES mode, one node checkpointing every step: the injected NaN
    batch -> the watchtower's ``nonfinite`` crit -> the remediator's
    ``rollback_poison`` -> ``train_rollback`` -> ``PoisonRollback`` ->
    ``restore_latest_valid``: the poisoned steps are quarantined as
    ``<step>.corrupt`` and the run still reaches its step count."""
    from tensorflowonspark_torch import backend, cluster, fault

    steps, nan_at = 40, 6
    b = backend.LocalBackend(1, env_per_executor=[
        {fault.FAULT_SPEC_ENV: json.dumps({"nan_batch_at_step": nan_at})}])
    try:
        c = cluster.run(
            b, _rollback_node_fn,
            tf_args={"steps": steps, "hold_at": nan_at + 4},
            num_executors=1, input_mode=cluster.InputMode.FILES,
            heartbeat_interval=0.5,
            log_dir=str(tmp_path), telemetry=True,
            observatory=True,
            watchtower={"interval_secs": 0.5, "window_secs": 6.0,
                        "cooldown_secs": 1.0, "journal_snapshot_secs": 1.0},
            remediator={"interval_secs": 0.25,
                        "confirm_windows": {"rollback_poison": 1},
                        "settle_ticks": 2, "cooldown_secs": 5.0,
                        "max_rollbacks": 1, "max_evictions": 0,
                        "journal_snapshot_secs": 1.0})
        c.shutdown(grace_secs=5)
        assert "error" not in c.tf_status, c.tf_status["error"]
        with open(os.path.join(b.workdir_root, "executor-0",
                               "result.json")) as f:
            result = json.load(f)
    finally:
        b.stop()
    assert result["step"] == steps, result
    assert result["rollbacks"] == 1, result
    assert len(result["starts"]) == 2 and nan_at >= result["starts"][1] > 0
    assert [e for e in result["ckpt_entries"] if e.endswith(".corrupt")]
    records = remediator.read_journal(
        os.path.join(str(tmp_path), "remediator", "journal.jsonl"))
    stages = {r["stage"] for r in records if r.get("kind") == "action"
              and r.get("action") == "rollback_poison"}
    assert {"proposed", "applied"} <= stages
    assert c.tf_status["alerts"]["nonfinite"] >= 1
