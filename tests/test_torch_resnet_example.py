"""The ResNet twin (``examples/resnet/resnet_imagenet_torch.py``, the twin of
``examples/resnet/resnet_imagenet.py``) on the CPU through ``cluster.run``
in FILES mode, at tiny flags: the synthetic branch, then the predecoded
shards of ``write_synthetic_shards`` -> ``predecode_shards`` with the crop
on the device, K = 2 dispatches, checkpoints, the exact eval and the
chief's export, 2 steps each; its LR schedule against the JAX example's
``optax.join_schedules``; and ``--profile_steps``' trace."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import checkpoint, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "resnet", "resnet_imagenet_torch.py")
sys.path.insert(0, os.path.dirname(EXAMPLE))
import imagenet_input_torch  # noqa: E402
import resnet_imagenet_torch as twin  # noqa: E402

TINY = ["--device", "cpu", "--cluster_size", "1", "--batch_size", "8",
        "--image_size", "32", "--blocks_per_stage", "1", "--stem", "s2d",
        "--train_steps", "2", "--log_steps", "1"]


def _run(args):
    return subprocess.Popen([sys.executable, EXAMPLE] + TINY + args,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    return out


def _restored(model_dir):
    """A fresh Trainer of the twin's model restored from its checkpoints
    (validated): returns the step and the trainer."""
    from tensorflowonspark_torch.models import resnet

    model = resnet.build_resnet50(num_classes=twin.NUM_CLASSES,
                                  blocks_per_stage=1, stem="s2d")
    params, extra = resnet.split_state(model)
    args = twin.parse_args(TINY)
    base_lr, warmup, bounds, _ = twin.lr_schedule(args)
    tr = train.Trainer(resnet.loss_fn(model), params,
                       twin.scheduled_sgd(base_lr, warmup, bounds),
                       extra_state=extra, device="cpu")
    ckpt = checkpoint.CheckpointManager(model_dir)
    return tr.restore_latest(ckpt, validate=True), tr


def test_synthetic_and_predecoded_runs(tmp_path):
    """Both branches end with exit 0; the predecoded one (one dispatch of
    two steps) saves step 2 (params, optimizer state with the schedule's
    count, and the running averages, which moved), evaluates the
    validation rows, and each exports the params alone with the JAX
    example's descriptor."""
    src = tmp_path / "jpeg"
    for split, n, seed in (("train", 32, 0), ("validation", 16, 1)):
        imagenet_input_torch.write_synthetic_shards(
            str(src), num_examples=n, num_shards=2, image_size=40,
            num_classes=10, seed=seed, split=split)
    raw = str(tmp_path / "raw")
    imagenet_input_torch.predecode_shards(sorted(glob.glob(str(src / "*"))),
                                          raw, store_px=36)
    synth = _run(["--use_synthetic_data", "--synthetic_examples", "32",
                  "--export_dir", str(tmp_path / "synth_export")])
    files = _run(["--data_dir", raw, "--eval_data_dir", raw, "--predecoded",
                  "--store_px", "36", "--train_epochs", "2",
                  "--steps_per_call", "2", "--shuffle_buffer", "16",
                  "--model_dir", str(tmp_path / "model"),
                  "--save_interval", "1",
                  "--export_dir", str(tmp_path / "export")])
    _wait(synth)
    out = _wait(files)
    assert "eval accuracy:" in out and "eval rows: 16" in out
    for export in ("synth_export", "export"):
        state, descriptor = checkpoint.load_model(str(tmp_path / export),
                                                  validate=True)
        assert descriptor["model_name"] == "resnet50"
        assert descriptor["model_config"] == {
            "num_classes": 1001, "dtype": "bfloat16", "blocks_per_stage": 1,
            "stem": "s2d"}
        assert descriptor["input_signature"] == {"image": [None, 32, 32, 3]}
        assert not any("running" in k for k in state)
    # K = 2: one dispatch of two steps, then the final forced save
    assert sorted(os.listdir(tmp_path / "model")) == ["2"]
    step, tr = _restored(str(tmp_path / "model"))
    assert step == 2
    state, _ = checkpoint.load_model(str(tmp_path / "export"))
    for name, t in state.items():
        assert torch.equal(tr.state.params[name].detach(), t), name
    assert float(tr.state.extra["stem_norm.running_mean"].abs().sum()) > 0
    count = tr.state.optimizer.state[tr.state.optimizer.param_groups[0][
        "params"][0]]["schedule_step"]
    assert float(count) == 2.0


def test_lr_schedule_matches_optax():
    """The twin's tensor-lr SGD follows the JAX example's
    ``optax.join_schedules``: 0 at step 0, linear warmup, then the
    piecewise decays counted from the end of the warmup."""
    import optax

    args = twin.parse_args(["--batch_size", "512", "--train_steps", "400"])
    base_lr, warmup, bounds, total = twin.lr_schedule(args)
    # a boundary inside the run: one epoch is NUM_IMAGES // 512 steps
    bounds = [30, 60]
    schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, base_lr, warmup),
         optax.piecewise_constant_schedule(
             base_lr, {b: twin.LR_DECAY for b in bounds})], [warmup])
    param = torch.nn.Parameter(torch.zeros(()))
    opt = twin.scheduled_sgd(base_lr, warmup, bounds)([param])
    got = []
    for _ in range(warmup + 70):
        param.grad = torch.zeros(())
        opt.step()
        got.append(float(opt.param_groups[0]["lr"]))
    want = [float(schedule(i)) for i in range(warmup + 70)]
    assert got[0] == 0.0 and base_lr == pytest.approx(0.2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert total == 400 and warmup == 40
    # the full run's boundaries: epochs 30, 60, 80 in steps of batch 256
    args = twin.parse_args([])
    epoch = twin.NUM_IMAGES // 256
    assert twin.lr_schedule(args) == (
        0.1, 5 * epoch, [30 * epoch, 60 * epoch, 80 * epoch], 90 * epoch)


class _Ctx(object):
    """The node context the twin's synthetic branch reads, one process."""

    process_id, num_processes = 0, 1

    def initialize_distributed(self, device=None):
        return torch.device(device)

    def is_chief(self):
        return True

    def absolute_path(self, path):
        return path


def test_profile_steps_waits_for_item_k(tmp_path):
    """Item K is ported: ``--profile_steps 2,4`` traces exactly steps 2-4
    (three optimizer steps) into ``--profile_dir`` as a gzipped Chrome
    trace.  (The name predates the port of the step profiler.)"""
    import gzip
    import json

    args = twin.parse_args(TINY + ["--train_steps", "6", "--profile_steps",
                                   "2,4", "--profile_dir",
                                   str(tmp_path / "trace"),
                                   "--synthetic_examples", "48"])
    twin.train_resnet(args, _Ctx())
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json.gz"))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("Optimizer.step#")]
    assert len(steps) == 3, [e["name"] for e in steps]
