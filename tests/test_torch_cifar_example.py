"""The CIFAR twin (``examples/resnet/resnet_cifar_torch.py``, the twin of
``examples/resnet/resnet_cifar.py``) on the CPU: its optimizer, SGD with
Nesterov momentum over the JAX example's
``optax.warmup_cosine_decay_schedule``, against ``optax`` (the learning
rate at every count through the warmup, the cosine and past its end, and
three steps' params, within 1e-6), then the twin through ``cluster.run``
in FILES mode at ``--blocks_per_stage 1``, on the synthetic data and on
TFRecords written by the port's ``dfutil``, with checkpoints, a step
trace and the chief's export."""

import glob
import os
import subprocess
import sys

import numpy as np
import torch

import jax
import optax

from tensorflowonspark_torch import checkpoint, dfutil, train
from tensorflowonspark_torch.models import resnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "resnet", "resnet_cifar_torch.py")
sys.path.insert(0, os.path.dirname(EXAMPLE))
import resnet_cifar_torch as twin  # noqa: E402

TINY = ["--device", "cpu", "--train_steps", "2", "--batch_size", "32",
        "--blocks_per_stage", "1", "--log_steps", "1"]


def test_schedule_and_sgd_steps_match_optax():
    """40 steps of batch 32: base LR 0.025, a 2-step warmup, the cosine over
    38 steps.  The factory's LR at counts 0..44 is optax's schedule's, and
    three Nesterov steps from the same params and gradients land where
    ``optax.sgd(schedule, 0.9, nesterov=True)`` does."""
    args = twin.parse_args(["--train_steps", "40", "--batch_size", "32"])
    base_lr, warmup, decay_steps, total = twin.lr_schedule(args)
    assert (base_lr, warmup, decay_steps, total) == (0.025, 2, 40, 40)
    schedule = optax.warmup_cosine_decay_schedule(0.0, base_lr, warmup,
                                                  decay_steps)
    rng = np.random.default_rng(0)
    init = [rng.standard_normal((3, 4)).astype(np.float32),
            rng.standard_normal(5).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in init]
             for _ in range(45)]

    params = [torch.tensor(p, requires_grad=True) for p in init]
    opt = twin.warmup_cosine_sgd(base_lr, warmup, decay_steps)(params)
    lrs, after3 = [], None
    for step, g in enumerate(grads):
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        lrs.append(float(opt.param_groups[0]["lr"]))
        if step == 2:
            after3 = [p.detach().numpy().copy() for p in params]
    np.testing.assert_allclose(
        lrs, [float(schedule(i)) for i in range(45)], rtol=1e-6, atol=1e-9)
    assert lrs[0] == 0.0 and lrs[-1] == 0.0
    np.testing.assert_allclose(lrs[2], base_lr, rtol=1e-6)

    tx = optax.sgd(schedule, momentum=0.9, nesterov=True)
    jparams = [jax.numpy.asarray(p) for p in init]
    state = tx.init(jparams)
    for g in grads[:3]:
        updates, state = tx.update([jax.numpy.asarray(x) for x in g], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
    for got, want in zip(after3, jparams):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def _run(args):
    return subprocess.Popen([sys.executable, EXAMPLE] + TINY + args,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ,
                                                OMP_NUM_THREADS="1"))


def _wait(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    return out


def test_synthetic_and_tfrecord_runs(tmp_path):
    """Both runs end with exit 0 and export the params with the JAX
    example's descriptor; the TFRecord run (one node, flips on the host)
    checkpoints steps 1 and 2 with the schedule's count in the optimizer
    state, and the synthetic run (two nodes) writes a trace of each node's
    profiled step."""
    images, labels = twin.synthetic_cifar(64, seed=5)
    dfutil.save_as_tfrecords(
        [{"image": images[i].ravel().tolist(), "label": int(labels[i])}
         for i in range(64)], str(tmp_path / "cifar" / "train"),
        schema={"image": "array<float32>", "label": "int64"}, num_shards=2)
    synth = _run(["--cluster_size", "2", "--use_synthetic_data",
                  "--synthetic_examples", "64",
                  "--profile_steps", "1,2",
                  "--profile_dir", str(tmp_path / "profile"),
                  "--export_dir", str(tmp_path / "synth_export")])
    files = _run(["--cluster_size", "1",
                  "--data_dir", str(tmp_path / "cifar"),
                  "--model_dir", str(tmp_path / "model"),
                  "--save_interval", "1",
                  "--export_dir", str(tmp_path / "files_export")])
    _wait(synth)
    _wait(files)
    for name in ("synth_export", "files_export"):
        state, desc = checkpoint.load_model(str(tmp_path / name),
                                            validate=True)
        assert desc == {"model_name": "resnet56_cifar",
                        "model_config": {"dtype": "bfloat16",
                                         "blocks_per_stage": 1},
                        "input_signature": {"image": [None, 32, 32, 3]}}
        assert not any("running" in k for k in state)
    assert len(glob.glob(str(tmp_path / "profile" / "*.pt.trace.json*"))) \
        == 2
    assert sorted(os.listdir(tmp_path / "model")) == ["1", "2"]

    model = resnet.build_resnet56(blocks_per_stage=1, dtype="bfloat16")
    params, extra = resnet.split_state(model)
    base_lr, warmup, decay_steps, _ = twin.lr_schedule(
        twin.parse_args(TINY))
    tr = train.Trainer(resnet.loss_fn(model), params,
                       twin.warmup_cosine_sgd(base_lr, warmup, decay_steps),
                       extra_state=extra, device="cpu")
    assert tr.restore_latest(checkpoint.CheckpointManager(
        str(tmp_path / "model")), validate=True) == 2
    counts = [s["schedule_step"] for s in tr.state.optimizer.state.values()
              if "schedule_step" in s]
    assert [float(c) for c in counts] == [2.0]
