"""The MNIST FILES-mode twin (``examples/mnist/mnist_files_torch.py``)
through ``cluster.run`` in FILES mode on two CPU nodes: each node runs
``main_fun`` inline in its executor, reads its half of the shards
(``data.shard_for_process`` from the torch.distributed world) and trains
with periodic checkpoints; a second run restores the newest step and
trains on from it."""

import os
import subprocess
import sys

import torch

from tensorflowonspark_torch import checkpoint

from test_torch_mnist_files import MNIST, stage


def _cluster(data, model_dir, export_dir, max_steps):
    proc = subprocess.run(
        [sys.executable, os.path.join(MNIST, "mnist_files_torch.py"),
         "--device", "cpu", "--cluster_size", "2", "--data_dir", data,
         "--batch_size", "64", "--epochs", "2", "--max_steps",
         str(max_steps), "--save_interval", "2", "--model_dir", model_dir,
         "--export_dir", export_dir],
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_cluster_files_mode_checkpoints_and_resumes(tmp_path):
    """Two nodes read disjoint halves of the shards (rank-sharded by the
    torch.distributed world), train 3 steps with a save every 2 and the
    final one, export; a second run restores step 3 and trains on to 5."""
    data_dir = stage(tmp_path, 4)
    model_dir = str(tmp_path / "model")
    export = str(tmp_path / "export")
    _cluster(data_dir, model_dir, export, 3)
    assert sorted(os.listdir(model_dir)) == ["2", "3"]
    first, _ = checkpoint.load_model(export, validate=True)
    _cluster(data_dir, model_dir, export, 5)
    # max_to_keep=3 retires step 2
    assert sorted(os.listdir(model_dir)) == ["3", "4", "5"]
    state, _ = checkpoint.CheckpointManager(model_dir).restore_latest()
    assert state["step"] == 5
    second, descriptor = checkpoint.load_model(export, validate=True)
    assert descriptor["model_name"] == "mnist_cnn"
    for name, t in second.items():
        assert torch.equal(state["params"][name], t), name
    assert any(not torch.equal(first[n], second[n]) for n in first)
