"""The MNIST data and evaluator twins and the ImageNet pre-decode twin on
the CPU, each against the JAX script it twins:

- ``examples/mnist/mnist_data_setup_torch.py``: the synthetic generator,
  ``load_idx`` on IDX files written here (raw and gzipped), and the CSV
  and TFRecord bytes, from the functions on a small slice and from the
  whole script over small IDX files: byte for byte the JAX script's;
- ``examples/mnist/mnist_eval_node_torch.py``: two workers and the
  evaluator through ``cluster.run(eval_node=True)`` in FILES mode; the
  evaluator scores the final step, with the loss and accuracy of that
  checkpoint recomputed here;
- ``examples/resnet/predecode_imagenet_torch.py`` (a spawn pool of two)
  against ``examples/resnet/predecode_imagenet.py`` on
  ``write_synthetic_shards`` output: the same files, byte for byte.
"""

import gzip
import importlib.util
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import checkpoint
from tensorflowonspark_torch.models import mnist as mnist_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "examples", "mnist")
RESNET = os.path.join(REPO, "examples", "resnet")
sys.path.insert(0, MNIST)
import mnist_data_setup_torch as setup_twin  # noqa: E402
import mnist_eval_node_torch as eval_twin  # noqa: E402


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_setup():
    return _load("mnist_data_setup_jax",
                 os.path.join(MNIST, "mnist_data_setup.py"))


def _tree_bytes(root):
    """``{relative path: bytes}`` of every file under ``root``."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(
                    [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def test_synthetic_mnist_is_the_jax_scripts():
    jax_setup = _jax_setup()
    for split in ("train", "test"):
        images, labels = setup_twin.synthetic_mnist(split)
        want_images, want_labels = jax_setup.synthetic_mnist(split)
        assert images.dtype == np.uint8 and labels.dtype == np.uint8
        np.testing.assert_array_equal(images, want_images)
        np.testing.assert_array_equal(labels, want_labels)


def test_csv_and_tfrecord_bytes_equal_the_jax_scripts(tmp_path):
    jax_setup = _jax_setup()
    images, labels = setup_twin.synthetic_mnist("test")
    images, labels = images[:37], labels[:37]
    for module, out in ((setup_twin, tmp_path / "port"),
                        (jax_setup, tmp_path / "jax")):
        module.write_csv(images, labels, str(out / "csv"), 3)
        module.write_tfrecords(images, labels, str(out / "tfr"), 3)
    port, jax_files = _tree_bytes(tmp_path / "port"), _tree_bytes(
        tmp_path / "jax")
    assert sorted(port) == sorted(jax_files) and len(port) == 6
    for name, data in jax_files.items():
        assert port[name] == data, name


def _write_idx(root, split, n, seed, gz):
    """Small IDX files of one split (images magic 2051, labels 2049)."""
    names = {"train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
             "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 28, 28), np.uint8)
    labels = rng.integers(0, 10, (n,), np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(os.path.join(root, names[split][0] + suffix), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(os.path.join(root, names[split][1] + suffix), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return images.reshape(n, 784), labels


def test_idx_script_output_equals_the_jax_scripts(tmp_path):
    """``load_idx`` reads raw and gzipped IDX files as the JAX script does,
    and the whole script over them writes the same CSV and TFRecord
    bytes."""
    jax_setup = _jax_setup()
    idx = tmp_path / "idx"
    idx.mkdir()
    want = {"train": _write_idx(str(idx), "train", 23, 0, gz=True),
            "test": _write_idx(str(idx), "test", 11, 1, gz=False)}
    for split, (images, labels) in want.items():
        got = setup_twin.load_idx(str(idx), split)
        np.testing.assert_array_equal(got[0], images)
        np.testing.assert_array_equal(got[1], labels)
        jax_got = jax_setup.load_idx(str(idx), split)
        np.testing.assert_array_equal(got[0], jax_got[0])
    outs = {}
    for name, script in (("port", "mnist_data_setup_torch.py"),
                         ("jax", "mnist_data_setup.py")):
        outs[name] = str(tmp_path / name)
        proc = subprocess.run(
            [sys.executable, os.path.join(MNIST, script), "--output",
             outs[name], "--idx_dir", str(idx), "--num_partitions", "2"],
            capture_output=True, text=True, timeout=120,
            env=dict(_env(), JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "wrote 23 train examples" in proc.stdout
    port, jax_files = _tree_bytes(outs["port"]), _tree_bytes(outs["jax"])
    assert sorted(port) == sorted(jax_files) and len(port) == 8
    for name, data in jax_files.items():
        assert port[name] == data, name


def test_eval_node_scores_the_final_step(tmp_path):
    """Two workers train 6 SGD steps, checkpointing every 2; the evaluator,
    outside their world, scores checkpoints as they land and the final one
    for certain (the driver waits for it); its final line is that
    checkpoint's loss and accuracy on the evaluator's batch."""
    model_dir = tmp_path / "model"
    proc = subprocess.run(
        [sys.executable, os.path.join(MNIST, "mnist_eval_node_torch.py"),
         "--device", "cpu", "--cluster_size", "3", "--batch_size", "32",
         "--max_steps", "6", "--save_interval", "2", "--eval_timeout", "120",
         "--model_dir", str(model_dir)],
        capture_output=True, text=True, timeout=240, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "warning: evaluator never scored" not in proc.stderr
    with open(model_dir / "eval_metrics.jsonl") as f:
        lines = [json.loads(line) for line in f if line.strip()]
    steps = [line["step"] for line in lines]
    assert steps == sorted(set(steps)) and steps[-1] == 6
    assert set(steps) <= {2, 4, 6}

    args = type("Args", (), {"batch_size": 32, "lr": 0.01})()
    model, trainer = eval_twin._build(args, "cpu")
    assert trainer.restore_latest(
        checkpoint.CheckpointManager(str(model_dir))) == 6
    batch = {k: torch.from_numpy(v) for k, v in
             eval_twin._synthetic_batch(args, seed=1234).items()}
    with torch.no_grad():
        loss, aux = mnist_mod.loss_fn(model)(trainer.state.params, batch,
                                             torch.ones(32))
    np.testing.assert_allclose(lines[-1]["loss"], float(loss), rtol=1e-6)
    np.testing.assert_allclose(lines[-1]["accuracy"],
                               float(aux["accuracy"]), rtol=1e-6)


def test_predecode_twin_writes_the_jax_scripts_shards(tmp_path):
    pytest.importorskip(
        "PIL", reason="write_synthetic_shards encodes its JPEGs with PIL")
    sys.path.insert(0, RESNET)
    import imagenet_input_torch

    src = str(tmp_path / "jpeg")
    imagenet_input_torch.write_synthetic_shards(
        src, num_examples=12, num_shards=3, image_size=40, num_classes=10)
    outs = {}
    for name, script, procs in (
            ("port", "predecode_imagenet_torch.py", "2"),
            ("jax", "predecode_imagenet.py", "1")):
        outs[name] = str(tmp_path / name)
        proc = subprocess.run(
            [sys.executable, os.path.join(RESNET, script), "--src_dir", src,
             "--out_dir", outs[name], "--store_px", "36", "--procs", procs],
            capture_output=True, text=True, timeout=120,
            env=dict(_env(), JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "predecoded 3 shards" in proc.stdout
    port, jax_files = _tree_bytes(outs["port"]), _tree_bytes(outs["jax"])
    assert sorted(port) == sorted(jax_files) and len(port) == 3
    for name, data in jax_files.items():
        assert port[name] == data, name
