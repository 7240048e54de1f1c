"""The MNIST inference twin (``examples/mnist/mnist_inference_torch.py``)
against the JAX example (``examples/mnist/mnist_inference.py``): on the
same converted params and the same synthetic test rows, the twin's
``prediction label`` lines equal the JAX twin's, in process and through its
command line (a ``LocalBackend`` of two executors on the CPU)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu.models import get_model as jax_get_model
from tensorflowonspark_torch import checkpoint, convert
from tensorflowonspark_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "examples", "mnist")
ROWS = 256


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(MNIST, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """A JAX export of a flax init and the port's export of the same
    params, converted, with the model (so the twin serves the artifact)."""
    root = tmp_path_factory.mktemp("mnist")
    flax_model = jax_get_model("mnist_cnn")
    params = jax.tree_util.tree_map(np.asarray, flax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"])
    jax_dir, torch_dir = str(root / "jax"), str(root / "torch")
    signature = {"image": [None, 28, 28, 1]}
    jax_checkpoint.export_model(jax_dir, params, "mnist_cnn",
                                input_signature=signature)
    loaded, _ = jax_checkpoint.load_model(jax_dir)
    state = convert.mnist_params_from_flax(
        jax.tree_util.tree_map(np.asarray, loaded))
    model = get_model("mnist_cnn")
    model.load_state_dict(state)
    checkpoint.export_model(torch_dir, state, "mnist_cnn",
                            input_signature=signature, model=model)
    return jax_dir, torch_dir


def _jax_lines(jax_dir, rows, batch_size):
    jax_twin = _load("mnist_inference")
    return jax_twin.infer_partition(jax_dir, batch_size)(iter(rows))


def test_twin_lines_equal_jax(exports):
    """The same rows as the JAX example's synthetic test split, served
    through the twin's per-process cached server (the artifact) in
    batches of 64: the same predictions, the same labels."""
    jax_dir, torch_dir = exports
    twin = _load("mnist_inference_torch")
    setup = _load("mnist_data_setup")
    images, labels = setup.synthetic_mnist("test")
    rows = [[float(labels[i])] + images[i].astype(float).tolist()
            for i in range(ROWS)]
    assert twin.synthetic_test_rows(ROWS) == rows
    got = twin.infer_partition(torch_dir, 64, "cpu")(iter(rows))
    assert twin._CACHE["server"].from_artifact
    want = _jax_lines(jax_dir, rows, 64)
    assert len(got) == ROWS and got == want


def test_twin_command_line_equals_jax(exports, tmp_path):
    """``python mnist_inference_torch.py --device cpu`` on two executors
    writes the JAX lines for the same rows, in row order."""
    jax_dir, torch_dir = exports
    out = str(tmp_path / "preds.txt")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(MNIST, "mnist_inference_torch.py"),
         "--export_dir", torch_dir, "--device", "cpu", "--cluster_size",
         "2", "--num_rows", str(ROWS), "--batch_size", "32",
         "--output", out], capture_output=True, text=True, timeout=240,
        env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "accuracy:" in proc.stdout
    with open(out) as f:
        got = f.read().split("\n")[:-1]
    twin = _load("mnist_inference_torch")
    want = _jax_lines(jax_dir, twin.synthetic_test_rows(ROWS), 32)
    assert got == want
