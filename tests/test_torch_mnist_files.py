"""The MNIST FILES-mode twin (``examples/mnist/mnist_files_torch.py``, the
twin of ``examples/mnist/mnist_files.py``) on the CPU: its streaming path
(``data.FileFeed`` -> ``ShardedFeed`` -> ``fit_feed``) from the JAX
example's init against the JAX example's ``train_streaming`` on the same
TFRecord shards (the row order is the same under the same seed: the loss
and the export agree).  ``tests/test_torch_mnist_files_cluster.py`` runs
the twin through ``cluster.run``."""

import argparse
import importlib.util
import os

import numpy as np
import torch

from tensorflowonspark_torch import checkpoint, dfutil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "examples", "mnist")
# bf16 compute on both sides from the same fp32 weights and rows: the
# losses after 4 SGD steps within 2e-2 nats, and each param's update (its
# export less the init) within 10% of the JAX update's norm (the bf16
# gradients round differently: 1.7-4.3% measured; other batches, or
# another order, are 70-180% off)
LOSS_TOL = 2e-2
UPDATE_RTOL = 0.1


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(MNIST, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def stage(root, num_shards):
    """``<root>/train``: 384 rows of the synthetic stand-in in TFRecord
    shards, the layout (and the ``image``/``label`` schema) of
    ``mnist_data_setup.py``'s ``tfr`` output."""
    twin = _load("mnist_files_torch")
    images, labels = twin.synthetic_mnist("train")
    rows = [{"image": (images[i] / 255.0).astype(np.float32).tolist(),
             "label": int(labels[i])} for i in range(384)]
    dfutil.save_as_tfrecords(rows, str(root / "train"),
                             schema={"image": "array<float32>",
                                     "label": "int64"}, num_shards=num_shards)
    return str(root)


class _Ctx(object):
    """The node context the streaming path reads, for one process."""

    process_id, num_processes = 0, 1

    def absolute_path(self, path):
        return path

    def is_chief(self):
        return True


def _args(data, export_dir, **kw):
    base = dict(batch_size=64, epochs=1, lr=0.05, max_steps=4,
                steps_per_call=1, shuffle_buffer=64, save_interval=100,
                data_dir=data, model_dir=None, export_dir=export_dir,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_streaming_matches_the_jax_example(tmp_path):
    """One shard, so one reader thread (the examples' FileFeed takes
    min(2, files)): the row order is a function of the seed alone, and the
    two runs see the same batches."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_torch import convert
    from tensorflowonspark_tpu import checkpoint as jax_checkpoint
    from tensorflowonspark_tpu.models import mnist as jax_mnist
    from tensorflowonspark_tpu.parallel import build_mesh

    data_dir = stage(tmp_path, 1)
    jax_example = _load("mnist_files")
    want = jax_example.train_streaming(
        _args(data_dir, str(tmp_path / "jax")), _Ctx(), build_mesh())
    init = convert.mnist_params_from_flax(jax.device_get(
        jax_mnist.build_mnist(dtype="bfloat16").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]))
    twin = _load("mnist_files_torch")
    got = twin.train_streaming(
        _args(data_dir, str(tmp_path / "torch")), _Ctx(), torch.device("cpu"),
        init_params=init)
    assert got["global_steps"] == want["global_steps"] == 4
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL
    jax_params, jax_desc = jax_checkpoint.load_model(str(tmp_path / "jax"))
    state, desc = checkpoint.load_model(str(tmp_path / "torch"))
    assert desc == {k: jax_desc[k] for k in desc}
    for name, value in convert.mnist_params_from_flax(
            jax.device_get(jax_params)).items():
        want_update = value - init[name]
        got_update = state[name] - init[name]
        assert float(want_update.norm()) > 0, name
        assert float((got_update - want_update).norm()) <= \
            UPDATE_RTOL * float(want_update.norm()), name
