"""The segmentation twin (``examples/segmentation/segmentation_torch.py``,
the twin of ``examples/segmentation/segmentation.py``) on the CPU: its
``synthetic_pets`` against the JAX example's, its cluster run through
``cluster.run`` in FILES mode at the JAX example test's tiny flags
(``tests/test_examples.py::test_segmentation_synthetic``) with the chief's
export, whose descriptor is the JAX package's, and that export rebuilt by
the registry's ``widths`` and served by ``ModelServer``, the logits equal
to the trainer's forward at the trained params."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from tensorflowonspark_torch import checkpoint, serving
from tensorflowonspark_torch.models import unet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "segmentation")
TWIN = os.path.join(EXAMPLES, "segmentation_torch.py")
sys.path.insert(0, EXAMPLES)
import segmentation_torch as twin  # noqa: E402

# the JAX example test's flags
TINY = ["--cluster_size", "2", "--train_steps", "2", "--batch_size", "16",
        "--image_size", "32", "--encoder_filters", "16,32",
        "--synthetic_examples", "64"]


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "segmentation_jax_example", os.path.join(EXAMPLES, "segmentation.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synthetic_pets_equal_the_jax_examples():
    jax_example = _jax_example()
    for n, size in ((8, 32), (3, 128)):
        images, masks = twin.synthetic_pets(n, size)
        want_images, want_masks = jax_example.synthetic_pets(n, size)
        assert images.dtype == want_images.dtype == np.float32
        np.testing.assert_array_equal(images, want_images)
        np.testing.assert_array_equal(masks, want_masks)
        assert set(np.unique(masks)) == {0, 1, 2}


def _jax_descriptor(tmp_path):
    """The descriptor the JAX example's export writes
    (``segmentation.py:99-104``), from the JAX package's ``export_model``."""
    from tensorflowonspark_tpu import checkpoint as jax_checkpoint

    out = str(tmp_path / "jax_export")
    jax_checkpoint.export_model(
        out, {"w": np.zeros(2, np.float32)}, "unet",
        model_config={"num_classes": 3, "dtype": "bfloat16"},
        input_signature={"image": [None, 32, 32, 3]})
    with open(os.path.join(out, "export.json")) as f:
        return json.load(f)


def test_cluster_run_exports_the_jax_descriptor(tmp_path):
    """Two FILES-mode nodes over gloo, 2 steps, exit 0; the chief's export
    serves, rebuilt at the trained widths."""
    export = str(tmp_path / "export")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, TWIN, "--device", "cpu", "--export_dir", export]
        + TINY, capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    state, desc = checkpoint.load_model(export, validate=True)
    assert desc == _jax_descriptor(tmp_path)
    server = serving.ModelServer(export, batch_size=4, device="cpu")
    assert not server.from_artifact
    assert [b.conv.weight.shape[0] for b in server.model.down] == [16, 32]
    images, _ = twin.synthetic_pets(3, 32)
    out = server.predict_feed({"image": images}, 3)["output"]
    assert out.shape == (3, 32, 32, 3) and np.isfinite(out).all()


class _Ctx(object):
    """One chief node of a one-process world on the CPU, for calling the
    node function in this process."""
    process_id, num_processes = 0, 1

    def initialize_distributed(self, device=None):
        return torch.device(device)

    def is_chief(self):
        return True

    def absolute_path(self, path):
        return path


def test_served_logits_equal_the_trainers_forward(tmp_path):
    """``train_segmentation`` in this process: the loss falls over 8 Adam
    steps (one epoch of the 64 examples), the export rebuilds by
    ``widths=`` from a descriptor without the widths, and ``ModelServer``
    answers the trainer's own forward at the trained params, to the bit
    (same CPU, same ops)."""
    export = str(tmp_path / "export")
    args = twin.parse_args(
        ["--device", "cpu", "--train_steps", "8", "--batch_size", "8",
         "--image_size", "32", "--encoder_filters", "16,32",
         "--synthetic_examples", "64", "--lr", "1e-2",
         "--export_dir", export])
    losses = []
    model, trainer, stats = twin.train_segmentation(
        args, _Ctx(), on_step=lambda step, loss, aux: losses.append(
            float(loss)))
    assert len(losses) == 8 and trainer.state.step == 8
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert stats["loss"] == losses[-1]
    _, desc = checkpoint.load_model(export)
    assert "encoder_filters" not in desc["model_config"]
    images = twin.first_batch(args)["image"][:5]
    with torch.no_grad():
        want = torch.func.functional_call(
            model, trainer.state.params, (torch.from_numpy(images),))
    server = serving.ModelServer(export, batch_size=8, device="cpu")
    got = server.predict_feed({"image": images}, 5)["output"]
    np.testing.assert_array_equal(got, want.numpy())


def test_first_batch_is_the_runs_first_step():
    """``first_batch`` is the batch the node's first step takes: its loss
    at the init is the trainer's first loss."""
    args = twin.parse_args(
        ["--device", "cpu", "--train_steps", "1", "--batch_size", "4",
         "--image_size", "32", "--encoder_filters", "16,32",
         "--synthetic_examples", "16", "--dtype", "float32"])
    first = []
    twin.train_segmentation(args, _Ctx(), on_step=lambda s, loss, aux:
                            first.append(float(loss)))
    model, trainer = twin.build_trainer(args, "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in twin.first_batch(args).items()}
    with torch.no_grad():
        loss, _ = unet.loss_fn(model)(trainer.state.params, batch,
                                      torch.ones(4))
    assert float(loss) == first[0]
