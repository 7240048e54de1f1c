"""The port's data-parallel path on several cards: the Trainer's NCCL
gradient all-reduce, the ResNet's BatchNorm statistics of the global batch,
and the cluster's NCCL world.

Marked ``cuda``; each test skips with a reason where fewer than two CUDA
cards are present.  No jax here (the machine with the cards has none), so
run it with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nccl_cuda.py
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import checkpoint, train
from tensorflowonspark_torch.models import mnist, resnet

from torch_world import run_world

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the global batch of a padded final step: 6 valid rows of 8
MASK = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
# fp32 on the cards with TF32 off: the ranks sum the batch's gradients in
# another order than one card does; 1e-5 on the loss and on the params
# after two SGD-momentum steps of lr 0.1
TOL = 1e-5


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")


def _batch():
    rng = np.random.default_rng(0)
    return (rng.random((8, 28, 28, 1), dtype=np.float32),
            rng.integers(0, 10, 8).astype(np.int64))


def _steps(device, rows):
    """Two Trainer steps of MNIST on ``rows`` of the global batch, from the
    same seeded init; returns the losses and params."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = mnist.build_mnist()
    tr = train.Trainer(mnist.loss_fn(model), dict(model.state_dict()),
                       functools.partial(torch.optim.SGD, lr=0.1,
                                         momentum=0.9),
                       batch_size=8, device=device)
    images, labels = _batch()
    losses = [tr.step({"image": images[rows], "label": labels[rows]},
                      MASK[rows])[0].item() for _ in range(2)]
    return losses, {k: v.detach().cpu().numpy()
                    for k, v in tr.state.params.items()}


def _rank_steps(rank):
    return _steps(torch.device("cuda", rank), slice(4 * rank, 4 * rank + 4))


def test_two_card_nccl_step_equals_one_card_step(two_cards):
    """Two NCCL ranks, each with half of a padded global batch (4 and 2
    valid rows), step as one card does on the whole batch, and both apply
    the same gradients."""
    ranks = run_world(_rank_steps, 2, backend="nccl")
    want_losses, want_params = _steps(torch.device("cuda", 0), slice(0, 8))
    for losses, params in ranks:
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=TOL)
        for name, want in want_params.items():
            np.testing.assert_allclose(params[name], want, rtol=0, atol=TOL,
                                       err_msg=name)
    for name in ranks[0][1]:
        assert np.array_equal(ranks[0][1][name], ranks[1][1][name]), name


def test_mnist_example_on_two_cards(two_cards, tmp_path):
    """The example's two SPARK-mode nodes, one card each: the forked
    children join an NCCL world, feed through ShardedFeed on their cards,
    all-reduce every step and the chief exports."""
    export = str(tmp_path / "export")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "mnist",
                                      "mnist_spark_torch.py"),
         "--cluster_size", "2", "--num_rows", "512", "--batch_size", "64",
         "--epochs", "1", "--export_dir", export],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    state, descriptor = checkpoint.load_model(export, validate=True)
    assert descriptor["model_name"] == "mnist_cnn"
    assert set(state) == set(mnist.build_mnist().state_dict())


def _group_steps(device, rows, k=4):
    """K = 4 MNIST steps from the same seeded init as one ``multi_step``
    (graph replays, the NCCL all-reduce inside the graph) on ``rows`` of
    each global batch; returns the final loss and the params."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = mnist.build_mnist()
    tr = train.Trainer(mnist.loss_fn(model), dict(model.state_dict()),
                       functools.partial(torch.optim.SGD, lr=0.1,
                                         momentum=0.9),
                       batch_size=8, device=device)
    images, labels = _batch()
    shift = [np.roll(images, i, axis=1) for i in range(k)]
    stack = {"image": np.stack([s[rows] for s in shift]),
             "label": np.stack([labels[rows]] * k)}
    loss = tr.multi_step(stack, np.stack([MASK[rows]] * k))
    return loss.item(), {n: v.detach().cpu().numpy()
                         for n, v in tr.state.params.items()}


def _rank_group_steps(rank):
    return _group_steps(torch.device("cuda", rank),
                        slice(4 * rank, 4 * rank + 4))


def test_two_card_multi_step_equals_one_card_steps(two_cards):
    """Two NCCL ranks run K = 4 steps as graph replays, the all-reduce
    captured in the graph, and end where one card's 4 steps on the whole
    padded batch end."""
    ranks = run_world(_rank_group_steps, 2, backend="nccl")
    want_loss, want_params = _group_steps(torch.device("cuda", 0),
                                          slice(0, 8))
    for loss, params in ranks:
        assert abs(loss - want_loss) <= TOL
        for name, want in want_params.items():
            np.testing.assert_allclose(params[name], want, rtol=0, atol=TOL,
                                       err_msg=name)


def _resnet_group(device, rows, k=3):
    """K = 3 steps of a small float64 ResNet-50 v1.5 (s2d, one bottleneck
    a stage, 32 px) as one ``multi_step`` on ``rows`` of each global batch,
    the last padded: two eager warm-ups, then a captured graph whose
    replay holds the BatchNorm all-reduces, the loss-share backward and
    the gradient all-reduce.  Returns the final loss, params and running
    averages."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = resnet.build_resnet50(num_classes=5, blocks_per_stage=1,
                                  stem="s2d", dtype="float64")
    model.init_weights(torch.Generator().manual_seed(0))
    params, extra = resnet.split_state(model)
    tr = train.Trainer(
        resnet.loss_fn(model, weight_decay=1e-4, label_smoothing=0.1),
        {n: v.double() for n, v in params.items()},
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        extra_state={n: v.double() for n, v in extra.items()},
        batch_size=8, device=device)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((k, 8, 32, 32, 3))
    labels = rng.integers(0, 5, (k, 8)).astype(np.int64)
    masks = np.stack([np.ones(8, np.float32)] * (k - 1) + [MASK])
    loss = tr.multi_step({"image": images[:, rows], "label": labels[:, rows]},
                         masks[:, rows])
    return (loss.item(),
            {n: v.detach().cpu().numpy() for n, v in tr.state.params.items()},
            {n: v.cpu().numpy() for n, v in tr.state.extra.items()})


def _rank_resnet_group(rank):
    return _resnet_group(torch.device("cuda", rank),
                         slice(4 * rank, 4 * rank + 4))


def test_two_card_resnet_global_batch_statistics(two_cards):
    """Two NCCL ranks of the ResNet, K = 3 graph replays with the
    BatchNorm statistics all-reduced inside the graph, end where one
    card's 3 steps on the whole batch end, the padded step's unequal valid
    rows (4 and 2) included.  float64 but for the fp32 logits: 1e-5 of
    each tensor's largest value (as tests/test_torch_resnet_dist.py holds
    two gloo ranks to JAX)."""
    ranks = run_world(_rank_resnet_group, 2, backend="nccl")
    want_loss, want_params, want_extra = _resnet_group(
        torch.device("cuda", 0), slice(0, 8))
    for loss, params, extra in ranks:
        assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
        for got, want in ((params, want_params), (extra, want_extra)):
            for name, value in want.items():
                np.testing.assert_allclose(
                    got[name], value, rtol=0,
                    atol=1e-5 * max(np.abs(value).max(), 1e-3),
                    err_msg=name)
