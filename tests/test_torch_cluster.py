"""The port's cluster path end to end on the CPU: ``cluster.run`` on a
``LocalBackend`` in SPARK mode -> ``node`` (manager fork, rendezvous,
forked user-fn child) -> ``ctx.initialize_distributed`` (gloo) ->
``DataFeed`` -> ``ShardedFeed`` -> ``Trainer.fit_feed`` -> the chief's
export, held against the JAX Trainer on the same global batches; a
raising ``main_fun``; a FILES-mode node; and the MNIST example.

The JAX package is imported inside the tests only: the executors unpickle
this module's node functions by reference, and they import nothing of
jax."""

import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import backend, checkpoint, cluster, convert
from tensorflowonspark_torch import train
from tensorflowonspark_torch.models import mnist
from tensorflowonspark_torch.parallel import infeed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH = 16        # 8 rows a node
ROWS_PER_PART = 36       # 4 full steps and one padded step of 4 rows
LR = 0.05
# fp32 on both sides, the convs and the cross entropy summed in other
# orders, and the port's global mean taken over two ranks' sums: 1e-4
# relative on each step's loss
LOSS_RTOL = 1e-4


def _mnist_rows(ids, seed=0):
    """Rows ``[id, label, 784 pixels]`` of learnable synthetic digits."""
    rng = np.random.default_rng(seed)
    templates = rng.random((10, 784)) * 255
    rows = []
    for i in ids:
        label = i % 10
        noise = np.random.default_rng(1000 + i).integers(-20, 21, 784)
        pixels = np.clip(templates[label] + noise, 0, 255).round()
        rows.append([float(i), float(label)] + pixels.tolist())
    return rows


def _preprocess(items):
    rows = np.asarray(items, np.float32)
    return {"id": rows[:, 0].astype(np.int64),
            "label": rows[:, 1].astype(np.int64),
            "image": (rows[:, 2:] / 255.0).reshape(-1, 28, 28, 1)}


class _Recorder(object):
    """Passes a ShardedFeed's batches on to ``fit_feed`` and records each
    step's valid row ids."""

    def __init__(self, feed):
        self.feed = feed
        self.steps = []

    def batches(self):
        for batch, mask in self.feed.batches():
            valid = mask.numpy() > 0
            self.steps.append(batch["id"].numpy()[valid].tolist())
            yield batch, mask

    def terminate(self):
        self.feed.terminate()

    def counters_snapshot(self):
        return self.feed.counters_snapshot()


def _train_fun(args, ctx):
    """The node's user fn: MNIST CNN, fp32, SGD with momentum 0.9 from the
    converted flax init; per-step losses and row ids to a JSON file."""
    torch.set_num_threads(1)
    device = ctx.initialize_distributed(device="cpu")
    model = mnist.build_mnist()
    trainer = train.Trainer(
        mnist.loss_fn(model), torch.load(args.init_params, weights_only=True),
        functools.partial(torch.optim.SGD, lr=LR, momentum=0.9),
        batch_size=GLOBAL_BATCH, log_steps=1, device=device)
    feed = _Recorder(infeed.ShardedFeed(ctx.get_data_feed(), GLOBAL_BATCH,
                                        preprocess=_preprocess,
                                        device=device))
    losses = []
    trainer.fit_feed(feed, on_steps=lambda s: losses.append(
        trainer.history.last_synced_value))
    if checkpoint.should_export(ctx):
        checkpoint.export_model(args.export_dir, trainer.state.params,
                                "mnist_cnn", model_config={},
                                input_signature={"image": [None, 28, 28, 1]})
    report = {"rank": ctx.process_id, "world": ctx.num_processes,
              "ids": feed.steps, "losses": losses}
    path = os.path.join(args.out_dir, "rank-{}.json".format(ctx.process_id))
    with open(path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(path + ".tmp", path)


def _reports(out_dir, n, timeout=60):
    """The nodes' reports, waited for: a SPARK-mode child finishes its last
    step after the driver's shutdown sent the end of the feed."""
    import time

    deadline = time.monotonic() + timeout
    paths = [os.path.join(out_dir, "rank-{}.json".format(r)) for r in range(n)]
    while not all(os.path.exists(p) for p in paths):
        assert time.monotonic() < deadline, "node reports missing"
        time.sleep(0.2)
    reports = []
    for p in paths:
        with open(p) as f:
            reports.append(json.load(f))
    return reports


def _jax_losses(flax_params, rows_by_id, steps):
    """The JAX Trainer's loss at each step of the same global batches
    (rank 0's rows, then rank 1's, each padded to 8 with masked zeros)."""
    import jax
    import optax

    from tensorflowonspark_tpu import train as jax_train
    from tensorflowonspark_tpu.models import mnist as jax_mnist
    from tensorflowonspark_tpu.parallel import batch_sharding, build_mesh

    mesh = build_mesh()
    model = jax_mnist.build_mnist()
    trainer = jax_train.Trainer(jax_mnist.loss_fn(model), flax_params,
                                optax.sgd(LR, momentum=0.9), mesh=mesh,
                                batch_size=GLOBAL_BATCH, step_flops_override=1)
    local = GLOBAL_BATCH // 2
    losses = []
    for per_rank in steps:
        images = np.zeros((GLOBAL_BATCH, 28, 28, 1), np.float32)
        labels = np.zeros((GLOBAL_BATCH,), np.int32)
        mask = np.zeros((GLOBAL_BATCH,), np.float32)
        for rank, ids in enumerate(per_rank):
            for j, i in enumerate(ids):
                batch = _preprocess([rows_by_id[i]])
                images[rank * local + j] = batch["image"][0]
                labels[rank * local + j] = batch["label"][0]
                mask[rank * local + j] = 1.0
        loss, _ = trainer.step(
            {"image": jax.device_put(images, batch_sharding(mesh, 3)),
             "label": jax.device_put(labels, batch_sharding(mesh))},
            jax.device_put(mask, batch_sharding(mesh)))
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def flax_init(tmp_path_factory):
    """A flax MnistCNN init as numpy, and the port's converted copy saved
    for the nodes."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import mnist as jax_mnist

    params = jax.device_get(jax_mnist.build_mnist().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"])
    path = str(tmp_path_factory.mktemp("init") / "init.pt")
    torch.save(convert.mnist_params_from_flax(params), path)
    return params, path


def test_two_node_spark_cluster_matches_jax_trainer(flax_init, tmp_path):
    flax_params, init_path = flax_init
    parts = [_mnist_rows(range(p * ROWS_PER_PART, (p + 1) * ROWS_PER_PART))
             for p in range(2)]
    args = types.SimpleNamespace(init_params=init_path,
                                 export_dir=str(tmp_path / "export"),
                                 out_dir=str(tmp_path))
    b = backend.LocalBackend(2)
    try:
        c = cluster.run(b, _train_fun, args, num_executors=2,
                        input_mode=cluster.InputMode.SPARK,
                        heartbeat_interval=1.0)
        # one partition a node: two free executors take one feed task each
        c.train(parts, num_epochs=1)
        c.shutdown(grace_secs=1)
        reports = _reports(str(tmp_path), 2)
    finally:
        b.stop()
    assert [r["world"] for r in reports] == [2, 2]
    # every row trained exactly once, each node's rows from one partition
    ids = [i for r in reports for step in r["ids"] for i in step]
    assert sorted(ids) == list(range(2 * ROWS_PER_PART))
    assert [len(step) for step in reports[0]["ids"]] == [8, 8, 8, 8, 4]
    for r in reports:
        assert len({i // ROWS_PER_PART for step in r["ids"] for i in step}) == 1
    # both ranks report the global batch's loss
    np.testing.assert_allclose(reports[0]["losses"], reports[1]["losses"],
                               rtol=1e-6)
    rows_by_id = {int(row[0]): row for part in parts for row in part}
    steps = list(zip(reports[0]["ids"], reports[1]["ids"]))
    want = _jax_losses(flax_params, rows_by_id, steps)
    np.testing.assert_allclose(reports[0]["losses"], want, rtol=LOSS_RTOL)
    assert want[-1] < want[0]
    # the chief's export loads back and serves
    state, descriptor = checkpoint.load_model(args.export_dir, validate=True)
    assert descriptor["model_name"] == "mnist_cnn"
    from tensorflowonspark_torch import serving

    server = serving.ModelServer(args.export_dir, batch_size=4, device="cpu")
    out = server.predict_feed(
        {"image": _preprocess(parts[0][:3])["image"]}, 3)["output"]
    assert out.shape == (3, 10) and np.isfinite(out).all()


def _raise_fun(args, ctx):
    raise ValueError("injected failure in main_fun")


def test_raising_main_fun_fails_shutdown():
    b = backend.LocalBackend(1)
    try:
        c = cluster.run(b, _raise_fun, None, num_executors=1,
                        input_mode=cluster.InputMode.SPARK)
        with pytest.raises(Exception):
            c.train([_mnist_rows(range(4))])
        assert "error" in c.tf_status
        with pytest.raises(SystemExit) as exit_info:
            c.shutdown()
        assert exit_info.value.code == 1
    finally:
        b.stop()


def _files_fun(args, ctx):
    """A FILES-mode node: reads its own data (here made from a seed) and
    trains inline in its start task."""
    torch.set_num_threads(1)
    device = ctx.initialize_distributed(device="cpu")
    torch.manual_seed(0)
    model = mnist.build_mnist()
    trainer = train.Trainer(mnist.loss_fn(model), dict(model.state_dict()),
                            functools.partial(torch.optim.SGD, lr=LR),
                            batch_size=8, device=device)
    batch = _preprocess(_mnist_rows(range(8)))
    for _ in range(2):
        trainer.step({"image": batch["image"], "label": batch["label"]})
    if checkpoint.should_export(ctx):
        checkpoint.export_model(args.export_dir, trainer.state.params,
                                "mnist_cnn", model_config={},
                                input_signature={"image": [None, 28, 28, 1]})


def test_files_mode_node(tmp_path):
    args = types.SimpleNamespace(export_dir=str(tmp_path / "export"))
    b = backend.LocalBackend(1)
    try:
        c = cluster.run(b, _files_fun, args, num_executors=1,
                        input_mode=cluster.InputMode.FILES)
        c.shutdown()
    finally:
        b.stop()
    state, _ = checkpoint.load_model(args.export_dir)
    assert set(state) == set(mnist.build_mnist().state_dict())


@pytest.mark.parametrize("unported", [
    {"observatory": True}, {"watchtower": {"interval_secs": 1}},
    {"autopilot": True},
    {"remediator": True}, {"data_service": "localhost:1"},
    {"profiler": True}, {"compile_cache_dir": "/nonexistent"},
])
def test_unported_planes_raise(unported):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cluster.run(object(), _raise_fun, None, num_executors=1, **unported)


def _example(*argv):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "mnist",
                                      "mnist_spark_torch.py"), *argv],
        capture_output=True, text=True, timeout=120)


def test_mnist_example_trains_on_the_cpu(tmp_path):
    export = str(tmp_path / "export")
    proc = _example("--device", "cpu", "--cluster_size", "2", "--num_rows",
                    "256", "--batch_size", "32", "--epochs", "1",
                    "--export_dir", export)
    assert proc.returncode == 0, proc.stderr[-3000:]
    state, descriptor = checkpoint.load_model(export, validate=True)
    assert descriptor["model_config"] == {"dtype": "bfloat16"}


def test_mnist_example_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    proc = _example("--cluster_size", "1", "--num_rows", "64",
                    "--batch_size", "32", "--epochs", "1",
                    "--export_dir", str(tmp_path / "export"))
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


def test_pin_cards(monkeypatch):
    """Worker i gets cards [i*k, (i+1)*k) through CUDA_VISIBLE_DEVICES,
    picked from an inherited list when there is one; out of range raises."""
    from tensorflowonspark_torch import device

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert device.pin_cards(1, 2, total_cards=4) == ["2", "3"]
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "2,3"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    with pytest.raises(ValueError, match="beyond"):
        device.pin_cards(2, 2, total_cards=4)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert device.pin_cards(1, 2) == ["6", "7"]
    with pytest.raises(ValueError, match="beyond"):
        device.pin_cards(2, 2)


def test_heartbeat_memory_counters_leave_cuda_alone():
    """The heartbeat's card-memory leg is empty, and starts nothing, in a
    process that has not initialized CUDA (the executor shells)."""
    from tensorflowonspark_torch import metrics

    if torch.cuda.is_initialized():
        pytest.skip("CUDA is initialized in this process")
    assert metrics.device_memory_counters() == {}
    assert not torch.cuda.is_initialized()
