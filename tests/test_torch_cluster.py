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


def _compile_root_fun(args, ctx):
    """What the node's compile plane set before this fn ran."""
    import json

    from tensorflowonspark_torch import compilecache
    from tensorflowonspark_torch.ops import _build

    with open(args.report, "w") as f:
        json.dump({"configured": compilecache.configured_dir(),
                   "env": os.environ.get(compilecache.CACHE_DIR_ENV),
                   "kernels": str(_build.build_dir())}, f)


def _service_spec_fun(args, ctx):
    """The data-service spec this node received."""
    import json

    with open(args.report, "w") as f:
        json.dump(ctx.data_service, f)


def _service_spec(pkg, data_service, report):
    """The spec a node of ``pkg`` (the port's or the JAX package's cluster
    and backend modules) receives from ``cluster.run(data_service=)``."""
    cluster_mod, backend_mod = pkg
    args = types.SimpleNamespace(report=report)
    b = backend_mod.LocalBackend(1)
    try:
        c = cluster_mod.run(b, _service_spec_fun, args, num_executors=1,
                            input_mode=cluster_mod.InputMode.FILES,
                            data_service=data_service)
        c.shutdown()
    finally:
        b.stop()
    with open(report) as f:
        return json.load(f)


@pytest.mark.parametrize("unported", [
    {"data_service": {"dispatcher": ["localhost:1", ("127.0.0.1", 2)],
                      "codecs": ["zlib"]}},
    {"compile_cache_dir": "root"},
])
def test_data_service_and_compile_planes_reach_the_node(unported, tmp_path):
    """Both planes once unported now work.  The data service: the node
    receives the spec the JAX package's ``cluster.run`` builds (a primary
    and a standby endpoint, the pinned codecs).  The compile plane: the
    node makes ``compile_cache_dir`` its compile root (kernels under
    ``<root>/kernels``) before the user fn runs."""
    if "data_service" in unported:
        from tensorflowonspark_tpu import backend as jax_backend
        from tensorflowonspark_tpu import cluster as jax_cluster

        spec = unported["data_service"]
        got = _service_spec((cluster, backend), spec,
                            str(tmp_path / "port.json"))
        want = _service_spec((jax_cluster, jax_backend), spec,
                             str(tmp_path / "jax.json"))
        assert got == want == {"dispatcher": [["localhost", 1],
                                              ["127.0.0.1", 2]],
                               "codecs": ["zlib"]}
        assert _service_spec((cluster, backend), "127.0.0.1:7",
                             str(tmp_path / "one.json")) == \
            {"dispatcher": ["127.0.0.1", 7]}
        return
    root = str(tmp_path / unported["compile_cache_dir"])
    args = types.SimpleNamespace(report=str(tmp_path / "report.json"))
    b = backend.LocalBackend(1)
    try:
        c = cluster.run(b, _compile_root_fun, args, num_executors=1,
                        input_mode=cluster.InputMode.FILES,
                        compile_cache_dir=root)
        c.shutdown()
    finally:
        b.stop()
    with open(args.report) as f:
        report = json.load(f)
    assert report == {"configured": root, "env": root,
                      "kernels": os.path.join(root, "kernels")}


def _noop_fun(args, ctx):
    pass


def _planes(pkg, options, log_dir):
    """``cluster.run`` of ``pkg`` (the port's or the JAX package's cluster
    and backend modules) on one FILES-mode executor with ``options``:
    which of the watchtower, autopilot and remediator engaged, or the
    ``ValueError`` it raised."""
    cluster_mod, backend_mod = pkg
    b = backend_mod.LocalBackend(1)
    try:
        try:
            c = cluster_mod.run(b, _noop_fun, None, num_executors=1,
                                input_mode=cluster_mod.InputMode.FILES,
                                log_dir=log_dir,
                                **options)
        except ValueError as e:
            return "ValueError: {}".format(e)
        engaged = {name: getattr(c, name) is not None
                   for name in ("watchtower", "autopilot", "remediator")}
        c.shutdown()
        return engaged
    finally:
        b.stop()


@pytest.mark.parametrize("options", [
    {"observatory": True, "watchtower": True},
    {"watchtower": {"interval_secs": 1}},
    {"autopilot": True},
    {"remediator": True},
    {"observatory": True, "remediator": True},
])
def test_control_plane_options_match_jax(options, tmp_path):
    """The alerting and control planes engage, or raise the same
    ``ValueError``, exactly as the JAX package's ``cluster.run`` does for
    the same options: the watchtower follows the observatory, and the
    autopilot and the remediator need it."""
    from tensorflowonspark_tpu import backend as jax_backend
    from tensorflowonspark_tpu import cluster as jax_cluster

    got = _planes((cluster, backend), options, str(tmp_path / "port"))
    want = _planes((jax_cluster, jax_backend), options,
                   str(tmp_path / "jax"))
    assert got == want
    assert got != {"watchtower": False, "autopilot": False,
                   "remediator": False} or "observatory" not in options


def _example(*argv, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "mnist",
                                      "mnist_spark_torch.py"), *argv],
        capture_output=True, text=True, timeout=120,
        env=None if env is None else dict(os.environ, **env))


def test_mnist_example_trains_on_the_cpu(tmp_path):
    # the guard of the next test: the nodes end their feeds at max_steps
    # (6 of the 8 steps the rows hold) and read each batch as they step
    # it, so TPUCluster.train returns only once the chief has stepped its
    # last step, and shutdown's fixed 5 s grace is left for the export
    # alone; with a prefetch of 2 the feed ended before the chief's last
    # steps, and on a loaded host the grace ended before the export
    export = str(tmp_path / "export")
    proc = _example("--device", "cpu", "--cluster_size", "2", "--num_rows",
                    "256", "--batch_size", "32", "--epochs", "1",
                    "--max_steps", "6", "--export_dir", export,
                    env={"TFOS_INFEED_PREFETCH": "0"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    state, descriptor = checkpoint.load_model(export, validate=True)
    assert descriptor["model_config"] == {"dtype": "bfloat16"}


def test_mnist_example_steps_per_call_and_tensorboard(tmp_path):
    """--steps_per_call 4 trains in groups, and with --tensorboard and
    --log_dir the chief writes a tfevents file TensorBoard can load."""
    log_dir = str(tmp_path / "tb")
    # max_steps: the chief finishes (and closes its writer) before the
    # cluster's shutdown, which in SPARK mode may stop a child mid-tail.
    # No prefetch: the nodes read each group as they dispatch it, so the
    # feed (and with it TPUCluster.train) ends only once the chief has
    # reached max_steps; a prefetch of 2 groups reads all 8 steps' rows
    # ahead, and on a loaded host shutdown's 5 s grace can end before the
    # chief's first steps
    proc = _example("--device", "cpu", "--cluster_size", "2", "--num_rows",
                    "512", "--batch_size", "32", "--epochs", "1",
                    "--max_steps", "8", "--steps_per_call", "4",
                    "--tensorboard", "--log_dir", log_dir, "--export_dir",
                    str(tmp_path / "export"),
                    env={"TFOS_INFEED_PREFETCH": "0"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    files = [f for f in os.listdir(log_dir) if "tfevents" in f]
    assert len(files) == 1, os.listdir(log_dir)     # the chief's only
    loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    events = list(loader.EventFileLoader(
        os.path.join(log_dir, files[0])).Load())
    tags = {v.tag for e in events for v in e.summary.value}
    assert {"loss", "avg_exp_per_second"} <= tags, tags
    steps = sorted({e.step for e in events for v in e.summary.value
                    if v.tag == "loss"})
    assert steps == list(range(1, 9))            # the per-step curve


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


def test_default_card_after_pin_cards(monkeypatch):
    """A worker that pin_cards left one card trains on cuda:0, whatever its
    local rank; unpinned, local rank r takes card r of the host's; a card
    that is not visible raises."""
    from tensorflowonspark_torch import device

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv(device.PINNED_ENV, raising=False)
    assert not device.cards_pinned()
    assert device.default_card(3, 4, pinned=False) == 3
    device.pin_cards(3, 1, total_cards=4)
    assert device.cards_pinned()
    assert device.default_card(3, 1, device.cards_pinned()) == 0
    with pytest.raises(ValueError, match="local rank 3"):
        device.default_card(3, 1, pinned=False)
    # a later change of the visible list is not this worker's pinning
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    assert not device.cards_pinned()


def test_heartbeat_memory_counters_leave_cuda_alone():
    """The heartbeat's card-memory leg is empty, and starts nothing, in a
    process that has not initialized CUDA (the executor shells)."""
    from tensorflowonspark_torch import metrics

    if torch.cuda.is_initialized():
        pytest.skip("CUDA is initialized in this process")
    assert metrics.device_memory_counters() == {}
    assert not torch.cuda.is_initialized()


# -- K steps per dispatch through the cluster, and its trace spans -----------

TRUE_W = np.array([3.14, 1.618], np.float32)
MEGA_ROWS = 36           # a node: 4 full steps of 8 rows, a padded step of 4


def _regression_rows(ids):
    x = np.random.default_rng(5).random((max(ids) + 1, 2)).astype(np.float32)
    return [[float(i)] + x[i].tolist() + [float(x[i] @ TRUE_W)] for i in ids]


def _regression_preprocess(items):
    rows = np.asarray(items, np.float32)
    return {"x": rows[:, 1:3], "y": rows[:, 3]}


def _linear_loss(params, batch, mask):
    pred = batch["x"] @ params["w"] + params["b"]
    err = (pred - batch["y"]) ** 2 * mask
    return err.sum() / mask.sum().clamp_min(1.0), pred


def _megastep_fun(args, ctx):
    """A node that trains the linear model with periodic checkpoints (the
    chief writes), restores the newest one and reports its params and the
    megastep stamp; K comes from TFOS_STEPS_PER_CALL when the cluster's
    executor_env sets it."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    device = ctx.initialize_distributed(device="cpu")
    trainer = train.Trainer(
        _linear_loss, {"w": np.zeros(2, np.float32),
                       "b": np.zeros((), np.float32)},
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        batch_size=GLOBAL_BATCH, log_steps=2, device=device)
    feed = infeed.ShardedFeed(ctx.get_data_feed(), GLOBAL_BATCH,
                              preprocess=_regression_preprocess,
                              device=device)
    ckpt = checkpoint.CheckpointManager(args.ckpt_dir, save_interval_steps=4,
                                        is_chief=ctx.is_chief())
    stats = trainer.fit_feed(
        feed, on_steps=lambda s: ckpt.maybe_save(s, trainer.state))
    ckpt.wait_until_finished()
    dist.barrier()
    _, restored = ckpt.restore_latest()
    ckpt.close()
    report = {"params": {k: v.detach().numpy().tolist()
                         for k, v in trainer.state.params.items()},
              "steps": trainer.state.step, "restored": restored,
              "megastep": stats["megastep"],
              "k_max": stats["overlap"].get("train_steps_per_call_max")}
    path = os.path.join(args.out_dir, "rank-{}.json".format(ctx.process_id))
    with open(path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(path + ".tmp", path)


def _megastep_run(tmp, env=None, telemetry_dir=None):
    os.makedirs(tmp)
    args = types.SimpleNamespace(out_dir=tmp,
                                 ckpt_dir=os.path.join(tmp, "ckpt"))
    parts = [_regression_rows(range(p * MEGA_ROWS, (p + 1) * MEGA_ROWS))
             for p in range(2)]
    b = backend.LocalBackend(2)
    try:
        c = cluster.run(b, _megastep_fun, args, num_executors=2,
                        input_mode=cluster.InputMode.SPARK,
                        heartbeat_interval=1.0, executor_env=env,
                        telemetry=telemetry_dir is not None,
                        telemetry_dir=telemetry_dir)
        c.train(parts, num_epochs=1)
        c.shutdown(grace_secs=1)
        return _reports(tmp, 2)
    finally:
        b.stop()


def test_cluster_steps_per_call_from_env_matches_k1_and_traces(tmp_path):
    """Two nodes, K = 4 armed by TFOS_STEPS_PER_CALL in the executors'
    environment (the twin of scripts/ci_assert_megastep.py): the final
    params equal the K = 1 cluster's, the stamp says K = 4, and with
    telemetry on the trace files hold the dispatch and checkpoint spans."""
    want = _megastep_run(str(tmp_path / "k1"))
    tdir = str(tmp_path / "telemetry")
    got = _megastep_run(str(tmp_path / "k4"),
                        env={train.STEPS_PER_CALL_ENV: "4"},
                        telemetry_dir=tdir)
    for w, g in zip(want, got):
        assert w["steps"] == g["steps"] == 5
        assert w["restored"] == g["restored"] == 4
        for name in w["params"]:
            np.testing.assert_allclose(g["params"][name], w["params"][name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        assert w["megastep"]["steps_per_call"] == 1
        assert g["megastep"]["steps_per_call"] == 4 and g["k_max"] == 4
    names = set()
    for name in os.listdir(tdir):
        if name.startswith("trace-"):
            with open(os.path.join(tdir, name)) as f:
                trace = json.load(f)
            events = trace["traceEvents"] if isinstance(trace, dict) else trace
            names.update(e.get("name") for e in events)
    assert {"train/dispatch", "checkpoint/save_requested", "checkpoint/save",
            "checkpoint/restore"} <= names, sorted(n for n in names if n)
