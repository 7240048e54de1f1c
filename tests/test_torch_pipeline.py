"""The port's Spark ML pipeline against the JAX package's:
``tests/test_pipeline.py``'s unit cases re-pointed (``Namespace``,
``TFParams``, ``_dataset_rows``), then ``TFEstimator.fit`` -> the port's
``Trainer`` in SPARK mode on a ``LocalBackend`` -> the chief's export ->
``TFModel.transform`` on the CPU, for the known-weights ``linear``
regression and the multi-input, multi-output ``two_tower`` model; and the
node's refusal to fork from an executor that initialized CUDA.

The JAX package is imported inside the tests only: the executors unpickle
this module's node functions by reference, and they import nothing of
jax."""

import argparse
import functools
import os

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import backend, checkpoint, node, pipeline
from tensorflowonspark_torch import serving, train
from tensorflowonspark_torch.models import get_model, linear, twotower
from tensorflowonspark_torch.parallel import infeed

WEIGHTS = [3.14, 1.618]  # reference test_pipeline.py:20


# ---------------------------------------------------------------------------
# units: Namespace / params merging / dataset rows, against the JAX package
# ---------------------------------------------------------------------------

class TestNamespace:
    def test_from_dict_and_kwargs(self):
        ns = pipeline.Namespace({"a": 1}, b=2)
        assert ns.a == 1 and ns.b == 2
        assert "a" in ns and "c" not in ns

    def test_from_argparse(self):
        args = argparse.Namespace(x=10)
        ns = pipeline.Namespace(args)
        assert ns.x == 10
        assert ns == args

    def test_copy_semantics(self):
        src = pipeline.Namespace({"a": 1})
        dup = pipeline.Namespace(src)
        dup.a = 2
        assert src.a == 1

    def test_rejects_other_sources(self):
        with pytest.raises(ValueError):
            pipeline.Namespace([1, 2])


class TestParams:
    def test_defaults_and_set_get(self):
        p = pipeline.TFParams()
        assert p.get("batch_size") == 128
        p.set("batch_size", 64)
        assert p.get("batch_size") == 64

    def test_camel_accessors(self):
        p = pipeline.TFParams()
        p.setBatchSize(32).setClusterSize(4)
        assert p.getBatchSize() == 32 and p.getClusterSize() == 4

    def test_unknown_param_rejected(self):
        with pytest.raises(KeyError):
            pipeline.TFParams().set("nope", 1)

    def test_merge_args_params(self):
        p = pipeline.TFParams(batch_size=17)
        merged = p.merge_args_params(argparse.Namespace(lr=0.5, batch_size=1))
        assert merged.batch_size == 17
        assert merged.lr == 0.5

    def test_param_table_and_ml_bases_match_jax(self):
        from tensorflowonspark_tpu import pipeline as jax_pipeline

        assert sorted(pipeline.PARAMS) == sorted(jax_pipeline.PARAMS)
        assert {k: v[0] for k, v in pipeline.PARAMS.items()} == \
            {k: v[0] for k, v in jax_pipeline.PARAMS.items()}
        assert pipeline.HAS_PYSPARK_ML == jax_pipeline.HAS_PYSPARK_ML
        args = argparse.Namespace(lr=0.5, batch_size=1)
        assert vars(pipeline.TFParams(epochs=3).merge_args_params(args)) == \
            vars(jax_pipeline.TFParams(epochs=3).merge_args_params(args))


class TestDatasetRows:
    @pytest.mark.parametrize("dataset,cols", [
        ([{"b": 2, "a": 1}, {"b": 4, "a": 3}], None),
        ([{"b": 2, "a": 1, "c": 0}], ["c", "a"]),
        ([(1, 2), (3, 4)], None),
        ([(1, 2)], ["y", "x"]),
        ([], None),
    ])
    def test_matches_jax(self, dataset, cols):
        from tensorflowonspark_tpu import pipeline as jax_pipeline

        assert pipeline._dataset_rows(dataset, cols) == \
            jax_pipeline._dataset_rows(dataset, cols)

    def test_dict_rows_sorted_columns(self):
        rows, cols = pipeline._dataset_rows(
            [{"b": 2, "a": 1}, {"b": 4, "a": 3}])
        assert cols == ["a", "b"]
        assert rows == [(1, 2), (3, 4)]


def test_refuses_to_fork_after_cuda(monkeypatch):
    """An executor that initialized CUDA (a transform on the card) refuses
    to host a node, naming the reason; one that did not, goes on."""
    node.refuse_if_cuda_initialized()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="initialized CUDA.*fit before"):
        node.refuse_if_cuda_initialized()


# ---------------------------------------------------------------------------
# integration: fit -> export -> transform on a LocalBackend, on the CPU
# ---------------------------------------------------------------------------

def _make_dataset(n=512, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 2), np.float32)
    y = x @ np.asarray(WEIGHTS, np.float32)
    return [{"features": x[i].tolist(), "label": float(y[i])}
            for i in range(n)]


def _fit(train_fn, loss_of, model, args, ctx, to_batch):
    """The node's Trainer loop: the port's ``Trainer`` over a columnar
    ``ShardedFeed``; the chief exports."""
    torch.set_num_threads(1)
    device = ctx.initialize_distributed(device="cpu")
    trainer = train.Trainer(
        loss_of(model), dict(model.state_dict()),
        functools.partial(torch.optim.Adam, lr=args.lr),
        batch_size=args.batch_size, log_steps=50, device=device)
    feed = infeed.ShardedFeed(
        ctx.get_data_feed(input_mapping=args.input_mapping),
        args.batch_size, transform=to_batch, device=device)
    trainer.fit_feed(feed)
    if checkpoint.should_export(ctx):
        train_fn(trainer.state.params)


def _linear_batch(arrays):
    return {"x": torch.as_tensor(np.asarray(arrays["x"], np.float32)),
            "y": torch.as_tensor(np.asarray(arrays["y"], np.float32))}


def _linear_train_fn(args, ctx):
    """Per-node training fn: linear regression through the port's
    Trainer; the chief exports with the JAX ``model_config``."""
    torch.manual_seed(0)
    model = get_model("linear", in_features=2)

    def export(params):
        checkpoint.export_model(args.export_dir, params, "linear",
                                model_config={"features": 1},
                                input_signature={"x": [None, 2]})

    _fit(export, linear.loss_fn, model, args, ctx, _linear_batch)


def test_fit_transform_end_to_end(tmp_path):
    b = backend.LocalBackend(2)
    try:
        export_dir = str(tmp_path / "export")
        est = pipeline.TFEstimator(
            _linear_train_fn, {"lr": 0.25}, b, device="cpu",
            cluster_size=2, batch_size=64, epochs=32,
            export_dir=export_dir, grace_secs=2,
            input_mapping={"features": "x", "label": "y"})
        model = est.fit(_make_dataset())
        assert os.path.exists(os.path.join(export_dir, "export.json"))
        assert isinstance(model, pipeline.TFModel)

        model.set("input_mapping", {"features": "x"})
        test_rows = [[1.0, 1.0], [2.0, 0.0], [0.0, 2.0], [0.5, 0.25],
                     [3.0, 1.0]]
        preds = model.transform(test_rows)
    finally:
        b.stop()
    assert len(preds) == 5
    expect = [sum(WEIGHTS), 2 * WEIGHTS[0], 2 * WEIGHTS[1],
              0.5 * WEIGHTS[0] + 0.25 * WEIGHTS[1],
              3 * WEIGHTS[0] + WEIGHTS[1]]
    for pred, want in zip(preds, expect):
        # the JAX test's tolerance on the learned weights
        assert abs(pred[0] - want) < 0.1, (pred, want)
    # row order, and the port ModelServer's own outputs on the same rows
    server = serving.ModelServer(export_dir, batch_size=64, device="cpu")
    want = server.predict_feed({"x": np.asarray(test_rows, np.float32)},
                               5)["output"]
    np.testing.assert_allclose(np.asarray(preds, np.float32), want,
                               rtol=0, atol=1e-6)
    # in-process (no backend) gives the same
    local = pipeline.TFModel(backend=None, device="cpu",
                             export_dir=export_dir, batch_size=2,
                             input_mapping={"features": "x"})
    assert local.transform(test_rows) == preds


def _tower_batch(arrays):
    return {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in arrays.items()}


def _two_tower_train_fn(args, ctx):
    """Multi-input training fn: consumes (item, label, user) columns,
    trains the two-tower model briefly, the chief exports with a 2-input
    signature."""
    torch.manual_seed(0)
    model = get_model("two_tower", embed_dim=4, user_features=3,
                      item_features=3)

    def export(params):
        checkpoint.export_model(
            args.export_dir, params, "two_tower",
            model_config={"embed_dim": 4},
            input_signature={
                "user": {"shape": [None, 3], "dtype": "float32"},
                "item": {"shape": [None, 3], "dtype": "float32"}})

    _fit(export, twotower.loss_fn, model, args, ctx, _tower_batch)


def test_multi_input_multi_output_fit_transform(tmp_path):
    rng = np.random.default_rng(1)
    n = 256
    users = rng.random((n, 3), np.float32)
    items = rng.random((n, 3), np.float32)
    labels = (users * items).sum(axis=1)
    dataset = [{"user": users[i].tolist(), "item": items[i].tolist(),
                "label": float(labels[i])} for i in range(n)]
    b = backend.LocalBackend(2)
    try:
        export_dir = str(tmp_path / "tt_export")
        est = pipeline.TFEstimator(
            _two_tower_train_fn, {"lr": 0.05}, b, device="cpu",
            cluster_size=2, batch_size=64, epochs=8,
            export_dir=export_dir, grace_secs=2,
            input_mapping={"item": "item", "label": "label", "user": "user"})
        model = est.fit(dataset)
        assert os.path.exists(os.path.join(export_dir, "export.json"))

        model.set("input_mapping", {"item": "item", "user": "user"})
        model.set("output_mapping",
                  {"score": "score", "user_embedding": "emb"})
        test_rows = [{"user": users[i].tolist(), "item": items[i].tolist()}
                     for i in range(5)]
        outs = model.transform(test_rows)
    finally:
        b.stop()
    assert len(outs) == 5
    for score, emb in outs:
        assert isinstance(score, float)
        assert isinstance(emb, list) and len(emb) == 4
    # ground truth: the exported params applied directly
    state, desc = checkpoint.load_model(export_dir)
    ref_model = get_model(desc["model_name"], state_dict=state,
                          **desc["model_config"])
    ref_model.load_state_dict(state)
    with torch.no_grad():
        ref = ref_model(user=torch.from_numpy(users[:5]),
                        item=torch.from_numpy(items[:5]))
    for i, (score, emb) in enumerate(outs):
        assert abs(score - float(ref["score"][i])) < 1e-5
        np.testing.assert_allclose(emb, ref["user_embedding"][i].numpy(),
                                   rtol=1e-5)


def _pretend_cuda_is_up(iterator):
    """Runs on an executor: from here on its process reports CUDA as
    initialized, as after a transform on the card."""
    torch.cuda.is_initialized = lambda: True
    return [os.getpid() for _ in iterator]


def test_fit_after_cuda_transform_fails_loudly(tmp_path):
    """Transform-then-fit on the same executor: the node refuses to fork,
    and ``fit`` raises with the reason instead of hanging."""
    import time

    b = backend.LocalBackend(1)
    try:
        b.map_partitions([[0]], _pretend_cuda_is_up)
        est = pipeline.TFEstimator(
            _linear_train_fn, {"lr": 0.25}, b, device="cpu",
            cluster_size=1, batch_size=8, epochs=1, grace_secs=1,
            export_dir=str(tmp_path / "export"),
            input_mapping={"features": "x", "label": "y"})
        t0 = time.monotonic()
        with pytest.raises(Exception, match="initialized CUDA"):
            est.fit(_make_dataset(16))
        assert time.monotonic() - t0 < 60
    finally:
        b.stop()
