"""The port's serving path against the JAX package's: a registry-served JAX
export of the transformer LM, converted, gives the same predictions through
the port's ``run_inference``.  Also the port's rules: no import of jax or
of the JAX package, and no silent fall back to the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import inference_cli as jax_inference_cli
from tensorflowonspark_tpu import pipeline as jax_pipeline
from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu.models import get_model as jax_get_model
from tensorflowonspark_torch import (checkpoint, convert, device, inference_cli,
                                     metrics, pipeline, serving)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"vocab_size": 64, "num_layers": 2, "num_heads": 2, "head_dim": 16,
       "max_seq_len": 32, "attention": "flash", "dtype": "float32"}
SEQ = 32
SIGNATURE = {"tokens": {"shape": [None, SEQ], "dtype": "int32"}}
# fp32 on both sides; matmul summation order differs: 1e-4 of the range
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """A registry-served JAX export (no ``model=``) and the port's export
    converted from it."""
    root = tmp_path_factory.mktemp("exports")
    model = jax_get_model("transformer_lm", **CFG)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, SEQ), jnp.int32))["params"]
    jax_dir, torch_dir = str(root / "jax"), str(root / "torch")
    jax_checkpoint.export_model(jax_dir, jax.device_get(params),
                                "transformer_lm", model_config=CFG,
                                input_signature=SIGNATURE)
    loaded, desc = jax_checkpoint.load_model(jax_dir)
    state = convert.transformer_params_from_flax(
        jax.tree_util.tree_map(np.asarray, loaded))
    checkpoint.export_model(torch_dir, state, desc["model_name"],
                            model_config=desc["model_config"],
                            input_signature=desc["input_signature"])
    return jax_dir, torch_dir


def _rows(n=5):
    rng = np.random.default_rng(2)
    return [{"id": i, "tokens": rng.integers(0, CFG["vocab_size"],
                                             SEQ).tolist()}
            for i in range(n)]


def test_run_inference_matches_jax(exports):
    jax_dir, torch_dir = exports
    rows = _rows()   # 5 rows at batch_size 4: a full rung and a padded one
    want = list(jax_inference_cli.run_inference(jax_dir, rows, batch_size=4))
    got = list(inference_cli.run_inference(torch_dir, rows, batch_size=4,
                                           device="cpu"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["id"] == w["id"] and g["tokens"] == w["tokens"]
        wp, gp = np.asarray(w["prediction"]), np.asarray(g["prediction"])
        assert gp.shape == wp.shape == (SEQ, CFG["vocab_size"])
        assert np.abs(gp - wp).max() <= LOGIT_TOL * np.abs(wp).max()


def test_model_server_rungs_match_jax(exports):
    jax_dir, torch_dir = exports
    rows = _rows()
    jax_server = jax_serving.ModelServer(jax_dir, batch_size=4)
    server = serving.ModelServer(torch_dir, batch_size=4, device="cpu")
    assert server.buckets == jax_server.buckets == (1, 2, 4)
    list(jax_server.run_rows_dict(iter(rows)))
    list(server.run_rows_dict(iter(rows)))
    assert server.compile_count == jax_server.compile_count == 2
    assert server.warmup() == 3
    feed = server.zero_feed(2)
    assert feed["tokens"].shape == (2, SEQ) and feed["tokens"].dtype == np.int32


def test_output_name_renames_prediction(exports):
    _, torch_dir = exports
    (row,) = inference_cli.run_inference(torch_dir, _rows(1),
                                         output_name="logits", device="cpu")
    assert "logits" in row and "prediction" not in row


def test_bucket_ladder_and_bucket_for_match_jax():
    for n in range(1, 301):
        ladder = serving.bucket_ladder(n)
        assert ladder == jax_serving.bucket_ladder(n)
        for count in range(1, 302):
            assert serving.bucket_for(count, ladder) == \
                jax_serving.bucket_for(count, ladder)
    with pytest.raises(ValueError):
        serving.bucket_ladder(0)


def test_feed_and_output_helpers_match_jax():
    sigs = [{"x": [None, 3]}, {"x": {"shape": [None, 2], "dtype": "int32"}},
            {"a": {"shape": [None]}, "b": [None, 4]}, None]
    for sig in sigs:
        assert serving._normalize_signature(sig) == \
            jax_serving._normalize_signature(sig)
    arr = np.arange(6.0).reshape(2, 3)
    for out in (arr, (arr, arr), {"score": arr, "emb": arr}):
        got, want = serving._name_outputs(out), jax_serving._name_outputs(out)
        assert sorted(got) == sorted(want)
        for mapping in (None, {"score": "s"}):
            try:
                expect = jax_serving.output_columns(mapping, want)
            except ValueError:
                with pytest.raises(ValueError):
                    serving.output_columns(mapping, got)
                continue
            assert serving.output_columns(mapping, got) == expect
    for x in (np.float32(2.5), np.arange(3), np.ones((2, 2))):
        assert serving._pyval(x) == jax_serving._pyval(x)
    for n, size in ((0, 4), (5, 4), (8, 4), (3, 10)):
        assert list(pipeline.yield_batch(iter(range(n)), size)) == \
            list(jax_pipeline.yield_batch(iter(range(n)), size))


def test_load_model_validate_refuses_nan(tmp_path):
    state = {"w": torch.ones(3), "b": torch.tensor([0.0, float("nan")])}
    checkpoint.export_model(str(tmp_path), state, "transformer_lm")
    with pytest.raises(ValueError, match="nonfinite"):
        checkpoint.load_model(str(tmp_path), validate=True)
    loaded, desc = checkpoint.load_model("file://" + str(tmp_path))
    assert desc == {"model_name": "transformer_lm", "model_config": {},
                    "input_signature": {}}
    assert torch.equal(loaded["w"], state["w"])


def test_default_device_raises_without_cuda(exports, monkeypatch):
    """No card and no ``device="cpu"``: entry points raise, never run on
    the CPU."""
    _, torch_dir = exports
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ModelServer(torch_dir, batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(inference_cli.run_inference(torch_dir, _rows(1)))
    with pytest.raises(RuntimeError):
        device.resolve_device("cuda:0")
    assert device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve_device("meta")


def test_roofline_at_the_serving_shape():
    """The H100 SXM bound of the flash forward at [4, 1024, 16, 64] bf16,
    causal: 8.6 GFLOP and 33.8 MB, bound by bytes at about 10 us."""
    b, s, h, d = 4, 1024, 16, 64
    flops = 4 * d * (s * (s + 1) // 2) * b * h
    nbytes = 4 * b * s * h * d * 2 + b * h * s * 4
    name = "NVIDIA H100 80GB HBM3"
    seconds = metrics.roofline_seconds(flops, nbytes, name)
    assert seconds == pytest.approx(nbytes / 3.35e12)
    assert 9e-6 < seconds < 11e-6
    assert metrics.roofline_bound_by(flops, nbytes, name) == "bytes"
    assert metrics.roofline_bound_by(flops, nbytes, name,
                                     "float32") == "operations"
    with pytest.raises(KeyError):
        metrics.roofline_seconds(flops, nbytes, "TPU v5 lite")


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
              "tensorflowonspark_tpu")

# the port's example, imported as a module like the port's own
_EXAMPLE = os.path.join("examples", "mnist", "mnist_spark_torch.py")

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import tensorflowonspark_torch as pkg
names = [info.name for info in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
spec = importlib.util.spec_from_file_location("mnist_spark_torch", {example!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules if n.split(".")[0] in {forbidden!r})
missing = sorted(set(pkg.__name__ + "." + m for m in (
    "summary", "tfrecord", "example_proto")) - set(names))
from tensorflowonspark_torch import checkpoint, train
missing += [n for n in ("fit_supervised", "MAX_ROLLBACKS")
            if not hasattr(train, n)]
missing += [n for n in ("evaluate", "apply_knob")
            if not hasattr(train.Trainer, n)]
missing += [n for n in ("restore_latest_valid", "_quarantine")
            if not hasattr(checkpoint.CheckpointManager, n)]
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 25 else 0)
"""


def test_port_imports_no_jax():
    """A fresh interpreter that imports every port module (the copied
    cluster layer among them), chip_smoke.py and the port's MNIST example
    has no jax, flax, optax, orbax or JAX-package module."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=_FORBIDDEN,
                                                  example=_EXAMPLE)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax():
    """No line of the port, of chip_smoke.py or of the port's MNIST example
    imports a forbidden package, not even inside a function."""
    pattern = re.compile(r"^\s*(import|from)\s+({})\b".format(
        "|".join(_FORBIDDEN)))
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, _EXAMPLE)]
    for root, _, files in os.walk(os.path.join(REPO,
                                               "tensorflowonspark_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            offenders += ["{}:{}".format(path, i) for i, line in enumerate(f, 1)
                          if pattern.match(line)]
    assert len(paths) > 10 and not offenders, offenders
