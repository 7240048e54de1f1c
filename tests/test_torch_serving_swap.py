"""The rest of the port's ``ModelServer`` against the JAX package's: the
``serving/compile`` trace instant on each cold rung, ``warmup_report``,
``model_version``, the live weight swap with its refusal matrix
(``tests/test_fleet.py::TestSwap`` re-pointed), and the same JAX export,
converted, served by both for ``linear`` and for the multi-input,
multi-output ``two_tower`` (fp32: 1e-6)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu import telemetry as jax_telemetry
from tensorflowonspark_tpu.models import get_model as jax_get_model
from tensorflowonspark_torch import (checkpoint, compilecache, convert,
                                     serving, telemetry)
from tensorflowonspark_torch.fleet import SwapRefused

TOL = 1e-6
LM_CFG = {"vocab_size": 64, "num_layers": 2, "num_heads": 2, "head_dim": 16,
          "max_seq_len": 32, "attention": "flash", "dtype": "float32"}
LM_SIG = {"tokens": {"shape": [None, 32], "dtype": "int32"}}
TT_SIG = {"user": {"shape": [None, 3], "dtype": "float32"},
          "item": {"shape": [None, 5], "dtype": "float32"}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _pair(root, name, params, config, signature, to_torch):
    """A registry-served JAX export and the port's export converted from
    it."""
    jax_dir, torch_dir = str(root / (name + "_jax")), \
        str(root / (name + "_torch"))
    jax_checkpoint.export_model(jax_dir, params, name, model_config=config,
                                input_signature=signature)
    loaded, desc = jax_checkpoint.load_model(jax_dir)
    checkpoint.export_model(torch_dir, to_torch(_np(loaded)),
                            desc["model_name"],
                            model_config=desc["model_config"],
                            input_signature=desc["input_signature"])
    return jax_dir, torch_dir


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    model = jax_get_model("transformer_lm", **LM_CFG)
    params = _np(model.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 32), jnp.int32))["params"])
    return _pair(tmp_path_factory.mktemp("lm"), "transformer_lm", params,
                 LM_CFG, LM_SIG, convert.transformer_params_from_flax)


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
    model = jax_get_model("two_tower", embed_dim=4)
    params = _np(model.init(jax.random.PRNGKey(1), user=jnp.zeros((1, 3)),
                            item=jnp.zeros((1, 5)))["params"])
    return _pair(tmp_path_factory.mktemp("tt"), "two_tower", params,
                 {"embed_dim": 4}, TT_SIG, convert.two_tower_params_from_flax)


def _linear_params(kernel, bias=0.0):
    return {"dense": {"kernel": np.asarray(kernel, np.float32),
                      "bias": np.full((1,), bias, np.float32)}}


def _export(path, kernel, name="linear", config=None, signature=None):
    """A port linear export y = k0*a + k1*b (tests/test_fleet.py's
    ``_export``, converted)."""
    path = str(path)
    checkpoint.export_model(
        path, convert.linear_params_from_flax(_linear_params(kernel)), name,
        model_config={"features": 1} if config is None else config,
        input_signature={"x": [None, 2]} if signature is None else signature)
    return path


def _compile_instants(tracer):
    return [(e["name"], e["args"]["bucket"], e["args"]["model"])
            for e in list(tracer._events)
            if e.get("ph") == "i" and e["name"] == "serving/compile"]


def test_compile_instants_match_jax(lm, tmp_path):
    """One ``serving/compile`` instant per cold rung (fields ``bucket`` and
    ``model``), none on a warm one: after ``warmup()``, a request above the
    top rung is a new rung, and the same request again is warm."""
    jax_dir, torch_dir = lm
    rng = np.random.default_rng(0)
    traffic = [3, 5, 5, 1]
    instants = {}
    for side, tel, make in (
            ("jax", jax_telemetry,
             lambda: jax_serving.ModelServer(jax_dir, batch_size=4)),
            ("port", telemetry,
             lambda: serving.ModelServer(torch_dir, batch_size=4,
                                         device="cpu"))):
        server = make()
        tracer = tel.configure(True, str(tmp_path / side))
        try:
            server.warmup()
            for n in traffic:
                server.predict_feed({"tokens": rng.integers(
                    0, 64, (n, 32), dtype=np.int32)}, n)
            instants[side] = _compile_instants(tracer)
        finally:
            tel.configure(False)
    assert instants["port"] == instants["jax"] == [
        ("serving/compile", b, "transformer_lm") for b in (4, 2, 1, 5)]


def test_warmup_report_and_version_match_jax(lm):
    jax_dir, torch_dir = lm
    jax_server = jax_serving.ModelServer(jax_dir, batch_size=4)
    server = serving.ModelServer(torch_dir, batch_size=4, device="cpu")
    assert server.warmup_report is None
    assert server.warmup() == jax_server.warmup() == 3
    got, want = server.warmup_report, jax_server.warmup_report
    assert sorted(got) == sorted(want) == ["buckets", "compiled", "loaded"]
    assert (got["loaded"], got["compiled"]) == \
        (want["loaded"], want["compiled"]) == (0, 3)
    assert [(b["bucket"], b["verdict"]) for b in got["buckets"]] == \
        [(b["bucket"], b["verdict"]) for b in want["buckets"]]
    assert all(b["micros"] > 0 for b in got["buckets"])
    assert server.model_version == jax_server.model_version == "0"
    assert server.model_name == jax_server.model_name


def test_warm_cache_dir_is_not_ported(lm, tmp_path, monkeypatch):
    """``warm_cache_dir`` is ported (item H): every rung compiles into the
    store, a restart loads each with ``compile_count == 0`` (the JAX
    server's verdicts and counts), outputs stay the eager server's, and a
    live swap keeps the loaded rungs, whose params are inputs.  The rungs'
    programs here are the forward itself (the real AOTInductor packages:
    ``tests/test_torch_compilecache_aoti.py``)."""
    _StandInCompiler(monkeypatch)
    tokens = np.random.default_rng(2).integers(0, 64, (3, 32)).astype(
        np.int32)
    eager = serving.ModelServer(lm[1], batch_size=4, device="cpu")
    want = eager.predict_feed({"tokens": tokens}, 3)["output"]
    reports = []
    for _ in range(2):
        server = serving.ModelServer(lm[1], batch_size=4, device="cpu",
                                     warm_cache_dir=str(tmp_path / "warm"))
        server.warmup()
        reports.append((server.warmup_report["loaded"],
                        server.warmup_report["compiled"],
                        server.compile_count))
        np.testing.assert_array_equal(
            server.predict_feed({"tokens": tokens}, 3)["output"], want)
    assert reports == [(0, 3, 3), (3, 0, 0)]
    assert sorted(os.listdir(str(tmp_path / "warm"))) == [
        "serving_b1.aotx", "serving_b2.aotx", "serving_b4.aotx"]
    rungs = dict(server._warm_exec)
    server.swap_export(lm[1], expected_version="2")
    assert server._warm_exec == rungs and server.compile_count == 0
    np.testing.assert_array_equal(
        server.predict_feed({"tokens": tokens}, 3)["output"], want)


class _StandInCompiler(object):
    """AOTInductor's stand-in: a rung's package is a marker, its program
    the server's own functional forward, which takes the params as inputs
    as a package does."""

    def __init__(self, monkeypatch):
        self.fns = []
        monkeypatch.setattr(compilecache, "aoti_compile", self.compile)
        monkeypatch.setattr(compilecache, "_load_package", self.load)

    def compile(self, fn, *args):
        self.fns.append(fn)
        return compilecache.AOTIProgram(b"stand-in package", fn)

    def load(self, data, device):
        assert data == b"stand-in package" and device == "cpu"
        return self.fns[-1]


def test_linear_predict_feed_matches_jax(tmp_path):
    params = _linear_params([[2.0], [-3.0]], bias=0.5)
    jax_dir, torch_dir = _pair(tmp_path, "linear", params, {"features": 1},
                               {"x": [None, 2]},
                               convert.linear_params_from_flax)
    jax_server = jax_serving.ModelServer(jax_dir, batch_size=4)
    server = serving.ModelServer(torch_dir, batch_size=4, device="cpu")
    x = np.random.default_rng(5).standard_normal((3, 2)).astype(np.float32)
    got, want = server.predict_feed({"x": x}, 3), \
        jax_server.predict_feed({"x": x}, 3)
    assert sorted(got) == sorted(want) == ["output"]
    np.testing.assert_allclose(got["output"], np.asarray(want["output"]),
                               rtol=0, atol=TOL)


def test_two_tower_predict_feed_matches_jax(tower):
    jax_dir, torch_dir = tower
    jax_server = jax_serving.ModelServer(jax_dir, batch_size=4)
    server = serving.ModelServer(torch_dir, batch_size=4, device="cpu")
    rng = np.random.default_rng(6)
    for n in (1, 3, 4):
        feed = {"user": rng.random((n, 3), np.float32),
                "item": rng.random((n, 5), np.float32)}
        got, want = server.predict_feed(feed, n), \
            jax_server.predict_feed(feed, n)
        assert sorted(got) == sorted(want) == ["score", "user_embedding"]
        for name in got:
            assert got[name].shape == np.asarray(want[name]).shape
            np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                       rtol=0, atol=TOL)
    assert server.compile_count == jax_server.compile_count == 2
    rows = [{"u": rng.random(3).tolist(), "i": rng.random(5).tolist()}
            for _ in range(5)]
    mapping = {"u": "user", "i": "item"}
    out_map = {"score": "s", "user_embedding": "emb"}
    got = list(server.run_rows_dict(iter(rows), mapping, out_map))
    want = list(jax_server.run_rows_dict(iter(rows), mapping, out_map))
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        assert abs(g["s"] - w["s"]) <= TOL
        np.testing.assert_allclose(g["emb"], w["emb"], rtol=0, atol=TOL)


class TestSwap:
    def test_swap_is_zero_recompile(self, tmp_path):
        e1 = _export(tmp_path / "v1", [[2.0], [3.0]])
        e2 = _export(tmp_path / "v2", [[4.0], [5.0]])
        server = serving.ModelServer(e1, batch_size=4, device="cpu")
        server.warmup()
        compiles = server.compile_count
        weight = server.model.dense.weight
        feed = {"x": np.asarray([[1.0, 1.0]], np.float32)}
        assert abs(float(server.predict_feed(feed, 1)["output"][0][0])
                   - 5.0) < 1e-5
        assert server.swap_export(e2, expected_version="2") == "2"
        # new weights answer at once, copied into the same module
        assert abs(float(server.predict_feed(feed, 1)["output"][0][0])
                   - 9.0) < 1e-5
        assert server.model.dense.weight is weight
        assert server.compile_count == compiles
        assert server.swap_count == 1
        assert server.model_version == "2"

    def test_swap_refusal_matrix(self, tmp_path):
        server = serving.ModelServer(
            _export(tmp_path / "v1", [[2.0], [3.0]]), batch_size=4,
            device="cpu")
        # different model name
        other = _export(tmp_path / "other", [[1.0], [1.0]], name="notlin")
        with pytest.raises(SwapRefused, match="model"):
            server.swap_export(other)
        # different params shape (3 features would rebuild the model)
        wide = _export(tmp_path / "wide", np.ones((3, 1)))
        with pytest.raises(SwapRefused, match="shapes"):
            server.swap_export(wide)
        # nonfinite weights are quarantined at the swap boundary
        poison = _export(tmp_path / "poison", [[np.nan], [1.0]])
        with pytest.raises(ValueError):
            server.swap_export(poison)
        # a different model_config, input signature or param dtype
        with pytest.raises(SwapRefused, match="model_config"):
            server.swap_export(_export(tmp_path / "cfg", [[1.0], [1.0]],
                                       config={"features": 1, "k": 2}))
        with pytest.raises(SwapRefused, match="signature"):
            server.swap_export(_export(
                tmp_path / "sig", [[1.0], [1.0]],
                signature={"x": {"shape": [None, 2], "dtype": "float64"}}))
        half = str(tmp_path / "half")
        checkpoint.export_model(
            half, {"dense.weight": torch.ones(1, 2, dtype=torch.float16),
                   "dense.bias": torch.zeros(1, dtype=torch.float16)},
            "linear", model_config={"features": 1},
            input_signature={"x": [None, 2]})
        with pytest.raises(SwapRefused, match="dtypes"):
            server.swap_export(half)
        # nothing above mutated the live model
        assert server.swap_count == 0
        assert server.model_version == "0"
        feed = {"x": np.asarray([[1.0, 1.0]], np.float32)}
        assert abs(float(server.predict_feed(feed, 1)["output"][0][0])
                   - 5.0) < 1e-5
