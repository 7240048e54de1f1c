"""The port's embedded package and its C++ runner against the JAX package:
``export_model(..., embed_batch_size=)`` records the io meta of JAX's
``serialize_embedded`` (``tests/test_serving.py``'s embedded test
re-pointed), ``run_inference_native`` pads and zips as JAX's does (its
stubbed-runner test re-pointed), and the runner (``csrc/aoti_runner.cpp``)
and the operator library (``csrc/flash_ops.cpp``), built here with the
host's ``g++`` against torch, serve a ``two_tower`` and a 2-layer fp32
flash LM package on the CPU as the JAX server does.  Also: the C++ op's
schema is the Python op's, the runner fails loudly without its library or
its card, and ``--pjrt_plugin`` is refused by name."""

import json
import os
import re
import subprocess
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu.models import get_model as jax_get_model
from tensorflowonspark_torch import (checkpoint, convert, dfutil,
                                     inference_cli, serving)
from tensorflowonspark_torch.models import get_model
from tensorflowonspark_torch.ops import _build
from tensorflowonspark_torch.ops import flash_attention  # noqa: F401

LM_CFG = {"vocab_size": 64, "num_layers": 2, "num_heads": 2, "head_dim": 16,
          "max_seq_len": 32, "attention": "flash", "dtype": "float32"}
LM_SIG = {"tokens": {"shape": [None, 32], "dtype": "int32"}}
TT_SIG = {"user": {"shape": [None, 3], "dtype": "float32"},
          "item": {"shape": [None, 3], "dtype": "float32"}}
# fp32 on both sides; the products sum in other orders (XLA against
# Inductor's C++ kernels): 1e-5 of the largest output
TOL = 1e-5
BATCH = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _descriptor(export_dir):
    with open(os.path.join(export_dir, "export.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def quick_packages():
    """This module's package compiles skip the probe of the host's vector
    ISA (each probe builds and loads a test library) and build their C++
    wrappers at -O0: the packages here are held for their values, not
    their speed."""
    from torch._inductor import config

    with config.patch({"cpp.vec_isa_ok": False,
                       "aot_inductor.compile_wrapper_opt_level": "O0"}):
        yield


@pytest.fixture(scope="module")
def built():
    """The runner and the operator library, built on a thread while the
    packages compile (``build_native``: one ``g++`` each, at once)."""
    result = {}

    def run():
        try:
            result["built"] = _build.build_native()
        except Exception as e:  # re-raised by the tests that need it
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def get():
        thread.join()
        if "error" in result:
            raise result["error"]
        return result["built"]
    return get


def _exports(root, name, flax_model, params, config, signature, to_torch):
    """The JAX export with its embedded module (``platform="cpu"``) and
    the port's with its embedded package, on the same params."""
    jax_dir, torch_dir = str(root / (name + "_jax")), \
        str(root / (name + "_torch"))
    jax_checkpoint.export_model(jax_dir, params, name, model_config=config,
                                input_signature=signature, model=flax_model,
                                embed_batch_size=BATCH, embed_platform="cpu")
    loaded, desc = jax_checkpoint.load_model(jax_dir)
    state = to_torch(_np(loaded))
    model = get_model(name, state_dict=state, **config)
    model.load_state_dict(state)
    checkpoint.export_model(torch_dir, state, name, model_config=config,
                            input_signature=signature, model=model,
                            embed_batch_size=BATCH, embed_platform="cpu")
    return jax_dir, torch_dir


@pytest.fixture(scope="module")
def tower(built, tmp_path_factory):
    flax_model = jax_get_model("two_tower", embed_dim=4)
    params = _np(flax_model.init(jax.random.PRNGKey(0),
                                 user=jnp.zeros((1, 3)),
                                 item=jnp.zeros((1, 3)))["params"])
    return _exports(tmp_path_factory.mktemp("tt"), "two_tower", flax_model,
                    params, {"embed_dim": 4}, TT_SIG,
                    convert.two_tower_params_from_flax)


@pytest.fixture(scope="module")
def lm(built, tmp_path_factory):
    flax_model = jax_get_model("transformer_lm", **LM_CFG)
    params = _np(flax_model.init(jax.random.PRNGKey(1),
                                 jnp.zeros((1, 32), jnp.int32))["params"])
    return _exports(tmp_path_factory.mktemp("lm"), "transformer_lm",
                    flax_model, params, LM_CFG, LM_SIG,
                    convert.transformer_params_from_flax)


def test_io_meta_matches_jax(tower, lm):
    """``embedded_pt2`` has the form and content of JAX's
    ``embedded_mlir``, apart from the file keys and the platform: sorted
    input names, short dtypes, the fixed batch in every shape."""
    for jax_dir, torch_dir in (tower, lm):
        got = dict(_descriptor(torch_dir)["embedded_pt2"])
        want = dict(_descriptor(jax_dir)["embedded_mlir"])
        assert got.pop("file") == "apply_embedded.pt2"
        assert os.path.exists(os.path.join(torch_dir, "apply_embedded.pt2"))
        want.pop("file"), want.pop("options_file")
        assert got.pop("platform") == want.pop("platform") == "cpu"
        assert got == want
    meta = _descriptor(tower[1])["embedded_pt2"]
    assert [i["name"] for i in meta["inputs"]] == ["item", "user"]
    assert [o["name"] for o in meta["outputs"]] == ["score",
                                                   "user_embedding"]
    assert _descriptor(lm[1])["embedded_pt2"]["inputs"] == [
        {"name": "tokens", "dtype": "s32", "shape": [BATCH, 32]}]


def test_cli_native_path_batches_and_zips(tower, monkeypatch):
    """``run_inference_native`` pads each batch to the package's fixed size,
    feeds by input_mapping, and zips the outputs 1:1 onto rows, all
    batches in one runner call (the runner stubbed with the JAX apply)."""
    jax_dir, torch_dir = tower
    params, _ = jax_checkpoint.load_model(jax_dir)
    flax_model = jax_get_model("two_tower", embed_dim=4)
    calls = []

    def fake_runner_many(export_dir, feeds, device=None, **kw):
        calls.append([{k: v.shape for k, v in feed.items()}
                      for feed in feeds])
        assert device == "cpu"
        return [{k: np.asarray(v) for k, v in flax_model.apply(
            {"params": params}, user=feed["user"],
            item=feed["item"]).items()} for feed in feeds]

    monkeypatch.setattr(serving, "run_embedded_native_many",
                        fake_runner_many)
    rng = np.random.default_rng(9)
    rows = [{"u": rng.random(3).astype(np.float32).tolist(),
             "i": rng.random(3).astype(np.float32).tolist()}
            for _ in range(6)]   # 4 + 2: the second batch padded
    outs = list(inference_cli.run_inference_native(
        torch_dir, rows, device="cpu",
        input_mapping={"u": "user", "i": "item"},
        output_mapping={"score": "score", "user_embedding": "emb"}))
    assert len(outs) == 6 and len(calls) == 1
    assert [s for feed in calls[0] for s in feed.values()] == [(4, 3)] * 4
    ref = flax_model.apply({"params": params},
                           user=np.asarray([r["u"] for r in rows], np.float32),
                           item=np.asarray([r["i"] for r in rows], np.float32))
    for k, out in enumerate(outs):
        assert abs(out["score"] - float(ref["score"][k])) < 1e-5
        np.testing.assert_allclose(out["emb"],
                                   np.asarray(ref["user_embedding"][k]),
                                   rtol=1e-5)
        assert out["u"] == rows[k]["u"]


def _assert_close(got, want):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_runner_serves_two_tower_as_jax(built, tower):
    """Two batches through one runner process: the JAX server's outputs
    within 1e-5; no flash op in this model."""
    jax_dir, torch_dir = tower
    rng = np.random.default_rng(3)
    feeds = [{"user": rng.random((BATCH, 3), np.float32),
              "item": rng.random((BATCH, 3), np.float32)} for _ in range(2)]
    paths = built()
    report = {}
    outs = serving.run_embedded_native_many(
        torch_dir, feeds, device="cpu",
        runner_path=paths["aoti_runner"]["path"],
        ops_lib=paths["flash_ops"]["path"], report=report)
    jax_server = jax_serving.ModelServer(jax_dir, batch_size=BATCH)
    for feed, out in zip(feeds, outs):
        want = jax_server.predict_feed(feed, BATCH)
        assert sorted(out) == sorted(want) == ["score", "user_embedding"]
        for key in want:
            _assert_close(out[key], want[key])
    assert report["batches"] == 2 and report["device"] == "cpu"
    assert report["flash_fwd_calls"] == report["flash_fwd_launches"] == 0


def test_runner_serves_flash_lm_as_jax(built, lm):
    """The 2-layer fp32 flash LM: the package calls ``tfos::flash_fwd``
    through the C++ registration once a layer and batch (its plain version
    here, so no kernel launches), and the logits are the JAX server's
    within 1e-5, the single-batch path (``out.<i>.bin``) included."""
    jax_dir, torch_dir = lm
    rng = np.random.default_rng(4)
    feeds = [{"tokens": rng.integers(0, 64, (BATCH, 32), dtype=np.int32)}
             for _ in range(3)]
    report = {}
    outs = serving.run_embedded_native_many(torch_dir, feeds, device="cpu",
                                            report=report)
    one = serving.run_embedded_native(torch_dir, feeds[0], device="cpu")
    jax_server = jax_serving.ModelServer(jax_dir, batch_size=BATCH)
    for feed, out in zip(feeds, outs):
        _assert_close(out["output"],
                      jax_server.predict_feed(feed, BATCH)["output"])
    np.testing.assert_array_equal(one["output"], outs[0]["output"])
    assert report["flash_fwd_calls"] == LM_CFG["num_layers"] * len(feeds)
    assert report["flash_fwd_launches"] == 0
    assert report["load_s"] >= 0 and report["run_s"] > 0


def test_inference_cli_native_end_to_end(built, lm, tmp_path):
    """``inference_cli --native --device cpu`` over TFRecord rows: the
    runner's logits, row for row, as the artifact-free eager server's."""
    _, torch_dir = lm
    built()
    rng = np.random.default_rng(6)
    rows = [{"tokens": rng.integers(0, 64, 32).tolist()} for _ in range(5)]
    data_dir = str(tmp_path / "tfr")
    dfutil.save_as_tfrecords(rows, data_dir,
                             schema={"tokens": "array<int64>"})
    out_path = str(tmp_path / "preds.jsonl")
    inference_cli.main(["--export_dir", torch_dir, "--input", data_dir,
                        "--schema_hint", "struct<tokens:array<bigint>>",
                        "--native", "--device", "cpu", "--output", out_path])
    lines = [json.loads(line) for line in open(out_path)]
    assert len(lines) == 5
    state, desc = checkpoint.load_model(torch_dir)
    model = get_model("transformer_lm", state_dict=state, **LM_CFG)
    model.load_state_dict(state)
    with torch.no_grad():
        want = model(torch.tensor([r["tokens"] for r in rows],
                                  dtype=torch.int32)).numpy()
    for line, row, w in zip(lines, rows, want):
        assert line["tokens"] == row["tokens"]
        _assert_close(np.asarray(line["output"], np.float32), w)


def test_runner_fails_loudly(built, lm, tmp_path):
    """No fallback: a missing operator library, ``--device cuda`` without a
    card, and a CPU package asked to run on the card each end the runner
    with exit code 1 and a message; ``run_embedded_native_many`` raises
    with the runner's tail."""
    _, torch_dir = lm
    paths = built()
    runner, ops = paths["aoti_runner"]["path"], paths["flash_ops"]["path"]
    package = os.path.join(torch_dir, "apply_embedded.pt2")
    tokens = str(tmp_path / "tokens.bin")
    np.zeros((BATCH, 32), np.int32).tofile(tokens)
    base = [runner, "--package", package, "--input",
            "s32:{},32:{}".format(BATCH, tokens), "--out",
            str(tmp_path / "out")]
    cases = [
        (["--device", "cpu", "--ops_lib", str(tmp_path / "missing.so")],
         "dlopen of --ops_lib failed"),
        (["--device", "cpu"], "--package and --ops_lib are required"),
        (["--device", "cuda", "--ops_lib", ops],
         "no CUDA card" if not torch.cuda.is_available()
         else "built for 'cpu'"),
    ]
    for flags, message in cases:
        proc = subprocess.run(base + flags, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 1, (flags, proc.stdout, proc.stderr)
        assert message in proc.stderr, (flags, proc.stderr)
    with pytest.raises(RuntimeError, match="aoti_runner failed"):
        serving.run_embedded_native_many(
            torch_dir, [{"tokens": np.zeros((BATCH, 32), np.int32)}],
            device="cpu", runner_path=runner,
            ops_lib=str(tmp_path / "missing.so"))
    with pytest.raises(ValueError, match="package wants"):
        serving.run_embedded_native_many(
            torch_dir, [{"tokens": np.zeros((BATCH + 1, 32), np.int32)}],
            device="cpu", runner_path=runner, ops_lib=ops)


def test_cpp_schema_is_the_python_ops():
    """``csrc/flash_ops.cpp`` declares ``tfos::flash_fwd`` letter for letter
    as the Python op: a package's extern node reaches it by this schema."""
    with open(_build.CSRC / "flash_ops.cpp") as f:
        source = f.read()
    (declared,) = re.findall(r'm\.def\("([^"]+)"\)', source)
    python = str(torch.ops.tfos.flash_fwd.default._schema)
    assert "tfos::" + declared == python
    assert "TORCH_LIBRARY_IMPL(tfos, CUDA" in source   # the card's kernel
    assert "flash_bwd" not in declared


def test_pjrt_plugin_refused_by_name(tower):
    _, torch_dir = tower
    with pytest.raises(NotImplementedError, match="--native"):
        inference_cli.main(["--export_dir", torch_dir, "--input", "/in",
                            "--pjrt_plugin", "/p.so", "--device", "cpu"])


def test_native_needs_the_embedded_package(tmp_path):
    model = get_model("linear", in_features=2)
    export_dir = str(tmp_path / "plain")
    checkpoint.export_model(export_dir, model, "linear",
                            model_config={"features": 1},
                            input_signature={"x": [None, 2]})
    with pytest.raises(ValueError, match="embed_batch_size"):
        list(inference_cli.run_inference_native(export_dir, [{"x": [1, 2]}],
                                                device="cpu"))
    with pytest.raises(ValueError, match="embed_batch_size"):
        serving.run_embedded_native_many(export_dir, [], device="cpu")
