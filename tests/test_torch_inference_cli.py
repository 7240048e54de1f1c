"""The port's inference CLI against the JAX package's: the batch TFRecord
mode (``tests/test_schema.py``'s two CLI cases re-pointed: the same
TFRecords and a converted ``linear`` / ``two_tower`` export give the same
JSON lines, values to 1e-6, keys and their order exact), the ``--serve``
replica as a subprocess, and the options that wait for other items."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import dfutil as jax_dfutil
from tensorflowonspark_tpu import inference_cli as jax_cli
from tensorflowonspark_tpu.models import get_model as jax_get_model
from tensorflowonspark_torch import checkpoint, convert, inference_cli
from tensorflowonspark_torch.gateway import GatewayChannel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _convert(jax_dir, torch_dir, to_torch):
    loaded, desc = jax_checkpoint.load_model(jax_dir)
    checkpoint.export_model(torch_dir, to_torch(
        jax.tree_util.tree_map(np.asarray, loaded)), desc["model_name"],
        model_config=desc["model_config"],
        input_signature=desc["input_signature"])


class _StandInCompiler(object):
    """AOTInductor's stand-in for plumbing tests (the suite's real
    compiles are in ``tests/test_torch_compilecache_aoti.py``): a rung's
    package is a marker, its program the server's own functional forward,
    which takes the params as inputs as a package does."""

    def __init__(self, monkeypatch):
        from tensorflowonspark_torch import compilecache

        self.fns = []
        self.cc = compilecache
        monkeypatch.setattr(compilecache, "aoti_compile", self.compile)
        monkeypatch.setattr(compilecache, "_load_package", self.load)
        for var in (compilecache.CACHE_DIR_ENV, "TORCHINDUCTOR_CACHE_DIR",
                    "TRITON_CACHE_DIR"):
            if var in os.environ:
                monkeypatch.setenv(var, os.environ[var])
            else:
                monkeypatch.delenv(var, raising=False)
        monkeypatch.setattr(compilecache, "_configured_dir", None)
        monkeypatch.setattr(compilecache, "_env_set", {})

    def compile(self, fn, *args):
        self.fns.append(fn)
        return self.cc.AOTIProgram(b"stand-in package", fn)

    def load(self, data, device):
        assert data == b"stand-in package" and device == "cpu"
        return self.fns[-1]


def _assert_same_lines(got_path, want_path, n):
    got = [json.loads(line) for line in open(got_path)]
    want = [json.loads(line) for line in open(want_path)]
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert list(g) == list(w)              # keys and their order
        for key in w:
            np.testing.assert_allclose(np.asarray(g[key], np.float64),
                                       np.asarray(w[key], np.float64),
                                       rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def linear_exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("lin")
    params = {"dense": {"kernel": np.asarray([[2.0], [3.0]], np.float32),
                        "bias": np.zeros((1,), np.float32)}}
    jax_dir, torch_dir = str(root / "jax"), str(root / "torch")
    jax_checkpoint.export_model(jax_dir, params, "linear",
                                model_config={"features": 1},
                                input_signature={"x": [None, 2]})
    _convert(jax_dir, torch_dir, convert.linear_params_from_flax)
    return jax_dir, torch_dir


def test_inference_cli_end_to_end(linear_exports, tmp_path):
    """TFRecords + linear export -> the port's CLI (a subprocess, as a user
    runs it) -> the JAX CLI's JSON lines."""
    jax_dir, torch_dir = linear_exports
    rows = [{"x": [1.0, 1.0]}, {"x": [2.0, 0.5]}, {"x": [0.0, 0.0]}]
    data_dir = str(tmp_path / "tfr")
    jax_dfutil.save_as_tfrecords(rows, data_dir,
                                 schema={"x": "array<float32>"})
    flags = ["--input", data_dir, "--schema_hint", "struct<x:array<float>>",
             "--input_mapping", json.dumps({"x": "x"}),
             "--output_mapping", json.dumps({"y": "score"}),
             "--batch_size", "2"]
    want_path, got_path = str(tmp_path / "jax.jsonl"), \
        str(tmp_path / "port.jsonl")
    jax_cli.main(["--export_dir", jax_dir, "--output", want_path] + flags)
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_torch.inference_cli",
         "--export_dir", torch_dir, "--output", got_path,
         "--device", "cpu"] + flags,
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    _assert_same_lines(got_path, want_path, 3)
    preds = [json.loads(line) for line in open(got_path)]
    for row, expect in zip(preds, [5.0, 5.5, 0.0]):
        assert abs(row["score"][0] - expect) < 1e-4
        assert "x" in row


def test_inference_cli_multi_input_output(tmp_path):
    model = jax_get_model("two_tower", embed_dim=4)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), user=jnp.zeros((1, 3)),
        item=jnp.zeros((1, 3)))["params"])
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_checkpoint.export_model(
        jax_dir, params, "two_tower", model_config={"embed_dim": 4},
        input_signature={"user": {"shape": [None, 3], "dtype": "float32"},
                         "item": {"shape": [None, 3], "dtype": "float32"}})
    _convert(jax_dir, torch_dir, convert.two_tower_params_from_flax)
    rng = np.random.default_rng(7)
    rows = [{"u": rng.random(3).astype(np.float32).tolist(),
             "i": rng.random(3).astype(np.float32).tolist()}
            for _ in range(5)]
    data_dir = str(tmp_path / "tfr")
    jax_dfutil.save_as_tfrecords(
        rows, data_dir, schema={"u": "array<float32>", "i": "array<float32>"})
    flags = ["--input", data_dir,
             "--schema_hint", "struct<u:array<float>,i:array<float>>",
             "--input_mapping", json.dumps({"u": "user", "i": "item"}),
             "--output_mapping", json.dumps({"score": "score",
                                             "user_embedding": "emb"}),
             "--batch_size", "3"]
    want_path, got_path = str(tmp_path / "jax.jsonl"), \
        str(tmp_path / "port.jsonl")
    jax_cli.main(["--export_dir", jax_dir, "--output", want_path] + flags)
    inference_cli.main(["--export_dir", torch_dir, "--output", got_path,
                        "--device", "cpu"] + flags)
    _assert_same_lines(got_path, want_path, 5)


def test_serve_subprocess_answers_and_exits_on_sigterm(linear_exports):
    _, torch_dir = linear_exports
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_torch.inference_cli",
         "--export_dir", torch_dir, "--serve", "--device", "cpu",
         "--max-batch", "4", "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "ready on" in line, (line, proc.stderr.read()
                                    if proc.poll() is not None else "")
        addr = line.split("ready on ")[1].split()[0]
        assert "(buckets [1, 2, 4])" in line
        ch = GatewayChannel(addr, timeout=30)
        try:
            out = ch.predict({"x": np.asarray([[1.0, 1.0], [2.0, 0.0]],
                                              np.float32)}, 2)
        finally:
            ch.close()
        np.testing.assert_allclose(out["output"][:, 0], [5.0, 4.0],
                                   rtol=0, atol=TOL)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("flags,item", [
    (["--registry", "{registry}", "--model", "lin"], "item H"),
    (["--warm-cache-dir", "{warm}"], "item H"),
    (["--pjrt_plugin", "/p.so", "--input", "/in"], "item L"),
])
def test_unported_options_raise(linear_exports, flags, item, tmp_path,
                                monkeypatch):
    """``--pjrt_plugin`` names the item that ports it.  ``--warm-cache-dir``
    and a registry entry's ``warm_dir`` (item H) are ported: the replica's
    compile root and warm store are that directory, its first start
    compiles the rung and a restart loads it, answering as before (the
    real AOTInductor replicas: ``tests/test_torch_compilecache_aoti.py``)."""
    from tensorflowonspark_torch import compilecache, fleet

    _, torch_dir = linear_exports
    warm = str(tmp_path / "warm")
    registry = fleet.ModelRegistry(tmp_path / "registry")
    registry.publish("lin", "1", torch_dir, status="live", warm_dir=warm)
    registry.close()
    flags = [f.format(registry=registry.root, warm=warm) for f in flags]
    if item == "item L":
        with pytest.raises(NotImplementedError, match=item):
            inference_cli.main(["--export_dir", torch_dir, "--device",
                                "cpu"] + flags)
        return
    _StandInCompiler(monkeypatch)
    x = {"x": np.asarray([[1.0, 1.0]], np.float32)}
    verdicts, outs = [], []
    for _ in range(2):
        args = inference_cli.build_parser().parse_args(
            ["--export_dir", torch_dir, "--device", "cpu", "--serve",
             "--max-batch", "1"] + flags)
        server, version = inference_cli.open_replica(args)
        assert compilecache.configured_dir() == warm
        assert server._aot.directory == warm
        server.warmup()
        verdicts.append([(b["bucket"], b["verdict"])
                         for b in server.warmup_report["buckets"]])
        outs.append(server.predict_feed(x, 1)["output"])
    assert verdicts == [[(1, "compiled")], [(1, "loaded")]]
    assert server.compile_count == 0
    assert version == ("1" if "--registry" in flags else None)
    np.testing.assert_allclose(outs[1][:, 0], [5.0], rtol=0, atol=TOL)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_default_device_is_the_card(linear_exports, tmp_path, monkeypatch):
    """Without ``--device cpu`` the CLI serves on the card, and raises
    where there is none."""
    _, torch_dir = linear_exports
    data_dir = str(tmp_path / "tfr")
    jax_dfutil.save_as_tfrecords([{"x": [1.0, 1.0]}], data_dir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference_cli.main(["--export_dir", torch_dir, "--input", data_dir,
                            "--output", str(tmp_path / "o.jsonl")])
    with pytest.raises(SystemExit):
        inference_cli.main(["--input", data_dir])   # no --export_dir
