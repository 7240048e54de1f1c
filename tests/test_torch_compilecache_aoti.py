"""The serving side of the port's warm-start compile plane: each ladder
rung an AOTInductor package, cold then warm, against the JAX package's warm
server (``tests/test_compilecache.py``'s ``TestServingAOT`` re-pointed).

The file's compiles, the only AOTInductor compiles of the suite, share one
Inductor cache: one ``linear`` rung and one 2-layer flash LM rung (about
20 s and 30 s on the CPU the first time).  Served from the same warm dir:
a restarted server (``compile_count == 0``), a weight swap, and two
``inference_cli --serve`` replicas, one through ``--warm-cache-dir`` and
one through a registry entry's ``warm_dir``.
"""

import importlib
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu.models import get_model as jax_get_model
from tensorflowonspark_torch import (checkpoint, compilecache, convert,
                                     fleet, reservation, serving)
from tensorflowonspark_torch.gateway import GatewayChannel
from tensorflowonspark_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=32,
              max_seq_len=32, attention="flash", dtype="float32")
# fp32; Inductor fuses the bias add and sums in another order than XLA
TOL = 1e-5
LINEAR = {"dense": {"kernel": np.asarray([[2.0], [-3.0]], np.float32),
                    "bias": np.asarray([0.5], np.float32)}}


@pytest.fixture(scope="module", autouse=True)
def _shared_inductor_cache(tmp_path_factory):
    """One Inductor cache for the file's compiles, the replicas' too."""
    names = ("TORCHINDUCTOR_CACHE_DIR", compilecache.CACHE_DIR_ENV)
    before = {name: os.environ.get(name) for name in names}
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(
        tmp_path_factory.mktemp("inductor"))
    os.environ.pop(compilecache.CACHE_DIR_ENV, None)
    yield
    for name, value in before.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


def _linear_export(root, name, params):
    jax_dir, torch_dir = str(root / ("jax-" + name)), str(root / name)
    jax_checkpoint.export_model(jax_dir, params, "linear",
                                model_config={"features": 1},
                                input_signature={"x": [None, 2]},
                                model=jax_get_model("linear"))
    checkpoint.export_model(torch_dir,
                            convert.linear_params_from_flax(params),
                            "linear", model_config={"features": 1},
                            input_signature={"x": [None, 2]})
    return jax_dir, torch_dir


@pytest.fixture(scope="module")
def linear_warm(tmp_path_factory):
    """The linear rung compiled once into a warm dir: ``(root, export,
    warm dir, the cold server's report, compile count and output)``."""
    root = tmp_path_factory.mktemp("linear")
    _, export = _linear_export(root, "v1", LINEAR)
    warm_dir = str(root / "warm")
    cold = serving.ModelServer(export, batch_size=1, device="cpu",
                               warm_cache_dir=warm_dir)
    assert cold.warmup() == 1
    out = cold.predict_feed({"x": _x()}, 1)["output"]
    return root, export, warm_dir, cold.warmup_report, cold.compile_count, \
        out


def _x():
    return np.asarray([[1.5, -2.0]], np.float32)


def _verdicts(report):
    return [(b["bucket"], b["verdict"]) for b in report["buckets"]]


def test_warm_restart_zero_compiles_matches_jax(linear_warm):
    """A restarted server over the warm dir loads its rung: no compile,
    the cold server's outputs bit for bit, the JAX warm server's within
    1e-5, and the JAX server's verdicts."""
    root, export, warm_dir, cold_report, cold_compiles, cold_out = \
        linear_warm
    assert _verdicts(cold_report) == [(1, "compiled")] and cold_compiles == 1
    assert os.listdir(warm_dir) == ["serving_b1.aotx"]
    before = compilecache.stats.counters_snapshot()
    warm = serving.ModelServer(export, batch_size=1, device="cpu",
                               warm_cache_dir=warm_dir)
    warm.warmup()
    assert _verdicts(warm.warmup_report) == [(1, "loaded")]
    assert warm.compile_count == 0
    got = warm.predict_feed({"x": _x()}, 1)["output"]
    np.testing.assert_array_equal(got, cold_out)
    after = compilecache.stats.counters_snapshot()
    assert after["compile_cache_aot_load"] == \
        before["compile_cache_aot_load"] + 1

    jax_dir = str(root / "jax-v1")
    reports, outs = [], []
    for _ in range(2):
        server = jax_serving.ModelServer(jax_dir, batch_size=1,
                                         warm_cache_dir=str(root / "jwarm"))
        server.warmup()
        reports.append(_verdicts(server.warmup_report))
        outs.append(np.asarray(server.predict_feed({"x": _x()}, 1)["output"]))
    assert reports == [_verdicts(cold_report),
                       _verdicts(warm.warmup_report)]
    np.testing.assert_allclose(got, outs[0], rtol=0, atol=TOL)
    eager = serving.ModelServer(export, batch_size=1, device="cpu")
    eager.warmup()
    assert _verdicts(eager.warmup_report) == [(1, "compiled")]
    np.testing.assert_allclose(got, eager.predict_feed({"x": _x()}, 1)
                               ["output"], rtol=0, atol=TOL)


def test_swap_keeps_the_warm_rung(linear_warm, tmp_path):
    """The params are the package's inputs: a live swap's new weights
    reach the loaded rung, which stays in use (nothing recompiles)."""
    _, export, warm_dir, _, _, _ = linear_warm
    other = {"dense": {"kernel": np.asarray([[-1.0], [4.0]], np.float32),
                       "bias": np.asarray([2.0], np.float32)}}
    _, export2 = _linear_export(tmp_path, "v2", other)
    server = serving.ModelServer(export, batch_size=1, device="cpu",
                                 warm_cache_dir=warm_dir)
    server.warmup()
    program = server._warm_exec[1]
    assert server.swap_export(export2, expected_version="2") == "2"
    got = server.predict_feed({"x": _x()}, 1)["output"]
    assert server._warm_exec[1] is program and server.compile_count == 0
    np.testing.assert_allclose(got, [[-1.5 - 8.0 + 2.0]], rtol=0, atol=TOL)


def _replica(args, env):
    return subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_torch.inference_cli",
         "--serve", "--device", "cpu", "--max-batch", "1", "--port", "0",
         "--heartbeat", "0.25"] + args,
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_cli_replicas_warm_from_flag_and_registry(linear_warm, tmp_path):
    """``--warm-cache-dir W`` and a registry entry carrying ``warm_dir=W``
    each start a replica that loads its rung from ``W`` (its roster
    registration says so) and answers as the cold server did."""
    _, export, warm_dir, _, _, cold_out = linear_warm
    registry = fleet.ModelRegistry(tmp_path / "registry")
    registry.publish("linear", "1", export, status="live", warm_dir=warm_dir)
    registry.close()
    resv = reservation.Server(2, heartbeat_interval=0.25)
    host, port = resv.start()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    roster = ["--roster", "%s:%d" % (host, port)]
    procs = [
        _replica(["--export_dir", export, "--warm-cache-dir", warm_dir,
                  "--replica-id", "flag"] + roster, env),
        _replica(["--registry", registry.root, "--model", "linear",
                  "--replica-id", "registry"] + roster, env)]
    try:
        rc = reservation.Client((host, port))
        try:
            rows = {r["executor_id"]: r
                    for r in rc.await_reservations(timeout=120)}
        finally:
            rc.close()
        assert sorted(rows) == ["flag", "registry"]
        for name, row in rows.items():
            assert _verdicts(row["warmup"]) == [(1, "loaded")], (name, row)
            ch = GatewayChannel(row["addr"], timeout=30)
            try:
                out = ch.predict({"x": _x()}, 1)
            finally:
                ch.close()
            np.testing.assert_array_equal(out["output"], cold_out)
        assert rows["registry"]["model_version"] == "1"
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for proc in procs:
            assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        resv.stop()


def test_flash_lm_rung_cold_then_warm(tmp_path):
    """The 2-layer flash LM's rung: the package calls ``tfos::flash_fwd``
    (the plain version on the CPU), a warm restart loads it with no
    compile and answers bit for bit as the cold server, both within 1e-5
    of the eager forward, relative to the largest logit."""
    model = get_model("transformer_lm", **LM_CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    export = str(tmp_path / "lm")
    checkpoint.export_model(export, model, "transformer_lm",
                            model_config=LM_CFG,
                            input_signature={"tokens": {
                                "shape": [None, LM_CFG["max_seq_len"]],
                                "dtype": "int32"}})
    tokens = np.random.default_rng(3).integers(
        0, LM_CFG["vocab_size"], (1, LM_CFG["max_seq_len"])).astype(np.int32)
    warm_dir = str(tmp_path / "warm")
    outs = []
    for expect, compiles in (("compiled", 1), ("loaded", 0)):
        server = serving.ModelServer(export, batch_size=1, device="cpu",
                                     warm_cache_dir=warm_dir)
        server.warmup()
        assert _verdicts(server.warmup_report) == [(1, expect)]
        assert server.compile_count == compiles
        outs.append(server.predict_feed({"tokens": tokens}, 1)["output"])
        assert 1 in server._warm_exec
    np.testing.assert_array_equal(outs[1], outs[0])
    eager = serving.ModelServer(export, batch_size=1, device="cpu")
    want = eager.predict_feed({"tokens": tokens}, 1)["output"]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(outs[0], want, rtol=0, atol=TOL * scale)
    # what the package calls: the op, whose fake keeps the kernel's
    # contract (output in the input dtype, the LSE fp32 [B * H, S])
    importlib.import_module("tensorflowonspark_torch.ops.flash_attention")
    q = torch.zeros(1, 32, 2, 32, dtype=torch.bfloat16, device="meta")
    out, lse = torch.ops.tfos.flash_fwd(q, q, q, 0.125, True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 32) and out.is_contiguous()
