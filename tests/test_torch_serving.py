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
    the CPU (the native runner's Python entry points among them)."""
    _, torch_dir = exports
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ModelServer(torch_dir, batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(inference_cli.run_inference(torch_dir, _rows(1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(inference_cli.run_inference_native(torch_dir, _rows(1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.run_embedded_native_many(torch_dir, [])
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

# the port's examples and its capture-merge script, imported as modules
# like the port's own
_EXAMPLES = (os.path.join("examples", "mnist", "mnist_spark_torch.py"),
             os.path.join("examples", "mnist", "mnist_pipeline_torch.py"),
             os.path.join("examples", "mnist", "mnist_files_torch.py"),
             os.path.join("examples", "mnist", "mnist_inference_torch.py"),
             os.path.join("examples", "resnet", "imagenet_input_torch.py"),
             os.path.join("examples", "resnet", "resnet_imagenet_torch.py"),
             os.path.join("examples", "transformer",
                          "transformer_lm_torch.py"),
             os.path.join("examples", "segmentation", "segmentation_torch.py"),
             os.path.join("examples", "resnet", "resnet_cifar_torch.py"),
             os.path.join("examples", "resnet", "predecode_imagenet_torch.py"),
             os.path.join("examples", "mnist", "mnist_data_setup_torch.py"),
             os.path.join("examples", "mnist", "mnist_streaming_torch.py"),
             os.path.join("examples", "mnist", "mnist_eval_node_torch.py"),
             os.path.join("examples", "utils", "stop_streaming_torch.py"),
             os.path.join("scripts", "analyze_profile_torch.py"),
             os.path.join("scripts", "metrics_replay_torch.py"),
             os.path.join("scripts", "ci_assert_torch_fleet.py"),
             os.path.join("scripts", "ci_assert_torch_warmstart.py"),
             os.path.join("scripts", "ci_assert_torch_dataservice.py"),
             os.path.join("scripts", "ci_assert_torch_cache.py"),
             os.path.join("scripts", "ci_assert_torch_shared.py"),
             # the twins of the JAX package's other one-shot gates
             *(os.path.join("scripts", "ci_assert_torch_{}.py".format(name))
               for name in ("watchtower", "autopilot", "remediator",
                            "serving", "reqtrace", "elastic", "telemetry",
                            "ha", "overlap", "megastep", "observatory",
                            "profiling", "native")))

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import tensorflowonspark_torch as pkg
names = [info.name for info in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for path in {examples!r}:
    name = path.rsplit("/", 1)[-1][:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules if n.split(".")[0] in {forbidden!r})
missing = sorted(set(pkg.__name__ + "." + m for m in (
    "summary", "tfrecord", "example_proto", "schema", "dfutil", "transport",
    "gateway", "fleet", "pipeline", "models.linear", "models.twotower",
    "models.resnet", "ops.augment", "data", "parallel.mesh",
    "parallel.fsdp", "parallel.ring", "parallel.tp", "parallel.ep",
    "parallel.pp", "parallel.comm", "observatory", "profiling",
    "profiler", "watchtower", "guardrails", "autopilot", "remediator",
    "compilecache", "dataservice", "dataservice_worker",
    "dataservice_dispatcher", "reservation_server"))
    - set(names))
from tensorflowonspark_torch.parallel import ep, fsdp, mesh, pp, ring, tp
missing += [n for n in ("tp_param_shardings", "shard_params")
            if not hasattr(tp, n)]
missing += [n for n in ("ep_param_shardings", "merge_ep_shardings",
                        "moe_ffn", "MOE_PARAM_RE") if not hasattr(ep, n)]
missing += [n for n in ("gpipe", "split_microbatches", "stack_stage_params",
                        "stage_shardings") if not hasattr(pp, n)]
missing += [n for n in ("Placement", "groups", "pooled_axes")
            if not hasattr(mesh, n)]
missing += [n for n in ("ring_attention", "ulysses_attention",
                        "chained_ring_attention") if not hasattr(ring, n)]
missing += [n for n in ("MeshSpec", "build_mesh", "batch_sharding",
                        "replicated", "local_batch_size")
            if not hasattr(mesh, n)]
missing += [n for n in ("leaf_spec", "tree_shardings", "shard_tree",
                        "ShardedParams") if not hasattr(fsdp, n)]
from tensorflowonspark_torch import fleet, gateway, pipeline
missing += [n for n in ("TFEstimator", "TFModel", "_run_model_fn")
            if not hasattr(pipeline, n)]
missing += [n for n in ("GatewayServer", "GatewayChannel", "ServingClient")
            if not hasattr(gateway, n)]
missing += [n for n in ("SwapRefused", "PublishConflict",
                        "read_registry_journal", "ModelRegistry",
                        "FleetRouter", "FleetClient", "DEFAULT_CANARY_CONFIG",
                        "CanaryController", "judge_window", "publish_trained",
                        "replay_journal") if not hasattr(fleet, n)]
from tensorflowonspark_torch import checkpoint, data, train
from tensorflowonspark_torch.models import resnet
missing += [n for n in ("FileFeed", "ProcessPoolFeed", "shard_for_process")
            if not hasattr(data, n)]
missing += [n for n in ("build_resnet50", "build_resnet56", "loss_fn")
            if not hasattr(resnet, n)]
missing += [n for n in ("fit_supervised", "MAX_ROLLBACKS",
                        "_resolve_transfer_guard", "TRANSFER_GUARD_ENV")
            if not hasattr(train, n)]
from tensorflowonspark_torch import observatory, profiler, profiling
missing += [n for n in ("SampleRing", "render_prometheus",
                        "ObservatoryServer", "build_info", "collect_slow")
            if not hasattr(observatory, n)]
missing += [n for n in ("CaptureCoordinator", "handle_capture_request",
                        "merge_capture", "register_step_counter")
            if not hasattr(profiling, n)]
missing += [n for n in ("StepProfiler", "start_server", "server_counters",
                        "parse_profile_steps") if not hasattr(profiler, n)]
missing += [n for n in ("evaluate", "apply_knob")
            if not hasattr(train.Trainer, n)]
from tensorflowonspark_torch import autopilot, guardrails, remediator
from tensorflowonspark_torch import watchtower
missing += [n for n in ("RuleEngine", "Watchtower", "AlertDeduper",
                        "replay_journal", "read_journal")
            if not hasattr(watchtower, n)]
missing += [n for n in ("Guardrails", "JsonlJournal", "STAGES")
            if not hasattr(guardrails, n)]
missing += [n for n in ("Autopilot", "replay_journal")
            if not hasattr(autopilot, n)]
missing += [n for n in ("Remediator", "replay_journal")
            if not hasattr(remediator, n)]
missing += [n for n in ("restore_latest_valid", "_quarantine")
            if not hasattr(checkpoint.CheckpointManager, n)]
from tensorflowonspark_torch import compilecache
missing += [n for n in ("CACHE_DIR_ENV", "stats", "configure",
                        "configure_from_meta", "configured_dir",
                        "fingerprint", "program_identity", "AOTCache",
                        "load_or_compile", "KernelSet", "AOTIProgram",
                        "aoti_compile") if not hasattr(compilecache, n)]
missing += [n for n in ("aot_root",) if not hasattr(checkpoint, n)]
from tensorflowonspark_torch import inference_cli, serving
from tensorflowonspark_torch.ops import _build
missing += [n for n in ("build_apply_fn", "serialize_apply",
                        "serialize_embedded", "load_artifact",
                        "run_embedded_native", "run_embedded_native_many",
                        "_SHORT_DTYPES") if not hasattr(serving, n)]
missing += [n for n in ("run_inference_native",)
            if not hasattr(inference_cli, n)]
missing += [n for n in ("build_native", "native_path", "NATIVE")
            if not hasattr(_build, n)]
missing += [n for n in ("flash_ops", "aoti_runner")
            if not (_build.CSRC / (n + ".cpp")).exists()]
missing += [n for n in ("set_aot_cache", "_aot_resolve")
            if not hasattr(train.Trainer, n)]
from tensorflowonspark_torch import dataservice
missing += [n for n in ("SHARD_OFF", "SHARD_STATIC", "SHARD_DYNAMIC",
                        "DispatchError", "DispatcherServer",
                        "DispatcherClient", "FeedWorker", "ServiceFeed",
                        "_Job", "_FrameCache") if not hasattr(dataservice, n)]
missing += [n for n in ("apply_knob", "counters_snapshot", "pop_flow_id")
            if not hasattr(dataservice.ServiceFeed, n)]
from tensorflowonspark_torch.parallel import infeed
missing += [n for n in ("_note_flow", "pop_dispatch_flow")
            if not hasattr(infeed.ShardedFeed, n)]
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 25 else 0)
"""


def test_port_imports_no_jax():
    """A fresh interpreter that imports every port module (the copied
    cluster layer, the serving tier, the ResNets, ``ops.augment``,
    ``data`` and the mesh, FSDP, ring, tensor-, expert- and
    pipeline-parallel modules among them),
    chip_smoke.py, the port's MNIST, ResNet, LM and segmentation examples
    and its data scripts (the U-Net, the CIFAR, streaming, evaluator,
    data-setup, pre-decode and STOP twins among them),
    scripts/analyze_profile_torch.py, scripts/metrics_replay_torch.py and
    scripts/ci_assert_torch_fleet.py and scripts/ci_assert_torch_warmstart.py
    has no jax, flax, optax, orbax or JAX-package module; the alerting and
    control planes (watchtower, guardrails, autopilot, remediator), the
    model fleet (fleet, with every public name of the JAX package's), the
    compile plane (compilecache), the exported artifact and the native
    runner's Python side (serving's serializers, ``run_embedded_native*``,
    ``inference_cli.run_inference_native``, ``ops._build.build_native``
    and its C++ sources), the MNIST inference twin, the data service
    (``dataservice`` with its worker and dispatcher CLIs,
    ``reservation_server``, ``ShardedFeed``'s split-flow relay), the
    data-service gates and the twins of the other JAX gates (watchtower,
    autopilot, remediator, serving, reqtrace, elastic, telemetry, ha,
    overlap, megastep, observatory, profiling, native) are among them."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(forbidden=_FORBIDDEN,
                                                  examples=_EXAMPLES)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax():
    """No line of the port (its fleet and its U-Net among it), of
    chip_smoke.py, of the port's MNIST, ResNet, LM and segmentation
    examples and data scripts or of
    scripts/analyze_profile_torch.py, scripts/metrics_replay_torch.py,
    scripts/ci_assert_torch_fleet.py, scripts/ci_assert_torch_warmstart.py,
    the data-service gates and every other gate twin (one for each
    ``scripts/ci_assert_*.py`` of the JAX package; the data service and
    ``reservation_server`` among the port's files) imports a forbidden
    package, not even inside a function."""
    pattern = re.compile(r"^\s*(import|from)\s+({})\b".format(
        "|".join(_FORBIDDEN)))
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, e) for e in _EXAMPLES]
    for root, _, files in os.walk(os.path.join(REPO,
                                               "tensorflowonspark_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for name in ("tp", "ep", "pp", "comm"):
        assert os.path.join(REPO, "tensorflowonspark_torch", "parallel",
                            name + ".py") in paths, name
    for name in ("watchtower", "guardrails", "autopilot", "remediator",
                 "cluster", "fleet", "compilecache", "dataservice",
                 "dataservice_worker", "dataservice_dispatcher",
                 "reservation_server"):
        assert os.path.join(REPO, "tensorflowonspark_torch",
                            name + ".py") in paths, name
    for name in ("metrics_replay_torch.py", "ci_assert_torch_fleet.py",
                 "ci_assert_torch_warmstart.py",
                 "ci_assert_torch_dataservice.py", "ci_assert_torch_cache.py",
                 "ci_assert_torch_shared.py"):
        assert os.path.join(REPO, "scripts", name) in paths, name
    # every JAX gate has its twin, and every twin is checked
    jax_gates = {name for name in os.listdir(os.path.join(REPO, "scripts"))
                 if name.startswith("ci_assert_")
                 and not name.startswith("ci_assert_torch_")}
    for name in jax_gates:
        twin = name.replace("ci_assert_", "ci_assert_torch_", 1)
        assert os.path.join(REPO, "scripts", twin) in paths, twin
    assert os.path.join(REPO, "examples", "mnist",
                        "mnist_inference_torch.py") in paths
    # the U-Net and the last example twins (the segmentation, CIFAR,
    # streaming, evaluator and data-script twins)
    assert os.path.join(REPO, "tensorflowonspark_torch", "models",
                        "unet.py") in paths
    for name in ("segmentation_torch.py", "resnet_cifar_torch.py",
                 "predecode_imagenet_torch.py", "mnist_data_setup_torch.py",
                 "mnist_streaming_torch.py", "mnist_eval_node_torch.py",
                 "stop_streaming_torch.py"):
        assert any(p.endswith(os.sep + name) for p in paths), name
    for name in ("serving", "inference_cli", os.path.join("ops", "_build")):
        assert os.path.join(REPO, "tensorflowonspark_torch",
                            name + ".py") in paths, name
    offenders = []
    for path in paths:
        with open(path) as f:
            offenders += ["{}:{}".format(path, i) for i, line in enumerate(f, 1)
                          if pattern.match(line)]
    assert len(paths) > 10 and not offenders, offenders
