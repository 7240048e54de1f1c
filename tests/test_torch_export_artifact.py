"""The port's exported serving artifact (``apply.pt2``, the counterpart of
the JAX package's ``apply.stablehlo``) against the JAX package: the same
params, exported by both with their model, give the same descriptor keys
(``exported`` in place of ``stablehlo``) and the same outputs from
``ModelServer`` at every ladder rung; the port serves the artifact with
its model registry blocked (``tests/test_serving.py``'s no-models test
re-pointed), falls back to the registry without it or on another platform,
swaps weights on it, warms its rungs from it, and a published fleet
version carries it."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu import checkpoint as jax_checkpoint
from tensorflowonspark_tpu import serving as jax_serving
from tensorflowonspark_tpu.models import get_model as jax_get_model
from tensorflowonspark_torch import (checkpoint, compilecache, convert,
                                     fleet, serving)
from tensorflowonspark_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_CFG = {"vocab_size": 64, "num_layers": 2, "num_heads": 2, "head_dim": 16,
          "max_seq_len": 32, "attention": "flash", "dtype": "float32"}
# fp32 on both sides; the products sum in other orders (XLA against
# ATen), so each model is held to 1e-5 of its largest output
TOL = 1e-5

# name -> (JAX model config, input signature, JAX init inputs, converter)
MODELS = {
    "linear": ({"features": 1}, {"x": [None, 2]},
               {"x": jnp.zeros((1, 2))}, convert.linear_params_from_flax),
    "two_tower": ({"embed_dim": 4},
                  {"user": {"shape": [None, 3], "dtype": "float32"},
                   "item": {"shape": [None, 5], "dtype": "float32"}},
                  {"user": jnp.zeros((1, 3)), "item": jnp.zeros((1, 5))},
                  convert.two_tower_params_from_flax),
    "mnist_cnn": ({}, {"image": [None, 28, 28, 1]},
                  {"x": jnp.zeros((1, 28, 28, 1))},
                  convert.mnist_params_from_flax),
    "transformer_lm": (LM_CFG,
                       {"tokens": {"shape": [None, 32], "dtype": "int32"}},
                       {"x": jnp.zeros((1, 32), jnp.int32)},
                       convert.transformer_params_from_flax),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _descriptor(export_dir):
    with open(os.path.join(export_dir, "export.json")) as f:
        return json.load(f)


def _port_model(name, state, config):
    model = get_model(name, state_dict=state, **config)
    model.load_state_dict(state)
    return model


def _pair(root, name, seed=0):
    """The JAX export of a flax init (with its model: the StableHLO
    artifact where JAX can make one) and the port's export of the same
    params, converted, with its model (the ``apply.pt2`` artifact)."""
    config, signature, init, to_torch = MODELS[name]
    flax_model = jax_get_model(name, **config)
    args = list(init.values()) if list(init) == ["x"] else []
    kwargs = {} if args else init
    params = _np(flax_model.init(jax.random.PRNGKey(seed), *args,
                                 **kwargs)["params"])
    jax_dir = str(root / (name + "_jax"))
    torch_dir = str(root / (name + "_torch"))
    jax_checkpoint.export_model(jax_dir, params, name, model_config=config,
                                input_signature=signature, model=flax_model)
    loaded, desc = jax_checkpoint.load_model(jax_dir)
    state = to_torch(_np(loaded))
    checkpoint.export_model(torch_dir, state, desc["model_name"],
                            model_config=desc["model_config"],
                            input_signature=desc["input_signature"],
                            model=_port_model(name, state, config))
    return jax_dir, torch_dir


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    return {name: _pair(root, name) for name in MODELS}


def _feed(name, n, seed):
    rng = np.random.default_rng(seed)
    _, signature, _, _ = MODELS[name]
    feed = {}
    for tensor, spec in serving._normalize_signature(signature).items():
        shape = [n] + list(spec["shape"][1:])
        if spec["dtype"] == "int32":
            feed[tensor] = rng.integers(0, LM_CFG["vocab_size"], shape,
                                        dtype=np.int32)
        else:
            feed[tensor] = rng.standard_normal(shape).astype(np.float32)
    return feed


def test_descriptor_keys_match_jax(pairs):
    """The port's descriptor has JAX's keys, ``exported`` for
    ``stablehlo``, and records where the artifact may be served."""
    for name, (jax_dir, torch_dir) in pairs.items():
        got, want = _descriptor(torch_dir), _descriptor(jax_dir)
        assert set(got) - {"exported"} == set(want) - {"stablehlo"}, name
        assert got["exported"] == {"file": "apply.pt2",
                                   "platforms": ["cpu", "cuda"]}, name
        assert os.path.exists(os.path.join(torch_dir, "apply.pt2"))
        if "stablehlo" in want:
            assert sorted(want["stablehlo"]) == sorted(got["exported"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_artifact_serves_every_rung_as_jax(pairs, name):
    """``ModelServer(device="cpu")`` serves the artifact (``from_artifact``)
    at rungs 1, 2 and 4 (3 rows pad to 4), each within 1e-5 of the JAX
    ``ModelServer`` on the same params."""
    jax_dir, torch_dir = pairs[name]
    server = serving.ModelServer(torch_dir, batch_size=4, device="cpu")
    assert server.from_artifact and server.model is None
    jax_server = jax_serving.ModelServer(jax_dir, batch_size=4)
    for n in (1, 2, 3, 4):
        feed = _feed(name, n, seed=n)
        got = server.predict_feed(feed, n)
        want = jax_server.predict_feed(feed, n)
        assert sorted(got) == sorted(want), name
        for key in want:
            w = np.asarray(want[key], np.float32)
            assert got[key].shape == w.shape, (name, key, n)
            scale = max(float(np.abs(w).max()), 1.0)
            assert np.abs(got[key] - w).max() <= TOL * scale, (name, key, n)
    assert server.compile_count == 3     # rungs 1, 2, 4


_NO_MODELS_DRIVER = """
import importlib.abc
import sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.startswith("tensorflowonspark_torch.models"):
            raise ImportError("blocked for the no-user-code serving test: "
                              + name)
        return None

sys.meta_path.insert(0, _Block())

import numpy as np
from tensorflowonspark_torch import serving

server = serving.ModelServer(sys.argv[1], batch_size=4, device="cpu")
assert server.from_artifact, "expected the artifact path"
rows = [{"u": [1.0, 0.0, 0.0], "i": [0.0, 1.0, 0.0, 0.0, 0.0]},
        {"u": [0.5, 0.5, 0.5], "i": [0.5, 0.5, 0.5, 0.5, 0.5]}]
outs = list(server.run_rows_dict(
    iter(rows), input_mapping={"u": "user", "i": "item"},
    output_mapping={"score": "score", "user_embedding": "emb"}))
assert len(outs) == 2 and all("score" in o and "emb" in o for o in outs)
assert not any(n.startswith("tensorflowonspark_torch.models")
               for n in sys.modules)
print("SERVED_WITHOUT_MODELS_PACKAGE", outs[0]["score"])
"""


def test_serving_without_models_package(pairs, tmp_path):
    """A process whose ``tensorflowonspark_torch.models`` is blocked serves
    the export from the artifact alone, as the direct forward does."""
    _, torch_dir = pairs["two_tower"]
    script = str(tmp_path / "no_models_driver.py")
    with open(script, "w") as f:
        f.write(_NO_MODELS_DRIVER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, script, torch_dir],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED_WITHOUT_MODELS_PACKAGE" in proc.stdout
    score = float(proc.stdout.split()[-1])
    state, desc = checkpoint.load_model(torch_dir)
    model = _port_model("two_tower", state, desc["model_config"])
    want = model(user=torch.tensor([[1.0, 0.0, 0.0]]),
                 item=torch.tensor([[0.0, 1.0, 0.0, 0.0, 0.0]]))
    assert abs(score - float(want["score"][0].detach())) < 1e-5


def test_registry_fallback_without_artifact_or_platform(pairs, tmp_path,
                                                        caplog):
    """No ``model=``: no artifact, registry serving.  An artifact made for
    other platforms only: a warning, registry serving, the same outputs."""
    _, torch_dir = pairs["linear"]
    state, desc = checkpoint.load_model(torch_dir)
    bare = str(tmp_path / "bare")
    checkpoint.export_model(bare, state, "linear",
                            model_config=desc["model_config"],
                            input_signature=desc["input_signature"])
    assert "exported" not in _descriptor(bare)
    server = serving.ModelServer(bare, batch_size=2, device="cpu")
    assert not server.from_artifact and server.model is not None
    feed = _feed("linear", 2, seed=5)
    want = server.predict_feed(feed, 2)["output"]

    cuda_only = str(tmp_path / "cuda_only")
    checkpoint.export_model(cuda_only, state, "linear",
                            model_config=desc["model_config"],
                            input_signature=desc["input_signature"],
                            model=_port_model("linear", state,
                                              desc["model_config"]),
                            serialize_platforms=("cuda",))
    assert _descriptor(cuda_only)["exported"]["platforms"] == ["cuda"]
    with caplog.at_level("WARNING"):
        other = serving.ModelServer(cuda_only, batch_size=2, device="cpu")
    assert not other.from_artifact
    assert "falling back to registry serving" in caplog.text
    np.testing.assert_array_equal(other.predict_feed(feed, 2)["output"],
                                  want)
    artifact = serving.ModelServer(torch_dir, batch_size=2, device="cpu")
    np.testing.assert_allclose(artifact.predict_feed(feed, 2)["output"],
                               want, rtol=0, atol=1e-6)


def test_non_batch_dynamic_dim_refused():
    model = get_model("linear", in_features=2)
    with pytest.raises(ValueError, match="non-batch dynamic dim 1"):
        serving.serialize_apply(model, model.state_dict(),
                                {"x": [None, None]})


def test_swap_export_on_the_artifact(tmp_path):
    """A live swap writes the new params into the artifact's inputs: the
    outputs become the new export's, no rung is compiled again, and a swap
    to another shape is refused with the old params still served."""
    state1 = convert.two_tower_params_from_flax(_np(jax_get_model(
        "two_tower", embed_dim=4).init(
            jax.random.PRNGKey(1), user=jnp.zeros((1, 3)),
            item=jnp.zeros((1, 5)))["params"]))
    state2 = {k: v * 2.0 + 0.5 for k, v in state1.items()}
    config, signature, _, _ = MODELS["two_tower"]
    dirs = []
    for i, state in enumerate((state1, state2)):
        d = str(tmp_path / "v{}".format(i + 1))
        checkpoint.export_model(d, state, "two_tower", model_config=config,
                                input_signature=signature,
                                model=_port_model("two_tower", state, config))
        dirs.append(d)
    server = serving.ModelServer(dirs[0], batch_size=4, device="cpu")
    fresh = serving.ModelServer(dirs[1], batch_size=4, device="cpu")
    assert server.from_artifact and fresh.from_artifact
    feed = _feed("two_tower", 3, seed=11)
    before = server.predict_feed(feed, 3)
    compiles = server.compile_count
    assert server.swap_export(dirs[1], expected_version="2") == "2"
    after = server.predict_feed(feed, 3)
    want = fresh.predict_feed(feed, 3)
    for key in want:
        np.testing.assert_array_equal(after[key], want[key])
        assert not np.array_equal(after[key], before[key])
    assert server.compile_count == compiles and server.swap_count == 1
    wide = str(tmp_path / "wide")
    state3 = dict(state1, **{"user_tower.weight": torch.zeros(4, 7)})
    checkpoint.export_model(wide, state3, "two_tower", model_config=config,
                            input_signature=signature)
    with pytest.raises(fleet.SwapRefused):
        server.swap_export(wide)
    for key in want:
        np.testing.assert_array_equal(server.predict_feed(feed, 3)[key],
                                      want[key])


def test_warm_rung_compiles_from_the_artifact(pairs, tmp_path, monkeypatch):
    """With ``warm_cache_dir`` each rung compiles the artifact's program
    (the registry's is never built) and its fingerprint says so."""
    _, torch_dir = pairs["linear"]
    seen = []

    def stand_in(cache, name, fp, compile_fn, args):
        fn, params, inputs = args
        seen.append((name, compile_fn, json.loads(
            json.dumps(fp, default=str))))
        return (lambda p, i: fn(p, i)), "compiled", None

    monkeypatch.setattr(compilecache, "load_or_compile", stand_in)
    server = serving.ModelServer(torch_dir, batch_size=2, device="cpu",
                                 warm_cache_dir=str(tmp_path / "warm"))
    assert server.from_artifact and server.model is None
    assert server.warmup() == 2
    assert [s[0] for s in seen] == ["serving_b2", "serving_b1"]
    assert all(s[1] is compilecache.aoti_compile for s in seen)
    assert all('"stablehlo": true' in json.dumps(s[2]) for s in seen)
    feed = _feed("linear", 1, seed=3)
    eager = serving.ModelServer(torch_dir, batch_size=2, device="cpu")
    np.testing.assert_array_equal(server.predict_feed(feed, 1)["output"],
                                  eager.predict_feed(feed, 1)["output"])


def test_artifact_graph_names_only_its_device(tmp_path):
    """A factory in the forward (``torch.arange(..., device=x.device)``) is
    traced on the CPU; after the move no op names the CPU."""

    class Positional(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.scale = torch.nn.Parameter(torch.ones(4))

        def forward(self, x):
            return x * self.scale + torch.arange(4, device=x.device)

    model = Positional()
    blob, platforms = serving.serialize_apply(
        model, model.state_dict(), {"x": [None, 4]})
    assert platforms == ("cpu", "cuda")
    path = str(tmp_path / "apply.pt2")
    with open(path, "wb") as f:
        f.write(blob)
    program = torch.export.load(path)
    assert "cpu" in serving._devices_named(program)
    moved = torch.export.passes.move_to_device_pass(program, "meta")
    assert serving._devices_named(moved) == {"meta"}
    apply_fn = serving.load_artifact(path, "cpu")
    out = apply_fn({"scale": torch.full((4,), 2.0)},
                   {"x": torch.ones(1, 4)})
    np.testing.assert_array_equal(out.numpy(), [[2.0, 3.0, 4.0, 5.0]])


def test_published_version_carries_the_artifact(tmp_path):
    """``publish_trained`` with the spec's ``module`` exports the artifact:
    the published version is served from it."""
    model = get_model("transformer_lm", **LM_CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    spec = {"registry": str(tmp_path / "registry"), "model": "lm",
            "model_name": "transformer_lm", "model_config": LM_CFG,
            "input_signature": MODELS["transformer_lm"][1],
            "module": model}
    entry = fleet.publish_trained(spec, model.state_dict(), 7)
    assert entry["version"] == "step-7"
    assert "exported" in _descriptor(entry["export_dir"])
    server = serving.ModelServer(entry["export_dir"], batch_size=2,
                                 device="cpu")
    assert server.from_artifact
    feed = _feed("transformer_lm", 2, seed=2)
    with torch.no_grad():
        want = model(torch.from_numpy(feed["tokens"])).numpy()
    np.testing.assert_allclose(server.predict_feed(feed, 2)["output"], want,
                               rtol=0, atol=1e-5)
