"""The port's warm-start compile plane against the JAX package's
(``tests/test_compilecache.py`` re-pointed): the artifact store's
fingerprint gate and corruption tolerance, the configuration and the
counters, the kernel build's toolkit key, and the Trainer on a 2-layer
flash LM, cold then warm, beside the JAX Trainer on the same numpy inputs.
The AOTInductor rungs of the serving side are in
``tests/test_torch_compilecache_aoti.py``.

The invariant under test everywhere: a warm start is an optimization,
never a correctness dependency — every mismatched, corrupt, or drifted
artifact degrades to eager dispatch with ``compile_cache_fallback``
incremented, identical numerics, and no exception.
"""

import functools
import json
import os
import shutil
import stat
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tensorflowonspark_tpu import compilecache as jax_cc
from tensorflowonspark_tpu import train as jax_train
from tensorflowonspark_tpu.models import transformer as jax_transformer
from tensorflowonspark_tpu.parallel import batch_sharding, build_mesh
from tensorflowonspark_torch import checkpoint, compilecache, convert, train
from tensorflowonspark_torch.models import transformer
from tensorflowonspark_torch.ops import _build

CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=16,
           max_seq_len=32)
SEQ, BATCH = 32, 8
PARAM_ATOL = 1e-5     # port against JAX after the same SGD steps, fp32


@pytest.fixture(autouse=True)
def _isolated_plane(monkeypatch):
    """No compile root leaks between tests: the env var, the configured
    dir and the compiler caches are restored, and ``ops._build``'s loaded
    libraries are this test's own."""
    for var in (compilecache.CACHE_DIR_ENV, "TORCHINDUCTOR_CACHE_DIR",
                "TRITON_CACHE_DIR"):
        if var in os.environ:
            monkeypatch.setenv(var, os.environ[var])
        else:
            monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(compilecache, "_configured_dir", None)
    monkeypatch.setattr(compilecache, "_env_set", {})
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_MADE_HERE", set())


def _both(fn):
    """``fn(cc)`` on the JAX module and the port's; the pair of results."""
    return fn(jax_cc), fn(compilecache)


# -- the store --------------------------------------------------------------

def _port_compile(x):
    return compilecache.KernelSet.compile("cpu")


class _JaxFn(object):
    """``load_or_compile``'s jit-fn argument for the JAX side."""

    def __init__(self, fn):
        self.fn = jax.jit(fn)

    def lower(self, *args):
        return self.fn.lower(*args)


def _roundtrip(cc, tmp_path, arr):
    cache = cc.AOTCache(str(tmp_path / cc.__name__.split(".")[0]))
    if cc is jax_cc:
        fn, args = _JaxFn(lambda a: a * 2 + 1), (jnp.asarray(arr),)
    else:
        fn, args = _port_compile, (arr,)
    fp = cc.fingerprint(avals=args, extra={"program": "t"})
    before = cc.stats.aot_save
    _, verdict, _ = cc.load_or_compile(cache, "t", fp, fn, args)
    saved = cc.stats.aot_save - before
    warm = cc.AOTCache(cache.directory)
    _, verdict2, _ = cc.load_or_compile(warm, "t", fp, fn, args)
    return verdict, saved, os.path.exists(cache.path("t")), verdict2


class TestAOTStore:
    def test_cold_then_warm_roundtrip(self, tmp_path):
        """A cold store compiles and persists; a fresh store over the same
        directory loads; the verdicts are the JAX store's."""
        arr = np.arange(4, dtype=np.float32)
        want, got = _both(lambda cc: _roundtrip(cc, tmp_path, arr))
        assert got == want == ("compiled", 1, True, "loaded")
        # the directory is private: its artifacts load shared libraries
        mode = stat.S_IMODE(os.stat(str(tmp_path / "tensorflowonspark_torch")
                                    ).st_mode)
        assert mode == 0o700

    def test_absent_artifact_is_silent_miss(self, tmp_path):
        """A cold store is not a fallback: the counter must not move."""
        def run(cc):
            cache = cc.AOTCache(str(tmp_path / cc.__name__))
            before = cc.stats.fallback
            return cache.load("nope", {"format": 1}), \
                cc.stats.fallback - before
        want, got = _both(run)
        assert got == want == (None, 0)

    def test_aval_mismatch_falls_back(self, tmp_path):
        """Same program name, different batch aval: the stored artifact is
        rejected naming ``avals`` and the caller recompiles."""
        small = np.zeros((4,), np.float32)
        big = np.zeros((16,), np.float32)

        def run(cc):
            cache = cc.AOTCache(str(tmp_path / cc.__name__))
            if cc is jax_cc:
                fn = _JaxFn(lambda x: x.sum())
                a, b = (jnp.asarray(small),), (jnp.asarray(big),)
            else:
                fn, a, b = _port_compile, (small,), (big,)
            fp_small = cc.fingerprint(avals=a)
            fp_big = cc.fingerprint(avals=b)
            diff = sorted(k for k in fp_small if fp_small[k] != fp_big[k])
            cc.load_or_compile(cache, "p", fp_small, fn, a)
            before = cc.stats.fallback
            _, verdict, _ = cc.load_or_compile(cache, "p", fp_big, fn, b)
            return diff, verdict, cc.stats.fallback - before
        want, got = _both(run)
        assert got == want == (["avals"], "compiled", 1)

    def test_version_drift_falls_back(self, tmp_path):
        """An artifact from another framework version never loads: the
        stored header names a fabricated version and the payload is
        garbage, proving the header is checked BEFORE the payload."""
        def run(cc, field):
            cache = cc.AOTCache(str(tmp_path / cc.__name__))
            x = np.zeros((2,), np.float32)
            if cc is jax_cc:
                fn, args = _JaxFn(lambda a: a + 1), (jnp.asarray(x),)
            else:
                fn, args = _port_compile, (x,)
            fp = cc.fingerprint(avals=args)
            cc.load_or_compile(cache, "v", fp, fn, args)
            with open(cache.path("v"), "rb") as f:
                blob = f.read()
            magic = cc._MAGIC
            header_end = blob.index(b"\n", len(magic))
            doc = json.loads(blob[len(magic):header_end])
            assert field in doc
            doc[field] = "9.9.9-fake"
            with open(cache.path("v"), "wb") as f:
                f.write(magic + json.dumps(doc, sort_keys=True).encode()
                        + b"\n" + b"\x80\x04 not a payload at all")
            before = cc.stats.fallback
            return cache.load("v", fp), cc.stats.fallback - before
        assert run(jax_cc, "jaxlib") == run(compilecache, "torch") \
            == (None, 1)
        assert run(compilecache, "nvcc") == (None, 1)

    def test_remote_directory_rejected(self):
        """Local filesystem only: a remote URL raises instead of being
        mangled into a local dir that would never warm another node."""
        for cc in (jax_cc, compilecache):
            with pytest.raises(ValueError, match="remote"):
                cc.AOTCache("gs://bucket/ckpt/aot_executables")

    def test_program_identity_sees_closure_values(self):
        """The structural hash separates what an aval fingerprint cannot
        (a constant in the loss body, a hyperparameter), on both sides,
        and is stable across equivalent reconstructions."""
        def loss_a(params, batch, mask):
            return (params * 2.0).sum(), None

        def loss_b(params, batch, mask):
            return (params * 3.0).sum(), None

        def sgd(lr):        # the port's optimizer is a factory
            return functools.partial(torch.optim.SGD, lr=lr)

        for cc, opt in ((jax_cc, optax.sgd), (compilecache, sgd)):
            ident = cc.program_identity
            assert ident(loss_a) != ident(loss_b)
            assert ident(opt(0.1)) != ident(opt(0.2))
            # deterministic across equivalent reconstructions (what two
            # processes re-running the same code must agree on)
            assert ident(opt(0.1)) == ident(opt(0.1))

    def test_program_identity_hashes_tensors(self):
        """The port's one fix: small tensors hash by their bytes (bf16
        included, which ``np.asarray`` refuses), and a module's params are
        its state, not its program."""
        ident = compilecache.program_identity
        ones = torch.ones(3, dtype=torch.bfloat16)
        assert ident(ones) == ident(ones.clone()) != ident(ones * 2)
        assert ident(torch.tensor(1.0)) != ident(torch.tensor(2.0))

        def model(seed):
            m = transformer.build_transformer(**CFG, attention="flash")
            return m.init_weights(torch.Generator().manual_seed(seed))

        assert ident(transformer.loss_fn(model(0))) == \
            ident(transformer.loss_fn(model(1)))
        other = transformer.build_transformer(**dict(CFG, num_layers=1),
                                              attention="flash")
        assert ident(transformer.loss_fn(model(0))) != \
            ident(transformer.loss_fn(other))

    @pytest.mark.parametrize("poison", [b"", b"not a pickle",
                                        b"\x80\x04garbage"])
    def test_corrupt_artifact_falls_back(self, tmp_path, poison):
        def run(cc):
            cache = cc.AOTCache(str(tmp_path / cc.__name__))
            with open(cache.path("c"), "wb") as f:
                f.write(poison)
            before = cc.stats.fallback
            return cache.load("c", cc.fingerprint()), \
                cc.stats.fallback - before
        want, got = _both(run)
        assert got == want == (None, 1)

    def test_truncated_artifact_falls_back(self, tmp_path):
        """A real artifact cut mid-way (the torn-write shape the atomic
        rename prevents, simulated anyway) reads as corrupt; a payload cut
        short fails its manifest's size check before any load."""
        def run(cc, cut):
            cache = cc.AOTCache(str(tmp_path / cc.__name__))
            x = np.zeros((2,), np.float32)
            if cc is jax_cc:
                fn, args = _JaxFn(lambda a: a * 3), (jnp.asarray(x),)
            else:
                fn, args = _port_compile, (x,)
            fp = cc.fingerprint(avals=args)
            cc.load_or_compile(cache, "t", fp, fn, args)
            with open(cache.path("t"), "rb") as f:
                blob = f.read()
            with open(cache.path("t"), "wb") as f:
                f.write(blob[:int(len(blob) * cut)])
            before = cc.stats.fallback
            return cache.load("t", fp), cc.stats.fallback - before
        assert run(jax_cc, 1 / 3) == run(compilecache, 1 / 3) == (None, 1)
        # the port's payload: a package whose bytes end early
        cache = compilecache.AOTCache(str(tmp_path / "payload"))
        fp = compilecache.fingerprint()
        package = types.SimpleNamespace(
            kind="aoti", files=lambda: [({"name": "program.pt2"},
                                         b"\x07" * 3000)])
        assert cache.save("p", fp, package)
        with open(cache.path("p"), "rb") as f:
            blob = f.read()
        with open(cache.path("p"), "wb") as f:
            f.write(blob[:-1000])
        before = compilecache.stats.fallback
        assert cache.load("p", fp) is None
        assert compilecache.stats.fallback == before + 1


class TestConfigure:
    def test_inert_without_dir(self, monkeypatch):
        for cc in (jax_cc, compilecache):
            monkeypatch.delenv(cc.CACHE_DIR_ENV, raising=False)
            assert cc.configure(None, register_feed=False) is None
        assert compilecache.configured_dir() is None

    def test_counters_snapshot_shape(self):
        want = jax_cc.stats.counters_snapshot()
        got = compilecache.stats.counters_snapshot()
        assert set(got) == set(want)
        assert set(got) >= {"compile_cache_hit", "compile_cache_miss",
                            "compile_cache_fallback",
                            "compile_cache_aot_load",
                            "compile_cache_aot_save",
                            "compile_cache_dir_bytes_hwm"}
        assert all(isinstance(v, int) for v in got.values())

    def test_fingerprint_names_the_diverged_field(self):
        def diff(cc):
            a = cc.fingerprint(extra={"program": "x"})
            b = cc.fingerprint(extra={"program": "y"})
            return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        want, got = _both(diff)
        assert got == want == ["program"]
        fp = compilecache.fingerprint(avals={"x": torch.zeros(2)},
                                      mesh=types.SimpleNamespace(
                                          mesh_dim_names=("data",),
                                          mesh=np.zeros((1,))))
        assert {"format", "torch", "cuda", "nvcc", "backend", "device",
                "device_count", "donate", "mesh", "avals",
                "kernels"} == set(fp)
        assert fp["backend"] == fp["device"] == "cpu"
        assert fp["mesh"] == repr((("data", 1),))

    def test_configure_sets_the_roots_without_cuda(self, tmp_path,
                                                   monkeypatch):
        """The root reaches ``ops._build`` and the compilers' caches
        (a user's own setting kept), children through the environment;
        nothing initialises CUDA."""
        monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "mine"))
        monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR", raising=False)
        root = compilecache.configure(str(tmp_path / "root"),
                                      register_feed=False)
        assert root == str(tmp_path / "root")
        assert compilecache.configured_dir() == root
        assert compilecache.CACHE_DIR_ENV == _build.CACHE_DIR_ENV
        assert os.environ[compilecache.CACHE_DIR_ENV] == root
        assert _build.build_dir() == tmp_path / "root" / "kernels"
        assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == os.path.join(
            root, "inductor")
        assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "mine")
        # a later root moves what configure set, not what the user set
        other = compilecache.configure(str(tmp_path / "other"),
                                       register_feed=False)
        assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == os.path.join(
            other, "inductor")
        assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "mine")
        assert compilecache.configure_from_meta(
            {"compile_cache_dir": root}) == root
        assert not torch.cuda.is_initialized()


# -- the kernel build's key -------------------------------------------------

_FAKE_NVCC = """#!/bin/sh
if [ "$1" = "--version" ]; then
  echo "Cuda compilation tools, release {release}"
  exit 0
fi
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
cp "{library}" "$out"
echo "ptxas info    : Used 1 registers"
"""


def _fake_toolkit(tmp_path, release):
    """A CUDA_HOME whose ``nvcc`` names ``release`` and 'builds' by
    copying a real shared library."""
    home = tmp_path / ("cuda-" + release)
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(
        release=release, library=os.path.join(
            os.path.dirname(torch.__file__), "lib",
            "libtorch_global_deps.so")))
    nvcc.chmod(0o755)
    return str(home)


def test_build_key_names_the_toolkit(tmp_path, monkeypatch):
    """The repair: a library built by another toolkit is not loaded; it
    counts as a miss and ``nvcc`` runs; the same toolkit's library is a
    hit whose saved time is the build's recorded seconds."""
    cuda_a = _fake_toolkit(tmp_path, "12.8, V12.8.93")
    cuda_b = _fake_toolkit(tmp_path, "12.9, V12.9.41")
    compilecache.configure(str(tmp_path / "root"), register_feed=False)
    snap = compilecache.stats.counters_snapshot

    def load_under(cuda_home):
        monkeypatch.setenv("CUDA_HOME", cuda_home)
        monkeypatch.setattr(_build, "_LOADED", {})
        monkeypatch.setattr(_build, "_MADE_HERE", set())
        before, runs = snap(), _build.nvcc_runs
        _build.load("flash_fwd")
        now = snap()
        return (_build.library_path("flash_fwd"),
                now["compile_cache_miss"] - before["compile_cache_miss"],
                now["compile_cache_hit"] - before["compile_cache_hit"],
                _build.nvcc_runs - runs)

    path_a, miss, hit, runs = load_under(cuda_a)
    assert (miss, hit, runs) == (1, 0, 1)
    assert path_a.parent == tmp_path / "root" / "kernels"
    assert _build.recorded_seconds(path_a) > 0
    path_b, miss, hit, runs = load_under(cuda_b)
    assert path_b != path_a and (miss, hit, runs) == (1, 0, 1)
    before = snap()["compile_cache_saved_us"]
    path, miss, hit, runs = load_under(cuda_a)
    assert path == path_a and (miss, hit, runs) == (0, 1, 0)
    assert snap()["compile_cache_saved_us"] - before == int(
        _build.recorded_seconds(path_a) * 1e6)


def test_install_loads_without_nvcc(tmp_path, monkeypatch):
    """The second tier's entry: a library's bytes laid down under a fresh
    root load with no ``nvcc``, its build seconds recorded; the set a
    Trainer stores is every kernel on a card and none on the CPU."""
    monkeypatch.setenv("CUDA_HOME", _fake_toolkit(tmp_path, "12.8, V12.8"))
    compilecache.configure(str(tmp_path / "cold"), register_feed=False)
    _build.load("flash_bwd")
    data = _build.library_path("flash_bwd").read_bytes()
    compilecache.configure(str(tmp_path / "warm"), register_feed=False)
    monkeypatch.setattr(_build, "_LOADED", {})
    runs = _build.nvcc_runs
    _build.install("flash_bwd", data, seconds=2.5)
    assert _build.loaded() == ["flash_bwd"] and _build.nvcc_runs == runs
    assert _build.library_path("flash_bwd").parent == \
        tmp_path / "warm" / "kernels"
    assert _build.recorded_seconds(_build.library_path("flash_bwd")) == 2.5
    assert compilecache.KernelSet.compile("cpu").names == ()


# -- the Trainer, cold then warm, beside the JAX Trainer ----------------------

@pytest.fixture(scope="module")
def flax_params():
    model = jax_transformer.build_transformer(**CFG, attention="full")
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(np.shape(x))
                   ).astype(np.float32), params)


def _tokens(seed, batch=BATCH):
    offs = np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                                (batch, 1))
    return ((np.arange(SEQ)[None] + offs) % CFG["vocab_size"]).astype(
        np.int32)


def _twice(loss):
    """An edited loss body: same shapes, another program."""
    def doubled(params, batch, mask):
        value, aux = loss(params, batch, mask)
        return value * 2.0, aux
    return doubled


class _Side(object):
    """One framework's Trainer factory over a store directory."""

    def __init__(self, jax_side, flax_params, store):
        self.jax_side = jax_side
        self.flax_params = flax_params
        self.store = store
        self.mesh = build_mesh() if jax_side else None
        # one loss object, as a restarted process re-creates the same code
        # (the JAX structural hash sees a new flax module's identity)
        if jax_side:
            # full attention: the Pallas kernels in interpret mode compile
            # for seconds a program, five programs here
            # (tests/test_torch_train.py holds the port's flash steps
            # against the JAX flash Trainer)
            self.loss = jax_transformer.loss_fn(
                jax_transformer.build_transformer(**CFG, attention="full"))
        else:
            self.loss = transformer.loss_fn(
                transformer.build_transformer(**CFG, attention="flash"))
        self.edited = _twice(self.loss)

    def trainer(self, lr=0.1, edited=False, version=None):
        loss = self.edited if edited else self.loss
        if self.jax_side:
            return jax_train.Trainer(
                loss, self.flax_params,
                optax.sgd(lr), mesh=self.mesh, batch_size=BATCH,
                step_flops_override=1, aot_cache=self.store,
                aot_program_version=version)
        return train.Trainer(
            loss,
            convert.transformer_params_from_flax(self.flax_params),
            functools.partial(torch.optim.SGD, lr=lr), batch_size=BATCH,
            device="cpu", aot_cache=self.store, aot_program_version=version)

    def step(self, tr, seed, batch=BATCH):
        tokens = _tokens(seed, batch)
        if self.jax_side:
            return tr.step(
                {"tokens": jax.device_put(tokens,
                                          batch_sharding(self.mesh, 1))},
                jax.device_put(np.ones(batch, np.float32),
                               batch_sharding(self.mesh)))
        return tr.step({"tokens": tokens})

    def params(self, tr):
        if self.jax_side:
            return jax.device_get(tr.state.params)
        return convert.transformer_params_to_flax(tr.state.params,
                                                  CFG["num_heads"])

    def run(self):
        """The constructions of ``tests/test_compilecache.py``'s Trainer
        tests in one sequence: cold, warm, a changed learning rate, an
        edited loss, a program version twice, then shape drift.  Returns
        the verdict stream, the fallbacks it counted, and the cold and
        warm params."""
        cc = jax_cc if self.jax_side else compilecache
        before = cc.stats.fallback
        verdicts, params = [], []
        for kwargs in ({}, {}, {"lr": 0.05}, {"edited": True},
                       {"version": "v2"}, {"version": "v2"}):
            tr = self.trainer(**kwargs)
            for seed in range(2):
                self.step(tr, seed)
            verdicts.append(tr._aot_verdicts.get("step"))
            if not kwargs:
                params.append(self.params(tr))
        assert tr._aot_exec.get("step") is not None
        self.step(tr, 9, batch=BATCH * 2)      # drifted: no crash
        verdicts.append(tr._aot_exec.get("step"))
        return verdicts, cc.stats.fallback - before, params


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_leaves(val, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree)}


def test_trainer_verdicts_and_weights_match_jax(flax_params, tmp_path):
    """The same sequence of constructions resolves the step program alike
    in both frameworks; the warm port run lands on the cold run's weights
    bit for bit, and on the JAX Trainer's within 1e-5."""
    jax_side = _Side(True, flax_params, str(tmp_path / "jax"))
    port = _Side(False, flax_params, str(tmp_path / "port"))
    want, want_fallbacks, want_params = jax_side.run()
    got, got_fallbacks, got_params = port.run()
    assert want == ["compiled", "loaded", "compiled", "compiled",
                    "compiled", "loaded", None]
    assert got == want and got_fallbacks == want_fallbacks == 3
    cold, warm = (_leaves(p) for p in got_params)
    for path, arr in cold.items():
        np.testing.assert_array_equal(warm[path], arr, err_msg=str(path))
    ref = _leaves(want_params[0])
    assert sorted(ref) == sorted(cold)
    for path, arr in ref.items():
        np.testing.assert_allclose(cold[path], arr, rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(path))


def test_trainer_programs_and_compile_time(flax_params, tmp_path):
    """``multi_<K>`` and ``repeat_<K>`` resolve like ``step``; the build or
    install time counts in ``train_compile_us_max``; without a store
    nothing resolves."""
    port = _Side(False, flax_params, str(tmp_path / "aot"))
    for expect in ("compiled", "loaded"):
        tr = port.trainer()
        tr.multi_step({"tokens": np.stack([_tokens(s) for s in (1, 2)])},
                      np.ones((2, BATCH), np.float32))
        tr.repeat_step({"tokens": _tokens(3)}, None, 2)
        assert tr._aot_verdicts == {"multi_2": expect, "repeat_2": expect}
        assert tr.counters_snapshot()["train_compile_us_max"] > 0
    assert sorted(os.listdir(str(tmp_path / "aot"))) == [
        "multi_2.aotx", "repeat_2.aotx"]
    plain = train.Trainer(
        transformer.loss_fn(transformer.build_transformer(
            **CFG, attention="flash")),
        convert.transformer_params_from_flax(flax_params),
        functools.partial(torch.optim.SGD, lr=0.1), device="cpu")
    plain.step({"tokens": _tokens(0)})
    assert plain._aot_verdicts == {} and plain._aot is None


class _Feed(object):
    def __init__(self, start, stop):
        self.start, self.stop = start, stop

    def batches(self):
        for i in range(self.start, self.stop):
            yield {"tokens": _tokens(100 + i)}, np.ones(BATCH, np.float32)


def test_fit_supervised_attaches_the_store(flax_params, tmp_path):
    """``fit_supervised`` puts the store beside a local checkpoint root
    (``checkpoint.aot_root``, the JAX package's ``aot_executables``): a
    second supervisor over the same root resumes there and loads; an
    explicit store is kept."""
    port = _Side(False, flax_params, None)
    root = str(tmp_path / "ckpt")
    assert checkpoint.aot_root(root) == os.path.join(root, "aot_executables")
    for expect, steps in (("compiled", 3), ("loaded", 5)):
        tr = port.trainer()
        ckpt = checkpoint.CheckpointManager(root, save_interval_steps=1)
        try:
            train.fit_supervised(
                tr, lambda: _Feed(int(tr.state.step), 5), ckpt,
                max_steps=steps)
        finally:
            ckpt.close()
        assert tr._aot.directory == checkpoint.aot_root(root)
        assert tr._aot_verdicts == {"step": expect}
        assert int(tr.state.step) == steps
    mine = str(tmp_path / "mine")
    tr = port.trainer()
    tr.set_aot_cache(mine)
    ckpt = checkpoint.CheckpointManager(str(tmp_path / "c2"))
    try:
        train.fit_supervised(tr, lambda: _Feed(0, 1), ckpt)
    finally:
        ckpt.close()
    assert tr._aot.directory == mine
    assert os.path.exists(os.path.join(mine, "step.aotx"))
    shutil.rmtree(mine)
