"""The port's parallelism layer against the JAX package's on the CPU: the
mesh (its spec resolution, axes, shapes, placements and local batch),
the FSDP rule ``leaf_spec`` and ring and Ulysses attention, the JAX side on
its 8 virtual CPU devices (``tests/conftest.py``), the port in gloo worlds
of 2 and 4 processes (``tests/torch_world.run_world``).  The same numpy
inputs go to both; the port's ranks return their sequence chunks, which
the tests put together.  (The re-pointed cases of ``tests/test_parallel.py``:
``TestMesh``, ``TestRingAttention``, ``TestUlyssesAttention`` and
``TestFSDPStateSharding.test_leaf_spec_rule``.)

jax is imported inside the tests only: the spawned ranks import this module
to find their functions, and need none of it."""

import functools

import numpy as np
import pytest
import torch

from tensorflowonspark_torch.parallel import fsdp, mesh as mesh_mod, ring

from torch_world import run_world

# fp32 forward: 1e-5 of the largest output; gradients: 5e-4 of the largest
# gradient (the two frameworks sum the blocks and the softmax in another
# order; the ring's online softmax rescales as it goes)
OUT_TOL = 1e-5
GRAD_TOL = 5e-4
# bf16 inputs, fp32 arithmetic inside, bf16 out: a few bf16 ulps
BF16_TOL = 3e-2

SHAPE = (2, 16, 4, 8)   # [batch, seq, heads, head_dim], the JAX tests' _qkv


def _qkv(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _cotangent(shape=SHAPE):
    return np.random.default_rng(9).standard_normal(shape).astype(np.float32)


def _local(x, mesh):
    """This rank's block of a global ``[B, S, ...]`` array: its rows of the
    data-like axes and its chunk of the ``seq`` axis."""
    index, count = mesh_mod.row_shard(mesh)
    rows = x.shape[0] // count
    parts = mesh_mod.axis_size(mesh, "seq")
    chunk = x.shape[1] // parts
    r = mesh.get_local_rank("seq") if parts > 1 else 0
    return x[index * rows:(index + 1) * rows, r * chunk:(r + 1) * chunk]


def _assemble(blocks, spec, world):
    """Put the ranks' ``[B/rows, S/P, ...]`` blocks back into the global
    array (ranks row-major over data, then seq)."""
    parts = spec.get("seq", 1)
    groups = world // parts
    return np.concatenate(
        [np.concatenate(blocks[g * parts:(g + 1) * parts], axis=1)
         for g in range(groups)], axis=0)


def _attention_rank(rank, spec, cases):
    """Every attention case on this rank's blocks: outputs and the
    gradients of ``sum(out * cotangent)``, as numpy."""
    torch.set_num_threads(1)
    mesh = mesh_mod.build_mesh(spec, device="cpu")
    results = {}
    for key, (fn, kwargs, dtype) in cases.items():
        q, k, v = (torch.from_numpy(_local(x, mesh)).to(dtype)
                   .requires_grad_() for x in _qkv())
        out = getattr(ring, fn)(q, k, v, mesh, **kwargs)
        dout = torch.from_numpy(_local(_cotangent(), mesh)).to(dtype)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        results[key] = ([out.detach().float().numpy()]
                        + [g.float().numpy() for g in grads])
    try:
        q = torch.zeros(2, 4, 3, 8)
        ring.ulysses_attention(q, q, q, mesh)
        results["heads_error"] = None
    except AssertionError as err:
        results["heads_error"] = str(err)
    return results


# (mesh spec, world): the JAX tests' {"data": 2, "seq": 4} and {"seq": 8},
# on four processes
WORLDS = {"data2_seq2": ({"data": 2, "seq": 2}, 4),
          "seq4": ({"seq": 4}, 4)}

CASES = {
    ("ring", False): ("ring_attention", {"causal": False}, torch.float32),
    ("ring", True): ("ring_attention", {"causal": True}, torch.float32),
    ("ulysses", False): ("ulysses_attention", {"causal": False},
                         torch.float32),
    ("ulysses", True): ("ulysses_attention", {"causal": True},
                        torch.float32),
    ("ulysses_flash", True): ("ulysses_attention",
                              {"causal": True, "impl": "flash"},
                              torch.float32),
    ("ring_bf16", False): ("ring_attention", {"causal": False},
                           torch.bfloat16),
}


@pytest.fixture(scope="module")
def port_attention():
    """``{world name: {case: global [out, dq, dk, dv]}}`` from the port's
    gloo worlds, and each world's Ulysses head-count error."""
    got = {}
    for name, (spec, world) in WORLDS.items():
        ranks = run_world(_attention_rank, world, spec, CASES)
        got[name] = {key: [_assemble([r[key][i] for r in ranks], spec, world)
                           for i in range(4)] for key in CASES}
        got[name]["heads_error"] = ranks[0]["heads_error"]
    return got


@functools.lru_cache(maxsize=None)
def _jax_attention(fn, causal, dtype="float32"):
    """The JAX package's output and ``jax.grad`` of ``sum(out *
    cotangent)`` on its virtual devices, a ``{"data": 2, "seq": 4}`` mesh
    (the global result does not depend on the mesh; the JAX Ulysses needs
    its heads divisible by the seq axis)."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.parallel import build_mesh
    from tensorflowonspark_tpu.parallel import ring as jax_ring

    mesh = build_mesh({"data": 2, "seq": 4})
    q, k, v = (jnp.asarray(x, dtype) for x in _qkv())
    ct = jnp.asarray(_cotangent(), dtype)

    def f(q, k, v):
        out = getattr(jax_ring, fn)(q, k, v, mesh, causal=causal)
        return (out.astype(jnp.float32) * ct.astype(jnp.float32)).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(out, np.float32)] + [np.asarray(g, np.float32)
                                            for g in grads]


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(port_attention, world, causal):
    """``TestRingAttention.test_matches_full_attention`` and
    ``test_full_seq_axis``, forward and gradients."""
    want = _jax_attention("ring_attention", causal)
    got = port_attention[world][("ring", causal)]
    tols = [OUT_TOL] + [GRAD_TOL] * 3
    for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want, tols):
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), name


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(port_attention, world, causal):
    """``TestUlyssesAttention.test_matches_full_attention``: the two
    all-to-alls and the local einsum attention, forward and gradients."""
    want = _jax_attention("ulysses_attention", causal)
    got = port_attention[world][("ulysses", causal)]
    tols = [OUT_TOL] + [GRAD_TOL] * 3
    for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want, tols):
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), name


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_ulysses_flash_matches_jax(port_attention, world):
    """``impl="flash"``: the port's flash op (its plain version on CPU
    tensors) inside the all-to-alls, against the JAX Ulysses (einsum: the
    JAX flash kernel's blocks need longer sequences; both are exact)."""
    want = _jax_attention("ulysses_attention", True)
    got = port_attention[world][("ulysses_flash", True)]
    tols = [OUT_TOL] + [GRAD_TOL] * 3
    for name, g, w, tol in zip(("out", "dq", "dk", "dv"), got, want, tols):
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), name


def test_ring_bf16_inputs(port_attention):
    """``TestRingAttention.test_bf16_inputs``: bf16 in, bf16 out."""
    want = _jax_attention("ring_attention", False, "bfloat16")
    got = port_attention["data2_seq2"][("ring_bf16", False)]
    assert np.abs(got[0] - want[0]).max() <= BF16_TOL * np.abs(want[0]).max()
    assert np.isfinite(got[1]).all()


def test_ulysses_head_divisibility_enforced(port_attention):
    """``TestUlyssesAttention.test_head_divisibility_enforced``: 3 heads
    over a seq axis of 2 and of 4."""
    for world in WORLDS:
        assert "heads 3" in port_attention[world]["heads_error"]


@pytest.mark.parametrize("causal", [False, True])
def test_chained_ring_equals_full_attention(causal):
    """The ring recurrence at P = 4 chunks in one process (what
    ``chip_smoke.py`` chains on the card), forward and backward, against
    the plain contraction."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv())
    ct = torch.from_numpy(_cotangent())
    want = ring.reference_attention(q, k, v, causal=causal)
    want_g = torch.autograd.grad(want, (q, k, v), ct)
    got = ring.chained_ring_attention(q, k, v, 4, causal=causal)
    got_g = torch.autograd.grad(got, (q, k, v), ct)
    assert (got - want).abs().max() <= OUT_TOL * want.abs().max()
    for g, w in zip(got_g, want_g):
        assert (g - w).abs().max() <= GRAD_TOL * w.abs().max()


def _mesh_rank(rank):
    """The meshes of ``TestMesh`` in a world of four processes: names,
    shapes, placements, row shards and local batches."""
    out = {}
    for key, spec in (("default", None), ("wild", {"data": -1, "tensor": 2}),
                      ("dict", {"data": 2, "seq": 2}),
                      ("kept", {"fsdp": 2, "seq": 2})):
        m = mesh_mod.build_mesh(spec, keep_trivial_axes=key == "kept",
                                device="cpu")
        out[key] = {"names": tuple(m.mesh_dim_names),
                    "shape": tuple(m.shape),
                    "placements": [type(p).__name__ for p in
                                   mesh_mod.batch_sharding(m)],
                    "replicated": [type(p).__name__ for p in
                                   mesh_mod.replicated(m)],
                    "row_shard": mesh_mod.row_shard(m),
                    "local_batch": mesh_mod.local_batch_size(m, 64)}
    try:
        mesh_mod.build_mesh({"data": 3}, device="cpu")
        out["mismatch"] = None
    except AssertionError as err:
        out["mismatch"] = str(err)
    m = mesh_mod.build_mesh({"fsdp": 4}, device="cpu")
    tree = {"w": torch.arange(512 * 128.0).reshape(512, 128),
            "b": torch.zeros(128)}
    shards = fsdp.shard_tree(tree, m)
    out["shards"] = {k: (tuple(v.shape), v.flatten()[0].item())
                     for k, v in shards.items()}
    return out


@pytest.fixture(scope="module")
def port_meshes():
    return run_world(_mesh_rank, 4)


@pytest.mark.parametrize("spec", [
    None, {"data": -1, "tensor": 2}, {"data": 2, "seq": 4},
    {"data": 2, "fsdp": 2, "seq": 2}, {"fsdp": -1, "seq": 2},
    {"pipe": 2, "data": -1}])
def test_mesh_spec_resolves_as_jax(spec):
    """``MeshSpec.resolve`` gives the JAX package's sizes at 8 and 4
    devices, and refuses what it refuses."""
    from tensorflowonspark_tpu.parallel import MeshSpec as JaxSpec

    for n in (8, 4):
        try:
            want = JaxSpec(**(spec or {})).resolve(n)
        except AssertionError:
            with pytest.raises(AssertionError):
                mesh_mod.MeshSpec(**(spec or {})).resolve(n)
            continue
        assert mesh_mod.MeshSpec(**(spec or {})).resolve(n) == want
    assert mesh_mod.AXIS_ORDER == ("pipe", "data", "fsdp", "seq", "expert",
                                   "tensor")


@pytest.mark.parametrize("key,spec,keep", [
    ("default", None, False), ("wild", {"data": -1, "tensor": 2}, False),
    ("dict", {"data": 2, "seq": 2}, False),
    ("kept", {"fsdp": 2, "seq": 2}, True)])
def test_mesh_axes_match_jax(port_meshes, key, spec, keep):
    """``TestMesh``: the default is pure DP, a wildcard fills, size-1
    axes drop unless kept; the port's mesh over four processes has the
    axes and shape of the JAX mesh over four devices."""
    import jax

    from tensorflowonspark_tpu.parallel import build_mesh

    want = build_mesh(spec, devices=jax.devices()[:4],
                      keep_trivial_axes=keep)
    for rank in port_meshes:
        got = rank[key]
        assert got["names"] == tuple(want.axis_names)
        assert got["shape"] == tuple(want.devices.shape)


def test_batch_sharding_spreads_rows(port_meshes):
    """``TestMesh.test_batch_sharding_spreads_rows``: rows shard over data
    and fsdp, nothing else; every rank its own block of rows, a ``seq``
    group one block."""
    assert port_meshes[0]["default"]["placements"] == ["Shard"]
    assert port_meshes[0]["dict"]["placements"] == ["Shard", "Replicate"]
    # pipe, data, fsdp, seq, expert, tensor
    assert port_meshes[0]["kept"]["placements"] == [
        "Replicate", "Shard", "Shard", "Replicate", "Replicate",
        "Replicate"]
    assert port_meshes[0]["kept"]["replicated"] == ["Replicate"] * 6
    assert sorted(r["default"]["row_shard"] for r in port_meshes) == [
        (i, 4) for i in range(4)]
    assert [r["dict"]["row_shard"] for r in port_meshes] == [
        (0, 2), (0, 2), (1, 2), (1, 2)]


def test_local_batch_size_and_mismatch(port_meshes):
    """``TestMesh.test_local_batch_size_single_process`` and
    ``test_dict_spec_and_mismatch``: each of four processes feeds a
    quarter of the global batch; a mesh that does not use the world
    raises."""
    for rank in port_meshes:
        assert rank["default"]["local_batch"] == 16
        assert rank["kept"]["local_batch"] == 16
        assert "uses" in rank["mismatch"]


@pytest.mark.parametrize("shape,n,min_size", [
    ((512, 128), 4, 0), ((128, 512), 4, 0), ((513, 128), 4, 0),
    ((513, 127), 4, 0), ((64,), 4, 2 ** 14), ((), 4, 0),
    ((256, 256), 4, 0), ((32000, 1024), 4, 2 ** 14), ((1024,), 2, 0),
    ((1024, 3072), 1, 0), ((4096, 1024), 4, 2 ** 14)])
def test_leaf_spec_matches_jax(shape, n, min_size):
    """``TestFSDPStateSharding.test_leaf_spec_rule``: the port's rule is
    the JAX package's, spec for spec (ties to the trailing dim)."""
    from tensorflowonspark_tpu.parallel import fsdp as jax_fsdp

    want = tuple(jax_fsdp.leaf_spec(shape, n, min_size=min_size))
    assert fsdp.leaf_spec(shape, n, min_size=min_size) == want


def test_shard_tree_keeps_each_ranks_block(port_meshes):
    """``TestFSDPStateSharding.test_state_shards_and_memory_drops``'s
    layout: the big leaf splits its largest dim over fsdp 4, rank r its
    r-th block; the small bias stays whole."""
    for rank, got in enumerate(port_meshes):
        assert got["shards"]["w"] == ((128, 128), float(rank * 128 * 128))
        assert got["shards"]["b"] == ((128,), 0.0)
