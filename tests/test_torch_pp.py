"""Pipeline parallelism of the port (``parallel/pp.py``) against the JAX
package on the CPU: ``tests/test_parallel.py``'s ``TestPipelineParallel``
re-pointed.  GPipe over pipe 2 and pipe 4 (and pipe 2 x data 2, the
gpipe dry run's mesh), the outputs and gradients against the sequential
stages and against JAX ``gpipe`` on its mesh of 8 virtual devices;
``split_microbatches``, ``stack_stage_params`` and ``stage_shardings``.

The port runs in a gloo world of 4 (``tests/torch_world.run_world``).  The
output is replicated over ``pipe``, so each pipe rank takes 1/S of the loss
(the sum over ranks is the one program's, see ``parallel/comm.py``), and a
gradient is the sum over the ranks: each stage's weights on their rank,
the microbatches' on stage 0."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tensorflowonspark_torch.parallel import mesh as mesh_mod
from tensorflowonspark_torch.parallel import pp

from torch_world import run_world

# test_parallel.py's sizes
D, N_MICRO, MB = 8, 6, 2
MESHES = {"pipe2": {"pipe": 2}, "pipe4": {"pipe": 4},
          "pipe2_data2": {"pipe": 2, "data": 2}}


def _setup(n_stages):
    rng = np.random.default_rng(0)
    stages = [{"w": rng.normal(0, 0.3, (D, D)).astype(np.float32),
               "b": rng.normal(0, 0.1, (D,)).astype(np.float32)}
              for _ in range(n_stages)]
    x = rng.normal(0, 1, (N_MICRO, MB, D)).astype(np.float32)
    return stages, x


def _stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _sequential(stacked, xs):
    h = xs
    for s in range(stacked["w"].shape[0]):
        h = _stage_fn({k: v[s] for k, v in stacked.items()}, h)
    return h


def _run(rank, key):
    torch.set_num_threads(1)
    spec = MESHES[key]
    mesh = mesh_mod.build_mesh(spec, keep_trivial_axes=True, device="cpu")
    n = spec["pipe"]
    stages, x = _setup(n)
    stacked = pp.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
    # this rank's [1, ...] block, as stage_shardings places it
    stage = mesh.get_local_rank("pipe")
    local = {k: v[stage:stage + 1].clone().requires_grad_(True)
             for k, v in stacked.items()}
    xs = torch.from_numpy(x).requires_grad_(True)
    out = pp.gpipe(_stage_fn, local, xs, mesh)
    # the output is replicated: every rank of the world takes its share
    ((out ** 2).sum() / dist.get_world_size()).backward()
    grad_x = xs.grad.clone()
    dist.all_reduce(grad_x)
    # each stage's gradient summed over the ranks holding that stage
    grads = {}
    for k, v in local.items():
        full = torch.zeros_like(stacked[k])
        full[stage] = v.grad[0]
        dist.all_reduce(full)
        grads[k] = full.numpy()
    return {"out": out.detach().numpy(), "grad_x": grad_x.numpy(),
            "grads": grads}


def _world4(rank):
    return {key: _run(rank, key) for key in MESHES
            if np.prod(list(MESHES[key].values())) == 4}


def _world2(rank):
    return {"pipe2": _run(rank, "pipe2")}


@pytest.fixture(scope="module")
def worlds():
    got = {}
    for ranks in (run_world(_world2, 2), run_world(_world4, 4)):
        for rank in ranks:
            for key, value in rank.items():
                got.setdefault(key, []).append(value)
    return got


@functools.lru_cache(maxsize=None)
def _jax_gpipe(n_stages):
    """JAX ``gpipe`` on a pipe mesh of the first ``n_stages`` devices: the
    outputs and the gradients of ``sum(out**2)`` for the stacked params
    and the microbatches."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.parallel import build_mesh
    from tensorflowonspark_tpu.parallel import pp as jax_pp

    stages, x = _setup(n_stages)
    stacked = jax_pp.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in stages])
    mesh = build_mesh({"pipe": n_stages}, devices=jax.devices()[:n_stages],
                      keep_trivial_axes=True)

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def loss(p, xs):
        return (jax_pp.gpipe(stage_fn, p, xs, mesh) ** 2).sum()

    stacked = jax.device_put(stacked, jax_pp.stage_shardings(stacked, mesh))
    with mesh:
        out = jax.jit(lambda p, xs: jax_pp.gpipe(stage_fn, p, xs, mesh))(
            stacked, jnp.asarray(x))
        g_p, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            stacked, jnp.asarray(x))
    return (np.asarray(out), {k: np.asarray(v) for k, v in g_p.items()},
            np.asarray(g_x))


def _sequential_reference(n_stages):
    stages, x = _setup(n_stages)
    stacked = pp.stack_stage_params(
        [{k: torch.from_numpy(v).requires_grad_(True) for k, v in s.items()}
         for s in stages])
    leaves = {k: v.detach().requires_grad_(True) for k, v in stacked.items()}
    xs = torch.from_numpy(x).requires_grad_(True)
    out = _sequential(leaves, xs)
    (out ** 2).sum().backward()
    return (out.detach().numpy(), {k: v.grad.numpy() for k, v in
                                   leaves.items()}, xs.grad.numpy())


@pytest.mark.parametrize("key", sorted(MESHES))
def test_matches_sequential(worlds, key):
    """``test_matches_sequential``: the pipeline's outputs on every rank
    are the stages applied in order."""
    want, _, _ = _sequential_reference(MESHES[key]["pipe"])
    for rank in worlds[key]:
        np.testing.assert_allclose(rank["out"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", sorted(MESHES))
def test_gradients_match_sequential(worlds, key):
    """``test_gradients_match_sequential``: each stage's weight gradients
    and the microbatches' are the sequential stages'."""
    _, want, want_x = _sequential_reference(MESHES[key]["pipe"])
    for rank in worlds[key]:
        for k in ("w", "b"):
            np.testing.assert_allclose(rank["grads"][k], want[k], rtol=1e-4,
                                       atol=1e-4)
        np.testing.assert_allclose(rank["grad_x"], want_x, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_matches_jax_gpipe(worlds, n_stages):
    """Against JAX ``gpipe`` on pipe 2 and 4: the outputs, the stacked
    params' gradients and the microbatches' (the JAX side's single loss;
    the port's ranks each carry 1/world of it)."""
    out, g_p, g_x = _jax_gpipe(n_stages)
    for rank in worlds["pipe%d" % n_stages]:
        np.testing.assert_allclose(rank["out"], out, rtol=1e-5, atol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(rank["grads"][k], g_p[k], rtol=1e-4,
                                       atol=1e-4)
        np.testing.assert_allclose(rank["grad_x"], g_x, rtol=1e-4,
                                   atol=1e-4)


def test_one_stage_is_a_sequential_map():
    """A pipe axis of 1 maps the stage over the microbatches (JAX's
    degenerate case), with no world needed."""
    stages, x = _setup(1)

    class _Mesh(object):
        mesh_dim_names = ("pipe",)

        def size(self, dim):
            return 1

    stacked = pp.stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in stages[0].items()}])
    got = pp.gpipe(_stage_fn, stacked, torch.from_numpy(x), _Mesh())
    want = _sequential(stacked, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_split_microbatches_and_stage_shardings():
    """``test_split_microbatches``: ``[12, 5] -> [4, 3, 5]``, an indivisible
    batch asserts; ``stage_shardings`` puts dim 0 on ``pipe``."""
    out = pp.split_microbatches({"x": torch.zeros(12, 5)}, 4)
    assert tuple(out["x"].shape) == (4, 3, 5)
    with pytest.raises(AssertionError):
        pp.split_microbatches({"x": torch.zeros(10, 2)}, 4)
    tree = pp.stage_shardings({"w": torch.zeros(2, 8, 8)}, None)
    assert tree["w"] == mesh_mod.Placement(axis="pipe", dim=0)
    assert tree["w"].spec(3) == ("pipe", None, None)
