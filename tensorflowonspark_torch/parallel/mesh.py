"""Device mesh of the port (the counterpart of
:mod:`tensorflowonspark_tpu.parallel.mesh`): the ``torch.distributed``
world, one process per card, arranged as a named
:class:`~torch.distributed.device_mesh.DeviceMesh`.  Standard axis names,
as in the JAX package:

- ``"data"``    — batch (data parallel; gradients all-reduced)
- ``"fsdp"``    — parameter and optimizer-state sharding combined with data
  parallelism (:mod:`~tensorflowonspark_torch.parallel.fsdp`)
- ``"seq"``     — sequence parallelism (ring and Ulysses attention,
  :mod:`~tensorflowonspark_torch.parallel.ring`)
- ``"tensor"``, ``"expert"``, ``"pipe"`` — tensor, expert and pipeline
  parallelism, which the port does not run yet (ROADMAP.md, item J2)

Ranks are laid out row-major in :data:`AXIS_ORDER`, so the ranks of one
``seq`` group are adjacent (on one host, NVLink neighbours).  The mesh
spans the whole world: NCCL on the card, gloo on the CPU.

The JAX module's ``enforce_env_platforms`` (the ``JAX_PLATFORMS`` guard) and
``scan_batch_sharding`` (the sharding of a ``lax.scan`` group) are jax-only
and have no counterpart: a torch process picks its device explicitly, and a
K-step group is a stack of local batches.
"""

import dataclasses
import logging
import math

import torch.distributed as dist

from tensorflowonspark_torch.device import resolve_device

logger = logging.getLogger(__name__)

AXIS_ORDER = ("pipe", "data", "fsdp", "seq", "expert", "tensor")

#: the axes whose coordinates carry distinct rows of the global batch
BATCH_AXES = ("data", "fsdp")


@dataclasses.dataclass
class MeshSpec:
    """Logical mesh shape; -1 for at most one axis means "fill with the
    remaining devices" (like a reshape wildcard).

    The default (``data=-1``) is pure sync data parallelism."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    def resolve(self, num_devices):
        sizes = {axis: getattr(self, axis) for axis in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        assert len(wild) <= 1, "at most one mesh axis may be -1, got {}".format(wild)
        known = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            assert num_devices % known == 0, (
                "cannot fill axis {!r}: {} devices not divisible by {}".format(
                    wild[0], num_devices, known))
            sizes[wild[0]] = num_devices // known
        total = math.prod(sizes.values())
        assert total == num_devices, (
            "mesh {} uses {} devices but {} are available".format(
                sizes, total, num_devices))
        return sizes


def _ensure_world(device):
    """The ``torch.distributed`` world to build a mesh over: the initialized
    one, or else a world of this one process (NCCL on a card, gloo on the
    CPU), as a JAX process alone sees its own devices."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    logger.info("initialized a one-process %s world for the mesh", backend)


def build_mesh(spec=None, keep_trivial_axes=False, device=None):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` over every
    process of the world, one card each.

    Args:
      spec: a :class:`MeshSpec`, a ``{axis: size}`` dict, or None (pure DP).
      keep_trivial_axes: keep size-1 axes in the mesh (code that names an
        axis then finds it); otherwise they are dropped, and a mesh with no
        axis left is ``("data",)``.
      device: ``"cuda"`` by default (this process's current card, NCCL);
        ``"cpu"`` only when asked (gloo).

    Without an initialized world it initializes one of this process alone.
    A collective call: every rank of the world calls it, with the same
    arguments."""
    device = resolve_device(device)
    _ensure_world(device)
    if spec is None:
        spec = MeshSpec()
    elif isinstance(spec, dict):
        spec = MeshSpec(**spec)
    sizes = spec.resolve(dist.get_world_size())
    axes = [a for a in AXIS_ORDER if keep_trivial_axes or sizes[a] > 1]
    if not axes:
        axes = ["data"]
    shape = tuple(sizes[a] for a in axes)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device.type, shape, mesh_dim_names=tuple(axes))
    logger.info("built mesh %s over %d %s processes",
                dict(zip(axes, shape)), dist.get_world_size(), device.type)
    return mesh


def axis_size(mesh, axis):
    """The size of ``axis`` in ``mesh``: 1 when the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def batch_sharding(mesh, extra_dims=0):
    """The placements of a batch on ``mesh``: the leading (row) dim sharded
    over every data-like axis present (``data`` and ``fsdp``), replicated
    over the rest; the JAX ``NamedSharding(mesh, P(batch_axes))``.
    ``extra_dims`` is the JAX signature's (trailing dims are unsharded
    either way)."""
    from torch.distributed.tensor import Replicate, Shard

    del extra_dims
    return tuple(Shard(0) if a in BATCH_AXES else Replicate()
                 for a in mesh.mesh_dim_names)


def replicated(mesh):
    """Fully replicated placements on ``mesh``."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def row_shard(mesh):
    """``(index, count)`` of this process's block of global-batch rows: its
    row-major coordinate over the data-like axes of ``mesh`` and their
    product.  The ranks of one ``seq`` group share a block."""
    index, count = 0, 1
    for axis in mesh.mesh_dim_names:
        if axis in BATCH_AXES:
            index = index * axis_size(mesh, axis) + mesh.get_local_rank(axis)
            count *= axis_size(mesh, axis)
    return index, count


def local_batch_size(mesh, global_batch_size):
    """This process's share of a globally-sharded batch dimension: what
    its feed assembles each step (a ``seq`` group then pools its members'
    rows, see :class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed`)."""
    total = row_shard(mesh)[1]
    assert global_batch_size % total == 0, (
        "global batch {} not divisible by data-parallel degree {}".format(
            global_batch_size, total))
    procs = dist.get_world_size()
    assert global_batch_size % procs == 0, (
        "global batch {} not divisible by process count {}; each host "
        "contributes an equal local shard".format(global_batch_size, procs))
    return global_batch_size // procs


def group(mesh, axis):
    """The process group of ``axis`` that holds this process, or None when
    the axis is absent or of size 1 (nothing to communicate)."""
    if axis_size(mesh, axis) <= 1:
        return None
    return mesh.get_group(axis)


def unsupported_axes(mesh):
    """``{axis: size}`` of the axes above 1 that the port does not run yet
    (``tensor``, ``expert``, ``pipe``)."""
    return {a: axis_size(mesh, a) for a in ("tensor", "expert", "pipe")
            if axis_size(mesh, a) > 1}

