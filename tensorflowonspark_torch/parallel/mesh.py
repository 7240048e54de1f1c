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
- ``"tensor"``   — tensor parallelism (:mod:`~tensorflowonspark_torch.parallel.tp`)
- ``"expert"``   — expert parallelism (:mod:`~tensorflowonspark_torch.parallel.ep`)
- ``"pipe"``     — pipeline parallelism (:mod:`~tensorflowonspark_torch.parallel.pp`)

Ranks are laid out row-major in :data:`AXIS_ORDER`, so the ranks of one
``seq`` group are adjacent (on one host, NVLink neighbours).  The mesh
spans the whole world: NCCL on the card, gloo on the CPU.

A :class:`Placement` is the port's ``NamedSharding`` of one leaf: the mesh
axis, if any, that shards one dim of it.  The sharding trees of
:mod:`~tensorflowonspark_torch.parallel.tp`,
:mod:`~tensorflowonspark_torch.parallel.ep` and
:mod:`~tensorflowonspark_torch.parallel.pp` are ``{name: Placement}``
dicts, which ``Trainer(param_sharding=...)`` lays the state out by.

Only the ``batch_axes`` (``BATCH_AXES`` unless a caller adds one, as JAX
``batch_sharding``'s caller may) carry distinct rows of the global batch;
the ranks that differ only in the other axes hold the same rows
(:func:`pooled_axes`).

The JAX module's ``enforce_env_platforms`` (the ``JAX_PLATFORMS`` guard) and
``scan_batch_sharding`` (the sharding of a ``lax.scan`` group) are jax-only
and have no counterpart: a torch process picks its device explicitly, and a
K-step group is a stack of local batches.
"""

import dataclasses
import logging
import math
from typing import Optional

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


def _batch_axes(batch_axes):
    if batch_axes is None:
        return BATCH_AXES
    if isinstance(batch_axes, str):
        return (batch_axes,)
    return tuple(batch_axes)


def batch_axes_of(mesh, batch_axes=None):
    """The axes of ``mesh`` that carry distinct rows under ``batch_axes``
    (``BATCH_AXES`` when None), in the mesh's order: the one answer the
    model, the Trainer and the feed must share."""
    axes = _batch_axes(batch_axes)
    return tuple(a for a in (mesh.mesh_dim_names or ()) if a in axes)


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


def row_shard(mesh, batch_axes=None):
    """``(index, count)`` of this process's block of global-batch rows: its
    row-major coordinate over the batch axes of ``mesh`` (``BATCH_AXES``
    unless ``batch_axes`` names others) and their product.  The ranks of
    one :func:`pooled_axes` group share a block."""
    axes = _batch_axes(batch_axes)
    index, count = 0, 1
    for axis in mesh.mesh_dim_names:
        if axis in axes:
            index = index * axis_size(mesh, axis) + mesh.get_local_rank(axis)
            count *= axis_size(mesh, axis)
    return index, count


def local_batch_size(mesh, global_batch_size, batch_axes=None):
    """This process's share of a globally-sharded batch dimension: what
    its feed assembles each step (the :func:`pooled_axes` group then pools
    its members' rows, see
    :class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed`)."""
    total = row_shard(mesh, batch_axes)[1]
    assert global_batch_size % total == 0, (
        "global batch {} not divisible by data-parallel degree {}".format(
            global_batch_size, total))
    procs = dist.get_world_size()
    assert global_batch_size % procs == 0, (
        "global batch {} not divisible by process count {}; each host "
        "contributes an equal local shard".format(global_batch_size, procs))
    return global_batch_size // procs


def pooled_axes(mesh, batch_axes=None):
    """The axes above 1 that are not batch axes: the ranks that differ only
    in them hold the same rows (each its chunk of the sequence under
    ``seq``; the same rows and work under ``tensor``, ``pipe``, and
    ``expert`` when it is not a batch axis)."""
    axes = _batch_axes(batch_axes)
    return tuple(a for a in mesh.mesh_dim_names
                 if a not in axes and axis_size(mesh, a) > 1)


def group(mesh, axis):
    """The process group of ``axis`` that holds this process, or None when
    the axis is absent or of size 1 (nothing to communicate)."""
    if axis_size(mesh, axis) <= 1:
        return None
    return mesh.get_group(axis)


def groups(mesh, axes):
    """The process group of the ranks that differ from this process only in
    ``axes`` (their coordinates on every other axis equal), or None when
    those axes hold one rank.  A collective call the first time for a set
    of axes (every rank builds every such group, in the same order); cached
    on the mesh after that."""
    axes = tuple(a for a in mesh.mesh_dim_names
                 if a in axes and axis_size(mesh, a) > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_tfos_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        inner = [names.index(a) for a in axes]
        outer = [d for d in range(len(names)) if d not in inner]
        size = math.prod(axis_size(mesh, a) for a in axes)
        ranks = mesh.mesh.permute(outer + inner).reshape(-1, size).tolist()
        me = dist.get_rank()
        for members in ranks:
            made = dist.new_group(members)
            if me in members:
                cache[axes] = made
    return cache[axes]


def complement(mesh, axes):
    """The mesh's axes above 1 that are not in ``axes``."""
    return tuple(a for a in mesh.mesh_dim_names
                 if a not in axes and axis_size(mesh, a) > 1)


@dataclasses.dataclass(frozen=True)
class Placement(object):
    """Where one leaf lives on a mesh (the port's ``NamedSharding``): mesh
    ``axis`` shards dim ``dim`` of the leaf viewed as ``shape`` (a reshape
    of the tensor, for a leaf whose JAX counterpart has more dims than the
    port's, as the fused qkv projection; None: the tensor's own shape).
    ``axis`` None is replicated.  Rank ``r`` of the axis holds block ``r``
    of that dim.  ``local``: the model computes with the block itself (as
    the MoE layer with its E/ep experts), so the Trainer never gathers the
    leaf; otherwise the model reads the full leaf, gathered after every
    step."""

    axis: Optional[str] = None
    dim: Optional[int] = None
    shape: Optional[tuple] = None
    local: bool = False

    @property
    def sharded(self):
        return self.axis is not None

    def view(self, t):
        """``t`` as the shape the placement indexes."""
        return t if self.shape is None else t.view(self.shape)

    def blocks(self, t, n):
        """``t`` (full) as its ``[n, *block]`` blocks: a view, the sharded
        dim split and moved to the front."""
        v = self.view(t)
        return v.unflatten(self.dim, (n, v.shape[self.dim] // n)).movedim(
            self.dim, 0)

    def local_shape(self, shape, n):
        """The shape of one block of a leaf of ``shape``."""
        full = list(self.shape if self.shape is not None else shape)
        full[self.dim] //= n
        return tuple(full)

    def spec(self, ndim=None):
        """The JAX ``PartitionSpec`` as a tuple over :attr:`shape`'s dims
        (or ``ndim`` dims of the tensor's own shape); ``()`` replicated."""
        if not self.sharded:
            return ()
        spec = [None] * (len(self.shape) if self.shape is not None
                         else ndim)
        spec[self.dim] = self.axis
        return tuple(spec)


REPLICATED = Placement()


def as_placement(value):
    """A :class:`Placement` from a placement, None (replicated), or a
    ``PartitionSpec``-like tuple over the tensor's dims with at most one
    axis (what :func:`~tensorflowonspark_torch.parallel.fsdp.leaf_spec`
    returns)."""
    if isinstance(value, Placement):
        return value
    if value is None:
        return REPLICATED
    named = [(d, a) for d, a in enumerate(value) if a is not None]
    if not named:
        return REPLICATED
    if len(named) > 1:
        raise ValueError("a leaf shards over at most one mesh axis, "
                         "got {}".format(tuple(value)))
    return Placement(axis=named[0][1], dim=named[0][0])

