"""FSDP: parameter and optimizer-state sharding over the ``fsdp`` mesh axis
(the counterpart of :mod:`tensorflowonspark_tpu.parallel.fsdp`).

The rule is the JAX package's, verbatim: each leaf shards its LARGEST
dimension divisible by the axis size (the trailing one on ties); leaves
smaller than ``min_size`` elements (biases, norm scales, scalars)
replicate.  Optimizer state mirrors the parameter shapes leaf by leaf, so
the same rule applies to it.

The JAX package annotates the shardings and lets XLA insert the
collectives.  The port's Trainer is functional (a name->tensor dict applied
through ``torch.func.functional_call``, its step captured as a CUDA graph),
so :class:`ShardedParams` writes the same recipe out with plain collectives
on fixed storage, which a CUDA graph captures:

- each rank keeps its shard of every sharded leaf, and the optimizer steps
  only the shards (its state is shard-shaped: per-card optimizer memory
  drops by the axis size);
- after each optimizer step, one ``all_gather_into_tensor`` over the
  ``fsdp`` group rebuilds the full params into the fixed buffers the loss
  reads;
- after the backward, one ``reduce_scatter_tensor`` sums the full
  gradients into shards.

Where the per-card memory differs from the JAX layout: the full params
stay resident between steps (a graph replays into fixed buffers), and the
backward writes full gradients before they are scattered; the shards, their
gradients and the optimizer state are 1/N.

:class:`ShardedParams` also holds any other sharding tree
(``{name: Placement}``, e.g. from
:func:`~tensorflowonspark_torch.parallel.tp.tp_param_shardings` or
:func:`~tensorflowonspark_torch.parallel.ep.merge_ep_shardings`): sharded
leaves are gathered as above, one group of flat buffers per axis, except
those whose placement is ``local`` (the MoE rule's expert leaves: the
layer computes with this rank's experts only), which stay as this rank's
blocks (their params in ``full`` are the blocks).
"""

import logging
import math

import torch
import torch.distributed as dist

from tensorflowonspark_torch.parallel import mesh as mesh_mod
from tensorflowonspark_torch.parallel.tp import _heuristic_dim

logger = logging.getLogger(__name__)

DEFAULT_MIN_SIZE = 2 ** 14  # leaves below 16k elements stay replicated


def leaf_spec(shape, axis_size, axis="fsdp", min_size=DEFAULT_MIN_SIZE):
    """The JAX ``PartitionSpec`` of one array shape, as a tuple: ``axis`` at
    the largest dim divisible by ``axis_size``, None elsewhere; ``()``
    (replicated) for a leaf too small or with no divisible dim."""
    if axis_size <= 1 or math.prod(shape or (1,)) < min_size:
        return ()
    d = _heuristic_dim(shape, axis_size, allow_1d=True)
    if d is None:
        return ()
    spec = [None] * len(shape)
    spec[d] = axis
    return tuple(spec)


def tree_shardings(tree, mesh, axis="fsdp", min_size=DEFAULT_MIN_SIZE):
    """``{name: spec}`` of a name->tensor dict under the rule (see
    :func:`leaf_spec`); raises ``ValueError`` when ``mesh`` has no
    ``axis``."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError("mesh has no {!r} axis (axes: {})".format(
            axis, names))
    n = mesh_mod.axis_size(mesh, axis)
    return {name: leaf_spec(tuple(t.shape), n, axis, min_size)
            for name, t in tree.items()}


def shard_tree(tree, mesh, axis="fsdp", min_size=DEFAULT_MIN_SIZE):
    """This rank's shard of every leaf of a name->tensor dict (a view of a
    sharded leaf, the leaf itself when replicated).  Logs the share of the
    elements that shards, as the JAX package does."""
    specs = tree_shardings(tree, mesh, axis, min_size)
    n = mesh_mod.axis_size(mesh, axis)
    rank = mesh.get_local_rank(axis)
    out = {}
    for name, t in tree.items():
        spec = specs[name]
        if spec:
            d = spec.index(axis)
            size = t.shape[d] // n
            out[name] = t.narrow(d, rank * size, size)
        else:
            out[name] = t
    total = sum(t.numel() for t in tree.values())
    sharded = sum(t.numel() for name, t in tree.items() if specs[name])
    if total:
        logger.info(
            "fsdp(x%d): %.1f%% of %d state elements sharded "
            "(per-device state ~%.2fx of replicated)", n,
            100.0 * sharded / total, total,
            (total - sharded + sharded / n) / total)
    return out


class ShardedParams(object):
    """One rank's sharded state for a name->tensor dict of full params.

    ``placements`` is ``{name: Placement}`` (a ``PartitionSpec``-like tuple
    or None are taken too); by default the FSDP rule over ``axis`` (see
    :func:`tree_shardings`).  Three kinds of leaf:

    - *gathered* (sharded, not ``local``): ``full`` keeps the dict's own
      tensor, the full param the loss reads, refilled in place
      by :meth:`gather`; its shard is a view into the axis's flat buffer of
      this rank's shards (the all-gather reads it in place);
    - *local* (a ``local`` placement): ``full`` holds this rank's block,
      which the loss reads and the optimizer steps;
    - replicated: ``full`` keeps the dict's tensor.

    :meth:`optimizer_params` lists, in the dict's order, the shard of a
    gathered leaf and ``full``'s tensor of the others.  The gathered leaves
    of one axis share one dtype.  Raises ``ValueError`` when a placement
    names an axis the mesh lacks or a dim that does not divide."""

    def __init__(self, full, mesh, axis="fsdp", min_size=DEFAULT_MIN_SIZE,
                 placements=None):
        if placements is None:
            placements = tree_shardings(full, mesh, axis, min_size)
        missing = [name for name in full if name not in placements]
        if missing:
            raise ValueError("the sharding tree has no placement for "
                             "{}".format(missing))
        names = mesh.mesh_dim_names or ()
        self.mesh = mesh
        self.placements = {}
        for name, t in full.items():
            p = mesh_mod.as_placement(placements[name])
            if p.sharded:
                if p.axis not in names:
                    raise ValueError("{}: mesh has no {!r} axis (axes: "
                                     "{})".format(name, p.axis, names))
                n = mesh_mod.axis_size(mesh, p.axis)
                size = tuple(p.shape if p.shape is not None else t.shape)
                if size[p.dim] % n:
                    raise ValueError(
                        "{} dim {} (size {}) not divisible by {}={}".format(
                            name, p.dim, size[p.dim], p.axis, n))
                if n == 1:
                    p = mesh_mod.REPLICATED
            self.placements[name] = p
        self.full = dict(full)
        self.local = {}    # name -> axis of a local leaf
        self.groups = {}   # axis -> _AxisShards of its gathered leaves
        by_axis = {}
        for name, p in self.placements.items():
            if not p.sharded:
                continue
            if p.local:
                self.local[name] = p.axis
            else:
                by_axis.setdefault(p.axis, []).append(name)
        for ax, leaves in by_axis.items():
            self.groups[ax] = _AxisShards(self, ax, leaves)
        with torch.no_grad():
            for name, ax in self.local.items():
                p, n = self.placements[name], mesh_mod.axis_size(mesh, ax)
                block = p.blocks(full[name], n)[mesh.get_local_rank(ax)]
                self.full[name] = block.contiguous().clone() \
                    .requires_grad_(full[name].requires_grad)
        # a local leaf's gradient still sums over the axes but its own
        # (groups built in one order on every rank)
        local_axes = sorted(set(self.local.values()))
        self._local_groups = {ax: mesh_mod.groups(
            mesh, mesh_mod.complement(mesh, (ax,))) for ax in local_axes}
        self._local_axis_groups = {ax: mesh_mod.group(mesh, ax)
                                   for ax in local_axes}

    @property
    def names(self):
        """The sharded leaves (gathered and local), in the dict's order."""
        return [name for name, p in self.placements.items() if p.sharded]

    @property
    def shards(self):
        """``{name: shard}`` of the gathered leaves."""
        out = {}
        for g in self.groups.values():
            out.update(g.shards)
        return out

    def optimizer_params(self):
        """The tensors the optimizer steps, in the dict's order."""
        shards = self.shards
        return [shards.get(name, t) for name, t in self.full.items()]

    @torch.no_grad()
    def gather(self):
        """Rebuild the full gathered params from every rank's shards, in
        place."""
        for g in self.groups.values():
            g.gather()

    @torch.no_grad()
    def scatter_grads(self):
        """Sum each gathered leaf's full gradient over its axis into this
        rank's shard (each shard's ``.grad``) and over the mesh's other
        axes; sum each local leaf's gradient over the axes but its own.
        Each axis's leaves go in one flat buffer and one collective per
        group."""
        for g in self.groups.values():
            g.scatter_grads()
        by_axis = {}
        for name, ax in self.local.items():
            by_axis.setdefault(ax, []).append(name)
        for ax, names in by_axis.items():
            group = self._local_groups[ax]
            if group is None:
                continue
            params = [self.full[name] for name in names]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            offset = 0
            for p in params:
                p.grad = flat[offset:offset + p.numel()].view_as(p)
                offset += p.numel()

    def grad_sq_sum(self):
        """Σ of the squared gradients of the sharded leaves over the mesh,
        each block counted once (a device scalar)."""
        total = None
        for g in self.groups.values():
            part = g.grad_sq_sum()
            total = part if total is None else total + part
        by_axis = {}
        for name, ax in self.local.items():
            grad = self.full[name].grad
            if grad is not None:
                by_axis.setdefault(ax, []).append(grad)
        for ax, grads in by_axis.items():
            part = torch.stack([g.float().square().sum()
                                for g in grads]).sum()
            group = self._local_axis_groups[ax]
            if group is not None:
                dist.all_reduce(part, group=group)
            total = part if total is None else total + part
        return total

    # -- checkpoints: the one-card format ----------------------------------

    def full_params(self):
        """The full params: the gathered and replicated leaves as they are,
        each local leaf all-gathered from its axis.  A collective call."""
        return {name: (self._gather_full(name, t) if name in self.local
                       else t) for name, t in self.full.items()}

    def full_optimizer_state(self, opt_state):
        """``opt_state`` (an ``optimizer.state_dict()`` over
        :meth:`optimizer_params`) with every block-shaped state tensor of a
        sharded leaf all-gathered to the leaf's full shape: the state a
        one-card optimizer holds.  A collective call."""
        return self._map_state(opt_state, self._block_shapes(),
                               self._gather_full)

    def local_optimizer_state(self, opt_state):
        """The inverse of :meth:`full_optimizer_state`: each full-shaped
        state tensor of a sharded leaf cut to this rank's block."""
        return self._map_state(opt_state, self._full_shapes(), self._local)

    def _block_shapes(self):
        shapes = {name: tuple(s.shape) for name, s in self.shards.items()}
        shapes.update({name: tuple(self.full[name].shape)
                       for name in self.local})
        return shapes

    def _full_shapes(self):
        return {name: self._full_shape(name) for name in self.names}

    def _full_shape(self, name):
        """The port's shape of the whole leaf ``name``."""
        if name not in self.local:
            return tuple(self.full[name].shape)
        p = self.placements[name]
        shape = list(self.full[name].shape)
        shape[p.dim] *= mesh_mod.axis_size(self.mesh, p.axis)
        return tuple(shape)

    def _map_state(self, opt_state, like, fn):
        """``opt_state`` with ``fn(name, t)`` in place of each state tensor
        ``t`` of a sharded leaf shaped ``like[name]``; the optimizer's
        params are the dict's, in its order."""
        names = list(self.full)
        state = {}
        for i, entry in opt_state["state"].items():
            name = names[int(i)]
            state[i] = {key: (fn(name, value) if name in like
                              and isinstance(value, torch.Tensor)
                              and tuple(value.shape) == like[name]
                              else value)
                        for key, value in entry.items()}
        return dict(opt_state, state=state)

    def _gather_full(self, name, value):
        """A block of leaf ``name`` (a shard, its optimizer state, or a
        local leaf) all-gathered over its axis to the leaf's full shape."""
        p = self.placements[name]
        n = mesh_mod.axis_size(self.mesh, p.axis)
        block = value.detach().contiguous()
        out = torch.empty(n * block.numel(), dtype=block.dtype,
                          device=block.device)
        dist.all_gather_into_tensor(out, block.view(-1),
                                    group=mesh_mod.group(self.mesh, p.axis))
        full = out.view((n,) + tuple(block.shape)).movedim(0, p.dim) \
            .flatten(p.dim, p.dim + 1)
        return full.reshape(self._full_shape(name))

    def _local(self, name, value):
        """This rank's block of a full-shaped tensor of leaf ``name``."""
        p = self.placements[name]
        return p.blocks(value.contiguous(), mesh_mod.axis_size(
            self.mesh, p.axis))[self.mesh.get_local_rank(p.axis)]

    @torch.no_grad()
    def load_full(self, params):
        """Copy full params (a name->tensor dict) into the full buffers,
        this rank's shards and its local blocks, in place."""
        shards = self.shards
        for name, t in self.full.items():
            if name in self.local:
                t.copy_(self._local(name, params[name]))
                continue
            t.copy_(params[name])
            if name in shards:
                shards[name].copy_(self._local(name, params[name]))


class _AxisShards(object):
    """The gathered leaves sharded over one mesh axis: this rank's shards,
    views into one flat buffer; the all-gather that refills the full
    params and the reduce-scatter that sums their gradients into the
    shards."""

    def __init__(self, owner, axis, names):
        mesh, full = owner.mesh, owner.full
        self.owner = owner
        self.axis = axis
        self.names = names
        self.n = mesh_mod.axis_size(mesh, axis)
        self.rank = mesh.get_local_rank(axis)
        self.group = mesh_mod.group(mesh, axis)
        # the other axes over which a shard's gradient still sums (data,
        # seq, tensor, ...): one all-reduce over their group
        self.replica_group = mesh_mod.groups(
            mesh, mesh_mod.complement(mesh, (axis,)))
        self.placements = {name: owner.placements[name] for name in names}
        dtypes = {full[name].dtype for name in names}
        if len(dtypes) > 1:
            raise ValueError(
                "the leaves sharded over {!r} must share one dtype, got "
                "{}".format(axis, sorted(str(d) for d in dtypes)))
        shapes = [self.placements[name].local_shape(full[name].shape,
                                                    self.n)
                  for name in names]
        sizes = [math.prod(shape) for shape in shapes]
        self.offsets = [sum(sizes[:i]) for i in range(len(sizes))]
        self.numel = sum(sizes)
        first = full[names[0]]
        self.flat = torch.empty(self.numel, dtype=first.dtype,
                                device=first.device)
        self.shards = {}
        with torch.no_grad():
            for name, off, size, shape in zip(names, self.offsets, sizes,
                                              shapes):
                shard = self.flat[off:off + size].view(shape)
                shard.copy_(self._full_blocks(full[name], name)[self.rank])
                self.shards[name] = shard
        self._gathered = None   # the all-gather's output buffer (lazy)

    def _blocks(self, flat, name, off):
        """``flat`` (``[N * numel]``, rank-major) as the ``[N, *shard]``
        blocks of one leaf."""
        shard = self.shards[name]
        return flat.view(self.n, self.numel)[:, off:off + shard.numel()] \
            .unflatten(1, shard.shape)

    def _full_blocks(self, t, name):
        """The full tensor ``t`` of a leaf as its ``[N, *shard]`` blocks (a
        view: the sharded dim split and moved to the front)."""
        return self.placements[name].blocks(t, self.n)

    def gather(self):
        if self._gathered is None:
            self._gathered = torch.empty(self.n * self.numel,
                                         dtype=self.flat.dtype,
                                         device=self.flat.device)
        dist.all_gather_into_tensor(self._gathered, self.flat,
                                    group=self.group)
        for name, off in zip(self.names, self.offsets):
            self._full_blocks(self.owner.full[name], name).copy_(
                self._blocks(self._gathered, name, off))

    def scatter_grads(self):
        packed = torch.empty(self.n * self.numel, dtype=self.flat.dtype,
                             device=self.flat.device)
        for name, off in zip(self.names, self.offsets):
            full = self.owner.full[name]
            grad = full.grad if full.grad is not None else torch.zeros_like(
                full)   # a leaf the loss did not use
            self._blocks(packed, name, off).copy_(
                self._full_blocks(grad, name))
            full.grad = None
        flat_grad = torch.empty_like(self.flat)
        dist.reduce_scatter_tensor(flat_grad, packed, group=self.group)
        if self.replica_group is not None:
            dist.all_reduce(flat_grad, group=self.replica_group)
        for name, off in zip(self.names, self.offsets):
            shard = self.shards[name]
            shard.grad = flat_grad[off:off + shard.numel()].view(shard.shape)

    def grad_sq_sum(self):
        grads = [self.shards[name].grad for name in self.names]
        total = torch.stack([g.float().square().sum() for g in grads]).sum()
        dist.all_reduce(total, group=self.group)
        return total
