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
"""

import logging
import math

import torch
import torch.distributed as dist

from tensorflowonspark_torch.parallel import mesh as mesh_mod

logger = logging.getLogger(__name__)

DEFAULT_MIN_SIZE = 2 ** 14  # leaves below 16k elements stay replicated


def _heuristic_dim(shape, n, allow_1d=False):
    """Largest ``n``-divisible dim, preferring the trailing dim on ties (the
    JAX package's ``tp._heuristic_dim``)."""
    if len(shape) < (1 if allow_1d else 2):
        return None
    dims = sorted(range(len(shape)), key=lambda d: (shape[d], d),
                  reverse=True)
    for d in dims:
        if shape[d] % n == 0 and shape[d] // n >= 1:
            return d
    return None


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
    """One rank's FSDP state for a name->tensor dict of full params.

    ``full`` keeps the dict's own tensors: the full params the loss reads,
    refilled in place by :meth:`gather`.  Every leaf that the rule shards
    also has a shard, a view into one flat buffer of this rank's shards
    (the all-gather reads it in place); :meth:`optimizer_params` lists, in
    the dict's order, the shard of a sharded leaf and the full tensor of a
    replicated one.  All sharded leaves share one dtype.  Raises
    ``ValueError`` when ``mesh`` has no ``axis``."""

    def __init__(self, full, mesh, axis="fsdp", min_size=DEFAULT_MIN_SIZE):
        specs = tree_shardings(full, mesh, axis, min_size)
        self.full = full
        self.n = mesh_mod.axis_size(mesh, axis)
        self.rank = mesh.get_local_rank(axis)
        self.group = mesh_mod.group(mesh, axis)
        # the other axes over which a shard's gradient still sums (data,
        # seq), one all-reduce each
        self.replica_groups = [mesh_mod.group(mesh, a)
                               for a in mesh.mesh_dim_names if a != axis
                               and mesh_mod.axis_size(mesh, a) > 1]
        self.dims = {name: spec.index(axis)
                     for name, spec in specs.items() if spec}
        self.names = list(self.dims)
        dtypes = {full[name].dtype for name in self.names}
        if len(dtypes) > 1:
            raise ValueError("fsdp shards leaves of one dtype, got {}".format(
                sorted(str(d) for d in dtypes)))
        sizes = [full[name].numel() // self.n for name in self.names]
        self.offsets = [sum(sizes[:i]) for i in range(len(sizes))]
        self.numel = sum(sizes)
        first = full[self.names[0]] if self.names else None
        self.flat = (torch.empty(self.numel, dtype=first.dtype,
                                 device=first.device) if first is not None
                     else None)
        self.shards = {}
        with torch.no_grad():
            for name, off, size in zip(self.names, self.offsets, sizes):
                t, d = full[name], self.dims[name]
                shape = list(t.shape)
                shape[d] //= self.n
                shard = self.flat[off:off + size].view(shape)
                shard.copy_(t.narrow(d, self.rank * shape[d], shape[d]))
                self.shards[name] = shard
        self._gathered = None   # the all-gather's output buffer (lazy)

    def optimizer_params(self):
        """The tensors the optimizer steps, in the dict's order."""
        return [self.shards.get(name, t) for name, t in self.full.items()]

    def _blocks(self, flat, name, off):
        """``flat`` (``[N * numel]``, rank-major) as the ``[N, *shard]``
        blocks of one leaf."""
        shard = self.shards[name]
        return flat.view(self.n, self.numel)[:, off:off + shard.numel()] \
            .unflatten(1, shard.shape)

    def _full_blocks(self, t, name):
        """The full tensor ``t`` of a leaf as its ``[N, *shard]`` blocks (a
        view: the sharded dim split and moved to the front)."""
        d = self.dims[name]
        return t.unflatten(d, (self.n, t.shape[d] // self.n)).movedim(d, 0)

    @torch.no_grad()
    def gather(self):
        """Rebuild the full params from every rank's shards, in place."""
        if not self.names:
            return
        if self._gathered is None:
            self._gathered = torch.empty(self.n * self.numel,
                                         dtype=self.flat.dtype,
                                         device=self.flat.device)
        dist.all_gather_into_tensor(self._gathered, self.flat,
                                    group=self.group)
        for name, off in zip(self.names, self.offsets):
            self._full_blocks(self.full[name], name).copy_(
                self._blocks(self._gathered, name, off))

    @torch.no_grad()
    def scatter_grads(self):
        """Sum the full params' gradients over the ``fsdp`` group into
        this rank's shards (each shard's ``.grad``, views of one flat
        buffer), then over the other axes of the mesh; the full params'
        gradients are dropped."""
        if not self.names:
            return
        packed = torch.empty(self.n * self.numel, dtype=self.flat.dtype,
                             device=self.flat.device)
        for name, off in zip(self.names, self.offsets):
            full = self.full[name]
            grad = full.grad if full.grad is not None else torch.zeros_like(
                full)   # a leaf the loss did not use
            self._blocks(packed, name, off).copy_(
                self._full_blocks(grad, name))
            full.grad = None
        flat_grad = torch.empty_like(self.flat)
        dist.reduce_scatter_tensor(flat_grad, packed, group=self.group)
        for group in self.replica_groups:
            dist.all_reduce(flat_grad, group=group)
        for name, off in zip(self.names, self.offsets):
            shard = self.shards[name]
            shard.grad = flat_grad[off:off + shard.numel()].view(shard.shape)

    def grad_sq_sum(self):
        """Σ of the squared shard gradients over the ``fsdp`` group: each
        sharded leaf's gradient counted once (a device scalar)."""
        grads = [self.shards[name].grad for name in self.names]
        total = torch.stack([g.float().square().sum() for g in grads]).sum()
        dist.all_reduce(total, group=self.group)
        return total

    # -- checkpoints: the optimizer state in the full, one-card format ----

    def full_optimizer_state(self, opt_state):
        """``opt_state`` (an ``optimizer.state_dict()`` over
        :meth:`optimizer_params`) with every shard-shaped state tensor of a
        sharded leaf all-gathered to the leaf's full shape: the state a
        one-card optimizer holds.  A collective call."""
        return self._map_state(opt_state, self.shards, self._gather_full)

    def local_optimizer_state(self, opt_state):
        """The inverse of :meth:`full_optimizer_state`: each full-shaped
        state tensor of a sharded leaf cut to this rank's shard."""
        return self._map_state(opt_state, self.full, self._local)

    def _map_state(self, opt_state, like, fn):
        """``opt_state`` with ``fn(name, t)`` in place of each state tensor
        ``t`` of a sharded leaf shaped as ``like[name]``; the optimizer's
        params are the dict's, in its order."""
        names = list(self.full)
        state = {}
        for i, entry in opt_state["state"].items():
            name = names[int(i)]
            state[i] = {key: (fn(name, value) if name in self.shards
                              and isinstance(value, torch.Tensor)
                              and value.shape == like[name].shape
                              else value)
                        for key, value in entry.items()}
        return dict(opt_state, state=state)

    def _gather_full(self, name, value):
        out = torch.empty(self.n * value.numel(), dtype=value.dtype,
                          device=value.device)
        dist.all_gather_into_tensor(out, value.contiguous().view(-1),
                                    group=self.group)
        d = self.dims[name]
        return out.view((self.n,) + tuple(value.shape)).movedim(0, d) \
            .flatten(d, d + 1)

    def _local(self, name, value):
        d = self.dims[name]
        size = value.shape[d] // self.n
        return value.narrow(d, self.rank * size, size)

    @torch.no_grad()
    def load_full(self, params):
        """Copy full params (a name->tensor dict) into the full buffers and
        this rank's shards, in place."""
        for name, t in self.full.items():
            t.copy_(params[name])
            if name in self.shards:
                self.shards[name].copy_(self._local(name, params[name]))
