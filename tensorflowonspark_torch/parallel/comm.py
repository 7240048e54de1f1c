"""Differentiable device collectives over a process group: the hops of
tensor, expert and pipeline parallelism and of MoE under ``seq``.

Each is an ``autograd.Function`` whose backward is the adjoint collective
(an all-gather's is a reduce-scatter, an all-to-all's the reverse
all-to-all, an all-reduce's an all-reduce).  So the gradient each rank's
backward leaves is its share of the gradient of the SUM of every rank's
loss, the one program that JAX's ``shard_map`` differentiates: ranks that
repeat one another's work each carry a 1/n share of the loss (the
Trainer's row count makes it so), and a leaf's gradient is the sum of its
ranks' shares.

Buffers are flat and rank-major, as gloo's ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` want them, and fresh on every call, so a CUDA
graph captures the calls.  A ``group`` of None is a group of one: every
function returns its input."""

import torch
import torch.distributed as dist


def _size(group):
    return 1 if group is None else dist.get_world_size(group)


def _gather(x, group, dim):
    n = _size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().view(-1), group=group)
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).flatten(
        dim, dim + 1).contiguous()


def _scatter(x, group, dim):
    n = _size(group)
    blocks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, blocks.contiguous().view(-1),
                               group=group)
    return out.view(blocks.shape[1:])


def _reduce(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _scatter(grad, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group), None


def _exchange(x, group, split_dim, concat_dim):
    """``all_to_all_single``: block r of ``split_dim`` goes to rank r, and
    the blocks received are concatenated along ``concat_dim`` in rank
    order."""
    n = _size(group)
    slots = x.unflatten(split_dim, (n, x.shape[split_dim] // n)).movedim(
        split_dim, 0).contiguous()
    got = torch.empty_like(slots)
    dist.all_to_all_single(got, slots, group=group)
    return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1) \
        .contiguous()


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split, ctx.concat = group, split_dim, concat_dim
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return (_exchange(grad, ctx.group, ctx.concat, ctx.split), None,
                None, None)


def all_gather(x, group, dim=0):
    """The group's ``x`` concatenated along ``dim`` in rank order."""
    return x if group is None else _AllGather.apply(x, group, dim)


def reduce_scatter(x, group, dim=0):
    """The group's sum of ``x``, block ``rank`` of ``dim``."""
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def all_reduce(x, group):
    """The group's sum of ``x``."""
    return x if group is None else _AllReduce.apply(x, group)


def pmean(x, group):
    """The group's mean of ``x`` (JAX ``lax.pmean``)."""
    return x if group is None else _AllReduce.apply(x, group) / _size(group)


def all_to_all(x, group, split_dim, concat_dim):
    """JAX ``lax.all_to_all(..., tiled=True)``: ``x`` split along
    ``split_dim`` into one block per rank, block r sent to rank r, and the
    received blocks concatenated along ``concat_dim``."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)
