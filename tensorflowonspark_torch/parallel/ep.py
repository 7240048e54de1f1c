"""Expert parallelism: the MoE FFN over the ``expert`` mesh axis (the port
of :mod:`tensorflowonspark_tpu.parallel.ep`).

Two paths, the same math:

1. ``ep_mode="gspmd"`` with the expert-stacked ``[E, ...]`` leaves of
   :class:`~tensorflowonspark_torch.models.transformer.MoEMlp` placed over
   ``expert`` (:func:`ep_param_shardings`, :func:`merge_ep_shardings`): each
   rank applies its E/ep experts to the rows it holds (its block of the
   dispatch tensor's E dim) and the partial combines are summed over the
   ``expert`` group, the dense products partitioned as XLA partitions them.

2. ``ep_mode="shard_map"`` (:func:`moe_ffn`): the DeepSpeed-MoE/GShard
   schedule written out, as JAX's ``shard_map`` body writes it:

       dispatch (local)                 [G_loc, E, C, D]
       all_to_all  split E, concat G -> [G,     E_loc, C, D]   # tokens->owners
       expert FFN  (local weights)      [G,     E_loc, C, D]
       all_to_all  split G, concat E -> [G_loc, E, C, D]       # results->home
       combine (local)

   Both hops are ``all_to_all_single`` inside ``autograd.Function``s whose
   backward is the reverse hop (:mod:`~tensorflowonspark_torch.parallel.comm`).

:func:`route` (and :func:`_route`, the dispatch tensors built from it) is
the routing of both paths and of the port's ``MoEMlp``: one function, so
the two modes cannot route differently.
"""

import dataclasses
import logging
import math
import re

import torch
import torch.nn.functional as F

from tensorflowonspark_torch.parallel import comm
from tensorflowonspark_torch.parallel import mesh as mesh_mod
from tensorflowonspark_torch.parallel import tp as tp_mod

logger = logging.getLogger(__name__)

# Expert-stacked parameter leaves of models.transformer.MoEMlp: leading dim
# is the expert dim for all four.
MOE_PARAM_RE = re.compile(r"(^|/)moe/(w1|w2|b1|b2)$")


def ep_param_shardings(params, mesh, axis="expert", pattern=MOE_PARAM_RE):
    """``{name: Placement}``: expert-stacked leaves (leading ``E`` dim)
    shard over ``axis``; everything else replicates on it (the rule engine
    of :func:`~tensorflowonspark_torch.parallel.tp.tp_param_shardings`
    with the MoE rule set).  The expert placements are ``local``: the MoE
    layer computes with this rank's E/ep experts, so the Trainer keeps the
    blocks and never gathers them."""
    pat = pattern.pattern if hasattr(pattern, "pattern") else pattern
    tree = tp_mod.tp_param_shardings(
        params, mesh, axis=axis, rules=[(pat, 0), ("", None)])
    return {name: (dataclasses.replace(p, local=True) if p.sharded else p)
            for name, p in tree.items()}


def merge_ep_shardings(base_shardings, params, mesh, axis="expert",
                       pattern=MOE_PARAM_RE):
    """Overlay expert parallelism on an existing sharding tree.

    ``base_shardings`` (placements, ``PartitionSpec``-like tuples such as
    :func:`~tensorflowonspark_torch.parallel.fsdp.tree_shardings` gives, or
    None) keeps every leaf EXCEPT the expert-stacked MoE weights, which take
    the ``axis``-on-dim-0 placement of :func:`ep_param_shardings`."""
    ep_tree = ep_param_shardings(params, mesh, axis=axis, pattern=pattern)
    pat = pattern if hasattr(pattern, "search") else re.compile(pattern)
    return {name: (ep_tree[name] if pat.search(tp_mod._param_path(name))
                   else mesh_mod.as_placement(base_shardings.get(name)))
            for name in params}


def router_logits(x, router_weight, router_bias):
    """The fp32 router: ``x`` cast to fp32 times the router weights, whatever
    the compute dtype (routing must not flip with bf16 rounding)."""
    return F.linear(x.float(), router_weight.float(), router_bias.float())


def route(logits, num_experts):
    """``(probs [G, S, E] fp32, expert_idx [G, S], expert_prob [G, S],
    pos [G, S])`` of the router's ``logits``: the softmax, each token's
    expert (the first most probable, as ``jnp.argmax`` picks) and its
    probability, and its 0-based position among the group's tokens routed
    to that expert."""
    probs = torch.softmax(logits, dim=-1)
    expert_prob, expert_idx = probs.max(dim=-1)
    experts = torch.arange(num_experts, device=logits.device)
    onehot = (expert_idx[..., None] == experts).long()
    # an integer cumsum: a low-precision one would saturate and give two
    # tokens one slot
    pos = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1
    return probs, expert_idx, expert_prob, pos


def _route(x, logits, num_experts, capacity):
    """Grouped top-1 routing of ``x`` by the router's ``logits``:
    ``(dispatch [G, S, E, C] in x's dtype, expert_prob [G, S], (fraction
    [E], mean_prob [E]))``, the last two the Switch load-balance
    ingredients (averaged by the caller)."""
    probs, expert_idx, expert_prob, pos = route(logits, num_experts)
    experts = torch.arange(num_experts, device=x.device)
    onehot = expert_idx[..., None] == experts                # [G, S, E]
    # a position past capacity matches no slot: the token is dropped
    # (jax.nn.one_hot's zero row; F.one_hot would raise)
    slot = pos[..., None] == torch.arange(capacity, device=x.device)
    dispatch = (onehot[..., None] & slot[:, :, None, :]).to(x.dtype)
    fraction = onehot.float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    return dispatch, expert_prob, (fraction, mean_prob)


def expert_ffn(expert_in, w1, b1, w2, b2, dtype):
    """The experts' FFN on ``[G, E_loc, C, D]`` tokens with their
    ``[E_loc, ...]`` weights, tanh gelu, in ``dtype``."""
    h = (torch.einsum("gecd,edh->gech", expert_in, w1.to(dtype))
         + b1.to(dtype)[:, None])
    h = F.gelu(h, approximate="tanh")
    return (torch.einsum("gech,ehd->gecd", h, w2.to(dtype))
            + b2.to(dtype)[:, None])


def local_experts(t, mesh, axis, num_experts):
    """This rank's ``[E/ep, ...]`` block of an expert-stacked leaf: ``t``
    itself when it holds E/ep experts (placed over ``axis``), block r of it
    when it holds all E (replicated)."""
    ep = mesh_mod.axis_size(mesh, axis)
    local = num_experts // ep
    if t.shape[0] == local:
        return t
    if t.shape[0] != num_experts:
        raise ValueError(
            "an expert leaf holds {} experts; expected {} (all) or {} (this "
            "rank's block over {}={})".format(t.shape[0], num_experts, local,
                                              axis, ep))
    return t.narrow(0, mesh.get_local_rank(axis) * local, local)


def _axes(batch_axes, axis):
    if batch_axes is None:
        return (axis,)
    if isinstance(batch_axes, str):
        return (batch_axes,)
    return tuple(batch_axes)


def moe_ffn(x, params, mesh, num_experts, capacity_factor=1.25,
            axis="expert", dtype=None, batch_axes=None):
    """Grouped top-1 MoE FFN with explicit expert parallelism.

    Args:
      x: ``[G, S, D]``, this rank's rows: its block of the group dim over
        the ``batch_axes`` that carry distinct rows.  The sequence is whole
        (routing's capacity cumsum runs over it).
      params: ``MoEMlp``'s leaves by its ``state_dict`` names:
        ``router.weight [E, D]``, ``router.bias [E]``, ``w1 [E, D, H]``,
        ``b1 [E, H]``, ``w2 [E, H, D]``, ``b2 [E, D]``; the four expert
        leaves whole or this rank's E/ep block.
      mesh: the device mesh; ``axis`` must be one of its axes.
      num_experts: E (divisible by the ``axis`` size).
      batch_axes: the mesh axes the group dim is sharded over (JAX's
        ``ep_batch_axes``), default ``(axis,)``.  ``axis`` is appended when
        absent: the ranks of the ``axis`` group then hold the same rows, and
        each routes its 1/ep block of them (G divisible by ep), the result
        all-gathered back, as ``shard_map`` re-lays out its input.

    Returns ``(y [G, S, D], aux)``, the Switch load balance from
    ``fraction`` and ``mean_prob`` averaged over ``batch_axes``.
    """
    given = _axes(batch_axes, axis)
    batch_axes = given if axis in given else given + (axis,)
    ep = mesh_mod.axis_size(mesh, axis)
    group_shards = math.prod(mesh_mod.axis_size(mesh, a) for a in batch_axes)
    assert num_experts % ep == 0, (
        "num_experts {} not divisible by expert axis size {}".format(
            num_experts, ep))
    split = axis not in given
    assert not split or x.shape[0] % ep == 0, (
        "group dim {} not divisible by the {} shards of batch_axes {} (the "
        "leading dim must shard over them)".format(
            x.shape[0] * group_shards // ep, group_shards, batch_axes))
    group = mesh_mod.group(mesh, axis)
    dtype = dtype or x.dtype
    seq = x.shape[1]
    capacity = max(int(capacity_factor * seq / num_experts), 1)
    xs = x
    if split and group is not None:
        rows = x.shape[0] // ep
        xs = x.narrow(0, mesh.get_local_rank(axis) * rows, rows)
    w1, b1, w2, b2 = (local_experts(params[k], mesh, axis, num_experts)
                      for k in ("w1", "b1", "w2", "b2"))
    dispatch, expert_prob, (fraction, mean_prob) = _route(
        xs, router_logits(xs, params["router.weight"], params["router.bias"]),
        num_experts, capacity)
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch, xs)
    # tokens -> expert owners: split the E dim over the axis, gather all
    # groups (tiled: concat, not stack)
    expert_in = comm.all_to_all(expert_in, group, split_dim=1, concat_dim=0)
    out = expert_ffn(expert_in, w1, b1, w2, b2, dtype)
    # results -> home rank of each group
    out = comm.all_to_all(out, group, split_dim=0, concat_dim=1)
    combine = dispatch * expert_prob.to(dtype)[..., None, None]
    y = torch.einsum("gsec,gecd->gsd", combine, out)
    # the global Switch aux: every rank routed its own (equal-size) block
    # of the groups, so the global fraction/mean_prob are the means over
    # every axis the group dim is sharded over
    mean_group = mesh_mod.groups(mesh, batch_axes)
    fraction = comm.pmean(fraction, mean_group)
    mean_prob = comm.pmean(mean_prob, mean_group)
    aux = num_experts * (fraction * mean_prob).sum()
    if split:
        y = comm.all_gather(y, group, dim=0)
    return y, aux
