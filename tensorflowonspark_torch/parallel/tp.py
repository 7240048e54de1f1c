"""Tensor-parallel parameter sharding over the ``tensor`` mesh axis (the
port of :mod:`tensorflowonspark_tpu.parallel.tp`).

:func:`tp_param_shardings` places each leaf by the JAX package's rule:
shard each >=2-D kernel's largest ``tensor``-divisible dim (the trailing
one on ties), replicate everything else, unless a ``rules`` entry
``(path_regex, dim)`` says otherwise (first match wins; ``dim`` negative
or None to replicate).  It returns ``{name: Placement}``
(:class:`~tensorflowonspark_torch.parallel.mesh.Placement`), which
``Trainer(param_sharding=...)`` lays the params and optimizer state out
by, each rank holding its block of a sharded leaf.

The rule looks at each leaf as its flax counterpart is laid out, so the
placements are JAX's leaf by leaf:

- names are matched as JAX paths: the port's ``blocks.0.mlp_out.weight``
  is ``blocks/0/mlp_out/weight``, so a JAX rule regex selects the same
  leaves in both packages;
- a leaf the model lays out otherwise than flax is read through the
  model's ``views`` (``{name: (view shape, perm)}``, e.g.
  :meth:`~tensorflowonspark_torch.models.transformer.TransformerLM.flax_views`):
  ``param.view(shape).permute(perm)`` is the flax leaf, so a Dense weight
  is read as the transposed kernel and the LM's fused qkv projection as
  flax's ``[D, 3, H, Dh]`` kernel; the rule and a rule's ``dim`` read the
  flax dims, and the placement shards the matching dim of the view.
  Without ``views`` each leaf is read as it is.

On the flagship LM (d1024, 16 heads) the rule shards the qkv kernel on
its input dim, ``proj`` on its output dim, the first MLP kernel on its
output dim, the second on its input dim (4096), and the token table on
the vocabulary.  The model computes on the full params, gathered after
every optimizer step (as under FSDP), and partitions its work over the
``tensor`` axis by heads and MLP columns
(:class:`~tensorflowonspark_torch.models.transformer.Attention`), whatever
the stored layout.  Every rank therefore keeps the full params resident
and, each step, reduce-scatters the full gradient and all-gathers the
params over ``tensor``: only the shards and their optimizer state are
1/T (ROADMAP.md, Queue 1: keeping TP leaves in their compute layout).
"""

import logging
import re

from tensorflowonspark_torch.parallel import mesh as mesh_mod

logger = logging.getLogger(__name__)

_UNRULED = object()


def _param_path(name):
    """A port param name as the JAX ``a/b/c`` path rules match."""
    return name.replace(".", "/")


def _heuristic_dim(shape, tp, allow_1d=False):
    """Largest tp-divisible dim, preferring the trailing (output-features)
    dim on ties — Megatron column-parallel for the big projections.

    ``allow_1d``: also shard rank-1 leaves (the FSDP rule wants this for
    large vectors; TP skips them — shared by ``fsdp.leaf_spec`` so the two
    strategies can't drift on divisibility/tie-breaking)."""
    if len(shape) < (1 if allow_1d else 2):
        return None
    dims = sorted(range(len(shape)),
                  key=lambda d: (shape[d], d), reverse=True)
    for d in dims:
        if shape[d] % tp == 0 and shape[d] // tp >= 1:
            return d
    return None


def flax_view(name, params, views=None):
    """``(flax shape, placement of a flax dim)`` of the leaf ``name`` of
    ``params``: the shape of its flax counterpart (read through
    ``views[name]``, the model's ``(view shape, perm)``, when it has one)
    and a function from a dim of that shape to the port's placement
    without an axis yet: ``(dim of the view, view shape or None)``."""
    shape = tuple(params[name].shape)
    view, perm = (views or {}).get(name, (None, None))
    if perm is None:
        return shape, lambda d: (d, None)
    viewed = shape if view is None else tuple(view)
    return (tuple(viewed[p] for p in perm),
            lambda d: (perm[d], None if view is None else tuple(view)))


def tp_param_shardings(params, mesh, axis="tensor", rules=None,
                       views=None):
    """``{name: Placement}`` annotating tensor parallelism over ``axis``.

    Args:
      params: a name->tensor dict (a model's ``state_dict``, or any dict
        of arrays with a ``shape``).
      mesh: a mesh; an ``axis`` absent or of size 1 replicates everything.
      axis: the mesh axis carrying TP.
      rules: optional ``[(path_regex, dim), ...]`` over JAX-style paths;
        first match wins.  ``dim`` is the flax leaf's dim to place on
        ``axis`` (negative ok), or None to replicate.  Unmatched leaves
        fall back to the heuristic.
      views: the model's ``{name: (view shape, perm)}`` of the leaves it
        lays out otherwise than flax (``model.flax_views()``), so that the
        placements are JAX's leaf by leaf.

    Raises ``ValueError`` when a ruled dim does not divide by the axis.
    """
    tp = mesh_mod.axis_size(mesh, axis)
    compiled = [(re.compile(pat), dim) for pat, dim in (rules or [])]
    out = {}
    for name in params:
        path = _param_path(name)
        ruled = next((dim for pat, dim in compiled if pat.search(path)),
                     _UNRULED)
        if tp <= 1 or ruled is None:
            out[name] = mesh_mod.REPLICATED
            continue
        shape, place = flax_view(name, params, views)
        dim = _heuristic_dim(shape, tp) if ruled is _UNRULED else ruled
        if dim is None:
            out[name] = mesh_mod.REPLICATED
            continue
        d = dim % len(shape)
        if shape[d] % tp != 0:
            raise ValueError(
                "param {} dim {} (size {}) not divisible by {}={}".format(
                    path, d, shape[d], axis, tp))
        port_dim, view = place(d)
        out[name] = mesh_mod.Placement(axis=axis, dim=port_dim, shape=view)
    return out


def shard_params(params, mesh, axis="tensor", rules=None, views=None):
    """``tp_param_shardings`` applied: this rank's block of every leaf (a
    view of a sharded leaf, the leaf itself when replicated)."""
    specs = tp_param_shardings(params, mesh, axis, rules, views)
    n = mesh_mod.axis_size(mesh, axis)
    out = {}
    for name, t in params.items():
        placement = specs[name]
        if placement.sharded:
            out[name] = placement.blocks(t, n)[mesh.get_local_rank(axis)]
        else:
            out[name] = t
    return out
