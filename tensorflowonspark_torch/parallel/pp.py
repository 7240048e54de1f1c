"""Pipeline parallelism over the ``pipe`` mesh axis, GPipe schedule (the
port of :mod:`tensorflowonspark_tpu.parallel.pp`).

One process per stage: rank ``s`` of the ``pipe`` axis holds stage ``s``'s
weights and activations hop stage to stage each tick.  The schedule is
JAX's: ``n_micro + S - 1`` ticks, stage 0 injecting microbatch ``t`` at tick
``t``, the last stage emitting microbatch ``t - (S-1)``, and the result the
sum over ``pipe`` of the emitted outputs (only the last stage's are not
zero), replicated.

The whole schedule is one ``autograd.Function``: its forward keeps each
tick's stage graph, and its backward runs the ticks in reverse, each
activation's cotangent sent back one stage (``batch_isend_irecv``), so
every rank's point-to-point calls pair up in the same order in both
passes and ``torch.autograd`` differentiates through the schedule as
``jax.grad`` does through ``ppermute``.  Each rank's gradient is its share
of the sum over ranks (:mod:`~tensorflowonspark_torch.parallel.comm`): its
own stage's weights, and the microbatches' on stage 0.  A stage that has
no microbatch at a tick (the pipeline's fill and drain) sends zeros and
computes nothing.

Contract: homogeneous stages, ``stage_fn(stage_params, x) -> y`` with
``y.shape == x.shape``; heterogeneous first/last layers (embed/unembed) run
outside the pipeline.
"""

import logging

import torch
import torch.distributed as dist

from tensorflowonspark_torch.parallel import comm
from tensorflowonspark_torch.parallel import mesh as mesh_mod

logger = logging.getLogger(__name__)


def stack_stage_params(params_list):
    """Stack per-stage name->tensor dicts into one dict with a leading
    stage dim (what :func:`gpipe` consumes; place that dim over ``pipe``)."""
    return {name: torch.stack([p[name] for p in params_list])
            for name in params_list[0]}


def stage_shardings(stacked_params, mesh, axis="pipe"):
    """``{name: Placement}`` placing the leading stage dim on ``axis``:
    rank ``i`` of the pipe axis holds exactly stage ``i``'s weights."""
    del mesh
    return {name: mesh_mod.Placement(axis=axis, dim=0)
            for name in stacked_params}


def split_microbatches(batch, n_micro):
    """``[global_batch, ...] -> [n_micro, global_batch/n_micro, ...]``, of a
    tensor or of every leaf of a dict."""
    def one(x):
        assert x.shape[0] % n_micro == 0, (
            "batch {} not divisible into {} microbatches".format(
                x.shape[0], n_micro))
        return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(
            x.shape[1:]))

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


class _Hop(object):
    """This rank's neighbours on the ``pipe`` ring (global ranks)."""

    def __init__(self, mesh, axis):
        self.group = mesh_mod.group(mesh, axis)
        ranks = dist.get_process_group_ranks(self.group)
        self.stage = mesh.get_local_rank(axis)
        self.size = len(ranks)
        self.next = ranks[(self.stage + 1) % self.size]
        self.prev = ranks[(self.stage - 1) % self.size]

    def _swap(self, send, to, frm):
        got = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send.contiguous(), to, self.group),
               dist.P2POp(dist.irecv, got, frm, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got

    def forward(self, y):
        """Send ``y`` one stage on (the last stage's to stage 0, which
        ignores it) and return the previous stage's."""
        return self._swap(y, self.next, self.prev)

    def backward(self, grad):
        """Send a cotangent one stage back and return the next stage's."""
        return self._swap(grad, self.prev, self.next)


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stage_fn, names, hop, microbatches, *params):
        n_micro, size, stage = microbatches.shape[0], hop.size, hop.stage
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        stage_params = dict(zip(names, leaves))
        zero = torch.zeros_like(microbatches[0])
        outputs = torch.zeros_like(microbatches)
        prev = zero
        ticks = []
        with torch.enable_grad():
            for t in range(n_micro + size - 1):
                if 0 <= t - stage < n_micro:
                    x = (microbatches[t] if stage == 0 else prev).detach() \
                        .requires_grad_(True)
                    y = stage_fn(stage_params, x)
                    ticks.append((t, x, y))
                    send = y.detach()
                    if stage == size - 1:
                        outputs[t - (size - 1)] = send
                else:
                    send = zero
                prev = hop.forward(send)
        ctx.hop, ctx.leaves, ctx.ticks = hop, leaves, ticks
        ctx.n_micro, ctx.micro_shape = n_micro, microbatches.shape
        return outputs

    @staticmethod
    def backward(ctx, grad_out):
        hop, leaves = ctx.hop, ctx.leaves
        size, stage, n_micro = hop.size, hop.stage, ctx.n_micro
        by_tick = {t: (x, y) for t, x, y in ctx.ticks}
        grad_micro = torch.zeros(ctx.micro_shape, dtype=grad_out.dtype,
                                 device=grad_out.device)
        grad_params = [None] * len(leaves)
        trainable = [p for p in leaves if p.requires_grad]
        zero = torch.zeros_like(grad_micro[0])
        grad_next = zero    # the cotangent of what this stage received
        for t in reversed(range(n_micro + size - 1)):
            grad_y = hop.backward(grad_next)
            grad_next = zero
            if t not in by_tick:
                continue
            x, y = by_tick[t]
            if stage == size - 1:
                grad_y = grad_y + grad_out[t - (size - 1)]
            got = torch.autograd.grad(y, [x] + trainable, grad_y,
                                      allow_unused=True)
            it = iter(got[1:])
            for i, p in enumerate(leaves):
                if not p.requires_grad:
                    continue
                g = next(it)
                if g is not None:
                    grad_params[i] = g if grad_params[i] is None \
                        else grad_params[i] + g
            if stage == 0:
                grad_micro[t] = got[0]
            else:
                grad_next = got[0]
        return (None, None, None, grad_micro) + tuple(grad_params)


def gpipe(stage_fn, stacked_params, microbatches, mesh, axis="pipe"):
    """Run ``stage_fn`` as an ``S``-stage GPipe pipeline over the mesh.

    Args:
      stage_fn: ``fn(stage_params, x) -> y`` with ``y.shape == x.shape``;
        executed by every pipe rank on its own stage.
      stacked_params: name->tensor dict with a leading stage dim: all ``S``
        stages (:func:`stack_stage_params`), or this rank's ``[1, ...]``
        block (placed by :func:`stage_shardings`).
      microbatches: ``[n_micro, micro_batch, ...]`` (see
        :func:`split_microbatches`), the same on every pipe rank.
      mesh: mesh containing ``axis``.

    Returns ``[n_micro, micro_batch, ...]`` outputs (replicated over
    ``axis``), differentiable end to end.
    """
    n_stages = mesh_mod.axis_size(mesh, axis)
    if n_stages == 1:
        # degenerate pipe: plain sequential microbatching
        squeezed = {k: v[0] for k, v in stacked_params.items()}
        return torch.stack([stage_fn(squeezed, x) for x in microbatches])
    hop = _Hop(mesh, axis)
    names = list(stacked_params)
    local = [v[hop.stage] if v.shape[0] == n_stages else v[0]
             for v in stacked_params.values()]
    out = _GPipe.apply(stage_fn, names, hop, microbatches, *local)
    # only the last stage wrote real outputs; the others hold zeros
    return comm.all_reduce(out, hop.group)
