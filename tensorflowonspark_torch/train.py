"""Trainer: the port's training loop (the counterpart of
:mod:`tensorflowonspark_tpu.train`).

The JAX Trainer jits a functional step over a pytree sharded on a mesh;
here a step runs on one device per process: the loss and its backward
through autograd (the flash attention kernels' backward included), the
global grad norm on the device, and one ``torch.optim`` step that updates
the params in place.  Nothing in a step reads a value back to the host:
the loss and grad norm stay device scalars until a
:class:`~tensorflowonspark_torch.metrics.TimeHistory` window boundary syncs
on them.

K steps per dispatch (:meth:`Trainer.multi_step`, :meth:`Trainer.repeat_step`,
``fit_feed(steps_per_call=K)``) are the JAX package's ``lax.scan`` groups.
On the CPU they are K eager steps.  On a CUDA card one optimizer step is
captured once per batch signature as a ``torch.cuda.CUDAGraph`` (forward,
backward, the all-reduce in a world of more than one process, grad norm,
optimizer step) and a dispatch replays it K times, copying slot i of the
stacked batch into the graph's static buffers before replay i: the host
launches one graph per step instead of every kernel.

``accum_steps`` = A splits each batch into A micro-batches along dim 0 and
adds up their gradients weighted by their valid rows, on the device, before
the one optimizer step: the same update as the full batch for a masked-mean
loss, with about 1/A of its activation memory.

:func:`fit_supervised` wraps :meth:`Trainer.fit_feed` in the JAX package's
recovery loop: a validated restore of the newest good checkpoint before
every attempt, periodic saves, a chief-only emergency save on preemption,
retries with backoff, and the ``train_rollback`` knob's halt, which
quarantines poisoned checkpoints and resumes from the last valid one.

In a ``torch.distributed`` world of more than one process (data
parallelism, each process a local batch of the global one, as
:class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed` yields them)
the step all-reduces the gradients so that the update is the JAX
Trainer's over the global batch, a padded final batch included: with
``loss_fn`` a masked mean over rows (every loss of the model zoo), each
rank's loss is scaled by its valid rows over the global valid-row count
before its backward, and the ranks' gradients are summed.  Scaling the loss
(not the gradient) keeps the update exact when the ranks' losses are
coupled, as by BatchNorm statistics synchronised across ranks, whose
all-reduce hands every rank the other ranks' gradients too.  Every rank then
applies identical gradients.

``mesh`` (:func:`~tensorflowonspark_torch.parallel.mesh.build_mesh`) names
the world's axes.  Its ``batch_axes`` (``data`` and ``fsdp`` unless the
caller names others, as the LM twin adds ``expert``) carry distinct rows of
the global batch; the ranks that differ only in the other axes
(:func:`~tensorflowonspark_torch.parallel.mesh.pooled_axes`) hold the same
rows: under ``seq`` each its chunk of the sequence (the model's loss is
then that chunk's share), under ``tensor``, ``pipe`` and a non-batch
``expert`` the same rows and the same loss.  The global valid-row count
divides the all-reduced count by that group's size, and the loss of a rank
whose work others repeat is scaled by 1/(their number), so that the SUM of
every rank's gradient is the global batch's: the collectives inside the
model differentiate as that sum (:mod:`~tensorflowonspark_torch.parallel.comm`),
which keeps exact the leaves that a rank uses on part of the work only
(the MoE router under ``moe_ffn``'s split, the qkv rows of its heads).

``param_sharding`` lays the params and the optimizer state out per leaf
(:class:`~tensorflowonspark_torch.parallel.fsdp.ShardedParams`): ``"fsdp"``
by the JAX package's FSDP rule, or a ``{name: Placement}`` tree
(:func:`~tensorflowonspark_torch.parallel.tp.tp_param_shardings`,
:func:`~tensorflowonspark_torch.parallel.ep.merge_ep_shardings`).  Each
rank holds its block of a sharded leaf and the optimizer steps only the
blocks.  A leaf sharded over ``fsdp`` or ``tensor`` is gathered: its full
gradient is reduce-scattered into the block over its axis (and summed over
the others), and the full params are all-gathered into their fixed buffers
after every step, so ``state.params`` holds them.  A leaf sharded over
``expert`` stays local (the MoE layer computes with its E/ep experts):
``state.params`` holds the block, whose gradient sums over the axes but
``expert``.  Replicated leaves sum over the world, the loss with them, in
one all-reduce.  Each group of leaves is one flat buffer and one collective
(a CUDA graph captures them).  The grad norm is ``sqrt`` of the Σ of the
blocks' squares over their axes plus the replicated leaves', each block
counted once.

``extra_state`` is the JAX Trainer's non-trainable state (BatchNorm running
averages): a name->tensor dict that the loss reads and hands back updated in
``aux["extra_state"]``; after each (micro-)batch the new values are copied
into the same storage, so a captured CUDA graph updates them on every
replay.
"""

import contextlib
import dataclasses
import importlib
import logging
import math
import os
import time
import warnings
import weakref
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from tensorflowonspark_torch import fault as fault_mod
from tensorflowonspark_torch import metrics as metrics_mod
from tensorflowonspark_torch import profiling as profiling_mod
from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.device import resolve_device
from tensorflowonspark_torch.parallel import fsdp as fsdp_mod
from tensorflowonspark_torch.parallel import mesh as mesh_mod

# the flash kernels' launch counters (the module; ``ops`` re-exports the
# function under the same name)
_kernels = importlib.import_module(
    "tensorflowonspark_torch.ops.flash_attention")

logger = logging.getLogger(__name__)

#: opt-in hot-loop transfer guard (see :func:`_resolve_transfer_guard`):
#: "1"/"on"/"disallow" makes any host->device copy inside a fit_feed
#: dispatch a hard error; "log" logs instead; ""/"0"/"off"/"allow"
#: disables (the default: the guard costs Python per op of an eager step)
TRANSFER_GUARD_ENV = "TFOS_TRANSFER_GUARD"

#: ``fit_feed``'s default K when the caller leaves ``steps_per_call=1``
#: (the JAX package's variable): cluster runs arm grouped dispatch through
#: the executors' environment, without code changes
STEPS_PER_CALL_ENV = "TFOS_STEPS_PER_CALL"

#: eager steps, per batch signature, before a step is captured as a CUDA
#: graph: they create the optimizer's lazy state, cuBLAS's workspaces and
#: autograd's buffers, which a capture cannot allocate for later replays
GRAPH_WARMUP_STEPS = 2

def _resolve_transfer_guard(mode):
    """Normalize a ``fit_feed(transfer_guard=...)`` / env value to a guard
    level string, or None when guarding is off (the JAX package's rule).

    Only the **host->device** direction is guarded: the dispatch path must
    never re-transfer batch data (that is the infeed prefetch thread's job),
    but the metrics recorder legitimately syncs the loss device->host at
    window boundaries.
    """
    if mode is None:
        mode = os.environ.get(TRANSFER_GUARD_ENV, "")
    if not mode or mode in ("0", "off", "allow", "allow_explicit", False):
        return None
    if mode in ("1", "on", True):
        return "disallow"
    return mode  # "disallow" / "log" / "log_explicit" pass through


def _host_to_device(func, args, kwargs):
    """The CPU tensor of more than zero dims that this ATen call copies off
    the host, or None: ``_to_copy`` of a CPU tensor to another device,
    ``copy_`` of a CPU source into a device destination, ``_copy_from``
    of a CPU source to a device destination.  Zero-dim tensors are exempt
    (scalars, like the optimizer's step counts)."""
    packet = getattr(func, "overloadpacket", None)
    src = dst_device = None
    if packet is torch.ops.aten._to_copy and args:
        src, dst_device = args[0], kwargs.get("device")
    elif packet is torch.ops.aten.copy_ and len(args) >= 2:
        src, dst_device = args[1], args[0].device
    elif packet is torch.ops.aten._copy_from and len(args) >= 2:
        src, dst_device = args[0], args[1].device
    if (not isinstance(src, torch.Tensor) or src.device.type != "cpu"
            or src.dim() == 0 or dst_device is None
            or torch.device(dst_device).type == "cpu"):
        return None
    return src


class _TransferGuard(TorchDispatchMode):
    """The hot-loop transfer guard (``jax.transfer_guard_host_to_device``'s
    counterpart): every ATen call of a dispatch passes through it, and a
    host->device copy (:func:`_host_to_device`) raises at a ``disallow*``
    level and is logged at a ``log*`` level.  Dispatch modes are per
    thread, so the infeed prefetch thread's pinned copies are not seen; a
    CUDA graph replay dispatches nothing, so at K > 1 the guard sees the
    capture, not the replays; and a copy made below the dispatcher
    (``torch.tensor(<a Python list>, device=...)``) is not seen either."""

    def __init__(self, level):
        super().__init__()
        self.level = level

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        src = _host_to_device(func, args, kwargs)
        if src is not None:
            msg = ("host->device copy of a {} {} CPU tensor inside a "
                   "fit_feed dispatch ({}): the batch is not device-resident "
                   "(transfer_guard={!r})".format(
                       list(src.shape), src.dtype, func, self.level))
            if self.level.startswith("log"):
                logger.warning(msg)
            else:
                raise RuntimeError(msg)
        return func(*args, **kwargs)


def _transfer_guard_ctx(level):
    """A fresh guard context per dispatch (none when ``level`` is None)."""
    if level is None:
        return contextlib.nullcontext()
    return _TransferGuard(level)


@dataclasses.dataclass
class TrainState:
    """The step counter, the params (a name->tensor dict, updated in place),
    the optimizer that holds their state, and the non-trainable ``extra``
    state (a name->tensor dict, e.g. BatchNorm running averages; None
    without one), updated in place too.  Under a sharded layout
    ``sharding`` is the
    :class:`~tensorflowonspark_torch.parallel.fsdp.ShardedParams` whose
    blocks the optimizer steps (``params`` are its ``full``: the full
    gathered leaves and this rank's block of a local one)."""

    step: int
    params: dict
    optimizer: Any
    extra: Any = None
    sharding: Any = None

    def state_dict(self):
        """``{"step", "params", "opt_state"}`` and ``"extra"`` when there is
        extra state: what a checkpoint holds.  Under a sharded layout the
        local leaves and the optimizer state are all-gathered to their full
        shapes, so the state is a one-card state (a collective call: every
        rank makes it)."""
        opt_state = self.optimizer.state_dict()
        if self.sharding is not None:
            opt_state = self.sharding.full_optimizer_state(opt_state)
        state = {"step": self.step, "params": self.full_params(),
                 "opt_state": opt_state}
        if self.extra is not None:
            state["extra"] = self.extra
        return state

    def full_params(self):
        """The full params, one-card shapes: ``params`` itself, or under a
        sharded layout with local leaves their all-gathered blocks (a
        collective call: every rank makes it)."""
        if self.sharding is None:
            return self.params
        return self.sharding.full_params()

    def load_state_dict(self, state):
        """Copy a :meth:`state_dict` into this state, in place: the params,
        the extra state, and the values of every optimizer state tensor and
        tensor hyperparameter this optimizer already holds, which keep their
        storage (a captured CUDA graph reads them at their addresses).
        ``capturable`` flags stay as they are; the other hyperparameters
        come from ``state``.  Under a sharded layout each rank takes its
        blocks of the one-card state."""
        opt = self.optimizer
        with torch.no_grad():
            if self.sharding is not None:
                self.sharding.load_full(state["params"])
            else:
                for name, t in self.params.items():
                    t.copy_(state["params"][name])
            for name, t in (self.extra or {}).items():
                t.copy_(state["extra"][name])
        opt_state = state["opt_state"]
        if self.sharding is not None:
            opt_state = self.sharding.local_optimizer_state(opt_state)
        held = {p: dict(s) for p, s in opt.state.items()}
        flags = [g.get("capturable") for g in opt.param_groups]
        # tensor hyperparameters (a tensor lr a schedule writes on the
        # device) keep their storage too
        held_hyper = [{k: v for k, v in g.items()
                       if isinstance(v, torch.Tensor)}
                      for g in opt.param_groups]
        opt.load_state_dict(opt_state)
        for group, flag, hyper in zip(opt.param_groups, flags, held_hyper):
            if flag is not None:
                group["capturable"] = flag
            for key, prev in hyper.items():
                value = group.get(key)
                if (isinstance(value, torch.Tensor)
                        and value.shape == prev.shape):
                    with torch.no_grad():
                        prev.copy_(value)
                    group[key] = prev
        _place_steps(opt)
        with torch.no_grad():
            for p, loaded in opt.state.items():
                old = held.get(p, {})
                for key, value in loaded.items():
                    prev = old.get(key)
                    if (isinstance(prev, torch.Tensor)
                            and isinstance(value, torch.Tensor)
                            and prev.shape == value.shape):
                        prev.copy_(value)
                        loaded[key] = prev
        self.step = int(state["step"])


def _asks_not_capturable(factory):
    """Whether an optimizer factory passes ``capturable=False`` itself (a
    ``functools.partial``'s keywords say so)."""
    return getattr(factory, "keywords", {}).get("capturable") is False


def _arm_capturable(optimizer):
    """Set ``capturable=True`` on every param group that has the key (a
    CUDA graph can then capture ``optimizer.step()``; Adam's step counter
    lives on the card) and place the step counters accordingly."""
    for group in optimizer.param_groups:
        if "capturable" in group:
            group["capturable"] = True
    _place_steps(optimizer)


def _check_capturable(optimizer):
    """Raise unless every param group that has ``capturable`` has it on."""
    if any(group.get("capturable") is False
           for group in optimizer.param_groups):
        raise RuntimeError(
            "the optimizer was made with capturable=False, so its step "
            "cannot be captured as a CUDA graph: K steps a dispatch on the "
            "card need it left to the Trainer (or set True)")


def _place_steps(optimizer):
    """Move the ``step`` counter of each param in a capturable group onto
    that param's device, where capturable ``step()`` reads it."""
    for group in optimizer.param_groups:
        if not group.get("capturable"):
            continue
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            step = state.get("step")
            if isinstance(step, torch.Tensor) and step.device != p.device:
                state["step"] = step.to(p.device)


def _world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _signature(batch, mask):
    """What a CUDA graph is captured for: the structure, shapes and dtypes
    of the batch and the mask's shape."""
    return repr((_map(batch, lambda t: (tuple(t.shape), str(t.dtype))),
                 tuple(mask.shape)))


def _holds_tensor(value):
    if isinstance(value, (tuple, list)):
        return any(_holds_tensor(v) for v in value)
    return isinstance(value, torch.Tensor)


def _frozen_hyperparameters(optimizer):
    """Per param group, the hyperparameters a captured step keeps as they
    were at capture: every value but the params, the ``capturable`` flag
    and tensors (a replay reads a tensor hyperparameter at its address,
    so writing it in place reaches every replay; a float ``lr`` is a
    launch argument of capturable Adam's kernels)."""
    return [{key: value for key, value in group.items()
             if key not in ("params", "capturable")
             and not _holds_tensor(value)}
            for group in optimizer.param_groups]


class _StepGraph(object):
    """One optimizer step captured as a CUDA graph: the static batch and
    mask it reads, the loss and grad norm it writes (overwritten by every
    replay), the gradients it keeps alive, the kernel launches one replay
    makes, and the optimizer's non-tensor hyperparameters at capture."""

    def __init__(self, graph, batch, mask, loss, grad_norm, grads,
                 launches, hyperparameters):
        self.graph = graph
        self.batch = batch
        self.mask = mask
        self.loss = loss
        self.grad_norm = grad_norm
        self.grads = grads
        self.launches = launches
        self.hyperparameters = hyperparameters

    def check_hyperparameters(self, optimizer):
        """Raise if a non-tensor hyperparameter of ``optimizer`` changed
        since the capture: a replay would still step with the old value
        (a scheduler or hook that writes ``group["lr"]`` moves eager steps
        only)."""
        groups = optimizer.param_groups
        if len(groups) != len(self.hyperparameters):
            raise RuntimeError(
                "the optimizer has {} param groups, {} when the train step "
                "was captured as a CUDA graph".format(
                    len(groups), len(self.hyperparameters)))
        for i, (held, group) in enumerate(zip(self.hyperparameters, groups)):
            for key, value in held.items():
                now = group.get(key)
                if type(now) is type(value) and now == value:
                    continue
                raise RuntimeError(
                    "param group {} changed {!r} from {!r} to {!r} after "
                    "the train step was captured as a CUDA graph, whose "
                    "replays keep the captured value: make it a tensor on "
                    "the card (e.g. {}=torch.tensor({!r}, device=...)) and "
                    "write it in place (.fill_(...)), which every replay "
                    "reads".format(i, key, value, now, key, value))

    def load(self, batch, mask):
        """Copy one batch into the static buffers (on the current stream)."""
        for dst, src in zip(_leaves(self.batch), _leaves(batch)):
            dst.copy_(src)
        self.mask.copy_(mask)

    def replay(self):
        # no profiler starts or stops while the host launches the graph
        with profiling_mod.cuda_graph_lock:
            self.graph.replay()
        _kernels.add_launches(self.launches)


class Trainer(object):
    """Runs training steps on one device.

    Args:
      loss_fn: ``fn(params, batch, mask) -> (loss, aux)``, ``params`` a
        name->tensor dict; ``mask`` is the per-row validity mask (1.0 = real
        row), which the loss must apply.  With ``extra_state``,
        ``fn(params, extra, batch, mask)``, which returns the updated extra
        state in ``aux["extra_state"]`` (split off ``aux`` by the step).
      init_params: name->tensor dict (e.g. a converted flax tree); the
        trainer copies it onto its device.
      extra_state: initial non-trainable state, a name->tensor dict (e.g.
        BatchNorm running averages); copied onto the device, never
        optimized.  After every (micro-)batch its new values are copied
        into the same tensors, so micro-batches of ``accum_steps`` see the
        previous one's, as in the JAX scan.
      optimizer: a factory ``params -> torch.optim.Optimizer``, e.g.
        ``functools.partial(torch.optim.Adam, lr=1e-3)`` for ``optax.adam``.
        On a card its param groups get ``capturable=True`` where they have
        the key, so that eager steps and CUDA graph replays do the same
        arithmetic, unless the factory is a ``functools.partial`` that
        passes ``capturable=False``: then eager steps keep it, and
        :meth:`multi_step` and :meth:`repeat_step` raise before their first
        step.  An optimizer whose step cannot be captured raises at the
        first capture.
      compute_dtype: cast floating batch inputs to this dtype in the step
        (the model's own ``dtype`` sets its compute precision).
      batch_size: global batch size, for throughput metrics.
      log_steps: TimeHistory window.
      extra_step_flops: FLOPs per step that ``FlopCounterMode`` cannot see:
        the hand-written kernels' work (for the flash LM, 7·S²·D·B·H·layers).
        Added to the counted figure for MFU.
      step_flops_override: the whole MFU numerator, stated by the model
        owner; no counting happens.
      summary_writer: optional
        :class:`~tensorflowonspark_torch.summary.SummaryWriter` (chief-only
        by the caller's convention): window scalars and the per-step loss
        curve land in TensorBoard.
      device: ``"cuda"`` by default; ``"cpu"`` only when asked.
      accum_steps: A > 1 runs each step as A sequential micro-batches of
        B/A rows (B must divide, else ``ValueError``) against the same
        params: gradients and losses are added up weighted by each
        micro-batch's ``mask.sum()`` and divided by ``max(sum, 1)``, on
        the device.  For a masked-MEAN loss (every loss of the model zoo)
        that is the full-batch update, padded rows included; ``aux`` is the
        last micro-batch's.  The step FLOPs are the full-batch step's (the
        micro-batches' products add up to it); the counted bytes are the
        dispatched step's, which reads the params once per micro-batch.

      mesh: the device mesh
        (:func:`~tensorflowonspark_torch.parallel.mesh.build_mesh`), or None:
        data parallelism over the world, as a ``("data",)`` mesh gives.
      param_sharding: None (replicated params and optimizer state),
        ``"fsdp"`` (sharded over the mesh's ``fsdp`` axis, which it needs),
        or a ``{name: Placement}`` tree over ``mesh``.
      batch_axes: the mesh axes whose coordinates carry distinct rows;
        by default the model's (``loss_fn.batch_axes``, as
        :func:`~tensorflowonspark_torch.models.transformer.loss_fn` sets
        it), else ``("data", "fsdp")``.  ``ValueError`` when it differs
        from the model's; :meth:`fit_feed` raises when a meshed feed's
        differs.
      aot_cache: warm-start artifact store — a directory path or a
        :class:`~tensorflowonspark_torch.compilecache.AOTCache`.  The step /
        multi-step / repeat programs (``step``, ``multi_<K>``,
        ``repeat_<K>``) are resolved through it at their first dispatch: a
        fingerprint-matched artifact installs the kernel libraries the
        step launches without ``nvcc`` (verdict ``loaded``); a cold store
        builds them once and persists them for the next restart
        (``compiled``).  The step itself stays eager (CUDA graphs at
        K > 1, captured anew): AOTInductor compiles no backward or
        optimizer step, and a CUDA graph cannot be serialized
        (:class:`~tensorflowonspark_torch.compilecache.KernelSet`).
        Fingerprints cover versions/device/mesh/avals/kernel sources PLUS
        a structural hash of the loss fn + optimizer
        (:func:`~tensorflowonspark_torch.compilecache.program_identity`),
        so resuming after editing the loss or a hyperparameter rejects
        the stale artifact; still scope the directory per model run.
        :func:`fit_supervised` defaults it beside a LOCAL checkpoint root
        (remote roots skip the default — the store is local-filesystem
        only).  The build or install time counts in
        ``train_compile_us_max``.
      aot_program_version: optional caller-asserted program identity mixed
        into the AOT fingerprint VERBATIM; bump it on any program change
        the structural hash cannot see — a mismatch is a clean recompile,
        never a crash.
    """

    def __init__(self, loss_fn, init_params, optimizer, extra_state=None,
                 compute_dtype=None, batch_size=None, log_steps=20,
                 extra_step_flops=0, step_flops_override=None,
                 summary_writer=None, device=None, accum_steps=1, mesh=None,
                 param_sharding=None, batch_axes=None, aot_cache=None,
                 aot_program_version=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        if isinstance(param_sharding, str) and param_sharding != "fsdp":
            raise ValueError("param_sharding must be None, 'fsdp' or a "
                             "sharding tree, got {!r}".format(param_sharding))
        # one answer to which axes carry distinct rows: the model's (its
        # MoE layers route by it), which the Trainer adopts and the feed
        # must share (fit_feed checks it)
        model_axes = getattr(loss_fn, "batch_axes", None)
        if mesh is not None and model_axes is not None:
            if batch_axes is None:
                batch_axes = model_axes
            elif (mesh_mod.batch_axes_of(mesh, batch_axes)
                  != mesh_mod.batch_axes_of(mesh, model_axes)):
                raise ValueError(
                    "batch_axes {} differ from the model's {}: the rows "
                    "would be laid out one way and routed another".format(
                        tuple(batch_axes), tuple(model_axes)))
        self.batch_axes = batch_axes
        # the rows of the global batch: the all-reduced count divides by the
        # size of the group that pools them; the ranks of that group but
        # the seq ones repeat one another's work, each 1/n of the loss
        pooled = (() if mesh is None
                  else mesh_mod.pooled_axes(mesh, batch_axes))
        self._row_holders = math.prod(mesh_mod.axis_size(mesh, a)
                                      for a in pooled)
        self._work_repeats = self._row_holders // (
            1 if mesh is None else mesh_mod.axis_size(mesh, "seq"))
        if int(accum_steps) < 1:
            raise ValueError("accum_steps must be >= 1, got {}".format(
                accum_steps))
        self.accum_steps = int(accum_steps)
        self.loss_fn = loss_fn
        self.compute_dtype = compute_dtype
        self.batch_size = batch_size
        self.log_steps = log_steps
        self.extra_step_flops = extra_step_flops
        self.step_flops_override = step_flops_override
        self.summary_writer = summary_writer
        params = {name: torch.as_tensor(t).detach().to(self.device, copy=True)
                  .requires_grad_(True) for name, t in init_params.items()}
        extra = None
        if extra_state is not None:
            extra = {name: torch.as_tensor(t).detach().to(self.device,
                                                          copy=True)
                     for name, t in extra_state.items()}
        sharding = None
        if param_sharding is not None:
            if mesh is None and param_sharding != "fsdp":
                raise ValueError("a sharding tree needs a mesh")
            sharding = fsdp_mod.ShardedParams(
                params, mesh, placements=(None if param_sharding == "fsdp"
                                          else param_sharding))
            if not sharding.names:   # size-1 axes: everything replicates
                sharding = None
            else:
                params = sharding.full
        stepped = (list(params.values()) if sharding is None
                   else sharding.optimizer_params())
        self.state = TrainState(step=0, params=params,
                                optimizer=optimizer(stepped), extra=extra,
                                sharding=sharding)
        self._optimizer_factory = optimizer
        if self.device.type == "cuda" and not _asks_not_capturable(
                optimizer):
            # eager steps and graph replays share one optimizer arithmetic
            # (capturable Adam computes its bias corrections on the card,
            # not in Python floats), so K = 1 and K > 1 train alike
            _arm_capturable(self.state.optimizer)
        self.history = None
        # dispatch-overlap and goodput tallies (the JAX Trainer's keys):
        # host-side time between one dispatch returning and the next
        self._dispatch_count = 0
        self._dispatch_gap_us = 0
        self._dispatch_gap_us_hwm = 0
        self._goodput_dispatch_us = 0
        self._goodput_infeed_starved_us = 0
        self._goodput_ckpt_drain_us = 0
        self._goodput_recovery_us = 0   # fit_supervised: restores + backoff
        self._last_drain_us = 0
        self._step_ms_hist = {}      # bucket bound (ms) -> window steps
        self._step_ms_count = 0      # steps covered by closed windows
        self._step_ms_sum_us = 0     # wall us covered by closed windows
        self._mfu_pct = None         # latest closed window's MFU, percent
        self._flops_per_sec = None   # latest achieved FLOP/s
        self._acct_history = None    # TimeHistory the accountant follows
        self._windows_seen = 0       # timestamp_log entries consumed
        # the first step's cost (estimate_step_cost) and its roofline
        self._step_bytes = None
        self._roofline = None
        self._compile_secs = None    # CUDA graph warm-up + capture wall
        # training health, read at window boundaries only
        self._health_grad_norm = None  # device scalar from the last dispatch
        self._health_windows = 0
        self._health_loss = None       # last FINITE loss
        self._health_grad = None       # last finite grad norm
        self._nonfinite_loss = 0
        self._nonfinite_grad = 0
        # megastep: dispatched steps, the K of the last dispatch and the
        # session's largest K (the tail of a feed degrades to singles)
        self._steps_total = 0
        self._steps_per_call_gauge = 0
        self._steps_per_call_hwm = 0
        # CUDA graphs by batch signature, eager warm-ups taken per
        # signature, and the side stream that warms up and captures
        self._graphs = {}
        self._warmups = {}
        self._capture_stream = None
        # the train_rollback knob: the armed token, the tokens seen (a knob
        # push is re-broadcast on every heartbeat) and fit_supervised's
        # rollbacks so far
        self._rollback_req = None
        self._rollback_tokens = set()
        self._rollbacks = 0
        # the warm-start compile plane (compilecache): the artifact store,
        # each program's resolved artifact (None: eager dispatch for good)
        # and the batch signature it resolved for, and the load-vs-compile
        # verdicts for status reporting
        self._aot = None
        self._aot_exec = {}
        self._aot_signature = {}
        self._aot_verdicts = {}
        self._aot_program_version = aot_program_version
        self._aot_program_id = None   # memoized program_identity digest
        if aot_cache is not None:
            self.set_aot_cache(aot_cache)

    # -- the step ---------------------------------------------------------

    def _put(self, x):
        t = torch.as_tensor(x).to(self.device)
        if self.compute_dtype is not None and t.is_floating_point():
            t = t.to(self.compute_dtype)
        return t

    def _prepare(self, batch, mask, stacked=False):
        """The batch and mask on the device; floating batch inputs cast to
        ``compute_dtype``; a missing mask is all ones (``[K, B]`` for a
        ``stacked`` group)."""
        batch = _map(batch, self._put)
        if mask is None:
            shape = _leaves(batch)[0].shape[:2 if stacked else 1]
            mask = torch.ones(shape, device=self.device)
        else:
            mask = torch.as_tensor(mask).to(self.device, torch.float32)
        return batch, mask

    def _loss(self, batch, mask):
        """``(loss, aux, new_extra)`` of the loss function on one
        (micro-)batch; ``new_extra`` is None without extra state."""
        if self.state.extra is None:
            loss, aux = self.loss_fn(self.state.params, batch, mask)
            return loss, aux, None
        loss, aux = self.loss_fn(self.state.params, self.state.extra, batch,
                                 mask)
        aux = dict(aux)
        return loss, aux, aux.pop("extra_state", None)

    def _commit_extra(self, new_extra):
        """Copy updated extra state into the state's own tensors."""
        if new_extra is None:
            return
        with torch.no_grad():
            for name, t in self.state.extra.items():
                t.copy_(new_extra[name])

    def _grads(self, batch, mask):
        """Loss, aux and the params' ``.grad`` of one batch (of its
        ``accum_steps`` micro-batches, see :meth:`_accum_grads`; in a world
        of more than one process, :meth:`_global_grads`)."""
        self.state.optimizer.zero_grad(set_to_none=True)
        for p in self.state.params.values():
            p.grad = None   # under FSDP a sharded leaf's full param is not
            # the optimizer's (compile_and_measure leaves its grad set)
        if _world_size() > 1:
            return self._global_grads(batch, mask)
        if self.accum_steps > 1:
            return self._accum_grads(batch, mask)
        loss, aux, new_extra = self._loss(batch, mask)
        loss.backward()
        self._commit_extra(new_extra)
        return loss.detach(), aux

    def _micro_batches(self, batch, mask):
        """``accum_steps`` ``(batch, mask)`` slices along dim 0, in order."""
        a = self.accum_steps
        for t in _leaves(batch) + [mask]:
            if t.shape[0] % a:
                raise ValueError(
                    "batch dim {} not divisible by accum_steps {}".format(
                        t.shape[0], a))
        size = int(mask.shape[0]) // a
        for i in range(a):
            part = slice(i * size, (i + 1) * size)
            yield _map(batch, lambda t: t[part]), mask[part]

    def _accum_grads(self, batch, mask):
        """The JAX Trainer's micro-batch accumulation: per micro-batch the
        loss and gradients against the same params, added up times
        ``w = mask.sum()``, then divided by ``max(sum of w, 1)``; the extra
        state threads through the micro-batches in order.  Every sum stays
        a device tensor (a CUDA graph captures it)."""
        params = list(self.state.params.values())
        g_sum = [None] * len(params)    # a param no micro-batch uses: None
        l_sum = w_sum = mask.new_zeros(())
        for b, m in self._micro_batches(batch, mask):
            loss, aux, new_extra = self._loss(b, m)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            self._commit_extra(new_extra)
            w = m.sum()
            for j, g in enumerate(grads):
                if g is not None:
                    g_sum[j] = g * w if g_sum[j] is None else g_sum[j] + g * w
            l_sum = l_sum + loss.detach() * w
            w_sum = w_sum + w
        w_safe = w_sum.clamp_min(1.0)
        for p, g in zip(params, g_sum):
            p.grad = None if g is None else g / w_safe
        return l_sum / w_safe, aux

    def _global_grads(self, batch, mask):
        """A step's gradients in a world of more than one process: each
        (micro-)batch's loss times its valid rows over the global batch's
        (one all-reduce of the row count first) is backpropagated, so the
        ranks' summed gradients (:meth:`_allreduce`) are the gradient of
        the masked mean over the global batch, the micro-batches weighted
        as :meth:`_accum_grads` weights them.  A loss coupled across ranks
        (synchronised BatchNorm statistics) gets each rank's share of the
        cross terms right too.  The ranks that pool rows count them once,
        and those that repeat the work each carry 1/n of it (see the module
        docstring).  Returns this rank's share of the loss."""
        total = mask.sum().reshape(1)
        dist.all_reduce(total)
        if self._row_holders > 1:
            total = total / self._row_holders
        total = total.clamp_min(1.0)
        if self._work_repeats > 1:
            total = total * self._work_repeats
        l_sum = mask.new_zeros(())
        for b, m in self._micro_batches(batch, mask):
            loss, aux, new_extra = self._loss(b, m)
            share = m.sum() / total
            (loss * share).backward()
            self._commit_extra(new_extra)
            l_sum = l_sum + loss.detach() * share
        return l_sum.reshape(()), aux

    @staticmethod
    def _allreduce(loss, grads):
        """Sum the ranks' loss shares and gradients in place (one all-reduce
        on the default group, NCCL on the card): the global batch's loss
        and gradient (see :meth:`_global_grads`)."""
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 1
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[0]

    def _step_math(self, batch, mask):
        """The work of one optimizer step, the step counter left alone
        (what a CUDA graph captures): ``(loss, aux, grad_norm)``, device
        scalars; in a multi-process world the loss and gradients are the
        global batch's."""
        loss, aux = self._grads(batch, mask)
        sharding = self.state.sharding
        if sharding is not None:
            sharding.scatter_grads()
        # the replicated leaves' gradients (a gathered leaf's went into its
        # shard, a local leaf's was summed by scatter_grads)
        grads = [p.grad for name, p in self.state.params.items()
                 if p.grad is not None
                 and (sharding is None or name not in sharding.local)]
        if _world_size() > 1:
            loss = self._allreduce(loss, grads)
        if sharding is None:
            grad_norm = torch.nn.utils.get_total_norm(grads)
        else:
            sq = sharding.grad_sq_sum()
            for g in grads:
                sq = sq + g.float().square().sum()
            grad_norm = sq.sqrt()
        with warnings.catch_warnings():
            # a capturable optimizer stepped eagerly: meant (see __init__)
            warnings.filterwarnings("ignore", message=".*capturable=True")
            self.state.optimizer.step()
        if sharding is not None:
            sharding.gather()
        return loss, aux, grad_norm

    def _step_core(self, batch, mask):
        """One optimizer step: ``(loss, aux, grad_norm)``."""
        result = self._step_math(batch, mask)
        self.state.step += 1
        return result

    def _new_history(self, step_flops):
        self.history = metrics_mod.TimeHistory(
            batch_size=self.batch_size or 0, log_steps=self.log_steps,
            step_flops=step_flops,
            peak_flops=metrics_mod.peak_flops_per_device(self.device),
            summary_writer=self.summary_writer)
        self.history.on_train_begin()

    def _step_flops(self, counted):
        """The MFU numerator from a ``FlopCounterMode`` count: the
        override when given, else the count plus ``extra_step_flops``
        (None when nothing was counted)."""
        if self.step_flops_override is not None:
            return self.step_flops_override
        if not counted:
            return None
        return counted + self.extra_step_flops

    def _set_cost(self, cost):
        """Keep one step's :func:`~tensorflowonspark_torch.metrics.estimate_step_cost`:
        the MFU numerator, the bytes and the roofline of the attribution
        report (None on the CPU, which has no peak rates)."""
        flops = self._step_flops(cost["flops"])
        self.history.step_flops = flops
        self._step_bytes = cost["bytes_accessed"]
        self._roofline = metrics_mod.roofline(
            flops, self._step_bytes,
            peak_flops=metrics_mod.peak_flops_per_device(self.device),
            peak_bps=metrics_mod.peak_bytes_per_sec_per_device(self.device))

    def _counted_step(self, batch, mask):
        """One eager optimizer step; the trainer's first also starts the
        metrics recorder and counts the step's FLOPs and bytes."""
        if self.history is not None:
            return self._step_core(batch, mask)
        self._new_history(self._step_flops(None))
        if self.step_flops_override is not None:
            return self._step_core(batch, mask)
        cost, result = metrics_mod.estimate_step_cost(self._step_core, batch,
                                                      mask)
        self._set_cost(cost)
        return result

    def compile_and_measure(self, example_batch, example_mask=None):
        """Build the kernels and count the per-step FLOPs and bytes with
        one forward and backward on ``example_batch`` (the params do not
        change; their grads are cleared).  Returns the step FLOPs."""
        if self.history is None:
            self._new_history(self._step_flops(None))
            if self.step_flops_override is None:
                batch, mask = self._prepare(example_batch, example_mask)
                kept = (None if self.state.extra is None else
                        {k: t.clone() for k, t in self.state.extra.items()})
                cost, _ = metrics_mod.estimate_step_cost(self._grads, batch,
                                                         mask)
                self.state.optimizer.zero_grad(set_to_none=True)
                self._commit_extra(kept)   # the extra state is unchanged
                self._set_cost(cost)
        return self.history.step_flops

    def reset_history(self):
        """Replace the metrics recorder with a fresh one (same step FLOPs),
        so warmup steps stay out of the reported stats.  No-op before the
        first step."""
        if self.history is not None:
            self._new_history(self.history.step_flops)

    def _note_dispatch(self, k):
        self._steps_per_call_gauge = k
        self._steps_per_call_hwm = max(self._steps_per_call_hwm, k)
        self._steps_total += k

    def step(self, batch, mask=None):
        """Run one eager step on the whole batch; returns ``(loss, aux)``,
        the loss a device scalar.  The first step also counts the step
        FLOPs and bytes unless :meth:`compile_and_measure` did."""
        batch, mask = self._prepare(batch, mask)
        self._aot_dispatch("step", batch, mask)
        # on the card no profiler starts or stops while the host launches
        # the step: a capture's window opens and closes between steps
        with (profiling_mod.cuda_graph_lock if self.device.type == "cuda"
              else contextlib.nullcontext()):
            loss, aux, self._health_grad_norm = self._counted_step(batch,
                                                                   mask)
        self._note_dispatch(1)
        # TimeHistory syncs on the loss at window boundaries: honest
        # ms/step and MFU; within a window the steps queue freely
        self.history.on_step_end(loss)
        return loss, aux

    def multi_step(self, batches, masks, donate_batches=False):
        """Run K steps in one dispatch; ``batches``/``masks`` leaves carry a
        leading dim K (:meth:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed.grouped_batches`
        yields them).  Returns the final step's loss as a device scalar.
        The ``[K]`` per-step losses go to the metrics recorder (a dense
        TensorBoard curve); window boundaries sync only the on-device loss
        mean, and the grad-norm mean stays on the device for the health
        gauges: within a window nothing is read back to the host.

        On the card the steps are replays of the cached CUDA graph (see
        :meth:`_graph_steps`), on the CPU K eager steps.  A replay keeps
        the optimizer's non-tensor hyperparameters (a float ``lr``) as
        they were at capture, so a replay after one of them changed raises
        instead; a tensor hyperparameter written in place reaches every
        replay.
        ``donate_batches`` is the JAX signature's and is ignored: the port
        never donates.  Each replay reads a copy of its slot, so the
        stacks' memory returns to the allocator as soon as the caller drops
        them."""
        del donate_batches
        batches, masks = self._prepare(batches, masks, stacked=True)
        k = int(masks.shape[0])
        self._aot_dispatch("multi_%d" % k, batches, masks)
        return self._dispatch_group(
            k, lambda i: (_map(batches, lambda t: t[i]), masks[i]))

    def repeat_step(self, batch, mask, k):
        """Run ``k`` steps on one batch in one dispatch (the synthetic-
        benchmark twin of :meth:`multi_step`); returns the final step's
        loss, with the same per-step accounting."""
        batch, mask = self._prepare(batch, mask)
        self._aot_dispatch("repeat_%d" % int(k), batch, mask)
        return self._dispatch_group(int(k), lambda i: (batch, mask))

    def _dispatch_group(self, k, slot):
        """``k`` steps, step i on ``slot(i) -> (batch, mask)``: the
        per-step losses and grad norms stay on the device."""
        if self.device.type == "cuda":
            losses, grad_norms = self._graph_steps(k, slot)
        else:
            results = [self._counted_step(*slot(i)) for i in range(k)]
            losses = torch.stack([r[0] for r in results])
            grad_norms = torch.stack([r[2] for r in results])
        self._health_grad_norm = grad_norms.mean()
        self._note_dispatch(k)
        self.history.on_steps_end(k, losses, window_value=losses.mean())
        return losses[-1]

    # -- the warm-start compile plane -------------------------------------

    def set_aot_cache(self, cache):
        """Attach a warm-start artifact store (a directory path or
        :class:`~tensorflowonspark_torch.compilecache.AOTCache`).  No-op when
        one is already attached, so :func:`fit_supervised` can default the
        store beside the checkpoint root without clobbering an explicit
        ctor choice."""
        if self._aot is not None or cache is None:
            return
        from tensorflowonspark_torch import compilecache

        self._aot = (cache if isinstance(cache, compilecache.AOTCache)
                     else compilecache.AOTCache(cache))

    def _aot_resolve(self, name, batch, mask):
        """The artifact of program ``name``, or None (eager dispatch, no
        store).  The first call per name decides: a fingerprint-matched
        artifact installs the kernel libraries without ``nvcc`` (the
        warm-rejoin path); a cold store builds them once and persists them
        for the next restart.  Either way the time counts toward
        ``train_compile_us_max``.  Shape drift after resolution is handled
        at dispatch (:meth:`_aot_dispatch`)."""
        if self._aot is None:
            return None
        if name in self._aot_exec:
            return self._aot_exec[name]
        from tensorflowonspark_torch import compilecache

        optimizer = self.state.optimizer
        if self._aot_program_id is None:
            # the Python half of the program — avals alone cannot tell two
            # losses (or two learning rates) with identical shapes apart
            self._aot_program_id = compilecache.program_identity(
                self.loss_fn, self._optimizer_factory,
                "%s.%s" % (type(optimizer).__module__,
                           type(optimizer).__qualname__), optimizer.defaults)
        fp = compilecache.fingerprint(
            avals=(self.state.params, self.state.extra, batch, mask),
            mesh=self.mesh, donate=(),
            extra={"program": name, "accum_steps": self.accum_steps,
                   "compute_dtype": str(self.compute_dtype),
                   "program_id": self._aot_program_id,
                   "program_version": self._aot_program_version,
                   # output-structure revision of the loop programs (the
                   # JAX package's; kept so both stores read alike)
                   "loop_rev": 2})
        compiled, verdict, micros = compilecache.load_or_compile(
            self._aot, name, fp, compilecache.KernelSet.compile,
            (self.device,))
        self._aot_verdicts[name] = verdict
        self._compile_secs = (self._compile_secs or 0.0) + micros / 1e6
        if verdict == "loaded":
            # loud on purpose: this program runs PRE-EXISTING stored
            # libraries — the fingerprint vouches for versions/device/
            # avals/program identity, the operator should still see which
            # store they came from
            logger.warning(
                "AOT program %s: loaded %d kernel librar%s from %s (%.1f "
                "ms, no nvcc; program_id %s)", name, len(compiled.names),
                "y" if len(compiled.names) == 1 else "ies",
                self._aot.directory, micros / 1e3, self._aot_program_id[:12])
        else:
            logger.info("AOT program %s: %s (%.1f ms)", name, verdict,
                        micros / 1e3)
        self._aot_exec[name] = compiled
        self._aot_signature[name] = _signature(batch, mask)
        return compiled

    def _aot_dispatch(self, name, batch, mask):
        """Resolve program ``name`` before its dispatch.  A program whose
        batch shapes drift from those it resolved for (e.g. an odd tail
        batch) reverts to plain eager dispatch for good, as the JAX
        Trainer reverts a shape-locked executable to JIT.  The dispatch
        itself is the same either way: the artifact's libraries are the
        ones the step launches."""
        if self._aot is None:
            return
        if name not in self._aot_exec:
            self._aot_resolve(name, batch, mask)
        elif (self._aot_exec[name] is not None
              and _signature(batch, mask) != self._aot_signature[name]):
            logger.warning(
                "AOT program %s: batch shapes drifted from its artifact's; "
                "reverting this program to eager dispatch", name)
            self._aot_exec[name] = None

    # -- CUDA graphs ------------------------------------------------------

    def _graph_steps(self, k, slot):
        """``k`` optimizer steps on the card: eager steps on the capture
        stream until this batch signature has had
        :data:`GRAPH_WARMUP_STEPS` (they are real steps: the first
        dispatch's own first steps), then one capture, then a replay per
        step.  Returns the ``[k]`` losses and grad norms, copies on the
        device (a replay overwrites the graph's own outputs)."""
        _check_capturable(self.state.optimizer)
        losses = torch.empty(k, device=self.device)
        grad_norms = torch.empty(k, device=self.device)
        for i in range(k):
            batch, mask = slot(i)
            key = _signature(batch, mask)
            graph = self._graphs.get(key)
            if graph is None and self._warmups.get(key, 0) < \
                    GRAPH_WARMUP_STEPS:
                loss, grad_norm = self._warmup_step(key, batch, mask)
            else:
                if graph is None:
                    graph = self._capture(key, batch, mask)
                else:
                    graph.check_hyperparameters(self.state.optimizer)
                    graph.load(batch, mask)
                graph.replay()
                self.state.step += 1
                loss, grad_norm = graph.loss, graph.grad_norm
            losses[i] = loss
            grad_norms[i] = grad_norm
        return losses, grad_norms

    def _side_stream(self):
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(device=self.device)
        current = torch.cuda.current_stream(self.device)
        self._capture_stream.wait_stream(current)
        return self._capture_stream, current

    def _warmup_step(self, key, batch, mask):
        """One eager step on the capture stream before ``key``'s capture;
        its wall time (synchronised) counts toward ``compile_secs``."""
        t0 = time.perf_counter()
        stream, current = self._side_stream()
        with torch.cuda.stream(stream):
            loss, _, grad_norm = self._counted_step(batch, mask)
        current.wait_stream(stream)
        stream.synchronize()
        self._warmups[key] = self._warmups.get(key, 0) + 1
        self._compile_secs = ((self._compile_secs or 0.0)
                              + time.perf_counter() - t0)
        return loss, grad_norm

    def _capture(self, key, batch, mask):
        """Capture one optimizer step on ``batch``'s signature into a CUDA
        graph whose static buffers hold ``batch`` and ``mask``.  Capture
        runs nothing, so the caller replays it for this batch.  Other
        threads (the infeed's prefetch, the checkpoint writer) may make
        CUDA calls meanwhile: the capture's error mode is thread-local.
        A failed capture raises; nothing falls back to eager steps, and
        the process's CUDA random-number state may be left mid-capture, so
        the error ends the run."""
        t0 = time.perf_counter()
        static_batch = _map(batch, lambda t: t.clone())
        static_mask = mask.clone()
        stream, current = self._side_stream()
        self.state.optimizer.zero_grad(set_to_none=True)
        before = _kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            # no profiler starts, stops or synchronizes the card meanwhile
            with profiling_mod.cuda_graph_lock, \
                    torch.cuda.graph(graph, stream=stream,
                                     capture_error_mode="thread_local"):
                loss, _, grad_norm = self._step_math(static_batch,
                                                     static_mask)
        except RuntimeError as err:
            raise RuntimeError(
                "capturing the train step as a CUDA graph failed (batch "
                "signature {}): {}".format(key, err)) from err
        current.wait_stream(stream)
        launches = {name: n - before[name]
                    for name, n in _kernels.launch_counts().items()}
        _kernels.add_launches({name: -n for name, n in launches.items()})
        stepped = [p for g in self.state.optimizer.param_groups
                   for p in g["params"]]
        entry = _StepGraph(graph, static_batch, static_mask, loss, grad_norm,
                           [p.grad for p in stepped],
                           launches,
                           _frozen_hyperparameters(self.state.optimizer))
        self._graphs[key] = entry
        self._compile_secs = ((self._compile_secs or 0.0)
                              + time.perf_counter() - t0)
        logger.info("captured the train step as a CUDA graph (%s) after %d "
                    "warm-up steps: %.3f s with the warm-ups", key,
                    self._warmups.get(key, 0), self._compile_secs)
        return entry

    # -- the loop ---------------------------------------------------------

    def apply_knob(self, name, value):
        """Live-knob hook (``node.apply_knobs``; :meth:`fit_feed` registers
        the trainer).  Returns True when claimed.

        ``train_steps_per_call`` is claimed, so a push is acknowledged (the
        :class:`ShardedFeed` of the same process regroups at its next
        group-fill start; ``train_steps_per_call_max`` shows the K that
        ran).

        ``train_rollback`` is the poison-step command: ``value`` is a
        one-shot token (knob pushes are re-broadcast on every heartbeat, so
        a token seen before is acknowledged and dropped).  A new token arms
        a halt: the next dispatch boundary of :meth:`fit_feed` (a group
        boundary at K > 1) raises
        :class:`~tensorflowonspark_torch.fault.PoisonRollback`, which
        :func:`fit_supervised` turns into a validated restore: poisoned
        checkpoint steps are quarantined as ``<step>.corrupt`` and training
        resumes from the last valid one."""
        if name == "train_rollback":
            token = str(value)
            if token not in self._rollback_tokens:
                self._rollback_tokens.add(token)
                self._rollback_req = token
            return True
        return name == "train_steps_per_call"

    def fit_feed(self, feed, max_steps=None, steps_per_call=1, on_steps=None,
                 transfer_guard=None):
        """Train from ``feed`` until it ends (or ``max_steps``); returns the
        final stats.

        ``feed`` is any object whose ``batches()`` yields ``(batch, mask)``
        (a :class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed` in
        a cluster); when it has ``terminate()``, an early stop calls it so
        its producers unblock, and its ``counters_snapshot()`` joins
        ``stats["overlap"]``.  The fault injector of ``TFOS_FAULT_SPEC``
        (straggler sleep, one NaN batch) hooks every dispatch, as in the
        JAX Trainer, and the trainer's counters ride this node's
        heartbeats.  Each dispatch is a ``train/dispatch`` trace span.  An
        armed ``train_rollback`` (:meth:`apply_knob`) halts the loop at the
        next dispatch boundary: ``feed.terminate()``, a
        ``train/rollback_halt`` instant, then
        :class:`~tensorflowonspark_torch.fault.PoisonRollback`.  On any exit
        the feed's iterator is closed, so its prefetch thread winds down.

        ``steps_per_call`` > 1 pulls K-step groups from the feed's
        ``grouped_batches(K)`` and runs each as one :meth:`multi_step`;
        single items (a feed's tail) run through :meth:`repeat_step` with
        k = 1, so on the card a padded final batch replays the same graph.
        Leaving ``steps_per_call=1`` reads :data:`STEPS_PER_CALL_ENV`.
        ``max_steps`` is an **absolute** target for ``state.step``: steps
        taken before count toward it, and a group may overshoot it by at
        most K-1.  ``on_steps``: optional ``fn(steps_done)`` called after
        every dispatch, the hook for periodic checkpoints (``lambda s:
        ckpt.maybe_save(s, trainer.state)``).

        ``transfer_guard``: opt-in hot-loop invariant — every dispatch runs
        under :class:`_TransferGuard` at this level (``"disallow"`` /
        ``"log"``; ``None`` reads :data:`TRANSFER_GUARD_ENV`), so a batch
        that is NOT already on the device (a host->device copy sneaking
        back onto the dispatch path) is a hard error instead of a silent
        step-time regression.  The guard wraps only the dispatch calls,
        not the feed pulls: the infeed's own copies stay legal.  The
        dispatch counter is registered for step-counted profile captures
        (``GET /profile?steps=N``).  A feed on a mesh (a
        :class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed` with
        ``mesh=``) must lay its rows out over the Trainer's batch axes:
        ``ValueError`` otherwise."""
        from tensorflowonspark_torch import node as node_mod

        feed_mesh = getattr(feed, "mesh", None)
        if self.mesh is not None and feed_mesh is not None and (
                mesh_mod.batch_axes_of(feed_mesh, feed.batch_axes)
                != mesh_mod.batch_axes_of(self.mesh, self.batch_axes)):
            raise ValueError(
                "the feed's rows are over {} but the Trainer's over "
                "{}".format(
                    mesh_mod.batch_axes_of(feed_mesh, feed.batch_axes),
                    mesh_mod.batch_axes_of(self.mesh, self.batch_axes)))
        node_mod._register_feed(self)
        # weakly: the registration outlives this call, the trainer need not
        this = weakref.ref(self)
        profiling_mod.register_step_counter(lambda: this()._dispatch_count)
        guard_level = _resolve_transfer_guard(transfer_guard)
        tracer = telemetry.get_tracer()
        injector = fault_mod.from_env()
        steps_per_call = int(steps_per_call)
        if steps_per_call <= 1:
            env_k = os.environ.get(STEPS_PER_CALL_ENV, "")
            if env_k:
                try:
                    steps_per_call = max(int(env_k), 1)
                except ValueError:
                    logger.warning("ignoring non-integer %s=%r",
                                   STEPS_PER_CALL_ENV, env_k)
        if steps_per_call > 1:
            source = feed.grouped_batches(steps_per_call)
        else:
            source = (("single", b, m) for b, m in feed.batches())
        # Cross-process flow: a data-service feed hands over the flow id of
        # the split a dispatched batch (or group of K) came from
        # (ServiceFeed / ShardedFeed ``pop_dispatch_flow``); ending the flow
        # here closes the worker-serve -> commit -> infeed -> dispatch
        # chain.  Duck-typed and optional: plain feeds have no flows.
        pop_flow = getattr(feed, "pop_dispatch_flow", None)
        last_loss = None
        steps_done = self.state.step
        prev_return = None
        try:
            for kind, batch, mask in source:
                if self._rollback_req is not None:
                    # the poison-step command: every further step would
                    # train on poisoned params; stop dispatching, unblock
                    # the feed's producers, hand over to fit_supervised
                    token, self._rollback_req = self._rollback_req, None
                    if hasattr(feed, "terminate"):
                        feed.terminate()
                    tracer.instant("train/rollback_halt", step=steps_done,
                                   token=token)
                    raise fault_mod.PoisonRollback(step=steps_done,
                                                   token=token)
                injector.on_step(steps_done)
                batch = injector.corrupt_batch(batch, steps_done)
                start = time.perf_counter()
                if prev_return is not None:
                    gap_us = int((start - prev_return) * 1e6)
                    self._dispatch_gap_us += gap_us
                    self._dispatch_gap_us_hwm = max(
                        self._dispatch_gap_us_hwm, gap_us)
                    # the gap net of the previous on_steps hook went to
                    # the feed
                    self._goodput_infeed_starved_us += max(
                        0, gap_us - self._last_drain_us)
                with tracer.span("train/dispatch", kind=kind), \
                        _transfer_guard_ctx(guard_level):
                    if kind == "multi":
                        loss = self.multi_step(batch, mask)
                        steps_done += int(mask.shape[0])
                    elif steps_per_call > 1:
                        loss = self.repeat_step(batch, mask, 1)
                        steps_done += 1
                    else:
                        loss, _ = self.step(batch, mask)
                        steps_done += 1
                prev_return = time.perf_counter()
                self._goodput_dispatch_us += int((prev_return - start) * 1e6)
                self._dispatch_count += 1
                self._account_windows()
                if pop_flow is not None:
                    fid = pop_flow()
                    if fid:
                        tracer.flow_end("dataservice/split_flow", fid,
                                        leg="train_dispatch", kind=kind,
                                        steps_done=steps_done)
                last_loss = loss
                if on_steps is not None:
                    drain_t0 = time.perf_counter()
                    on_steps(steps_done)
                    self._last_drain_us = int(
                        (time.perf_counter() - drain_t0) * 1e6)
                    self._goodput_ckpt_drain_us += self._last_drain_us
                else:
                    self._last_drain_us = 0
                if max_steps and steps_done >= max_steps:
                    if hasattr(feed, "terminate"):
                        feed.terminate()
                    break
        finally:
            # however the loop ends, close the feed's iterator: a
            # ShardedFeed's prefetch thread winds down with it
            close = getattr(source, "close", None)
            if close is not None:
                close()
        overlap = dict(self.counters_snapshot())
        if hasattr(feed, "counters_snapshot"):
            overlap.update(feed.counters_snapshot())
        if self.history:
            self.history.on_train_end(last_loss)
            stats = self.history.log_stats(
                loss=None if last_loss is None else float(last_loss))
        else:
            stats = {}
        stats["overlap"] = overlap
        stats["megastep"] = {
            "steps_per_call": steps_per_call,
            "steps_per_call_last": self._steps_per_call_gauge or 1,
            "group_assembly": (getattr(feed, "group_assembly", None)
                               if steps_per_call > 1 else None),
            # the port donates neither (see multi_step)
            "donate_state": False,
            "donate_batches": False,
        }
        return stats

    def restore_latest(self, ckpt_manager, validate=False):
        """Restore the newest checkpoint of ``ckpt_manager`` into this
        trainer's state (params, optimizer state, extra state, step), in
        place, so a captured CUDA graph stays valid; returns the restored
        step, or None when there is no checkpoint yet.

        ``validate=True`` uses
        :meth:`~tensorflowonspark_torch.checkpoint.CheckpointManager.restore_latest_valid`:
        a partial, corrupt or nonfinite newest step is quarantined and the
        previous retained step restored instead."""
        restore = (ckpt_manager.restore_latest_valid if validate
                   else ckpt_manager.restore_latest)
        # loaded to the host: the params are copied into place and the
        # optimizer puts its state where its own policy keeps it
        state, step = restore(map_location="cpu")
        if step is None:
            return None
        self.state.load_state_dict(state)
        logger.info("trainer state restored at step %d", step)
        return step

    def evaluate(self, feed, metric_fn, cache_key=None):
        """Exact evaluation over ``feed.batches(drain="all")`` (every
        process's rows count: an exhausted process steps zero-mask dummies
        while others still have rows).

        ``metric_fn(params[, extra], batch, mask) -> (sums, weight)`` (the
        extra state passed when the trainer has one, e.g. a ResNet's
        running averages) runs under ``torch.no_grad()`` per batch:
        ``sums`` a dict of mask-weighted sums over the batch, ``weight`` its real-row count (``mask.sum()``
        for per-row metrics).  Sums and weights add up on the device; one
        readback at the end.  Returns ``{name: sum / max(weight, 1)}``,
        e.g. top-1 accuracy from ``{"accuracy": ((pred == label) *
        mask).sum()}, mask.sum()``.  In a multi-process world the caller's
        ``metric_fn`` reduces across processes, if it wants global figures.

        ``cache_key`` is the JAX signature's key for its jit cache; eager
        PyTorch compiles nothing, so nothing is cached and it is
        ignored."""
        del cache_key
        totals, weight_total = None, None
        with torch.no_grad():
            for batch, mask in feed.batches(drain="all"):
                batch = _map(batch, lambda t: torch.as_tensor(t).to(
                    self.device))
                mask = torch.as_tensor(mask).to(self.device, torch.float32)
                if self.state.extra is None:
                    sums, weight = metric_fn(self.state.params, batch, mask)
                else:
                    sums, weight = metric_fn(self.state.params,
                                             self.state.extra, batch, mask)
                sums = {k: torch.as_tensor(v, device=self.device)
                        for k, v in sums.items()}
                weight = torch.as_tensor(weight, device=self.device)
                if totals is None:
                    totals, weight_total = sums, weight
                else:
                    totals = {k: totals[k] + v for k, v in sums.items()}
                    weight_total = weight_total + weight
        if totals is None:
            return {}
        names = sorted(totals)
        values = torch.stack([weight_total.float()]
                             + [totals[k].float() for k in names]).tolist()
        weight_total = max(values[0], 1.0)
        return {k: v / weight_total for k, v in zip(names, values[1:])}

    # -- accounting -------------------------------------------------------

    def counters_snapshot(self):
        """Flat dispatch, goodput, step-time, health and attribution
        counters under the JAX Trainer's names (see its
        ``counters_snapshot``): ``train_steps_per_call_max`` the session's
        largest K, ``train_compile_us_max`` the CUDA graph warm-up and
        capture wall time (when a graph was captured),
        ``train_step_bytes_max`` the first step's counted bytes,
        ``goodput_recovery_us`` :func:`fit_supervised`'s restores and
        backoff, ``train_rollbacks_total`` its poison rollbacks, and
        ``attrib_<bucket>_pct_max`` of :meth:`attribution_report` once a
        window closed."""
        snap = {
            "dispatch_count": self._dispatch_count,
            "dispatch_gap_us": self._dispatch_gap_us,
            "dispatch_gap_us_hwm": self._dispatch_gap_us_hwm,
        }
        if self._steps_total:
            snap["train_steps_total"] = self._steps_total
        if self._steps_per_call_hwm:
            snap["train_steps_per_call_max"] = self._steps_per_call_hwm
        if self._step_ms_count:
            running = 0
            for bound in metrics_mod.STEP_MS_BUCKETS:
                running += self._step_ms_hist.get(bound, 0)
                snap["step_ms_le_%s" % bound] = running
            snap["step_ms_count"] = self._step_ms_count
            snap["step_ms_sum_us"] = self._step_ms_sum_us
        for key, val in (
                ("goodput_dispatch_us", self._goodput_dispatch_us),
                ("goodput_infeed_starved_us", self._goodput_infeed_starved_us),
                ("goodput_ckpt_drain_us", self._goodput_ckpt_drain_us),
                ("goodput_recovery_us", self._goodput_recovery_us)):
            if val:
                snap[key] = val
        if self._mfu_pct is not None:
            snap["train_mfu_pct_max"] = round(self._mfu_pct, 4)
        if self._flops_per_sec is not None:
            snap["train_flops_per_sec_max"] = self._flops_per_sec
        if self._health_windows:
            snap["train_health_windows"] = self._health_windows
            snap["train_nonfinite_loss"] = self._nonfinite_loss
            snap["train_nonfinite_grad"] = self._nonfinite_grad
            if self._health_loss is not None:
                snap["train_loss_max"] = self._health_loss
            if self._health_grad is not None:
                snap["train_grad_norm_max"] = round(self._health_grad, 6)
        if self._compile_secs is not None:
            snap["train_compile_us_max"] = int(self._compile_secs * 1e6)
        if self._step_bytes:
            snap["train_step_bytes_max"] = self._step_bytes
        if self._rollbacks:
            snap["train_rollbacks_total"] = self._rollbacks
        attrib = self.attribution_report()
        if attrib:
            for name, pct in attrib.items():
                snap["attrib_%s_max" % name] = round(pct, 4)
        return snap

    def attribution_report(self):
        """Decompose the closed-window step-loop wall time into the
        :data:`~tensorflowonspark_torch.metrics.ATTRIBUTION_BUCKETS`
        percentages (summing to 100), or None before the first window
        closes (the JAX Trainer's report).

        ``device_compute`` is closed-window steps times the roofline's
        ``ideal_step_seconds`` from the first step's counted FLOPs and
        bytes (0 on the CPU, which has no peak rates); ``collective`` is 0
        (no timing source, as in the JAX package); ``infeed_starved`` and
        ``ckpt_drain`` are the goodput tallies; ``unattributed`` is the
        rest: the device below its roofline plus host work the other
        buckets do not see."""
        measured_us = self._step_ms_sum_us
        if not measured_us:
            return None
        ideal = (self._roofline or {}).get("ideal_step_seconds")
        device_us = self._step_ms_count * ideal * 1e6 if ideal else 0.0
        return metrics_mod.attribute_step_time(
            measured_us, device_us,
            infeed_starved_us=self._goodput_infeed_starved_us,
            ckpt_drain_us=self._goodput_ckpt_drain_us)

    def _account_windows(self):
        """Fold newly closed TimeHistory windows into the step-time
        histogram and the MFU / FLOP/s gauges (window boundaries are device
        synced, so these are device times)."""
        hist = self.history
        if hist is None:
            return
        if hist is not self._acct_history:
            self._acct_history = hist
            self._windows_seen = 1
        elif self._windows_seen >= len(hist.timestamp_log):
            return
        before = self._windows_seen
        log = hist.timestamp_log
        while self._windows_seen < len(log):
            s0, t0 = log[self._windows_seen - 1]
            s1, t1 = log[self._windows_seen]
            self._windows_seen += 1
            steps, span = s1 - s0, t1 - t0
            if steps <= 0 or span <= 0:
                continue
            step_s = span / steps
            for bound in metrics_mod.STEP_MS_BUCKETS:
                if step_s * 1e3 <= bound:
                    self._step_ms_hist[bound] = (
                        self._step_ms_hist.get(bound, 0) + steps)
                    break
            self._step_ms_count += steps
            self._step_ms_sum_us += int(span * 1e6)
            flops_ps = metrics_mod.achieved_flops_per_sec(hist.step_flops,
                                                          step_s)
            if flops_ps is not None:
                self._flops_per_sec = flops_ps
            mfu = hist.mfu(step_s)
            if mfu is not None:
                self._mfu_pct = 100.0 * mfu
        if self._windows_seen != before:
            self._sync_health(hist)

    def _sync_health(self, hist):
        """Fold one boundary's loss and grad norm into the health gauges:
        the boundary just synced, so reading them stalls nothing.  The
        synced value is a step's loss or a K-step dispatch's loss mean
        (NaN and Inf propagate through the mean)."""
        self._health_windows += 1
        val = hist.last_synced_value
        if val is not None:
            arr = np.asarray(val, dtype=np.float64).ravel()
            self._nonfinite_loss += int((~np.isfinite(arr)).sum())
            if arr.size and math.isfinite(arr[-1]):
                self._health_loss = float(arr[-1])
        gnorm, self._health_grad_norm = self._health_grad_norm, None
        if gnorm is not None:
            gval = float(gnorm)
            if math.isfinite(gval):
                self._health_grad = gval
            else:
                self._nonfinite_grad += 1


def _publish(spec, trainer, ckpt_manager, stats, tracer):
    """``fit_supervised``'s train-to-serve handoff: the chief publishes the
    full params (gathered on every rank: a collective under a sharded
    state) into ``stats["published"]``, or reports its failure in
    ``stats["publish_error"]``."""
    from tensorflowonspark_torch import fleet as fleet_mod

    try:
        params = trainer.state.full_params()
        if not ckpt_manager.is_chief:
            return
        with tracer.span("train/publish"):
            stats["published"] = fleet_mod.publish_trained(
                spec, params, int(trainer.state.step))
        logger.info("supervised fit: published %s@%s to registry",
                    stats["published"]["model"],
                    stats["published"]["version"])
    except Exception as e:
        # the training run succeeded; a handoff failure is reported, not
        # raised
        logger.warning("train-to-serve publish failed", exc_info=True)
        stats["publish_error"] = repr(e)


#: poison rollbacks one fit_supervised call takes before it re-raises (a
#: bound on a pathological loop, e.g. every checkpoint quarantined and the
#: state in memory poisoned too)
MAX_ROLLBACKS = 4


def fit_supervised(trainer, feed_factory, ckpt_manager, retry_policy=None,
                   max_steps=None, steps_per_call=1, profiler=None,
                   transfer_guard=None, publish=None):
    """Supervised :meth:`Trainer.fit_feed` (the JAX package's
    ``fit_supervised``): restore the newest valid checkpoint, train with
    periodic checkpoints, and on a retryable failure back off, restore and
    try again from the last saved step.

    Args:
      trainer: a :class:`Trainer`; its current state seeds the first
        attempt when no checkpoint exists yet.
      feed_factory: zero-argument callable returning a FRESH feed per
        attempt (a feed whose consumer failed mid-batch cannot be reused).
        It is called after the attempt's restore, so it may read
        ``trainer.state.step`` to start where training resumes.
      ckpt_manager: a
        :class:`~tensorflowonspark_torch.checkpoint.CheckpointManager`;
        ``maybe_save`` runs after every dispatch, and a final ``force``
        save has landed when this returns.
      retry_policy: a :class:`~tensorflowonspark_torch.fault.RetryPolicy`
        (the default policy when None).  Only retryable failures re-enter
        the loop; user-code errors re-raise at once.
      max_steps / steps_per_call / transfer_guard: forwarded to
        :meth:`Trainer.fit_feed`.
      profiler: optional
        :class:`~tensorflowonspark_torch.profiler.StepProfiler`; it is
        stepped once per dispatch and used as a context manager around
        every attempt, so an exception mid-capture stops the trace instead
        of leaking it into the retry's capture.
      publish: optional train-to-serve handoff spec
        (:func:`~tensorflowonspark_torch.fleet.publish_trained`): after the
        final checkpoint lands, the run's finiteness-validated params are
        exported and published to the model registry as a ``staging``
        version, which a running canary controller walks to live with no
        operator action.  The registry entry rides the stats dict as
        ``stats["published"]``; a publish failure is logged and reported
        as ``stats["publish_error"]`` without failing the (already
        successful) training run.  The chief publishes, inside a
        ``train/publish`` span; under a sharded state every rank first
        joins the gather of the full params.

    The AOT artifact store (``Trainer(aot_cache=)``) defaults to
    :func:`~tensorflowonspark_torch.checkpoint.aot_root` beside a local
    checkpoint root; a remote root skips it.

    Every attempt opens with ``trainer.restore_latest(validate=True)`` in a
    ``train/restore`` span and trains in a ``train/fit_attempt`` span.  The
    chief registers an emergency save with
    :func:`~tensorflowonspark_torch.node.on_preemption` (a SIGTERM lands
    the current step past the interval gate) and removes it on the way
    out.  A :class:`~tensorflowonspark_torch.fault.PoisonRollback` (the
    ``train_rollback`` knob) loops back to the validated restore with no
    backoff and no attempt used, at most :data:`MAX_ROLLBACKS` times, with
    a ``train/rollback`` instant.  Another error that the policy retries
    emits ``train/retry``, sleeps the backoff and adds it, with the
    restores, to ``goodput_recovery_us``.

    Returns the final fit stats dict."""
    from tensorflowonspark_torch import node as node_mod

    policy = retry_policy or fault_mod.RetryPolicy()
    tracer = telemetry.get_tracer()

    # Warm-start default: the AOT artifact store lives beside the
    # checkpoints, so a restarted/replacement supervisor that can see the
    # checkpoint root can also see the stored kernel libraries (restore and
    # warm rejoin share one directory tree).  set_aot_cache is a no-op when
    # the Trainer ctor already chose a store.  Remote roots skip the
    # default: AOTCache is local-filesystem only, and a store silently
    # landing on node-local disk would LOOK shared while never warming a
    # rejoining node.
    from tensorflowonspark_torch import checkpoint as ckpt_mod
    from tensorflowonspark_torch import fsio

    if fsio.is_remote(ckpt_manager.directory):
        logger.info(
            "checkpoint root %s is remote; warm-start AOT store not "
            "auto-attached (pass Trainer(aot_cache=<shared local mount>) "
            "to opt in)", ckpt_manager.directory)
    else:
        try:
            trainer.set_aot_cache(ckpt_mod.aot_root(ckpt_manager.directory))
        except (OSError, ValueError) as e:  # read-only roots: optional
            logger.warning("AOT store beside checkpoints unavailable (%s); "
                           "training proceeds without it", e)

    def _emergency_save():
        # the preemption drain: land whatever progress exists before the
        # process unwinds, past the interval gate
        step = int(trainer.state.step)
        logger.warning("preemption: emergency checkpoint at step %d", step)
        ckpt_manager.maybe_save(step, trainer.state, force=True)
        ckpt_manager.wait_until_finished()

    # chief-only: it runs inside a signal handler on one process, so it
    # cannot be a collective, and only the chief writes
    if ckpt_manager.is_chief:
        node_mod.on_preemption(_emergency_save)

    def _on_steps(step):
        ckpt_manager.maybe_save(step, trainer.state)
        if profiler is not None:
            profiler.on_step_end()

    def _fit_once():
        return trainer.fit_feed(feed_factory(), max_steps=max_steps,
                                steps_per_call=steps_per_call,
                                on_steps=_on_steps,
                                transfer_guard=transfer_guard)

    attempt = 0
    rollbacks = 0
    try:
        while True:
            restore_t0 = time.perf_counter()
            with tracer.span("train/restore", attempt=attempt + 1):
                restored = trainer.restore_latest(ckpt_manager, validate=True)
            trainer._goodput_recovery_us += int(
                (time.perf_counter() - restore_t0) * 1e6)
            if restored is not None:
                logger.info("supervised fit: resuming from checkpoint step "
                            "%d", restored)
            try:
                with tracer.span("train/fit_attempt", attempt=attempt + 1,
                                 restored_step=restored):
                    # the context-manager form: stop() runs on the
                    # exception path too, so a failed attempt cannot leak
                    # an active trace into the next attempt's capture
                    with (profiler if profiler is not None
                          else contextlib.nullcontext()):
                        stats = _fit_once()
                ckpt_manager.maybe_save(int(trainer.state.step),
                                        trainer.state, force=True)
                ckpt_manager.wait_until_finished()
                if publish:
                    _publish(publish, trainer, ckpt_manager, stats, tracer)
                return stats
            except fault_mod.PoisonRollback as rb:
                # a control-plane command, not a failure: no attempt used,
                # no backoff
                rollbacks += 1
                if rollbacks > MAX_ROLLBACKS:
                    raise
                trainer._rollbacks = rollbacks
                logger.warning(
                    "poison rollback %d/%d at step %s: restoring the last "
                    "VALID checkpoint (poisoned steps quarantined as "
                    "<step>.corrupt)", rollbacks, MAX_ROLLBACKS, rb.step)
                tracer.instant("train/rollback", step=rb.step,
                               token=rb.token, rollbacks=rollbacks)
            except Exception as e:
                attempt += 1
                if (not policy.is_retryable(e)
                        or attempt >= policy.max_attempts):
                    raise
                delay = policy.backoff(attempt - 1)
                logger.warning(
                    "supervised fit attempt %d/%d failed (%s: %s); restoring "
                    "the latest checkpoint and retrying in %.1fs", attempt,
                    policy.max_attempts, type(e).__name__, e, delay)
                tracer.instant("train/retry", attempt=attempt,
                               delay_secs=delay, error=repr(e))
                time.sleep(delay)
                # the backoff is recovery wall time: the card sits idle
                trainer._goodput_recovery_us += int(delay * 1e6)
    finally:
        node_mod.remove_preemption_callback(_emergency_save)
