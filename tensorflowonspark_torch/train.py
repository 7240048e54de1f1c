"""Trainer: the port's training loop (the counterpart of
:mod:`tensorflowonspark_tpu.train`, its ``steps_per_call=1`` path).

The JAX Trainer jits a functional step over a pytree sharded on a mesh;
here the step runs eagerly on one device per process: the loss and its
backward through autograd (the flash attention kernels' backward
included), the global grad norm on the device, and one ``torch.optim``
step that updates the params in place.  Nothing in a step reads a value
back to the host: the loss and grad norm stay device scalars until a
:class:`~tensorflowonspark_torch.metrics.TimeHistory` window boundary syncs
on them.

In a ``torch.distributed`` world of more than one process (data
parallelism, each process a local batch of the global one, as
:class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed` yields them)
the step all-reduces the gradients so that the update is the JAX
Trainer's over the global batch, a padded final batch included: with
``loss_fn`` a masked mean over rows (every loss of the model zoo), each
rank's gradient is weighted by its valid rows over the global valid-row
count before the sum.  Every rank then applies identical gradients.
"""

import dataclasses
import logging
import math
import time
from typing import Any

import torch
import torch.distributed as dist

from tensorflowonspark_torch import fault as fault_mod
from tensorflowonspark_torch import metrics as metrics_mod
from tensorflowonspark_torch.device import resolve_device

logger = logging.getLogger(__name__)

# constructor arguments of the JAX Trainer that this port does not take yet:
# (JAX default, the ROADMAP.md item that ports it)
_UNPORTED = {
    "mesh": (None, "Queue 1, the parallelism slice"),
    "param_sharding": (None, "Queue 1, the parallelism slice (FSDP)"),
    "accum_steps": (1, "Queue 1, the module queue: accum_steps"),
    "aot_cache": (None, "Queue 1, the compile plane"),
    "summary_writer": (None, "Queue 1, the module queue: summary writer"),
}
_MEGASTEP_TODO = ("multi-step dispatch (steps_per_call > 1, multi_step, "
                  "repeat_step) is not ported yet (ROADMAP.md, Queue 1, the "
                  "module queue: multi_step as CUDA graphs)")


@dataclasses.dataclass
class TrainState:
    """The step counter, the params (a name->tensor dict, updated in place)
    and the optimizer that holds their state."""

    step: int
    params: dict
    optimizer: Any

    def state_dict(self):
        """``{"step", "params", "opt_state"}``: what a checkpoint holds."""
        return {"step": self.step, "params": self.params,
                "opt_state": self.optimizer.state_dict()}

    def load_state_dict(self, state):
        """Copy a :meth:`state_dict` into this state, in place."""
        with torch.no_grad():
            for name, t in self.params.items():
                t.copy_(state["params"][name])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


class Trainer(object):
    """Runs training steps on one device.

    Args:
      loss_fn: ``fn(params, batch, mask) -> (loss, aux)``, ``params`` a
        name->tensor dict; ``mask`` is the per-row validity mask (1.0 = real
        row), which the loss must apply.
      init_params: name->tensor dict (e.g. a converted flax tree); the
        trainer copies it onto its device.
      optimizer: a factory ``params -> torch.optim.Optimizer``, e.g.
        ``functools.partial(torch.optim.Adam, lr=1e-3)`` for ``optax.adam``.
      compute_dtype: cast floating batch inputs to this dtype in the step
        (the model's own ``dtype`` sets its compute precision).
      batch_size: global batch size, for throughput metrics.
      log_steps: TimeHistory window.
      extra_step_flops: FLOPs per step that ``FlopCounterMode`` cannot see:
        the hand-written kernels' work (for the flash LM, 7·S²·D·B·H·layers).
        Added to the counted figure for MFU.
      step_flops_override: the whole MFU numerator, stated by the model
        owner; no counting happens.
      device: ``"cuda"`` by default; ``"cpu"`` only when asked.

    ``mesh``, ``param_sharding``, ``accum_steps``, ``aot_cache`` and
    ``summary_writer`` raise ``NotImplementedError`` at any value other
    than the JAX default: they are not ported yet.
    """

    def __init__(self, loss_fn, init_params, optimizer, compute_dtype=None,
                 batch_size=None, log_steps=20, extra_step_flops=0,
                 step_flops_override=None, device=None, **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError("Trainer() got an unexpected keyword "
                                "argument {!r}".format(name))
            default, item = _UNPORTED[name]
            if value != default:
                raise NotImplementedError(
                    "Trainer({}=...) is not ported yet (ROADMAP.md, "
                    "{})".format(name, item))
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.compute_dtype = compute_dtype
        self.batch_size = batch_size
        self.log_steps = log_steps
        self.extra_step_flops = extra_step_flops
        self.step_flops_override = step_flops_override
        params = {name: torch.as_tensor(t).detach().to(self.device, copy=True)
                  .requires_grad_(True) for name, t in init_params.items()}
        self.state = TrainState(step=0, params=params,
                                optimizer=optimizer(list(params.values())))
        self.history = None
        # dispatch-overlap and goodput tallies (the JAX Trainer's keys):
        # host-side time between one step returning and the next starting
        self._dispatch_count = 0
        self._dispatch_gap_us = 0
        self._dispatch_gap_us_hwm = 0
        self._goodput_dispatch_us = 0
        self._goodput_infeed_starved_us = 0
        self._goodput_ckpt_drain_us = 0
        self._last_drain_us = 0
        self._step_ms_hist = {}      # bucket bound (ms) -> window steps
        self._step_ms_count = 0      # steps covered by closed windows
        self._step_ms_sum_us = 0     # wall us covered by closed windows
        self._mfu_pct = None         # latest closed window's MFU, percent
        self._flops_per_sec = None   # latest achieved FLOP/s
        self._acct_history = None    # TimeHistory the accountant follows
        self._windows_seen = 0       # timestamp_log entries consumed
        # training health, read at window boundaries only
        self._health_grad_norm = None  # device scalar from the last step
        self._health_windows = 0
        self._health_loss = None       # last FINITE loss
        self._health_grad = None       # last finite grad norm
        self._nonfinite_loss = 0
        self._nonfinite_grad = 0
        self._steps_total = 0

    # -- the step ---------------------------------------------------------

    def _prepare(self, batch, mask):
        """The batch and mask on the device; floating batch inputs cast to
        ``compute_dtype``; a missing mask is all ones."""
        def put(x):
            t = torch.as_tensor(x).to(self.device)
            if self.compute_dtype is not None and t.is_floating_point():
                t = t.to(self.compute_dtype)
            return t

        batch = _map(batch, put)
        if mask is None:
            mask = torch.ones(_first_leaf(batch).shape[0], device=self.device)
        else:
            mask = torch.as_tensor(mask).to(self.device, torch.float32)
        return batch, mask

    def _grads(self, batch, mask):
        """Loss, aux and the params' ``.grad`` of one batch."""
        self.state.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn(self.state.params, batch, mask)
        loss.backward()
        return loss.detach(), aux

    def _allreduce(self, loss, grads, mask):
        """Sum the ranks' gradients in place, each weighted by its valid
        rows over the global valid-row count, so they become the gradient
        of the masked mean over the global batch; returns that mean's loss.
        One all-reduce of the two counts, one of the flattened gradients,
        both on the default group (NCCL on the card)."""
        rows = mask.sum()
        totals = torch.stack([rows, loss * rows])
        dist.all_reduce(totals)
        global_rows = totals[0].clamp_min(1.0)
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat.mul_(rows / global_rows)
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return totals[1] / global_rows

    def _step_core(self, batch, mask):
        """One optimizer step: ``(loss, aux, grad_norm)``, device scalars;
        in a multi-process world the loss and gradients are the global
        batch's."""
        loss, aux = self._grads(batch, mask)
        grads = [p.grad for p in self.state.params.values()
                 if p.grad is not None]
        if dist.is_initialized() and dist.get_world_size() > 1:
            loss = self._allreduce(loss, grads, mask)
        grad_norm = torch.nn.utils.get_total_norm(grads)
        self.state.optimizer.step()
        self.state.step += 1
        return loss, aux, grad_norm

    def _new_history(self, step_flops):
        self.history = metrics_mod.TimeHistory(
            batch_size=self.batch_size or 0, log_steps=self.log_steps,
            step_flops=step_flops,
            peak_flops=metrics_mod.peak_flops_per_device(self.device))
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

    def compile_and_measure(self, example_batch, example_mask=None):
        """Build the kernels and count the per-step FLOPs for MFU with one
        forward and backward on ``example_batch`` (the params do not
        change; their grads are cleared).  Returns the step FLOPs."""
        if self.history is None:
            counted = None
            if self.step_flops_override is None:
                batch, mask = self._prepare(example_batch, example_mask)
                counted, _ = metrics_mod.estimate_step_flops(
                    self._grads, batch, mask)
                self.state.optimizer.zero_grad(set_to_none=True)
            self._new_history(self._step_flops(counted))
        return self.history.step_flops

    def reset_history(self):
        """Replace the metrics recorder with a fresh one (same step FLOPs),
        so warmup steps stay out of the reported stats.  No-op before the
        first step."""
        if self.history is not None:
            self._new_history(self.history.step_flops)

    def step(self, batch, mask=None):
        """Run one step on the whole batch; returns ``(loss, aux)``, the
        loss a device scalar.  The first step also counts the step FLOPs
        (under ``FlopCounterMode``) unless :meth:`compile_and_measure` did."""
        batch, mask = self._prepare(batch, mask)
        if self.history is None:
            self._new_history(None)
            if self.step_flops_override is None:
                counted, result = metrics_mod.estimate_step_flops(
                    self._step_core, batch, mask)
            else:
                counted, result = None, self._step_core(batch, mask)
            self.history.step_flops = self._step_flops(counted)
        else:
            result = self._step_core(batch, mask)
        loss, aux, self._health_grad_norm = result
        self._steps_total += 1
        # TimeHistory syncs on the loss at window boundaries: honest
        # ms/step and MFU; within a window the steps queue freely
        self.history.on_step_end(loss)
        return loss, aux

    def multi_step(self, batches, masks, donate_batches=False):
        raise NotImplementedError(_MEGASTEP_TODO)

    def repeat_step(self, batch, mask, k):
        raise NotImplementedError(_MEGASTEP_TODO)

    # -- the loop ---------------------------------------------------------

    def fit_feed(self, feed, max_steps=None, steps_per_call=1, on_steps=None):
        """Train from ``feed`` until it ends (or ``max_steps``); returns the
        final stats.

        ``feed`` is any object whose ``batches()`` yields ``(batch, mask)``
        (a :class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed` in
        a cluster); when it has ``terminate()``, an early stop calls it so
        its producers unblock, and its ``counters_snapshot()`` joins
        ``stats["overlap"]``.  The fault injector of ``TFOS_FAULT_SPEC``
        (straggler sleep, one NaN batch) hooks every step, as in the JAX
        Trainer, and the trainer's counters ride this node's heartbeats.
        ``max_steps`` is an **absolute** target for ``state.step``: steps
        taken before count toward it.  ``on_steps``: optional
        ``fn(steps_done)`` called after every step, the hook for periodic
        checkpoints (``lambda s: ckpt.maybe_save(s, trainer.state)``).
        ``steps_per_call`` > 1 is not ported yet."""
        if int(steps_per_call) > 1:
            raise NotImplementedError(_MEGASTEP_TODO)
        from tensorflowonspark_torch import node as node_mod

        node_mod._register_feed(self)
        injector = fault_mod.from_env()
        last_loss = None
        steps_done = self.state.step
        prev_return = None
        for batch, mask in feed.batches():
            injector.on_step(steps_done)
            batch = injector.corrupt_batch(batch, steps_done)
            start = time.perf_counter()
            if prev_return is not None:
                gap_us = int((start - prev_return) * 1e6)
                self._dispatch_gap_us += gap_us
                self._dispatch_gap_us_hwm = max(self._dispatch_gap_us_hwm,
                                                gap_us)
                # the gap net of the previous on_steps hook went to the feed
                self._goodput_infeed_starved_us += max(
                    0, gap_us - self._last_drain_us)
            loss, _ = self.step(batch, mask)
            steps_done += 1
            prev_return = time.perf_counter()
            self._goodput_dispatch_us += int((prev_return - start) * 1e6)
            self._dispatch_count += 1
            self._account_windows()
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
            "steps_per_call": 1,
            "steps_per_call_last": 1,
            "group_assembly": None,
            "donate_state": False,
            "donate_batches": False,
        }
        return stats

    def restore_latest(self, ckpt_manager, validate=False):
        """Restore the newest checkpoint of ``ckpt_manager`` into this
        trainer's state (params, optimizer state, step); returns the
        restored step, or None when there is no checkpoint yet."""
        if validate:
            raise NotImplementedError(
                "restore_latest(validate=True) needs restore_latest_valid, "
                "which is not ported yet (ROADMAP.md, Queue 1, the module "
                "queue: restore_latest_valid)")
        # loaded to the host: the params are copied into place and the
        # optimizer puts its state where its own policy keeps it
        state, step = ckpt_manager.restore_latest(map_location="cpu")
        if step is None:
            return None
        self.state.load_state_dict(state)
        logger.info("trainer state restored at step %d", step)
        return step

    # -- accounting -------------------------------------------------------

    def counters_snapshot(self):
        """Flat dispatch, goodput, step-time and health counters under the
        JAX Trainer's names (see its ``counters_snapshot``)."""
        snap = {
            "dispatch_count": self._dispatch_count,
            "dispatch_gap_us": self._dispatch_gap_us,
            "dispatch_gap_us_hwm": self._dispatch_gap_us_hwm,
        }
        if self._steps_total:
            snap["train_steps_total"] = self._steps_total
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
                ("goodput_ckpt_drain_us", self._goodput_ckpt_drain_us)):
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
        return snap

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
        the boundary just synced, so reading them stalls nothing."""
        self._health_windows += 1
        val = hist.last_synced_value
        if val is not None:
            val = float(val)
            if math.isfinite(val):
                self._health_loss = val
            else:
                self._nonfinite_loss += 1
        gnorm, self._health_grad_norm = self._health_grad_norm, None
        if gnorm is not None:
            gval = float(gnorm)
            if math.isfinite(gval):
                self._health_grad = gval
            else:
                self._nonfinite_grad += 1
