"""Throughput, step-time and MFU instrumentation, peak rates and roofline
bounds of the port's CUDA cards (the counterpart of
:mod:`tensorflowonspark_tpu.metrics`).

Peaks are keyed on the full lowercased ``torch.cuda.get_device_name()``
(exact match: a prefix rule would let one part's figures pass for
another's).  Figures are NVIDIA's data-sheet peaks at the full power limit,
dense (no sparsity); a card set below its limit runs slower, so a bound
computed from them is the least time, never a promise.  There is no CPU
entry: on the CPU, MFU is None.
"""

import importlib
import json
import logging
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tensorflowonspark_torch.wire import compression_ratio  # noqa: F401

logger = logging.getLogger(__name__)

# dense FLOP/s by compute dtype, and device memory bytes/s
PEAKS = {
    # H100 SXM5 80GB: 989.4 TFLOP/s bf16/fp16 tensor, 67 TFLOP/s fp32
    # (CUDA cores), 3.35 TB/s HBM3
    "nvidia h100 80gb hbm3": {
        "flops": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12},
        "bytes_per_sec": 3.35e12,
    },
    # H100 PCIe 80GB: 756 TFLOP/s bf16/fp16 tensor, 51 TFLOP/s fp32,
    # 2.0 TB/s HBM2e
    "nvidia h100 pcie": {
        "flops": {"bfloat16": 756e12, "float16": 756e12, "float32": 51e12},
        "bytes_per_sec": 2.0e12,
    },
}

# Step-time histogram bucket upper bounds, in milliseconds (the JAX
# package's, so the Trainer's ``step_ms_le_<bound>`` counters keep their
# names).
STEP_MS_BUCKETS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000)

# Serving latency histogram bucket upper bounds, in microseconds (the JAX
# package's): the gateway's ``serving_*_us_le_<bound>`` heartbeat counters
# for the queue/coalesce/dispatch/serialize stages and the end-to-end
# ``serving_latency_us`` family.
SERVING_US_BUCKETS = (50, 100, 250, 500, 1000, 2500, 5000, 10000, 25000,
                      50000, 100000, 250000, 500000, 1000000)


def device_memory_counters():
    """Card memory high-water marks as heartbeat counters, under the JAX
    package's gauge names: ``device_mem_bytes_in_use_hwm`` (bytes the
    caching allocator holds for tensors now) and
    ``device_mem_peak_bytes_hwm`` (its peak), the max over this process's
    cards, from ``torch.cuda.memory_stats``.

    This runs on the heartbeat thread, which must never be what
    initializes CUDA (seconds of start-up, and a forked node could no
    longer use the card): a process that has not initialized CUDA
    contributes ``{}``."""
    out = {}
    try:
        if not torch.cuda.is_initialized():
            return out
        in_use = peak = 0
        for index in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(index)
            in_use = max(in_use, int(stats.get("allocated_bytes.all.current",
                                               0)))
            peak = max(peak, int(stats.get("allocated_bytes.all.peak", 0)))
        out["device_mem_bytes_in_use_hwm"] = in_use
        out["device_mem_peak_bytes_hwm"] = peak
    except Exception:  # metrics must never cost a heartbeat
        logger.debug("device memory stats unavailable", exc_info=True)
    return out


def peak_rates(device_name, dtype="bfloat16"):
    """``(flops_per_sec, bytes_per_sec)`` of ``device_name`` for work in
    ``dtype``.  Raises ``KeyError`` on a device or dtype not in the table."""
    key = device_name.strip().lower()
    if key not in PEAKS:
        raise KeyError("no peak rates for device {!r}; known: {}".format(
            device_name, sorted(PEAKS)))
    entry = PEAKS[key]
    if dtype not in entry["flops"]:
        raise KeyError("no {} peak for device {!r}".format(dtype, device_name))
    return entry["flops"][dtype], entry["bytes_per_sec"]


def roofline_seconds(flops, nbytes, device_name, dtype="bfloat16"):
    """The least time ``device_name`` could take for work of ``flops``
    operations in ``dtype`` that must move ``nbytes``: the larger of the
    two times at peak rate."""
    peak_flops, peak_bw = peak_rates(device_name, dtype)
    return max(flops / peak_flops, nbytes / peak_bw)


def roofline_bound_by(flops, nbytes, device_name, dtype="bfloat16"):
    """``"operations"`` or ``"bytes"``: which of the two times sets
    :func:`roofline_seconds`."""
    peak_flops, peak_bw = peak_rates(device_name, dtype)
    return "operations" if flops / peak_flops >= nbytes / peak_bw else "bytes"


def peak_flops_per_device(device=None):
    """Dense bf16 peak FLOP/s of the CUDA card ``device`` (default: the
    current one), the MFU denominator.  None for a CPU device, with no
    card, or for a card not in :data:`PEAKS` (logged)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    try:
        return peak_rates(name)[0]
    except KeyError:
        logger.warning("unknown device %r; MFU will be reported as None",
                       name)
        return None


def peak_bytes_per_sec_per_device(device=None):
    """Device memory bytes/s of the CUDA card ``device`` (default: the
    current one), the roofline's other peak.  None for a CPU device, with
    no card, or for a card not in :data:`PEAKS` (logged)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    try:
        return peak_rates(name)[1]
    except KeyError:
        logger.warning("unknown device %r; roofline will be reported as "
                       "None", name)
        return None


def roofline(step_flops, bytes_accessed, peak_flops=None, peak_bps=None):
    """Roofline classification of one step (the JAX package's keys).

    ``peak_flops``/``peak_bps`` default to this process's card
    (:func:`peak_flops_per_device`, :func:`peak_bytes_per_sec_per_device`).
    Returns None when any input is unknowable (on the CPU, for one), else::

        {"arithmetic_intensity": flops/byte,
         "ridge_point":          peak_flops / peak_bps (flops/byte),
         "bound":                "memory" | "compute",
         "ceiling_flops_per_sec": min(peak_flops, intensity * peak_bps),
         "ideal_step_seconds":   step_flops / ceiling}

    ``ideal_step_seconds`` is the device-compute bucket of the attribution
    report (:func:`attribute_step_time`)."""
    if peak_flops is None:
        peak_flops = peak_flops_per_device()
    if peak_bps is None:
        peak_bps = peak_bytes_per_sec_per_device()
    if not step_flops or not bytes_accessed or not peak_flops or not peak_bps:
        return None
    intensity = step_flops / bytes_accessed
    ridge = peak_flops / peak_bps
    ceiling = min(peak_flops, intensity * peak_bps)
    return {
        "arithmetic_intensity": intensity,
        "ridge_point": ridge,
        "bound": "memory" if intensity < ridge else "compute",
        "ceiling_flops_per_sec": ceiling,
        "ideal_step_seconds": step_flops / ceiling,
    }


#: Attribution bucket names, in report order.  The buckets decompose one
#: measured wall duration of the step loop and always sum to 100%.
ATTRIBUTION_BUCKETS = ("device_compute", "collective", "infeed_starved",
                       "ckpt_drain", "unattributed")


def attribute_step_time(measured_us, device_compute_us, collective_us=0.0,
                        infeed_starved_us=0.0, ckpt_drain_us=0.0):
    """Decompose ``measured_us`` of step-loop wall time into percentage
    buckets that sum to exactly 100 (the JAX package's function, copied).

    ``device_compute_us`` is the roofline-ideal device time (steps x
    :func:`roofline` ``ideal_step_seconds``); ``collective_us`` estimated
    communication time; ``infeed_starved_us``/``ckpt_drain_us`` the goodput
    counters.  The remainder is ``unattributed``: device inefficiency plus
    host overhead the other buckets cannot see.  When the named buckets
    overshoot the measurement they are scaled down proportionally so the
    report never claims more than 100% of the wall.  Returns None when
    ``measured_us`` is not positive."""
    measured = float(measured_us)
    if measured <= 0:
        return None
    named = [max(float(v), 0.0) for v in (device_compute_us, collective_us,
                                          infeed_starved_us, ckpt_drain_us)]
    total_named = sum(named)
    if total_named > measured:
        scale = measured / total_named
        named = [v * scale for v in named]
        total_named = measured
    parts = named + [measured - total_named]
    return {"%s_pct" % name: 100.0 * v / measured
            for name, v in zip(ATTRIBUTION_BUCKETS, parts)}


def achieved_flops_per_sec(step_flops, step_seconds):
    """Achieved per-device FLOP/s for one step (None when unknowable)."""
    if not step_flops or not step_seconds or step_seconds <= 0:
        return None
    return step_flops / step_seconds


def mfu_from_step_time(step_flops, step_seconds, peak=None):
    """MFU for one step from per-device FLOPs and wall seconds: FLOPs over
    ``peak`` (default :func:`peak_flops_per_device`) over seconds.  The one
    formula :meth:`TimeHistory.mfu` and the Trainer's gauges share."""
    if peak is None:
        peak = peak_flops_per_device()
    if peak is None or not step_flops or not step_seconds or step_seconds <= 0:
        return None
    return step_flops / peak / step_seconds


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of the tensor inputs and outputs of every aten op
    dispatched under it, views left out (they move no data): the byte half
    of :func:`estimate_step_cost`."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.total += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _count_inside_kernel_ops():
    """The flash kernels are opaque custom ops; both counters see inside
    them, as they saw the plain versions and the kernel wrappers before."""
    from torch.utils import flop_counter

    fa = importlib.import_module(
        "tensorflowonspark_torch.ops.flash_attention")
    fa.see_inside(_ByteCounter)
    fa.see_inside(getattr(flop_counter, "_FlopCounterMode",
                          flop_counter.FlopCounterMode))


_count_inside_kernel_ops()


def estimate_step_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under
    ``torch.utils.flop_counter.FlopCounterMode`` and a byte counter;
    returns ``({"flops", "bytes_accessed", "compile_secs"}, result)``.

    Unlike XLA's cost analysis it needs a real run, so the caller passes
    the work it wants done anyway (the Trainer's first step) and gets its
    result back.  ``flops`` counts the matrix products PyTorch dispatches,
    forward and backward.  ``bytes_accessed`` sums, over every aten op
    dispatched, the bytes of its tensor inputs and outputs (views left
    out): the eager program's own traffic, op by op, which is XLA's
    "bytes accessed" applied to an unfused program.  Like XLA with Pallas,
    neither count sees the hand-written CUDA kernels (the Trainer's
    ``extra_step_flops`` adds their FLOPs; their bytes stay uncounted).  On
    CPU tensors the plain versions of those kernels run as PyTorch ops and
    are counted.  Either figure is None when nothing was counted.
    ``compile_secs`` is None: an eager step compiles nothing (the Trainer
    reports a CUDA graph's warm-up and capture time itself)."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with flops, nbytes:
        result = fn(*args, **kwargs)
    return {"flops": flops.get_total_flops() or None,
            "bytes_accessed": nbytes.total or None,
            "compile_secs": None}, result


def _host_value(value):
    """A readback of ``value`` to the host: a Python float for a scalar
    tensor (``.item()`` waits for the device work that produced it), a
    numpy array for a larger one; other values pass through."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        return value.item() if value.numel() == 1 else value.cpu().numpy()
    return value


class TimeHistory(object):
    """Per-N-step timing and throughput recorder (the JAX package's
    ``TimeHistory``).

    Call :meth:`on_step_end(value)` once per step, or
    :meth:`on_steps_end(n, ...)` once per dispatch of ``n`` steps, with a
    device value that depends on that dispatch (the loss).  CUDA work is
    asynchronous, so at every window boundary the recorder reads the value
    back to the host before it reads the clock: window times are device
    times, and steps within a window still queue freely.
    ``timestamp_log`` holds ``(global_steps, time)`` per boundary, as in
    the JAX package.  With a ``summary_writer``
    (:class:`~tensorflowonspark_torch.summary.SummaryWriter`, chief-only by
    the caller's convention) each window's scalars and the per-step loss
    curve land in TensorBoard."""

    def __init__(self, batch_size, log_steps=20, step_flops=None,
                 peak_flops=None, summary_writer=None):
        self.batch_size = batch_size
        self.log_steps = log_steps
        self.step_flops = step_flops  # FLOPs per step on the one device
        self.peak_flops = peak_flops  # None: peak_flops_per_device()
        self.summary_writer = summary_writer
        self.global_steps = 0
        self.timestamp_log = []
        self.train_start_time = None
        self.start_time = None
        self.elapsed = 0.0
        # per-step loss vectors of K-step dispatches, kept as DEVICE
        # tensors (reading them per dispatch would sync every group) and
        # drained into the writer at window boundaries, which sync anyway
        self._pending_losses = []
        self._loss_curve_end = 0  # last step the per-step curve covers
        #: host copy of the value the last boundary synced on (the loss, or
        #: a K-step dispatch's on-device loss mean)
        self.last_synced_value = None

    def on_train_begin(self):
        self.train_start_time = time.time()
        self.start_time = time.time()
        self.timestamp_log.append((0, self.start_time))

    def on_step_end(self, value=None):
        self.on_steps_end(1, value)

    def on_steps_end(self, n, value=None, window_value=None):
        """Record ``n`` steps completed by one dispatch (n > 1 for
        ``Trainer.multi_step``).  A window closes whenever the step counter
        crosses a multiple of ``log_steps``; window lengths are tracked in
        steps exactly, so throughput stays honest when a boundary lands
        mid-group.

        ``value`` may be the dispatch's ``[n]`` per-step loss vector: with a
        summary writer the loss curve keeps one point per step (buffered on
        the device, written at boundaries).  ``window_value``, a device
        scalar summarising the dispatch (the group's loss mean), is what a
        boundary syncs on when given, so the readback stays O(1) in n."""
        if self.train_start_time is None:
            self.on_train_begin()
        before = self.global_steps
        self.global_steps += n
        vec = value if getattr(value, "ndim", 0) else None
        if vec is not None and self.summary_writer is not None:
            self._pending_losses.append((before, vec))
        if self.global_steps // self.log_steps > before // self.log_steps:
            synced = _host_value(
                window_value if window_value is not None else value)
            if synced is not None:
                self.last_synced_value = synced
            now = time.time()
            window_steps = self.global_steps - self.timestamp_log[-1][0]
            elapsed = now - self.start_time
            eps = self.batch_size * window_steps / elapsed
            msg = "step %d: %.1f examples/sec, %.1f ms/step" % (
                self.global_steps, eps, 1000 * elapsed / window_steps)
            mfu = self.mfu(elapsed / window_steps)
            if mfu is not None:
                msg += ", %.1f%% MFU" % (100 * mfu)
            logger.info(msg)
            if self.summary_writer is not None:
                flushed_loss = self._drain_pending_losses()
                scalars = {"examples_per_sec": eps,
                           "ms_per_step": 1000 * elapsed / window_steps}
                if mfu is not None:
                    scalars["mfu"] = mfu
                if synced is not None and not flushed_loss and np.size(
                        synced) == 1:
                    scalars["loss"] = float(np.asarray(synced).ravel()[0])
                self.summary_writer.add_scalars(scalars, self.global_steps)
                # per window: live dashboards update mid-run, and a killed
                # job keeps its curves
                self.summary_writer.flush()
            self.timestamp_log.append((self.global_steps, now))
            self.start_time = now

    def _drain_pending_losses(self):
        """Write the buffered per-step loss vectors; True if any point was
        written."""
        for s0, vec in self._pending_losses:
            arr = np.asarray(_host_value(vec.float())).ravel()
            for i, loss in enumerate(arr):
                self.summary_writer.add_scalars({"loss": float(loss)},
                                                s0 + i + 1)
            self._loss_curve_end = max(self._loss_curve_end, s0 + len(arr))
        drained = bool(self._pending_losses)
        self._pending_losses = []
        return drained

    def on_train_end(self, value=None):
        synced = _host_value(value)
        if synced is not None:
            self.last_synced_value = synced
        self.elapsed = time.time() - self.train_start_time
        if self.summary_writer is not None and self._pending_losses:
            # the curve's tail: steps since the last boundary
            self._drain_pending_losses()
            self.summary_writer.flush()

    def mfu(self, step_seconds):
        return mfu_from_step_time(self.step_flops, step_seconds,
                                  self.peak_flops)

    def avg_examples_per_second(self):
        log = self.timestamp_log
        if len(log) >= 2:
            steps = log[-1][0] - log[0][0]
            elapsed = log[-1][1] - log[0][1]
            return self.batch_size * steps / elapsed if elapsed > 0 else 0.0
        if self.elapsed and self.global_steps:
            # run shorter than one window: the synced whole-run elapsed
            return self.batch_size * self.global_steps / self.elapsed
        return 0.0

    def build_stats(self, loss=None, eval_loss=None, accuracy=None):
        eps = self.avg_examples_per_second()
        stats = {
            "global_steps": self.global_steps,
            "avg_exp_per_second": eps,
            "exp_per_second_per_chip": eps,   # one device
            "train_finish_time": time.time(),
            "elapsed_seconds": self.elapsed,
        }
        avg_step = (self.elapsed / self.global_steps
                    if self.global_steps and self.elapsed else None)
        if avg_step:
            stats["avg_step_seconds"] = avg_step
            mfu = self.mfu(avg_step)
            if mfu is not None:
                stats["mfu"] = mfu
        if loss is not None:
            stats["loss"] = float(loss)
        if eval_loss is not None:
            stats["eval_loss"] = float(eval_loss)
        if accuracy is not None:
            stats["accuracy_top_1"] = float(accuracy)
        return stats

    def log_stats(self, **kwargs):
        stats = self.build_stats(**kwargs)
        logger.info("train stats: %s", json.dumps(stats, default=float))
        if self.summary_writer is not None:
            keys = ["loss", "avg_exp_per_second", "avg_step_seconds",
                    "mfu", "eval_loss", "accuracy_top_1"]
            if self._loss_curve_end >= self.global_steps:
                keys.remove("loss")  # the per-step curve has this point
            final = {k: float(stats[k]) for k in keys if k in stats}
            self.summary_writer.add_scalars(final, self.global_steps)
            self.summary_writer.flush()
        return stats
