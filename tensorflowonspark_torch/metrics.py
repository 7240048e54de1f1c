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

import json
import logging
import time

import torch

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


def estimate_step_flops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under
    ``torch.utils.flop_counter.FlopCounterMode``; returns ``(flops,
    result)``.

    Unlike XLA's cost analysis it needs a real run, so the caller passes
    the work it wants done anyway (the Trainer's first step) and gets its
    result back.  It counts the matrix products PyTorch dispatches,
    forward and backward; like XLA with Pallas it cannot see the
    hand-written CUDA kernels, whose FLOPs the model owner adds (the
    Trainer's ``extra_step_flops``).  On CPU tensors the plain versions of
    those kernels run as PyTorch ops and are counted.  None when nothing
    was counted."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        result = fn(*args, **kwargs)
    return counter.get_total_flops() or None, result


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
    ``TimeHistory``, without its summary writer).

    Call :meth:`on_step_end(value)` once per step with a device value that
    depends on that step (the loss).  CUDA work is asynchronous, so at every
    window boundary the recorder reads ``value`` back to the host
    (``.item()``) before it reads the clock: window times are device times,
    and steps within a window still queue freely.  ``timestamp_log`` holds
    ``(global_steps, time)`` per boundary, as in the JAX package."""

    def __init__(self, batch_size, log_steps=20, step_flops=None,
                 peak_flops=None):
        self.batch_size = batch_size
        self.log_steps = log_steps
        self.step_flops = step_flops  # FLOPs per step on the one device
        self.peak_flops = peak_flops  # None: peak_flops_per_device()
        self.global_steps = 0
        self.timestamp_log = []
        self.train_start_time = None
        self.start_time = None
        self.elapsed = 0.0
        #: host copy of the value the last boundary synced on (the loss)
        self.last_synced_value = None

    def on_train_begin(self):
        self.train_start_time = time.time()
        self.start_time = time.time()
        self.timestamp_log.append((0, self.start_time))

    def on_step_end(self, value=None):
        """Record one step; close a window when the step counter reaches a
        multiple of ``log_steps``."""
        if self.train_start_time is None:
            self.on_train_begin()
        self.global_steps += 1
        if self.global_steps % self.log_steps == 0:
            synced = _host_value(value)
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
            self.timestamp_log.append((self.global_steps, now))
            self.start_time = now

    def on_train_end(self, value=None):
        synced = _host_value(value)
        if synced is not None:
            self.last_synced_value = synced
        self.elapsed = time.time() - self.train_start_time

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

    def build_stats(self, loss=None):
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
        return stats

    def log_stats(self, loss=None):
        stats = self.build_stats(loss)
        logger.info("train stats: %s", json.dumps(stats, default=float))
        return stats
