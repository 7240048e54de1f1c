#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``tensorflowonspark_torch/csrc/``, holds each kernel against its plain
PyTorch version at the shapes the serving and training paths give it (and
at head_dim 32, 64 and 128, fp32 and bf16, causal and not) and times both
(and one PyTorch library call as a yardstick): CUDA events around the
calls, and the kernels' own device time from ``torch.profiler``.  Each row
names the variant that ran, its product path (``wgmma`` on the tensor cores
or ``fma``) and its ptxas registers.  Then it drives the flagship transformer LM (vocab 32000, 8
layers, 16 heads x 64, 1024 tokens, bf16, ``attention="flash"``, random
weights from a seed) along both paths:

- serve: ``serving.ModelServer`` answers requests; every attention went
  through the forward kernel and the logits agree with the same weights
  served with ``attention="full"``;
- train: ``train.Trainer.fit_feed`` takes 30 Adam steps on a learnable
  token stream with async checkpoints every 10; every attention went
  through the forward and both backward kernels, the loss falls, the flash
  gradients agree with full attention's, a Trainer restored from the last
  checkpoint steps exactly as the original, and the trained export serves
  the trained model's logits; the steady step is timed on batches already
  on the card, the Trainer's capturable Adam interleaved with a trainer
  made with ``capturable=False`` (whose losses at steps 10, 20 and 30 are
  reported beside);
- train at K = 5: the same init and stream through ``fit_feed(max_steps=30,
  steps_per_call=5)``: every step after two eager warm-ups is a replay of
  one captured CUDA graph; the kernels' launches (the counters, which a
  replay advances by the launches its capture recorded, held to the flash
  kernels ``torch.profiler`` saw the card execute), the losses at steps 10,
  20 and 30 against K = 1's, a steady step and a profile of warm groups of
  5 on device-resident stacks, the capture time, the step-time attribution
  at K = 1 and K = 5, and a restore into the trainer that captured;
- cluster: the Spark-style lifecycle in SPARK input mode, ``cluster.run``
  on a one-executor ``LocalBackend``: the node forks its manager and its
  user-fn child, which loads the kernels this process built, trains the
  same LM from rows that ``TPUCluster.train`` pushes through the node's
  queue (``DataFeed`` -> ``ShardedFeed``: pinned copies to the card on a
  side stream -> ``Trainer.fit_feed``) and exports it as the chief; after
  ``shutdown()`` this process serves the export.  Every row trained once,
  every attention went through the three kernels in the child, the loss
  falls, and the served logits are the trained model's.  This process
  initialized CUDA in the phases before; the executor is a spawned
  process, so nothing forks from here.  Then again with
  ``TFOS_STEPS_PER_CALL=5`` in the executor's environment: 4 groups of 5
  and a padded single, all graph replays after the warm-ups, with the
  losses at steps 10 and 20 against the K = 1 cluster run's.  In both
  cluster runs the node's ``fit_feed`` runs under ``torch.profiler`` (CUDA
  activity only), and its launch counters are held to the flash kernels
  the card executed;
- supervised: the same LM, init and stream at K = 5 through
  ``train.fit_supervised`` with checkpoints every 10 steps: (a) a feed
  that fails (retryably) after step 15, resumed from step 10, ends at step
  30 with the params of the train-at-K = 5 phase's uninterrupted run; (b)
  the same after the ``corrupt_checkpoint`` fault garbled the newest step,
  which is quarantined as ``<step>.corrupt``; (c) a NaN batch at step 16
  poisons the params, the ``train_rollback`` knob pushed through
  ``node.apply_knobs`` halts the run, the poisoned step is quarantined and
  training resumes from the last valid one; (d) ``accum_steps=2`` and (e)
  ``remat=True`` at K = 1 and K = 5 beside plain runs on the same batches,
  with their peak memory and steady step (remat's losses equal the plain
  run's; accum's one step from the same params equals the full batch's,
  and its K = 5 run its K = 1 run); (f) ``Trainer.evaluate`` of the
  trained params over 20 held-out rows (two full batches and a padded
  one), flash against full attention.  The launch counters of (a), (d),
  (e) and (f) are held to the flash kernels the profiler saw the card
  execute.

Each phase prints one JSON line; any failure raises and the exit code is
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  It needs
one card; without CUDA, or without the package beside it, it fails.
"""

import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the flagship LM (bench.py's LM leg) at full width, served in batches of 4
LM_CONFIG = {"vocab_size": 32000, "num_layers": 8, "num_heads": 16,
             "head_dim": 64, "max_seq_len": 1024, "attention": "flash",
             "dtype": "bfloat16"}
SEQ = 1024
SERVE_BATCH = 4
REQUESTS = (4, 4, 3, 1)
# the bench LM leg's training run: batch 8 x 1024 tokens, Adam lr 1e-3,
# fp32 params under bf16 compute
TRAIN_BATCH = 8
TRAIN_STEPS = 30
LOG_STEPS = 10
LR = 1e-3
STEADY_STEPS = 10    # warm steps timed after the checks
PROFILE_STEPS = 3    # warm steps under torch.profiler
# the steady K = 1 step with capturable Adam (the Trainer's default on the
# card) and with capturable=False, runs of STEADY_STEPS interleaved
AB_ROUNDS = 5

# kernel vs plain, same inputs.  O: fp32 sums in another order (1e-4 at
# |O| <= 4); bf16 O rounds to 8 mantissa bits (2e-2 is one bf16 step below
# |O| = 4).  L is fp32 on both sides.
O_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
L_TOL = 5e-4
# served logits, flash vs full attention, same bf16 weights: the two paths
# round the attention output to bf16 from fp32 values that differ in the
# last fp32 bits, and 8 bf16 layers amplify an occasional one-step flip;
# 3e-2 of max|logit| holds that with margin, while a wrong kernel moves
# logits by O(max|logit|)
LOGIT_TOL = 3e-2

# backward kernels vs plain, same inputs, relative to the largest
# gradient: dQ, dK, dV are sums of up to S products; fp32 kernels sum in
# another order than the plain einsums (1e-4 covers it), bf16 gradients
# round to 8 mantissa bits (1e-2 is about two bf16 steps of the largest).
# delta is fp32 on both sides from the same O and dO.
G_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
DELTA_TOL = 1e-4
# training checks.  Loss: the token stream is learnable (each token is the
# previous one plus 1), so 30 Adam steps take the loss at least 0.1 nats
# (1% of ln 32000) below the first step's.  Gradients, flash vs full
# attention, same bf16 weights and batch: both round attention outputs and
# gradients to bf16 from fp32 values that differ in the last bits, and 8
# layers carry that to under 1% per tensor (a CPU rehearsal at this depth
# gave 0.9%); 5e-2 of each tensor's norm holds it, a wrong kernel is off by
# O(1).  Resume: the kernels use no atomics and one process picks the same
# cuBLAS algorithms for the same shapes, so a restored Trainer's step
# should match bit for bit; 1e-6 is the stated limit.  Handoff: the server
# runs the same kernels on the same params and batch: 1e-3 of max|logit|.
LOSS_DROP = 0.1
GRAD_RTOL = 5e-2
RESUME_TOL = 1e-6
HANDOFF_TOL = 1e-3

# the cluster phase: 164 rows of 1024 tokens, fed as 4 partitions, make 20
# full steps of 8 rows and a padded final step of 4 valid rows; windows of
# 5 steps (the steady figure is the median of the windows after the first)
CLUSTER_ROWS = 164
CLUSTER_PARTS = 4
CLUSTER_LOG_STEPS = 5
CLUSTER_STEPS = -(-CLUSTER_ROWS // TRAIN_BATCH)
# the cluster node trains the train phase's init on the same token stream in
# the same order, so its loss at steps 10 and 20 is the train phase's window
# loss there; another process may pick other cuBLAS algorithms, so 1e-3
# nats, while a row out of order or corrupt moves it by O(0.1)
CLUSTER_LOSS_TOL = 1e-3
# how long the driver waits, after shutdown(), for the node's last step,
# export and report
CLUSTER_REPORT_SECS = 300

# K steps a dispatch: the train and cluster phases again at K = 5.  Graph
# replays run the same kernels on the same data; Adam in capturable mode
# computes its bias corrections as fp32 tensors, not Python floats, and
# another process may pick other cuBLAS algorithms, so the losses at steps
# 10, 20 and 30 are held to K = 1's at 1e-3 nats, while a replay that read
# a stale batch or stale optimizer state moves them by O(0.1)
MEGA_K = 5
MEGA_LOSS_TOL = 1e-3
MEGA_STEADY_GROUPS = 4     # warm groups of 5 timed on device-resident stacks
MEGA_PROFILE_GROUPS = 2    # warm groups of 5 under torch.profiler

# the supervised phase: fit_supervised at K = 5 with a save every 10 steps;
# the first feed fails after step 15 ((a); (b) after step 25, once a save
# of step 20 was garbled); a NaN batch at step 16 for (c).  A resumed run
# replays the uninterrupted run's kernels, graph and data from a restored
# state that is a bit copy, so its params are held to RESUME_TOL.
SUPERVISED_SAVE_STEPS = 10
CRASH_STEP = 15
CORRUPT_CRASH_STEP = 25
NAN_STEP = 12          # the first group at or after it: steps 16-20
# accum_steps=2 splits a batch of 8 into two of 4, and each micro-batch's
# bf16 weight gradients are rounded on their own: a different arithmetic,
# which 30 Adam steps at lr 1e-3 amplify like any other (on the card,
# Adam with capturable=False, an fp32 bias-correction difference, ends
# 5e-5, 0.026 and 0.135 nats off at steps 10, 20 and 30; PERF.md).  So the accum run's losses there
# are reported beside the plain run's, not held; what is held is one step
# from the same params and batch: the loss within 1e-3 nats and each
# gradient within GRAD_RTOL of its norm (about two bf16 steps; a
# micro-batch weighted wrongly is off by O(1)), and the K = 5 run against
# the K = 1 run at MEGA_LOSS_TOL.  remat runs the same forward twice with
# the same kernels: its losses are held to the plain run's at RESUME_TOL.
ACCUM_STEPS = 2
ACCUM_LOSS_TOL = 1e-3
REMAT_LOSS_TOL = RESUME_TOL
SUPERVISED_STEADY_GROUPS = 2
# evaluate: 20 held-out rows in batches of 8; the mean token loss and top-1
# accuracy through the flash forward against full attention on the same
# params.  LOGIT_TOL bounds a logit's difference relative to max|logit|;
# the means over 20 x 1023 tokens move far less, so both are held to
# LOGIT_TOL absolute (nats, and a share of tokens)
EVAL_ROWS = 20
EVAL_TOL = LOGIT_TOL

# (shape [B, S, H, D], dtype, causal, fused): the serving shape first, then
# the training shape
FLASH_CASES = [
    ((SERVE_BATCH, SEQ, 16, 64), "bfloat16", True, True),
    ((TRAIN_BATCH, SEQ, 16, 64), "bfloat16", True, True),
    ((2, 256, 4, 64), "float32", True, False),
    ((2, 256, 4, 64), "float32", False, False),
    ((2, 256, 4, 128), "bfloat16", True, False),
    ((2, 256, 4, 128), "float32", False, False),
    ((2, 256, 4, 32), "bfloat16", True, False),   # head_dim 32: wgmma
    ((2, 256, 4, 32), "float32", False, False),   # head_dim 32: padded to 64
    ((1, 96, 2, 64), "bfloat16", True, False),    # ragged last tile
    ((2, 256, 4, 64), "bfloat16", False, False),
]
# the backward kernels: the training shape first
BWD_CASES = [
    ((TRAIN_BATCH, SEQ, 16, 64), "bfloat16", True, True),
    ((2, 256, 4, 64), "float32", True, False),
    ((2, 256, 4, 64), "float32", False, False),
    ((2, 256, 4, 128), "bfloat16", True, False),
    ((2, 256, 4, 128), "float32", False, False),
    ((1, 96, 2, 64), "float32", True, False),     # ragged last tile
    ((2, 256, 4, 32), "bfloat16", True, False),   # head_dim 32
    ((2, 256, 4, 32), "float32", True, False),
    ((1, 96, 2, 64), "bfloat16", True, False),    # ragged, tensor cores
    ((2, 256, 4, 64), "bfloat16", False, False),
    ((1, 96, 2, 64), "bfloat16", False, False),   # ragged, not causal
    # the training token count and width (8 x 1024 tokens, 1024 channels)
    # at the other head_dims: the same FLOPs and bytes as the training shape
    ((TRAIN_BATCH, SEQ, 32, 32), "bfloat16", True, True),
    ((TRAIN_BATCH, SEQ, 8, 128), "bfloat16", True, True),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(prof):
    """The device-side events of a ``torch.profiler`` trace, less the GPU
    ranges of user annotations such as "Optimizer.step#Adam.step", which
    overlap the kernels they enclose."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]


# trailing work before a counting profiler stops (see counted_on_device)
TRACE_TAIL_KERNELS = 256
TRACE_TAIL_SECS = 0.5

# the flash kernels' names in a trace (each fragment covers the fp32 and
# the bf16 variant), by the names of the kernels line
FLASH_KERNELS = {"flash_fwd": "flash_fwd_", "flash_bwd_dq": "flash_bwd_dq_",
                 "flash_bwd_dkv": "flash_bwd_dkv_"}


def counted_on_device(torch, fn):
    """Run ``fn()`` under ``torch.profiler`` (CUDA activity only) and count
    the flash kernels the card executed, by name, whether a wrapper
    launched them or a CUDA graph replay ran them again.  Returns ``(fn's
    result, {name: executions})``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
        # the trace can miss the records of the last kernels before the
        # profiler stops (seen on the card: the last layers' backward
        # kernels of a 30-step run): trailing kernels of another name and
        # a pause give them time to land
        tail = torch.zeros(1, device="cuda")
        for _ in range(TRACE_TAIL_KERNELS):
            tail.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(TRACE_TAIL_SECS)
    counts = dict.fromkeys(FLASH_KERNELS, 0)
    for e in device_kernels(prof):
        for name, fragment in FLASH_KERNELS.items():
            if fragment in e.key:
                counts[name] += e.count
    return result, counts


def device_ms(torch, fn, iters=10, warmup=2, match=None):
    """Mean device milliseconds per call of ``fn``: the time of the kernels
    it launches, summed from a ``torch.profiler`` trace, so the host's time
    between launches is left out.  ``match`` keeps the kernels whose
    lowercased name holds it.  None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in device_kernels(prof)
                if match is None or match in e.key.lower())
    return total / 1e3 / iters if total else None


def warm_clocks(torch, seconds=1.0):
    """Keep the card busy with bf16 matmuls for about ``seconds``, so that
    its clocks have risen before the first kernel is timed."""
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def phase_device(torch, device):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    report = device.device_report()
    info = {"phase": "device", "kind": report["name"],
            "count": report["count"], "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def ptxas_usage(log):
    """``{entry function: {"registers", "spill_stores"}}`` from a build's
    ``-Xptxas -v`` output."""
    usage, entry = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
            usage[entry] = {}
        elif entry and "spill stores" in line:
            usage[entry]["spill_stores"] = int(
                re.search(r"(\d+) bytes spill stores", line).group(1))
        elif entry and "registers" in line:
            usage[entry]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return usage


def phase_build(build):
    t0 = time.perf_counter()
    results = build.build()
    usage = {}
    for r in results.values():
        usage.update(ptxas_usage(r["log"]))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": r["seconds"], "cached": r["cached"]}
                      for n, r in results.items()},
          "ptxas": usage})
    return usage


def variant(torch, fa, usage, kernel, dtype_name, head_dim):
    """``{"product_path", "kernel_head_dim", "registers", "spill_stores"}``
    of the kernel variant that runs ``kernel`` at this dtype and head_dim,
    from the ptxas entries of the build (mangled names)."""
    dtype = getattr(torch, dtype_name)
    path = fa.product_path(kernel, dtype)
    dim = fa.kernel_head_dim(kernel, dtype, head_dim)
    symbol = kernel + ("_sm90_kernel" if path == "wgmma" else "_kernel") + "I"
    names = [n for n in usage if symbol in n and "Li{}E".format(dim) in n]
    if len(names) != 1:
        raise AssertionError("no single ptxas entry for {} {} D={}: {}".format(
            kernel, dtype_name, dim, names))
    return dict(usage[names[0]], product_path=path, kernel_head_dim=dim)


def make_qkv(torch, shape, dtype, fused):
    """q, k, v on the card from a numpy seed; ``fused`` makes them strided
    views of one [B, S, 3, H, D] buffer, as the transformer gives them."""
    import numpy as np

    b, s, h, d = shape
    x = np.random.default_rng(0).standard_normal((b, s, 3, h, d))
    qkv = torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)
    if fused:
        return qkv.unbind(2)
    return tuple(qkv[:, :, i].contiguous() for i in range(3))


def flash_case(torch, F, fa, metrics, kind, usage, shape, dtype_name, causal,
               fused):
    """Check one flash_fwd case against the plain version; time kernel,
    plain and the library call; compute the roofline bound."""
    b, s, h, d = shape
    q, k, v = make_qkv(torch, shape, getattr(torch, dtype_name), fused)
    scale = 1.0 / d ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, causal, scale)
    err_o = (out.float() - want_out).abs().max().item()
    err_l = (lse - want_lse).abs().max().item()
    ok = (bool(torch.isfinite(out.float()).all()) and err_o < O_TOL[dtype_name]
          and err_l < L_TOL)

    def kernel():
        return fa._flash_fwd_cuda(q, k, v, scale, causal)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)

    kernel_ms = time_ms(torch, kernel)
    kernel_device_ms = device_ms(torch, kernel, match="flash_fwd_")
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal, scale), iters=5)
    library_ms = device_ms(torch, sdpa)
    library_events_ms = time_ms(torch, sdpa)

    pairs = s * (s + 1) // 2 if causal else s * s    # (query, key) pairs
    flops = 4 * d * pairs * b * h                    # QK^T and PV
    elt = q.element_size()
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4  # q, k, v, O; L fp32
    bound_ms = 1e3 * metrics.roofline_seconds(flops, nbytes, kind, dtype_name)
    row = {"phase": "kernel", "name": "flash_fwd", "shape": list(shape),
           "dtype": dtype_name, "causal": causal, "fused_qkv": fused,
           "max_abs_err_o": err_o, "max_abs_err_l": err_l,
           "tol_o": O_TOL[dtype_name], "tol_l": L_TOL, "ok": ok,
           "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_events_ms": library_events_ms,
           "library": "scaled_dot_product_attention forward",
           "bound_ms": bound_ms,
           "bound_by": metrics.roofline_bound_by(flops, nbytes, kind,
                                                 dtype_name),
           "flops": flops, "bytes": nbytes,
           "bound_share": bound_ms / (kernel_device_ms or kernel_ms)}
    row.update(variant(torch, fa, usage, "flash_fwd", dtype_name, d))
    emit(row)
    if not ok:
        raise AssertionError("flash_fwd disagrees with its plain version: "
                             "{}".format(row))
    return row


def bwd_case(torch, F, fa, metrics, kind, usage, shape, dtype_name, causal,
             fused):
    """Check the two backward kernels against their plain versions on one
    case; time kernels, plain versions and the library backward; compute
    each kernel's roofline bound."""
    import numpy as np

    b, s, h, d = shape
    dtype = getattr(torch, dtype_name)
    q, k, v = make_qkv(torch, shape, dtype, fused)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        shape).astype(np.float32)).to("cuda", dtype)
    scale = 1.0 / d ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, out, lse, g, scale, causal)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal)
    torch.cuda.synchronize()
    want_dq, want_delta = fa.flash_bwd_dq_plain(q, k, v, out, lse, g, causal,
                                                scale)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, g, lse, want_delta,
                                              causal, scale)
    errs, limits = {}, {}
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        errs[name] = (got.float() - want).abs().max().item()
        limits[name] = G_TOL[dtype_name] * want.abs().max().item()
    err_delta = (delta - want_delta).abs().max().item()
    limit_delta = DELTA_TOL * max(want_delta.abs().max().item(), 1.0)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (dq, dk, dv))
    ok = (finite and all(errs[n] <= limits[n] for n in errs)
          and err_delta <= limit_delta)

    def dq_kernel():
        return fa._flash_bwd_dq_cuda(q, k, v, out, lse, g, scale, causal)

    def dkv_kernel():
        return fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal)

    dq_ms = time_ms(torch, dq_kernel)
    dkv_ms = time_ms(torch, dkv_kernel)
    device = {"flash_bwd_dq": device_ms(torch, dq_kernel,
                                        match="flash_bwd_dq_"),
              "flash_bwd_dkv": device_ms(torch, dkv_kernel,
                                         match="flash_bwd_dkv_")}
    plain_dq_ms = time_ms(torch, lambda: fa.flash_bwd_dq_plain(
        q, k, v, out, lse, g, causal, scale), iters=3, warmup=1)
    plain_dkv_ms = time_ms(torch, lambda: fa.flash_bwd_dkv_plain(
        q, k, v, g, lse, delta, causal, scale), iters=3, warmup=1)
    # the library yardstick: SDPA's backward alone (dQ, dK and dV
    # together), run again and again through one retained forward graph;
    # its kernels' device time, and CUDA events around the calls
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    gt = g.transpose(1, 2)
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qt, kt, vt), gt,
                                   retain_graph=True)

    library_ms = device_ms(torch, sdpa_bwd)
    library_events_ms = time_ms(torch, sdpa_bwd)
    del sdpa_out

    pairs = s * (s + 1) // 2 if causal else s * s    # (query, key) pairs
    elt = q.element_size()
    tile = b * s * h * d * elt                       # one [B, S, H, D] tensor
    stat = b * h * s * 4                             # L or delta, fp32
    cost = {
        # S and dP recomputed, dQ: 3 products; q, k, v, O, dO and L in,
        # dQ and delta out
        "flash_bwd_dq": (6 * d * pairs * b * h, 6 * tile + 2 * stat),
        # S and dP recomputed, dK and dV: 4 products; q, k, v, dO, L and
        # delta in, dK and dV out
        "flash_bwd_dkv": (8 * d * pairs * b * h, 6 * tile + 2 * stat),
    }
    rows = []
    for name, kernel_ms, plain_ms, err in (
            ("flash_bwd_dq", dq_ms, plain_dq_ms, errs["dq"]),
            ("flash_bwd_dkv", dkv_ms, plain_dkv_ms, max(errs["dk"],
                                                        errs["dv"]))):
        flops, nbytes = cost[name]
        bound_ms = 1e3 * metrics.roofline_seconds(flops, nbytes, kind,
                                                  dtype_name)
        rows.append({
            "phase": "kernel", "name": name, "shape": list(shape),
            "dtype": dtype_name, "causal": causal, "fused_qkv": fused,
            "max_abs_err": err, "ok": ok, "kernel_ms": kernel_ms,
            "kernel_device_ms": device[name],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_events_ms": library_events_ms,
            "library": "scaled_dot_product_attention backward (dQ, dK, dV)",
            "bound_ms": bound_ms,
            "bound_by": metrics.roofline_bound_by(flops, nbytes, kind,
                                                  dtype_name),
            "flops": flops, "bytes": nbytes,
            "bound_share": bound_ms / (device[name] or kernel_ms),
            **variant(torch, fa, usage, name, dtype_name, d)})
    rows[0].update({"max_abs_err_delta": err_delta,
                    "tol_delta": limit_delta})
    for row in rows:
        row["errors"] = errs
        row["limits"] = limits
        emit(row)
    if not ok:
        raise AssertionError("flash backward kernels disagree with their "
                             "plain versions: {}".format(rows))
    return rows


def phase_serve(torch, np, fa):
    """Export the flagship LM, serve it through ModelServer on the default
    device and count the kernel's launches."""
    from tensorflowonspark_torch import checkpoint, serving
    from tensorflowonspark_torch.models import get_model

    model = get_model("transformer_lm", **LM_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    signature = {"tokens": {"shape": [None, SEQ], "dtype": "int32"}}
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, LM_CONFIG["vocab_size"], (n, SEQ),
                             dtype=np.int32) for n in REQUESTS]
    with tempfile.TemporaryDirectory() as tmp:
        flash_dir = os.path.join(tmp, "flash")
        full_dir = os.path.join(tmp, "full")
        checkpoint.export_model(flash_dir, model, "transformer_lm",
                                model_config=LM_CONFIG,
                                input_signature=signature)
        checkpoint.export_model(full_dir, model, "transformer_lm",
                                model_config=dict(LM_CONFIG,
                                                  attention="full"),
                                input_signature=signature)
        del model

        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = 0                          # the main path starts
        t0 = time.perf_counter()
        server = serving.ModelServer(flash_dir, batch_size=SERVE_BATCH)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warmed = server.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        latencies, outputs = [], []
        for tokens in requests:
            t0 = time.perf_counter()
            out = server.predict_feed({"tokens": tokens}, len(tokens))
            latencies.append(time.perf_counter() - t0)
            outputs.append(out["output"])
        launches = fa.fwd_launches                   # the main path ends
        peak_bytes = torch.cuda.max_memory_allocated()

        # where a request's time goes: the forward at the top rung on the
        # device (CUDA events), then the fp32 logits' copy back to the host
        x = torch.from_numpy(requests[0]).to(server.device)
        with torch.inference_mode():
            forward_ms = time_ms(torch, lambda: server.model(x), iters=5,
                                 warmup=1)
            logits = server.model(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serving._to_numpy(logits)
            readback_ms = 1e3 * (time.perf_counter() - t0)
            readback_bytes = logits.numel() * logits.element_size()
            del logits

        batches = warmed + len(requests)
        expected = LM_CONFIG["num_layers"] * batches
        finite = all(bool(np.isfinite(o).all()) for o in outputs)
        shapes_ok = all(o.shape == (n, SEQ, LM_CONFIG["vocab_size"])
                        for o, n in zip(outputs, REQUESTS))

        check = 2   # the 3-row request: a padded rung
        full = serving.ModelServer(full_dir, batch_size=SERVE_BATCH)
        ref = full.predict_feed({"tokens": requests[check]},
                                len(requests[check]))["output"]
        del full
        diff = float(np.abs(outputs[check] - ref).max())
        scale = float(np.abs(ref).max())
    row = {"phase": "serve", "config": LM_CONFIG, "device": str(server.device),
           "load_s": load_s, "warmup_rungs": warmed, "warmup_s": warmup_s,
           "requests": [{"rows": n, "ms": 1e3 * t,
                         "tokens_per_s": n * SEQ / t}
                        for n, t in zip(REQUESTS, latencies)],
           "max_memory_allocated": peak_bytes,
           "forward_ms": forward_ms, "readback_ms": readback_ms,
           "readback_bytes": readback_bytes,
           "fwd_launches": launches, "expected_launches": expected,
           "logits_finite": finite, "shapes_ok": shapes_ok,
           "vs_full_max_abs_diff": diff, "max_abs_logit": scale,
           "vs_full_tol": LOGIT_TOL * scale, "compile_count":
           server.compile_count}
    emit(row)
    if not (finite and shapes_ok):
        raise AssertionError("served logits are not finite or misshapen")
    if launches != expected:
        raise AssertionError("flash_fwd launched {} times, expected {} "
                             "(layers x batches)".format(launches, expected))
    if not diff <= LOGIT_TOL * scale:
        raise AssertionError("flash-served logits differ from full attention "
                             "by {} (max |logit| {})".format(diff, scale))
    return row


def device_batches(torch, feed, n, device):
    """``n`` of ``feed``'s batches, already on the card (as the K = 5
    groups are timed), so a timed step makes no host copy."""
    out = []
    for _ in range(n):
        batch, mask = feed.next_batch()
        out.append(({"tokens": torch.from_numpy(batch["tokens"]).to(device)},
                    torch.from_numpy(mask).to(device)))
    return out


def time_steps(torch, trainer, batches, first=None):
    """Mean ms of one Trainer step on each of ``batches``, host clock from a
    synchronised start to a synchronised end; ``first()`` runs after the
    first step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, (batch, mask) in enumerate(batches):
        trainer.step(batch, mask)
        if i == 0 and first is not None:
            first()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / len(batches)


def interleaved_steady(torch, trainers, batches, rounds):
    """``{name: [ms/step of each run]}``: ``rounds`` runs of
    :func:`time_steps` per trainer on the same batches, in the order
    A B, B A, A B, ... so that drift of the host or the clocks falls on
    both alike."""
    names = list(trainers)
    runs = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            runs[name].append(time_steps(torch, trainers[name], batches))
    return runs


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


# lowercased kernel-name fragments -> the group a step's device time is
# reported under (first match wins)
KERNEL_GROUPS = (
    ("flash_fwd", ("flash_fwd_",)),
    ("flash_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_",)),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "sm90")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("softmax / cross entropy", ("softmax", "nll_loss", "cross_entropy")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("memcpy", "memset", "copy_kernel")),
    ("elementwise", ("elementwise",)),
)


def profile_steps(torch, trainer, batches):
    """Device time of a Trainer step on each of ``batches``, by kernel
    group (see :func:`profile_run`)."""
    n = len(batches)

    def run():
        for batch, mask in batches:
            trainer.step(batch, mask)

    return profile_run(torch, run, n)


def profile_run(torch, run, n):
    """Device time of ``run()``, which takes ``n`` steps, by kernel group,
    from ``torch.profiler`` (CUDA activity): per-step ms by group, the
    device-busy sum against the profiled wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups, top = {}, []
    for e in device_kernels(prof):
        ms = e.self_device_time_total / 1e3 / n
        name = e.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
        top.append((ms, e.key[:90], e.count // n))
    busy = sum(groups.values())
    return {"steps": n, "wall_ms_per_step": wall_ms / n,
            "device_busy_ms_per_step": busy,
            # None when the trace holds no device time (not measured)
            "device_idle_share": (1.0 - busy / (wall_ms / n)) if busy
            else None,
            "ms_per_step_by_group": dict(sorted(groups.items(),
                                                key=lambda kv: -kv[1])),
            "top_kernels": [{"ms_per_step": ms, "name": name,
                             "launches_per_step": c}
                            for ms, name, c in sorted(top)[::-1][:12]]}


class NgramFeed(object):
    """The JAX LM example's learnable token stream
    (examples/transformer/transformer_lm.py): each row counts up by one
    from a random offset.  ``batches()`` yields ``(batch, mask)`` as
    ``Trainer.fit_feed`` takes them; ``terminate()`` ends it."""

    def __init__(self, np, seed, batch, seq, vocab):
        self.np = np
        self.rng = np.random.default_rng(seed)
        self.shape = (batch, seq)
        self.vocab = vocab
        self.terminated = False

    def next_batch(self):
        np = self.np
        offs = self.rng.integers(0, self.vocab, (self.shape[0], 1))
        tokens = (np.arange(self.shape[1])[None] + offs) % self.vocab
        return ({"tokens": tokens.astype(np.int32)},
                np.ones(self.shape[0], np.float32))

    def batches(self):
        while not self.terminated:
            yield self.next_batch()

    def next_group(self, k):
        """``k`` batches as ``(K, B, S)`` / ``(K, B)`` numpy stacks."""
        np = self.np
        items = [self.next_batch() for _ in range(k)]
        return ({"tokens": np.stack([b["tokens"] for b, _ in items])},
                np.stack([m for _, m in items]))

    def grouped_batches(self, k):
        while not self.terminated:
            yield ("multi",) + self.next_group(k)

    def terminate(self):
        self.terminated = True


class LossCurve(object):
    """A summary writer that keeps the Trainer's per-step loss curve
    (``TimeHistory`` writes one point per step of a K-step dispatch)."""

    def __init__(self):
        self.losses = {}

    def add_scalars(self, scalars, step):
        if "loss" in scalars:
            self.losses[int(step)] = float(scalars["loss"])

    def flush(self):
        pass


def phase_train(torch, np, fa, metrics, kind, kernel_ms):
    """Train the flagship LM through ``Trainer.fit_feed`` with async
    checkpoints on the default device, count the kernels' launches, then
    check the gradients against full attention, the resume and the
    handoff to serving."""
    import functools

    from tensorflowonspark_torch import checkpoint, serving, train
    from tensorflowonspark_torch.models import get_model, transformer

    vocab, layers = LM_CONFIG["vocab_size"], LM_CONFIG["num_layers"]
    heads, head_dim = LM_CONFIG["num_heads"], LM_CONFIG["head_dim"]
    d_model = heads * head_dim
    model = get_model("transformer_lm", **LM_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    init = dict(model.state_dict())
    with torch.device("meta"):   # its params always come from a dict
        full_model = get_model("transformer_lm",
                               **dict(LM_CONFIG, attention="full"))
    loss_fn = transformer.loss_fn(model)
    # the flash kernels' FLOPs, which FlopCounterMode cannot see: causal
    # forward 2 and backward 5 S^2 D products per (batch, head, layer)
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers
    # model FLOPs for comparison: 3 x the forward's matmuls, plus the above
    analytic_flops = (3 * TRAIN_BATCH * SEQ * (24 * d_model * d_model * layers
                                              + 2 * d_model * vocab)
                      + flash_flops)

    def new_trainer(**adam):
        return train.Trainer(loss_fn, init,
                             functools.partial(torch.optim.Adam, lr=LR,
                                               **adam),
                             compute_dtype=torch.bfloat16,
                             batch_size=TRAIN_BATCH, log_steps=LOG_STEPS,
                             extra_step_flops=flash_flops)

    trainer = new_trainer()
    feed = NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab)
    # the first step's loss: the initial params on the feed's first batch
    batch0, mask0 = NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab).next_batch()
    with torch.no_grad():
        first_loss = loss_fn(trainer.state.params,
                             {"tokens": torch.from_numpy(
                                 batch0["tokens"]).to(trainer.device)},
                             torch.from_numpy(mask0).to(trainer.device))[0]
        first_loss = first_loss.item()

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = checkpoint.CheckpointManager(
            os.path.join(tmp, "ckpt"), save_interval_steps=LOG_STEPS,
            max_to_keep=2, async_save=True)
        window_losses = []

        def on_steps(step):
            if step % LOG_STEPS == 0:   # a window closed in this step
                window_losses.append(trainer.history.last_synced_value)
            ckpt.maybe_save(step, trainer.state)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        t0 = time.perf_counter()                      # the main path starts
        stats = trainer.fit_feed(feed, max_steps=TRAIN_STEPS,
                                 on_steps=on_steps)
        fit_s = time.perf_counter() - t0
        launches = {"flash_fwd": fa.fwd_launches,
                    "flash_bwd_dq": fa.bwd_dq_launches,
                    "flash_bwd_dkv": fa.bwd_dkv_launches}  # ... and ends
        peak_bytes = torch.cuda.max_memory_allocated()
        log = trainer.history.timestamp_log
        window_ms = [1e3 * (t1 - t0_) / (s1 - s0)
                     for (s0, t0_), (s1, t1) in zip(log, log[1:])]
        step_ms = sorted(window_ms)[len(window_ms) // 2]
        step_flops = trainer.history.step_flops
        # where fit_feed's closed windows went (the Trainer's report)
        attribution = trainer.attribution_report()
        mfu = metrics.mfu_from_step_time(step_flops, step_ms / 1e3)
        flash_ms = sum(layers * kernel_ms[name] for name in launches)

        # gradients of one step, flash against full attention, on the
        # trained weights and a fresh batch
        fixed, fixed_mask = NgramFeed(np, 1, TRAIN_BATCH, SEQ,
                                      vocab).next_batch()
        dev = trainer.device
        tokens = {"tokens": torch.from_numpy(fixed["tokens"]).to(dev)}
        mask = torch.from_numpy(fixed_mask).to(dev)
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in trainer.state.params.items()}
        g_flash = torch.autograd.grad(loss_fn(params, tokens, mask)[0],
                                      list(params.values()))
        g_full = torch.autograd.grad(
            transformer.loss_fn(full_model)(params, tokens, mask)[0],
            list(params.values()))
        grad_rel = {name: ((a.float() - b.float()).norm()
                           / b.float().norm().clamp_min(1e-30)).item()
                    for name, a, b in zip(params, g_flash, g_full)}
        del params, g_flash, g_full
        worst_grad = max(grad_rel, key=grad_rel.get)

        # resume: a fresh Trainer restored from the last checkpoint takes
        # the same step as the original on the same batch
        ckpt.wait_until_finished()
        saved = ckpt.latest_step()
        resumed = new_trainer()
        restored = resumed.restore_latest(ckpt)
        want_loss, _ = trainer.step(fixed, fixed_mask)
        got_loss, _ = resumed.step(fixed, fixed_mask)
        resume_loss_diff = abs(got_loss.item() - want_loss.item())
        resume_param_diff = max(
            (resumed.state.params[k] - t).abs().max().item()
            for k, t in trainer.state.params.items())
        ckpt.close()
        del resumed

        # handoff: the trained params exported and served
        export_dir = os.path.join(tmp, "export")
        checkpoint.export_model(
            export_dir, trainer.state.params, "transformer_lm",
            model_config=LM_CONFIG,
            input_signature={"tokens": {"shape": [None, SEQ],
                                        "dtype": "int32"}})
        server = serving.ModelServer(export_dir, batch_size=SERVE_BATCH)
        request = np.random.default_rng(2).integers(
            0, vocab, (SERVE_BATCH, SEQ), dtype=np.int32)
        served = server.predict_feed({"tokens": request},
                                     SERVE_BATCH)["output"]
        with torch.inference_mode():
            trained = torch.func.functional_call(
                model, trainer.state.params,
                (torch.from_numpy(request).to(dev),)).float().cpu().numpy()
        del server
        handoff_diff = float(np.abs(served - trained).max())
        handoff_scale = float(np.abs(trained).max())

        # the Trainer's default on the card is capturable Adam (eager and
        # graph steps share its arithmetic); the same 30 steps with
        # capturable=False, as a caller may ask, for the loss difference
        plain = new_trainer(capturable=False)
        plain_losses = []

        def on_plain_steps(step):
            if step % LOG_STEPS == 0:
                plain_losses.append(plain.history.last_synced_value)

        plain.fit_feed(NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab),
                       max_steps=TRAIN_STEPS, on_steps=on_plain_steps)

        # where a step's time goes, once warm, on batches already on the
        # card: steps with no checkpoint in flight (capturable Adam and
        # capturable=False interleaved), the same with one async save in
        # flight, and a profile
        more = NgramFeed(np, 3, TRAIN_BATCH, SEQ, vocab)
        steady = interleaved_steady(
            torch, {"capturable": trainer, "not_capturable": plain},
            device_batches(torch, more, STEADY_STEPS, dev), AB_ROUNDS)
        del plain
        steady_ms = median(steady["capturable"])
        ckpt2 = checkpoint.CheckpointManager(
            os.path.join(tmp, "ckpt2"), save_interval_steps=0,
            async_save=True)
        inflight_ms = time_steps(
            torch, trainer, device_batches(torch, more, STEADY_STEPS, dev),
            first=lambda: ckpt2.maybe_save(trainer.state.step,
                                           trainer.state, force=True))
        ckpt2.close()
        profile = profile_steps(
            torch, trainer, device_batches(torch, more, PROFILE_STEPS, dev))
        # the profiler slows the host; against the unprofiled steady step
        busy = profile["device_busy_ms_per_step"]
        profile["device_idle_share_of_steady_step"] = (
            1.0 - busy / steady_ms if busy else None)

    steps = stats["global_steps"]
    expected = layers * steps
    losses_finite = all(np.isfinite(x) for x in window_losses + [first_loss])
    row = {"phase": "train", "config": LM_CONFIG, "device": str(dev),
           "batch": TRAIN_BATCH, "seq": SEQ, "steps": steps,
           "optimizer": "torch.optim.Adam(lr={}), capturable".format(LR),
           "first_step_loss": first_loss,
           "window_losses": window_losses, "loss_drop": LOSS_DROP,
           "window_ms_per_step": window_ms, "ms_per_step": step_ms,
           "tokens_per_s": TRAIN_BATCH * SEQ / (step_ms / 1e3),
           "fit_feed_s": fit_s, "step_flops": step_flops,
           "analytic_step_flops": analytic_flops, "mfu": mfu,
           "trainer_mfu_pct": stats["overlap"].get("train_mfu_pct_max"),
           "max_memory_allocated": peak_bytes,
           "launches": launches, "expected_launches": expected,
           "flash_ms_per_step": flash_ms,
           "flash_share": flash_ms / step_ms,
           "steady_ms_per_step": steady_ms,
           "capturable_ab": {
               "runs_ms_per_step": steady,
               "median_ms_per_step": {k: median(v)
                                      for k, v in steady.items()},
               "spread_ms": {k: max(v) - min(v) for k, v in steady.items()},
               "not_capturable_window_losses": plain_losses,
               "loss_diff": [abs(a - b) for a, b in zip(plain_losses,
                                                        window_losses)]},
           "steady_tokens_per_s": TRAIN_BATCH * SEQ / (steady_ms / 1e3),
           "steady_mfu": metrics.mfu_from_step_time(step_flops,
                                                    steady_ms / 1e3),
           "steady_flash_share": flash_ms / steady_ms,
           "save_in_flight_ms_per_step": inflight_ms,
           "profile": profile,
           "overlap": stats["overlap"],
           "attribution": attribution,
           "step_bytes": stats["overlap"].get("train_step_bytes_max"),
           "grad_rel_err_max": grad_rel[worst_grad],
           "grad_rel_err_worst_tensor": worst_grad, "grad_rtol": GRAD_RTOL,
           "checkpoint_latest": saved, "restored_step": restored,
           "resume_loss_diff": resume_loss_diff,
           "resume_param_max_diff": resume_param_diff,
           "resume_tol": RESUME_TOL,
           "handoff_max_abs_diff": handoff_diff,
           "handoff_max_abs_logit": handoff_scale,
           "handoff_tol": HANDOFF_TOL * handoff_scale}
    emit(row)
    if not losses_finite or len(window_losses) != TRAIN_STEPS // LOG_STEPS:
        raise AssertionError("training loss not finite at every window: "
                             "{}".format(window_losses))
    if not window_losses[-1] <= first_loss - LOSS_DROP:
        raise AssertionError("loss did not fall: first step {}, windows "
                             "{}".format(first_loss, window_losses))
    if any(n != expected for n in launches.values()):
        raise AssertionError("kernel launches {} over fit_feed, expected {} "
                             "each (layers x steps)".format(launches,
                                                            expected))
    if not grad_rel[worst_grad] <= GRAD_RTOL:
        raise AssertionError("flash gradients differ from full attention's: "
                             "{} at {}".format(grad_rel[worst_grad],
                                               worst_grad))
    if saved != TRAIN_STEPS or restored != TRAIN_STEPS:
        raise AssertionError("checkpoint at step {}, restored {}, expected "
                             "{}".format(saved, restored, TRAIN_STEPS))
    if not (resume_loss_diff <= RESUME_TOL
            and resume_param_diff <= RESUME_TOL):
        raise AssertionError("the resumed step differs: loss {}, params "
                             "{}".format(resume_loss_diff, resume_param_diff))
    if not handoff_diff <= HANDOFF_TOL * handoff_scale:
        raise AssertionError("the served export differs from the trained "
                             "model by {} (max |logit| {})".format(
                                 handoff_diff, handoff_scale))
    return row


def phase_train_megastep(torch, np, fa, metrics, k1):
    """The train phase at K = 5: the same init, stream and async
    checkpoints through ``fit_feed(steps_per_call=5)``, each step after two
    eager warm-ups a replay of one captured CUDA graph.  Counts the
    kernels' launches, holds the losses at steps 10, 20 and 30 to K = 1's,
    times warm groups on device-resident stacks with and without the
    profiler, and restores a checkpoint into the trainer that captured."""
    import functools

    from tensorflowonspark_torch import checkpoint, train
    from tensorflowonspark_torch.models import get_model, transformer

    vocab, layers = LM_CONFIG["vocab_size"], LM_CONFIG["num_layers"]
    heads, head_dim = LM_CONFIG["num_heads"], LM_CONFIG["head_dim"]
    model = get_model("transformer_lm", **LM_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    init = dict(model.state_dict())
    loss_fn = transformer.loss_fn(model)
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers

    def new_trainer(**kwargs):
        return train.Trainer(loss_fn, init,
                             functools.partial(torch.optim.Adam, lr=LR),
                             compute_dtype=torch.bfloat16,
                             batch_size=TRAIN_BATCH, log_steps=LOG_STEPS,
                             extra_step_flops=flash_flops, **kwargs)

    curve = LossCurve()
    trainer = new_trainer(summary_writer=curve)
    feed = NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = checkpoint.CheckpointManager(
            os.path.join(tmp, "ckpt"), save_interval_steps=LOG_STEPS,
            max_to_keep=2, async_save=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        t0 = time.perf_counter()                      # the main path starts
        # under the profiler: the flash kernels the card executed, against
        # the counters (which a replay advances by its capture's launches)
        stats, executed = counted_on_device(torch, lambda: trainer.fit_feed(
            feed, max_steps=TRAIN_STEPS, steps_per_call=MEGA_K,
            on_steps=lambda step: ckpt.maybe_save(step, trainer.state)))
        fit_s = time.perf_counter() - t0
        launches = {"flash_fwd": fa.fwd_launches,
                    "flash_bwd_dq": fa.bwd_dq_launches,
                    "flash_bwd_dkv": fa.bwd_dkv_launches}  # ... and ends
        fit_steps = trainer.state.step
        peak_bytes = torch.cuda.max_memory_allocated()
        # the uninterrupted run's params, for the supervised phase
        final_params = {k: v.detach().cpu()
                        for k, v in trainer.state.params.items()}
        attribution = trainer.attribution_report()
        snap = trainer.counters_snapshot()
        log = trainer.history.timestamp_log
        window_ms = [1e3 * (t1 - t0_) / (s1 - s0)
                     for (s0, t0_), (s1, t1) in zip(log, log[1:])]
        checked = [LOG_STEPS * (i + 1) for i in range(TRAIN_STEPS // LOG_STEPS)]
        losses = {str(step): curve.losses.get(step) for step in checked}
        vs_k1 = {str(step): (abs(curve.losses[step] - want)
                             if step in curve.losses else None)
                 for step, want in zip(checked, k1["window_losses"])}

        # warm groups of 5 on device-resident stacks: host clock from a
        # synchronised start to a synchronised end, then a profile; the
        # last async save lands first (its copies would share the card)
        ckpt.wait_until_finished()
        more = NgramFeed(np, 3, TRAIN_BATCH, SEQ, vocab)
        groups = []
        for _ in range(MEGA_STEADY_GROUPS + MEGA_PROFILE_GROUPS):
            batch, mask = more.next_group(MEGA_K)
            groups.append(({"tokens": torch.from_numpy(
                batch["tokens"]).to(trainer.device)},
                torch.from_numpy(mask).to(trainer.device)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch, mask in groups[:MEGA_STEADY_GROUPS]:
            trainer.multi_step(batch, mask)
        torch.cuda.synchronize()
        steady_ms = 1e3 * (time.perf_counter() - t0) / (
            MEGA_STEADY_GROUPS * MEGA_K)

        def profiled():
            for batch, mask in groups[MEGA_STEADY_GROUPS:]:
                trainer.multi_step(batch, mask)

        profile = profile_run(torch, profiled, MEGA_PROFILE_GROUPS * MEGA_K)
        busy = profile["device_busy_ms_per_step"]
        profile["device_idle_share_of_steady_step"] = (
            1.0 - busy / steady_ms if busy else None)

        # a checkpoint restored into the trainer that captured: its next
        # step (a graph replay) against a fresh trainer's eager step
        ckpt.wait_until_finished()
        saved = ckpt.latest_step()
        restored = trainer.restore_latest(ckpt)
        fresh = new_trainer()
        fresh.restore_latest(ckpt)
        fixed, fixed_mask = NgramFeed(np, 1, TRAIN_BATCH, SEQ,
                                      vocab).next_batch()
        got = trainer.repeat_step(fixed, fixed_mask, 1)
        want, _ = fresh.step(fixed, fixed_mask)
        restore_loss_diff = abs(got.item() - want.item())
        restore_param_diff = max(
            (fresh.state.params[k] - t).abs().max().item()
            for k, t in trainer.state.params.items())
        ckpt.close()
        del fresh

    expected = layers * TRAIN_STEPS
    row = {"phase": "train_megastep", "steps_per_call": MEGA_K,
           "steps": fit_steps, "fit_feed_s": fit_s,
           "megastep": stats["megastep"],
           "launches": launches, "device_launches": executed,
           "expected_launches": expected,
           "losses": losses, "k1_window_losses": k1["window_losses"],
           "loss_diff_vs_k1": vs_k1, "loss_tol_vs_k1": MEGA_LOSS_TOL,
           "window_ms_per_step": window_ms,
           "steady_ms_per_step": steady_ms,
           "k1_steady_ms_per_step": k1["steady_ms_per_step"],
           "steady_tokens_per_s": TRAIN_BATCH * SEQ / (steady_ms / 1e3),
           "steady_mfu": metrics.mfu_from_step_time(
               trainer.history.step_flops, steady_ms / 1e3),
           "profile": profile,
           "k1_profile_device_busy_ms_per_step":
               k1["profile"]["device_busy_ms_per_step"],
           "capture_s": snap.get("train_compile_us_max", 0) / 1e6,
           "graphs": len(trainer._graphs),
           "attribution": attribution, "k1_attribution": k1["attribution"],
           "overlap": stats["overlap"],
           "max_memory_allocated": peak_bytes,
           "checkpoint_latest": saved, "restored_step": restored,
           "restore_loss_diff": restore_loss_diff,
           "restore_param_max_diff": restore_param_diff,
           "restore_tol": RESUME_TOL}
    emit(row)
    if fit_steps != TRAIN_STEPS:
        raise AssertionError("fit_feed took {} steps at K = {}, expected "
                             "{}".format(fit_steps, MEGA_K, TRAIN_STEPS))
    if any(n != expected for n in list(launches.values())
           + list(executed.values())):
        raise AssertionError("kernel launches {} counted and {} executed on "
                             "the card over fit_feed at K = {}, expected {} "
                             "each".format(launches, executed, MEGA_K,
                                           expected))
    if trainer.state.step != restored + 1:
        raise AssertionError("the restored trainer is at step {}, expected "
                             "{}".format(trainer.state.step, restored + 1))
    if not all(d is not None and d <= MEGA_LOSS_TOL for d in vs_k1.values()):
        raise AssertionError("the K = {} losses differ from K = 1's: "
                             "{}".format(MEGA_K, vs_k1))
    if saved != TRAIN_STEPS or restored != TRAIN_STEPS:
        raise AssertionError("checkpoint at step {}, restored {}, expected "
                             "{}".format(saved, restored, TRAIN_STEPS))
    if not (restore_loss_diff <= RESUME_TOL
            and restore_param_diff <= RESUME_TOL):
        raise AssertionError("the step after a restore into the captured "
                             "trainer differs: loss {}, params {}".format(
                                 restore_loss_diff, restore_param_diff))
    return row, final_params


class TokenRows(object):
    """Rows of tokens served like a DataFeed's columnar path
    (``next_batch_arrays``), for a :class:`ShardedFeed`."""

    def __init__(self, tokens):
        self.tokens = tokens
        self.pos = 0
        self.done = False

    def next_batch_arrays(self, n):
        rows = self.tokens[self.pos:self.pos + n]
        self.pos += len(rows)
        if len(rows) < n:
            self.done = True
        return {"tokens": rows}, len(rows)

    def should_stop(self):
        return self.done

    def interrupt(self):
        pass

    def terminate(self):
        pass


class SupervisedFeed(NgramFeed):
    """The phase stream from the step a trainer resumes at (the batches
    before it are drawn and dropped), in groups of K.  ``crash_at``: raise
    a retryable injected failure once the trainer reached that step.
    ``row_weight``: every batch carries a float ``row_weight`` of ones (a
    NaN batch then has something to poison).  ``rollback``: once the
    trainer's health counters saw a nonfinite loss, drop the fault spec
    (the poison was in the data) and push the ``train_rollback`` knob
    through ``node.apply_knobs``, as the remediator does."""

    def __init__(self, np, trainer, crash_at=None, row_weight=False,
                 rollback=None):
        super().__init__(np, 0, TRAIN_BATCH, SEQ, LM_CONFIG["vocab_size"])
        self.trainer = trainer
        self.crash_at = crash_at
        self.row_weight = row_weight
        self.rollback = rollback
        for _ in range(trainer.state.step):
            self.next_batch()

    def next_batch(self):
        batch, mask = super().next_batch()
        if self.row_weight:
            batch["row_weight"] = self.np.ones(TRAIN_BATCH, self.np.float32)
        return batch, mask

    def next_group(self, k):
        items = [self.next_batch() for _ in range(k)]
        return ({name: self.np.stack([b[name] for b, _ in items])
                 for name in items[0][0]},
                self.np.stack([m for _, m in items]))

    def grouped_batches(self, k):
        from tensorflowonspark_torch import fault, node

        while not self.terminated:
            if (self.crash_at is not None
                    and self.trainer.state.step >= self.crash_at):
                fault.fail("injected feed loss after step {}".format(
                    self.trainer.state.step))
            if (self.rollback is not None and self.trainer.counters_snapshot()
                    .get("train_nonfinite_loss", 0)):
                os.environ.pop(fault.FAULT_SPEC_ENV, None)
                node.apply_knobs({"train_rollback": self.rollback})
                self.rollback = None
            yield ("multi",) + self.next_group(k)


def launches_of(fa):
    return {"flash_fwd": fa.fwd_launches, "flash_bwd_dq": fa.bwd_dq_launches,
            "flash_bwd_dkv": fa.bwd_dkv_launches}


def phase_supervised(torch, np, fa, k1, k5, uninterrupted):
    """Supervised training at full width and depth (the train phases'
    config, init, stream and optimizer): ``fit_supervised`` at K = 5
    through a crash, a corrupt newest checkpoint and a poison rollback;
    ``accum_steps=2`` and ``remat=True`` at K = 1 and K = 5; and
    ``Trainer.evaluate`` of the trained params.  ``k1`` and ``k5`` are the
    train phases' rows, ``uninterrupted`` the params of the K = 5 run's 30
    steps (on the host)."""
    import functools
    import gc
    import shutil

    from tensorflowonspark_torch import checkpoint, fault, train
    from tensorflowonspark_torch.models import get_model, transformer
    from tensorflowonspark_torch.parallel.infeed import ShardedFeed

    vocab, layers = LM_CONFIG["vocab_size"], LM_CONFIG["num_layers"]
    heads, head_dim = LM_CONFIG["num_heads"], LM_CONFIG["head_dim"]
    model = get_model("transformer_lm", **LM_CONFIG)
    model.init_weights(torch.Generator().manual_seed(0))
    init = dict(model.state_dict())
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers
    checked = [LOG_STEPS * (i + 1) for i in range(TRAIN_STEPS // LOG_STEPS)]

    def new_trainer(loss_fn=None, **kwargs):
        return train.Trainer(loss_fn or transformer.loss_fn(model), init,
                             functools.partial(torch.optim.Adam, lr=LR),
                             compute_dtype=torch.bfloat16,
                             batch_size=TRAIN_BATCH, log_steps=LOG_STEPS,
                             extra_step_flops=flash_flops, **kwargs)

    def release():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def param_diff(trainer):
        return max((trainer.state.params[k].detach().cpu() - t).abs().max()
                   .item() for k, t in uninterrupted.items())

    def supervised(trainer, directory, max_steps=TRAIN_STEPS, **feed_kwargs):
        """fit_supervised at K = 5 from fresh SupervisedFeeds, under the
        profiler; returns what it measured."""
        ckpt = checkpoint.CheckpointManager(
            directory, save_interval_steps=SUPERVISED_SAVE_STEPS,
            max_to_keep=2, async_save=True)
        starts = []

        def factory():
            starts.append(trainer.state.step)
            kwargs = dict(feed_kwargs)
            if len(starts) > 1:
                kwargs.pop("crash_at", None)
            return SupervisedFeed(np, trainer, **kwargs)

        policy = fault.RetryPolicy(max_attempts=3, initial_backoff=0.05,
                                   extra_retryable=["injected"])
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        t0 = time.perf_counter()                  # the main path starts
        stats, executed = counted_on_device(torch, lambda: (
            train.fit_supervised(trainer, factory, ckpt, retry_policy=policy,
                                 max_steps=max_steps,
                                 steps_per_call=MEGA_K)))
        wall_s = time.perf_counter() - t0
        launches = launches_of(fa)                # ... and ends
        snap = trainer.counters_snapshot()
        out = {"feed_starts": starts, "steps": trainer.state.step,
               "wall_s": wall_s, "final_loss": stats["loss"],
               "recovery_us": snap.get("goodput_recovery_us", 0),
               "rollbacks": snap.get("train_rollbacks_total", 0),
               "checkpoints": sorted(os.listdir(ckpt.directory)),
               "launches": launches, "device_launches": executed}
        ckpt.close()
        return out

    def plain_fit(trainer, k):
        """fit_feed of the phase stream, 30 steps at K = ``k``, under the
        profiler: the losses at steps 10, 20 and 30, peak memory and
        launches."""
        curve, window = LossCurve(), {}
        trainer.summary_writer = curve   # read at the first step

        def on_steps(step):
            if k == 1 and step % LOG_STEPS == 0:
                window[step] = trainer.history.last_synced_value

        release()
        torch.cuda.reset_peak_memory_stats()
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        _, executed = counted_on_device(torch, lambda: trainer.fit_feed(
            NgramFeed(np, 0, TRAIN_BATCH, SEQ, vocab), max_steps=TRAIN_STEPS,
            steps_per_call=k, on_steps=on_steps))
        launches = launches_of(fa)
        peak = torch.cuda.max_memory_allocated()
        losses = window if k == 1 else {s: curve.losses.get(s)
                                        for s in checked}
        return {"losses": {str(s): losses.get(s) for s in checked},
                "max_memory_allocated": peak, "launches": launches,
                "device_launches": executed}

    def accum_step_check(trainer):
        """One step's loss and gradients at ``accum_steps=2`` against
        ``accum_steps=1`` (the trainer's own ``_grads``, the work of a
        step before the optimizer) on the trainer's params and a fresh
        batch."""
        batch, mask = trainer._prepare(*NgramFeed(
            np, 1, TRAIN_BATCH, SEQ, vocab).next_batch())
        names = list(trainer.state.params)
        out = {}
        for a in (1, ACCUM_STEPS):
            trainer.accum_steps = a
            loss, _ = trainer._grads(batch, mask)
            out[a] = (loss.item(), [trainer.state.params[n].grad.float()
                                    for n in names])
        trainer.state.optimizer.zero_grad(set_to_none=True)
        rel = {n: ((g - g1).norm() / g1.norm().clamp_min(1e-30)).item()
               for n, g1, g in zip(names, out[1][1], out[ACCUM_STEPS][1])}
        worst = max(rel, key=rel.get)
        return {"loss_accum1": out[1][0], "loss_accum2": out[ACCUM_STEPS][0],
                "loss_diff": abs(out[ACCUM_STEPS][0] - out[1][0]),
                "grad_rel_err_max": rel[worst],
                "grad_rel_err_worst_tensor": worst, "grad_rtol": GRAD_RTOL}

    def steady(trainer, k):
        """ms per step of warm steps on batches already on the card: 10
        single steps at K = 1, groups of 5 at K = 5."""
        more = NgramFeed(np, 3, TRAIN_BATCH, SEQ, vocab)
        dev = trainer.device
        if k == 1:
            return time_steps(torch, trainer,
                              device_batches(torch, more, STEADY_STEPS, dev))
        groups = []
        for _ in range(SUPERVISED_STEADY_GROUPS):
            batch, mask = more.next_group(k)
            groups.append(({"tokens": torch.from_numpy(
                batch["tokens"]).to(dev)}, torch.from_numpy(mask).to(dev)))
        trainer.multi_step(*groups[0])          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch, mask in groups:
            trainer.multi_step(batch, mask)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (len(groups) * k)

    def group_profile(trainer):
        """Device time of one warm group of K steps, by kernel group."""
        batch, mask = NgramFeed(np, 4, TRAIN_BATCH, SEQ,
                                vocab).next_group(MEGA_K)
        dev = trainer.device
        batch = {"tokens": torch.from_numpy(batch["tokens"]).to(dev)}
        mask = torch.from_numpy(mask).to(dev)
        prof = profile_run(torch, lambda: trainer.multi_step(batch, mask),
                           MEGA_K)
        return {"device_busy_ms_per_step": prof["device_busy_ms_per_step"],
                "ms_per_step_by_group": prof["ms_per_step_by_group"]}

    k1_losses = {str(s): v for s, v in zip(checked, k1["window_losses"])}
    k5_losses = k5["losses"]
    row = {"phase": "supervised", "steps_per_call": MEGA_K,
           "save_interval_steps": SUPERVISED_SAVE_STEPS,
           "resume_tol": RESUME_TOL}
    tmp = tempfile.mkdtemp()
    try:
        # (a) crash -> resume
        trainer = new_trainer()
        a = supervised(trainer, os.path.join(tmp, "a"), crash_at=CRASH_STEP)
        a["param_max_diff_vs_uninterrupted"] = param_diff(trainer)
        row["crash_resume"] = a
        final = {k: v.detach().cpu() for k, v in
                 trainer.state.params.items()}   # evaluated in (f)
        del trainer
        release()

        # (b) the newest checkpoint corrupt -> quarantined
        trainer = new_trainer()
        first = supervised(trainer, os.path.join(tmp, "b"),
                           max_steps=SUPERVISED_SAVE_STEPS)
        os.environ[fault.FAULT_SPEC_ENV] = json.dumps(
            {"corrupt_checkpoint": True})
        try:
            # the manager resolves its fault injector once, when made
            b = supervised(trainer, os.path.join(tmp, "b"),
                           crash_at=CORRUPT_CRASH_STEP)
        finally:
            os.environ.pop(fault.FAULT_SPEC_ENV, None)
        b["first_run_checkpoints"] = first["checkpoints"]
        b["param_max_diff_vs_uninterrupted"] = param_diff(trainer)
        row["corrupt_quarantine"] = b
        del trainer
        release()

        # (c) poison -> rollback
        lm_loss = transformer.loss_fn(model)

        def weighted_loss(params, batch, mask):
            return lm_loss(params, {"tokens": batch["tokens"]},
                           mask * batch["row_weight"])

        trainer = new_trainer(weighted_loss)
        os.environ[fault.FAULT_SPEC_ENV] = json.dumps(
            {"nan_batch_at_step": NAN_STEP})
        try:
            c = supervised(trainer, os.path.join(tmp, "c"), row_weight=True,
                           rollback="poison-1")
        finally:
            os.environ.pop(fault.FAULT_SPEC_ENV, None)
        c["param_max_diff_vs_uninterrupted"] = param_diff(trainer)
        c["nonfinite_loss_windows"] = trainer.counters_snapshot().get(
            "train_nonfinite_loss")
        row["poison_rollback"] = c
        del trainer
        release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) accum_steps=2 and (e) remat=True, at K = 1 and K = 5, against the
    # plain step on the same batches, all without checkpoints (so that
    # their peak memory compares)
    with torch.device("meta"):   # its params always come from a dict
        remat_model = get_model("transformer_lm",
                                **dict(LM_CONFIG, remat=True))
    variants = {}
    for name, make in (
            ("plain", new_trainer),
            ("accum2", lambda: new_trainer(accum_steps=ACCUM_STEPS)),
            ("remat", lambda: new_trainer(transformer.loss_fn(remat_model)))):
        for k in (1, MEGA_K):
            trainer = make()
            run = plain_fit(trainer, k)
            run["steady_ms_per_step"] = steady(trainer, k)
            if name == "accum2" and k == 1:
                run["one_step_vs_accum1"] = accum_step_check(trainer)
            if k > 1:
                run["profile"] = group_profile(trainer)
            if k > 1:
                k1_run = variants[name + "_k1"]["losses"]
                run["loss_diff_vs_k1"] = {
                    s: abs(v - k1_run[s]) for s, v in run["losses"].items()}
            want = (variants["plain_k{}".format(k)]["losses"]
                    if name != "plain" else k1_losses if k == 1
                    else k5_losses)
            run["loss_diff_vs_plain"] = {
                s: (abs(v - want[s]) if v is not None else None)
                for s, v in run["losses"].items()}
            variants["{}_k{}".format(name, k)] = run
            del trainer
            release()
    row["accum_steps"] = ACCUM_STEPS
    row["accum_loss_tol"] = ACCUM_LOSS_TOL
    row["remat_loss_tol"] = REMAT_LOSS_TOL
    row["variants"] = variants
    row["train_phases"] = {
        "k1": {"max_memory_allocated": k1["max_memory_allocated"],
               "steady_ms_per_step": k1["steady_ms_per_step"]},
        "k5": {"max_memory_allocated": k5["max_memory_allocated"],
               "steady_ms_per_step": k5["steady_ms_per_step"]}}

    # (f) evaluate the trained params over held-out rows, flash and full
    trainer = new_trainer()
    with torch.no_grad():
        for name, t in trainer.state.params.items():
            t.copy_(final[name])
    del final
    with torch.device("meta"):   # its params always come from a dict
        full_model = get_model("transformer_lm",
                               **dict(LM_CONFIG, attention="full"))
    rows = lm_rows(np, 5, EVAL_ROWS, SEQ, vocab)
    seen = []

    def lm_metric(net):
        def metric(params, batch, mask):
            tokens = batch["tokens"].long()
            logits = torch.func.functional_call(net, params, (tokens,))
            targets = torch.roll(tokens, -1, dims=1)
            pos = (torch.arange(SEQ, device=tokens.device)
                   < SEQ - 1).float()
            ce = torch.nn.functional.cross_entropy(
                logits.reshape(-1, vocab), targets.reshape(-1),
                reduction="none").reshape(tokens.shape)
            hit = (logits.argmax(-1) == targets).float()
            row_ce = (ce * pos).sum(-1) / pos.sum()
            row_acc = (hit * pos).sum(-1) / pos.sum()
            seen.append(mask.sum())
            return ({"loss": (row_ce * mask).sum(),
                     "accuracy": (row_acc * mask).sum()}, mask.sum())
        return metric

    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    t0 = time.perf_counter()                      # the main path starts
    got, executed = counted_on_device(torch, lambda: trainer.evaluate(
        ShardedFeed(TokenRows(rows), TRAIN_BATCH), lm_metric(model)))
    eval_s = time.perf_counter() - t0
    eval_launches = launches_of(fa)               # ... and ends
    eval_rows = [float(m) for m in seen]
    want = trainer.evaluate(ShardedFeed(TokenRows(rows), TRAIN_BATCH),
                            lm_metric(full_model))
    row["evaluate"] = {
        "rows": EVAL_ROWS, "batch_rows": eval_rows, "flash": got,
        "full": want, "tol": EVAL_TOL, "wall_s": eval_s,
        "diff": {k: abs(got[k] - want[k]) for k in got},
        "launches": eval_launches, "device_launches": executed}
    del trainer
    release()
    emit(row)

    # the checks
    steps_a = (CRASH_STEP + TRAIN_STEPS - SUPERVISED_SAVE_STEPS) * layers
    expected = {
        "crash_resume": dict.fromkeys(launches_of(fa), steps_a),
        "accum2_k1": dict.fromkeys(launches_of(fa),
                                   ACCUM_STEPS * layers * TRAIN_STEPS),
        "remat_k1": {"flash_fwd": 2 * layers * TRAIN_STEPS,
                     "flash_bwd_dq": layers * TRAIN_STEPS,
                     "flash_bwd_dkv": layers * TRAIN_STEPS},
        "evaluate": {"flash_fwd": layers * 3, "flash_bwd_dq": 0,
                     "flash_bwd_dkv": 0}}
    expected["accum2_k5"] = expected["accum2_k1"]
    expected["remat_k5"] = expected["remat_k1"]
    expected["plain_k1"] = expected["plain_k5"] = dict.fromkeys(
        launches_of(fa), layers * TRAIN_STEPS)
    counted = {"crash_resume": row["crash_resume"],
               "evaluate": row["evaluate"]}
    counted.update(variants)
    for name, want_n in expected.items():
        got_n = counted[name]
        if got_n["launches"] != want_n or got_n["device_launches"] != want_n:
            raise AssertionError(
                "{}: kernel launches {} counted and {} executed on the "
                "card, expected {}".format(name, got_n["launches"],
                                           got_n["device_launches"], want_n))
    for name, starts in (("crash_resume", [0, SUPERVISED_SAVE_STEPS]),
                         ("corrupt_quarantine", [SUPERVISED_SAVE_STEPS] * 2),
                         ("poison_rollback", [0, SUPERVISED_SAVE_STEPS])):
        r = row[name]
        if r["feed_starts"] != starts or r["steps"] != TRAIN_STEPS:
            raise AssertionError(
                "{}: feeds started at steps {} and ended at step {}, "
                "expected {} and {}".format(name, r["feed_starts"],
                                            r["steps"], starts, TRAIN_STEPS))
        if not math.isfinite(r["final_loss"]):
            raise AssertionError("{}: final loss {}".format(
                name, r["final_loss"]))
    for name in ("crash_resume", "corrupt_quarantine"):
        diff = row[name]["param_max_diff_vs_uninterrupted"]
        if not diff <= RESUME_TOL:
            raise AssertionError(
                "{}: the params differ from the uninterrupted run's by "
                "{}".format(name, diff))
    if "20.corrupt" not in row["corrupt_quarantine"]["checkpoints"]:
        raise AssertionError("the garbled step 20 was not quarantined: "
                             "{}".format(row["corrupt_quarantine"]))
    c = row["poison_rollback"]
    if c["rollbacks"] != 1 or "20.corrupt" not in c["checkpoints"]:
        raise AssertionError("the poisoned step 20 was not rolled back: "
                             "{}".format(c))
    for name, run in variants.items():
        # plain: the train phases' runs again, in the same process; accum:
        # reported, and held one step at a time below
        tol = {"plain": RESUME_TOL, "remat": REMAT_LOSS_TOL}.get(
            name.split("_")[0])
        if tol is not None and not all(
                d is not None and d <= tol
                for d in run["loss_diff_vs_plain"].values()):
            raise AssertionError("{}: losses differ from the plain run's "
                                 "(plain: the train phases'): {}".format(
                                     name, run["loss_diff_vs_plain"]))
        diff = run.get("loss_diff_vs_k1", {})
        if not all(d <= MEGA_LOSS_TOL for d in diff.values()):
            raise AssertionError("{}: the K = {} losses differ from K = "
                                 "1's: {}".format(name, MEGA_K, diff))
    one = variants["accum2_k1"]["one_step_vs_accum1"]
    if not (one["loss_diff"] <= ACCUM_LOSS_TOL
            and one["grad_rel_err_max"] <= GRAD_RTOL):
        raise AssertionError("accum_steps={}: one step differs from the "
                             "full batch's: {}".format(ACCUM_STEPS, one))
    ev = row["evaluate"]
    if ev["batch_rows"] != [TRAIN_BATCH, TRAIN_BATCH,
                            EVAL_ROWS - 2 * TRAIN_BATCH]:
        raise AssertionError("evaluate saw batches of {} rows".format(
            ev["batch_rows"]))
    if not (all(math.isfinite(v) for v in got.values())
            and all(d <= EVAL_TOL for d in ev["diff"].values())):
        raise AssertionError("evaluate: flash {} against full {}".format(
            got, want))
    return row


def lm_rows(np, seed, n, seq, vocab):
    """``n`` rows of the JAX LM example's learnable token stream
    (examples/transformer/transformer_lm.py): each row counts up by one
    from a random offset."""
    base = np.arange(seq) % vocab
    offs = np.random.default_rng(seed).integers(0, vocab, (n, 1))
    return ((base[None, :] + offs) % vocab).astype(np.int32)


class RowCounter(object):
    """Passes a ShardedFeed on to ``fit_feed`` (single or grouped) and
    keeps each dispatch's valid rows as device scalars."""

    def __init__(self, feed):
        self.feed = feed
        self.rows = []

    def batches(self):
        for batch, mask in self.feed.batches():
            self.rows.append(mask.sum())
            yield batch, mask

    def grouped_batches(self, k):
        for kind, batch, mask in self.feed.grouped_batches(k):
            self.rows.append(mask.sum())
            yield kind, batch, mask

    def __getattr__(self, name):
        return getattr(self.feed, name)


def cluster_main(args, ctx):
    """The cluster phase's user fn, run by the node in the child it forked:
    the first CUDA call of that process is ``ctx.initialize_distributed()``.
    Trains the LM from the node's feed (K steps a dispatch when the
    executor's ``TFOS_STEPS_PER_CALL`` says so), exports it as the chief,
    writes the trained model's logits next to the export, and reports to
    ``args["report"]`` (the traceback too when it fails, then re-raises)."""
    import functools
    import importlib
    import traceback

    report = {"child_started": time.time()}
    try:
        import numpy as np
        import torch

        from tensorflowonspark_torch import checkpoint, train
        from tensorflowonspark_torch.models import get_model, transformer
        from tensorflowonspark_torch.ops import _build
        from tensorflowonspark_torch.parallel import infeed

        fa = importlib.import_module(
            "tensorflowonspark_torch.ops.flash_attention")
        device = ctx.initialize_distributed(device=args["device"])
        report["device"] = str(device)
        report["distributed_ready"] = time.time()
        if device.type == "cuda":
            # the parent built every kernel: this loads, it does not build
            t0 = time.perf_counter()
            built = _build.build()
            for name in built:
                _build.load(name)
            report["kernel_libs"] = {n: {"cached": r["cached"],
                                         "build_s": r["seconds"]}
                                     for n, r in built.items()}
            report["kernel_load_s"] = time.perf_counter() - t0
        cfg = args["config"]
        model = get_model("transformer_lm", **cfg)
        model.init_weights(torch.Generator().manual_seed(0))
        lm_loss = transformer.loss_fn(model)
        losses = []
        # the per-step loss curve: K-step dispatches write every step's
        curve = LossCurve()

        def loss_fn(params, batch, mask):
            # keeps each eager step's loss as a device scalar (no sync):
            # read once training is over
            loss, aux = lm_loss(params, batch, mask)
            losses.append(loss.detach())
            return loss, aux

        trainer = train.Trainer(
            loss_fn, dict(model.state_dict()),
            functools.partial(torch.optim.Adam, lr=args["lr"]),
            compute_dtype=getattr(torch, cfg["dtype"]),
            batch_size=args["batch"], log_steps=args["log_steps"],
            extra_step_flops=args["flash_flops"], summary_writer=curve,
            device=device)
        feed = RowCounter(infeed.ShardedFeed(
            ctx.get_data_feed(), args["batch"],
            transform=lambda t: {"tokens": t}, device=device))
        report["model_ready"] = time.time()
        first, step_ends = {}, []

        def on_steps(step):
            # host clock as each step's dispatch returns: the gaps show
            # where the step loop waited on the feed
            step_ends.append(time.perf_counter())
            if step == 1:
                first["t"] = time.time()

        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0

        def main_path():
            return trainer.fit_feed(feed, on_steps=on_steps)

        if device.type == "cuda":
            # under the profiler: the flash kernels the card executed
            stats, report["device_launches"] = counted_on_device(
                torch, main_path)
        else:
            stats = main_path()
        launches = {"flash_fwd": fa.fwd_launches,
                    "flash_bwd_dq": fa.bwd_dq_launches,
                    "flash_bwd_dkv": fa.bwd_dkv_launches}  # ... ends here
        if device.type == "cuda":
            torch.cuda.synchronize()
        report["fit_feed_end"] = time.time()
        log = trainer.history.timestamp_log
        window_ms = [1e3 * (t1 - t0_) / (s1 - s0)
                     for (s0, t0_), (s1, t1) in zip(log, log[1:])]
        later = sorted(window_ms[1:])
        if checkpoint.should_export(ctx):
            checkpoint.export_model(
                args["export_dir"], trainer.state.params, "transformer_lm",
                model_config=cfg,
                input_signature={"tokens": {"shape": [None, cfg["max_seq_len"]],
                                            "dtype": "int32"}})
            request = np.random.default_rng(args["request_seed"]).integers(
                0, cfg["vocab_size"], (1, cfg["max_seq_len"]), dtype=np.int32)
            with torch.inference_mode():
                logits = torch.func.functional_call(
                    model, trainer.state.params,
                    (torch.from_numpy(request).to(device),))
            np.save(os.path.join(args["export_dir"], "trained_logits.npy"),
                    logits.float().cpu().numpy())
        k = stats["megastep"]["steps_per_call"]
        report.update({
            "rows": float(sum(r.item() for r in feed.rows)),
            "steps": trainer.state.step,
            # eager steps: the loss_fn's own; K > 1: the per-step curve
            "losses": ([x.item() for x in losses] if k == 1 else
                       [curve.losses.get(s) for s in
                        range(1, trainer.state.step + 1)]),
            "megastep": stats["megastep"],
            "graphs": len(trainer._graphs),
            "launches": launches,
            "window_ms_per_step": window_ms,
            "steady_ms_per_step": later[len(later) // 2] if later else None,
            "first_step_end": first.get("t"),
            "step_interval_ms": [1e3 * (b - a) for a, b in
                                 zip(step_ends, step_ends[1:])],
            "infeed": feed.counters_snapshot(),
            "datafeed": feed.feed.feed.counters_snapshot(),
            "wire_formats": feed.wire_formats(),
            "overlap": stats["overlap"],
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if device.type == "cuda" else None)})
    except Exception:
        report["error"] = traceback.format_exc()
        raise
    finally:
        with open(args["report"] + ".tmp", "w") as f:
            json.dump(report, f)
        os.replace(args["report"] + ".tmp", args["report"])


def wait_for_report(path, seconds):
    """The node's report, once its child wrote it; raises after ``seconds``
    or when the report carries the child's traceback."""
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise AssertionError("the cluster node wrote no report within "
                                 "{} s".format(seconds))
        time.sleep(0.2)
    with open(path) as f:
        report = json.load(f)
    if "error" in report:
        raise AssertionError("the cluster node failed:\n" + report["error"])
    return report


def phase_cluster(torch, np, train_row, config=LM_CONFIG, device=None,
                  steps_per_call=1, k1_cluster=None):
    """Train the LM through the cluster lifecycle in SPARK input mode on a
    one-executor LocalBackend, serve the chief's export here, and check
    rows, steps, kernel launches in the node, loss and handoff.  With
    ``steps_per_call`` > 1 the executor's ``TFOS_STEPS_PER_CALL`` arms K
    steps a dispatch, and the losses are held to ``k1_cluster``'s."""
    from tensorflowonspark_torch import backend, cluster, serving

    vocab, layers = config["vocab_size"], config["num_layers"]
    seq = config["max_seq_len"]
    heads, head_dim = config["num_heads"], config["head_dim"]
    parts = backend.partition(list(lm_rows(np, 0, CLUSTER_ROWS, seq, vocab)),
                              CLUSTER_PARTS)
    if device is None:
        torch.cuda.empty_cache()   # the earlier phases' cached blocks
    with tempfile.TemporaryDirectory() as tmp:
        args = {"config": config, "device": device, "lr": LR,
                "batch": TRAIN_BATCH, "log_steps": CLUSTER_LOG_STEPS,
                "flash_flops": 7 * seq * seq * head_dim * TRAIN_BATCH
                * heads * layers,
                "export_dir": os.path.join(tmp, "export"),
                "report": os.path.join(tmp, "report.json"),
                "request_seed": 2}
        b = backend.LocalBackend(1)
        try:
            t_run = time.time()
            env = ({"TFOS_STEPS_PER_CALL": str(steps_per_call)}
                   if steps_per_call > 1 else None)
            c = cluster.run(b, cluster_main, args, num_executors=1,
                            input_mode=cluster.InputMode.SPARK,
                            executor_env=env)
            t_ready = time.time()
            c.train(parts, num_epochs=1)
            t_fed = time.time()
            c.shutdown(grace_secs=1)
            report = wait_for_report(args["report"], CLUSTER_REPORT_SECS)
        finally:
            b.stop()
        t_reported = time.time()
        request = np.random.default_rng(args["request_seed"]).integers(
            0, vocab, (1, seq), dtype=np.int32)
        server = serving.ModelServer(args["export_dir"],
                                     batch_size=SERVE_BATCH, device=device)
        served = server.predict_feed({"tokens": request}, 1)["output"]
        del server
        trained = np.load(os.path.join(args["export_dir"],
                                       "trained_logits.npy"))
    handoff_diff = float(np.abs(served - trained).max())
    handoff_scale = float(np.abs(trained).max())
    losses = report["losses"]
    if steps_per_call == 1:
        # steps 10 and 20 against the train phase's windows
        want_at = {LOG_STEPS * (i + 1): want for i, want in
                   enumerate(train_row.get("window_losses", []))}
    else:
        # steps 10 and 20 against the K = 1 cluster run's
        want_at = {step: k1_cluster["losses"][step - 1]
                   for step in (LOG_STEPS, 2 * LOG_STEPS)}
    vs_train = {str(step): (abs(losses[step - 1] - want)
                            if losses[step - 1] is not None else None)
                for step, want in want_at.items() if step <= len(losses)}
    expected = layers * CLUSTER_STEPS if report["device"] != "cpu" else 0
    steady = report["steady_ms_per_step"]
    row = {"phase": "cluster" if steps_per_call == 1 else "cluster_megastep",
           "config": config, "device": report["device"],
           "backend": "LocalBackend(1)", "input_mode": "SPARK",
           "steps_per_call_env": steps_per_call,
           "megastep": report["megastep"], "graphs": report["graphs"],
           "train_steps_per_call_max": report["overlap"].get(
               "train_steps_per_call_max"),
           "rows_fed": CLUSTER_ROWS, "partitions": CLUSTER_PARTS,
           "rows_trained": report["rows"], "steps": report["steps"],
           "expected_steps": CLUSTER_STEPS,
           "first_step_loss": losses[0] if losses else None,
           "last_step_loss": losses[-1] if losses else None,
           "losses": losses,
           "loss_diff_vs_" + ("train_phase" if steps_per_call == 1
                              else "k1_cluster"): vs_train,
           "loss_tol": CLUSTER_LOSS_TOL,
           "launches": report["launches"],
           "device_launches": report.get("device_launches"),
           "expected_launches": expected,
           "window_ms_per_step": report["window_ms_per_step"],
           "steady_ms_per_step": steady,
           "train_phase_steady_ms_per_step": train_row.get(
               "steady_ms_per_step"),
           "train_phase_ms_per_step": train_row.get("ms_per_step"),
           "feed_cost_ms_per_step": (
               steady - train_row["steady_ms_per_step"]
               if steady is not None
               and train_row.get("steady_ms_per_step") is not None else None),
           "bring_up_s": {
               "cluster_run": t_ready - t_run,
               "to_child_start": report["child_started"] - t_run,
               "to_distributed_ready": report["distributed_ready"] - t_run,
               "child_kernel_load_s": report.get("kernel_load_s"),
               "to_model_ready": report["model_ready"] - t_run,
               "to_first_step": (report["first_step_end"] - t_run
                                 if report["first_step_end"] else None)},
           "child_kernel_libs": report.get("kernel_libs"),
           "feed_s": t_fed - t_ready,
           "end_of_feed_to_report_s": t_reported - t_fed,
           "rows_per_s_fed": CLUSTER_ROWS / (t_fed - t_ready),
           "step_interval_ms": report["step_interval_ms"],
           "infeed": report["infeed"], "datafeed": report["datafeed"],
           "wire_formats": report["wire_formats"],
           "overlap": report["overlap"],
           "max_memory_allocated": report["max_memory_allocated"],
           "handoff_max_abs_diff": handoff_diff,
           "handoff_max_abs_logit": handoff_scale,
           "handoff_tol": HANDOFF_TOL * handoff_scale}
    emit(row)
    if report["rows"] != CLUSTER_ROWS or report["steps"] != CLUSTER_STEPS:
        raise AssertionError("the node trained {} rows in {} steps, expected "
                             "{} in {}".format(report["rows"], report["steps"],
                                               CLUSTER_ROWS, CLUSTER_STEPS))
    executed = report.get("device_launches") or {}
    if any(n != expected for n in list(report["launches"].values())
           + list(executed.values())) or (expected and not executed):
        raise AssertionError("kernel launches {} counted and {} executed on "
                             "the card in the node, expected {} each (layers "
                             "x steps)".format(report["launches"], executed,
                                               expected))
    if report["megastep"]["steps_per_call"] != steps_per_call:
        raise AssertionError("the node dispatched {} steps a call, expected "
                             "{}".format(report["megastep"], steps_per_call))
    if not (len(losses) == CLUSTER_STEPS and None not in losses
            and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("cluster training loss not finite and falling: "
                             "{}".format(losses))
    if not all(d is not None and d <= CLUSTER_LOSS_TOL
               for d in vs_train.values()) or len(vs_train) != len(
                   [s for s in want_at if s <= CLUSTER_STEPS]):
        raise AssertionError("the cluster node's losses differ from the "
                             "reference run's on the same stream: {}".format(
                                 vs_train))
    if not handoff_diff <= HANDOFF_TOL * handoff_scale:
        raise AssertionError("the served cluster export differs from the "
                             "trained model by {} (max |logit| {})".format(
                                 handoff_diff, handoff_scale))
    return row


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a "
              "CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch.nn.functional as F

    import tensorflowonspark_torch as tt
    if not os.path.abspath(tt.__file__).startswith(HERE + os.sep):
        raise RuntimeError("tensorflowonspark_torch imported from {}, not "
                           "from this checkout".format(tt.__file__))
    from tensorflowonspark_torch import device as device_mod, metrics
    from tensorflowonspark_torch.ops import _build as build

    fa = importlib.import_module("tensorflowonspark_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device = phase_device(torch, device_mod)
    usage = phase_build(build)
    warm_clocks(torch)
    fwd_rows = [flash_case(torch, F, fa, metrics, device["kind"], usage, *case)
                for case in FLASH_CASES]
    bwd_rows = [bwd_case(torch, F, fa, metrics, device["kind"], usage, *case)
                for case in BWD_CASES]
    serve = phase_serve(torch, np, fa)
    # the training shape: FLASH_CASES[1] and BWD_CASES[0]
    at_train = {"flash_fwd": fwd_rows[1], "flash_bwd_dq": bwd_rows[0][0],
                "flash_bwd_dkv": bwd_rows[0][1]}
    trained = phase_train(torch, np, fa, metrics, device["kind"],
                          {n: r["kernel_ms"] for n, r in at_train.items()})
    mega, mega_params = phase_train_megastep(torch, np, fa, metrics, trained)
    supervised = phase_supervised(torch, np, fa, trained, mega, mega_params)
    del mega_params
    clustered = phase_cluster(torch, np, trained)
    mega_cluster = phase_cluster(torch, np, trained, steps_per_call=MEGA_K,
                                 k1_cluster=clustered)

    serve_row = fwd_rows[0]
    head_dim_train = LM_CONFIG["head_dim"]
    replaces = {
        "flash_fwd": "tensorflowonspark_tpu/ops/flash_attention.py:49",
        "flash_bwd_dq": "tensorflowonspark_tpu/ops/flash_attention.py:158",
        "flash_bwd_dkv": "tensorflowonspark_tpu/ops/flash_attention.py:192",
    }
    sources = {"flash_fwd": "tensorflowonspark_torch/csrc/flash_fwd.cu",
               "flash_bwd_dq": "tensorflowonspark_torch/csrc/flash_bwd.cu",
               "flash_bwd_dkv": "tensorflowonspark_torch/csrc/flash_bwd.cu"}
    variants = supervised["variants"]
    supervised_paths = {
        "supervised_k5": supervised["crash_resume"],
        "accum2": variants["accum2_k1"], "accum2_k5": variants["accum2_k5"],
        "remat": variants["remat_k1"], "remat_k5": variants["remat_k5"],
        "eval": supervised["evaluate"]}
    kernels = []
    for name, row in at_train.items():
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            # this slice's main path: fit_supervised at K = 5 through a
            # crash and a resume; its counter, held equal to the kernels the
            # profiler saw the card execute there (device_launches_by_path)
            "launches": supervised["crash_resume"]["launches"][name],
            "device_launches_by_path": dict(
                {"train_k5": mega["device_launches"][name],
                 "cluster": clustered["device_launches"][name],
                 "cluster_k5": mega_cluster["device_launches"][name]},
                **{path: run["device_launches"][name]
                   for path, run in supervised_paths.items()}),
            "launches_by_path": dict(
                {"train": trained["launches"][name],
                 "train_k5": mega["launches"][name],
                 "cluster": clustered["launches"][name],
                 "cluster_k5": mega_cluster["launches"][name]},
                **{path: run["launches"][name]
                   for path, run in supervised_paths.items()}),
            # device time per step inside the replayed graph (K = 5) and
            # in eager steps (K = 1), from the two phases' profiles
            "graph_device_ms_per_step": mega["profile"][
                "ms_per_step_by_group"].get(name),
            "eager_device_ms_per_step": trained["profile"][
                "ms_per_step_by_group"].get(name),
            "max_abs_err": row.get("max_abs_err", row.get("max_abs_err_o")),
            "ms": row["kernel_ms"], "device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "product_path": row["product_path"],
            "registers": row["registers"],
            "checked_shapes": (len(fwd_rows) if name == "flash_fwd"
                               else len(bwd_rows))}
        if name == "flash_fwd":
            entry["launches_by_path"]["serve"] = serve["fwd_launches"]
            entry["serve_shape"] = {
                k: serve_row[k] for k in ("shape", "max_abs_err_o",
                                          "kernel_ms", "kernel_device_ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "product_path",
                                          "registers")}
        if name == "flash_bwd_dq":   # the training width at head_dim 32, 128
            entry["other_head_dims"] = {
                str(r[0]["shape"][3]): {
                    k: r[0].get(k) for k in (
                        "shape", "max_abs_err", "kernel_ms",
                        "kernel_device_ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "product_path",
                        "registers", "spill_stores")}
                for r in bwd_rows
                if r[0]["shape"][:2] == [TRAIN_BATCH, SEQ]
                and r[0]["shape"][3] != head_dim_train}
        kernels.append(entry)
    emit({"kernels": kernels})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
