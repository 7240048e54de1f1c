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
  the trained model's logits.

Each phase prints one JSON line; any failure raises and the exit code is
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  It needs
one card; without CUDA, or without the package beside it, it fails.
"""

import importlib
import json
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


def time_steps(torch, trainer, feed, n, first=None):
    """Mean ms of ``n`` Trainer steps on ``feed``'s batches, host clock
    from a synchronised start to a synchronised end; ``first()`` runs after
    the first step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        trainer.step(*feed.next_batch())
        if i == 0 and first is not None:
            first()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


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


def profile_steps(torch, trainer, feed, n):
    """Device time of ``n`` Trainer steps by kernel group, from
    ``torch.profiler`` (CUDA activity): per-step ms by group, the
    device-busy sum against the profiled wall time, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    batches = [feed.next_batch() for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch, mask in batches:
            trainer.step(batch, mask)
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

    def terminate(self):
        self.terminated = True


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
    optimizer = functools.partial(torch.optim.Adam, lr=LR)
    # the flash kernels' FLOPs, which FlopCounterMode cannot see: causal
    # forward 2 and backward 5 S^2 D products per (batch, head, layer)
    flash_flops = 7 * SEQ * SEQ * head_dim * TRAIN_BATCH * heads * layers
    # model FLOPs for comparison: 3 x the forward's matmuls, plus the above
    analytic_flops = (3 * TRAIN_BATCH * SEQ * (24 * d_model * d_model * layers
                                              + 2 * d_model * vocab)
                      + flash_flops)

    def new_trainer():
        return train.Trainer(loss_fn, init, optimizer,
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

        # where a step's time goes, once warm: steps with no checkpoint in
        # flight, the same with one async save in flight, and a profile
        more = NgramFeed(np, 3, TRAIN_BATCH, SEQ, vocab)
        steady_ms = time_steps(torch, trainer, more, STEADY_STEPS)
        ckpt2 = checkpoint.CheckpointManager(
            os.path.join(tmp, "ckpt2"), save_interval_steps=0,
            async_save=True)
        inflight_ms = time_steps(
            torch, trainer, more, STEADY_STEPS,
            first=lambda: ckpt2.maybe_save(trainer.state.step,
                                           trainer.state, force=True))
        ckpt2.close()
        profile = profile_steps(torch, trainer, more, PROFILE_STEPS)
        # the profiler slows the host; against the unprofiled steady step
        busy = profile["device_busy_ms_per_step"]
        profile["device_idle_share_of_steady_step"] = (
            1.0 - busy / steady_ms if busy else None)

    steps = stats["global_steps"]
    expected = layers * steps
    losses_finite = all(np.isfinite(x) for x in window_losses + [first_loss])
    row = {"phase": "train", "config": LM_CONFIG, "device": str(dev),
           "batch": TRAIN_BATCH, "seq": SEQ, "steps": steps,
           "optimizer": "torch.optim.Adam(lr={})".format(LR),
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
           "steady_tokens_per_s": TRAIN_BATCH * SEQ / (steady_ms / 1e3),
           "steady_mfu": metrics.mfu_from_step_time(step_flops,
                                                    steady_ms / 1e3),
           "steady_flash_share": flash_ms / steady_ms,
           "save_in_flight_ms_per_step": inflight_ms,
           "profile": profile,
           "overlap": stats["overlap"],
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
    kernels = []
    for name, row in at_train.items():
        entry = {
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            "launches": trained["launches"][name],
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
            entry["launches_by_path"] = {"serve": serve["fwd_launches"],
                                         "train": entry["launches"]}
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
