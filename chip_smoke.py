#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``tensorflowonspark_torch/csrc/``, holds each kernel against its plain
PyTorch version at the shapes the serving path gives it and times both (and
one PyTorch library call as a yardstick), then serves the flagship
transformer LM (vocab 32000, 8 layers, 16 heads x 64, 1024 tokens, bf16,
``attention="flash"``, random weights from a seed) through
``serving.ModelServer`` and checks that every attention went through the
kernel and that the logits agree with the same weights served with
``attention="full"``.

Each phase prints one JSON line; any failure raises and the exit code is
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  It needs
one card; without CUDA, or without the package beside it, it fails.
"""

import importlib
import json
import os
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

# (shape [B, S, H, D], dtype, causal, fused): the serving shape first
FLASH_CASES = [
    ((SERVE_BATCH, SEQ, 16, 64), "bfloat16", True, True),
    ((2, 256, 4, 64), "float32", True, False),
    ((2, 256, 4, 64), "float32", False, False),
    ((2, 256, 4, 128), "bfloat16", True, False),
    ((2, 256, 4, 128), "float32", False, False),
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


def phase_build(build):
    t0 = time.perf_counter()
    results = build.build()
    # each variant's entry-function line, then its registers and spills
    ptxas = {name: [line.strip() for line in r["log"].splitlines()
                    if "Compiling entry function" in line
                    or "registers" in line or "spill" in line]
             for name, r in results.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": r["seconds"], "cached": r["cached"]}
                      for n, r in results.items()},
          "ptxas": ptxas})
    return results


def flash_case(torch, F, fa, metrics, kind, shape, dtype_name, causal, fused):
    """Check one flash_fwd case against the plain version; time kernel,
    plain and the library call; compute the roofline bound."""
    import numpy as np

    b, s, h, d = shape
    dtype = getattr(torch, dtype_name)
    x = np.random.default_rng(0).standard_normal((b, s, 3, h, d))
    qkv = torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)
    if fused:   # strided views of one buffer, as the transformer gives them
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
    scale = 1.0 / d ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_plain(q, k, v, causal, scale)
    err_o = (out.float() - want_out).abs().max().item()
    err_l = (lse - want_lse).abs().max().item()
    ok = (bool(torch.isfinite(out.float()).all()) and err_o < O_TOL[dtype_name]
          and err_l < L_TOL)

    kernel_ms = time_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, scale,
                                                          causal))
    plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, causal, scale), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=scale))

    pairs = s * (s + 1) // 2 if causal else s * s    # (query, key) pairs
    flops = 4 * d * pairs * b * h                    # QK^T and PV
    elt = q.element_size()
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4  # q, k, v, O; L fp32
    bound_ms = 1e3 * metrics.roofline_seconds(flops, nbytes, kind, dtype_name)
    row = {"phase": "kernel", "name": "flash_fwd", "shape": list(shape),
           "dtype": dtype_name, "causal": causal, "fused_qkv": fused,
           "max_abs_err_o": err_o, "max_abs_err_l": err_l,
           "tol_o": O_TOL[dtype_name], "tol_l": L_TOL, "ok": ok,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": metrics.roofline_bound_by(flops, nbytes, kind,
                                                 dtype_name),
           "flops": flops, "bytes": nbytes,
           "bound_share": bound_ms / kernel_ms}
    emit(row)
    if not ok:
        raise AssertionError("flash_fwd disagrees with its plain version: "
                             "{}".format(row))
    return row


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
    phase_build(build)
    rows = [flash_case(torch, F, fa, metrics, device["kind"], *case)
            for case in FLASH_CASES]
    serve = phase_serve(torch, np, fa)

    main_row = rows[0]   # the serving shape
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "tensorflowonspark_torch/csrc/flash_fwd.cu",
        "replaces": "tensorflowonspark_tpu/ops/flash_attention.py:49",
        "launches": serve["fwd_launches"],
        "max_abs_err": main_row["max_abs_err_o"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "checked_shapes": len(rows)}]})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
