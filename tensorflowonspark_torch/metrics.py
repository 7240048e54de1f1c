"""Peak rates and roofline bounds of the port's CUDA cards (the counterpart
of :mod:`tensorflowonspark_tpu.metrics`' peak tables).

Keyed on the full lowercased ``torch.cuda.get_device_name()`` (exact
match: a prefix rule would let one part's figures pass for another's).
Figures are NVIDIA's data-sheet peaks at the full power limit, dense (no
sparsity); a card set below its limit runs slower, so a bound computed
from them is the least time, never a promise.
"""

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
