"""Hand-written CUDA kernels for the hot ops, each beside its plain PyTorch
version (the port of :mod:`tensorflowonspark_tpu.ops`).  Attention first
(:mod:`~tensorflowonspark_torch.ops.flash_attention`).  Kernels are built
from ``csrc/`` at their first use on a card, never at import."""

from tensorflowonspark_torch.ops.flash_attention import flash_attention  # noqa: F401
