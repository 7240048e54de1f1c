"""tensorflowonspark_torch — the PyTorch and CUDA port of
:mod:`tensorflowonspark_tpu` for NVIDIA Hopper (H100).

It keeps the JAX package's module paths and public names, so every module
here has one counterpart there, and it imports nothing of the JAX package
(nor jax): what it needs of a jax-free module is copied.  Kernels that the
JAX package wrote in Pallas for the TPU are hand-written CUDA here, under
``csrc/``, each beside its plain PyTorch version.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

Ported so far (the serving and training slices):

- :mod:`~tensorflowonspark_torch.device`      — device resolution
- :mod:`~tensorflowonspark_torch.ops`         — FlashAttention-2 forward and
  backward kernels
- :mod:`~tensorflowonspark_torch.parallel`    — reference attention
- :mod:`~tensorflowonspark_torch.models`      — registry + transformer LM
  and its loss
- :mod:`~tensorflowonspark_torch.convert`     — flax tree <-> state_dict
- :mod:`~tensorflowonspark_torch.train`       — Trainer (step, fit_feed)
- :mod:`~tensorflowonspark_torch.checkpoint`  — CheckpointManager, export /
  load
- :mod:`~tensorflowonspark_torch.serving`     — ModelServer
- :mod:`~tensorflowonspark_torch.inference_cli` — run_inference
- :mod:`~tensorflowonspark_torch.metrics`     — TimeHistory, MFU, peak
  rates, roofline
"""
