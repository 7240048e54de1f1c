"""tensorflowonspark_torch — the PyTorch and CUDA port of
:mod:`tensorflowonspark_tpu` for NVIDIA Hopper (H100).

It keeps the JAX package's module paths and public names, so every module
here has one counterpart there, and it imports nothing of the JAX package
(nor jax): what it needs of a jax-free module is copied.  Kernels that the
JAX package wrote in Pallas for the TPU are hand-written CUDA here, under
``csrc/``, each beside its plain PyTorch version.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

Ported so far (the serving, training and cluster slices):

- :mod:`~tensorflowonspark_torch.cluster`     — ``cluster.run``, the
  ``TPUCluster`` lifecycle, SPARK and FILES input modes (copied)
- :mod:`~tensorflowonspark_torch.node`        — the per-executor node
  runtime; ``initialize_distributed`` joins a ``torch.distributed`` world
- copied jax-free planes: ``backend``, ``reservation``, ``standby``,
  ``manager``, ``datafeed``, ``marker``, ``columnar``, ``wire``,
  ``shmring`` (+ ``native``), ``fault``, ``telemetry``, ``fsio``, ``util``
- :mod:`~tensorflowonspark_torch.device`      — device resolution, card
  pinning
- :mod:`~tensorflowonspark_torch.ops`         — FlashAttention-2 forward and
  backward kernels
- :mod:`~tensorflowonspark_torch.parallel`    — reference attention, the
  host-level collectives, the ``ShardedFeed`` infeed
- :mod:`~tensorflowonspark_torch.models`      — registry, transformer LM,
  MNIST CNN, their losses
- :mod:`~tensorflowonspark_torch.convert`     — flax tree <-> state_dict
- :mod:`~tensorflowonspark_torch.train`       — Trainer (step, fit_feed,
  data-parallel gradient all-reduce)
- :mod:`~tensorflowonspark_torch.checkpoint`  — CheckpointManager, export /
  load, ``should_export``
- :mod:`~tensorflowonspark_torch.serving`     — ModelServer
- :mod:`~tensorflowonspark_torch.inference_cli` — run_inference
- :mod:`~tensorflowonspark_torch.metrics`     — TimeHistory, MFU, peak
  rates, roofline, card memory counters
- :mod:`~tensorflowonspark_torch.dataservice` — the disaggregated data
  service: dispatcher, feed workers and ``ServiceFeed`` (copied), with the
  ``dataservice_worker``, ``dataservice_dispatcher`` and
  ``reservation_server`` CLIs

CUDA and fork: the cluster layer forks (the manager server, the SPARK-mode
user-fn child), and a process that has initialized CUDA cannot hand it to
a forked child.  The driver and the executor shells never initialize CUDA;
the first CUDA call is in the user's ``main_fun``.
"""

__version__ = "0.1.0"
