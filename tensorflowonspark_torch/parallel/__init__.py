"""Parallelism layer of the port (the counterpart of
:mod:`tensorflowonspark_tpu.parallel`): the plain attention contraction
(:func:`~tensorflowonspark_torch.parallel.ring.reference_attention`), the
host-level agreement helpers
(:mod:`~tensorflowonspark_torch.parallel.collectives`) and the SPARK-mode
infeed (:class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed`)."""
