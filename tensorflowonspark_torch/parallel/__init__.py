"""Parallelism layer of the port (the counterpart of
:mod:`tensorflowonspark_tpu.parallel`).  So far it holds only the plain
attention contraction, :func:`~tensorflowonspark_torch.parallel.ring.reference_attention`."""
