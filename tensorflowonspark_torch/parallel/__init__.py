"""Parallelism layer of the port (the counterpart of
:mod:`tensorflowonspark_tpu.parallel`): the device mesh
(:mod:`~tensorflowonspark_torch.parallel.mesh`), FSDP
(:mod:`~tensorflowonspark_torch.parallel.fsdp`), ring and Ulysses
sequence parallelism and the plain attention contraction
(:mod:`~tensorflowonspark_torch.parallel.ring`), the host-level agreement
helpers (:mod:`~tensorflowonspark_torch.parallel.collectives`) and the
SPARK-mode infeed (:class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed`).
Tensor, pipeline and expert parallelism (the JAX package's ``tp``, ``pp``
and ``ep``) wait for ROADMAP.md's item J2."""

from tensorflowonspark_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    build_mesh,
    batch_sharding,
    replicated,
)
from tensorflowonspark_torch.parallel.collectives import (  # noqa: F401
    all_hosts_agree,
    end_of_data_consensus,
)
