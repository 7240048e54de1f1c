"""Parallelism layer of the port (the counterpart of
:mod:`tensorflowonspark_tpu.parallel`): the device mesh and its per-leaf
placements (:mod:`~tensorflowonspark_torch.parallel.mesh`), FSDP
(:mod:`~tensorflowonspark_torch.parallel.fsdp`), tensor, expert and
pipeline parallelism (:mod:`~tensorflowonspark_torch.parallel.tp`,
:mod:`~tensorflowonspark_torch.parallel.ep`,
:mod:`~tensorflowonspark_torch.parallel.pp`) over the differentiable
collectives of :mod:`~tensorflowonspark_torch.parallel.comm`, ring and
Ulysses sequence parallelism and the plain attention contraction
(:mod:`~tensorflowonspark_torch.parallel.ring`), the host-level agreement
helpers (:mod:`~tensorflowonspark_torch.parallel.collectives`) and the
SPARK-mode infeed (:class:`~tensorflowonspark_torch.parallel.infeed.ShardedFeed`)."""

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
from tensorflowonspark_torch.parallel.tp import (  # noqa: F401
    shard_params,
    tp_param_shardings,
)
from tensorflowonspark_torch.parallel.pp import (  # noqa: F401
    gpipe,
    split_microbatches,
    stack_stage_params,
    stage_shardings,
)
