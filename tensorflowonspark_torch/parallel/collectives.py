"""Small cross-host agreement helpers for the SPARK-mode feed path (the
counterpart of :mod:`tensorflowonspark_tpu.parallel.collectives`, same
semantics; no mesh argument, since the port has no mesh).

The headline one is :func:`end_of_data_consensus` — the exact fix for the
original system's fragile uneven-partition handling: its example told
users to train on "90% of the steps" so no worker starved at epoch end
(``examples/mnist/keras/mnist_spark.py:58-66`` there); here all hosts agree
on every step whether a full global batch exists (SURVEY §7.4.1).

Implementation: one host-level all-reduce of a CPU scalar on a **gloo**
group per call, never a device collective.  The flag is born on the host
(did my queue yield rows?), so an NCCL all-reduce would pay a
host→device→host round trip per step for no win.  The group is made once
by :func:`init_host_group` (``TPUNodeContext.initialize_distributed`` calls
it right after ``init_process_group``); without an initialized world, or in
a world of one, every helper returns the value itself.
"""

import torch
import torch.distributed as dist

# the gloo group of this process's world: None until init_host_group ran
# (or when the default group is gloo and serves as it)
_HOST_GROUP = {"group": None}


def init_host_group():
    """Create the gloo group that carries the host-level agreement.  A
    collective call: every rank of the world calls it once, right after
    ``init_process_group``.  When the default group is already gloo it is
    reused."""
    if dist.get_backend() == "gloo":
        _HOST_GROUP["group"] = None
    else:
        _HOST_GROUP["group"] = dist.new_group(backend="gloo")


def world_size():
    """Processes in the ``torch.distributed`` world (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _host_allreduce(value, op):
    """All-reduce one host scalar across the processes (the shared core of
    every helper here); a single process returns the value itself.

    Values travel as float64, so a host-local count is exact to 2^53."""
    if world_size() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, op=op, group=_HOST_GROUP["group"])
    return float(t.item())


def all_hosts_agree(local_flag):
    """Global logical-AND of a per-host boolean; True iff every process
    passed True."""
    return bool(_host_allreduce(bool(local_flag), dist.ReduceOp.MIN))


def any_host_has_data(local_flag):
    """Global logical-OR of a per-host boolean (the dual of
    :func:`end_of_data_consensus`): True while ANY process still has data.
    Used by exact-evaluation draining, where exhausted hosts keep stepping
    with zero-mask dummies until everyone finishes."""
    return bool(_host_allreduce(bool(local_flag), dist.ReduceOp.MAX))


def host_sum(value):
    """Sum a per-HOST-LOCAL scalar across all processes.  Only for values
    each process computed over its OWN data (host-side accumulators, local
    file stats), never for values that are already global."""
    return _host_allreduce(value, dist.ReduceOp.SUM)


def end_of_data_consensus(local_has_data):
    """True iff *every* host still has data for the next step.

    Call once per step in SPARK input mode; when any host's feed is
    exhausted all hosts stop together, keeping the ranks in lock-step."""
    return all_hosts_agree(local_has_data)
