"""The port's host-level agreement helpers
(:mod:`tensorflowonspark_torch.parallel.collectives`): the JAX package's
semantics over a gloo all-reduce, checked in a world of two CPU processes,
and the value itself in a single process."""

from tensorflowonspark_torch.parallel import collectives

from torch_world import run_world


def _helpers(rank):
    collectives.init_host_group()   # gloo default group: reused
    return {
        "world": collectives.world_size(),
        "agree_all": collectives.all_hosts_agree(True),
        "agree_one": collectives.all_hosts_agree(rank == 0),
        "any_one": collectives.any_host_has_data(rank == 1),
        "any_none": collectives.any_host_has_data(False),
        "eod_all": collectives.end_of_data_consensus(True),
        "eod_one": collectives.end_of_data_consensus(rank == 0),
        "flag_sum": collectives.host_sum(rank == 1),
        "sum": collectives.host_sum(rank + 0.5),
        "big_sum": collectives.host_sum(2 ** 40 + rank),
    }


def test_two_processes_agree():
    for got in run_world(_helpers, 2):
        assert got == {"world": 2, "agree_all": True, "agree_one": False,
                       "any_one": True, "any_none": False, "eod_all": True,
                       "eod_one": False, "flag_sum": 1.0, "sum": 2.0,
                       "big_sum": 2.0 ** 41 + 1}


def test_single_process_returns_the_value():
    assert collectives.world_size() == 1
    assert collectives.all_hosts_agree(True) is True
    assert collectives.all_hosts_agree(False) is False
    assert collectives.any_host_has_data(True) is True
    assert collectives.end_of_data_consensus(False) is False
    assert collectives.host_sum(2.5) == 2.5
    assert collectives.host_sum(True) == 1.0
