"""``chip_smoke.py``'s dataservice phase rehearsed on the CPU at a tiny
width: the journaled dispatcher and two worker processes of the port
(``--reader tfrecord --fields id,tokens``, one SIGKILLed mid-split), the
FILES-mode node training from ``ctx.get_service_feed``, and every check
the phase makes on the card but the kernels' launches (none on the CPU):
each row once an epoch, the fence and re-pool, epoch 2 from the caches,
colv1 on the wire, the node's losses equal to the replay's, the split
flow ended at ``train_dispatch``."""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = dict(cs.LM_CONFIG, vocab_size=64, num_layers=2, num_heads=2,
            head_dim=8, max_seq_len=32)


@pytest.mark.chaos(timeout=240)
def test_dataservice_phase_on_the_cpu(monkeypatch):
    # one thread each here and in the node's executor (it inherits the
    # environment): the tiny model gains nothing from more, and the suite
    # runs beside it
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        started = cs.start_dataservice(torch, np, config=TINY, device="cpu")
        row = cs.phase_dataservice(torch, np, started, card="cpu")
    finally:
        torch.set_num_threads(threads)
    assert row["steps"] == cs.DS_STEPS == 24
    assert row["splits_committed"] == 24 and row["split_dupes"] == 0
    assert row["exit_codes"]["ds-w0"] == -9
    assert row["workers_listed"] == ["ds-w1"]
    assert row["cache_hits"] > 0
    assert row["max_loss_diff_vs_replay"] <= cs.CLUSTER_LOSS_TOL
    assert row["flows_ended_at_dispatch"] >= 1
    assert not os.path.exists(started["tmp"])
