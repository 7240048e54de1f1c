"""``chip_smoke.py``'s segmentation phase rehearsed on the CPU at a tiny
width: the U-Net twin's node brought up beside nothing, let go, trained
through ``cluster.run`` in FILES mode, its export served by
``ModelServer`` and held to the trainer's forward, the first loss held to
the port's fp32 loss on the CPU, and every check the phase makes on the
card (no flash launch, the JAX example's descriptor, the rebuilt
widths)."""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = ["--cluster_size", "1", "--image_size", "32", "--batch_size", "8",
        "--encoder_filters", "16,32", "--dtype", "bfloat16",
        "--synthetic_examples", "32", "--train_steps", "12",
        "--log_steps", "4", "--lr", "1e-2"]


@pytest.mark.chaos(timeout=240)
def test_segmentation_phase_on_the_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    started = cs.start_segmentation(torch, np, flags=TINY, device="cpu")
    row = cs.phase_segmentation(torch, np, started, card="cpu")
    assert row["steps"] == 12 and row["device"] == "cpu"
    assert row["last_loss"] < row["first_loss"]
    assert row["first_loss_rel_gap"] <= cs.SEG_LOSS_RTOL
    assert row["served_logit_gap"] <= cs.SEG_SERVE_TOL
    assert row["served_widths"] == [16, 32]
    assert row["flash_launches_in_node"] == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert row["max_memory_allocated"] is None
    assert len(row["window_ms_per_step"]) == 3
    assert not os.path.exists(started["tmp"])


@pytest.mark.chaos(timeout=240)
def test_segmentation_stop_releases_a_waiting_node(monkeypatch):
    """A phase before it failed: ``stop_segmentation`` lets the waiting node
    go with an abort, and its cluster ends (the script would otherwise
    wait on the node's executor)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    started = cs.start_segmentation(torch, np, flags=TINY, device="cpu")
    cs.stop_segmentation(started)
    assert not started["leg"].thread.is_alive()
    assert not os.path.exists(started["tmp"])
