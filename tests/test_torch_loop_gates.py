"""The port's step-loop gates on the CPU, each run as a script:
``scripts/ci_assert_torch_overlap.py`` (guarded dispatches, an async save
that returns before its slowed write lands, the overlap counters and
spans) and ``scripts/ci_assert_torch_megastep.py`` (K-step groups from
``TFOS_STEPS_PER_CALL=4``, a live retune to 8 on a group boundary, exact
work)."""

import pytest

from torch_gates import run_gate


@pytest.mark.parametrize("gate, verdict", [
    ("ci_assert_torch_overlap.py", "overlap OK"),
    ("ci_assert_torch_megastep.py", "megastep OK"),
])
def test_gate(gate, verdict):
    run_gate(gate, verdict)
