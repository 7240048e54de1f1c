"""The port's alerting and control gates on the CPU, each run as a script:
``scripts/ci_assert_torch_watchtower.py`` (a straggler and a NaN loss
caught live, attributed to the right executor on every surface and
re-derived offline from the journal) and
``scripts/ci_assert_torch_autopilot.py`` (a starved prefetch depth raised
live through ``node.apply_knobs``, kept on a measured drop, journaled and
replayed)."""

import pytest

from torch_gates import run_gate


@pytest.mark.parametrize("gate, verdict", [
    ("ci_assert_torch_watchtower.py", "watchtower OK"),
    ("ci_assert_torch_autopilot.py", "autopilot OK"),
])
def test_gate(gate, verdict):
    run_gate(gate, verdict)
