"""The port's cluster-layer gates on the CPU, each run as a script:
``scripts/ci_assert_torch_elastic.py`` (a SIGKILLed node detected,
released and replaced, every partition fed once),
``scripts/ci_assert_torch_telemetry.py`` (the lifecycle spans and the
heartbeat-carried counters) and ``scripts/ci_assert_torch_ha.py`` (a
SIGSTOPped primary coordinator taken over by its standby, the zombie
fenced by epoch, exact totals and no false fence)."""

import pytest

from torch_gates import run_gate


@pytest.mark.parametrize("gate, verdict", [
    ("ci_assert_torch_elastic.py", "elastic recovery OK"),
    ("ci_assert_torch_telemetry.py", "telemetry OK"),
    ("ci_assert_torch_ha.py", "coordinator HA OK"),
])
def test_gate(gate, verdict):
    run_gate(gate, verdict)
