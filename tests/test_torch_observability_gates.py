"""The port's observability gates on the CPU, each run as a script:
``scripts/ci_assert_torch_observatory.py`` (live scrapes of the MFU and
goodput accountant, split flows across the dispatcher, a worker and a
consumer), ``scripts/ci_assert_torch_profiling.py`` (attribution gauges,
an on-demand capture of both nodes, one merged timeline) and
``scripts/ci_assert_torch_native.py`` (the C++ ring and TFRecord codec
loaded, not their fallbacks)."""

import pytest

from torch_gates import run_gate


@pytest.mark.parametrize("gate, verdict", [
    ("ci_assert_torch_observatory.py", "observatory OK"),
    ("ci_assert_torch_profiling.py", "profiling OK"),
    ("ci_assert_torch_native.py", "native engines OK"),
])
def test_gate(gate, verdict):
    run_gate(gate, verdict)
