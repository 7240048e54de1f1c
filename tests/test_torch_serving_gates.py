"""The port's serving gates on the CPU, each run as a script:
``scripts/ci_assert_torch_serving.py`` (a replica SIGKILLed under load:
zero lost requests, every prediction exact, the second replica warm from
the first's rungs, the SLO burn paging) and
``scripts/ci_assert_torch_reqtrace.py`` (an injected dispatch stall
decomposed by stage, named on ``/slow``, paged for the slow replica only,
stitched across processes and replayed from the journal)."""

import pytest

from torch_gates import run_gate


@pytest.mark.parametrize("gate, verdict", [
    ("ci_assert_torch_serving.py", "serving OK"),
    ("ci_assert_torch_reqtrace.py", "reqtrace OK"),
])
def test_gate(gate, verdict):
    run_gate(gate, verdict)
