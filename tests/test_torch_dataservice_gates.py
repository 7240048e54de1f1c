"""The port's data-service gates on the CPU, each run as a script as the
JAX gates are: ``scripts/ci_assert_torch_dataservice.py`` (a worker
SIGKILLed mid-split, exact totals over two consumers),
``scripts/ci_assert_torch_cache.py`` (a 2-epoch STATIC job, >= 90% of
epoch 2's splits from the worker cache, the codec's ratio on ``/metrics``)
and ``scripts/ci_assert_torch_shared.py`` (the dispatcher process
SIGKILLed and restarted from its journal under two attached consumers)."""

import pytest

from torch_gates import run_gate


@pytest.mark.parametrize("gate, verdict", [
    ("ci_assert_torch_dataservice.py", "data service OK"),
    ("ci_assert_torch_cache.py", "cache OK"),
    ("ci_assert_torch_shared.py", "shared OK"),
])
def test_gate(gate, verdict):
    run_gate(gate, verdict)
