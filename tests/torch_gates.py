"""Runs one of the port's one-shot gates (``scripts/ci_assert_torch_*.py``)
as a script, as the JAX gates are run: its node functions are pickled by
reference from ``__main__``, so a gate cannot run inside the pytest
process."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_SECS = 240


def run_gate(gate, *verdicts):
    """Run ``scripts/<gate>`` and assert it exits 0 and prints every line
    of ``verdicts``."""
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", gate)],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_SECS)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    for verdict in verdicts:
        assert verdict in proc.stdout, proc.stdout[-4000:]
