"""The port's remediator gate on the CPU, run as a script:
``scripts/ci_assert_torch_remediator.py`` evicts and replaces a straggler,
scales the data service's workers out with an exactly-once job under way,
and rolls a poisoned run back to its last finite checkpoint, with no
operator."""

from torch_gates import run_gate


def test_remediator_gate():
    run_gate("ci_assert_torch_remediator.py",
             "remediator fleet OK", "remediator rollback OK")
