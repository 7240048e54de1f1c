"""``scripts/ci_assert_torch_fleet.py``'s whole walk on the CPU, as the JAX
gate is run: three models with two ``inference_cli --registry/--model``
replicas each, a poisoned ``beta@2`` rolled back and retired, a
``fit_supervised(publish=)`` ``beta@3`` walked to live, ``/fleet`` and
``/alerts`` served, and ``replay_journal`` re-deriving the decisions."""

import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ci_assert_torch_fleet_walk(capsys):
    spec = importlib.util.spec_from_file_location(
        "ci_assert_torch_fleet",
        os.path.join(REPO, "scripts", "ci_assert_torch_fleet.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    assert gate.main() == 0
    out = capsys.readouterr().out
    assert "fleet OK" in out and "across 3 models" in out
