"""``scripts/ci_assert_torch_warmstart.py`` on the CPU, as the JAX gate
(``scripts/ci_assert_warmstart.py``) is run: two nodes share a compile
root, one is SIGKILLed mid-feed, and its replacement's step program
resolves to ``loaded`` with its AOT load on a live ``/metrics`` scrape and
every fed element counted once.  The gate runs as a script: its node
function is pickled by reference from its ``__main__``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ci_assert_torch_warmstart_rejoins_warm():
    env = dict(os.environ)
    env.pop("TFOS_COMPILE_CACHE_DIR", None)
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts",
                                      "ci_assert_torch_warmstart.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "warm start OK" in proc.stdout
    reports = next(line for line in proc.stdout.splitlines()
                   if line.startswith("per-node reports:"))
    assert "2: {" in reports and "'step': 'loaded'" in reports
