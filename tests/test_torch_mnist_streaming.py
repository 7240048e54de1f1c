"""The streaming MNIST twin (``examples/mnist/mnist_streaming_torch.py``,
the twin of ``examples/mnist/mnist_streaming.py``) and the STOP twin
(``examples/utils/stop_streaming_torch.py``) on the CPU, two SPARK-mode
nodes over gloo:

- bounded by ``--max_batches`` at the JAX example test's flags
  (``tests/test_examples.py::test_mnist_streaming_bounded``), with
  ``--max_steps`` below what the stream holds, so the nodes end their
  feeds (and the chief exports) while micro-batches still arrive: the
  export does not race SPARK mode's fixed shutdown grace on a loaded
  host.  A node that ends its feed while a partition is being fed to it
  asks the driver to STOP the stream (the reference's early stop), so
  the stream hands out at most its 4 micro-batches.  The stream feeds a
  partition to one node at a time, so the feed's prefetch stays on
  (``TFOS_INFEED_PREFETCH=0``, the guard of ``tests/test_torch_cluster.py``'s
  MNIST runs, would leave the other node without rows to step with);
- unbounded, ended by ``stop_streaming_torch.py`` sent to the driver's
  reservation server: no ``--max_steps`` (the nodes' own early stop would
  race the external one) and no export to wait for.
"""

import os
import subprocess
import sys
import time

from tensorflowonspark_torch import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN = os.path.join(REPO, "examples", "mnist", "mnist_streaming_torch.py")
STOP = os.path.join(REPO, "examples", "utils", "stop_streaming_torch.py")
# the JAX example test's flags and the device
FLAGS = ["--device", "cpu", "--cluster_size", "2", "--stream_interval",
         "0.02"]
STREAM_SECS = 3.0


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1")


def _micro_batches(out):
    """N of the twin's "stream ended after N micro-batches" line."""
    for line in out.splitlines():
        if line.startswith("stream ended after "):
            return int(line.split()[3])
    raise AssertionError("no end-of-stream line in {!r}".format(out))


def test_bounded_stream_trains_and_exports(tmp_path):
    """4 micro-batches of 512 rows hold 8 steps of 256; the nodes stop at
    2, exit 0, and the chief's export loads."""
    export = str(tmp_path / "export")
    proc = subprocess.run(
        [sys.executable, TWIN, "--max_batches", "4", "--max_steps", "2",
         "--export_dir", export] + FLAGS,
        capture_output=True, text=True, timeout=240, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 1 <= _micro_batches(proc.stdout) <= 4
    _, descriptor = checkpoint.load_model(export, validate=True)
    assert descriptor["model_name"] == "mnist_cnn"


def test_stop_streaming_ends_an_unbounded_stream(tmp_path):
    """No ``--max_batches``: the stream runs until ``stop_streaming_torch.py``
    sends STOP to the address the twin prints (here once the stream has
    run for STREAM_SECS), then the cluster shuts down and exits 0."""
    with open(tmp_path / "stderr.log", "w") as err:
        proc = subprocess.Popen([sys.executable, TWIN] + FLAGS,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True, env=_env())
        try:
            line = proc.stdout.readline()
            assert "stop_streaming_torch.py" in line, line
            host, port = line.split()[-2:]
            time.sleep(STREAM_SECS)
            assert proc.poll() is None, "the stream ended by itself"
            stop = subprocess.run([sys.executable, STOP, host, port],
                                  capture_output=True, text=True,
                                  timeout=60, env=_env())
            assert stop.returncode == 0, stop.stderr[-2000:]
            assert "STOP sent to {}:{}".format(host, port) in stop.stdout
            out, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, open(tmp_path / "stderr.log").read()[-3000:]
    assert _micro_batches(out) >= 1


def test_stop_streaming_usage():
    """Without a host and a port the STOP twin prints its usage and exits
    2, as the JAX script does."""
    proc = subprocess.run([sys.executable, STOP], capture_output=True,
                          text=True, timeout=60, env=_env())
    assert proc.returncode == 2
    assert "Usage" in proc.stdout
