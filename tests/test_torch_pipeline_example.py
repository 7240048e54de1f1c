"""The port's MNIST pipeline example (``examples/mnist/mnist_pipeline_torch.py``,
the twin of ``examples/mnist/mnist_pipeline.py``) at its small settings on
the CPU: ``TFEstimator.fit`` on two nodes, the chief's export, then
``TFModel.transform`` on the executors, better than chance."""

import os
import re
import subprocess
import sys

from tensorflowonspark_torch import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mnist_pipeline_example_on_the_cpu(tmp_path):
    export = str(tmp_path / "export")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "mnist",
                                      "mnist_pipeline_torch.py"),
         "--device", "cpu", "--cluster_size", "2", "--num_rows", "512",
         "--batch_size", "64", "--epochs", "2", "--lr", "0.05",
         "--num_test", "64", "--export_dir", export],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    found = re.search(r"pipeline accuracy: ([0-9.]+) \((\d+)/64\)",
                      proc.stdout)
    assert found, proc.stdout[-2000:]
    # ten classes: chance is 0.1; 16 SGD steps of the CNN reach about 0.5
    assert float(found.group(1)) > 0.2
    state, descriptor = checkpoint.load_model(export, validate=True)
    assert descriptor["model_name"] == "mnist_cnn"
    assert descriptor["model_config"] == {"dtype": "bfloat16"}
