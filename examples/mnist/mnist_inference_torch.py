"""Clusterless parallel MNIST inference on the PyTorch port (the twin of
``examples/mnist/mnist_inference.py``, reference
``examples/mnist/keras/mnist_inference.py``).

Batch inference needs no cluster: a plain ``mapPartitions`` where each
executor loads the export once and streams its partitions through it.  Each
executor process caches one :class:`~tensorflowonspark_torch.serving.ModelServer`
(the export's ``apply.pt2`` artifact where it carries one, else the model
rebuilt from the registry) and maps its partitions to ``prediction label``
lines.

Run (after mnist_spark_torch.py or mnist_files_torch.py exported a model):
    python examples/mnist/mnist_inference_torch.py \
        --export_dir /tmp/mnist_export --output /tmp/mnist_preds
on the executors' card; ``--device cpu`` runs on the CPU.  Without a card
and without ``--device cpu`` the executors raise.
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

_CACHE = {}  # process-global model cache (reference pred_fn/pred_args globals)


def infer_partition(export_dir, batch_size, device=None):
    """The per-partition inference closure; the export loads once per
    executor process and serves every partition after (reference
    ``mnist_inference.py`` / ``pipeline.py:474-481`` cache pattern)."""

    def _infer(iterator):
        import numpy as np

        from tensorflowonspark_torch import serving

        if "server" not in _CACHE:
            _CACHE["server"] = serving.ModelServer(export_dir, batch_size,
                                                   device=device)
        server = _CACHE["server"]
        (tensor,) = sorted(server.signature) or ["image"]

        rows = list(iterator)
        out = []
        for i in range(0, len(rows), batch_size):
            chunk = np.asarray(rows[i:i + batch_size], np.float32)
            labels = chunk[:, 0].astype(np.int32)
            images = (chunk[:, 1:] / 255.0).reshape(-1, 28, 28, 1)
            logits = server.predict_feed({tensor: images},
                                         len(chunk))["output"]
            preds = logits.argmax(-1)
            out.extend("{} {}".format(int(p), int(l))
                       for p, l in zip(preds, labels))
        return out

    return _infer


def synthetic_test_rows(n, seed=7):
    """The first ``n`` rows ``[label, 784 pixels]`` of the synthetic test
    split of ``mnist_data_setup_torch.synthetic_mnist`` (the JAX script's
    numbers)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from mnist_data_setup_torch import synthetic_mnist

    images, labels = synthetic_mnist("test", seed)
    return [[float(labels[i])] + images[i].astype(float).tolist()
            for i in range(n)]


def csv_partitions(data_dir):
    """One list of (label, pixels...) rows per CSV part file."""
    for path in sorted(glob.glob(os.path.join(data_dir, "part-*.csv"))):
        with open(path) as f:
            yield [[float(v) for v in line.strip().split(",")] for line in f]


def main(argv=None):
    from tensorflowonspark_torch import backend

    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--export_dir", required=True)
    parser.add_argument("--data_dir", default=None,
                        help="CSV dir from mnist_data_setup.py; synthetic "
                             "test split when omitted")
    parser.add_argument("--num_rows", type=int, default=2048,
                        help="synthetic test rows")
    parser.add_argument("--device", default=None,
                        help="'cpu' to serve on the CPU; the executors' "
                             "card by default")
    parser.add_argument("--output", default=None,
                        help="write 'pred label' lines here (stdout summary "
                             "otherwise)")
    args, _ = parser.parse_known_args(argv)

    if args.data_dir:
        parts = list(csv_partitions(args.data_dir))
    else:
        parts = backend.partition(synthetic_test_rows(args.num_rows),
                                  args.cluster_size * 2)

    b = backend.LocalBackend(args.cluster_size)
    try:
        results = b.map_partitions(
            parts, infer_partition(args.export_dir, args.batch_size,
                                   args.device))
    finally:
        b.stop()
    lines = [line for part in results for line in part]
    correct = sum(1 for line in lines
                  if line.split()[0] == line.split()[1])
    print("accuracy: {:.4f} ({}/{})".format(
        correct / len(lines), correct, len(lines)))
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
