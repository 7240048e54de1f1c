"""Streaming MNIST training on the PyTorch port (the twin of
``examples/mnist/mnist_streaming.py``; reference
``examples/mnist/estimator/mnist_spark_streaming.py``).

The same InputMode.SPARK lifecycle as ``mnist_spark_torch.py`` (the same
node function; only the feed differs) with an unbounded feed: a generator
of partitions, one a "micro-batch" (the DStream analogue), throttled like
an arriving stream.  Training ends when a STOP reaches the reservation
server, sent by ``examples/utils/stop_streaming_torch.py``, or after
``--max_batches`` micro-batches.

CUDA and fork: as in ``mnist_spark_torch.py``, the first CUDA call is in
the node's forked child.

Run on the CPU, then stop from another shell:
    python examples/mnist/mnist_streaming_torch.py --device cpu \\
        --cluster_size 2
    python examples/utils/stop_streaming_torch.py <host> <port>
On the cards (one per node): leave out ``--device``.
"""

import argparse
import itertools
import os
import sys
import time

EXAMPLE_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(EXAMPLE_DIR, "..", ".."))
sys.path.insert(0, EXAMPLE_DIR)

# the same training fn; the feed differs
from mnist_spark_torch import main_fun  # noqa: E402


def stream_partitions(batch_rows, interval_secs, max_batches, fed=None):
    """Unbounded generator of partitions: one partition per 'micro-batch'
    (the DStream analogue), throttled like an arriving stream.  ``fed``, a
    list when given, gets one entry a micro-batch handed out."""
    from mnist_data_setup_torch import synthetic_mnist

    images, labels = synthetic_mnist("train")
    counter = itertools.count()
    for i in counter:
        if max_batches and i >= max_batches:
            return
        lo = (i * batch_rows) % (len(labels) - batch_rows)
        rows = [[float(labels[j])] + images[j].astype(float).tolist()
                for j in range(lo, lo + batch_rows)]
        if fed is not None:
            fed.append(i)
        yield rows
        time.sleep(interval_secs)


def main(argv=None):
    from tensorflowonspark_torch import backend, cluster

    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--stream_rows", type=int, default=512,
                        help="rows per arriving micro-batch")
    parser.add_argument("--stream_interval", type=float, default=0.1)
    parser.add_argument("--max_batches", type=int, default=None,
                        help="end the stream after N micro-batches "
                             "(unbounded when omitted: stop externally)")
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU; the nodes' cards "
                             "by default")
    args, _ = parser.parse_known_args(argv)

    b = backend.LocalBackend(args.cluster_size)
    try:
        c = cluster.run(b, main_fun, args, num_executors=args.cluster_size,
                        input_mode=cluster.InputMode.SPARK)
        host, port = c.cluster_meta["server_addr"]
        print("streaming; stop with: python "
              "examples/utils/stop_streaming_torch.py {} {}".format(
                  host, port), flush=True)
        fed = []
        c.train(stream_partitions(args.stream_rows, args.stream_interval,
                                  args.max_batches, fed))
        print("stream ended after {} micro-batches".format(len(fed)),
              flush=True)
        c.shutdown(grace_secs=5)
    finally:
        b.stop()


if __name__ == "__main__":
    main()
