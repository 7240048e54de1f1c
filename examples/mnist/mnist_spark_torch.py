"""MNIST training with Spark-pushed data on the PyTorch port (the twin of
``examples/mnist/mnist_spark.py``).

The same InputMode.SPARK lifecycle: the driver's ``cluster.run`` starts one
node per executor, ``TPUCluster.train`` pushes the partitions through each
node's queues, and every node trains in a forked child: DataFeed ->
ShardedFeed (columnar local batches, pinned copies to the card on a side
stream, end-of-data consensus) -> Trainer (gradients all-reduced across
the nodes over NCCL) -> the chief exports the model.

CUDA and fork: nothing on the driver or in the executor shells may
initialize CUDA; the first CUDA call is ``ctx.initialize_distributed()``
in ``main_fun``, in the node's child.

Run on the CPU (two nodes, gloo):
    python examples/mnist/mnist_spark_torch.py --device cpu --cluster_size 2
On the cards (one per node): leave out ``--device``.  Without a card and
without ``--device cpu`` the nodes raise.  ``--steps_per_call K`` trains K
steps a dispatch (on the cards: replays of a captured CUDA graph);
``--log_dir DIR`` has the chief write TensorBoard curves there, and
``--tensorboard`` launches TensorBoard on it.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main_fun(args, ctx):
    import functools

    import numpy as np
    import torch

    from tensorflowonspark_torch import checkpoint, summary
    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.models import mnist as mnist_mod
    from tensorflowonspark_torch.parallel import infeed

    device = ctx.initialize_distributed(device=args.device)
    # chief-only TensorBoard curves (loss, throughput, MFU per window)
    writer = None
    if getattr(args, "log_dir", None) and ctx.is_chief():
        writer = summary.SummaryWriter(args.log_dir)
    torch.manual_seed(0)                  # the same init on every node
    model = mnist_mod.build_mnist(dtype="bfloat16")
    trainer = train_mod.Trainer(
        mnist_mod.loss_fn(model), dict(model.state_dict()),
        functools.partial(torch.optim.SGD, lr=args.lr, momentum=0.9),
        compute_dtype=torch.bfloat16, batch_size=args.batch_size,
        summary_writer=writer, device=device)

    def preprocess(items):
        # CSV-style rows: (label, 784 pixels)
        rows = np.asarray(items, np.float32)
        labels = rows[:, 0].astype(np.int64)
        images = rows[:, 1:] / 255.0
        return {"image": images.reshape(-1, 28, 28, 1), "label": labels}

    feed = ctx.get_data_feed(train_mode=True)
    sharded = infeed.ShardedFeed(feed, args.batch_size, preprocess=preprocess,
                                 device=device)
    try:
        stats = trainer.fit_feed(
            sharded, max_steps=args.max_steps,
            steps_per_call=getattr(args, "steps_per_call", 1))
    finally:
        if writer is not None:
            writer.close()  # keep the curves even when training fails

    if args.export_dir and checkpoint.should_export(ctx):
        checkpoint.export_model(
            ctx.absolute_path(args.export_dir), trainer.state.params,
            "mnist_cnn", model_config={"dtype": "bfloat16"},
            input_signature={"image": [None, 28, 28, 1]})
    return stats


def synthetic_rows(n, seed=7):
    """``n`` MNIST-shaped rows ``[label, 784 pixels]``: each class a fixed
    random template, each sample a noisy copy (learnable, so the loss
    falls)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    templates = (rng.random((10, 784)) * 255).astype(np.int16)
    labels = rng.integers(0, 10, (n,))
    noise = rng.integers(-20, 21, (n, 784), np.int16)
    images = np.clip(templates[labels] + noise, 0, 255)
    return [[float(labels[i])] + images[i].astype(float).tolist()
            for i in range(n)]


def main(argv=None):
    from tensorflowonspark_torch import backend, cluster

    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=256,
                        help="global batch size across all nodes")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="train steps per dispatch (on the cards, "
                             "replays of one captured CUDA graph)")
    parser.add_argument("--num_rows", type=int, default=4096,
                        help="synthetic training rows")
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU; the nodes' cards "
                             "by default")
    parser.add_argument("--export_dir", default="mnist_export")
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--log_dir", default=None,
                        help="TensorBoard event dir: the chief writes loss/"
                             "throughput/MFU curves (summary.SummaryWriter)")
    args, _ = parser.parse_known_args(argv)

    b = backend.LocalBackend(args.cluster_size)
    try:
        c = cluster.run(b, main_fun, args, num_executors=args.cluster_size,
                        input_mode=cluster.InputMode.SPARK,
                        tensorboard=args.tensorboard, log_dir=args.log_dir)
        parts = backend.partition(synthetic_rows(args.num_rows),
                                  args.cluster_size * 4)
        c.train(parts, num_epochs=args.epochs)
        c.shutdown(grace_secs=5)
    finally:
        b.stop()


if __name__ == "__main__":
    main()
