"""MNIST via the ML pipeline API on the PyTorch port (the twin of
``examples/mnist/mnist_pipeline.py``).

``TFEstimator.fit`` spins up the cluster, feeds the train rows, exports on
the chief, and returns a ``TFModel`` whose ``transform`` runs cached
per-executor batch inference (reference ``mnist_pipeline.py:124-149``).

CUDA and fork: ``fit`` trains in each node's forked child, where the first
CUDA call is ``ctx.initialize_distributed()``; ``transform`` then serves on
the executors' cards, which initializes CUDA in the executor processes.
That order is the safe one: an executor that initialized CUDA refuses to
host a later node.

Run on the CPU (two nodes, gloo):
    python examples/mnist/mnist_pipeline_torch.py --device cpu --cluster_size 2
On the cards (one per node): leave out ``--device``.  Without a card and
without ``--device cpu`` the nodes raise.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def train_fn(args, ctx):
    import functools

    import numpy as np
    import torch

    from tensorflowonspark_torch import checkpoint
    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.models import mnist as mnist_mod
    from tensorflowonspark_torch.parallel import infeed

    device = ctx.initialize_distributed(device=args.device)
    torch.manual_seed(0)                  # the same init on every node
    model = mnist_mod.build_mnist(dtype="bfloat16")
    trainer = train_mod.Trainer(
        mnist_mod.loss_fn(model), dict(model.state_dict()),
        functools.partial(torch.optim.SGD, lr=args.lr, momentum=0.9),
        compute_dtype=torch.bfloat16, batch_size=args.batch_size,
        device=device)

    def to_batch(cols):
        # dict of columns via input_mapping
        images = np.asarray(cols["image"], np.float32).reshape(-1, 28, 28, 1)
        labels = np.asarray(cols["label"], np.int64)
        return {"image": torch.from_numpy(images),
                "label": torch.from_numpy(labels)}

    feed = ctx.get_data_feed(
        input_mapping={"image": "image", "label": "label"})
    sharded = infeed.ShardedFeed(feed, args.batch_size, transform=to_batch,
                                 device=device)
    trainer.fit_feed(sharded,
                     steps_per_call=getattr(args, "steps_per_call", 1))

    if checkpoint.should_export(ctx):
        checkpoint.export_model(
            args.export_dir, trainer.state.params,
            "mnist_cnn", model_config={"dtype": "bfloat16"},
            input_signature={"image": [None, 28, 28, 1]})


def synthetic_mnist(n, seed):
    """``n`` MNIST-shaped images in [0, 1] and their labels: each class a
    fixed random template, each sample a noisy copy (learnable)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(7).random((10, 784))
    labels = rng.integers(0, 10, (n,))
    noise = rng.uniform(-0.08, 0.08, (n, 784))
    images = np.clip(templates[labels] + noise, 0.0, 1.0).astype(np.float32)
    return images, labels


def main(argv=None):
    import numpy as np

    from tensorflowonspark_torch import backend, pipeline

    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=256,
                        help="global batch size across all nodes")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--num_rows", type=int, default=4096,
                        help="synthetic training rows")
    parser.add_argument("--num_test", type=int, default=512,
                        help="synthetic rows transformed after fit")
    parser.add_argument("--device", default=None,
                        help="'cpu' to train and transform on the CPU; the "
                             "cards by default")
    parser.add_argument("--export_dir",
                        default=os.path.abspath("mnist_pipeline_export"))
    args, _ = parser.parse_known_args(argv)

    images, labels = synthetic_mnist(args.num_rows, seed=0)
    train_rows = [{"image": images[i].tolist(), "label": int(labels[i])}
                  for i in range(args.num_rows)]

    b = backend.LocalBackend(args.cluster_size)
    try:
        est = pipeline.TFEstimator(
            train_fn, {"lr": args.lr, "device": args.device}, b,
            device=args.device, cluster_size=args.cluster_size,
            batch_size=args.batch_size, epochs=args.epochs,
            export_dir=args.export_dir, grace_secs=5,
            input_mapping={"image": "image", "label": "label"})
        model = est.fit(train_rows)

        timages, tlabels = synthetic_mnist(args.num_test, seed=1)
        model.set("input_mapping", {"image": "image"})
        test_rows = [{"image": timages[i].tolist()}
                     for i in range(args.num_test)]
        preds = model.transform(test_rows)
        correct = sum(1 for p, want in zip(preds, tlabels)
                      if int(np.argmax(p)) == int(want))
        print("pipeline accuracy: {:.4f} ({}/{})".format(
            correct / len(preds), correct, len(preds)))
    finally:
        b.stop()
    return correct / len(preds)


if __name__ == "__main__":
    main()
