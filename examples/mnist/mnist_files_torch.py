"""MNIST training in InputMode.FILES on the PyTorch port (the twin of
``examples/mnist/mnist_files.py``; reference ``examples/mnist/keras/mnist_tf.py``).

The reference's TENSORFLOW mode: no Spark feeding; every worker reads its
shard of the dataset itself while the cluster machinery provides
rendezvous, lifecycle and failure propagation.  Each node runs
``main_fun`` inline in its executor process and either streams the
TFRecords staged by ``mnist_data_setup.py`` (``<data_dir>/train``) through
``data.FileFeed`` -> ``ShardedFeed`` -> ``Trainer.fit_feed``, or trains on
the synthetic stand-in held in memory.  Checkpoints are periodic
(``CheckpointManager``), and a restarted run resumes from the newest one.

Run on the CPU:
    python examples/mnist/mnist_files_torch.py --device cpu \\
        --cluster_size 2 --epochs 1 --max_steps 20
On the cards (one per node): leave out ``--device``.
"""

import argparse
import os
import sys

EXAMPLE_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(EXAMPLE_DIR, "..", ".."))
sys.path.insert(0, EXAMPLE_DIR)

# the synthetic stand-in of the data-setup twin (its one copy)
from mnist_data_setup_torch import synthetic_mnist  # noqa: E402


def main_fun(args, ctx):
    import numpy as np

    device = ctx.initialize_distributed(device=args.device)
    # Each process reads and shards the dataset itself (FILES mode contract).
    # With a data_dir, shards STREAM through data.FileFeed (reader threads,
    # shuffle buffer, executor-side epochs: the tf.data role); see
    # train_streaming below.
    if args.data_dir:
        return train_streaming(args, ctx, device)
    rank = ctx.process_id or 0
    world = max(ctx.num_processes or 1, 1)
    raw, labels = synthetic_mnist("train")
    images = (raw / 255.0).astype(np.float32).reshape(-1, 28, 28, 1)
    labels = labels.astype(np.int32)
    images, labels = images[rank::world], labels[rank::world]

    trainer, ckpt = build_trainer(args, ctx, device)

    local_bs = args.batch_size // world
    steps_per_epoch = len(labels) // local_bs
    step_count = int(trainer.state.step)
    mask = np.ones((local_bs,), np.float32)
    rng = np.random.default_rng(rank)
    loss = None
    for _ in range(args.epochs):
        order = rng.permutation(len(labels))
        for s in range(steps_per_epoch):
            idx = order[s * local_bs:(s + 1) * local_bs]
            loss, _ = trainer.step({"image": images[idx],
                                    "label": labels[idx]}, mask)
            step_count += 1
            if ckpt:
                ckpt.maybe_save(step_count, trainer.state)
            if args.max_steps and step_count >= args.max_steps:
                break
        if args.max_steps and step_count >= args.max_steps:
            break

    trainer.history.on_train_end(loss)
    stats = trainer.history.log_stats(loss=float(loss))
    _finish(args, ctx, trainer, ckpt, step_count)
    return stats


def build_trainer(args, ctx, device, init_params=None):
    """Model + Trainer + optional CheckpointManager with restore-on-restart
    (shared by the in-memory and streaming paths).  ``init_params``: a
    ``state_dict`` to start from (e.g. a converted flax init); by default
    the model's init from seed 0, the same on every node."""
    import functools

    import torch

    from tensorflowonspark_torch import checkpoint
    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.models import mnist as mnist_mod

    torch.manual_seed(0)
    model = mnist_mod.build_mnist(dtype="bfloat16")
    if init_params is None:
        init_params = dict(model.state_dict())
    trainer = train_mod.Trainer(
        mnist_mod.loss_fn(model), init_params,
        functools.partial(torch.optim.SGD, lr=args.lr, momentum=0.9),
        compute_dtype=torch.bfloat16, batch_size=args.batch_size,
        device=device)

    ckpt = None
    if args.model_dir:
        ckpt = checkpoint.CheckpointManager(
            ctx.absolute_path(args.model_dir),
            save_interval_steps=args.save_interval, is_chief=ctx.is_chief())
        trainer.restore_latest(ckpt)
    return trainer, ckpt


def _finish(args, ctx, trainer, ckpt, step_count):
    from tensorflowonspark_torch import checkpoint

    if ckpt:
        ckpt.maybe_save(step_count, trainer.state, force=True)
        ckpt.wait_until_finished()
        ckpt.close()
    if args.export_dir and checkpoint.should_export(ctx):
        checkpoint.export_model(
            ctx.absolute_path(args.export_dir), trainer.state.params,
            "mnist_cnn", model_config={"dtype": "bfloat16"},
            input_signature={"image": [None, 28, 28, 1]})


def train_streaming(args, ctx, device, init_params=None):
    """data.FileFeed -> ShardedFeed -> Trainer.fit_feed: TFRecord shards
    stream through reader threads, a shuffle buffer and executor-side
    epochs (the tf.data role, reference ``mnist_tf.py:23-27``) with the same
    device plane as SPARK mode (prefetch, consensus, K-step groups)."""
    import numpy as np

    from tensorflowonspark_torch import data as data_mod
    from tensorflowonspark_torch.datafeed import strip_scheme
    from tensorflowonspark_torch.parallel import infeed

    trainer, ckpt = build_trainer(args, ctx, device, init_params)
    root = strip_scheme(ctx.absolute_path(args.data_dir))
    feed = data_mod.FileFeed(
        data_mod.list_shards(os.path.join(root, "train")),
        shuffle_buffer=args.shuffle_buffer, num_epochs=args.epochs,
        seed=ctx.process_id or 0)

    def transform(cols):
        return {
            "image": np.asarray(cols["image"],
                                np.float32).reshape(-1, 28, 28, 1),
            "label": np.asarray(cols["label"], np.int32),
        }

    sharded = infeed.ShardedFeed(feed, args.batch_size, transform=transform,
                                 device=device)
    # Periodic checkpointing rides the per-dispatch hook (save_interval is
    # enforced by the manager; off-interval calls are free no-ops).
    on_steps = ((lambda s: ckpt.maybe_save(s, trainer.state)) if ckpt
                else None)
    stats = trainer.fit_feed(sharded, max_steps=args.max_steps,
                             steps_per_call=args.steps_per_call,
                             on_steps=on_steps)
    _finish(args, ctx, trainer, ckpt, int(trainer.state.step))
    return stats


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="train steps per dispatch (streaming path; on "
                             "the cards, replays of one captured CUDA graph)")
    parser.add_argument("--shuffle_buffer", type=int, default=4096,
                        help="FileFeed shuffle reservoir (streaming path)")
    parser.add_argument("--save_interval", type=int, default=100)
    parser.add_argument("--data_dir", default=None,
                        help="TFRecord root from mnist_data_setup.py "
                             "(expects <data_dir>/train); synthetic if omitted")
    parser.add_argument("--model_dir", default=None,
                        help="checkpoint dir (shared storage on multi-host)")
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU; the nodes' cards "
                             "by default")
    args, _ = parser.parse_known_args(argv)
    return args


def main(argv=None):
    from tensorflowonspark_torch import backend, cluster

    args = parse_args(argv)
    b = backend.LocalBackend(args.cluster_size)
    try:
        c = cluster.run(b, main_fun, args, num_executors=args.cluster_size,
                        input_mode=cluster.InputMode.FILES)
        c.shutdown(grace_secs=2)
    finally:
        b.stop()


if __name__ == "__main__":
    main()
