"""ResNet-56 / CIFAR-10 distributed training on the PyTorch port (the twin of
``examples/resnet/resnet_cifar.py``; reference ``examples/resnet/``).

The same workload: ResNet-56 (``resnet56_cifar``) with its BatchNorm
running averages as the Trainer's extra state, bf16 compute, SGD with
Nesterov momentum 0.9 over a linear warmup from 0 and a cosine decay (the
JAX example's ``optax.warmup_cosine_decay_schedule``, as device arithmetic
on a step count the optimizer state carries, so a captured step stays
right), L2 weight decay in the loss, the synthetic-data option
(``--use_synthetic_data``, the JAX example's arrays), TFRecords from
``--data_dir`` through the port's ``dfutil``, the host-side random flip,
periodic checkpoints (``--model_dir``), a step-range trace
(``--profile_steps``, ``profiler.StepProfiler``), the chief's export, and
the FILES-mode cluster lifecycle: every node runs ``main_fun`` inline in
its executor and steps its own shard.  Leftover argv rides along in
``args.remaining_argv`` (the reference's passthrough convention).

Where the twin differs: ``--device`` ("cpu" to run on the CPU; the nodes'
cards by default).

Run on the CPU (tiny smoke):
    python examples/resnet/resnet_cifar_torch.py --device cpu \\
        --cluster_size 2 --use_synthetic_data --train_steps 2 \\
        --batch_size 32 --blocks_per_stage 1 --synthetic_examples 64
On a card: leave out ``--device``.
"""

import argparse
import math
import os
import sys

EXAMPLE_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(EXAMPLE_DIR, "..", ".."))
sys.path.insert(0, EXAMPLE_DIR)

HEIGHT, WIDTH, CHANNELS = 32, 32, 3  # reference cifar_preprocessing.py
NUM_CLASSES = 10
NUM_IMAGES = 50000


def synthetic_cifar(n, seed=11):
    """Deterministic learnable stand-in for CIFAR-10 (reference synthetic
    input_fn, ``common.py:315-363``): the JAX example's arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    templates = rng.random((NUM_CLASSES, HEIGHT, WIDTH, CHANNELS)).astype("f")
    labels = rng.integers(0, NUM_CLASSES, (n,))
    noise = rng.normal(0, 0.15, (n, HEIGHT, WIDTH, CHANNELS)).astype("f")
    return (templates[labels] + noise).astype("float32"), labels.astype("int32")


def lr_schedule(args):
    """``(base_lr, warmup_steps, decay_steps, total_steps)`` of the JAX
    example: the base LR scaled by batch size as the reference scales it,
    a warmup of a twentieth of the run (at most 5 epochs), the cosine over
    ``decay_steps - warmup_steps``."""
    steps_per_epoch = max(NUM_IMAGES // args.batch_size, 1)
    total_steps = args.train_steps or steps_per_epoch * args.train_epochs
    base_lr = args.base_lr * args.batch_size / 128.0
    warmup = min(max(total_steps // 20, 1), 5 * steps_per_epoch)
    return base_lr, warmup, max(total_steps, warmup + 1), total_steps


def warmup_cosine_sgd(base_lr, warmup_steps, decay_steps, momentum=0.9):
    """An optimizer factory for ``optax.sgd(warmup_cosine_decay_schedule(0,
    base_lr, warmup_steps, decay_steps), momentum, nesterov=True)``: linear
    from 0 to ``base_lr`` over the warmup, then ``base_lr`` times half a
    cosine period over the remaining ``decay_steps - warmup_steps`` (0 at
    its end and after), Nesterov SGD with a tensor lr
    (``resnet_imagenet_torch.sgd_with_schedule``)."""
    import torch

    from resnet_imagenet_torch import sgd_with_schedule

    cosine_steps = decay_steps - warmup_steps

    def lr_at(count):
        warm = count * (base_lr / warmup_steps)
        t = (count - warmup_steps).clamp(0.0, float(cosine_steps))
        after = base_lr * (0.5 * (1.0 + torch.cos(math.pi * t
                                                  / cosine_steps)))
        return torch.where(count < warmup_steps, warm, after)

    return sgd_with_schedule(lr_at, momentum, nesterov=True)


def load_data(args):
    """``(images, labels)``: the synthetic stand-in, or ``<data_dir>/train``
    TFRecords (``image``: 3072 floats, ``label``)."""
    import numpy as np

    from tensorflowonspark_torch import dfutil

    if args.use_synthetic_data:
        return synthetic_cifar(args.synthetic_examples)
    rows = dfutil.load_tfrecords(os.path.join(args.data_dir, "train"))
    images = np.asarray([r["image"] for r in rows], np.float32)
    images = images.reshape(-1, HEIGHT, WIDTH, CHANNELS)
    labels = np.asarray([r["label"] for r in rows], np.int32)
    return images, labels


def train_cifar(args, ctx):
    """Build and train on this node: returns ``(trainer, stats)``
    (:func:`main_fun` is this less the trainer)."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import checkpoint
    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.models import resnet as resnet_mod

    if EXAMPLE_DIR not in sys.path:   # resnet_imagenet_torch, in an executor
        sys.path.insert(0, EXAMPLE_DIR)
    device = ctx.initialize_distributed(device=args.device)
    rank = ctx.process_id or 0
    world = max(ctx.num_processes or 1, 1)

    images, labels = load_data(args)
    images, labels = images[rank::world], labels[rank::world]

    # blocks_per_stage is the size knob (reference resnet_size): 6n+2
    # layers; 9 -> ResNet-56, 1 -> an 8-layer smoke model.  One seed on
    # every node: the same init everywhere
    model = resnet_mod.build_resnet56(dtype=args.dtype,
                                      blocks_per_stage=args.blocks_per_stage)
    model.init_weights(torch.Generator().manual_seed(0))
    params, batch_stats = resnet_mod.split_state(model)

    base_lr, warmup, decay_steps, total_steps = lr_schedule(args)
    trainer = train_mod.Trainer(
        resnet_mod.loss_fn(model, weight_decay=args.weight_decay),
        params, warmup_cosine_sgd(base_lr, warmup, decay_steps),
        extra_state=batch_stats,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else None,
        batch_size=args.batch_size, log_steps=args.log_steps, device=device)

    ckpt = None
    if args.model_dir:
        ckpt = checkpoint.CheckpointManager(
            ctx.absolute_path(args.model_dir),
            save_interval_steps=args.save_interval, is_chief=ctx.is_chief())

    # --profile_steps "start,stop" traces that range (reference
    # common.py:192-197,293-300)
    prof = None
    if args.profile_steps:
        from tensorflowonspark_torch import profiler

        prof = profiler.StepProfiler(
            args.profile_dir or "profile_logs", args.profile_steps)

    local_bs = args.batch_size // world
    row_mask = np.ones((local_bs,), np.float32)
    rng = np.random.default_rng(rank)
    step = 0
    loss = aux = None
    while step < total_steps:
        order = rng.permutation(len(labels))
        for s in range(len(labels) // local_bs):
            idx = order[s * local_bs:(s + 1) * local_bs]
            x = images[idx]
            if not args.use_synthetic_data or args.augment:
                # random flip (reference cifar_preprocessing.py)
                flip = rng.random(local_bs) < 0.5
                x = x.copy()
                x[flip] = x[flip, :, ::-1]
            if prof:
                prof.on_step_begin()
            loss, aux = trainer.step({"image": x, "label": labels[idx]},
                                     row_mask)
            if prof:
                prof.on_step_end()
            step += 1
            if ckpt:
                ckpt.maybe_save(step, trainer.state)
            if step >= total_steps:
                break

    if prof:
        prof.stop()
    trainer.history.on_train_end(loss)
    stats = trainer.history.log_stats(
        loss=float(loss), accuracy=float(aux["accuracy"]))
    if ckpt:
        ckpt.maybe_save(step, trainer.state, force=True)
        ckpt.wait_until_finished()
        ckpt.close()
    if args.export_dir and checkpoint.should_export(ctx):
        checkpoint.export_model(
            ctx.absolute_path(args.export_dir), trainer.state.params,
            "resnet56_cifar",
            model_config={"dtype": args.dtype,
                          "blocks_per_stage": args.blocks_per_stage},
            input_signature={"image": [None, HEIGHT, WIDTH, CHANNELS]})
    return trainer, stats


def main_fun(args, ctx):
    """The node function: train on this node, return the final stats."""
    return train_cifar(args, ctx)[1]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=128,
                        help="global batch (reference default 128)")
    parser.add_argument("--train_epochs", type=int, default=182,
                        help="reference default 182 epochs")
    parser.add_argument("--train_steps", type=int, default=None,
                        help="overrides train_epochs when set")
    parser.add_argument("--base_lr", type=float, default=0.1)
    parser.add_argument("--blocks_per_stage", type=int, default=9,
                        help="basic blocks per stage: 6n+2 layers (9 = "
                             "ResNet-56; the reference's resnet_size knob)")
    parser.add_argument("--weight_decay", type=float, default=2e-4)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--use_synthetic_data", action="store_true")
    parser.add_argument("--synthetic_examples", type=int, default=2048)
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--data_dir", default=None,
                        help="TFRecord root with train/ (image: 3072 floats)")
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--save_interval", type=int, default=500)
    parser.add_argument("--log_steps", type=int, default=20)
    parser.add_argument("--profile_steps", default=None,
                        help='"start,stop" trace capture range '
                             "(reference --profile_steps)")
    parser.add_argument("--profile_dir", default=None)
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU; the nodes' cards "
                             "by default")
    # parse_known_args: leftover argv rides along inside args for user code
    # (reference passthrough convention, resnet_cifar_spark.py:19-21)
    args, rem = parser.parse_known_args(argv)
    args.remaining_argv = rem
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
