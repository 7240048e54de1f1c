"""ResNet-50 v1.5 / ImageNet distributed training on the PyTorch port (the
twin of ``examples/resnet/resnet_imagenet.py``; reference
``examples/resnet/resnet_imagenet_main.py``).

The same workload: ResNet-50 with the ImageNet scale constants (1,281,167
train images, 90 epochs, batch 256), piecewise LR decay after a linear
warmup from 0 (the JAX example's ``optax.join_schedules``), label smoothing
and L2 weight decay added to the loss, SGD with momentum 0.9, the
synthetic-data mode, periodic checkpoints of params, optimizer state AND
the BatchNorm running averages (the Trainer's extra state), the exact
validation top-1, the chief's export, and the FILES-mode cluster
lifecycle: every node runs ``main_fun`` inline in its executor process and
reads its own file shard (``data.FileFeed`` -> ``ShardedFeed`` ->
``Trainer.fit_feed``).  With ``--predecoded`` the stored uint8 rows ship
untouched and the crop and flip run on the card inside the loss
(``ops.augment.crop_and_flip``), then the channel means
(``imagenet_input_torch.normalize_on_device``).

CUDA in FILES mode: the node runs ``main_fun`` in the executor process
itself, so CUDA comes up there (``ctx.initialize_distributed``) after the
node forked its manager; nothing forks from it afterwards (the decode pool
of ``--decode_procs`` spawns).

Where the twin differs: ``--device`` ("cpu" to run on the CPU; the nodes'
cards by default); ``--eval_data_dir`` with ``--predecoded`` reads
predecoded ``validation-*.raw`` shards (center crop on the host), since a
host without PIL or OpenCV cannot decode the JPEG validation shards the
JAX example reads; ``--profile_steps start,stop`` writes a gzipped Chrome
trace (``*.pt.trace.json.gz``) of those steps into ``--profile_dir``
(``profiler.StepProfiler``, on ``torch.profiler``).  The export carries the
params alone, as the JAX example's does: the running averages stay in the
checkpoints.

Run on the CPU (tiny smoke):
    python examples/resnet/resnet_imagenet_torch.py --device cpu \\
        --cluster_size 1 --use_synthetic_data --train_steps 2 \\
        --batch_size 8 --image_size 32 --blocks_per_stage 1 --stem s2d
On a card: leave out ``--device``.
"""

import argparse
import os
import sys

EXAMPLE_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(EXAMPLE_DIR, "..", ".."))
sys.path.insert(0, EXAMPLE_DIR)

NUM_CLASSES = 1001      # reference uses 1001 (background class), resnet_model
NUM_IMAGES = 1281167    # reference imagenet_preprocessing.py:46-49
DEFAULT_IMAGE_SIZE = 224

# Reference LR schedule: 0.1 * batch/256 base, x0.1 at epochs 30, 60, 80,
# 5-epoch linear warmup (resnet_imagenet_main.py:37-71).
LR_BOUNDARY_EPOCHS = (30, 60, 80)
LR_DECAY = 0.1
WARMUP_EPOCHS = 5


def synthetic_imagenet(n, image_size, seed=13):
    """Learnable synthetic stand-in (reference synthetic input_fn,
    ``common.py:315-363``): class templates + noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    few_classes = min(NUM_CLASSES, 32)  # keep the template table small
    templates = rng.random((few_classes, image_size, image_size, 3)).astype("f")
    labels = rng.integers(0, few_classes, (n,))
    noise = rng.normal(0, 0.1, (n, image_size, image_size, 3)).astype("f")
    return (templates[labels] + noise).astype("float32"), labels.astype("int32")


def lr_schedule(args):
    """``(base_lr, warmup_steps, boundaries, total_steps)`` of the JAX
    example's schedule: linear warmup from 0 to ``base_lr`` over
    ``warmup_steps``, then ``base_lr`` times ``LR_DECAY`` for every boundary
    passed.  The boundaries count from the END of the warmup, as
    ``optax.join_schedules`` hands the later schedule ``step - warmup``."""
    steps_per_epoch = max(NUM_IMAGES // args.batch_size, 1)
    total_steps = args.train_steps or steps_per_epoch * args.train_epochs
    base_lr = args.base_lr * args.batch_size / 256.0
    warmup_steps = min(WARMUP_EPOCHS * steps_per_epoch,
                       max(total_steps // 10, 1))
    boundaries = [e * steps_per_epoch for e in LR_BOUNDARY_EPOCHS
                  if e * steps_per_epoch < total_steps]
    return base_lr, warmup_steps, boundaries, total_steps


def scheduled_sgd(base_lr, warmup_steps, boundaries, momentum=0.9):
    """An optimizer factory for ``optax.sgd(schedule, momentum)`` of the
    JAX example's schedule (:func:`sgd_with_schedule`)."""
    import torch

    def lr_at(count):
        warm = count * (base_lr / warmup_steps)
        after = torch.full_like(count, base_lr)
        for b in boundaries:
            after = torch.where(count - warmup_steps >= b, after * LR_DECAY,
                                after)
        return torch.where(count < warmup_steps, warm, after)

    return sgd_with_schedule(lr_at, momentum)


def sgd_with_schedule(lr_at, momentum=0.9, nesterov=False):
    """An optimizer factory for ``optax.sgd(schedule, momentum, nesterov)``:
    ``torch.optim.SGD`` (dampening 0) whose ``lr`` is a tensor on the
    params' device, set to ``lr_at(count)`` before every step from a step
    count kept on the device (in the optimizer state, so checkpoints carry
    it).  ``lr_at`` is device arithmetic on that fp32 count, so a CUDA graph
    that captures the step advances the schedule on every replay; on a card
    the update is the fused SGD, which reads the tensor lr in place."""
    import torch

    def factory(params):
        device = params[0].device
        opt = torch.optim.SGD(params, lr=torch.zeros((), device=device),
                              momentum=momentum, nesterov=nesterov,
                              fused=True if device.type == "cuda" else None)

        def set_lr(optimizer, args, kwargs):
            state = optimizer.state[params[0]]
            count = state.get("schedule_step")
            if count is None:
                count = state["schedule_step"] = torch.zeros((),
                                                             device=device)
            optimizer.param_groups[0]["lr"].copy_(lr_at(count))
            count.add_(1.0)

        opt.register_step_pre_hook(set_lr)
        return opt

    return factory


def train_resnet(args, ctx):
    """Build and train on this node: returns ``(trainer, stats)``
    (:func:`main_fun` is this less the trainer)."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import checkpoint
    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.models import resnet as resnet_mod

    if EXAMPLE_DIR not in sys.path:   # imagenet_input_torch, in an executor
        sys.path.insert(0, EXAMPLE_DIR)
    device = ctx.initialize_distributed(device=args.device)
    rank = ctx.process_id or 0
    world = max(ctx.num_processes or 1, 1)
    size = args.image_size

    if not args.data_dir:
        images, labels = synthetic_imagenet(args.synthetic_examples, size)
        images, labels = images[rank::world], labels[rank::world]

    # blocks_per_stage is the size knob (the reference's resnet_size):
    # None -> ResNet-50's [3,4,6,3]; 1 -> a 14-layer smoke model.  One seed
    # on every node: the same init everywhere
    model = resnet_mod.build_resnet50(num_classes=NUM_CLASSES,
                                      dtype=args.dtype,
                                      blocks_per_stage=args.blocks_per_stage,
                                      stem=args.stem)
    model.init_weights(torch.Generator().manual_seed(0))
    params, batch_stats = resnet_mod.split_state(model)

    base_lr, warmup_steps, boundaries, total_steps = lr_schedule(args)
    optimizer = scheduled_sgd(base_lr, warmup_steps, boundaries,
                              momentum=0.9)

    base_loss = resnet_mod.loss_fn(model, weight_decay=args.weight_decay,
                                   label_smoothing=args.label_smoothing)
    in_dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.data_dir:
        # TFRecord rows arrive uint8 (1 byte/pixel over the host->device
        # link); the channel-mean normalization happens HERE, inside the
        # step.  Pre-decoded rows also carry their sampled crop/flip ints:
        # the crop itself runs on the card too (ops.augment.crop_and_flip).
        import imagenet_input_torch as imagenet_input

        from tensorflowonspark_torch.ops import augment

        def loss(p, bs, batch, mask):
            batch = dict(batch)
            img = batch.pop("image")
            if args.predecoded:
                img = augment.crop_and_flip(
                    img, batch.pop("cropx"), batch.pop("cropy"),
                    batch.pop("flip"), size)
            batch["image"] = imagenet_input.normalize_on_device(
                img, in_dtype)
            return base_loss(p, bs, batch, mask)
    else:
        loss = base_loss

    writer = None
    if args.log_dir and ctx.is_chief():
        from tensorflowonspark_torch import summary

        writer = summary.SummaryWriter(args.log_dir)

    trainer = train_mod.Trainer(
        loss, params, optimizer, extra_state=batch_stats,
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else None,
        batch_size=args.batch_size, log_steps=args.log_steps,
        summary_writer=writer, device=device)

    ckpt = None
    if args.model_dir:
        ckpt = checkpoint.CheckpointManager(
            ctx.absolute_path(args.model_dir),
            save_interval_steps=args.save_interval, is_chief=ctx.is_chief())

    prof = None
    if args.profile_steps:
        from tensorflowonspark_torch import profiler

        prof = profiler.StepProfiler(
            args.profile_dir or "profile_logs", args.profile_steps)

    if args.data_dir:
        # ImageNet TFRecord shards: stream through data.FileFeed with the
        # reference's preprocessing (imagenet_input_torch) and the same
        # device plane as SPARK mode (prefetch, consensus, K-step groups).
        from tensorflowonspark_torch import data as data_mod
        from tensorflowonspark_torch.datafeed import strip_scheme
        from tensorflowonspark_torch.parallel import infeed

        if args.predecoded:
            reader = imagenet_input.predecoded_reader(
                train=True, image_size=size, store_px=args.store_px,
                seed=rank, device_crop=True)
            pattern = "train-*.raw"
        else:
            reader = imagenet_input.imagenet_reader(
                train=True, image_size=size, seed=rank)
            pattern = "train-*"
        files = data_mod.list_shards(
            strip_scheme(ctx.absolute_path(args.data_dir)), pattern=pattern)
        if args.decode_procs:
            # decode is CPU-bound: scale it across cores with spawned worker
            # processes (the tf.data num_parallel_calls role)
            feed = data_mod.ProcessPoolFeed(
                files, row_reader=reader,
                shuffle_buffer=args.shuffle_buffer,
                num_epochs=args.train_epochs, num_procs=args.decode_procs)
        else:
            feed = data_mod.FileFeed(
                files, row_reader=reader,
                shuffle_buffer=args.shuffle_buffer,
                num_epochs=args.train_epochs,
                reader_threads=args.reader_threads,
                # decoded 224px uint8 rows are ~147 KB: bound the reader
                # queue (blocks of FileFeed.BLOCK rows)
                queue_size=8)
        sharded = infeed.ShardedFeed(
            feed, args.batch_size,
            # generic passthrough: the predecoded path adds cropx/cropy/flip
            # int columns next to image/label
            transform=lambda cols: {
                k: np.asarray(v, np.int32 if k != "image" else None)
                for k, v in cols.items()},
            device=device)

        def on_steps(s):
            if ckpt:
                ckpt.maybe_save(s, trainer.state)
            if prof:
                # dispatch granularity: a K-step group counts as one hop
                prof.on_step_end()
                prof.on_step_begin()

        if prof:
            prof.on_step_begin()
        stats = trainer.fit_feed(sharded, max_steps=total_steps,
                                 steps_per_call=args.steps_per_call,
                                 on_steps=on_steps)
        if prof:
            prof.stop()
        _maybe_eval(args, ctx, model, trainer, size, in_dtype, stats)
        _finish(args, ctx, trainer, ckpt, int(trainer.state.step), size)
        return trainer, stats

    local_bs = args.batch_size // world
    rng = np.random.default_rng(rank)
    mask_np = np.ones((local_bs,), np.float32)
    step = 0
    loss_v = aux = None
    while step < total_steps:
        order = rng.permutation(len(labels))
        for s in range(max(len(labels) // local_bs, 1)):
            idx = order[s * local_bs:(s + 1) * local_bs]
            if len(idx) < local_bs:
                break
            batch = {"image": images[idx], "label": labels[idx]}
            if prof:
                prof.on_step_begin()
            loss_v, aux = trainer.step(batch, mask_np)
            if prof:
                prof.on_step_end()
            step += 1
            if ckpt:
                ckpt.maybe_save(step, trainer.state)
            if step >= total_steps:
                break

    if prof:
        prof.stop()
    trainer.history.on_train_end(loss_v)
    stats = trainer.history.log_stats(
        loss=float(loss_v), accuracy=float(aux["accuracy"]))
    _maybe_eval(args, ctx, model, trainer, size, in_dtype, stats)
    _finish(args, ctx, trainer, ckpt, step, size)
    return trainer, stats


def main_fun(args, ctx):
    """The node function: train on this node, return the final stats."""
    return train_resnet(args, ctx)[1]


def _maybe_eval(args, ctx, model, trainer, size, in_dtype, stats):
    """Run the exact validation top-1 when --eval_data_dir is set (from
    both the synthetic and the TFRecord train paths)."""
    if args.eval_data_dir:
        acc, rows = _evaluate(args, ctx, model, trainer, size, in_dtype)
        stats["eval_accuracy_top_1"] = acc
        stats["eval_rows"] = rows
        print("eval accuracy: {:.4f}".format(acc))
        print("eval rows: {}".format(rows))
        if trainer.summary_writer is not None:
            trainer.summary_writer.add_scalar(
                "eval_accuracy_top_1", acc, int(trainer.state.step))


def _evaluate(args, ctx, model, trainer, size, in_dtype):
    """Top-1 over the validation shards (reference ``eval_input_fn`` +
    ``accuracy_top_1``): each process reads its file shard with the eval
    transform (resize + center crop; BatchNorm running averages), and the
    metric's sums are all-reduced over the processes, so every process
    returns the global figure (as the JAX example's global-batch sums).
    Returns ``(top-1, rows evaluated)``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import imagenet_input_torch as imagenet_input

    from tensorflowonspark_torch import data as data_mod
    from tensorflowonspark_torch.datafeed import strip_scheme
    from tensorflowonspark_torch.parallel import infeed

    if args.predecoded:
        reader = imagenet_input.predecoded_reader(
            train=False, image_size=size, store_px=args.store_px)
        pattern = "validation-*.raw"
    else:
        reader = imagenet_input.imagenet_reader(train=False, image_size=size)
        pattern = "validation-*"
    feed = data_mod.FileFeed(
        data_mod.list_shards(
            strip_scheme(ctx.absolute_path(args.eval_data_dir)),
            pattern=pattern),
        row_reader=reader, reader_threads=args.reader_threads, queue_size=8)
    sharded = infeed.ShardedFeed(
        feed, args.batch_size,
        transform=lambda cols: {
            "image": np.asarray(cols["image"]),
            "label": np.asarray(cols["label"], np.int32)},
        device=trainer.device)
    distributed = dist.is_initialized() and dist.get_world_size() > 1
    rows = []     # each batch's global valid rows, device scalars

    def metric_fn(params, batch_stats, batch, mask):
        logits = torch.func.functional_call(
            model, {**params, **batch_stats},
            (imagenet_input.normalize_on_device(batch["image"], in_dtype),))
        sums = torch.stack([
            ((logits.argmax(-1) == batch["label"].long()) * mask).sum(),
            mask.sum()])
        if distributed:
            dist.all_reduce(sums)
        rows.append(sums[1])
        return {"accuracy": sums[0]}, sums[1]

    # Trainer.evaluate: drain="all" exact evaluation (exhausted processes
    # step zero-mask dummies, no validation row dropped)
    acc = trainer.evaluate(sharded, metric_fn)["accuracy"]
    return acc, int(torch.stack(rows).sum().item())


def _finish(args, ctx, trainer, ckpt, step, size):
    """Final checkpoint + chief-only export (shared by the synthetic and
    TFRecord-streaming paths)."""
    from tensorflowonspark_torch import checkpoint

    if trainer.summary_writer is not None:
        trainer.summary_writer.close()
    if ckpt:
        ckpt.maybe_save(step, trainer.state, force=True)
        ckpt.wait_until_finished()
        ckpt.close()
    if args.export_dir and checkpoint.should_export(ctx):
        checkpoint.export_model(
            ctx.absolute_path(args.export_dir), trainer.state.params,
            "resnet50",
            model_config={"num_classes": NUM_CLASSES, "dtype": args.dtype,
                          "blocks_per_stage": args.blocks_per_stage,
                          "stem": args.stem},
            input_signature={"image": [None, size, size, 3]})


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=256,
                        help="global batch (reference default 256)")
    parser.add_argument("--train_epochs", type=int, default=90,
                        help="reference default 90 epochs")
    parser.add_argument("--train_steps", type=int, default=None,
                        help="overrides train_epochs when set")
    parser.add_argument("--image_size", type=int, default=DEFAULT_IMAGE_SIZE)
    parser.add_argument("--blocks_per_stage", type=int, default=None,
                        help="bottleneck blocks per stage (None = ResNet-50's "
                             "[3,4,6,3]; the reference's resnet_size knob)")
    parser.add_argument("--base_lr", type=float, default=0.1)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--label_smoothing", type=float, default=0.1,
                        help="reference resnet_imagenet_main.py:98-100")
    parser.add_argument("--stem", default="conv7", choices=["conv7", "s2d"],
                        help="s2d = space-to-depth stem (same math; "
                             "models/resnet.py)")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--use_synthetic_data", action="store_true")
    parser.add_argument("--synthetic_examples", type=int, default=1024)
    parser.add_argument("--data_dir", default=None,
                        help="ImageNet TFRecord shard dir (train-*): "
                             "streams via data.FileFeed + imagenet_input; "
                             "synthetic data when omitted")
    parser.add_argument("--eval_data_dir", default=None,
                        help="validation-* shard dir: exact top-1 after "
                             "training (drain='all', center-crop eval)")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="train steps per dispatch (data_dir path; on a "
                             "card, replays of one captured CUDA graph)")
    parser.add_argument("--shuffle_buffer", type=int, default=10000)
    parser.add_argument("--reader_threads", type=int, default=4)
    parser.add_argument("--decode_procs", type=int, default=0,
                        help="JPEG-decode worker PROCESSES for the train "
                        "feed (0 = in-process reader threads); decode is "
                        "CPU-bound, so size this to the host's spare cores")
    parser.add_argument("--predecoded", action="store_true",
                        help="data_dir holds predecode_imagenet.py output "
                        "(fixed-size uint8 rows, *.raw): decode-free hot "
                        "path, crop/flip on the card (ops.augment)")
    parser.add_argument("--store_px", type=int, default=256,
                        help="stored row size of the predecoded shards")
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--save_interval", type=int, default=1000)
    parser.add_argument("--log_steps", type=int, default=20)
    parser.add_argument("--log_dir", default=None,
                        help="TensorBoard event dir (chief writes loss/"
                             "throughput/MFU curves + eval accuracy)")
    parser.add_argument("--profile_steps", default=None,
                        help="'start,stop': trace these steps into "
                             "--profile_dir")
    parser.add_argument("--profile_dir", default=None)
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU; the nodes' cards "
                             "by default")
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
