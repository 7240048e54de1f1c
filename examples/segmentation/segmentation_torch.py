"""U-Net image segmentation on the PyTorch port (the twin of
``examples/segmentation/segmentation.py``; reference
``examples/segmentation/segmentation_spark.py``).

The same workload and lifecycle: the U-Net
(:mod:`tensorflowonspark_torch.models.unet`) trained on the synthetic
shape-mask stand-in for oxford_iiit_pet (the same arrays as the JAX
example: the same generator and seed), Adam, bf16 compute, in a FILES-mode
cluster where every node runs ``main_fun`` inline in its executor process,
takes its strided shard of the examples and steps its own shuffles; the
chief exports after training (``checkpoint.should_export``) with the JAX
example's descriptor (``"unet"``, ``{"num_classes", "dtype"}``, the
``image`` input signature).  A server rebuilds the export's encoder widths
from the params' shapes (the registry's ``widths``).

CUDA in FILES mode: CUDA comes up in the executor process itself
(``ctx.initialize_distributed``), after the node forked its manager.

Where the twin differs: ``--device`` ("cpu" to run on the CPU; the nodes'
cards by default).

Run on the CPU (tiny smoke):
    python examples/segmentation/segmentation_torch.py --device cpu \\
        --cluster_size 2 --train_steps 2 --batch_size 16 --image_size 32 \\
        --encoder_filters 16,32 --synthetic_examples 64
On a card: leave out ``--device`` (``--cluster_size 1`` on one card).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def synthetic_pets(n, size, seed=23):
    """Images with a bright rectangle on noise; masks label the rectangle
    (3 classes like oxford_iiit_pet: object / border / background).  The
    JAX example's generator, so both twins see the same arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.random((n, size, size, 3)).astype("float32") * 0.3
    masks = np.full((n, size, size), 2, np.int32)  # background
    for i in range(n):
        h, w = rng.integers(size // 4, size // 2, 2)
        y, x = rng.integers(0, size - h), rng.integers(0, size - w)
        images[i, y:y + h, x:x + w] += 0.6
        masks[i, y:y + h, x:x + w] = 0               # object
        masks[i, y:y + h, x] = masks[i, y:y + h, x + w - 1] = 1  # border
        masks[i, y, x:x + w] = masks[i, y + h - 1, x:x + w] = 1
    return np.clip(images, 0, 1), masks


def build_trainer(args, device):
    """``(model, trainer)``: the U-Net from flax's initialisers with seed 0
    (the same init on every node) and its Adam Trainer."""
    import functools

    import torch

    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.models import unet as unet_mod

    filters = tuple(int(f) for f in args.encoder_filters.split(","))
    model = unet_mod.build_unet(num_classes=3, dtype=args.dtype,
                                encoder_filters=filters)
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = train_mod.Trainer(
        unet_mod.loss_fn(model), dict(model.named_parameters()),
        functools.partial(torch.optim.Adam, lr=args.lr),
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else None,
        batch_size=args.batch_size, log_steps=args.log_steps, device=device)
    return model, trainer


def node_examples(args, rank=0, world=1):
    """``(images, masks)``: the ``rank``'s strided shard of the synthetic
    examples."""
    images, masks = synthetic_pets(args.synthetic_examples, args.image_size)
    return images[rank::world], masks[rank::world]


def first_batch(args, rank=0, world=1):
    """The ``rank``'s first local batch of :func:`train_segmentation`: its
    shard of the examples in its first shuffle's order."""
    import numpy as np

    images, masks = node_examples(args, rank, world)
    local_bs = args.batch_size // world
    idx = np.random.default_rng(rank).permutation(len(images))[:local_bs]
    return {"image": images[idx], "mask": masks[idx]}


def train_segmentation(args, ctx, on_step=None):
    """Train on this node and export from the chief: returns ``(model,
    trainer, stats)``.  ``on_step(step, loss, aux)``, when given, sees every
    step's device loss (:func:`main_fun` is this less the model and the
    trainer)."""
    import numpy as np

    from tensorflowonspark_torch import checkpoint

    device = ctx.initialize_distributed(device=args.device)
    rank = ctx.process_id or 0
    world = max(ctx.num_processes or 1, 1)

    images, masks = node_examples(args, rank, world)
    model, trainer = build_trainer(args, device)

    local_bs = args.batch_size // world
    row_mask = np.ones((local_bs,), np.float32)
    rng = np.random.default_rng(rank)
    loss = aux = None
    step = 0
    while step < args.train_steps:
        order = rng.permutation(len(images))
        for s in range(len(images) // local_bs):
            idx = order[s * local_bs:(s + 1) * local_bs]
            loss, aux = trainer.step({"image": images[idx],
                                      "mask": masks[idx]}, row_mask)
            step += 1
            if on_step is not None:
                on_step(step, loss, aux)
            if step >= args.train_steps:
                break

    trainer.history.on_train_end(loss)
    stats = trainer.history.log_stats(
        loss=float(loss), accuracy=float(aux["accuracy"]))
    if args.export_dir and checkpoint.should_export(ctx):
        checkpoint.export_model(
            ctx.absolute_path(args.export_dir), trainer.state.params, "unet",
            model_config={"num_classes": 3, "dtype": args.dtype},
            input_signature={
                "image": [None, args.image_size, args.image_size, 3]})
    return model, trainer, stats


def main_fun(args, ctx):
    """The node function: train on this node, return the final stats."""
    return train_segmentation(args, ctx)[2]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--train_steps", type=int, default=200)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--encoder_filters", default="32,64,128,256",
                        help="comma-separated U-Net encoder widths (depth "
                             "knob; fewer/narrower stages for smoke tests)")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--synthetic_examples", type=int, default=512)
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--log_steps", type=int, default=20)
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
