"""Transformer LM on the PyTorch port, dense or Switch MoE (the one-card
twin of ``examples/transformer/transformer_lm.py``).

The same workload and flags: a decoder-only LM (``--mlp moe`` for the
Switch-style top-1 mixture of experts, ``--attention flash`` for the
hand-written CUDA flash kernels), optax ``adamw(lr)``'s update
(``torch.optim.AdamW`` with its weight decay 1e-4 and eps 1e-8), the
synthetic token stream with learnable n-gram structure (numpy's
``default_rng(process index)``, the JAX example's formula, so the stream is
its stream to the token), or with ``--data_dir`` a byte-level LM over raw
files (``data.FileFeed`` + ``data.byte_lm_reader`` -> ``ShardedFeed``), the
TimeHistory stats with the port's FLOP count, and the chief's export, all
through ``cluster.run`` in FILES mode: every node runs ``main_fun`` inline
in its executor process, where CUDA comes up.

Where the twin differs: it trains on one card a node, so the mesh
``--data`` x ``--fsdp`` x ``--seq`` x ``--expert`` x ``--tensor`` spans the
``--cluster_size`` nodes: the product must equal it (``--data`` defaults
to -1, the rest of the nodes; the other axes to 1, where the JAX defaults
of 2 need 8 devices).  The layout is the JAX example's ``layout()``: the
FSDP rule over ``--fsdp`` when it is above 1, else replicated, with the
expert-stacked MoE leaves over ``expert`` (``merge_ep_shardings``) when
``--expert`` is above 1; the rows go over data, fsdp and expert (the
model's ``ep_batch_axes`` and the feed's and Trainer's ``batch_axes``).
``--tensor`` above 1 splits each block's heads and MLP over that axis
while the params replicate over it, as the JAX example's ``layout()`` does
(its docstring says "tensor-parallel", its code never calls
``tp_param_shardings``: ROADMAP.md, Queue 3).  ``--seq`` above 1 splits
each sequence over that axis, with ring attention unless ``--attention``
says ``ulysses``, and each ``seq`` group trains on its members' pooled
rows; an MoE layer then routes the whole sequence.  ``--ep_mode
shard_map`` runs the explicit all-to-all schedule.  ``--attention``
defaults to ``full`` without ``--seq``; ``--device`` ("cpu" to run on the
CPU; the nodes' cards by default); the steps go through the port's
Trainer (``fit_feed``); the export's ``model_config`` also carries
``mlp``, ``num_experts`` and ``capacity_factor``, so an MoE export is
served as the MoE LM (the JAX example's omits them).

Run on the CPU (tiny smoke):
    python examples/transformer/transformer_lm_torch.py --device cpu \\
        --mlp moe --num_experts 4 --vocab_size 64 --num_layers 2 \\
        --num_heads 2 --head_dim 8 --seq_len 32 --train_steps 4
On a card: leave out ``--device`` (``--attention flash`` for the kernels).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

# the MoE capacity factor the JAX example builds with (the model's default)
CAPACITY_FACTOR = 1.25


class SyntheticTokens(object):
    """The JAX example's synthetic token stream (``next_batch``): each row
    counts up by one from a random offset, drawn per batch from
    ``numpy.random.default_rng(seed)``.  Served like a DataFeed's columnar
    path (``next_batch_arrays``) for a ``ShardedFeed``; it never ends."""

    def __init__(self, seq_len, vocab_size, seed):
        import numpy as np

        self.rng = np.random.default_rng(seed)
        self.base = np.arange(seq_len) % vocab_size
        self.vocab_size = vocab_size

    def next_batch_arrays(self, n):
        import numpy as np

        offs = self.rng.integers(0, self.vocab_size, (n, 1))
        toks = ((self.base[None, :] + offs) % self.vocab_size).astype(
            np.int32)
        return {"tokens": toks}, n

    def should_stop(self):
        return False

    def interrupt(self):
        pass

    def terminate(self):
        pass


def train_lm(args, ctx):
    """Build and train on this node: returns ``(trainer, stats)``
    (:func:`main_fun` is this less the trainer)."""
    import functools

    import torch

    from tensorflowonspark_torch import checkpoint
    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.parallel import infeed
    from tensorflowonspark_torch.parallel import mesh as mesh_mod

    spec = check_mesh_flags(args)
    attention = args.attention or ("ring" if args.seq > 1 else "full")
    device = ctx.initialize_distributed(device=args.device)
    rank = ctx.process_id or 0
    mesh = mesh_mod.build_mesh(spec, keep_trivial_axes=True, device=device)
    # batch: dp (data, fsdp AND expert axes all carry distinct rows) x sp,
    # as the JAX example's
    batch_axes = tuple(a for a, n in (("data", args.data),
                                      ("fsdp", args.fsdp),
                                      ("expert", args.expert)) if n != 1)
    batch_axes = batch_axes or ("data",)
    model = tfm.build_transformer(
        vocab_size=args.vocab_size, num_layers=args.num_layers,
        num_heads=args.num_heads, head_dim=args.head_dim,
        max_seq_len=args.seq_len, attention=attention, mlp=args.mlp,
        num_experts=args.num_experts, capacity_factor=CAPACITY_FACTOR,
        ep_mode=args.ep_mode, mesh=mesh, ep_batch_axes=batch_axes,
        dtype=args.dtype)
    # one seed on every node: the same init everywhere
    model.init_weights(torch.Generator().manual_seed(0))
    params = dict(model.state_dict())

    # the flash kernels' FLOPs, which FlopCounterMode cannot see: causal
    # forward 2 and backward 5 S^2 D products per (row, head, layer)
    flash_flops = (7 * args.seq_len ** 2 * args.head_dim * args.batch_size
                   * args.num_heads * args.num_layers
                   if attention == "flash" else 0)
    trainer = train_mod.Trainer(
        tfm.loss_fn(model), params,
        # optax.adamw(lr): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
        functools.partial(torch.optim.AdamW, lr=args.lr, eps=1e-8,
                          weight_decay=1e-4),
        batch_size=args.batch_size, log_steps=args.log_steps,
        extra_step_flops=flash_flops, device=device, mesh=mesh,
        param_sharding=layout(args, params, mesh), batch_axes=batch_axes)

    if args.data_dir:
        # real text: raw files -> byte-level token stream (vocab 256, no
        # tokenizer) packed to seq_len, streamed via FileFeed
        if args.vocab_size < 256:
            raise ValueError("--data_dir byte-level LM needs --vocab_size "
                             ">= 256")
        from tensorflowonspark_torch import data as data_mod
        from tensorflowonspark_torch.datafeed import strip_scheme

        source = data_mod.FileFeed(
            data_mod.list_shards(
                strip_scheme(ctx.absolute_path(args.data_dir)), pattern="*"),
            row_reader=data_mod.byte_lm_reader(args.seq_len),
            shuffle_buffer=args.shuffle_buffer, num_epochs=args.epochs,
            seed=rank)
    else:
        source = SyntheticTokens(args.seq_len, args.vocab_size, rank)
    feed = infeed.ShardedFeed(source, args.batch_size, device=device,
                              mesh=mesh, batch_axes=batch_axes)
    stats = trainer.fit_feed(feed, max_steps=args.train_steps)
    if trainer.state.step == 0:
        raise RuntimeError(
            "no training batches produced: are the --data_dir files "
            "shorter than --seq_len bytes?")
    print("trained {} steps, loss {:.4f}".format(trainer.state.step,
                                                 stats["loss"]))

    # every node: a local expert leaf's blocks are all-gathered
    params = trainer.state.full_params()
    if args.export_dir and checkpoint.should_export(ctx):
        # the JAX example's model_config, plus the FFN's
        checkpoint.export_model(
            ctx.absolute_path(args.export_dir), params,
            "transformer_lm",
            model_config={"vocab_size": args.vocab_size,
                          "num_layers": args.num_layers,
                          "num_heads": args.num_heads,
                          "head_dim": args.head_dim,
                          "max_seq_len": args.seq_len, "dtype": args.dtype,
                          "mlp": args.mlp, "num_experts": args.num_experts,
                          "capacity_factor": CAPACITY_FACTOR},
            input_signature={"tokens": [None, args.seq_len]})
    return trainer, stats


def layout(args, params, mesh):
    """The JAX example's ``layout()``: the FSDP rule by shape when
    ``--fsdp`` is above 1, else replicated, then the expert-stacked MoE
    leaves overlaid on the expert axis when ``--expert`` is above 1; None
    when everything replicates."""
    from tensorflowonspark_torch.parallel import ep as ep_mod
    from tensorflowonspark_torch.parallel import fsdp as fsdp_mod

    shardings = (fsdp_mod.tree_shardings(params, mesh) if args.fsdp > 1
                 else None)
    if args.expert > 1:
        shardings = ep_mod.merge_ep_shardings(shardings or {}, params, mesh)
    return shardings


def check_mesh_flags(args):
    """The mesh spec of the flags, before any node starts: a mesh that
    does not span ``--cluster_size`` nodes, one card each, raises
    ``ValueError``."""
    from tensorflowonspark_torch.parallel import mesh as mesh_mod

    spec = mesh_mod.MeshSpec(data=args.data, fsdp=args.fsdp, seq=args.seq,
                             expert=args.expert, tensor=args.tensor)
    try:
        spec.resolve(args.cluster_size)
    except AssertionError as err:
        raise ValueError(
            "--data {} x --fsdp {} x --seq {} x --expert {} x --tensor {} "
            "must span --cluster_size {} nodes, one card each: {}".format(
                args.data, args.fsdp, args.seq, args.expert, args.tensor,
                args.cluster_size, err)) from None
    return spec


def main_fun(args, ctx):
    """The node function: train on this node, return the final stats."""
    return train_lm(args, ctx)[1]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--train_steps", type=int, default=20)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--vocab_size", type=int, default=512)
    parser.add_argument("--num_layers", type=int, default=4)
    parser.add_argument("--num_heads", type=int, default=8)
    parser.add_argument("--head_dim", type=int, default=32)
    parser.add_argument("--seq_len", type=int, default=1024)
    parser.add_argument("--data", type=int, default=-1,
                        help="data-parallel mesh degree (-1: the nodes "
                             "--fsdp and --seq leave)")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="fsdp-axis size: shards params + optimizer "
                             "state (and contributes to batch parallelism)")
    parser.add_argument("--seq", type=int, default=1,
                        help="sequence-parallel degree (ring attention "
                             "unless --attention ulysses)")
    parser.add_argument("--expert", type=int, default=1,
                        help="expert-parallel degree: MoE expert weights "
                             "shard over this axis")
    parser.add_argument("--tensor", type=int, default=1,
                        help="tensor-parallel degree: heads and MLP split "
                             "over it, params replicated (the JAX "
                             "example's layout)")
    parser.add_argument("--mlp", default="dense", choices=["dense", "moe"],
                        help="FFN flavor; 'moe' = Switch-style mixture of "
                             "experts")
    parser.add_argument("--num_experts", type=int, default=8)
    parser.add_argument("--ep_mode", default="gspmd",
                        choices=["gspmd", "shard_map"],
                        help="expert parallelism flavor: gspmd (dense "
                             "one-hot dispatch) or shard_map (explicit "
                             "all_to_all schedule, parallel/ep.py)")
    parser.add_argument("--attention", default=None,
                        choices=[None, "full", "flash", "ring", "ulysses"],
                        help="attention kernel (default ring when --seq "
                             "> 1, else full; 'flash' runs the hand-written "
                             "CUDA kernels)")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--export_dir", default=None)
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--data_dir", default=None,
                        help="dir of raw text files: byte-level LM via "
                             "data.byte_lm_reader (synthetic when omitted)")
    parser.add_argument("--shuffle_buffer", type=int, default=2048)
    parser.add_argument("--epochs", type=int, default=1,
                        help="file passes in --data_dir mode")
    parser.add_argument("--device", default=None,
                        help="'cpu' to train on the CPU; the nodes' cards "
                             "by default")
    args, _ = parser.parse_known_args(argv)
    return args


def main(argv=None):
    from tensorflowonspark_torch import backend, cluster

    args = parse_args(argv)
    check_mesh_flags(args)   # before any node starts
    b = backend.LocalBackend(args.cluster_size)
    try:
        c = cluster.run(b, main_fun, args, num_executors=args.cluster_size,
                        input_mode=cluster.InputMode.FILES)
        c.shutdown(grace_secs=2)
    finally:
        b.stop()


if __name__ == "__main__":
    main()
