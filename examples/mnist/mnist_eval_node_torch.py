"""MNIST training with a dedicated evaluator node on the PyTorch port (the
twin of ``examples/mnist/mnist_eval_node.py``; reference
``examples/mnist/estimator/mnist_tf.py:109-115``, ``train_and_evaluate``
with an ``eval_node``).

Workers train in the shared ``torch.distributed`` world (SGD with momentum
0.9, gradients all-reduced) and checkpoint every ``--save_interval``
steps; the **evaluator** is outside that world (``ctx.process_id`` is
None: a different program inside the world would wedge its collectives),
polls the checkpoint directory, restores the newest step, evaluates it and
appends the metrics to ``eval_metrics.jsonl`` beside the checkpoints until
it has scored the final step.  The driver waits for that final score
before it shuts the cluster down.

CUDA in FILES mode: the workers run ``main_fun`` inline in their executors
and bring CUDA up there; the evaluator runs in the node's forked child.

Run on the CPU:
    python examples/mnist/mnist_eval_node_torch.py --device cpu \\
        --cluster_size 3
On the cards (one per node): leave out ``--device``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def _build(args, device):
    """``(model, trainer)``: the MNIST CNN from seed 0 and its SGD-momentum
    Trainer on ``device``."""
    import functools

    import torch

    from tensorflowonspark_torch import train as train_mod
    from tensorflowonspark_torch.models import mnist as mnist_mod

    torch.manual_seed(0)
    model = mnist_mod.build_mnist(dtype="bfloat16")
    trainer = train_mod.Trainer(
        mnist_mod.loss_fn(model), dict(model.state_dict()),
        functools.partial(torch.optim.SGD, lr=args.lr, momentum=0.9),
        compute_dtype=torch.bfloat16, batch_size=args.batch_size,
        device=device)
    return model, trainer


def _synthetic_batch(args, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "image": rng.random((args.batch_size, 28, 28, 1), np.float32),
        "label": rng.integers(0, 10, (args.batch_size,), np.int64),
    }


def evaluator_fun(args, ctx):
    """Runs on the evaluator node, outside the workers' world: restore and
    evaluate each new checkpoint (the reference eval_node's continuous-eval
    loop)."""
    import torch

    from tensorflowonspark_torch import checkpoint
    from tensorflowonspark_torch.datafeed import strip_scheme
    from tensorflowonspark_torch.device import resolve_device
    from tensorflowonspark_torch.models import mnist as mnist_mod

    assert ctx.process_id is None  # not a slot in the workers' world
    device = resolve_device(args.device)
    model, trainer = _build(args, device)
    loss = mnist_mod.loss_fn(model)
    eval_batch = {k: torch.from_numpy(v).to(device)
                  for k, v in _synthetic_batch(args, seed=1234).items()}
    mask = torch.ones(args.batch_size, device=device)
    model_dir = ctx.absolute_path(args.model_dir)

    mgr = checkpoint.CheckpointManager(model_dir, save_interval_steps=0)
    seen = -1
    # idle timeout, not a lifetime cap: every evaluated checkpoint pushes
    # the deadline out, so a loaded host where training itself takes longer
    # than eval_timeout does not lose the final eval; the loop only gives
    # up after eval_timeout with NO new checkpoint appearing
    deadline = time.time() + args.eval_timeout
    while time.time() < deadline:
        # cheap step probe first: a full restore on every 1 s idle poll
        # would load the same checkpoint again and again
        latest = mgr.latest_step()
        if (-1 if latest is None else latest) <= seen:
            time.sleep(1)
            continue
        step = trainer.restore_latest(mgr)
        if step is not None and step > seen:
            seen = step
            deadline = time.time() + args.eval_timeout
            with torch.no_grad():
                value, aux = loss(trainer.state.params, eval_batch, mask)
            metrics = {"step": int(step), "loss": float(value),
                       "accuracy": float(aux["accuracy"])}
            # metrics land next to the checkpoints (shared storage), not in
            # whatever cwd the evaluator process happens to run from
            metrics_path = os.path.join(strip_scheme(model_dir),
                                        "eval_metrics.jsonl")
            with open(metrics_path, "a") as f:
                f.write(json.dumps(metrics) + "\n")
            print("evaluator: step {} loss {:.4f} acc {:.3f}".format(
                step, metrics["loss"], metrics["accuracy"]))
            if step >= args.max_steps:
                break
        time.sleep(1)
    mgr.close()


def main_fun(args, ctx):
    """Dispatch by role: workers train + checkpoint, evaluator evaluates."""
    if ctx.job_name == "evaluator":
        evaluator_fun(args, ctx)
        return

    from tensorflowonspark_torch import checkpoint

    device = ctx.initialize_distributed(device=args.device)
    _, trainer = _build(args, device)
    mgr = checkpoint.CheckpointManager(
        ctx.absolute_path(args.model_dir),
        save_interval_steps=args.save_interval, is_chief=ctx.is_chief())
    batch = _synthetic_batch(args, seed=ctx.process_id or 0)
    for step in range(1, args.max_steps + 1):
        trainer.step(batch)
        mgr.maybe_save(step, trainer.state, force=step == args.max_steps)
    mgr.wait_until_finished()
    mgr.close()


def main(argv=None):
    from tensorflowonspark_torch import backend, cluster

    parser = argparse.ArgumentParser()
    parser.add_argument("--cluster_size", type=int, default=3,
                        help="workers + 1 evaluator")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--max_steps", type=int, default=30)
    parser.add_argument("--save_interval", type=int, default=10)
    parser.add_argument("--eval_timeout", type=int, default=120)
    parser.add_argument("--model_dir", default="mnist_eval_model")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU; the nodes' cards "
                             "by default")
    args, _ = parser.parse_known_args(argv)
    # Checkpoints must live on storage every node can reach (executors each
    # have their own cwd); absolutize against the driver's cwd for the
    # local-backend case; in real deployments pass shared storage.
    args.model_dir = os.path.abspath(args.model_dir)

    b = backend.LocalBackend(args.cluster_size)
    try:
        baseline = _metrics_line_count(args)  # stale lines from a prior run
        c = cluster.run(b, main_fun, args, num_executors=args.cluster_size,
                        eval_node=True, input_mode=cluster.InputMode.FILES)
        _await_final_eval(args, baseline)
        c.shutdown(grace_secs=5)
    finally:
        b.stop()


def _metrics_line_count(args):
    try:
        with open(os.path.join(args.model_dir, "eval_metrics.jsonl")) as f:
            return sum(1 for _ in f)  # raw count: the waiter slices raw lines
    except OSError:
        return 0


def _await_final_eval(args, baseline):
    """Block until THIS run's evaluator has scored the FINAL checkpoint.

    ``train_and_evaluate`` semantics (reference
    ``examples/mnist/estimator/mnist_tf.py:109-115``): the run isn't done
    until the last checkpoint has an eval.  Without this, shutdown races
    the evaluator's restore of the final step: workers finish, the driver
    poisons the cluster, and a slow restore loses the last eval.  Only
    lines past ``baseline`` count: eval_metrics.jsonl is append-only, so a
    reused model_dir carries satisfied-looking steps from a previous run.

    The timeout is an IDLE timeout (matching the evaluator's own loop):
    ``cluster.run`` returns at rendezvous, before training, so a fixed
    lifetime deadline would bill training time against ``eval_timeout``
    and give up mid-training on a loaded host.  Any observable progress
    (a new metrics line, a new checkpoint directory) pushes it out."""
    metrics_path = os.path.join(args.model_dir, "eval_metrics.jsonl")
    deadline = time.time() + args.eval_timeout
    progress = None
    while time.time() < deadline:
        try:
            with open(metrics_path) as f:
                lines = [line for line in list(f)[baseline:] if line.strip()]
            steps = [json.loads(line)["step"] for line in lines]
            if steps and max(steps) >= args.max_steps:
                return
        except (OSError, ValueError, KeyError):
            lines = []
        try:
            ckpt_steps = sorted(int(d) for d in os.listdir(args.model_dir)
                                if d.isdigit())
        except OSError:
            ckpt_steps = []
        now_progress = (len(lines), ckpt_steps[-1] if ckpt_steps else -1)
        if now_progress != progress:
            progress = now_progress
            deadline = time.time() + args.eval_timeout
        time.sleep(0.5)
    print("warning: evaluator never scored step {} within {}s of last "
          "progress".format(args.max_steps, args.eval_timeout),
          file=sys.stderr)


if __name__ == "__main__":
    main()
