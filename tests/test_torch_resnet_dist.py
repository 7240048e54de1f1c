"""Two gloo ranks of the port's Trainer on ResNet-50 v1.5 (s2d stem, one
bottleneck a stage, 32 px) against the JAX Trainer on one process over the
concatenated global batch: the BatchNorm statistics are the global batch's
(each layer all-reduces its sums with a differentiable all-reduce), and
each rank's loss is scaled by its share of the global valid rows before
its backward, so the summed gradients carry the cross-rank terms of the
statistics right, a padded final batch with unequal valid rows included.

float64 on both sides (see ``tests/test_torch_resnet_train.py``).  The
ranks import this module: jax stays inside the test, so they do not load
it."""

import functools
import threading

import numpy as np
import torch

from tensorflowonspark_torch import convert, train
from tensorflowonspark_torch.models import resnet

from torch_world import run_world

PX, BATCH, CLASSES = 32, 8, 5
CFG = dict(num_classes=CLASSES, blocks_per_stage=1, stem="s2d",
           dtype="float64")
LR, MOMENTUM, WD, SMOOTH = 0.1, 0.9, 1e-4, 0.1
# as in tests/test_torch_resnet_train.py: fp32 logits over float64
LOSS_RTOL = 1e-6
STATE_TOL = 1e-5


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((BATCH, PX, PX, 3)),
            "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)}


def _rank_steps(rank, state, batches, masks):
    """This rank's half of each global batch (rows ``4 * rank`` on), a step
    each; returns the losses and, after each step, the params and extra
    state."""
    torch.set_num_threads(1)
    sd, extra = state
    tr = train.Trainer(
        resnet.loss_fn(resnet.build_resnet50(**CFG), weight_decay=WD,
                       label_smoothing=SMOOTH),
        {k: torch.from_numpy(v) for k, v in sd.items()},
        functools.partial(torch.optim.SGD, lr=LR, momentum=MOMENTUM),
        extra_state={k: torch.from_numpy(v) for k, v in extra.items()},
        batch_size=BATCH, device="cpu")
    rows = slice(4 * rank, 4 * rank + 4)
    losses, states = [], []
    for b, m in zip(batches, masks):
        losses.append(tr.step({k: v[rows] for k, v in b.items()},
                              m[rows])[0].item())
        states.append((
            {k: v.detach().numpy().copy() for k, v in tr.state.params.items()},
            {k: v.numpy().copy() for k, v in tr.state.extra.items()}))
    return losses, states


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, prefix + (key,)))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def test_two_gloo_ranks_match_jax_global_batch():
    """A full step, then a padded one (rank 0's half keeps 4 valid rows,
    rank 1's 2): each rank's losses, params and running averages after each
    step equal the JAX Trainer's over the whole batch, and both ranks end
    on the same params."""
    import jax
    import jax.numpy as jnp
    import optax

    from tensorflowonspark_tpu import train as jax_train
    from tensorflowonspark_tpu.models import resnet as jax_resnet
    from tensorflowonspark_tpu.parallel import batch_sharding, build_mesh

    with jax.enable_x64(True):
        model = jax_resnet.build_resnet50(**CFG)
        variables = jax.jit(lambda k: model.init(
            k, jnp.zeros((1, PX, PX, 3)), train=False))(
                jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(x):
        x = np.asarray(x, np.float64)
        return x + 0.1 * (np.std(x) or 1.0) * rng.standard_normal(x.shape)

    params = jax.tree_util.tree_map(perturb, variables["params"])
    stats = jax.tree_util.tree_map(lambda x: np.abs(perturb(x)),
                                   variables["batch_stats"])
    sd, extra = convert.resnet_params_from_flax(params, stats)
    state = ({k: v.numpy() for k, v in sd.items()},
             {k: v.numpy() for k, v in extra.items()})
    batches = [_batch(60), _batch(61)]
    masks = [np.ones(BATCH, np.float32),
             np.array([1, 1, 1, 1, 1, 0, 1, 0], np.float32)]

    # the ranks run while this process compiles and steps the JAX Trainer
    ranks = {}

    def run_ranks():
        try:
            ranks["result"] = run_world(_rank_steps, 2, state, batches, masks)
        except BaseException as exc:  # noqa: B036 -- re-raised below
            ranks["error"] = exc

    thread = threading.Thread(target=run_ranks)
    thread.start()
    want = []
    with jax.enable_x64(True):
        jax_tr = jax_train.Trainer(
            jax_resnet.loss_fn(model, weight_decay=WD,
                               label_smoothing=SMOOTH),
            params, optax.sgd(LR, momentum=MOMENTUM), mesh=build_mesh(),
            extra_state=stats, batch_size=BATCH, step_flops_override=1)
        mesh = jax_tr.mesh
        for b, m in zip(batches, masks):
            loss, _ = jax_tr.step(
                {"image": jax.device_put(b["image"], batch_sharding(mesh, 3)),
                 "label": jax.device_put(b["label"], batch_sharding(mesh))},
                jax.device_put(m, batch_sharding(mesh)))
            want.append((float(loss),
                         _flat(jax.device_get(jax_tr.state.params)),
                         _flat(jax.device_get(jax_tr.state.extra))))
    thread.join(timeout=300)
    if "error" in ranks:
        raise ranks["error"]
    assert "result" in ranks, "the ranks did not finish"
    for losses, states in ranks["result"]:
        for (want_loss, want_params, want_stats), loss, (p, e) in zip(
                want, losses, states):
            np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
            got_params, got_stats = convert.resnet_params_to_flax(
                {k: torch.from_numpy(v) for k, v in p.items()},
                {k: torch.from_numpy(v) for k, v in e.items()})
            for got, ref in ((_flat(got_params), want_params),
                             (_flat(got_stats), want_stats)):
                assert sorted(got) == sorted(ref)
                for path, arr in ref.items():
                    np.testing.assert_allclose(
                        got[path], arr, rtol=0,
                        atol=STATE_TOL * max(np.abs(arr).max(), 1e-3),
                        err_msg=str(path))
    first, second = ranks["result"]
    for name, value in first[1][-1][0].items():
        assert np.array_equal(second[1][-1][0][name], value), name
