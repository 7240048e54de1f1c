"""The port's parallel paths on several cards: the Trainer's NCCL
gradient all-reduce, the ResNet's BatchNorm statistics of the global batch,
and the cluster's NCCL world (two cards); the flagship LM at full width
under FSDP, ring and Ulysses sequence parallelism, Ulysses on the flash
kernels, K = 5 under FSDP and the LM twin through the cluster on a
``--fsdp 2 --seq 2`` mesh (four cards); and tensor, expert and pipeline
parallelism (four cards): the flash LM under tensor 4 and data 2 x
tensor 2, the MoE flash LM under expert 4 (``shard_map``), data 1 x fsdp 2
x expert 2 (``merge_ep_shardings`` of the FSDP tree) and data 2 x seq 2
(ring), ``gpipe`` over pipe 4, and the twin on ``--fsdp 2 --expert 2
--mlp moe --ep_mode shard_map``.  Run only these with ``-k j2``.

Marked ``cuda``; each test skips with a reason where fewer than two (four)
CUDA cards are present.  No jax here (the machine with the cards has none),
so run it with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_nccl_cuda.py

With ``-s`` each four-card case prints one JSON line (``"case": ...``):
its losses against one card's, its per-card state bytes, and its steady
ms/step (bf16, the flagship's dtype) with the spread over repeated runs
and the device-idle share from ``torch.profiler``.
"""

import contextlib
import functools
import importlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import checkpoint, train
from tensorflowonspark_torch.models import mnist, resnet, transformer
from tensorflowonspark_torch.parallel import mesh as mesh_mod, ring

from torch_world import run_world

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the global batch of a padded final step: 6 valid rows of 8
MASK = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
# fp32 on the cards with TF32 off: the ranks sum the batch's gradients in
# another order than one card does; 1e-5 on the loss and on the params
# after two SGD-momentum steps of lr 0.1
TOL = 1e-5


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")


def _batch():
    rng = np.random.default_rng(0)
    return (rng.random((8, 28, 28, 1), dtype=np.float32),
            rng.integers(0, 10, 8).astype(np.int64))


def _steps(device, rows):
    """Two Trainer steps of MNIST on ``rows`` of the global batch, from the
    same seeded init; returns the losses and params."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = mnist.build_mnist()
    tr = train.Trainer(mnist.loss_fn(model), dict(model.state_dict()),
                       functools.partial(torch.optim.SGD, lr=0.1,
                                         momentum=0.9),
                       batch_size=8, device=device)
    images, labels = _batch()
    losses = [tr.step({"image": images[rows], "label": labels[rows]},
                      MASK[rows])[0].item() for _ in range(2)]
    return losses, {k: v.detach().cpu().numpy()
                    for k, v in tr.state.params.items()}


def _rank_steps(rank):
    return _steps(torch.device("cuda", rank), slice(4 * rank, 4 * rank + 4))


def test_two_card_nccl_step_equals_one_card_step(two_cards):
    """Two NCCL ranks, each with half of a padded global batch (4 and 2
    valid rows), step as one card does on the whole batch, and both apply
    the same gradients."""
    ranks = run_world(_rank_steps, 2, backend="nccl")
    want_losses, want_params = _steps(torch.device("cuda", 0), slice(0, 8))
    for losses, params in ranks:
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=TOL)
        for name, want in want_params.items():
            np.testing.assert_allclose(params[name], want, rtol=0, atol=TOL,
                                       err_msg=name)
    for name in ranks[0][1]:
        assert np.array_equal(ranks[0][1][name], ranks[1][1][name]), name


def test_mnist_example_on_two_cards(two_cards, tmp_path):
    """The example's two SPARK-mode nodes, one card each: the forked
    children join an NCCL world, feed through ShardedFeed on their cards,
    all-reduce every step and the chief exports."""
    export = str(tmp_path / "export")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "mnist",
                                      "mnist_spark_torch.py"),
         "--cluster_size", "2", "--num_rows", "512", "--batch_size", "64",
         "--epochs", "1", "--export_dir", export],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    state, descriptor = checkpoint.load_model(export, validate=True)
    assert descriptor["model_name"] == "mnist_cnn"
    assert set(state) == set(mnist.build_mnist().state_dict())


def _group_steps(device, rows, k=4):
    """K = 4 MNIST steps from the same seeded init as one ``multi_step``
    (graph replays, the NCCL all-reduce inside the graph) on ``rows`` of
    each global batch; returns the final loss and the params."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model = mnist.build_mnist()
    tr = train.Trainer(mnist.loss_fn(model), dict(model.state_dict()),
                       functools.partial(torch.optim.SGD, lr=0.1,
                                         momentum=0.9),
                       batch_size=8, device=device)
    images, labels = _batch()
    shift = [np.roll(images, i, axis=1) for i in range(k)]
    stack = {"image": np.stack([s[rows] for s in shift]),
             "label": np.stack([labels[rows]] * k)}
    loss = tr.multi_step(stack, np.stack([MASK[rows]] * k))
    return loss.item(), {n: v.detach().cpu().numpy()
                         for n, v in tr.state.params.items()}


def _rank_group_steps(rank):
    return _group_steps(torch.device("cuda", rank),
                        slice(4 * rank, 4 * rank + 4))


def test_two_card_multi_step_equals_one_card_steps(two_cards):
    """Two NCCL ranks run K = 4 steps as graph replays, the all-reduce
    captured in the graph, and end where one card's 4 steps on the whole
    padded batch end."""
    ranks = run_world(_rank_group_steps, 2, backend="nccl")
    want_loss, want_params = _group_steps(torch.device("cuda", 0),
                                          slice(0, 8))
    for loss, params in ranks:
        assert abs(loss - want_loss) <= TOL
        for name, want in want_params.items():
            np.testing.assert_allclose(params[name], want, rtol=0, atol=TOL,
                                       err_msg=name)


def _resnet_group(device, rows, k=3):
    """K = 3 steps of a small float64 ResNet-50 v1.5 (s2d, one bottleneck
    a stage, 32 px) as one ``multi_step`` on ``rows`` of each global batch,
    the last padded: two eager warm-ups, then a captured graph whose
    replay holds the BatchNorm all-reduces, the loss-share backward and
    the gradient all-reduce.  Returns the final loss, params and running
    averages."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = resnet.build_resnet50(num_classes=5, blocks_per_stage=1,
                                  stem="s2d", dtype="float64")
    model.init_weights(torch.Generator().manual_seed(0))
    params, extra = resnet.split_state(model)
    tr = train.Trainer(
        resnet.loss_fn(model, weight_decay=1e-4, label_smoothing=0.1),
        {n: v.double() for n, v in params.items()},
        functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
        extra_state={n: v.double() for n, v in extra.items()},
        batch_size=8, device=device)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((k, 8, 32, 32, 3))
    labels = rng.integers(0, 5, (k, 8)).astype(np.int64)
    masks = np.stack([np.ones(8, np.float32)] * (k - 1) + [MASK])
    loss = tr.multi_step({"image": images[:, rows], "label": labels[:, rows]},
                         masks[:, rows])
    return (loss.item(),
            {n: v.detach().cpu().numpy() for n, v in tr.state.params.items()},
            {n: v.cpu().numpy() for n, v in tr.state.extra.items()})


def _rank_resnet_group(rank):
    return _resnet_group(torch.device("cuda", rank),
                         slice(4 * rank, 4 * rank + 4))


def test_two_card_resnet_global_batch_statistics(two_cards):
    """Two NCCL ranks of the ResNet, K = 3 graph replays with the
    BatchNorm statistics all-reduced inside the graph, end where one
    card's 3 steps on the whole batch end, the padded step's unequal valid
    rows (4 and 2) included.  float64 but for the fp32 logits: 1e-5 of
    each tensor's largest value (as tests/test_torch_resnet_dist.py holds
    two gloo ranks to JAX)."""
    ranks = run_world(_rank_resnet_group, 2, backend="nccl")
    want_loss, want_params, want_extra = _resnet_group(
        torch.device("cuda", 0), slice(0, 8))
    for loss, params, extra in ranks:
        assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
        for got, want in ((params, want_params), (extra, want_extra)):
            for name, value in want.items():
                np.testing.assert_allclose(
                    got[name], value, rtol=0,
                    atol=1e-5 * max(np.abs(value).max(), 1e-3),
                    err_msg=name)



# -- four cards: the parallelism slice at the flagship's widths ----------------

@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


# the flagship LM at full width (chip_smoke.py's LM_CONFIG), batch 8 x 1024
LM = dict(vocab_size=32000, num_layers=8, num_heads=16, head_dim=64,
          max_seq_len=1024)
LM_BATCH, LM_SEQ, LM_STEPS, LM_LR = 8, 1024, 10, 1e-3
# fp32 with TF32 off, where the meshes only sum in another order than one
# card: 10 Adam steps within 1e-3 nats of the one-card run's losses
LM_LOSS_TOL = 1e-3
# Ulysses on the flash kernels against the one-card flash op, bf16: 2e-2
# of the largest value or gradient (the public contract's bf16 tolerance)
ATTN_TOL = 2e-2
# steady timing: repeats of this many steps, after 2 warm-up steps
TIME_STEPS, TIME_REPEATS, PROFILE_STEPS = 5, 3, 3


def _lm_init():
    model = transformer.build_transformer(**LM)
    model.init_weights(torch.Generator().manual_seed(0))
    return dict(model.state_dict())


def _lm_tokens(step):
    """The JAX LM example's stream: rows counting up from random offsets."""
    offs = np.random.default_rng(100 + step).integers(
        0, LM["vocab_size"], (LM_BATCH, 1))
    return ((np.arange(LM_SEQ)[None] + offs) % LM["vocab_size"]).astype(
        np.int32)


def _lm_block(x, mesh, batch_axes=None):
    """This rank's block of a global ``[B, S]`` (or ``[B]``) array: its rows
    of the batch axes, its chunk of the seq axis."""
    if mesh is None:
        return x
    index, count = mesh_mod.row_shard(mesh, batch_axes)
    rows = x.shape[0] // count
    x = x[index * rows:(index + 1) * rows]
    parts = mesh_mod.axis_size(mesh, "seq")
    if x.ndim > 1 and parts > 1:
        chunk = x.shape[1] // parts
        r = mesh.get_local_rank("seq")
        x = x[:, r * chunk:(r + 1) * chunk]
    return x


def _lm_trainer(init, device, attention, dtype, mesh=None,
                param_sharding=None):
    model = transformer.build_transformer(**LM, attention=attention,
                                          mesh=mesh, dtype=dtype)
    return train.Trainer(transformer.loss_fn(model), init,
                         functools.partial(torch.optim.Adam, lr=LM_LR),
                         batch_size=LM_BATCH, log_steps=LM_STEPS,
                         device=device, mesh=mesh,
                         param_sharding=param_sharding)


def _device_batch(step, mesh, device, batch_axes=None):
    return ({"tokens": torch.from_numpy(_lm_block(
        _lm_tokens(step), mesh, batch_axes)).to(device)},
            torch.from_numpy(_lm_block(np.ones(LM_BATCH, np.float32),
                                       mesh, batch_axes)).to(device))


def _lm_losses(trainer, mesh, k=1, batch_axes=None):
    """``LM_STEPS`` steps from the stream, as single steps or groups of
    ``k`` (``multi_step``); the loss after each step (each group's last
    at K > 1)."""
    device, losses = trainer.device, []
    for start in range(0, LM_STEPS, k):
        batches = [_device_batch(start + i, mesh, device, batch_axes)
                   for i in range(k)]
        if k == 1:
            losses.append(trainer.step(*batches[0])[0].item())
        else:
            tokens = torch.stack([b["tokens"] for b, _ in batches])
            masks = torch.stack([m for _, m in batches])
            losses += [None] * (k - 1) + [
                trainer.multi_step({"tokens": tokens}, masks).item()]
    return losses


def _state_bytes(trainer):
    """Bytes of the params (full buffers and shards) and the optimizer
    state this rank holds, each storage once."""
    seen, total = set(), 0
    tensors = list(trainer.state.params.values()) + [
        p for g in trainer.state.optimizer.param_groups for p in g["params"]]
    for state in trainer.state.optimizer.state.values():
        tensors += [t for t in state.values() if isinstance(t, torch.Tensor)]
    for t in tensors:
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _steady(trainer, mesh, k=1, batch_axes=None):
    """bf16 ms/step after 2 warm-up dispatches: ``TIME_REPEATS`` runs of
    ``TIME_STEPS`` steps (``k`` a dispatch), host clock between two
    synchronisations, then the device-busy share of ``PROFILE_STEPS``
    steps from ``torch.profiler`` (CUDA kernels; the busy sum over the
    profiled wall time) and the NCCL kernels' device ms a step by
    collective (``AllGather``, ``ReduceScatter``, ``AllReduce``,
    ``SendRecv`` for the all-to-alls and the ring's hops)."""
    from torch.profiler import ProfilerActivity, profile

    device = trainer.device
    batches = [_device_batch(i, mesh, device, batch_axes)
               for i in range(TIME_STEPS)]

    def run(n):
        for start in range(0, n, k):
            group = [batches[(start + i) % TIME_STEPS] for i in range(k)]
            if k == 1:
                trainer.step(*group[0])
            else:
                trainer.multi_step(
                    {"tokens": torch.stack([b["tokens"] for b, _ in group])},
                    torch.stack([m for _, m in group]))

    run(2 * k)
    runs = []
    for _ in range(TIME_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(TIME_STEPS if k == 1 else k)
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0)
                    / (TIME_STEPS if k == 1 else k))
    n = PROFILE_STEPS if k == 1 else k
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and "#" not in e.key) / 1e3
    collectives = {}
    for e in prof.key_averages():
        kind = re.match(r"nccl(?:Dev)?Kernel_([A-Za-z]+)", e.key)
        if kind and str(e.device_type).endswith("CUDA"):
            collectives[kind.group(1)] = collectives.get(
                kind.group(1), 0.0) + e.self_device_time_total / 1e3 / n
    return {"ms_per_step": sorted(runs)[len(runs) // 2],
            "runs_ms_per_step": runs, "spread_ms": max(runs) - min(runs),
            "device_idle_share": 1.0 - busy / wall if busy else None,
            "collective_ms_per_step": collectives,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}


# (name, mesh spec, attention, param_sharding): the four-card cases, each
# against one card with the same global batch
LM_CASES = (("fsdp4", {"fsdp": 4}, "flash", "fsdp"),
            ("ring_seq4", {"seq": 4}, "ring", None),
            ("ulysses_data2_seq2", {"data": 2, "seq": 2}, "ulysses", None))


def _four_card_lm(rank):
    """Every LM case on this rank: fp32 losses of 10 steps (and at K = 5
    under fsdp), the state bytes, the flash launches, then the bf16 steady
    step; and Ulysses on the flash kernels against this card's flash op."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = importlib.import_module("tensorflowonspark_torch.ops.flash_attention")
    device = torch.device("cuda", rank)
    init = _lm_init()
    out = {}
    for name, spec, attention, sharding in LM_CASES:
        mesh = mesh_mod.build_mesh(spec, keep_trivial_axes=True)
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        tr = _lm_trainer(init, device, attention, "float32", mesh, sharding)
        case = {"losses": _lm_losses(tr, mesh),
                "state_bytes": _state_bytes(tr),
                "launches": [fa.fwd_launches, fa.bwd_dq_launches,
                             fa.bwd_dkv_launches]}
        # K = 5: every step after two eager warm-ups a graph replay, the
        # collectives inside the graph
        k1_params = {n: t.detach().clone()
                     for n, t in tr.state.params.items()}
        del tr
        tr = _lm_trainer(init, device, attention, "float32", mesh, sharding)
        case["k5_losses"] = _lm_losses(tr, mesh, k=5)
        case["k5_param_max_diff"] = max(
            (tr.state.params[n] - t).abs().max().item()
            for n, t in k1_params.items())
        case["k5_graphs"] = len(tr._graphs)
        del k1_params, tr
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        tr = _lm_trainer(init, device, attention, "bfloat16", mesh, sharding)
        case["bf16_losses"] = _lm_losses(tr, mesh)
        case["steady"] = _steady(tr, mesh)
        case["steady_k5"] = _steady(tr, mesh, k=5)
        del tr
        torch.cuda.empty_cache()
        out[name] = case

    # Ulysses on the flash kernels over a seq axis of 4, against the flash
    # op on this card over the whole sequence
    mesh = mesh_mod.build_mesh({"seq": 4}, keep_trivial_axes=True)
    gen = torch.Generator().manual_seed(11)
    shape = (LM_BATCH, LM_SEQ, LM["num_heads"], LM["head_dim"])
    full = [torch.randn(shape, generator=gen).to(device, torch.bfloat16)
            for _ in range(4)]
    chunk = LM_SEQ // 4
    cut = slice(rank * chunk, (rank + 1) * chunk)
    local = [t[:, cut].contiguous().requires_grad_() for t in full[:3]]
    got = ring.ulysses_attention(*local, mesh, causal=True, impl="flash")
    got_grads = torch.autograd.grad(got, local, full[3][:, cut].contiguous())
    ref = [t.detach().clone().requires_grad_() for t in full[:3]]
    want = fa.flash_attention(*ref, causal=True)
    want_grads = torch.autograd.grad(want, ref, full[3])
    errs = {}
    for key, g, w in zip(("out", "dq", "dk", "dv"), [got] + list(got_grads),
                         [want] + list(want_grads)):
        w_local = w[:, cut].float()
        errs[key] = ((g.float() - w_local).abs().max()
                     / w.float().abs().max()).item()
    out["ulysses_flash_op"] = {"errs": errs,
                               "device": str(got.device),
                               "on_this_card": got.device == device}
    return out


def _one_card_lm():
    """The one-card runs the cases are held to: fp32 full and flash
    attention (10 steps), the bf16 losses, and the bf16 flash steady
    step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    init = _lm_init()
    out = {}
    for attention in ("full", "flash"):
        for dtype in ("float32", "bfloat16"):
            tr = _lm_trainer(init, device, attention, dtype)
            out[attention, dtype] = _lm_losses(tr, None)
            if attention == "flash" and dtype == "bfloat16":
                torch.cuda.reset_peak_memory_stats(device)
                out["steady"] = _steady(tr, None)
                out["state_bytes"] = _state_bytes(tr)
            del tr
            torch.cuda.empty_cache()
    return out


@pytest.fixture(scope="module")
def four_card_lm():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from tensorflowonspark_torch.ops import _build

    _build.build()        # once here; the ranks load it
    one = _one_card_lm()
    torch.cuda.empty_cache()
    ranks = run_world(_four_card_lm, 4, backend="nccl", timeout=900)
    return one, ranks


def _report(case, **fields):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps(dict({"case": case, "cards": smi}, **fields)),
          flush=True)


def _loss_diffs(got, want):
    return [abs(a - b) for a, b in zip(got, want) if a is not None]


def test_four_card_fsdp_lm_matches_one_card(four_cards, four_card_lm):
    """fsdp = 4: the flash LM at full width, 10 fp32 steps within 1e-3
    nats of one card's on the same global batch; the per-card bytes of
    params plus Adam state below one card's; the flash kernels launched
    layers x steps on every rank."""
    one, ranks = four_card_lm
    diffs = [_loss_diffs(r["fsdp4"]["losses"], one["flash", "float32"])
             for r in ranks]
    case = ranks[0]["fsdp4"]
    _report("fsdp4", losses=case["losses"],
            one_card_losses=one["flash", "float32"],
            max_loss_diff=max(max(d) for d in diffs),
            state_bytes=[r["fsdp4"]["state_bytes"] for r in ranks],
            one_card_state_bytes=one["state_bytes"],
            bf16_loss_diff=_loss_diffs(case["bf16_losses"],
                                       one["flash", "bfloat16"]),
            steady=case["steady"], one_card_steady=one["steady"],
            launches=case["launches"])
    assert all(max(d) <= LM_LOSS_TOL for d in diffs), diffs
    assert all(r["fsdp4"]["state_bytes"] < 0.75 * one["state_bytes"]
               for r in ranks)
    expected = LM["num_layers"] * LM_STEPS
    assert all(r["fsdp4"]["launches"] == [expected] * 3 for r in ranks)


@pytest.mark.parametrize("name", [c[0] for c in LM_CASES])
def test_four_card_k5_equals_k1(four_cards, four_card_lm, name):
    """K = 5 under fsdp = 4, seq = 4 (ring) and data = 2 x seq = 2
    (Ulysses): the collectives captured in the graph (the reduce-scatter
    and all-gather, the ring's sends and receives, the all-to-alls), the
    losses at steps 5 and 10 and the params equal to K = 1's."""
    _, ranks = four_card_lm
    case = ranks[0][name]
    _report(name + "_k5", k5_losses=case["k5_losses"],
            k1_losses=case["losses"],
            param_max_diff=[r[name]["k5_param_max_diff"] for r in ranks],
            graphs=case["k5_graphs"], steady_k5=case["steady_k5"])
    for r in ranks:
        c = r[name]
        assert c["k5_graphs"] == 1
        assert max(_loss_diffs(c["k5_losses"], c["losses"])) <= LM_LOSS_TOL
        assert c["k5_param_max_diff"] <= 1e-5


@pytest.mark.parametrize("name", ["ring_seq4", "ulysses_data2_seq2"])
def test_four_card_sequence_parallel_lm_matches_one_card(four_cards,
                                                         four_card_lm, name):
    """seq = 4 with ring attention, and data = 2 x seq = 2 with Ulysses:
    the full-width LM's 10 fp32 steps within 1e-3 nats of one card's with
    ``attention="full"``."""
    one, ranks = four_card_lm
    diffs = [_loss_diffs(r[name]["losses"], one["full", "float32"])
             for r in ranks]
    case = ranks[0][name]
    _report(name, losses=case["losses"],
            one_card_losses=one["full", "float32"],
            max_loss_diff=max(max(d) for d in diffs),
            state_bytes=case["state_bytes"],
            bf16_loss_diff=_loss_diffs(case["bf16_losses"],
                                       one["full", "bfloat16"]),
            steady=case["steady"])
    assert all(max(d) <= LM_LOSS_TOL for d in diffs), diffs


def test_four_card_ulysses_flash_matches_flash_op(four_cards, four_card_lm):
    """``ulysses_attention(impl="flash")`` over four cards at [8, 1024, 16,
    64] bf16 causal, forward and backward, against the flash op on one
    card; each rank's kernels ran on its own card."""
    _, ranks = four_card_lm
    errs = [r["ulysses_flash_op"]["errs"] for r in ranks]
    _report("ulysses_flash_op", errs=errs)
    for r in ranks:
        assert r["ulysses_flash_op"]["on_this_card"]
        assert all(e <= ATTN_TOL for e in r["ulysses_flash_op"]["errs"]
                   .values()), r["ulysses_flash_op"]


def _twin(flags, export_dir):
    example = os.path.join(REPO, "examples", "transformer",
                           "transformer_lm_torch.py")
    argv = [sys.executable, example, "--cluster_size", "4",
            "--vocab_size", str(LM["vocab_size"]), "--num_layers", "2",
            "--num_heads", str(LM["num_heads"]),
            "--head_dim", str(LM["head_dim"]), "--seq_len", str(LM_SEQ),
            "--batch_size", str(LM_BATCH), "--train_steps", str(LM_STEPS),
            "--log_steps", "5", "--export_dir", export_dir] + flags
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # the four nodes print to one stdout, their lines may interleave
    losses = re.findall(r"trained {} steps, loss ([0-9.]+)".format(
        LM_STEPS), proc.stdout)
    assert len(losses) == 4, proc.stdout[-2000:]
    return [float(x) for x in losses], time.perf_counter() - t0


def test_four_card_twin_fsdp2_seq2(four_cards, tmp_path):
    """The LM twin through the cluster, four nodes one card each, on
    ``--fsdp 2 --seq 2`` (ring attention, the Adam state sharded over
    fsdp, each seq group's rows pooled) at the flagship's widths, 2
    layers, fp32: the same losses as ``--data 4`` on the same streams, and
    the chief's export of the full params."""
    got, got_s = _twin(["--data", "1", "--fsdp", "2", "--seq", "2"],
                       str(tmp_path / "mesh"))
    want, want_s = _twin(["--data", "4"], str(tmp_path / "dp"))
    _report("twin_fsdp2_seq2", losses=got, data4_losses=want,
            wall_s=got_s, data4_wall_s=want_s)
    assert max(abs(a - want[0]) for a in got + want) <= LM_LOSS_TOL
    state, _ = checkpoint.load_model(str(tmp_path / "mesh"), validate=True)
    assert state["embed.weight"].shape == (LM["vocab_size"],
                                           LM["num_heads"] * LM["head_dim"])


# -- four cards: tensor, expert and pipeline parallelism -----------------------

# the MoE flash LM at full width (chip_smoke.py's MOE_CONFIG)
J2_MOE = dict(LM, mlp="moe", num_experts=8)
# (name, config, mesh, attention, layout, ep_mode, batch_axes): each held to
# one card's run of the same config on the same global batch
J2_CASES = (
    ("tp_tensor4", LM, {"tensor": 4}, "flash", "tp", "gspmd", None),
    ("tp_data2_tensor2", LM, {"data": 2, "tensor": 2}, "flash", "tp",
     "gspmd", None),
    ("ep_expert4", J2_MOE, {"expert": 4}, "flash", "ep", "shard_map",
     ("expert",)),
    ("ep_fsdp2_expert2", J2_MOE, {"data": 1, "fsdp": 2, "expert": 2},
     "flash", "fsdp_ep", "gspmd", None),
    ("moe_ring_data2_seq2", J2_MOE, {"data": 2, "seq": 2}, "ring", None,
     "gspmd", None),
)
# leaves whose params after the fp32 steps are held to one card's (a slice
# of each: the rows the host carries back)
J2_PROBES = ("blocks.0.attn.qkv.weight", "blocks.0.attn.proj.weight",
             "blocks.7.mlp_out.weight", "ln_f.weight", "embed.weight")
J2_MOE_PROBES = ("blocks.0.moe.w1", "blocks.7.moe.w2", "blocks.0.moe.b1",
                 "blocks.0.moe.router.weight")
# Adam moves a param by at most about lr a step, so two runs whose
# rounding differs can part by at most 2 x lr a step where a gradient is
# rounding noise; elsewhere they agree to fp32 rounding, which the 99.9th
# percentile of the differences shows (the qkv bias, whose key third has
# an exactly-zero gradient, is not probed)
J2_PARAM_BOUND = 2 * LM_STEPS * LM_LR
J2_PARAM_P999 = 1e-4
# gpipe over pipe 4: 2 of the flagship's blocks a stage, 4 microbatches of
# 2 rows, bf16 (the public contract's 2e-2 of the largest value)
GPIPE_MICRO = 4
# fp32, the MoE LM while its routing is one card's: each step's loss (the
# forward) and global gradient norm (the whole backward and every
# reduction, before Adam's per-leaf normalisation could hide a scale)
# within 1e-5 (relative) of one card's, at every step before the first
# token routed to another expert, and the losses of steps 1-4 whatever
# the routing (a four-card run read them within 8.6e-6 nats)
J2_HELD_RTOL = 1e-5
J2_MOE_HELD_STEPS = 4
# the MoE LM's probed leaves after these steps, gathered: Adam's update
# of the expert blocks (and their moments, at step 2) against one card's
J2_PROBE_STEPS = (1, 2)
# per expert, the median |difference| of a probed leaf: rounding while the
# routing agrees; a flipped token moves its experts' second Adam step by
# a few percent of lr; a skipped or misplaced update moves it by ~lr
J2_EXPERT_MEDIAN = 1e-6
J2_EXPERT_MEDIAN_FLIPPED = 1e-4
# a flip's witness: the first step's flipped tokens were near ties on one
# card (top-1 minus top-2 router probability; a typical token's is ~0.1)
J2_TIE_MARGIN = 1e-3


def _card(rank):
    return torch.device("cuda", rank)


def _init_of(config):
    model = transformer.build_transformer(**config)
    model.init_weights(torch.Generator().manual_seed(0))
    return dict(model.state_dict())


def _j2_layout(layout, model, init, mesh):
    from tensorflowonspark_torch.parallel import ep, fsdp, tp

    if layout == "tp":
        return tp.tp_param_shardings(init, mesh, views=model.flax_views())
    if layout == "ep":
        return ep.merge_ep_shardings({}, init, mesh)
    if layout == "fsdp_ep":
        return ep.merge_ep_shardings(fsdp.tree_shardings(init, mesh), init,
                                     mesh)
    return None


def _j2_trainer(config, init, device, attention, dtype, mesh=None,
                layout=None, ep_mode="gspmd", batch_axes=None):
    model = transformer.build_transformer(
        **config, attention=attention, mesh=mesh, dtype=dtype,
        ep_mode=ep_mode, ep_batch_axes=batch_axes)
    return train.Trainer(transformer.loss_fn(model), init,
                         functools.partial(torch.optim.Adam, lr=LM_LR),
                         batch_size=LM_BATCH, log_steps=LM_STEPS,
                         device=device, mesh=mesh,
                         param_sharding=_j2_layout(layout, model, init,
                                                   mesh),
                         batch_axes=batch_axes)


class _Routes(object):
    """While entered, each token's expert and router margin (its top-1
    minus top-2 probability) at every ``ep._route`` call, the routing that
    both MoE modes and every layer run through: :meth:`take` returns one
    step's ``(experts [L, G, S] int8, margins [L, G, S])``."""

    def __enter__(self):
        from tensorflowonspark_torch.parallel import ep

        self._ep, self._route, self._calls = ep, ep._route, []

        def recorded(x, logits, num_experts, capacity):
            with torch.no_grad():
                probs, experts = ep.route(logits, num_experts)[:2]
                top = probs.topk(2, dim=-1).values
                self._calls.append((experts.to(torch.int8),
                                    top[..., 0] - top[..., 1]))
            return self._route(x, logits, num_experts, capacity)

        ep._route = recorded
        return self

    def __exit__(self, *exc):
        self._ep._route = self._route

    def take(self):
        experts = torch.stack([e for e, _ in self._calls]).cpu().numpy()
        margins = torch.stack([m for _, m in self._calls]).float().cpu()
        self._calls = []
        return experts, margins.numpy()


def _j2_losses(trainer, mesh, batch_axes, config):
    """``_lm_losses`` at K = 1 with the global gradient norm of each step;
    for the MoE LM also each step's routing (:class:`_Routes`) and the
    probed leaves after ``J2_PROBE_STEPS`` (gathered; kept on rank 0)."""
    device, losses, norms = trainer.device, [], []
    moe = config.get("mlp") == "moe"
    out = {"routes": [], "margins": [], "step_probes": {}}
    rank0 = (not torch.distributed.is_initialized()
             or torch.distributed.get_rank() == 0)
    with _Routes() if moe else contextlib.nullcontext() as routes:
        for step in range(LM_STEPS):
            losses.append(trainer.step(*_device_batch(
                step, mesh, device, batch_axes))[0].item())
            norms.append(float(trainer._health_grad_norm))
            if not moe:
                continue
            experts, margins = routes.take()
            out["routes"].append(experts)
            out["margins"].append(margins)
            if step + 1 in J2_PROBE_STEPS:
                full = trainer.state.full_params()
                out["step_probes"][step + 1] = (_probes(full, config)
                                                if rank0 else None)
                del full
    if moe:
        out["routes"] = np.stack(out["routes"])
        out["margins"] = np.stack(out["margins"])
    return losses, norms, out


def _probes(params, config):
    names = J2_MOE_PROBES if config.get("mlp") == "moe" else J2_PROBES
    return {n: params[n].detach().float()[..., :256].cpu().numpy().copy()
            for n in names}


def _gpipe_case(rank, device):
    """``gpipe`` over pipe 4, 2 flash blocks a stage, bf16: the output and
    this stage's gradients against the 8 blocks in sequence on this card."""
    from tensorflowonspark_torch.parallel import pp

    mesh = mesh_mod.build_mesh({"pipe": 4}, keep_trivial_axes=True)
    lm = transformer.build_transformer(**LM, attention="flash",
                                       dtype="bfloat16")
    lm.init_weights(torch.Generator().manual_seed(0))
    blocks = lm.blocks.to(device)
    per = len(blocks) // 4

    def run_blocks(params, h, first):
        for i in range(per):
            prefix = "%d." % (first + i)
            h, _ = torch.func.functional_call(
                blocks[first + i], {n[len(prefix):]: v
                                    for n, v in params.items()
                                    if n.startswith(prefix)}, (h,))
        return h

    gen = torch.Generator().manual_seed(5)
    d_model = LM["num_heads"] * LM["head_dim"]
    h0 = torch.randn(LM_BATCH, LM_SEQ, d_model, generator=gen).to(
        device, torch.bfloat16)
    cot = torch.randn(LM_BATCH, LM_SEQ, d_model, generator=gen).to(
        device, torch.bfloat16)
    full = {n: p.detach() for n, p in blocks.named_parameters()}
    # stage s holds blocks s*per ... (s+1)*per - 1, renamed 0 ... per - 1
    stages = [{"%d.%s" % (i, n.split(".", 1)[1]): full[n]
               for n in full for i in range(per)
               if int(n.split(".", 1)[0]) == s * per + i}
              for s in range(4)]
    stage = mesh.get_local_rank("pipe")
    mine = {n: v.clone().requires_grad_()
            for n, v in stages[stage].items()}
    stacked = {n: v[None] for n, v in mine.items()}
    hs = h0.clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pp.gpipe(lambda p, h: run_blocks(p, h, 0), stacked,
                   pp.split_microbatches(hs, GPIPE_MICRO), mesh)
    out = out.reshape(hs.shape)
    # the output is replicated over pipe: each rank carries 1/4 of the loss
    grads = torch.autograd.grad((out.float() * cot.float()).sum() / 4,
                                [hs] + list(mine.values()))
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    dx = grads[0].clone()
    torch.distributed.all_reduce(dx, group=mesh_mod.group(mesh, "pipe"))
    # the reference: every block in order on this card
    ref = {n: v.clone().requires_grad_() for n, v in full.items()}
    hr = h0.clone().requires_grad_()
    h = hr
    for s in range(4):
        h = _seq_stage(blocks, ref, h, s * per, per)
    want = torch.autograd.grad((h.float() * cot.float()).sum(),
                               [hr] + [ref[n] for n in full
                                       if int(n.split(".", 1)[0]) // per
                                       == stage])

    def err(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    mine_names = [n for n in full if int(n.split(".", 1)[0]) // per == stage]
    return {"out": err(out, h), "dx": err(dx, want[0]),
            "dparams": max(err(g, w) for g, w in zip(grads[1:], want[1:])),
            "params_checked": len(mine_names), "seconds": pipe_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}


def _seq_stage(blocks, params, h, first, per):
    for i in range(first, first + per):
        prefix = "%d." % i
        h, _ = torch.func.functional_call(
            blocks[i], {n[len(prefix):]: v for n, v in params.items()
                        if n.startswith(prefix)}, (h,))
    return h


def _four_card_j2(rank):
    """Every J2 case on this rank: fp32 losses of 10 steps at K = 1 and
    K = 5, the params after them (probed leaves, gathered), the state
    bytes and the local expert shapes, and for the MoE LM each step's
    routing of this rank's rows and the probed leaves after steps 1 and 2;
    the bf16 steady step at K = 1 and 5 with peak memory and the
    collectives' device ms; then gpipe over pipe 4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = importlib.import_module("tensorflowonspark_torch.ops.flash_attention")
    device = _card(rank)
    inits = {}
    out = {}
    for name, config, spec, attention, layout, mode, axes in J2_CASES:
        key = config.get("mlp", "dense")
        if key not in inits:
            inits.clear()
            inits[key] = _init_of(config)
        init = inits[key]
        mesh = mesh_mod.build_mesh(spec, keep_trivial_axes=True)
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        tr = _j2_trainer(config, init, device, attention, "float32", mesh,
                         layout, mode, axes)
        losses, norms, routing = _j2_losses(tr, mesh, axes, config)
        # the rows this rank routes: its block over the model's batch axes
        index, count = mesh_mod.row_shard(mesh, tr.batch_axes)
        rows = LM_BATCH // count
        case = {"losses": losses, "grad_norms": norms,
                "routes": routing["routes"],
                "route_rows": (index * rows, (index + 1) * rows),
                "step_probes": routing["step_probes"],
                "state_bytes": _state_bytes(tr),
                "launches": [fa.fwd_launches, fa.bwd_dq_launches,
                             fa.bwd_dkv_launches],
                "sharded_leaves": (0 if tr.state.sharding is None
                                   else len(tr.state.sharding.names))}
        if config.get("mlp") == "moe":
            case["local_w1"] = list(tr.state.params[
                "blocks.0.moe.w1"].shape)
        full = tr.state.full_params()
        case["probes"] = _probes(full, config) if rank == 0 else None
        k1_params = {n: t.detach().clone() for n, t in full.items()}
        del tr, full
        tr = _j2_trainer(config, init, device, attention, "float32", mesh,
                         layout, mode, axes)
        case["k5_losses"] = _lm_losses(tr, mesh, k=5, batch_axes=axes)
        full = tr.state.full_params()
        case["k5_param_max_diff"] = max(
            (full[n] - t).abs().max().item() for n, t in k1_params.items())
        case["k5_graphs"] = len(tr._graphs)
        del k1_params, tr, full
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        tr = _j2_trainer(config, init, device, attention, "bfloat16", mesh,
                         layout, mode, axes)
        case["bf16_losses"] = _lm_losses(tr, mesh, batch_axes=axes)
        case["steady"] = _steady(tr, mesh, batch_axes=axes)
        torch.cuda.reset_peak_memory_stats(device)
        case["steady_k5"] = _steady(tr, mesh, k=5, batch_axes=axes)
        del tr
        torch.cuda.empty_cache()
        out[name] = case
    inits.clear()
    out["gpipe_pipe4"] = _gpipe_case(rank, device)
    return out


def _one_card_j2():
    """The one-card runs the J2 cases are held to: the dense and MoE flash
    LMs in fp32 (and the MoE LM with full attention, for ring) with their
    params after the steps (probed), the MoE runs' routing and probes
    after steps 1 and 2, the bf16 losses, the bf16 steady steps and state
    bytes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = _card(0)
    out = {}
    for key, config in (("dense", LM), ("moe", J2_MOE)):
        init = _init_of(config)
        for attention, dtype in (("flash", "float32"), ("full", "float32"),
                                 ("flash", "bfloat16")):
            if key == "dense" and attention == "full":
                continue
            tr = _j2_trainer(config, init, device, attention, dtype)
            (out[key, attention, dtype], out[key, attention, dtype,
                                             "norms"],
             routing) = _j2_losses(tr, None, None, config)
            if dtype == "float32":
                out[key, attention, "routing"] = routing
            if dtype == "float32" and attention == "flash":
                out[key, "probes"] = _probes(tr.state.params, config)
            if dtype == "bfloat16":
                torch.cuda.reset_peak_memory_stats(device)
                out[key, "steady"] = _steady(tr, None)
                torch.cuda.reset_peak_memory_stats(device)
                out[key, "steady_k5"] = _steady(tr, None, k=5)
                out[key, "state_bytes"] = _state_bytes(tr)
            del tr
            torch.cuda.empty_cache()
        del init
    return out


@pytest.fixture(scope="module")
def four_card_j2():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from tensorflowonspark_torch.ops import _build

    _build.build()        # once here; the ranks load it
    one = _one_card_j2()
    torch.cuda.empty_cache()
    ranks = run_world(_four_card_j2, 4, backend="nccl", timeout=1500)
    return one, ranks


def _param_diffs(got, want):
    diffs = np.concatenate([np.abs(got[n] - want[n]).ravel() for n in want])
    return {"max": float(diffs.max()),
            "p999": float(np.quantile(diffs, 0.999)),
            "median": float(np.median(diffs))}


def _expert_diffs(got, want):
    """Per probed leaf (dim 0 the expert): the largest |difference|, its
    99.9th percentile, and the largest of the experts' medians."""
    out = {}
    for name in want:
        d = np.abs(got[name] - want[name])
        out[name] = {"max": float(d.max()),
                     "p999": float(np.quantile(d, 0.999)),
                     "expert_median": float(max(np.median(d[e])
                                                for e in range(len(d))))}
    return out


def _route_flips(ranks, name, want):
    """The routing witness: per step, the tokens (over layers and ranks)
    whose expert differs from one card's on the same rows; the first such
    step (1-based, None when every step agrees) and one card's margins of
    that step's flipped tokens."""
    flips, first_margins = [0] * LM_STEPS, []
    for r in ranks:
        c = r[name]
        start, stop = c["route_rows"]
        ref = want["routes"][:, :, start:stop]
        assert c["routes"].shape == ref.shape, (c["routes"].shape, ref.shape)
        diff = c["routes"] != ref
        for step in range(LM_STEPS):
            flips[step] += int(diff[step].sum())
    first = next((i + 1 for i, f in enumerate(flips) if f), None)
    if first is not None:
        for r in ranks:
            start, stop = r[name]["route_rows"]
            diff = r[name]["routes"][first - 1] != want["routes"][
                first - 1, :, start:stop]
            first_margins += want["margins"][
                first - 1, :, start:stop][diff].tolist()
    return flips, first, first_margins


@pytest.mark.parametrize("name", [c[0] for c in J2_CASES])
def test_four_card_j2_lm_matches_one_card(four_cards, four_card_j2, name):
    """Tensor 4 and data 2 x tensor 2 (``tp_param_shardings``), the MoE LM
    under expert 4 (``shard_map``, rows over expert), data 1 x fsdp 2 x
    expert 2 (the moe/fsdp/ep dry run's layout) and data 2 x seq 2 (ring,
    each MoE layer routing the whole sequence), each against one card on
    the same global batch in fp32.  The dense LM over 10 steps: its losses
    within 1e-3 nats, as the J1 cases hold them, and its params (probed
    leaves, gathered) within Adam's bound with their 99.9th percentile
    within 1e-4; step 1's loss and global gradient norm within 1e-5.

    The MoE LM's top-1 router is discontinuous: once rounding in another
    order tips a near-tie, a token goes to another expert or loses its
    slot and the runs part (one card's own flash and full-attention runs,
    both exact, part by 1.5e-4 nats by step 10).  So each step's routing
    is recorded on both sides, and the case is held while it agrees:
    every step before the first flipped token has its loss and global
    gradient norm within 1e-5 (relative), and the losses of steps 1-4
    whatever the routing.  The first flip is the witness of the parting:
    its tokens were near ties on one card (margin within 1e-3).  Adam's
    update of the expert-sharded blocks and their moments is held on the
    probed leaves (``w1``, ``w2``, ``b1``, the router) after steps 1 and
    2: every expert's median difference within 1e-6 and the leaf within
    Adam's bound of 2 x lr a step (99.9th percentile within 1e-4 while the
    routing agrees; after a flip, the step-2 medians within 1e-4).  The
    10-step losses, params, bf16 losses, steady ms a step at K = 1 and 5,
    the collectives' device ms and peak memory are reported.  The flash
    kernels launched layers x steps on every rank."""
    one, ranks = four_card_j2
    config = [c for c in J2_CASES if c[0] == name][0]
    key = config[1].get("mlp", "dense")
    ref = "full" if config[3] == "ring" else "flash"
    want = one[key, ref, "float32"]
    want_norms = one[key, ref, "float32", "norms"]
    diffs = [_loss_diffs(r[name]["losses"], want) for r in ranks]
    case = ranks[0][name]
    params = _param_diffs(case["probes"], one[key, "probes"])
    witness = {}
    if key == "moe":
        routing = one[key, ref, "routing"]
        flips, first, margins = _route_flips(ranks, name, routing)
        probes = {step: _expert_diffs(case["step_probes"][step],
                                      routing["step_probes"][step])
                  for step in J2_PROBE_STEPS}
        witness = {"flips_by_step": flips, "first_flip_step": first,
                   "first_flip_margins": sorted(margins)[:16],
                   "first_flip_max_margin": max(margins, default=None),
                   "step_probe_diffs": probes,
                   "loss_rel_diff_by_step": [
                       max(abs(r[name]["losses"][i] - want[i]) / abs(want[i])
                           for r in ranks) for i in range(LM_STEPS)],
                   "grad_norm_rel_diff_by_step": [
                       max(abs(r[name]["grad_norms"][i] - want_norms[i])
                           / want_norms[i] for r in ranks)
                       for i in range(LM_STEPS)]}
    _report(name, losses=case["losses"], one_card_losses=want,
            max_loss_diff=max(max(d) for d in diffs), param_diffs=params,
            grad_norms=[r[name]["grad_norms"] for r in ranks],
            one_card_grad_norms=want_norms,
            state_bytes=[r[name]["state_bytes"] for r in ranks],
            one_card_state_bytes=one[key, "state_bytes"],
            bf16_loss_diff=_loss_diffs(case["bf16_losses"],
                                       one[key, "flash", "bfloat16"]),
            steady=case["steady"], steady_k5=case["steady_k5"],
            one_card_steady=one[key, "steady"],
            one_card_steady_k5=one[key, "steady_k5"],
            launches=case["launches"], local_w1=case.get("local_w1"),
            sharded_leaves=case["sharded_leaves"], **witness)
    for r in ranks:
        assert r[name]["losses"][0] == pytest.approx(want[0],
                                                     rel=J2_HELD_RTOL)
        assert r[name]["grad_norms"][0] == pytest.approx(
            want_norms[0], rel=J2_HELD_RTOL)
    if key == "dense":
        assert all(max(d) <= LM_LOSS_TOL for d in diffs), diffs
        assert params["max"] <= J2_PARAM_BOUND and (
            params["p999"] <= J2_PARAM_P999), params
    else:
        held = LM_STEPS if first is None else first - 1
        for r in ranks:
            got = r[name]
            for i in range(LM_STEPS):
                if i < max(held, J2_MOE_HELD_STEPS):
                    assert got["losses"][i] == pytest.approx(
                        want[i], rel=J2_HELD_RTOL), (i + 1, witness)
                if i < held:
                    assert got["grad_norms"][i] == pytest.approx(
                        want_norms[i], rel=J2_HELD_RTOL), (i + 1, witness)
        if first is not None:
            assert max(margins) <= J2_TIE_MARGIN, witness
        for step in J2_PROBE_STEPS:
            agreed = first is None or first > step
            for leaf, d in probes[step].items():
                assert d["max"] <= 2 * step * LM_LR, (step, leaf, d)
                assert d["expert_median"] <= (
                    J2_EXPERT_MEDIAN if agreed or step == 1
                    else J2_EXPERT_MEDIAN_FLIPPED), (step, leaf, d)
                if agreed:
                    assert d["p999"] <= J2_PARAM_P999, (step, leaf, d)
    expected = LM["num_layers"] * LM_STEPS
    if config[3] == "flash":
        assert all(r[name]["launches"] == [expected] * 3 for r in ranks)


@pytest.mark.parametrize("name", [c[0] for c in J2_CASES])
def test_four_card_j2_k5_equals_k1(four_cards, four_card_j2, name):
    """K = 5 under every J2 case: the all-reduces of the split heads and
    MLP, the all-to-alls of ``moe_ffn``, the grouped gradient collectives
    captured in one graph; the losses at steps 5 and 10 within 1e-3 nats
    and the params within 1e-5 of K = 1's."""
    _, ranks = four_card_j2
    case = ranks[0][name]
    _report(name + "_k5", k5_losses=case["k5_losses"],
            k1_losses=case["losses"],
            param_max_diff=[r[name]["k5_param_max_diff"] for r in ranks],
            graphs=case["k5_graphs"])
    for r in ranks:
        c = r[name]
        assert c["k5_graphs"] == 1
        assert max(_loss_diffs(c["k5_losses"], c["losses"])) <= LM_LOSS_TOL
        assert c["k5_param_max_diff"] <= 1e-5


def test_four_card_j2_expert_state_below_one_card(four_cards, four_card_j2):
    """Under expert 4 each card holds 2 of the 8 experts of every MoE layer
    and their Adam moments: its params plus optimizer state below one
    card's (the 604 M-param MoE LM)."""
    one, ranks = four_card_j2
    for r in ranks:
        assert r["ep_expert4"]["local_w1"][0] == J2_MOE["num_experts"] // 4
        assert r["ep_expert4"]["state_bytes"] < one["moe", "state_bytes"]
        assert r["ep_fsdp2_expert2"]["state_bytes"] < one[
            "moe", "state_bytes"]


def test_four_card_j2_gpipe_matches_sequential(four_cards, four_card_j2):
    """``gpipe`` over pipe 4 (2 of the flagship's flash blocks a stage, 4
    microbatches, bf16): the output on every rank and each stage's
    gradients, and the input's, against the 8 blocks in sequence on one
    card, within 2e-2 of the largest value."""
    _, ranks = four_card_j2
    _report("gpipe_pipe4", **{"rank%d" % i: r["gpipe_pipe4"]
                              for i, r in enumerate(ranks)})
    for r in ranks:
        g = r["gpipe_pipe4"]
        assert max(g["out"], g["dx"], g["dparams"]) <= ATTN_TOL, g


def test_four_card_j2_twin_fsdp2_expert2_shard_map(four_cards, tmp_path):
    """The LM twin through the cluster, four nodes one card each, on
    ``--fsdp 2 --expert 2 --mlp moe --ep_mode shard_map`` (the FSDP tree
    with the experts over expert, rows over fsdp and expert) at the
    flagship's widths, 2 layers, fp32: the same losses as ``--data 4 --mlp
    moe`` on the same streams, and the chief's export of the full params,
    every expert in it."""
    got, got_s = _twin(["--data", "1", "--fsdp", "2", "--expert", "2",
                        "--mlp", "moe", "--ep_mode", "shard_map"],
                       str(tmp_path / "mesh"))
    want, want_s = _twin(["--data", "4", "--mlp", "moe"],
                         str(tmp_path / "dp"))
    _report("twin_fsdp2_expert2_shard_map", losses=got, data4_losses=want,
            wall_s=got_s, data4_wall_s=want_s)
    assert max(abs(a - want[0]) for a in got + want) <= LM_LOSS_TOL
    state, _ = checkpoint.load_model(str(tmp_path / "mesh"), validate=True)
    assert state["blocks.0.moe.w1"].shape[0] == 8
