"""The port's parallel paths on several cards: the Trainer's NCCL
gradient all-reduce, the ResNet's BatchNorm statistics of the global batch,
and the cluster's NCCL world (two cards); the flagship LM at full width
under FSDP, ring and Ulysses sequence parallelism, Ulysses on the flash
kernels, K = 5 under FSDP and the LM twin through the cluster on a
``--fsdp 2 --seq 2`` mesh (four cards).

Marked ``cuda``; each test skips with a reason where fewer than two (four)
CUDA cards are present.  No jax here (the machine with the cards has none),
so run it with ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_nccl_cuda.py

With ``-s`` each four-card case prints one JSON line (``"case": ...``):
its losses against one card's, its per-card state bytes, and its steady
ms/step (bf16, the flagship's dtype) with the spread over repeated runs
and the device-idle share from ``torch.profiler``.
"""

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


def _lm_block(x, mesh):
    """This rank's block of a global ``[B, S]`` (or ``[B]``) array: its rows
    of the data-like axes, its chunk of the seq axis."""
    if mesh is None:
        return x
    index, count = mesh_mod.row_shard(mesh)
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


def _device_batch(step, mesh, device):
    return ({"tokens": torch.from_numpy(_lm_block(_lm_tokens(step),
                                                  mesh)).to(device)},
            torch.from_numpy(_lm_block(np.ones(LM_BATCH, np.float32),
                                       mesh)).to(device))


def _lm_losses(trainer, mesh, k=1):
    """``LM_STEPS`` steps from the stream, as single steps or groups of
    ``k`` (``multi_step``); the loss after each step (each group's last
    at K > 1)."""
    device, losses = trainer.device, []
    for start in range(0, LM_STEPS, k):
        batches = [_device_batch(start + i, mesh, device) for i in range(k)]
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


def _steady(trainer, mesh, k=1):
    """bf16 ms/step after 2 warm-up dispatches: ``TIME_REPEATS`` runs of
    ``TIME_STEPS`` steps (``k`` a dispatch), host clock between two
    synchronisations, then the device-busy share of ``PROFILE_STEPS``
    steps from ``torch.profiler`` (CUDA kernels; the busy sum over the
    profiled wall time)."""
    from torch.profiler import ProfilerActivity, profile

    device = trainer.device
    batches = [_device_batch(i, mesh, device) for i in range(TIME_STEPS)]

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
    return {"ms_per_step": sorted(runs)[len(runs) // 2],
            "runs_ms_per_step": runs, "spread_ms": max(runs) - min(runs),
            "device_idle_share": 1.0 - busy / wall if busy else None,
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
