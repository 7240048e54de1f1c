"""K steps per dispatch on the card: ``Trainer.multi_step`` as replays of
a captured CUDA graph against K eager steps, the kernels' launch counters
under replay against the kernels the profiler saw the card execute, an
optimizer made with ``capturable=False``, restoring state into a trainer
that captured, a capture while the infeed's prefetch thread pins memory,
grouped batches stacked on the card, a capture that fails, and captures of
a step with ``accum_steps=2`` and of the ``remat=True`` LM.

Marked ``cuda``; each test skips with a reason where no CUDA card is
present.  No jax here (the machine with the card has none), so run it with
``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graphs_cuda.py
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import checkpoint, train
from tensorflowonspark_torch.models import transformer
from tensorflowonspark_torch.parallel.infeed import ShardedFeed

fa = importlib.import_module("tensorflowonspark_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda

# a 2-layer flash LM: head_dim 64, so the fp32 kernels take it unpadded
CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=64,
           max_seq_len=128, attention="flash")
SEQ, BATCH, K = 128, 4, 5
# graph against eager, the same kernels, cuBLAS calls and (capturable)
# optimizer arithmetic on the same card: fp32 to 1e-5.  bf16 compute (fp32
# params): a last-bit difference can flip one bf16 rounding, so the loss is
# held to 1e-2 nats and the params to 2e-3, two Adam steps of lr 1e-3.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2e-3)}
OPTIMIZERS = {"adam": functools.partial(torch.optim.Adam, lr=1e-3),
              "sgd_momentum": functools.partial(torch.optim.SGD, lr=0.1,
                                                momentum=0.9)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _init(dtype="float32", **model_kwargs):
    model = transformer.build_transformer(**CFG, dtype=dtype, **model_kwargs)
    model.init_weights(torch.Generator().manual_seed(0))
    return model, dict(model.state_dict())


def _trainer(device, dtype="float32", optimizer="adam", model_kwargs=None,
             **kwargs):
    model, init = _init(dtype, **(model_kwargs or {}))
    return train.Trainer(
        transformer.loss_fn(model), init, OPTIMIZERS[optimizer],
        compute_dtype=getattr(torch, dtype), batch_size=BATCH,
        log_steps=1000, device=device, **kwargs)


def _tokens(seed, n=BATCH):
    offs = np.random.default_rng(seed).integers(0, CFG["vocab_size"], (n, 1))
    return ((np.arange(SEQ)[None] + offs) % CFG["vocab_size"]).astype(
        np.int32)


def _group(seed, k=K, device="cuda"):
    tokens = np.stack([_tokens(seed * 100 + i) for i in range(k)])
    return ({"tokens": torch.from_numpy(tokens).to(device)},
            torch.ones(k, BATCH, device=device))


def _params(tr):
    return {k: v.detach().float().cpu() for k, v in tr.state.params.items()}


def _eager(tr, stack, masks):
    """The group as K eager steps: per-step losses."""
    return [tr.step({"tokens": stack["tokens"][i]}, masks[i])[0].item()
            for i in range(masks.shape[0])]


# the key bias of the qkv projection has a zero gradient in exact
# arithmetic, so Adam turns rounding noise of either sign into steps of up
# to about lr (the standing difference tests/test_torch_train.py holds):
# that slice is held to steps x lr x 2
KEY_BIAS_LR_STEPS = 2 * 1e-3


def _close(got, want, atol, what, steps=0):
    features = CFG["num_heads"] * CFG["head_dim"]
    for name, t in want.items():
        g = got[name]
        if name.endswith("attn.qkv.bias") and steps:
            key = slice(features, 2 * features)
            diff = (g[key] - t[key]).abs().max().item()
            assert diff <= steps * KEY_BIAS_LR_STEPS, (what, name, diff)
            g, t = torch.cat([g[:features], g[2 * features:]]), torch.cat(
                [t[:features], t[2 * features:]])
        diff = (g - t).abs().max().item()
        assert diff <= atol, "{} {}: {}".format(what, name, diff)


@pytest.mark.parametrize("dtype,optimizer", [
    ("float32", "adam"), ("float32", "sgd_momentum"), ("bfloat16", "adam")])
def test_graph_replays_equal_eager_steps(card, dtype, optimizer):
    """Two groups of K: the first warms up (2 eager steps on the capture
    stream), captures and replays; the second only replays.  Per-step
    losses (from the writer's dense curve) and params equal K eager steps
    a group."""
    loss_tol, param_tol = TOL[dtype]
    eager = _trainer(card, dtype, optimizer)
    want = []
    groups = [_group(seed) for seed in (1, 2)]
    for stack, masks in groups:
        want += _eager(eager, stack, masks)
    curve = _LossCurve()
    graphed = _trainer(card, dtype, optimizer, summary_writer=curve)
    for stack, masks in groups:
        last = graphed.multi_step(stack, masks)
    graphed.history.on_train_end(None)
    assert graphed.state.step == eager.state.step == 2 * K
    assert len(graphed._graphs) == 1
    got = [loss for _, loss in sorted(curve.losses.items())]
    np.testing.assert_allclose(got, want, rtol=0, atol=loss_tol)
    assert abs(last.item() - want[-1]) <= loss_tol
    _close(_params(graphed), _params(eager), param_tol, "params",
           steps=2 * K if optimizer == "adam" else 0)
    snap = graphed.counters_snapshot()
    assert snap["train_compile_us_max"] > 0
    assert snap["train_steps_per_call_max"] == K


class _LossCurve(object):
    """SummaryWriter stand-in keeping the per-step loss curve."""

    def __init__(self):
        self.losses = {}

    def add_scalars(self, scalars, step):
        if "loss" in scalars:
            self.losses[step] = scalars["loss"]

    def flush(self):
        pass


# counter name -> the name fragment of its kernels (fp32 and bf16 variants)
KERNEL_NAMES = {"fwd_launches": "flash_fwd_",
                "bwd_dq_launches": "flash_bwd_dq_",
                "bwd_dkv_launches": "flash_bwd_dkv_"}


def _device_launches(fn):
    """Run ``fn`` under ``torch.profiler`` and count the flash kernels the
    card executed, by counter name: what the device did, whether a wrapper
    launched the kernel or a graph replay did."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for event in prof.key_averages():
        if not str(event.device_type).endswith("CUDA"):
            continue
        for name, fragment in KERNEL_NAMES.items():
            if fragment in event.key:
                counts[name] += event.count
    return counts


def test_launch_counters_advance_by_layers_per_step(card):
    """A replay runs each flash kernel once a layer, as an eager step
    does; the capture itself runs nothing.  The counters (which a replay
    advances by the launches its capture recorded) equal the kernels the
    profiler saw the card execute: the first group's 2 eager warm-ups,
    its capture and 3 replays, the second group's 5 replays, a single."""
    tr = _trainer(card)
    layers = CFG["num_layers"]
    for group in (1, 2):
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        executed = _device_launches(lambda: tr.multi_step(*_group(group)))
        want = dict.fromkeys(KERNEL_NAMES, layers * K)
        assert fa.launch_counts() == want, group
        assert executed == want, group
    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    executed = _device_launches(
        lambda: tr.repeat_step({"tokens": _tokens(9)}, None, 1))
    assert fa.launch_counts() == executed == dict.fromkeys(KERNEL_NAMES,
                                                           layers)


def test_explicit_capturable_false_is_kept_and_refuses_capture(card):
    """An optimizer factory that passes capturable=False keeps it: eager
    steps run as it says, and a K-step dispatch raises before its first
    step instead of arming it."""
    model, init = _init()
    tr = train.Trainer(
        transformer.loss_fn(model), init,
        functools.partial(torch.optim.Adam, lr=1e-3, capturable=False),
        batch_size=BATCH, log_steps=1000, device=card)
    assert [g["capturable"] for g in tr.state.optimizer.param_groups] == [
        False]
    tr.step({"tokens": _tokens(1)})
    with pytest.raises(RuntimeError, match="capturable=False"):
        tr.multi_step(*_group(2))
    assert tr.state.step == 1 and not tr._graphs
    default = _trainer(card)
    assert [g["capturable"] for g in default.state.optimizer.param_groups] \
        == [True]


def test_restore_after_capture_steps_like_a_fresh_trainer(card, tmp_path):
    """A checkpoint restored into a trainer that captured (its graph reads
    the optimizer state at fixed addresses, which load_state_dict fills in
    place) takes the same next group as a fresh trainer restored from the
    same checkpoint."""
    tr = _trainer(card)
    ckpt = checkpoint.CheckpointManager(str(tmp_path), save_interval_steps=0)
    tr.multi_step(*_group(1))
    ckpt.maybe_save(tr.state.step, tr.state, force=True)
    tr.multi_step(*_group(2))                 # moves past the checkpoint
    ckpt.wait_until_finished()
    assert tr.restore_latest(ckpt) == K and tr.state.step == K
    fresh = _trainer(card)
    assert fresh.restore_latest(ckpt) == K
    stack, masks = _group(3)
    got = tr.multi_step(stack, masks)
    want = fresh.multi_step(stack, masks)     # warms up, captures, replays
    assert abs(got.item() - want.item()) <= 1e-5
    _close(_params(tr), _params(fresh), 1e-5, "params", steps=K)
    ckpt.close()


class _PinningFeed(object):
    """A feed of token rows whose batches the prefetch thread pins while
    the trainer warms up and captures."""

    def __init__(self, n_batches, ballast=1 << 20):
        self.rows = np.stack([_tokens(500 + i, 1)[0]
                              for i in range(n_batches * BATCH)])
        self.ballast = ballast
        self.pos, self.done = 0, False

    def next_batch_arrays(self, n):
        out = self.rows[self.pos:self.pos + n]
        self.pos += len(out)
        self.done = len(out) < n or self.pos >= len(self.rows)
        # a large float column: every batch pins a few MB more
        pad = np.zeros((len(out), self.ballast), np.float32)
        return {"tokens": out, "ballast": pad}, len(out)

    def should_stop(self):
        return self.done

    def interrupt(self):
        pass

    def terminate(self):
        pass


def test_capture_while_the_prefetch_thread_pins_memory(card):
    """fit_feed(steps_per_call=K) from a ShardedFeed whose prefetch thread
    keeps pinning host memory and copying on its side stream while the
    step is captured (thread-local capture mode): the capture succeeds and
    the params equal the K = 1 run's."""
    def loss_fn(model):
        lm = transformer.loss_fn(model)
        return lambda params, batch, mask: lm(
            params, {"tokens": batch["tokens"]}, mask)

    results = {}
    for k in (1, K):
        model, init = _init()
        tr = train.Trainer(loss_fn(model), init, OPTIMIZERS["adam"],
                           batch_size=BATCH, log_steps=1000, device=card)
        feed = ShardedFeed(_PinningFeed(3 * K), BATCH, prefetch=6,
                           device=card)
        stats = tr.fit_feed(feed, steps_per_call=k)
        results[k] = (tr, stats)
    tr1, _ = results[1]
    trk, stats = results[K]
    assert trk.state.step == tr1.state.step == 3 * K
    assert stats["megastep"]["steps_per_call"] == K
    assert len(trk._graphs) == 1
    _close(_params(trk), _params(tr1), 1e-5, "params", steps=3 * K)


def test_grouped_batches_on_card_match_cpu(card):
    """Device assembly stacks the copied batches on the prefetch thread's
    side stream; the groups and singles equal the CPU path's."""
    def groups(device):
        feed = ShardedFeed(_PinningFeed(7, ballast=4), BATCH, prefetch=2,
                           device=device)
        return [(kind, {n: t.cpu().clone() for n, t in b.items()},
                 m.cpu().clone()) for kind, b, m in feed.grouped_batches(3)]

    want, got = groups("cpu"), groups(card)
    assert [g[0] for g in got] == [w[0] for w in want] == \
        ["multi", "multi", "single"]
    for (_, gb, gm), (_, wb, wm) in zip(got, want):
        assert torch.equal(gm, wm)
        for name in wb:
            assert torch.equal(gb[name], wb[name]), name


def _failed_capture():
    """In a process of its own: a step that reads a value back to the host
    cannot be captured.  The warm-up steps run, the capture raises, nothing
    falls back to eager steps.  Prints the outcome."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model, init = _init()
    lm = transformer.loss_fn(model)

    def syncing_loss(params, batch, mask):
        loss, aux = lm(params, batch, mask)
        if loss.item() != loss.item():     # a host readback each step
            raise AssertionError("nan")
        return loss, aux

    tr = train.Trainer(syncing_loss, init, OPTIMIZERS["adam"],
                       batch_size=BATCH, device="cuda:0")
    try:
        tr.multi_step(*_group(1))
    except RuntimeError as err:
        print("RAISED", "CUDA graph" in str(err), tr.state.step,
              len(tr._graphs))
        return
    print("NOT RAISED")


def test_a_failed_capture_raises(card):
    """Run in a child process: a failed capture leaves that process's CUDA
    random-number state mid-capture, so the error is the end of it."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path[:0] = [{!r}, {!r}]; "
         "import test_torch_graphs_cuda as t; t._failed_capture()".format(
             here, os.path.dirname(here))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-4:] == [
        "RAISED", "True", str(train.GRAPH_WARMUP_STEPS), "0"], proc.stdout


# per step: accum_steps=2 runs every kernel once a layer per micro-batch;
# remat runs the forward again in the backward
OPTIONS = {
    "accum2": ({"accum_steps": 2}, {}, (2, 2, 2)),
    "remat": ({}, {"remat": True}, (2, 1, 1)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_accum_and_remat_captures_equal_eager_steps(card, option):
    """A group of 4 (2 eager warm-ups, a capture, 2 replays) with the
    option gives the params of 4 eager steps with it, to 1e-6 (the same
    kernels, cuBLAS calls and optimizer arithmetic on the same card); the
    launches the capture recorded, per step, times 4 equal the flash
    kernels the profiler saw the card execute."""
    trainer_kwargs, model_kwargs, per_layer = OPTIONS[option]
    layers, k = CFG["num_layers"], 4
    stack, masks = _group(7, k=k)

    def make():
        return _trainer(card, optimizer="sgd_momentum",
                        model_kwargs=model_kwargs, **trainer_kwargs)

    eager = make()
    _eager(eager, stack, masks)
    graphed = make()
    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    executed = _device_launches(lambda: graphed.multi_step(stack, masks))
    per_step = {name: n * layers
                for name, n in zip(KERNEL_NAMES, per_layer)}
    (graph,) = graphed._graphs.values()
    assert graph.launches == per_step
    assert fa.launch_counts() == executed == {
        name: n * k for name, n in per_step.items()}
    _close(_params(graphed), _params(eager), 1e-6, option)
