"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips with a reason where no CUDA card is
present.  No jax here (the machine with the card has none), so run it with
``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("tensorflowonspark_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda

# O: fp32 kernels sum in another order than the plain einsum (1e-4 covers
# it at |O| <= 4); bf16 outputs round to 8 mantissa bits (2e-2 covers one
# bf16 step at |O| < 4).  L is fp32 on both sides from the same inputs.
O_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
L_TOL = 5e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _qkv(shape, dtype, device, seed=0, fused=False):
    """q, k, v from a numpy seed; ``fused`` makes them strided views of one
    [B, S, 3, H, D] buffer, as the transformer's qkv projection gives."""
    b, s, h, d = shape
    x = np.random.default_rng(seed).standard_normal((b, s, 3, h, d))
    t = torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=dtype)
    if fused:
        return t.unbind(2)
    return tuple(t[:, :, i].contiguous() for i in range(3))


@pytest.mark.parametrize("shape,dtype,causal,fused", [
    ((2, 256, 4, 64), torch.float32, True, False),
    ((2, 256, 4, 64), torch.float32, False, False),
    ((2, 256, 4, 128), torch.float32, True, False),
    ((2, 256, 4, 128), torch.bfloat16, False, False),
    ((1, 1024, 2, 64), torch.bfloat16, True, True),
    ((1, 96, 2, 64), torch.float32, True, False),    # ragged last tile
    ((2, 256, 4, 32), torch.bfloat16, True, False),  # head_dim 32: wgmma
    ((2, 256, 4, 32), torch.float32, False, False),  # head_dim 32: padded
    ((2, 256, 4, 128), torch.bfloat16, True, False),
    ((1, 96, 2, 64), torch.bfloat16, True, False),   # ragged, tensor cores
    ((2, 256, 4, 64), torch.bfloat16, False, False),
    ((8, 1024, 16, 64), torch.bfloat16, True, True),  # the training shape
])
def test_kernel_matches_plain(card, shape, dtype, causal, fused):
    q, k, v = _qkv(shape, dtype, card, fused=fused)
    scale = 1.0 / np.sqrt(shape[-1])
    before = fa.fwd_launches
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert fa.fwd_launches == before + 1
    want_out, want_lse = fa.flash_attention_plain(q, k, v, causal, scale)
    assert out.dtype == dtype and out.shape == q.shape
    assert lse.shape == (shape[0] * shape[2], shape[1])
    assert (out.float() - want_out).abs().max().item() < O_TOL[dtype]
    assert (lse - want_lse).abs().max().item() < L_TOL


def test_public_op_uses_kernel(card):
    q, k, v = _qkv((2, 128, 2, 64), torch.bfloat16, card, seed=1)
    before = fa.fwd_launches
    with torch.inference_mode():
        got = fa.flash_attention(q, k, v, causal=True)
    assert fa.fwd_launches == before + 1
    want, _ = fa.flash_attention_plain(q, k, v, causal=True)
    assert (got.float() - want).abs().max().item() < O_TOL[torch.bfloat16]


# dQ, dK, dV: each is a sum over up to S products whose terms reach a few
# units; fp32 kernels sum in another order than the plain einsums (1e-4 of
# the largest gradient covers it), bf16 gradients round to 8 mantissa bits
# (1e-2 of the largest is about two bf16 steps).  delta is fp32 on both
# sides from the same O and dO.
G_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("shape,dtype,causal,fused", [
    ((2, 256, 4, 64), torch.float32, True, False),
    ((2, 256, 4, 64), torch.float32, False, False),
    ((2, 256, 4, 128), torch.bfloat16, True, False),
    ((2, 256, 4, 128), torch.float32, False, False),
    ((1, 1024, 2, 64), torch.bfloat16, True, True),
    ((1, 96, 2, 64), torch.float32, True, False),    # ragged last tile
    ((2, 256, 4, 32), torch.bfloat16, True, False),  # head_dim 32
    ((2, 256, 4, 32), torch.float32, False, False),
    ((1, 96, 2, 64), torch.bfloat16, True, False),   # ragged, tensor cores
    ((2, 256, 4, 64), torch.bfloat16, False, False),
    ((1, 96, 2, 64), torch.bfloat16, False, False),  # ragged, not causal
    ((8, 1024, 16, 64), torch.bfloat16, True, True),  # the training shape
])
def test_backward_kernels_match_plain(card, shape, dtype, causal, fused):
    q, k, v = _qkv(shape, dtype, card, fused=fused)
    (g,) = _qkv(shape, dtype, card, seed=1)[:1]
    scale = 1.0 / np.sqrt(shape[-1])
    out, lse = fa._flash_fwd_cuda(q, k, v, scale, causal)
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    dq, delta = fa._flash_bwd_dq_cuda(q, k, v, out, lse, g, scale, causal)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (before[0] + 1,
                                                         before[1] + 1)
    want_dq, want_delta = fa.flash_bwd_dq_plain(q, k, v, out, lse, g, causal,
                                                scale)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, g, lse, want_delta,
                                              causal, scale)
    assert (delta - want_delta).abs().max().item() <= 1e-4 * max(
        want_delta.abs().max().item(), 1.0)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == q.shape
        limit = G_TOL[dtype] * want.abs().max().item()
        assert (got.float() - want).abs().max().item() <= limit


def test_autograd_uses_backward_kernels(card):
    """The public op's backward launches both kernels once and gives the
    plain version's gradients, through a fused qkv buffer."""
    shape = (2, 128, 2, 64)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (shape[0], shape[1], 3) + shape[2:]).astype(np.float32)).to(card)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        shape).astype(np.float32)).to(card)
    qkv = x.clone().requires_grad_()
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    out = fa.flash_attention(*qkv.unbind(2), causal=True)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (before[0] + 1,
                                                         before[1] + 1)
    q, k, v = x.unbind(2)
    o, lse = fa.flash_attention_plain(q, k, v, causal=True)
    want = torch.stack(fa.flash_attention_bwd_plain(q, k, v, o, lse, w,
                                                    True), dim=2)
    limit = G_TOL[torch.float32] * want.abs().max().item()
    assert (qkv.grad - want).abs().max().item() <= limit


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "stride", "align"])
def test_kernel_refuses(card, bad):
    shape, dtype = (1, 64, 2, 64), torch.float32
    if bad == "head_dim":
        shape = (1, 64, 2, 48)
    if bad == "dtype":
        dtype = torch.float16
    q, k, v = _qkv(shape, dtype, card)
    if bad == "stride":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)
    if bad == "align":   # a contiguous view 4 bytes off a 16-byte boundary
        q = torch.zeros(q.numel() + 1, device=card)[1:].view(q.shape)
    with pytest.raises(ValueError, match="align" if bad == "align" else None):
        fa._flash_fwd_cuda(q, k, v, 0.125, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_public_op_head_dim_32(card, dtype):
    """head_dim 32 (the JAX LM example's default) runs forward and backward
    on CUDA tensors through the public op, and matches the plain version."""
    shape = (2, 128, 2, 32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (shape[0], shape[1], 3) + shape[2:]).astype(np.float32)).to(card)
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        shape).astype(np.float32)).to(card, dtype)
    qkv = x.to(dtype).requires_grad_()
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    out = fa.flash_attention(*qkv.unbind(2), causal=True)
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    q, k, v = x.to(dtype).unbind(2)
    o, lse = fa.flash_attention_plain(q, k, v, causal=True)
    assert (out.float() - o).abs().max().item() < O_TOL[dtype]
    want = torch.stack(fa.flash_attention_bwd_plain(q, k, v, out, lse, w,
                                                    True), dim=2)
    limit = G_TOL[dtype] * want.abs().max().item()
    assert qkv.grad.dtype == dtype
    assert (qkv.grad.float() - want).abs().max().item() <= limit


# a process with no Python op: the C++ registration (csrc/flash_ops.cpp,
# argv[1]) runs the forward on each case of argv[2] on the card and saves
# the outputs and its launch count to argv[3]
_BINDING_CHILD = """
import ctypes, sys
import torch
torch.ops.load_library(sys.argv[1])
lib = ctypes.CDLL(sys.argv[1])
lib.tfos_flash_fwd_launches.restype = ctypes.c_longlong
outs = []
for qkv, fused, scale, causal in torch.load(sys.argv[2]):
    qkv = qkv.cuda()
    q, k, v = (qkv.unbind(2) if fused else
               [qkv[:, :, i].contiguous() for i in range(3)])
    outs.append([t.cpu() for t in torch.ops.tfos.flash_fwd(q, k, v, scale,
                                                           causal)])
torch.save({"outs": outs, "launches": lib.tfos_flash_fwd_launches()},
           sys.argv[3])
"""


def test_cpp_binding_matches_python_op(card, tmp_path):
    """The C++ binding the runner loads launches the same kernel as the
    Python op: bit for bit at the serve shape (fused q, k, v views), at
    head_dim 32 and 128, and for fp32 head_dim 32 (padded to 64 by both),
    one launch a call."""
    import subprocess
    import sys

    from tensorflowonspark_torch.ops import _build

    lib = _build.build_native(["flash_ops"])["flash_ops"]["path"]
    cases = []
    for shape, dtype, causal, fused in [
            ((4, 1024, 16, 64), torch.bfloat16, True, True),
            ((2, 256, 4, 32), torch.bfloat16, True, False),
            ((2, 256, 4, 128), torch.bfloat16, False, False),
            ((2, 256, 4, 32), torch.float32, True, False)]:
        b, s, h, d = shape
        x = np.random.default_rng(d).standard_normal((b, s, 3, h, d))
        cases.append((torch.from_numpy(x.astype(np.float32)).to(dtype),
                      fused, 1.0 / d ** 0.5, causal))
    src, dst = str(tmp_path / "cases.pt"), str(tmp_path / "outs.pt")
    torch.save(cases, src)
    proc = subprocess.run([sys.executable, "-c", _BINDING_CHILD, lib, src,
                           dst], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(dst)
    assert got["launches"] == len(cases)
    for (qkv, fused, scale, causal), (o, lse) in zip(cases, got["outs"]):
        qkv = qkv.to(card)
        q, k, v = (qkv.unbind(2) if fused else
                   [qkv[:, :, i].contiguous() for i in range(3)])
        want_o, want_lse = torch.ops.tfos.flash_fwd(q, k, v, scale, causal)
        assert torch.equal(o, want_o.cpu()) and torch.equal(
            lse, want_lse.cpu())


class _RowFeed(object):
    """Columnar rows served like a DataFeed (``next_batch_arrays``):
    ``should_stop`` turns true once a read asked for more rows than were
    left."""

    def __init__(self, rows):
        self.rows, self.pos, self.done = rows, 0, False

    def next_batch_arrays(self, n):
        out = self.rows[self.pos:self.pos + n]
        self.pos += len(out)
        self.done = len(out) < n
        return out, len(out)

    def should_stop(self):
        return self.done

    def interrupt(self):
        pass

    def terminate(self):
        pass


def test_eager_step_holds_the_capture_lock(card):
    """On the card an eager Trainer step runs under
    ``profiling.cuda_graph_lock``, so a capture's profiler starts and stops
    between steps, and a capture asked for mid-step waits for its end."""
    import functools
    import threading
    import time

    from tensorflowonspark_torch import profiling, train

    held, entered, release = [], threading.Event(), threading.Event()

    def loss_fn(params, batch, mask):
        held.append(profiling.cuda_graph_lock.locked())
        entered.set()
        release.wait(10)
        return ((params["w"] * batch["x"]).sum(-1) ** 2).mean(), {}

    trainer = train.Trainer(loss_fn, {"w": torch.ones(4)},
                            functools.partial(torch.optim.SGD, lr=0.1),
                            batch_size=2, device=card)
    stepping = threading.Thread(target=trainer.step, args=(
        {"x": torch.arange(8.0, device=card).reshape(2, 4)},))
    stepping.start()
    assert entered.wait(30)
    t0 = time.monotonic()
    acquired = profiling.cuda_graph_lock.acquire(timeout=0.2)
    if acquired:
        profiling.cuda_graph_lock.release()
    release.set()
    stepping.join(30)
    assert held == [True] and not acquired
    assert time.monotonic() - t0 >= 0.2 and trainer.state.step == 1
    assert not profiling.cuda_graph_lock.locked()


def test_sharded_feed_on_card_matches_cpu(card):
    """50 full batches and a padded tail, prefetched two deep onto the card
    through pinned memory and a side stream, equal the CPU path's batch for
    batch.  The consumer keeps its stream busy before it copies each batch
    and drops it right after: a missing event wait would read a batch
    before its copy ended, a missing ``record_stream`` would let a later
    copy reuse its memory before the consumer's copy ran."""
    from tensorflowonspark_torch.parallel.infeed import ShardedFeed

    rows = np.random.default_rng(0).integers(
        0, 32000, (50 * 8 + 3, 1024)).astype(np.int32)

    def transform(tokens):
        return {"tokens": tokens}

    want = [(b["tokens"].clone(), m.clone()) for b, m in ShardedFeed(
        _RowFeed(rows), 8, transform=transform, prefetch=0,
        device="cpu").batches()]
    busy = torch.randn(2048, 2048, device=card)
    got = []
    feed = ShardedFeed(_RowFeed(rows), 8, transform=transform, prefetch=2,
                       device=card)
    for batch, mask in feed.batches():
        assert batch["tokens"].is_cuda and mask.is_cuda
        for _ in range(4):
            busy = torch.tanh(busy @ busy)
        got.append((batch["tokens"].clone(), mask.clone()))
        del batch, mask
    torch.cuda.synchronize()
    assert len(got) == len(want) == 51
    for (gb, gm), (wb, wm) in zip(got, want):
        assert torch.equal(gb.cpu(), wb) and torch.equal(gm.cpu(), wm)
    assert feed.counters_snapshot()["infeed_batches"] == 51
