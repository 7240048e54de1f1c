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
