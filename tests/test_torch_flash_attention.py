"""The port's flash attention (its plain version, on the CPU) against the
JAX package's Pallas kernel in interpret mode, and its reference attention
against the JAX one.  Inputs come from numpy seeds and reach both sides as
numpy."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorflowonspark_tpu.ops import flash_attention as jax_flash_attention
from tensorflowonspark_tpu.parallel import ring as jax_ring
from tensorflowonspark_torch.ops import flash_attention
from tensorflowonspark_torch.parallel import ring
from test_torch_kernels_cuda import G_TOL   # the card's gradient tolerance

jfa = importlib.import_module("tensorflowonspark_tpu.ops.flash_attention")
tfa = importlib.import_module("tensorflowonspark_torch.ops.flash_attention")

# fp32: both sides compute in fp32 and differ only in summation order and
# exp/log rounding, far inside 2e-5 at these sizes.  bf16: both start from
# the same bf16 inputs and compute in fp32, but the output is rounded to
# bf16 (8 mantissa bits): 2e-2 is about one bf16 step at |O| near 2-4.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# the cases of tests/test_ops.py: (shape [B, S, H, D], causal, block, dtype)
CASES = [
    ((2, 128, 2, 32), False, 64, "float32"),
    ((2, 128, 2, 32), True, 64, "float32"),
    ((1, 256, 1, 16), True, 64, "float32"),   # 4 x 4 blocks: online softmax
    ((2, 64, 2, 16), True, 32, "bfloat16"),
]


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _fold(x):
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("shape,causal,block,dtype", CASES)
def test_output_matches_jax_kernel(shape, causal, block, dtype):
    q, k, v = _qkv(shape, seed=sum(shape))
    want = jax_flash_attention(*(_jax(x, dtype) for x in (q, k, v)),
                               causal=causal, block_q=block, block_k=block,
                               interpret=True)
    got = flash_attention(*(_torch(x, dtype) for x in (q, k, v)),
                          causal=causal, block_q=block, block_k=block)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shape,causal,block,dtype", CASES)
def test_logsumexp_matches_jax_kernel(shape, causal, block, dtype):
    q, k, v = _qkv(shape, seed=sum(shape) + 1)
    scale = 1.0 / np.sqrt(shape[-1])
    want_o, want_l = jfa._flash_fwd(
        *(_fold(_jax(x, dtype)) for x in (q, k, v)), scale, causal, block,
        block, True)
    got_o, got_l = tfa._flash_fwd(*(_torch(x, dtype) for x in (q, k, v)),
                                  scale, causal)
    b, s, h, d = shape
    assert got_l.dtype == torch.float32 and got_l.shape == (b * h, s)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(
        _fold(got_o.float().numpy()), np.asarray(want_o, np.float32),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    q, k, v = _qkv((2, 96, 3, 32), seed=7)
    want = jax_ring.reference_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                        causal=causal)
    got = ring.reference_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])


def test_plain_matches_reference_attention():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 64, 2, 64), seed=2))
    out, lse = tfa.flash_attention_plain(q, k, v, causal=True)
    want = ring.reference_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    assert lse.shape == (2, 64)


def test_seq_divisibility_enforced():
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, 48, 2, 32)))
    with pytest.raises(AssertionError, match="divide"):
        flash_attention(q, k, v, block_q=32, block_k=32)


def test_cpu_tensors_launch_no_kernel():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 128, 2, 64)))
    before = tfa.fwd_launches
    flash_attention(q, k, v)
    assert tfa.fwd_launches == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "stride", "device"])
def test_kernel_wrapper_refuses_before_building(bad):
    """The launcher validates in Python before it builds or launches
    anything: CPU tensors, unsupported head_dim/dtype or a strided head_dim
    are ValueErrors, never a silent CPU run."""
    shape, dtype = (1, 64, 2, 64), torch.float32
    if bad == "head_dim":
        shape = (1, 64, 2, 48)
    if bad == "dtype":
        dtype = torch.float16
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(shape))
    if bad == "stride":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError):
        tfa._flash_fwd_cuda(q, k, v, 0.125, True)


def _misaligned(shape):
    """A contiguous fp32 view whose base pointer is 4 bytes off 16."""
    buf = torch.zeros(int(np.prod(shape)) + 1)
    return buf[1:].view(shape)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
def test_kernel_wrapper_refuses_misaligned_view(kernel):
    """The kernels copy 16 bytes at a time: a view off a 16-byte boundary
    is a ValueError naming the alignment, before anything is built."""
    shape = (1, 64, 2, 64)
    q = _misaligned(shape)
    k, v, out, g = (torch.from_numpy(x) for x in _qkv(shape) + _qkv(shape)[:1])
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="align"):
        if kernel == "flash_fwd":
            tfa._flash_fwd_cuda(q, k, v, 0.125, True)
        elif kernel == "flash_bwd_dq":
            tfa._flash_bwd_dq_cuda(q, k, v, out, lse, g, 0.125, True)
        else:
            tfa._flash_bwd_dkv_cuda(q, k, v, g, lse, lse, 0.125, True)


def test_bf16_dq_runs_unpadded_on_tensor_cores():
    """bf16 dQ is a wgmma kernel that takes head_dim 32 as it is; fp32 dQ
    stays on FMAs and is padded."""
    assert tfa.product_path("flash_bwd_dq", torch.bfloat16) == "wgmma"
    assert tfa.product_path("flash_bwd_dq", torch.float32) == "fma"
    tensors = [torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16)
               for _ in range(5)]
    got, head_dim = tfa._padded_for("flash_bwd_dq", tensors)
    assert head_dim == 32 and all(a is b for a, b in zip(got, tensors))
    (padded,), _ = tfa._padded_for("flash_bwd_dq", [tensors[0].float()])
    assert padded.shape[-1] == 64


def _dq_as_wgmma_kernel(q, k, v, out, lse, grad_out, causal, scale):
    """dQ by the arithmetic of the bf16 tensor-core kernel: S and dP are
    fp32 sums of bf16 products, P = exp2(S·scale·log2e − L·log2e) and
    dS = P∘(dP − δ) in fp32, dS rounded to bf16 as the A operand of dS·K,
    fp32 sums, dQ scaled and rounded to bf16 once."""
    batch, s_len, heads, _ = q.shape
    log2e = float(np.log2(np.e))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    lse = lse.reshape(batch, heads, s_len, 1)
    p = torch.exp2(s * (scale * log2e) - lse * log2e)
    if causal:
        p = p.tril()
    delta = (grad_out.float() * out.float()).sum(-1).transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", grad_out.float(), v.float())
    ds = (p * (dp - delta[..., None])).to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_dq_rounding_is_inside_card_tolerance(causal):
    """A rehearsal of the tensor-core dQ kernel's rounding, not a test of
    the kernel: a local emulation of its arithmetic (dS rounded to bf16
    before dS·K) stays within half the card's bf16 tolerance of the exact
    fp32 formula, on bf16 inputs at a size the card tests use.  The kernel
    itself is held to that tolerance on the card."""
    shape = (2, 256, 4, 64)
    scale = 1.0 / np.sqrt(shape[-1])
    q, k, v = (_torch(x, "bfloat16") for x in _qkv(shape, seed=21))
    (g,) = (_torch(x, "bfloat16") for x in _qkv(shape, seed=22)[:1])
    out, lse = tfa.flash_attention_plain(q, k, v, causal, scale)
    out = out.to(torch.bfloat16)
    want, _ = tfa.flash_bwd_dq_plain(q, k, v, out, lse, g, causal, scale)
    got = _dq_as_wgmma_kernel(q, k, v, out, lse, g, causal, scale)
    err = (got.float() - want).abs().max().item()
    assert err <= 0.5 * G_TOL[torch.bfloat16] * want.abs().max().item()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("output", ["out", "lse", "dq", "dk", "dv"])
def test_head_dim_32_padding_is_exact(causal, output):
    """head_dim 32 reaches the FMA kernels zero-padded to 64 with the scale
    of 32 passed explicitly: on the plain versions at fp32 the padded path,
    sliced back, gives what head_dim 32 gives directly (zero columns add
    nothing to Q K^T, dO V^T or delta)."""
    shape = (2, 96, 2, 32)
    scale = 1.0 / np.sqrt(32)
    q, k, v = (torch.from_numpy(x) for x in _qkv(shape, seed=11))
    (g,) = (torch.from_numpy(x) for x in _qkv(shape, seed=12)[:1])
    out, lse = tfa.flash_attention_plain(q, k, v, causal, scale)
    want = dict(zip(("dq", "dk", "dv"), tfa.flash_attention_bwd_plain(
        q, k, v, out, lse, g, causal, scale)), out=out, lse=lse)

    (qp, kp, vp, gp), head_dim = tfa._padded_for("flash_bwd_dq",
                                                 [q, k, v, g])
    assert head_dim == 32 and qp.shape[-1] == 64
    out_p, lse_p = tfa.flash_attention_plain(qp, kp, vp, causal, scale)
    got = dict(zip(("dq", "dk", "dv"), tfa.flash_attention_bwd_plain(
        qp, kp, vp, out_p, lse_p, gp, causal, scale)), out=out_p, lse=lse_p)
    if output != "lse":
        assert got[output][..., 32:].abs().max().item() == 0.0
        got[output] = got[output][..., :32]
    np.testing.assert_allclose(got[output].numpy(), want[output].numpy(),
                               atol=1e-6, rtol=1e-6)
