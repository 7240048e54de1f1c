"""The port's flash attention backward on the CPU: gradients through the one
``autograd.Function`` (its plain path) against ``jax.grad`` through the JAX
package's Pallas kernels in interpret mode; the plain backward against the
JAX backward kernels and against autograd of the reference attention; δ;
and the wiring (dtypes, fused views, no kernel launch on CPU tensors).
Inputs come from numpy seeds and reach both sides as numpy."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowonspark_tpu.ops import flash_attention as jax_flash_attention
from tensorflowonspark_torch.ops import flash_attention
from tensorflowonspark_torch.parallel import ring

jfa = importlib.import_module("tensorflowonspark_tpu.ops.flash_attention")
tfa = importlib.import_module("tensorflowonspark_torch.ops.flash_attention")

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these shapes run as fast on one, and the suite's
    parallel workers share the machine's cores with timing-sensitive tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# fp32: 5e-4, the tolerance tests/test_ops.py holds the JAX kernels' own
# gradients to.  bf16: both sides start from the same bf16 inputs, compute
# in fp32 and round the gradients to bf16 (8 mantissa bits); the cotangent
# 2·O can differ by one bf16 step where the two forwards round O
# differently: 2e-2 of the largest gradient.
GRAD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}

# the gradient cases of tests/test_ops.py (shape [B, S, H, D], causal,
# block), fp32 as there, and its bf16 input case with gradients
CASES = [
    ((1, 64, 2, 16), False, 32, "float32"),
    ((1, 64, 2, 16), True, 32, "float32"),
    ((2, 64, 2, 16), True, 32, "bfloat16"),
    ((1, 256, 1, 16), True, 64, "float32"),   # 4 x 4 blocks
]


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(n))


def _fold(x):
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("shape,causal,block,dtype", CASES)
def test_gradients_match_jax_vjp(shape, causal, block, dtype):
    """d/dq,k,v of sum(O²), as tests/test_ops.py takes it."""
    q, k, v = _arrays(shape, 3, seed=sum(shape) + causal)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, block_q=block,
                                block_k=block, interpret=True)
        return (o.astype(jnp.float32) ** 2).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
              for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, block_q=block,
                          block_k=block)
    (out.float() ** 2).sum().backward()
    for leaf, w, name in zip(leaves, want, "qkv"):
        assert leaf.grad.dtype == getattr(torch, dtype)
        w = np.asarray(w, np.float32)
        limit = GRAD_TOL[dtype] * max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(leaf.grad.float().numpy(), w, rtol=0,
                                   atol=limit, err_msg="d" + name)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_backward_kernels(causal):
    """flash_attention_bwd_plain against the JAX ``_flash_bwd`` (both
    Pallas backward kernels, interpret mode) on the same residuals."""
    shape, block = (2, 128, 2, 32), 64
    q, k, v, g = _arrays(shape, 4, seed=11)
    scale = 1.0 / np.sqrt(shape[-1])
    out, lse = tfa.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, scale)
    res = tuple(jnp.asarray(_fold(x)) for x in (q, k, v, out.numpy())) + (
        jnp.asarray(lse.numpy()),)
    want = jfa._flash_bwd(res, jnp.asarray(_fold(g)), scale, causal, block,
                          block, True)
    got = tfa.flash_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), out, lse,
        torch.from_numpy(g), causal, scale)
    for gt, w in zip(got, want):
        assert gt.dtype == torch.float32 and gt.shape == shape
        np.testing.assert_allclose(_fold(gt.numpy()), np.asarray(w),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_reference_autograd(causal):
    """The plain backward (formulas, not autograd) against torch autograd
    of the reference attention, fp32."""
    shape = (2, 96, 3, 32)
    q, k, v, g = (torch.from_numpy(x) for x in _arrays(shape, 4, seed=5))
    out, lse = tfa.flash_attention_plain(q, k, v, causal)
    got = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ring.reference_attention(*leaves, causal=causal).backward(g)
    for gt, leaf in zip(got, leaves):
        np.testing.assert_allclose(gt.numpy(), leaf.grad.numpy(), rtol=0,
                                   atol=1e-5)


def test_delta_matches_rowsum():
    """δ = rowsum(dO∘O) in the folded [B·H, S] layout of the JAX kernels,
    and the dQ half returns the same δ."""
    shape = (2, 64, 3, 16)
    q, k, v, g = _arrays(shape, 4, seed=8)
    out = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=True, interpret=True)
    want = (_fold(np.asarray(out)) * _fold(g)).sum(-1)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tout = torch.from_numpy(np.array(out))
    delta = tfa.flash_attention_delta(tout, tg)
    assert delta.shape == (6, 64) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), want, rtol=1e-5, atol=1e-5)
    _, lse = tfa.flash_attention_plain(tq, tk, tv, True)
    _, delta_dq = tfa.flash_bwd_dq_plain(tq, tk, tv, tout, lse, tg, True)
    assert torch.equal(delta_dq, delta)


def test_fused_views_and_strided_grad_out():
    """q, k, v as views of one [B, S, 3, H, D] buffer (as the transformer
    hands them) and a grad_out with no unit stride give the gradients of
    separate contiguous inputs."""
    (x,) = _arrays((2, 64, 3, 2, 16), 1, seed=3)
    fused = torch.from_numpy(x).requires_grad_()
    flash_attention(*fused.unbind(2)).sum().backward()   # expanded grad_out
    parts = [torch.from_numpy(np.ascontiguousarray(x[:, :, i]))
             .requires_grad_() for i in range(3)]
    flash_attention(*parts).sum().backward()
    for i, part in enumerate(parts):
        torch.testing.assert_close(fused.grad[:, :, i], part.grad)


def test_cpu_backward_launches_no_kernel():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _arrays((1, 64, 2, 64), 3, seed=2))
    before = (tfa.fwd_launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches)
    flash_attention(q, k, v).sum().backward()
    assert (tfa.fwd_launches, tfa.bwd_dq_launches,
            tfa.bwd_dkv_launches) == before
    assert q.grad is not None and k.grad is not None and v.grad is not None


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_backward_wrappers_refuse_cpu_tensors(kernel):
    """The backward launchers validate in Python before they build or
    launch anything: CPU tensors are a ValueError, never a CPU run."""
    q, k, v, g = (torch.from_numpy(x) for x in _arrays((1, 64, 2, 64), 4, 0))
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        if kernel == "dq":
            tfa._flash_bwd_dq_cuda(q, k, v, q, lse, g, 0.125, True)
        else:
            tfa._flash_bwd_dkv_cuda(q, k, v, g, lse, lse, 0.125, True)
