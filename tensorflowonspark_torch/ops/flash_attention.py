"""FlashAttention-2 forward on Hopper: a hand-written CUDA kernel
(``csrc/flash_fwd.cu``) and its plain PyTorch version.

The port of :mod:`tensorflowonspark_tpu.ops.flash_attention`.  The kernel
streams K/V tiles through shared memory with an online softmax, so device
memory traffic is O(S·D) and the [S, S] score matrix never exists; it
emits O in the input dtype and the fp32 row logsumexp L, like the Pallas
``_fwd_kernel`` it replaces.

Dispatch is by the device of the tensors: a CUDA tensor launches the kernel
(or raises ``ValueError`` on what the kernel does not take), a CPU tensor
runs :func:`flash_attention_plain`.  Nothing falls back from one to the
other.  The backward kernels belong to the training slice.

Layout contract, as in the JAX package: ``[batch, seq, heads, dim]``; blocks
default to 128 and are clamped to the sequence length, which must divide by
them.  The CUDA kernel tiles by 64 whatever the blocks are: they only change
the order of summation.
"""

import ctypes
import math

import torch

from tensorflowonspark_torch.ops import _build

NEG_INF = -1e30

#: Launches of the CUDA forward kernel in this process.  Only the wrapper
#: that launches it adds to it; callers may set it back to 0.
fwd_launches = 0

_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BACKWARD_TODO = ("flash attention backward on CUDA is not ported yet: it is "
                  "the training slice's _bwd_dq_kernel / _bwd_dkv_kernel "
                  "(ROADMAP.md, Queue 1, slice 2: Flash backward; Queue 2)")


def flash_attention_plain(q, k, v, causal=True, scale=None):
    """``(O, L)`` in fp32, straight from ``softmax`` and ``logsumexp``.

    ``O`` is ``[batch, seq, heads, dim]``; ``L`` is ``[batch * heads, seq]``
    (batch-major, the JAX kernel's folded layout)."""
    batch, s_len, heads, dim = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dim)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(s_len, s_len, dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float())
    return out, lse.reshape(batch * heads, s_len)


def _lib():
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        lib.flash_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(q, k, v):
    """Raise ``ValueError`` on anything the CUDA kernel does not take."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one [batch, seq, heads, dim] "
                         "shape, got {}, {}, {}".format(
                             tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError("flash_fwd kernel takes head_dim in {}, got {}".format(
            _HEAD_DIMS, q.shape[-1]))
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_fwd kernel takes float32 or bfloat16 inputs of "
                         "one dtype, got {}, {}, {}".format(
                             q.dtype, k.dtype, v.dtype))
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_fwd kernel needs a contiguous head_dim "
                         "(stride 1 on the last axis)")
    if any(t.device.type != "cuda" or t.device != q.device for t in (q, k, v)):
        raise ValueError("flash_fwd kernel runs on CUDA tensors of one device, "
                         "got {}, {}, {}".format(q.device, k.device, v.device))


def _flash_fwd_cuda(q, k, v, scale, causal):
    """Launch the CUDA kernel: ``(O in q.dtype, L fp32 [B*H, S])``."""
    global fwd_launches
    _check_kernel_inputs(q, k, v)
    batch, s_len, heads, dim = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((batch * heads, s_len), dtype=torch.float32,
                      device=q.device)
    strides = (ctypes.c_longlong * 12)(*[
        t.stride(i) for t in (q, k, v, out) for i in range(3)])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), batch, s_len, heads, dim, ctypes.addressof(strides),
            float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_fwd kernel launch failed: {} ({})".format(
            lib.flash_fwd_error_string(err).decode(), err))
    fwd_launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The CUDA forward under autograd; saves what the backward kernels of
    the training slice will need."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _flash_fwd_cuda(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(_BACKWARD_TODO)


def _flash_fwd(q, k, v, scale, causal):
    """``(O in q.dtype, L fp32 [batch * heads, seq])``: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, scale, causal)
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal=causal, scale=scale)
        return out.to(q.dtype), lse
    raise ValueError("flash attention runs on cuda or cpu tensors, got "
                     "{}".format(q.device))


def flash_attention(q, k, v, causal=True, block_q=128, block_k=128,
                    scale=None):
    """Memory-linear attention over ``[batch, seq, heads, dim]`` inputs.

    Softmax statistics are fp32 whatever the input dtype; the output has
    the input dtype.  ``block_q/k`` are clamped to the sequence length,
    which must divide by them.  On CUDA tensors this is the hand-written
    kernel (forward only: its backward raises until the training slice);
    on CPU tensors it is :func:`flash_attention_plain`.
    """
    batch, s_len, heads, dim = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dim)
    block_q = min(block_q, s_len)
    block_k = min(block_k, s_len)
    assert s_len % block_q == 0 and s_len % block_k == 0, (
        "seq len {} must divide by blocks ({}, {})".format(
            s_len, block_q, block_k))
    if q.device.type == "cuda":
        return _FlashAttention.apply(q, k, v, causal, scale)
    out, _ = _flash_fwd(q, k, v, scale, causal)
    return out
