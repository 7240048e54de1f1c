"""FlashAttention-2 on Hopper: hand-written CUDA kernels for the forward
(``csrc/flash_fwd.cu``) and the backward (``csrc/flash_bwd.cu``), each
beside its plain PyTorch version.

The port of :mod:`tensorflowonspark_tpu.ops.flash_attention`.  The forward
streams K/V tiles through shared memory with an online softmax, so device
memory traffic is O(S·D) and the [S, S] score matrix never exists; it
emits O in the input dtype and the fp32 row logsumexp L, like the Pallas
``_fwd_kernel`` it replaces.  The backward is FlashAttention-2's split, as
in ``_flash_bwd``: one kernel accumulates dQ over key tiles (and computes
δ = rowsum(dO∘O) on the way), one accumulates dK and dV over query tiles;
both recompute P = exp(scale·QKᵀ − L) from the saved L.

:func:`flash_attention` is one ``torch.autograd.Function`` for both
devices.  Its forward and backward dispatch on the device of the tensors:
a CUDA tensor launches the kernels (or raises ``ValueError`` on what they
do not take), a CPU tensor runs the plain versions.  Nothing falls back
from one to the other.

Layout contract, as in the JAX package: ``[batch, seq, heads, dim]``; blocks
default to 128 and are clamped to the sequence length, which must divide by
them.  The CUDA kernels tile by 64 whatever the blocks are: they only change
the order of summation.  Gradients come back in the inputs' dtype.

On the card, the bf16 kernels (forward, dQ, dK/dV) do their products on
the tensor cores (``wgmma``, :func:`product_path`) and take head_dim 32,
64 or 128; the fp32 kernels do theirs as fp32 FMAs and take 64 or 128, so
the wrapper zero-pads head_dim 32 to 64 for them (exact: zero columns add
nothing to any product or to δ) and slices the result.
Every CUDA input needs a 16-byte aligned base pointer and strides.
"""

import ctypes
import math

import torch

from tensorflowonspark_torch.ops import _build

NEG_INF = -1e30

#: Launches of each CUDA kernel in this process.  Only the wrapper that
#: launches a kernel adds to its count; callers may set them back to 0.
fwd_launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0

_HEAD_DIMS = (32, 64, 128)
_FMA_HEAD_DIMS = (64, 128)   # what the FMA kernels take; 32 is padded to 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16                  # bytes: the kernels' 16-byte vector copies
_TENSOR_CORE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# C entry points: tensor pointers, then (batch, seq, heads, head_dim), the
# strides array, scale, causal, dtype code and the stream
_TAIL = [_INT] * 4 + [_PTR, ctypes.c_float, _INT, _INT, _PTR]
_ENTRY_POINTS = {
    "flash_fwd": {"flash_fwd": [_PTR] * 5 + _TAIL},
    "flash_bwd": {"flash_bwd_dq": [_PTR] * 8 + _TAIL,
                  "flash_bwd_dkv": [_PTR] * 8 + _TAIL},
}
_CONFIGURED = set()


def product_path(kernel, dtype):
    """How the CUDA kernel ``kernel`` does its products for inputs of
    ``dtype``: ``"wgmma"`` (Hopper's tensor cores; every bf16 kernel) or
    ``"fma"`` (fp32 FMAs on the CUDA cores)."""
    if kernel in _TENSOR_CORE_KERNELS and dtype == torch.bfloat16:
        return "wgmma"
    return "fma"


def kernel_head_dim(kernel, dtype, head_dim):
    """The head_dim the kernel variant runs at: head_dim 32 is padded to 64
    for the FMA kernels."""
    if (product_path(kernel, dtype) == "fma"
            and head_dim not in _FMA_HEAD_DIMS):
        return _FMA_HEAD_DIMS[0]
    return head_dim


def _default_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _scores(q, k, causal, scale):
    """fp32 ``scale·QKᵀ`` as ``[batch, heads, seq, seq]``, masked causal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_len = q.shape[1]
        mask = torch.ones(s_len, s_len, dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return s


def flash_attention_plain(q, k, v, causal=True, scale=None):
    """``(O, L)`` in fp32, straight from ``softmax`` and ``logsumexp``.

    ``O`` is ``[batch, seq, heads, dim]``; ``L`` is ``[batch * heads, seq]``
    (batch-major, the JAX kernel's folded layout)."""
    batch, s_len, heads, _ = q.shape
    s = _scores(q, k, causal, _default_scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float())
    return out, lse.reshape(batch * heads, s_len)


def _probs(q, k, lse, causal, scale):
    """P = exp(scale·QKᵀ − L) recomputed from the saved L, as the JAX
    ``_recompute_p`` does: ``[batch, heads, seq, seq]`` fp32."""
    batch, s_len, heads, _ = q.shape
    s = _scores(q, k, causal, scale)
    return torch.exp(s - lse.reshape(batch, heads, s_len, 1))


def flash_attention_delta(out, grad_out):
    """δ = rowsum(dO∘O) in fp32, as ``[batch * heads, seq]``."""
    batch, s_len, heads, _ = out.shape
    delta = (grad_out.float() * out.float()).sum(-1)      # [b, s, h]
    return delta.transpose(1, 2).reshape(batch * heads, s_len)


def flash_bwd_dq_plain(q, k, v, out, lse, grad_out, causal=True, scale=None):
    """``(dQ, δ)`` in fp32: what the dQ kernel computes.
    dS = P∘(dO·Vᵀ − δ), dQ = scale·dS·K."""
    batch, s_len, heads, _ = q.shape
    scale = _default_scale(q, scale)
    delta = flash_attention_delta(out, grad_out)
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", grad_out.float(), v.float())
    ds = p * (dp - delta.reshape(batch, heads, s_len, 1))
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq, delta


def flash_bwd_dkv_plain(q, k, v, grad_out, lse, delta, causal=True,
                        scale=None):
    """``(dK, dV)`` in fp32: what the dK/dV kernel computes.
    dV = Pᵀ·dO, dK = scale·dSᵀ·Q."""
    batch, s_len, heads, _ = q.shape
    scale = _default_scale(q, scale)
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", grad_out.float(), v.float())
    ds = p * (dp - delta.reshape(batch, heads, s_len, 1))
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, grad_out.float())
    return dk, dv


def flash_attention_bwd_plain(q, k, v, out, lse, grad_out, causal=True,
                              scale=None):
    """``(dQ, dK, dV)`` in fp32 by the JAX kernels' formulas, from the
    forward's ``out`` and ``L``: P = exp(scale·QKᵀ − L), δ = rowsum(dO∘O),
    dS = P∘(dO·Vᵀ − δ), dQ = scale·dS·K, dK = scale·dSᵀ·Q, dV = Pᵀ·dO.
    Not autograd of the forward."""
    dq, delta = flash_bwd_dq_plain(q, k, v, out, lse, grad_out, causal, scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, grad_out, lse, delta, causal, scale)
    return dq, dk, dv


def _lib(name):
    lib = _build.load(name)
    if name not in _CONFIGURED:
        for fn, argtypes in _ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, name + "_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _CONFIGURED.add(name)
    return lib


def _aligned(t):
    """Whether ``t``'s base pointer and (batch, seq, head) strides are
    multiples of 16 bytes."""
    elt = t.element_size()
    return t.data_ptr() % _ALIGN == 0 and all(
        t.stride(i) * elt % _ALIGN == 0 for i in range(3))


def _check_kernel_inputs(kernel, **tensors):
    """Raise ``ValueError`` on any ``[batch, seq, heads, dim]`` tensor the
    CUDA kernel does not take (the first one sets shape, dtype, device)."""
    names = list(tensors)
    first = tensors[names[0]]
    if first.dim() != 4 or any(t.shape != first.shape
                               for t in tensors.values()):
        raise ValueError("{} must share one [batch, seq, heads, dim] shape, "
                         "got {}".format(", ".join(names), [
                             tuple(t.shape) for t in tensors.values()]))
    if first.shape[-1] not in _HEAD_DIMS:
        raise ValueError("{} kernel takes head_dim in {}, got {}".format(
            kernel, _HEAD_DIMS, first.shape[-1]))
    if first.dtype not in _DTYPE_CODES or any(t.dtype != first.dtype
                                              for t in tensors.values()):
        raise ValueError("{} kernel takes float32 or bfloat16 inputs of one "
                         "dtype, got {}".format(kernel, [
                             t.dtype for t in tensors.values()]))
    if any(t.stride(-1) != 1 for t in tensors.values()):
        raise ValueError("{} kernel needs a contiguous head_dim (stride 1 on "
                         "the last axis)".format(kernel))
    for name, t in tensors.items():
        if not _aligned(t):
            raise ValueError(
                "{} kernel needs {} aligned to {} bytes (base pointer and "
                "batch, seq, head strides), got pointer offset {} and "
                "strides {}".format(kernel, name, _ALIGN,
                                    t.data_ptr() % _ALIGN, t.stride()))
    if any(t.device.type != "cuda" or t.device != first.device
           for t in tensors.values()):
        raise ValueError("{} kernel runs on CUDA tensors of one device, got "
                         "{}".format(kernel, [
                             str(t.device) for t in tensors.values()]))


def _check_stats(kernel, like, **stats):
    """Raise ``ValueError`` unless each of ``stats`` (L, δ) is a contiguous
    fp32 ``[batch * heads, seq]`` tensor on ``like``'s device."""
    batch, s_len, heads, _ = like.shape
    for name, t in stats.items():
        if (t.dtype != torch.float32 or t.shape != (batch * heads, s_len)
                or not t.is_contiguous() or t.device != like.device):
            raise ValueError(
                "{} kernel takes {} as contiguous float32 [{}, {}] on {}, "
                "got {} {} on {}".format(kernel, name, batch * heads, s_len,
                                         like.device, t.dtype,
                                         tuple(t.shape), t.device))


def _launch(lib_name, fn_name, pointers, strided, scale, causal):
    """Call one C entry point on the current stream of the tensors' device
    and raise on a refused launch.  ``strided`` are the
    ``[batch, seq, heads, dim]`` tensors whose (batch, seq, head) strides
    the entry point takes, in its order."""
    like = strided[0]
    batch, s_len, heads, dim = like.shape
    strides = (ctypes.c_longlong * (3 * len(strided)))(*[
        t.stride(i) for t in strided for i in range(3)])
    lib = _lib(lib_name)
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = getattr(lib, fn_name)(
            *[t.data_ptr() for t in pointers], batch, s_len, heads, dim,
            ctypes.addressof(strides), float(scale), int(bool(causal)),
            _DTYPE_CODES[like.dtype], stream)
    if err != 0:
        message = getattr(lib, lib_name + "_error_string")(err).decode()
        raise RuntimeError("{} kernel launch failed: {} ({})".format(
            fn_name, message, err))


def _padded_for(kernel, tensors):
    """``(tensors, head_dim)``: the tensors padded to the head_dim the
    kernel variant takes (as they are where no padding is needed)."""
    head_dim = tensors[0].shape[-1]
    run_dim = kernel_head_dim(kernel, tensors[0].dtype, head_dim)
    if run_dim == head_dim:
        return tensors, head_dim
    pad = (0, run_dim - head_dim)   # zeros after the last column
    return [torch.nn.functional.pad(t, pad) for t in tensors], head_dim


def _flash_fwd_cuda(q, k, v, scale, causal):
    """Launch the forward kernel: ``(O in q.dtype, L fp32 [B*H, S])``."""
    global fwd_launches
    _check_kernel_inputs("flash_fwd", q=q, k=k, v=v)
    (q, k, v), head_dim = _padded_for("flash_fwd", [q, k, v])
    batch, s_len, heads, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((batch * heads, s_len), dtype=torch.float32,
                      device=q.device)
    _launch("flash_fwd", "flash_fwd", (q, k, v, out, lse), (q, k, v, out),
            scale, causal)
    fwd_launches += 1
    if out.shape[-1] != head_dim:
        out = out[..., :head_dim].contiguous()
    return out, lse


def _flash_bwd_dq_cuda(q, k, v, out, lse, grad_out, scale, causal):
    """Launch the dQ kernel: ``(dQ in q.dtype, δ fp32 [B*H, S])``."""
    global bwd_dq_launches
    _check_kernel_inputs("flash_bwd_dq", q=q, k=k, v=v, out=out,
                         grad_out=grad_out)
    _check_stats("flash_bwd_dq", q, lse=lse)
    (q, k, v, out, grad_out), head_dim = _padded_for(
        "flash_bwd_dq", [q, k, v, out, grad_out])
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty_like(lse)
    _launch("flash_bwd", "flash_bwd_dq",
            (q, k, v, out, grad_out, lse, delta, dq),
            (q, k, v, out, grad_out, dq), scale, causal)
    bwd_dq_launches += 1
    return dq[..., :head_dim], delta


def _flash_bwd_dkv_cuda(q, k, v, grad_out, lse, delta, scale, causal):
    """Launch the dK/dV kernel: ``(dK in k.dtype, dV in v.dtype)``, from
    the δ the dQ kernel wrote."""
    global bwd_dkv_launches
    _check_kernel_inputs("flash_bwd_dkv", q=q, k=k, v=v, grad_out=grad_out)
    _check_stats("flash_bwd_dkv", q, lse=lse, delta=delta)
    (q, k, v, grad_out), head_dim = _padded_for("flash_bwd_dkv",
                                                [q, k, v, grad_out])
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("flash_bwd", "flash_bwd_dkv",
            (q, k, v, grad_out, lse, delta, dk, dv),
            (q, k, v, grad_out, dk, dv), scale, causal)
    bwd_dkv_launches += 1
    return dk[..., :head_dim], dv[..., :head_dim]


def _check_device(q):
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError("flash attention runs on cuda or cpu tensors, got "
                         "{}".format(q.device))


def _flash_fwd(q, k, v, scale, causal):
    """``(O in q.dtype, L fp32 [batch * heads, seq])``: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_device(q)
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, scale, causal)
    out, lse = flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return out.to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, grad_out, scale, causal):
    """``(dQ, dK, dV)`` in the inputs' dtypes: the two kernels for CUDA
    tensors, the plain version for CPU tensors."""
    _check_device(q)
    if q.device.type == "cuda":
        dq, delta = _flash_bwd_dq_cuda(q, k, v, out, lse, grad_out, scale,
                                       causal)
        dk, dv = _flash_bwd_dkv_cuda(q, k, v, grad_out, lse, delta, scale,
                                     causal)
        return dq, dk, dv
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, grad_out,
                                           causal, scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Flash attention under autograd, on either device: saves
    ``(q, k, v, O, L)`` as the JAX ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        # e.g. the expanded gradient of a sum: the kernels read dO in place
        if grad_out.stride(-1) != 1 or not _aligned(grad_out):
            grad_out = grad_out.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, grad_out, ctx.scale,
                                ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, block_q=128, block_k=128,
                    scale=None):
    """Memory-linear attention over ``[batch, seq, heads, dim]`` inputs.

    Differentiable; softmax statistics are fp32 whatever the input dtype;
    the output and the gradients have the input dtype.  ``block_q/k`` are
    clamped to the sequence length, which must divide by them.  On CUDA
    tensors the forward and backward are the hand-written kernels; on CPU
    tensors they are :func:`flash_attention_plain` and
    :func:`flash_attention_bwd_plain`.
    """
    s_len = q.shape[1]
    scale = _default_scale(q, scale)
    block_q = min(block_q, s_len)
    block_k = min(block_k, s_len)
    assert s_len % block_q == 0 and s_len % block_k == 0, (
        "seq len {} must divide by blocks ({}, {})".format(
            s_len, block_q, block_k))
    return _FlashAttention.apply(q, k, v, causal, scale)
