"""ResNet family of the port (the counterpart of
:mod:`tensorflowonspark_tpu.models.resnet`): ResNet-50 v1.5 for ImageNet and
ResNet-56 for CIFAR-10.

The same model as the flax one, with its numerics:

- inputs are NHWC ``[B, H, W, C]``; inside, activations are NCHW views in
  ``channels_last`` memory, so cuDNN runs its NHWC convolutions;
- params are fp32; ``dtype`` is the compute dtype.  Convs cast their input
  and weight to it (flax ``promote_dtype``), global average pooling runs in
  it, and the final Dense runs in fp32;
- flax's SAME padding, which is asymmetric under stride 2 (the 7x7/s2 stem
  pads (2, 3) at 224 px, a 3x3/s2 conv (0, 1), the 3x3/s2 max pool (0, 1)
  with -inf), computed from the input size and applied with ``F.pad``; the
  s2d stem's 4x4 conv pads ((1, 2), (1, 2));
- BatchNorm: flax ``momentum=0.9`` (the running averages keep 0.9 of the
  old value, torch ``momentum=0.1``), eps 1e-5, statistics reduced in fp32
  whatever the compute dtype, the running variance updated with the
  **biased** batch variance, and rows with mask 0 counted in the batch
  statistics, as in JAX.  Each block's last BatchNorm scale starts at zero.

The running averages are not params: they are the Trainer's extra state.
``model(x)`` is the eval forward (running averages); ``model(x,
train=True)`` returns ``(logits, new_stats)``, ``new_stats`` the updated
running averages by buffer name, computed under ``no_grad``.
:func:`loss_fn` takes the Trainer's ``fn(params, extra, batch, mask)``
contract and hands the new statistics back in ``aux["extra_state"]``.

In a ``torch.distributed`` world of more than one process the batch
statistics are the global batch's, as when XLA reduces a BatchNorm over a
batch sharded across processes: each layer all-reduces its per-channel
sum, sum of squares and row count with a differentiable all-reduce, so the
backward carries every rank's gradient with respect to the statistics.
One process takes the fused ``native_batch_norm`` and makes no collective.

:mod:`~tensorflowonspark_torch.convert` maps a flax ``params`` and
``batch_stats`` tree onto this module's params and buffers and back.
"""

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import register_model

MOMENTUM = 0.9      # flax's: the running averages keep 0.9 of the old value
EPSILON = 1e-5
STEMS = ("conv7", "s2d")


def space_to_depth(x, block=2):
    """NHWC space-to-depth: ``(B, H, W, C) -> (B, H/b, W/b, C*b*b)``.

    Pixel ``(bh*b+i, bw*b+j, c)`` lands in channel ``(i*b + j)*C + c`` of
    block ``(bh, bw)``: the layout :func:`s2d_stem_kernel` assumes."""
    b_, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(
            "stem='s2d' requires H and W divisible by {} (got {}x{}); use "
            "stem='conv7' or pad/resize the input".format(block, h, w))
    x = x.reshape(b_, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b_, h // block, w // block, c * block * block)


def s2d_stem_kernel(kernel7):
    """A ``(7, 7, C, F)`` stride-2 SAME stem kernel (flax HWIO) as the
    exactly equivalent ``(4, 4, C*4, F)`` kernel of a stride-1 conv over
    :func:`space_to_depth` (block 2) input padded ``((1, 2), (1, 2))``.

    SAME/stride-2/k=7 taps input ``[2i-2, 2i+4]``, an even start, so
    zero-padding the kernel to 8x8 at the bottom/right keeps every tap's
    block alignment and each 2x2 pixel block folds into the s2d channel
    dim.  numpy in and out (the port's own copy of the JAX function)."""
    k = np.asarray(kernel7)
    kh, kw, c, f = k.shape
    if (kh, kw) != (7, 7):
        raise ValueError("expected a 7x7 kernel, got {}x{}".format(kh, kw))
    k = np.pad(k, ((0, 1), (0, 1), (0, 0), (0, 0)))  # 8x8, zeros bottom/right
    # (4, 2, 4, 2, C, F): split each spatial dim into (block_index, offset)
    k = k.reshape(4, 2, 4, 2, c, f)
    # s2d channel order is (off_h, off_w, c): fold the offsets over channels
    return k.transpose(0, 2, 1, 3, 4, 5).reshape(4, 4, 2 * 2 * c, f)


def _same_pads(size, kernel, stride):
    """flax/XLA SAME padding of one spatial dim: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_2d(x, kernel, stride, padding, value=0.0):
    """``x`` (NCHW) padded for a ``kernel``/``stride`` window: SAME from its
    size when ``padding`` is None, else the explicit ``((top, bottom),
    (left, right))``.  Returns ``(x, symmetric)``: symmetric pads are left
    to the conv (``(ph, pw)``), asymmetric ones applied here."""
    if padding is None:
        padding = (_same_pads(x.shape[2], kernel, stride),
                   _same_pads(x.shape[3], kernel, stride))
    (top, bottom), (left, right) = padding
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def _truncated_lecun_normal_(weight, fan_in, generator):
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so that the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: ``weight`` ``(out, in, kh, kw)``
    (OIHW); input and weight cast to ``dtype``; SAME or explicit padding."""

    def __init__(self, in_channels, out_channels, kernel, stride=1,
                 padding=None, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel))

    def reset_parameters(self, generator):
        w = self.weight
        _truncated_lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3],
                                 generator)

    def forward(self, x):
        kernel = self.weight.shape[-1]
        x, pads = _pad_2d(x.to(self.dtype), kernel, self.stride, self.padding)
        w = self.weight.to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=pads)


def _world_size():
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of an NCHW input (see the
    module docstring): ``weight``/``bias`` are flax's ``scale``/``bias``,
    the buffers ``running_mean``/``running_var`` its ``batch_stats``
    ``mean``/``var``.  The buffers are read, never written: the updated
    averages go to ``updates`` under this layer's buffer names."""

    def __init__(self, features, zero_scale=False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.zero_scale = zero_scale
        self.prefix = ""    # this layer's name in the model, set by ResNet

    def reset_parameters(self, generator=None):
        del generator
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x, updates=None):
        x = x.to(self.dtype)
        if updates is None:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=EPSILON)
        if _world_size() > 1:
            y, mean, var = self._global_stats(x)
        else:
            y, mean, rstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, EPSILON)
            with torch.no_grad():
                # rstd = (var + eps)^-1/2 of the biased batch variance
                var = (rstd.reciprocal().square() - EPSILON).clamp_min(0.0)
        with torch.no_grad():
            updates[self.prefix + "running_mean"] = (
                MOMENTUM * self.running_mean + (1 - MOMENTUM) * mean)
            updates[self.prefix + "running_var"] = (
                MOMENTUM * self.running_var + (1 - MOMENTUM) * var)
        return y

    def _global_stats(self, x):
        """Normalise by the statistics of every rank's batch: one
        differentiable all-reduce of the fp32 per-channel sum, sum of
        squares and row count (flax's fast variance ``E[x^2] - E[x]^2``,
        clipped at 0).  Returns ``(y, mean, var)``, the statistics detached."""
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        c = xf.shape[1]
        count = xf.new_full((1,), float(xf.numel() // c))
        sums = all_reduce(torch.cat([xf.sum((0, 2, 3)),
                                     (xf * xf).sum((0, 2, 3)), count]))
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
        scale = torch.rsqrt(var + EPSILON) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()


class _Block(nn.Module):
    """Shared forward of the two block kinds: ``convs``/``norms`` in flax's
    order (``Conv_k``/``BatchNorm_k``), the projection last when there is
    one; ReLU after every norm but the last, then the residual add."""

    def forward(self, x, updates=None):
        y = x
        last = self.main_convs - 1
        for i in range(self.main_convs):
            y = self.norms[i](self.convs[i](y), updates)
            if i < last:
                y = F.relu(y)
        residual = x
        if len(self.convs) > self.main_convs:
            residual = self.norms[-1](self.convs[-1](x), updates)
        return F.relu(residual + y)


class BottleneckBlock(_Block):
    """ResNet-v1.5 bottleneck: 1x1 -> 3x3(stride) -> 1x1 (x4 channels),
    with a 1x1(stride) projection shortcut when the shape changes."""

    main_convs = 3

    def __init__(self, in_channels, filters, strides=1, dtype=torch.float32):
        super().__init__()
        convs = [Conv(in_channels, filters, 1, dtype=dtype),
                 Conv(filters, filters, 3, strides, dtype=dtype),
                 Conv(filters, filters * 4, 1, dtype=dtype)]
        norms = [BatchNorm(filters, dtype=dtype),
                 BatchNorm(filters, dtype=dtype),
                 BatchNorm(filters * 4, zero_scale=True, dtype=dtype)]
        if strides != 1 or in_channels != filters * 4:
            convs.append(Conv(in_channels, filters * 4, 1, strides,
                              dtype=dtype))
            norms.append(BatchNorm(filters * 4, dtype=dtype))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.out_channels = filters * 4


class BasicBlock(_Block):
    """CIFAR basic block: two 3x3 convs, with a 1x1(stride) projection
    shortcut when the shape changes."""

    main_convs = 2

    def __init__(self, in_channels, filters, strides=1, dtype=torch.float32):
        super().__init__()
        convs = [Conv(in_channels, filters, 3, strides, dtype=dtype),
                 Conv(filters, filters, 3, dtype=dtype)]
        norms = [BatchNorm(filters, dtype=dtype),
                 BatchNorm(filters, zero_scale=True, dtype=dtype)]
        if strides != 1 or in_channels != filters:
            convs.append(Conv(in_channels, filters, 1, strides, dtype=dtype))
            norms.append(BatchNorm(filters, dtype=dtype))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.out_channels = filters


class ResNet(nn.Module):
    """Configurable ResNet: ``stage_sizes`` and ``block_cls`` pick the
    variant ([3, 4, 6, 3] bottleneck = ResNet-50 v1.5; [9, 9, 9] basic =
    ResNet-56 for CIFAR).  Module names: ``stem_conv``/``stem_norm`` (flax's
    top-level ``Conv_0``/``BatchNorm_0``), ``blocks.<n>`` (its
    ``<Block>_<n>``) and ``head`` (``Dense_0``)."""

    def __init__(self, stage_sizes, block_cls=BottleneckBlock,
                 num_classes=1000, num_filters=64, cifar_stem=False,
                 stem="conv7", in_channels=3, dtype=torch.float32):
        super().__init__()
        if not cifar_stem and stem not in STEMS:
            raise ValueError("unknown stem {!r}; expected 'conv7' or "
                             "'s2d'".format(stem))
        self.cifar_stem = cifar_stem
        self.stem = stem
        self.dtype = dtype
        if cifar_stem:
            self.stem_conv = Conv(in_channels, num_filters, 3, dtype=dtype)
        elif stem == "s2d":
            # the exactly equivalent 4x4/s1 conv over the (H/2, W/2, 4C)
            # space-to-depth input (kernel mapping: s2d_stem_kernel)
            self.stem_conv = Conv(in_channels * 4, num_filters, 4,
                                  padding=((1, 2), (1, 2)), dtype=dtype)
        else:
            self.stem_conv = Conv(in_channels, num_filters, 7, 2,
                                  dtype=dtype)
        self.stem_norm = BatchNorm(num_filters, dtype=dtype)
        blocks, channels = [], num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = 2 if i > 0 and j == 0 else 1
                block = block_cls(channels, num_filters * 2 ** i, strides,
                                  dtype=dtype)
                channels = block.out_channels
                blocks.append(block)
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(channels, num_classes)
        for name, module in self.named_modules():
            if isinstance(module, BatchNorm):
                module.prefix = name + "."

    @torch.no_grad()
    def init_weights(self, generator):
        """flax's initialisers from ``generator``: truncated lecun-normal
        conv and Dense kernels, zero Dense bias, BatchNorm scale 1 (0 for
        each block's last), bias 0, running mean 0 and variance 1."""
        for module in self.modules():
            if isinstance(module, (Conv, BatchNorm)):
                module.reset_parameters(generator)
        _truncated_lecun_normal_(self.head.weight, self.head.weight.shape[1],
                                 generator)
        self.head.bias.zero_()
        return self

    def forward(self, x, train=False):
        """``x``: ``[B, H, W, C]``.  Eval: the logits (fp32).  ``train``:
        ``(logits, new_stats)`` from the batch's statistics."""
        updates = {} if train else None
        x = x.to(self.dtype)
        if not self.cifar_stem and self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)       # NCHW view, channels_last memory
        x = F.relu(self.stem_norm(self.stem_conv(x), updates))
        if not self.cifar_stem:
            x, pads = _pad_2d(x, 3, 2, None, value=-math.inf)
            x = F.max_pool2d(x, 3, 2, padding=pads)
        for block in self.blocks:
            x = block(x, updates)
        x = x.mean((2, 3))              # global average pool, in dtype
        logits = F.linear(x.float(), self.head.weight.float(),
                          self.head.bias.float())
        return (logits, updates) if train else logits


def _torch_dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


@register_model("resnet50")
def build_resnet50(num_classes=1000, dtype="bfloat16", blocks_per_stage=None,
                   stem="conv7"):
    """ResNet-50 v1.5 for ImageNet.  ``blocks_per_stage``: None = the
    [3, 4, 6, 3] ResNet-50; N = [N, N, N, N] bottleneck stages.
    ``stem="s2d"``: the space-to-depth stem (exactly equivalent math)."""
    stage_sizes = ([blocks_per_stage] * 4 if blocks_per_stage
                   else [3, 4, 6, 3])
    return ResNet(stage_sizes, BottleneckBlock, num_classes=num_classes,
                  stem=stem, dtype=_torch_dtype(dtype))


@register_model("resnet56_cifar")
def build_resnet56(num_classes=10, dtype="float32", blocks_per_stage=9):
    """ResNet-56 for CIFAR-10 (6n+2 layers; n = ``blocks_per_stage``)."""
    return ResNet([blocks_per_stage] * 3, BasicBlock,
                  num_classes=num_classes, num_filters=16, cifar_stem=True,
                  dtype=_torch_dtype(dtype))


def split_state(model):
    """``(params, extra)``: the model's parameters and its BatchNorm running
    averages (the Trainer's ``init_params`` and ``extra_state``), each a
    name -> tensor dict."""
    return (dict(model.named_parameters()), dict(model.named_buffers()))


def loss_fn(model, weight_decay=0.0, label_smoothing=0.0):
    """Masked cross-entropy (+ L2) for the Trainer's extra-state contract,
    ``fn(params, extra, batch, mask) -> (loss, aux)``, applied with
    ``torch.func.functional_call``; the updated running averages return in
    ``aux["extra_state"]`` (never optimized), beside ``accuracy``.

    The cross entropy is taken against labels smoothed by
    ``label_smoothing`` (``optax.smooth_labels``), averaged over rows
    weighted by ``mask``; the L2 term is ``weight_decay * sum(p**2)`` over
    the params of more than one dim (conv and Dense kernels), added to the
    loss, as the JAX loss does."""
    def loss(params, extra, batch, mask):
        logits, new_stats = torch.func.functional_call(
            model, {**params, **extra}, (batch["image"],), {"train": True})
        labels = batch["label"].long()
        ce = F.cross_entropy(logits, labels, reduction="none",
                             label_smoothing=label_smoothing)
        mask = mask.to(ce.dtype)
        count = mask.sum().clamp_min(1.0)
        ce = (ce * mask).sum() / count
        if weight_decay:
            l2 = torch.stack([p.square().sum() for p in params.values()
                              if p.ndim > 1]).sum()
            ce = ce + weight_decay * l2
        acc = ((logits.argmax(-1) == labels) * mask).sum() / count
        return ce, {"accuracy": acc, "extra_state": new_stats}

    return loss
