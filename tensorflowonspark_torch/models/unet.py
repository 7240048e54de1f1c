"""U-Net of the port (the counterpart of
:mod:`tensorflowonspark_tpu.models.unet`; the original system's
segmentation example, ``examples/segmentation/segmentation_spark.py:70-122``
there): a strided-conv encoder with skip connections and a transpose-conv
decoder, per-pixel class logits.

The same model as the flax one, with its numerics:

- inputs are NHWC ``[B, H, W, 3]`` and the logits NHWC ``[B, H, W,
  classes]``; inside, activations are NCHW views in ``channels_last``
  memory, so cuDNN runs its NHWC convolutions;
- params are fp32; ``dtype`` is the compute dtype.  Convs cast their input
  and weight to it (flax ``promote_dtype``); the final 1x1 conv runs in
  fp32.  The first and the final conv have a bias, the blocks' convs none;
- a block's stride-2 3x3 conv pads flax's SAME, which is asymmetric on an
  even input ((0, 1)), with ``F.pad`` (the ResNet's ``Conv``);
- flax's ``ConvTranspose(f, (3, 3), strides=(2, 2))`` (SAME,
  ``transpose_kernel=False``) is ``F.conv_transpose2d(x, w, stride=2)``
  cropped to its first ``2n`` rows and columns, ``w`` the flax HWIO kernel
  flipped in both spatial axes and laid out ``(in, out, kh, kw)``: the
  layout this module keeps (:mod:`~tensorflowonspark_torch.convert` flips);
- ``GroupNorm(min(8, filters))``: epsilon 1e-6, statistics reduced in fp32
  whatever the compute dtype, the variance as ``E[x^2] - E[x]^2``, scale
  and bias applied in fp32 and the result cast back to ``dtype``, as flax
  does.

:func:`loss_fn` is the JAX loss: per-pixel integer-label cross entropy,
averaged per example, then over the rows weighted by the mask, and the
masked pixel accuracy.
"""

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import register_model
from tensorflowonspark_torch.models.resnet import (
    Conv, _torch_dtype, _truncated_lecun_normal_)

EPSILON = 1e-6      # flax GroupNorm's
MAX_GROUPS = 8


def _fan_in(weight, in_dim):
    return weight.shape[in_dim] * weight.shape[2] * weight.shape[3]


class BiasConv(nn.Module):
    """flax ``nn.Conv`` with a bias, stride 1, SAME (odd kernels pad
    symmetrically): ``weight`` OIHW, input, weight and bias cast to
    ``dtype``."""

    def __init__(self, in_channels, out_channels, kernel, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator):
        _truncated_lecun_normal_(self.weight, _fan_in(self.weight, 1),
                                 generator)
        self.bias.zero_()

    def forward(self, x):
        w = self.weight.to(self.dtype).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(x.to(self.dtype), w, self.bias.to(self.dtype),
                        padding=self.weight.shape[-1] // 2)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(f, (3, 3), strides=(2, 2), use_bias=False)``
    (see the module docstring): ``weight`` ``(in, out, kh, kw)``, the flax
    kernel flipped."""

    def __init__(self, in_channels, out_channels, kernel=3, stride=2,
                 dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kernel, kernel))

    def reset_parameters(self, generator):
        # flax's fan-in of a (kh, kw, in, out) kernel: in * kh * kw
        _truncated_lecun_normal_(self.weight, _fan_in(self.weight, 0),
                                 generator)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                               stride=self.stride)
        return y[:, :, :h * self.stride, :w * self.stride]


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` over the channel dim of an NCHW
    input: ``weight``/``bias`` are flax's ``scale``/``bias``."""

    def __init__(self, features, num_groups, dtype=torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator=None):
        del generator
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        # at least fp32, as flax promotes (fp64 stays fp64)
        dtype = torch.promote_types(x.dtype, torch.float32)
        b, c, h, w = x.shape
        size = c // self.num_groups
        xf = x.to(dtype)
        groups = xf.reshape(b, self.num_groups, size, h, w)
        mean = groups.mean((2, 3, 4))
        # flax's fast variance, E[x^2] - E[x]^2 clipped at 0 (torch's
        # group_norm takes another sum, off by 1e-4 where the mean is
        # large beside the spread)
        var = (groups.square().mean((2, 3, 4)) - mean.square()).clamp_min(0.0)

        def per_channel(t):
            return t.repeat_interleave(size, 1)[:, :, None, None]

        mul = (torch.rsqrt(per_channel(var) + EPSILON)
               * self.weight.to(dtype)[:, None, None])
        y = (xf - per_channel(mean)) * mul + self.bias.to(dtype)[:, None, None]
        return y.to(self.dtype)


class DownBlock(nn.Module):
    """Stride-2 3x3 conv (no bias) -> GroupNorm -> ReLU."""

    def __init__(self, in_channels, filters, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(in_channels, filters, 3, stride=2, dtype=dtype)
        self.norm = GroupNorm(filters, min(MAX_GROUPS, filters), dtype=dtype)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class UpBlock(nn.Module):
    """Transpose-conv upsampler (the original's pix2pix.upsample):
    ConvTranspose -> GroupNorm -> ReLU, then the skip concatenated on the
    channels."""

    def __init__(self, in_channels, filters, dtype=torch.float32):
        super().__init__()
        self.conv = ConvTranspose(in_channels, filters, dtype=dtype)
        self.norm = GroupNorm(filters, min(MAX_GROUPS, filters), dtype=dtype)

    def forward(self, x, skip):
        return torch.cat([F.relu(self.norm(self.conv(x))), skip], dim=1)


class UNet(nn.Module):
    """Encoder/decoder with skip connections; output: per-pixel class
    logits (fp32).  Module names: ``conv_in`` (flax ``Conv_0``),
    ``down.<i>`` (``DownBlock_<i>``), ``up.<i>`` (``UpBlock_<i>``), each
    with ``conv`` and ``norm``, and ``conv_out`` (``Conv_1``)."""

    def __init__(self, num_classes=3, encoder_filters=(32, 64, 128, 256),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        filters = tuple(int(f) for f in encoder_filters)
        self.conv_in = BiasConv(3, 16, 3, dtype=dtype)
        skips, channels, down = [], 16, []
        for f in filters:
            skips.append(channels)
            down.append(DownBlock(channels, f, dtype=dtype))
            channels = f
        up = []
        for f, skip in zip(reversed(filters[:-1]), reversed(skips[1:])):
            up.append(UpBlock(channels, f, dtype=dtype))
            channels = f + skip
        up.append(UpBlock(channels, 16, dtype=dtype))
        self.down = nn.ModuleList(down)
        self.up = nn.ModuleList(up)
        # final per-pixel classifier in fp32 for a stable softmax
        self.conv_out = BiasConv(16 + skips[0], num_classes, 1,
                                 dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, generator):
        """flax's initialisers from ``generator``: truncated lecun-normal
        conv and transpose-conv kernels, zero biases, GroupNorm scale 1 and
        bias 0."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def forward(self, x):
        """``x``: ``[B, H, W, 3]``; the logits ``[B, H, W, classes]``."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # channels_last memory
        x = self.conv_in(x)
        skips = []
        for block in self.down:
            skips.append(x)
            x = block(x)
        for block, skip in zip(self.up, reversed(skips)):
            x = block(x, skip)
        return self.conv_out(x).permute(0, 2, 3, 1)


def _widths(state_dict):
    n = sum(1 for name in state_dict
            if name.startswith("down.") and name.endswith(".conv.weight"))
    return {"encoder_filters": tuple(
        int(state_dict["down.%d.conv.weight" % i].shape[0])
        for i in range(n))}


@register_model("unet", widths=_widths)
def build_unet(num_classes=3, dtype="float32",
               encoder_filters=(32, 64, 128, 256)):
    return UNet(num_classes=num_classes, encoder_filters=encoder_filters,
                dtype=_torch_dtype(dtype))


def loss_fn(model):
    """Masked per-pixel cross-entropy for the Trainer contract
    (``fn(params, batch, mask) -> (loss, aux)``; the mask is per row, from
    the infeed), with the JAX package's ``accuracy`` aux."""
    def loss(params, batch, mask):
        logits = torch.func.functional_call(model, params, (batch["image"],))
        labels = batch["mask"].long()
        ce = F.cross_entropy(logits.permute(0, 3, 1, 2), labels,
                             reduction="none").mean((1, 2))
        mask = mask.to(ce.dtype)
        count = mask.sum().clamp_min(1.0)
        ce = (ce * mask).sum() / count
        acc = (logits.argmax(-1) == labels).to(ce.dtype).mean((1, 2))
        acc = (acc * mask).sum() / count
        return ce, {"accuracy": acc}

    return loss
