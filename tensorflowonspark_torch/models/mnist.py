"""MNIST CNN of the port (the counterpart of
:mod:`tensorflowonspark_tpu.models.mnist`; the original system's example
CNN family, ``examples/mnist/keras/mnist_spark.py:14-20`` there).

Kept equal to the flax model: inputs NHWC ``[B, 28, 28, 1]``, 3x3 convs
with flax's SAME padding (``padding=1``), the conv output flattened in
NHWC order before ``Dense(128)`` (so converted flax kernels line up), the
hidden layers in the model's ``dtype`` (params and inputs cast to it, as
flax does), the last Dense in fp32, and the same masked loss and accuracy.
"""

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import register_model


def _dense(x, layer, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _conv(x, layer, dtype):
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype),
                    padding=1)


class MnistCNN(nn.Module):
    """Conv(32)->pool->Conv(64)->pool->Dense(128)->Dense(10) over NHWC
    images; fp32 params, compute in ``dtype``, fp32 logits."""

    def __init__(self, num_classes=10, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = nn.Conv2d(1, 32, 3, padding=1)
        self.conv1 = nn.Conv2d(32, 64, 3, padding=1)
        self.dense0 = nn.Linear(7 * 7 * 64, 128)
        self.dense1 = nn.Linear(128, num_classes)

    def forward(self, x):
        # x: [batch, 28, 28, 1] floats in [0, 1]
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(_conv(x, self.conv0, self.dtype)), 2)
        x = F.max_pool2d(F.relu(_conv(x, self.conv1, self.dtype)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        x = F.relu(_dense(x, self.dense0, self.dtype))
        return _dense(x, self.dense1, torch.float32)


@register_model("mnist_cnn")
def build_mnist(num_classes=10, dtype="float32"):
    return MnistCNN(num_classes=num_classes, dtype=getattr(torch, dtype))


def loss_fn(model):
    """Masked softmax cross-entropy for the Trainer contract
    (``fn(params, batch, mask) -> (loss, aux)``), with the JAX package's
    ``accuracy`` and ``logits`` aux."""
    def loss(params, batch, mask):
        logits = torch.func.functional_call(model, params, (batch["image"],))
        labels = batch["label"].long()
        ce = F.cross_entropy(logits, labels, reduction="none")
        mask = mask.to(ce.dtype)
        count = mask.sum().clamp_min(1.0)
        ce = (ce * mask).sum() / count
        acc = ((logits.argmax(-1) == labels) * mask).sum() / count
        return ce, {"accuracy": acc, "logits": logits}

    return loss
