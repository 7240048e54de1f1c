"""On-device image augmentation: per-row crop and horizontal flip inside
the training step (the port of :mod:`tensorflowonspark_tpu.ops.augment`,
which is plain XLA there, no Pallas kernel).

The device half of the pre-decoded ImageNet path
(``examples/resnet/imagenet_input_torch.predecoded_reader(device_crop=True)``):
the host ships the stored ``store_px`` uint8 rows untouched plus three int
vectors, and the crop window and flip happen here, on the card, as one
gather.  Host-side counterpart with the same sampling:
``predecoded_reader(device_crop=False)``.
"""

import torch


def crop_and_flip(images, xs, ys, flips, size):
    """Per-row ``size``-crop and optional horizontal flip.

    Args:
      images: ``[B, H, W, C]`` (any dtype; uint8 stays uint8: the cast and
        the channel means belong to the normalize step).
      xs, ys: ``[B]`` int top-left corners (``0 <= x <= W - size``; out of
        range is clamped, as ``lax.dynamic_slice`` clamps).
      flips: ``[B]`` int or bool; nonzero rows flip left-right.
      size: the crop size (static).

    Returns ``[B, size, size, C]``.  One advanced-indexing gather built from
    ``arange`` plus the offsets, the flip a ``torch.where`` on the column
    index: no host sync and no data-dependent shape, so a CUDA graph
    captures it (the offsets must already be tensors on the card there)."""
    b, h, w, _ = images.shape
    dev = images.device
    xs = torch.as_tensor(xs, device=dev).long().clamp(0, w - size)
    ys = torch.as_tensor(ys, device=dev).long().clamp(0, h - size)
    flips = torch.as_tensor(flips, device=dev) != 0
    r = torch.arange(size, device=dev)
    rows = ys[:, None] + r[None, :]                          # [B, size]
    cols = xs[:, None] + torch.where(flips[:, None], size - 1 - r[None, :],
                                     r[None, :])             # [B, size]
    batch = torch.arange(b, device=dev)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]
