"""ImageNet TFRecord input for the ResNet twin on the PyTorch port (the
port's copy of ``examples/resnet/imagenet_input.py``; the copy is the
port's own and imports the port's ``example_proto``/``tfrecord``).

The reference reads ImageNet from the standard TFRecord shards with
``tf.data`` + TF image ops (reference ``examples/resnet/
imagenet_preprocessing.py``: parse Example -> decode JPEG -> random
resized crop + horizontal flip (train) / resize + center crop (eval) ->
channel-mean subtraction).  This module is that pipeline with no
TensorFlow:

- ``imagenet_reader`` is a ``data.FileFeed`` row reader: TFRecord codec ->
  tf.train.Example wire parse -> JPEG decode -> numpy crops.  The decode
  engine is OpenCV (libjpeg, with reduced-resolution decode) when
  available, PIL otherwise: a host without either cannot read JPEG shards
  (pre-decode them elsewhere, :func:`predecode_shards`).  The crop window
  is sampled from the JPEG *header* dimensions before any pixel is
  decoded, so the decoder can skip straight to the largest power-of-two
  downscale that still covers the crop (the reference's partial decode,
  ``imagenet_preprocessing.py:87-113``, traded for DCT scaled decoding).
- Rows leave as **uint8 HWC**, 1 byte/pixel across the host->device link;
  the channel-mean normalization belongs on the card inside the step
  (:func:`normalize_on_device`).
- Decode is CPU-bound: to scale it past one core, wrap the reader in
  ``data.ProcessPoolFeed`` (spawned worker processes, one decode engine
  each): ``resnet_imagenet_torch.py --decode_procs N``.
- :func:`predecoded_reader` reads :func:`predecode_shards` output (fixed-
  size uint8 rows, no decoder); with ``device_crop=True`` the crop and flip
  run on the card (``tensorflowonspark_torch.ops.augment.crop_and_flip``).

Standard shard feature keys (same as the reference's ``_parse_example_proto``,
``imagenet_preprocessing.py``): ``image/encoded`` (JPEG bytes),
``image/class/label`` (int, 1-based in the classic shards).
"""

import io

import numpy as np

# Reference channel means (imagenet_preprocessing.py CHANNEL_MEANS),
# subtracted on device after the uint8 batch lands.
CHANNEL_MEANS = (123.68, 116.779, 103.939)

_cv2 = None


def _get_cv2():
    """cv2 module or None; single-threaded (readers parallelize at the
    row level — an internal cv2 pool would oversubscribe)."""
    global _cv2
    if _cv2 is None:
        try:
            import cv2

            cv2.setNumThreads(1)
            _cv2 = cv2
        except ImportError:
            _cv2 = False
    return _cv2 or None


def jpeg_size(data):
    """(width, height) from the JPEG header — no pixel decode (PIL opens
    lazily; ``.size`` only parses markers)."""
    from PIL import Image

    return Image.open(io.BytesIO(data)).size


def sample_crop_box(w, h, rng, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                    attempts=10):
    """Sample the reference's random area/aspect crop window from image
    DIMENSIONS alone (reference ``_decode_crop_and_flip`` sampling,
    ``imagenet_preprocessing.py:87-113``); None = no window fit (caller
    falls back to a center crop)."""
    area = w * h
    for _ in range(attempts):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            return x, y, cw, ch
    return None


def _reduce_factor(min_side, needed):
    """Largest power-of-two downscale (<=8) whose result still covers
    ``needed`` pixels on the shortest relevant side."""
    k = 1
    while k < 8 and (min_side >> (k.bit_length())) >= needed:
        k <<= 1
    return k


_REDUCED_FLAGS = {}


def _decode_rgb(data, reduce_k=1):
    """JPEG bytes -> RGB uint8 ndarray at 1/reduce_k linear resolution.
    cv2 (reduced-resolution decode) when importable, PIL (+draft) fallback."""
    cv2 = _get_cv2()
    if cv2 is not None:
        if not _REDUCED_FLAGS:
            _REDUCED_FLAGS.update({
                1: cv2.IMREAD_COLOR, 2: cv2.IMREAD_REDUCED_COLOR_2,
                4: cv2.IMREAD_REDUCED_COLOR_4, 8: cv2.IMREAD_REDUCED_COLOR_8})
        arr = cv2.imdecode(np.frombuffer(data, np.uint8),
                           _REDUCED_FLAGS[reduce_k])
        if arr is not None:
            return arr[:, :, ::-1]  # BGR -> RGB
        # corrupt-for-cv2 image: fall through to PIL
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if reduce_k > 1:
        img.draft("RGB", (max(1, img.size[0] // reduce_k),
                          max(1, img.size[1] // reduce_k)))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8)


def _resize(arr, out_w, out_h):
    cv2 = _get_cv2()
    if cv2 is not None:
        return cv2.resize(np.ascontiguousarray(arr), (out_w, out_h),
                          interpolation=cv2.INTER_LINEAR)
    from PIL import Image

    img = Image.fromarray(arr).resize((out_w, out_h), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def random_resized_crop(data, size, rng, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3), attempts=10):
    """Train-time path: sample the crop from header dims, decode at the
    coarsest sufficient resolution, slice, resize to ``size`` x ``size``."""
    w, h = jpeg_size(data)
    box = sample_crop_box(w, h, rng, scale, ratio, attempts)
    if box is None:
        return center_crop(data, size)
    x, y, cw, ch = box
    k = _reduce_factor(min(cw, ch), size)
    arr = _decode_rgb(data, k)
    # Map the crop by the scale the decoder ACTUALLY applied (header dims
    # vs array dims), not by the requested k: a fallback decoder that
    # ignores the reduction request (PIL draft on progressive/non-JPEG
    # data) would otherwise get a k-times-smaller top-left-pinned crop.
    ah, aw = arr.shape[:2]
    kx, ky = w / aw, h / ah
    x0, y0 = min(int(x / kx), aw - 1), min(int(y / ky), ah - 1)
    x1 = max(x0 + 1, min(int(round((x + cw) / kx)), aw))
    y1 = max(y0 + 1, min(int(round((y + ch) / ky)), ah))
    return _resize(arr[y0:y1, x0:x1], size, size)


def center_crop(data, size, resize_shorter=256):
    """Eval-time path (reference ``_central_crop`` + aspect-preserving
    resize): shorter side to ``resize_shorter``, central ``size`` window."""
    w, h = jpeg_size(data)
    k = _reduce_factor(min(w, h), resize_shorter)
    arr = _decode_rgb(data, k)
    ah, aw = arr.shape[:2]
    s = resize_shorter / min(aw, ah)
    arr = _resize(arr, max(size, int(round(aw * s))),
                  max(size, int(round(ah * s))))
    ah, aw = arr.shape[:2]
    x = (aw - size) // 2
    y = (ah - size) // 2
    return arr[y:y + size, x:x + size]


def imagenet_reader(train=True, image_size=224, seed=0,
                    label_offset=-1):
    """Returns a ``data.FileFeed`` row reader for ImageNet TFRecord shards.

    Yields ``{"image": uint8 (H, W, 3), "label": int32}`` rows.
    ``label_offset=-1`` maps the classic shards' 1-based labels to 0-based.
    """
    def reader(path):
        import zlib

        from tensorflowonspark_torch import example_proto, tfrecord

        # stable per-file stream (hash() is process-randomized; crc32 isn't)
        rng = np.random.default_rng((seed, zlib.crc32(path.encode())))
        for rec in tfrecord.tfrecord_iterator(path):
            feats = example_proto.decode_example(rec)
            _, encoded = feats["image/encoded"]
            _, label = feats["image/class/label"]
            if train:
                arr = random_resized_crop(encoded[0], image_size, rng)
                if rng.random() < 0.5:
                    arr = arr[:, ::-1]  # horizontal flip
            else:
                arr = center_crop(encoded[0], image_size)
            yield {
                "image": np.ascontiguousarray(arr),
                "label": np.int32(int(label[0]) + label_offset),
            }

    return reader


def normalize_on_device(image_batch, dtype=None):
    """uint8 batch on the card -> ``dtype`` (default bf16) less the
    reference channel means (rounded to ``dtype``, as the JAX function
    rounds them); call it INSIDE the loss so the host->device link carries
    1 byte/pixel.  The means are built on the device from Python scalars,
    with no host copy, so a CUDA graph captures the call."""
    import torch

    dtype = dtype or torch.bfloat16
    means = torch.cat([torch.full((1,), m, dtype=dtype,
                                  device=image_batch.device)
                       for m in CHANNEL_MEANS])
    return image_batch.to(dtype) - means


def write_synthetic_shards(out_dir, num_examples=64, num_shards=4,
                           image_size=64, num_classes=1000, seed=0,
                           split="train"):
    """Stage tiny synthetic ImageNet-format TFRecord shards (random JPEGs,
    1-based labels) — for tests and smoke runs without the real dataset."""
    import os

    from tensorflowonspark_torch import example_proto, tfrecord
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    per = max(1, num_examples // num_shards)
    n = 0
    for s in range(num_shards):
        path = os.path.join(out_dir, "{}-{:05d}-of-{:05d}".format(
            split, s, num_shards))
        with tfrecord.TFRecordWriter(path) as w:
            for _ in range(per):
                arr = rng.integers(0, 256, (image_size, image_size, 3),
                                   np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG")
                rec = example_proto.encode_example({
                    "image/encoded": ("bytes", [buf.getvalue()]),
                    "image/class/label":
                        ("int64", [int(rng.integers(1, num_classes + 1))]),
                })
                w.write(rec)
                n += 1
    return n


# ---------------------------------------------------------------------------
# Offline pre-decode: the deployment recipe when host cores can't sustain
# the card's JPEG consumption rate (the reference leaned on tf.data's C++
# decode pool, ``imagenet_preprocessing.py:87-113``).
# Decode every JPEG ONCE offline into fixed-size uint8 tensor records;
# training reads become a frombuffer + cheap uint8 crop — no decoder in the
# hot path at all.
# ---------------------------------------------------------------------------

def predecode_shards(src_files, out_dir, store_px=256, label_offset=-1,
                     progress_every=0):
    """Rewrite ImageNet JPEG TFRecord shards as fixed-size uint8 tensors.

    Each output record is ``image_raw`` (``store_px x store_px x 3`` uint8,
    shorter-side-resized + center-cropped — crop/flip augmentation is NOT
    baked in; it happens cheaply at read time on the uint8 array) plus
    ``label`` (already ``label_offset``-mapped to 0-based).  Storage cost:
    ``store_px**2 * 3`` bytes/row (196 KiB at 256px) vs ~110 KiB JPEG —
    a ~1.8x size trade for a decode-free hot path.

    One output shard per input shard (same basename + ``.raw``), so the
    FILES-mode per-worker sharding (``data.shard_for_process``) carries
    over unchanged.
    """
    import os

    from tensorflowonspark_torch import example_proto, tfrecord

    os.makedirs(out_dir, exist_ok=True)
    outs = []
    done = 0
    for path in src_files:
        out_path = os.path.join(out_dir, os.path.basename(path) + ".raw")
        with tfrecord.TFRecordWriter(out_path) as w:
            for rec in tfrecord.tfrecord_iterator(path):
                feats = example_proto.decode_example(rec)
                _, encoded = feats["image/encoded"]
                _, label = feats["image/class/label"]
                arr = center_crop(encoded[0], store_px,
                                  resize_shorter=store_px)
                w.write(example_proto.encode_example({
                    "image_raw": ("bytes", [np.ascontiguousarray(
                        arr).tobytes()]),
                    "label": ("int64", [int(label[0]) + label_offset]),
                }))
                done += 1
                if progress_every and done % progress_every == 0:
                    print("predecoded %d rows" % done, flush=True)
        outs.append(out_path)
    return outs


def predecoded_reader(train=True, image_size=224, store_px=256, seed=0,
                      device_crop=False):
    """``data.FileFeed`` row reader for :func:`predecode_shards` output.

    Per row: ``np.frombuffer`` + reshape (zero-copy view of the record),
    then train-time random ``image_size`` crop + horizontal flip (eval:
    center crop).  No JPEG decoder anywhere.

    Two crop modes:

    - ``device_crop=False``: crop/flip as host uint8 slicing; rows are
      ``{"image": (S,S,3)}``.  Simple, but a strided crop copy per row at
      the batch assembler.
    - ``device_crop=True``: pixels ship UNTOUCHED as the full contiguous ``store_px`` row (the
      host's only per-pixel work is the contiguous batch memcpy) plus
      sampled ``cropx/cropy/flip`` ints; the crop happens on device via
      :func:`tensorflowonspark_torch.ops.augment.crop_and_flip` in
      the step.  Rows are ``{"image": (store_px,store_px,3),
      "cropx","cropy","flip": int32}``.  CRC verification is skipped
      (our own writer verified at write time; the crc pass costs more
      than the whole parse on 196 KB rows).

    Augmentation note: the stored image is already shorter-side-resized to
    ``store_px``, so the random crop here is the classic fixed-scale crop,
    not ``random_resized_crop``'s scale/aspect sampling — document the
    swap when comparing accuracy curves against the JPEG path.
    """
    import zlib

    from tensorflowonspark_torch import example_proto, tfrecord

    def reader(path):
        rng = np.random.default_rng((seed, zlib.crc32(path.encode())))
        margin = store_px - image_size
        for rec in tfrecord.tfrecord_iterator(
                path, verify_crc=not device_crop):
            feats = example_proto.decode_example(rec)
            _, raw = feats["image_raw"]
            _, label = feats["label"]
            arr = np.frombuffer(raw[0], np.uint8).reshape(
                store_px, store_px, 3)
            if device_crop:
                if train and margin > 0:
                    x = int(rng.integers(0, margin + 1))
                    y = int(rng.integers(0, margin + 1))
                else:
                    x = y = margin // 2
                # flip is gated on `train` ALONE: with store_px ==
                # image_size (margin 0) training must still flip 50%,
                # matching the JPEG path's augmentation.  Drawn AFTER the
                # crop ints — the host-crop branch consumes the rng in the
                # same order, so the two modes sample identical augs.
                flip = int(train and rng.random() < 0.5)
                # plain ints, not np scalars: the columnar assembler stacks
                # them with one np.asarray per column either way, and per-row
                # np.int32 construction is measurable at these rates
                yield {"image": arr, "cropx": x, "cropy": y, "flip": flip,
                       "label": int(label[0])}
                continue
            if train:
                if margin > 0:
                    x = int(rng.integers(0, margin + 1))
                    y = int(rng.integers(0, margin + 1))
                    arr = arr[y:y + image_size, x:x + image_size]
                if rng.random() < 0.5:
                    arr = arr[:, ::-1]
            elif margin > 0:
                off = margin // 2
                arr = arr[off:off + image_size, off:off + image_size]
            yield {"image": np.ascontiguousarray(arr),
                   "label": np.int32(int(label[0]))}

    return reader
