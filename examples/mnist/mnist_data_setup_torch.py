"""Stage MNIST to CSV and TFRecords with the PyTorch port (the twin of
``examples/mnist/mnist_data_setup.py``; reference
``examples/mnist/mnist_data_setup.py``).

The same script through the port's ``dfutil``: it reads the classic IDX
files when ``--idx_dir`` is given (no network in the loop) and otherwise
generates the deterministic synthetic stand-in with the same shapes and
dtypes, and writes the same bytes as the JAX script.  The synthetic
generator here is the one the port's MNIST examples train on.

Output layout (per split):
    <output>/csv/<split>/part-00000.csv      label,784 comma-separated pixels
    <output>/tfr/<split>/part-r-00000        tf.train.Example records
                                             {image: float list, label: int}

Run:
    python examples/mnist/mnist_data_setup_torch.py --output data/mnist
"""

import argparse
import gzip
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from tensorflowonspark_torch import dfutil  # noqa: E402


def load_idx(idx_dir, split):
    """Read images/labels from IDX (optionally .gz) files."""
    names = {
        "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }[split]

    def _open(base):
        for suffix in ("", ".gz"):
            path = os.path.join(idx_dir, base + suffix)
            if os.path.exists(path):
                return gzip.open(path, "rb") if suffix else open(path, "rb")
        raise IOError("missing IDX file {} under {}".format(base, idx_dir))

    with _open(names[0]) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, "bad images magic {}".format(magic)
        images = np.frombuffer(f.read(n * rows * cols), np.uint8)
        images = images.reshape(n, rows * cols)
    with _open(names[1]) as f:
        magic, n2 = struct.unpack(">II", f.read(8))
        assert magic == 2049, "bad labels magic {}".format(magic)
        labels = np.frombuffer(f.read(n2), np.uint8)
    assert n == n2
    return images, labels


def synthetic_mnist(split, seed=7):
    """Deterministic MNIST-shaped synthetic data: each class gets a fixed
    random template; samples are noisy copies.  Learnable by the example CNN,
    so end-to-end runs show a falling loss."""
    n = 60000 if split == "train" else 10000
    rng = np.random.default_rng(seed)
    templates = (rng.random((10, 784)) * 255).astype(np.uint8)
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    labels = rng.integers(0, 10, (n,), np.uint8)
    noise = rng.integers(-20, 21, (n, 784), np.int16)
    images = np.clip(templates[labels].astype(np.int16) + noise, 0, 255)
    return images.astype(np.uint8), labels


def write_csv(images, labels, out_dir, num_partitions):
    os.makedirs(out_dir, exist_ok=True)
    splits = np.array_split(np.arange(len(labels)), num_partitions)
    for p, idx in enumerate(splits):
        path = os.path.join(out_dir, "part-{:05d}.csv".format(p))
        with open(path, "w") as f:
            for i in idx:
                f.write(str(int(labels[i])) + "," +
                        ",".join(str(int(v)) for v in images[i]) + "\n")


def write_tfrecords(images, labels, out_dir, num_partitions):
    rows = [{"image": (images[i] / 255.0).astype(np.float32).tolist(),
             "label": int(labels[i])} for i in range(len(labels))]
    schema = {"image": "array<float32>", "label": "int64"}
    dfutil.save_as_tfrecords(rows, out_dir, schema=schema,
                             num_shards=num_partitions)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", default="data/mnist",
                        help="output root directory")
    parser.add_argument("--idx_dir", default=None,
                        help="directory with the classic IDX files; synthetic "
                             "data is generated when omitted")
    parser.add_argument("--format", choices=["csv", "tfr", "both"],
                        default="both")
    parser.add_argument("--num_partitions", type=int, default=10)
    args = parser.parse_args(argv)

    for split in ("train", "test"):
        if args.idx_dir:
            images, labels = load_idx(args.idx_dir, split)
        else:
            images, labels = synthetic_mnist(split)
        if args.format in ("csv", "both"):
            write_csv(images, labels,
                      os.path.join(args.output, "csv", split),
                      args.num_partitions)
        if args.format in ("tfr", "both"):
            write_tfrecords(images, labels,
                            os.path.join(args.output, "tfr", split),
                            args.num_partitions)
        print("wrote {} {} examples under {}".format(
            len(labels), split, args.output))


if __name__ == "__main__":
    main()
