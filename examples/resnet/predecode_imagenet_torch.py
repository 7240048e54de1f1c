"""Offline pre-decode CLI on the PyTorch port (the twin of
``examples/resnet/predecode_imagenet.py``): JPEG ImageNet TFRecord shards
-> fixed-size uint8 tensor shards (the decode-free hot path; see
``imagenet_input_torch.predecode_shards``).

Run once per dataset, then point ``resnet_imagenet_torch.py --data_dir``
at the output with ``--predecoded`` (reader swap only; training math
unchanged):

    python predecode_imagenet_torch.py --src_dir /data/imagenet/train \\
        --out_dir /data/imagenet-raw/train --store_px 256 --procs 8

Sharded across ``--procs`` spawned worker processes (one input shard per
task).  Decoding JPEG needs PIL or OpenCV, as the JAX script does: run it
on a host that has one, and ship the output to the card's host.
"""

import argparse
import multiprocessing as mp
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def _one(task):
    import imagenet_input_torch

    path, out_dir, store_px, label_offset = task
    imagenet_input_torch.predecode_shards(
        [path], out_dir, store_px=store_px, label_offset=label_offset)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--pattern", default="train-*")
    ap.add_argument("--store_px", type=int, default=256)
    ap.add_argument("--label_offset", type=int, default=-1)
    ap.add_argument("--procs", type=int, default=max(os.cpu_count() - 1, 1))
    args = ap.parse_args(argv)

    from tensorflowonspark_torch import data as data_mod

    shards = data_mod.list_shards(args.src_dir, args.pattern)
    if not shards:
        raise SystemExit("no shards matching {!r} in {}".format(
            args.pattern, args.src_dir))
    tasks = [(p, args.out_dir, args.store_px, args.label_offset)
             for p in shards]
    t0 = time.time()
    if args.procs > 1:
        with mp.get_context("spawn").Pool(args.procs) as pool:
            for i, path in enumerate(pool.imap_unordered(_one, tasks), 1):
                print("[%d/%d] %s" % (i, len(tasks), path), flush=True)
    else:
        for i, task in enumerate(tasks, 1):
            _one(task)
            print("[%d/%d] %s" % (i, len(tasks), task[0]), flush=True)
    print("predecoded %d shards in %.1fs -> %s"
          % (len(tasks), time.time() - t0, args.out_dir))


if __name__ == "__main__":
    main()
