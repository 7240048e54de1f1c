#!/usr/bin/env python
"""Merge a profile capture of the PyTorch port into ONE Perfetto timeline
and print its step-time attribution table.

Input: a ``profiles/<capture_id>/`` directory produced by the observatory's
``GET /profile`` trigger (``tensorflowonspark_torch/profiling.py``): each
node's ``node-<executor>/.../*.pt.trace.json.gz`` Chrome traces and the
``capture.json`` manifest; optionally the telemetry dir holding the
per-process ``trace-<host>-<pid>.json`` host traces.  Output: one Chrome
trace loadable in Perfetto, with the node traces and the host spans on one
wall-clock-µs axis (``profiling.merge_capture``).

Usage:
    python scripts/analyze_profile_torch.py profiles/<capture_id> \
        [--telemetry-dir DIR] [--out merged_timeline.json]
"""

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="merge a profile capture into one Perfetto timeline")
    ap.add_argument("capture_dir",
                    help="profiles/<capture_id> directory from GET /profile")
    ap.add_argument("--telemetry-dir", default=None,
                    help="dir holding the host-side trace-*.json files")
    ap.add_argument("--out", default=None,
                    help="merged output path (default: "
                         "<capture_dir>/merged_timeline.json)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tensorflowonspark_torch import profiling

    profiling.merge_capture(args.capture_dir, args.telemetry_dir, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
