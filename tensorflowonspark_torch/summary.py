"""TensorBoard scalar summaries with no TensorFlow dependency.

The port's copy of :mod:`tensorflowonspark_tpu.summary` (it never imported
jax); the copy is the port's own.

The reference's training curves come from Keras/estimator summary writers
inside the user fn (reference ``examples/mnist/keras/mnist_spark.py``
TensorBoard callback); the framework launches TensorBoard on the chief
(``node.py``) but had nothing writing scalar events.  This module closes
that: :class:`SummaryWriter` emits standard ``events.out.tfevents.*`` files
— TFRecord-framed ``tensorflow.Event`` protos, hand-encoded on the same
wire helpers as :mod:`~tensorflowonspark_torch.example_proto` and framed by
the native TFRecord codec — readable by stock TensorBoard.

Wire schema (tensorflow/core/util/event.proto, public format):

- ``Event``: ``double wall_time = 1`` (64-bit), ``int64 step = 2``
  (varint), ``string file_version = 3``, ``Summary summary = 5``.
- ``Summary``: ``repeated Value value = 1``; ``Value``: ``string tag = 1``,
  ``float simple_value = 2`` (32-bit).

Usage (chief-only, like every reference example; local paths only —
``file://`` is stripped, remote schemes are rejected)::

    with summary.SummaryWriter(args.log_dir) as writer:
        writer.add_scalar("loss", float(loss), step)
"""

import itertools
import json
import os
import socket
import struct
import time

from tensorflowonspark_torch import tfrecord
from tensorflowonspark_torch.example_proto import (
    _write_len_delimited, _write_tag, _write_varint)

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_I32 = 5

#: Per-process monotonic counter folded into event filenames: two writers
#: opened in the same process within the same wall-clock second (retry
#: loops, tests) would otherwise produce the SAME path and silently
#: interleave their records into one file.
_FILE_COUNTER = itertools.count()


def _encode_value(tag, simple_value):
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode("utf-8"))
    _write_tag(out, 2, _WIRE_I32)
    out += struct.pack("<f", float(simple_value))
    return bytes(out)


def encode_scalar_event(tag, value, step, wall_time=None):
    """One ``Event{step, wall_time, summary{value{tag, simple_value}}}``."""
    summary = bytearray()
    _write_len_delimited(summary, 1, _encode_value(tag, value))
    out = bytearray()
    _write_tag(out, 1, _WIRE_I64)
    out += struct.pack("<d", time.time() if wall_time is None else wall_time)
    _write_tag(out, 2, _WIRE_VARINT)
    _write_varint(out, int(step))
    _write_len_delimited(out, 5, bytes(summary))
    return bytes(out)


def _encode_text_value(tag, text):
    """A text-plugin ``Summary.Value``: ``metadata.plugin_data.plugin_name =
    "text"`` (field 9 → 1 → 1) plus a rank-1 DT_STRING ``tensor`` (field 8:
    dtype=7, shape dim size 1, ``string_val``) — the public wire shape
    TensorBoard's text dashboard reads."""
    plugin_data = bytearray()
    _write_len_delimited(plugin_data, 1, b"text")
    metadata = bytearray()
    _write_len_delimited(metadata, 1, bytes(plugin_data))
    dim = bytearray()
    _write_tag(dim, 1, _WIRE_VARINT)
    _write_varint(dim, 1)
    shape = bytearray()
    _write_len_delimited(shape, 2, bytes(dim))
    tensor = bytearray()
    _write_tag(tensor, 1, _WIRE_VARINT)
    _write_varint(tensor, 7)  # DT_STRING
    _write_len_delimited(tensor, 2, bytes(shape))
    _write_len_delimited(tensor, 8, text.encode("utf-8"))
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode("utf-8"))
    _write_len_delimited(out, 8, bytes(tensor))
    _write_len_delimited(out, 9, bytes(metadata))
    return bytes(out)


def encode_text_event(tag, text, step, wall_time=None):
    """One ``Event`` carrying a text-plugin summary (markdown-rendered by
    TensorBoard's text dashboard)."""
    summary = bytearray()
    _write_len_delimited(summary, 1, _encode_text_value(tag, text))
    out = bytearray()
    _write_tag(out, 1, _WIRE_I64)
    out += struct.pack("<d", time.time() if wall_time is None else wall_time)
    _write_tag(out, 2, _WIRE_VARINT)
    _write_varint(out, int(step))
    _write_len_delimited(out, 5, bytes(summary))
    return bytes(out)


def encode_file_version_event(wall_time=None):
    """The required first record: ``Event{file_version: "brain.Event:2"}``."""
    out = bytearray()
    _write_tag(out, 1, _WIRE_I64)
    out += struct.pack("<d", time.time() if wall_time is None else wall_time)
    _write_len_delimited(out, 3, b"brain.Event:2")
    return bytes(out)


class SummaryWriter(object):
    """Append-only scalar event writer (one standard tfevents file).

    Open it on the chief only — the convention every reference example
    follows — and point the framework-launched TensorBoard at ``logdir``.
    """

    def __init__(self, logdir, filename_suffix=""):
        # Local filesystem only: strip file://, refuse remote schemes loudly
        # (silently creating a literal './hdfs:/...' dir would hide every
        # curve from the TensorBoard watching the real log_dir).
        if logdir.startswith("file://"):
            logdir = logdir[len("file://"):]
        if "://" in logdir:
            raise ValueError(
                "SummaryWriter writes to the local filesystem; got {!r} "
                "(write locally and sync, or mount the remote store)"
                .format(logdir))
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.{:.0f}.{}.{}.{}{}".format(
            time.time(), socket.gethostname(), os.getpid(),
            next(_FILE_COUNTER), filename_suffix)
        self.path = os.path.join(logdir, name)
        self._writer = tfrecord.TFRecordWriter(self.path)
        self._writer.write(encode_file_version_event())
        self.flush()

    def add_scalar(self, tag, value, step, wall_time=None):
        self._writer.write(
            encode_scalar_event(tag, float(value), step, wall_time))

    def add_scalars(self, scalars, step):
        """``{tag: value}`` convenience (one event per tag, same step)."""
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def add_text(self, tag, text, step=0, wall_time=None):
        """Write a text-plugin event (TensorBoard renders it as markdown)."""
        self._writer.write(encode_text_event(tag, text, step, wall_time))

    def add_run_metadata(self, ctx_or_dict, step=0):
        """Record the run's cluster shape as a step-0 text event, so the
        TensorBoard run carries WHAT produced these curves (cluster size,
        role, host) alongside them.  Pass a node context (its ``job_name``/
        ``task_index``/``num_executors``/``cluster_meta`` are summarized)
        or any JSON-serializable dict."""
        if isinstance(ctx_or_dict, dict):
            info = dict(ctx_or_dict)
        else:
            ctx = ctx_or_dict
            info = {"job_name": getattr(ctx, "job_name", None),
                    "task_index": getattr(ctx, "task_index", None),
                    "executor_id": getattr(ctx, "executor_id", None),
                    "num_executors": getattr(ctx, "num_executors", None),
                    "host": socket.gethostname()}
            meta = getattr(ctx, "cluster_meta", None) or {}
            for key in ("id", "cluster_template", "input_mode"):
                if key in meta:
                    info["cluster_" + key] = meta[key]
        text = "```json\n{}\n```".format(
            json.dumps(info, indent=2, sort_keys=True, default=str))
        self.add_text("run_metadata", text, step=step)

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
