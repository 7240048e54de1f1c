"""Local + remote filesystem access for the data path.

The reference trains from HDFS: executors read TFRecord shards through
Hadoop's filesystem layer (classpath plumbing ``TFSparkNode.py:191-197``,
TFRecord loads ``dfutil.py:44-81``, tf.data file reads
``examples/mnist/keras/mnist_tf.py:23-27``).  The TPU-first deployment
equivalent is an object store — on a v5e pod the training shards live in
GCS — so every file touch in the data path (TFRecord read/write, shard
listing, raw byte streams) routes through this module:

- **local paths stay on the stdlib fast path** (``open``/``glob``/``os``)
  — zero new overhead for the common case;
- **URLs with a scheme** (``gs://``, ``hdfs://``, ``s3://``, ``memory://``,
  …) go through ``fsspec``, which resolves the protocol to an installed
  backend (``gcsfs`` for GCS, ``pyarrow``/``fsspec[hdfs]`` for HDFS).
  ``fsspec`` itself is a hard dependency of this module's remote branch
  only; a purely-local workload never imports it.

``file://`` URLs are normalized to plain local paths.
"""

import glob as _glob
import os

__all__ = ["is_remote", "open_file", "glob", "isdir", "exists", "makedirs",
           "join", "strip_file_scheme"]


def strip_file_scheme(path):
    """``file:///x`` / ``file:/x`` -> ``/x`` (local paths with an explicit
    scheme take the stdlib fast path like any other local path)."""
    if path.startswith("file://"):
        return path[len("file://"):] or "/"
    if path.startswith("file:"):
        return path[len("file:"):]
    return path


def _scheme(path):
    """URL scheme of ``path``, or None for plain local paths.  A Windows
    drive letter (``C:\\...``) is not a scheme; neither is a path with no
    ``://``."""
    head, sep, _ = path.partition("://")
    if not sep or not head or "/" in head:
        return None
    return head


def is_remote(path):
    """True when ``path`` needs an fsspec backend (any scheme but file)."""
    return _scheme(strip_file_scheme(path)) is not None


def _fs(path):
    import fsspec

    return fsspec.core.url_to_fs(path)


def open_file(path, mode="rb", **kwargs):
    """Open ``path`` for streaming IO: builtin ``open`` locally, an fsspec
    buffered file for remote URLs.  Both return context-manager file
    objects with the standard read/write/seek surface."""
    path = strip_file_scheme(path)
    if not is_remote(path):
        return open(path, mode, **kwargs)
    import fsspec

    return fsspec.open(path, mode, **kwargs).open()


def glob(pattern):
    """Sorted matches for ``pattern``; remote results keep their scheme."""
    pattern = strip_file_scheme(pattern)
    if not is_remote(pattern):
        return sorted(_glob.glob(pattern))
    fs, rel = _fs(pattern)
    return sorted(fs.unstrip_protocol(p) for p in fs.glob(rel))


def isdir(path):
    path = strip_file_scheme(path)
    if not is_remote(path):
        return os.path.isdir(path)
    fs, rel = _fs(path)
    return fs.isdir(rel)


def exists(path):
    path = strip_file_scheme(path)
    if not is_remote(path):
        return os.path.exists(path)
    fs, rel = _fs(path)
    return fs.exists(rel)


def makedirs(path, exist_ok=True):
    """mkdir -p; for object stores this is a (cheap) no-op placeholder."""
    path = strip_file_scheme(path)
    if not is_remote(path):
        os.makedirs(path, exist_ok=exist_ok)
        return
    fs, rel = _fs(path)
    fs.makedirs(rel, exist_ok=exist_ok)


def join(base, *parts):
    """Path join that preserves URL schemes (``os.path.join`` would not
    mangle them on posix, but this keeps intent explicit and wins on
    Windows)."""
    if is_remote(base):
        pieces = [base.rstrip("/")]
        pieces.extend(p.strip("/") for p in parts)
        return "/".join(pieces)
    return os.path.join(base, *parts)
