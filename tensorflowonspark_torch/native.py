"""Build/load shim for the repo's first-party native host library (the
port's copy of the JAX package's ``native`` module, reduced to what the
port loads: ``libshmring`` and ``libtfrecord``).

The C++ source lives in the repo's ``native/`` directory.  It is compiled
on first use with the host toolchain into ``build/native/`` at the repo
root (a directory ``.gitignore`` lists), never next to the source, and
loaded via ctypes.  Consumers must tolerate a missing toolchain: the shm
ring has a pure-Python fallback (the manager queue carries the chunks),
and so has the TFRecord codec.
"""

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_lock = threading.Lock()
_cache = {}


def _compile(src, out, flags, timeout, libs=()):
    """Compile ``src`` -> ``out`` when missing/stale.  Compiles to a private
    temp file, then atomically renames: many executor processes race this
    build on one host, and dlopen of a half-written binary would
    permanently demote that process to its fallback path.

    ``libs`` go AFTER the source on the command line: with the default
    ``--as-needed`` link order, a ``-l`` before the object that needs it is
    silently dropped — the .so builds but dlopen later fails on the
    unresolved symbol."""
    stale = (not os.path.exists(out)
             or os.path.getmtime(out) < os.path.getmtime(src))
    if not stale:
        return
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = "{}.tmp.{}".format(out, os.getpid())
    cmd = (["g++", "-O3", "-std=c++17"] + list(flags) + ["-o", tmp, src]
           + ["-l" + l for l in libs])
    logger.info("building native code: %s", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=True, timeout=timeout)
    os.replace(tmp, out)


def build_shared(name, timeout=240, libs=()):
    """Build ``native/<name>.cc`` into ``build/native/lib<name>.so`` and
    return its path, or None when the toolchain is absent."""
    key = ("so-path", name)
    with _lock:
        if key in _cache:
            return _cache[key]
        out = None
        try:
            src = os.path.join(_NATIVE_DIR, name + ".cc")
            so = os.path.join(_BUILD_DIR, "lib{}.so".format(name))
            if os.path.exists(src):
                _compile(src, so, ["-shared", "-fPIC"], timeout, libs=libs)
                out = so
        except Exception:
            logger.warning("native shared lib %s unavailable", name,
                           exc_info=True)
            out = None
        _cache[key] = out
        return out


def load(name, libs=()):
    """Load ``lib<name>.so``, building it from ``native/<name>.cc`` first if
    missing or stale (via :func:`build_shared`); returns a ``ctypes.CDLL``
    or None on any failure."""
    with _lock:
        if name in _cache:
            return _cache[name]
    so = build_shared(name, timeout=120, libs=libs)
    with _lock:
        if name in _cache:  # lost a race with another loader
            return _cache[name]
        lib = None
        try:
            if so is not None:
                lib = ctypes.CDLL(so)
        except Exception:
            logger.warning("native %s unavailable; using pure-python fallback",
                           name, exc_info=True)
            lib = None
        _cache[name] = lib
        return lib
