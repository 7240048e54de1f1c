"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``.
Libraries land in :func:`build_dir`, named by a hash of the sources, the
flags and the toolkit's version line, so an edited source or another
``nvcc`` rebuilds at its first use and an unchanged one loads at once.
Several sources build in parallel, one ``nvcc`` each.  Nothing is built when
this module is imported.

The build directory is the first tier of the compile plane
(:mod:`~tensorflowonspark_torch.compilecache`): under a configured compile
root (:data:`CACHE_DIR_ENV`, read at every call, so forked children inherit
it) it is ``<root>/kernels``, which a cluster can share; otherwise
``build/kernels`` beside the package.  Each library has its build seconds
recorded beside it (``<library>.json``).  :func:`install` lays a library
down from its bytes (the second tier, a stored artifact) without running
``nvcc``, and the one :func:`load` serves both tiers.  Listeners
(:func:`add_listener`) hear ``"cache_hit"`` when a library is found on disk
and loaded, and ``"cache_miss"`` when ``nvcc`` ran.
"""

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: the compile root (``compilecache.CACHE_DIR_ENV``): libraries live in its
#: ``kernels`` subdirectory when it is set
CACHE_DIR_ENV = "TFOS_COMPILE_CACHE_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED = {}
_TOOLKITS = {}       # nvcc path -> its version line
_LISTENERS = []
_MADE_HERE = set()   # library paths this process built or installed
#: ``nvcc`` processes this process started
nvcc_runs = 0


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s, or
    the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                           "to build the port's kernels")
    return found


def toolkit():
    """The CUDA compiler's version line (the ``release`` line of ``nvcc
    --version``), or None where there is no ``nvcc``.  Part of every
    library's key: a build from another toolkit is never loaded."""
    try:
        path = nvcc_path()
    except RuntimeError:
        return None
    with _LOCK:
        if path not in _TOOLKITS:
            try:
                out = subprocess.run([path, "--version"], capture_output=True,
                                     text=True, timeout=120).stdout
            except (OSError, subprocess.SubprocessError) as e:
                out = "unreadable: {}".format(type(e).__name__)
            lines = [line.strip() for line in out.splitlines()
                     if line.strip()]
            release = [line for line in lines if "release" in line]
            _TOOLKITS[path] = (release or lines or [path])[-1]
        return _TOOLKITS[path]


def build_dir():
    """Where libraries are built and loaded from: ``<compile root>/kernels``
    under a configured compile root, else ``build/kernels``."""
    root = os.environ.get(CACHE_DIR_ENV)
    return Path(root) / "kernels" if root else BUILD_DIR


def kernel_names():
    """Every kernel source in ``csrc/``, by name (file stem)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def digest(name):
    """The key of kernel ``name``'s library: a hash of its source, the
    shared headers, the flags and the toolkit's version line."""
    h = hashlib.sha256()
    for path in [CSRC / (name + ".cu")] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(toolkit()).encode())
    return h.hexdigest()[:16]


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to (see :func:`digest`)."""
    return build_dir() / "lib{}-{}.so".format(name, digest(name))


def add_listener(fn):
    """Call ``fn(event, **kwargs)`` on every tier-1 outcome (idempotent):
    ``"cache_hit"`` with ``saved_secs`` (the build seconds recorded beside
    the library) and ``retrieval_secs`` (the ``dlopen``), ``"cache_miss"``
    with ``build_secs``."""
    with _LOCK:
        if fn not in _LISTENERS:
            _LISTENERS.append(fn)


def _emit(event, **kwargs):
    for fn in list(_LISTENERS):
        fn(event, **kwargs)


def recorded_seconds(path):
    """The build seconds recorded beside the library at ``path`` (0.0 when
    none were)."""
    try:
        with open(str(path) + ".json") as f:
            return float(json.load(f).get("seconds", 0.0))
    except (OSError, ValueError, TypeError, AttributeError):
        return 0.0


def _record(path, seconds):
    tmp = "{}.json.tmp{}".format(path, os.getpid())
    with open(tmp, "w") as f:
        json.dump({"seconds": seconds, "toolkit": toolkit()}, f)
    os.replace(tmp, str(path) + ".json")


def build(names=None):
    """Build the named kernels (default: all) that are not built yet, all
    ``nvcc`` processes at once.  Returns ``{name: {"path", "seconds",
    "cached", "log"}}``; ``log`` is the compiler's output, which holds the
    ``-Xptxas -v`` lines (registers, shared memory, spills).  Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    global nvcc_runs
    names = kernel_names() if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    for name in names:
        out = library_path(name)
        log_path = out.with_suffix(".log")
        if out.exists():
            log = log_path.read_text() if log_path.exists() else ""
            results[name] = {"path": str(out), "seconds": 0.0, "cached": True,
                             "log": log}
            continue
        tmp = out.with_name("{}.tmp{}".format(out.name, os.getpid()))
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / (name + ".cu"))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        nvcc_runs += 1
        running[name] = (proc, tmp, out, log_path, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, log_path, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append("{} (nvcc exit {}):\n{}".format(
                name, proc.returncode, log))
            continue
        log_path.write_text(log)
        _record(out, seconds)
        os.replace(tmp, out)
        _MADE_HERE.add(str(out))
        _emit("cache_miss", name=name, build_secs=seconds)
        results[name] = {"path": str(out), "seconds": seconds, "cached": False,
                         "log": log}
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return results


def _dlopen(name, path):
    """Load ``path`` as kernel ``name``; a library this process neither
    built nor installed counts as a tier-1 hit."""
    t0 = time.perf_counter()
    lib = ctypes.CDLL(path)
    if path not in _MADE_HERE:
        _emit("cache_hit", name=name, saved_secs=recorded_seconds(path),
              retrieval_secs=time.perf_counter() - t0)
    _LOADED[name] = lib
    return lib


def load(name):
    """The loaded shared library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]["path"]
    with _LOCK:
        return _LOADED.get(name) or _dlopen(name, path)


def loaded():
    """The kernels this process has loaded, by name."""
    with _LOCK:
        return sorted(_LOADED)


def install(name, data, seconds=0.0):
    """Lay kernel ``name``'s library down from its bytes (a stored artifact
    built by the same sources, flags and toolkit) and load it, without
    running ``nvcc``.  A library already on disk is kept and loaded (a
    tier-1 hit).  Returns the loaded library."""
    with _LOCK:
        lib = _LOADED.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name("{}.tmp{}".format(out.name, os.getpid()))
        tmp.write_bytes(data)
        _record(out, seconds)
        os.replace(tmp, out)
        _MADE_HERE.add(str(out))
    with _LOCK:
        return _LOADED.get(name) or _dlopen(name, str(out))
