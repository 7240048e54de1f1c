"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``.
Libraries land in ``build/kernels/`` beside the package, named by a hash of
the sources and flags, so an edited source rebuilds at its first use and an
unchanged one loads at once.  Several sources build in parallel, one
``nvcc`` each.  Nothing is built when this module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED = {}


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


def kernel_names():
    """Every kernel source in ``csrc/``, by name (file stem)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to: keyed on its source, the shared
    headers and the flags."""
    digest = hashlib.sha256()
    for path in [CSRC / (name + ".cu")] + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / "lib{}-{}.so".format(name, digest.hexdigest()[:16])


def build(names=None):
    """Build the named kernels (default: all) that are not built yet, all
    ``nvcc`` processes at once.  Returns ``{name: {"path", "seconds",
    "cached", "log"}}``; ``log`` is the compiler's output, which holds the
    ``-Xptxas -v`` lines (registers, shared memory, spills).  Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": seconds, "cached": False,
                         "log": log}
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return results


def load(name):
    """The loaded shared library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name]["path"])
            _LOADED[name] = lib
        return lib
