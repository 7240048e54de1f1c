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
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

logger = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: the compile root (``compilecache.CACHE_DIR_ENV``): libraries live in its
#: ``kernels`` subdirectory when it is set
CACHE_DIR_ENV = "TFOS_COMPILE_CACHE_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED = {}
_TOOLKITS = {}       # compiler path (nvcc, g++) -> its version line
_CXX = {}            # "cxx" -> the host compiler openmp_cxx chose
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


# -- the C++ programs against torch (csrc/*.cpp) -----------------------------

#: The C++ sources built with the host's compiler against torch's headers
#: and libraries: ``flash_ops`` (a shared library registering
#: ``tfos::flash_fwd``) and ``aoti_runner`` (an executable).
NATIVE = {"flash_ops": "shared", "aoti_runner": "executable"}
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC")


def _torch_native():
    """``(include dirs, library dir, whether torch has its CUDA libraries,
    the ABI define)`` of the installed torch."""
    import torch
    from torch.utils import cpp_extension

    lib_dir = os.path.join(os.path.dirname(torch.__file__), "lib")
    cuda = (torch.version.cuda is not None and os.path.exists(
        os.path.join(lib_dir, "libtorch_cuda.so")))
    abi = "-D_GLIBCXX_USE_CXX11_ABI={}".format(
        int(torch.compiled_with_cxx11_abi()))
    return cpp_extension.include_paths(), lib_dir, cuda, abi


def _native_command(name, cxx, out):
    """The compiler's command line for ``csrc/<name>.cpp``: against torch's
    headers, its libraries with an rpath to them, and with torch's CUDA
    libraries (and, for ``flash_ops``, the forward kernel's library and
    ``-DTFOS_WITH_CUDA``) where torch has them."""
    includes, lib_dir, cuda, abi = _torch_native()
    flags, libs = [abi], ["-ltorch", "-ltorch_cpu", "-lc10"]
    if NATIVE[name] == "shared":
        flags.append("-shared")
    if cuda:
        libs += ["-ltorch_cuda", "-lc10_cuda"]
        if name == "flash_ops":
            cuda_home = os.path.dirname(os.path.dirname(nvcc_path()))
            flags += ["-DTFOS_WITH_CUDA",
                      "-I" + os.path.join(cuda_home, "include")]
            libs.append(str(library_path("flash_fwd")))
    # --no-as-needed: the runner reaches torch_cuda's package runner only
    # through its registration at load, which --as-needed would drop
    return ([cxx, *CXX_FLAGS, *flags] + ["-I" + d for d in includes]
            + [str(CSRC / (name + ".cpp")), "-o", str(out),
               "-L" + lib_dir, "-Wl,--no-as-needed"] + libs
            + ["-Wl,--as-needed", "-Wl,-rpath," + lib_dir, "-ldl"])


def openmp_cxx():
    """A C++ compiler that links ``-fopenmp``, which AOTInductor puts on
    the link line of every package: Inductor's own choice (``$CXX``, else
    ``g++``) when it can, else the first ``g++``, ``c++`` or ``clang++`` on
    the ``PATH`` that can (a toolchain without libgomp's spec file cannot
    link it); None when none can.  Checked once per process.  AOTInductor
    (through ``compilecache``) and :func:`build_native` both use it."""
    from torch._inductor import config

    with _LOCK:
        if "cxx" in _CXX:
            return _CXX["cxx"]
        default = config.cpp.cxx
        default = default[-1] if isinstance(default, (list, tuple)) \
            else default
        tmp = tempfile.mkdtemp(prefix="tfos-cxx-")
        try:
            src = os.path.join(tmp, "main.cpp")
            with open(src, "w") as f:
                f.write("int main() { return 0; }\n")
            for cxx in [default] + [shutil.which(name) for name in
                                    ("g++", "c++", "clang++")]:
                if not cxx:
                    continue
                try:
                    ok = subprocess.run(
                        [cxx, "-fopenmp", src, "-o",
                         os.path.join(tmp, "main")],
                        capture_output=True, timeout=120).returncode == 0
                except (OSError, subprocess.SubprocessError):
                    ok = False
                if ok:
                    _CXX["cxx"] = cxx
                    break
            else:
                _CXX["cxx"] = None
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if _CXX["cxx"] != default:
            logger.info("AOTInductor links with %s (%s cannot link "
                        "-fopenmp)", _CXX["cxx"], default)
        return _CXX["cxx"]


def _native_cxx():
    """``(path, --version line)`` of the compiler :func:`build_native`
    uses: :func:`openmp_cxx`'s, else the ``g++`` on the ``PATH``."""
    cxx = openmp_cxx() or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found to build {}".format(
            sorted(NATIVE)))
    with _LOCK:
        if cxx not in _TOOLKITS:
            out = subprocess.run([cxx, "--version"], capture_output=True,
                                 text=True).stdout
            _TOOLKITS[cxx] = (out.splitlines() or [""])[0]
        return cxx, _TOOLKITS[cxx]


def native_digest(name):
    """The key of ``csrc/<name>.cpp``'s build: a hash of the source, the
    compiler's command line (the compiler's path, flags, torch's paths,
    the CUDA switch), the compiler's version line and
    ``torch.__version__``."""
    import torch

    cxx, version = _native_cxx()
    h = hashlib.sha256()
    h.update((CSRC / (name + ".cpp")).read_bytes())
    h.update(" ".join(_native_command(name, cxx, "out")).encode())
    h.update(version.encode())
    h.update(torch.__version__.encode())
    return h.hexdigest()[:16]


def native_path(name):
    """Where ``csrc/<name>.cpp`` builds to (see :func:`native_digest`)."""
    if NATIVE[name] == "shared":
        return build_dir() / "lib{}-{}.so".format(name, native_digest(name))
    return build_dir() / "{}-{}".format(name, native_digest(name))


def build_native(names=None):
    """Build the named C++ programs (default: both) that are not built yet,
    one compiler process each, all at once; where torch has CUDA the
    forward kernel's library is built first (``flash_ops`` links it).
    Returns ``{name: {"path", "seconds", "cached", "log"}}``; raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    names = list(NATIVE) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    if "flash_ops" in names and _torch_native()[2]:
        build(["flash_fwd"])
    cxx, _ = _native_cxx()
    results, running = {}, {}
    for name in names:
        out = native_path(name)
        if out.exists():
            results[name] = {"path": str(out), "seconds": 0.0,
                             "cached": True, "log": ""}
            continue
        tmp = out.with_name("{}.tmp{}".format(out.name, os.getpid()))
        proc = subprocess.Popen(_native_command(name, cxx, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append("{} ({} exit {}):\n{}".format(
                name, cxx, proc.returncode, log[-4000:]))
            continue
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": seconds,
                         "cached": False, "log": log}
    if failures:
        raise RuntimeError("native build failed: " + "\n".join(failures))
    return results
