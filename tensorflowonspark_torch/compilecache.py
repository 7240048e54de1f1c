"""Warm-start compile plane: the kernels' persistent build cache and the
stored AOT artifacts (the port of :mod:`tensorflowonspark_tpu.compilecache`).

Eager PyTorch compiles no step, so what the port pays at a restart is the
compiled code it does have: the hand-written kernels' ``nvcc`` builds, and,
where a forward is compiled ahead of time, its AOTInductor package.  This
module makes both a one-time cost shared across runs and replicas, on the
JAX package's two tiers:

1. **Persistent cache** (:func:`configure`): a compile root resolved from
   cluster config / :data:`CACHE_DIR_ENV`, shared across the cluster.
   :mod:`~tensorflowonspark_torch.ops._build` builds and loads the kernel
   libraries under ``<root>/kernels``, and Inductor's and Triton's caches
   (``TORCHINDUCTOR_CACHE_DIR``, ``TRITON_CACHE_DIR``) go under the root
   unless the user set them.  ``compile_cache_hit`` counts a library found
   there, ``compile_cache_miss`` one that ``nvcc`` built,
   ``compile_cache_saved_us`` the build seconds recorded beside each hit,
   ``compile_cache_retrieval_us`` the ``dlopen``.  The counters ride
   heartbeats into the observatory as ``tfos_compile_cache_*``.

2. **AOT artifact store** (:class:`AOTCache`), keyed by a field-by-field
   :func:`fingerprint` (torch, CUDA and ``nvcc`` versions, backend, device,
   mesh shape, donation signature, avals, the kernels' sources).  A
   serving rung's artifact is an AOTInductor package of the model's
   forward (:func:`aoti_compile`), the params its inputs, so a weight swap
   keeps it; a Trainer program's is the kernel libraries a step launches
   (:class:`KernelSet`: AOTInductor compiles no backward or optimizer
   step, and a CUDA graph cannot be serialized).  A warm load installs and
   dispatches them without ``nvcc`` or Inductor; any fingerprint mismatch,
   corrupt artifact or failed load is a clean miss — the caller falls back
   to eager dispatch and ``compile_cache_fallback`` increments.  A warm
   start is an optimization, never a correctness dependency.

Scoping contract: fingerprints cover everything the runtime can see
(versions, device, mesh, donation, avals, kernel sources) plus whatever
program identity the caller mixes in — the trainer hashes its loss fn and
optimizer structurally (:func:`program_identity`) so resuming a run after
editing the loss or a hyperparameter rejects the stale artifact; serving
keys by model name/config.  The structural hash is best-effort (bytecode +
consts + closure values), so callers should still scope the store per
model run (the trainer defaults it beside the checkpoint root, see
``checkpoint.aot_root``; serving keys by its warm dir) and can pin an
explicit ``program_version`` when the automatic hash can't see a change.

Trust boundary: an artifact's payload holds shared libraries (a kernel
library, or the compiled model inside an AOTInductor package) that are
``dlopen``\\ ed on load — anyone with WRITE access to a store directory can
execute arbitrary code in every process that warms from it.  The store
therefore (a) creates its directory ``0o700``, (b) verifies the plain-JSON
fingerprint header *before* the payload is touched, then each file's
SHA-256, so mismatched artifacts never reach the loader, and (c) must live
on a mount whose writers you trust exactly as much as the training job
itself (same bar as the checkpoint root).  Remote object-store URLs are
rejected — this store is local-filesystem / shared-mount only.  The
payload is a JSON manifest and raw file bytes, never a pickle.
"""

import hashlib
import json
import logging
import os
import shutil
import tempfile
import threading
import time

logger = logging.getLogger(__name__)

#: env fallback for the shared compile root (cluster config wins; see
#: :func:`configure_from_meta`).  ``configure`` re-exports the resolved
#: path here so forked children (manager, feed tasks) inherit it, and
#: ``ops._build`` reads it at every build (its ``CACHE_DIR_ENV``).
CACHE_DIR_ENV = "TFOS_COMPILE_CACHE_DIR"


def _build_module():
    """``ops._build``, imported at first use: importing the ``ops`` package
    imports torch, which an inert compile plane (a node with no root)
    must not pay for before its user fn runs."""
    from tensorflowonspark_torch.ops import _build

    return _build

#: bump when the artifact layout changes — old artifacts then read as
#: fingerprint mismatches (clean eager fallback), not crashes
_FORMAT = 3

_SUFFIX = ".aotx"

#: artifact layout: magic, one line of canonical-JSON fingerprint, then
#: the payload: one line of JSON manifest and the files' bytes.  The JSON
#: header is what load() checks — only a fingerprint-matched artifact ever
#: has its payload read.
_MAGIC = b"TFOS-AOTX3\n"

#: caches of the compilers the port drives, set under the compile root
#: unless the user already set them
_COMPILER_CACHES = (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                    ("TRITON_CACHE_DIR", "triton"))


class _CacheStats(object):
    """Process-global compile-plane tallies (plain ints, the DataFeed
    pattern: written on the compile path, read torn-but-harmlessly by the
    heartbeat thread).  Registered once as a node metrics feed by
    :func:`configure`, so the counters ride HBEAT payloads and render on
    the observatory as ``tfos_compile_cache_*``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.cache_hit = 0          # kernel libraries found on disk
        self.cache_miss = 0         # kernel libraries nvcc built
        self.fallback = 0           # AOT artifacts rejected -> eager fallback
        self.saved_us = 0           # build time the disk cache saved
        self.retrieval_us = 0       # time spent loading cached libraries
        self.aot_load = 0           # AOT artifacts loaded
        self.aot_save = 0           # AOT artifacts persisted
        self.aot_load_us = 0
        self.aot_compile_us = 0     # explicit compiles on cold stores
        self.aot_bytes_read = 0
        self.aot_bytes_written = 0
        self._dir_bytes = 0
        self._dir_scan_t = 0.0

    def _dir_bytes_now(self):
        """Compile-root footprint gauge (every file under it), rescanned at
        most every 5s."""
        d = _configured_dir
        if not d:
            return 0
        now = time.time()
        if now - self._dir_scan_t >= 5.0:
            self._dir_scan_t = now
            total = 0
            for root, _, files in os.walk(d):
                for name in files:
                    try:
                        total += os.path.getsize(os.path.join(root, name))
                    except OSError:
                        pass
            self._dir_bytes = total
        return self._dir_bytes

    def counters_snapshot(self):
        """Flat counters for heartbeat payloads /
        :func:`~tensorflowonspark_torch.telemetry.merge_counters`:
        ``compile_cache_hit`` / ``compile_cache_miss`` persistent-cache
        outcomes (a kernel library found, or built by ``nvcc``),
        ``compile_cache_saved_us`` the build time the cache saved,
        ``compile_cache_retrieval_us`` time spent loading cached libraries,
        ``compile_cache_fallback`` AOT artifacts rejected (mismatch/corrupt)
        in favor of eager dispatch, ``compile_cache_aot_load`` /
        ``compile_cache_aot_save`` AOT store traffic with byte and
        microsecond tallies, and ``compile_cache_dir_bytes_hwm`` the
        compile root's footprint (``_hwm`` -> merged by max, rendered as a
        gauge)."""
        return {
            "compile_cache_hit": self.cache_hit,
            "compile_cache_miss": self.cache_miss,
            "compile_cache_fallback": self.fallback,
            "compile_cache_saved_us": self.saved_us,
            "compile_cache_retrieval_us": self.retrieval_us,
            "compile_cache_aot_load": self.aot_load,
            "compile_cache_aot_save": self.aot_save,
            "compile_cache_aot_load_us": self.aot_load_us,
            "compile_cache_aot_compile_us": self.aot_compile_us,
            "compile_cache_aot_bytes_read": self.aot_bytes_read,
            "compile_cache_aot_bytes_written": self.aot_bytes_written,
            "compile_cache_dir_bytes_hwm": self._dir_bytes_now(),
        }


#: the process-global tally instance every helper below writes to
stats = _CacheStats()

_lock = threading.Lock()
_listeners_installed = False
_feed_registered = False
_configured_dir = None
_env_set = {}        # compiler cache variables configure() set, and to what


def _on_event(event, **kwargs):
    """``ops._build``'s tier-1 events."""
    if event == "cache_hit":
        stats.cache_hit += 1
        stats.saved_us += max(0, int(kwargs.get("saved_secs", 0.0) * 1e6))
        stats.retrieval_us += int(kwargs.get("retrieval_secs", 0.0) * 1e6)
    elif event == "cache_miss":
        stats.cache_miss += 1


def _install_listeners():
    """Subscribe the tallies to ``ops._build``'s events (idempotent)."""
    global _listeners_installed
    with _lock:
        if _listeners_installed:
            return True
        _build_module().add_listener(_on_event)
        _listeners_installed = True
        return True


def _register_stats_feed():
    """Publish :data:`stats` on this node's heartbeats (idempotent; no-op
    outside a node process — gateway replicas merge the snapshot into
    their own heartbeat_metrics instead)."""
    global _feed_registered
    with _lock:
        if _feed_registered:
            return
        _feed_registered = True
    from tensorflowonspark_torch import node

    node._register_feed(stats)


def configured_dir():
    """The active compile root, or None before :func:`configure`
    succeeds."""
    return _configured_dir


def configure(cache_dir=None, register_feed=True):
    """Make ``cache_dir`` this process's compile root.

    Resolution order: explicit argument, then :data:`CACHE_DIR_ENV`.
    Returns the resolved (created) directory, or None when neither names
    one — the whole compile plane is then inert, zero-cost.

    Side effects on success: :data:`CACHE_DIR_ENV` exported (the kernel
    build module reads it at every build, and forked children inherit it), the
    Inductor and Triton caches pointed under the root unless the user set
    them, ``ops._build``'s listeners installed, and (``register_feed=True``)
    :data:`stats` registered as a node heartbeat feed.  Only paths and the
    environment change: nothing here initialises CUDA, so a node that
    forks later may call it.
    """
    global _configured_dir
    cache_dir = cache_dir or os.environ.get(CACHE_DIR_ENV) or None
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    os.environ[CACHE_DIR_ENV] = cache_dir
    with _lock:
        for var, sub in _COMPILER_CACHES:
            current = os.environ.get(var)
            if current is None or current == _env_set.get(var):
                _env_set[var] = os.path.join(cache_dir, sub)
                os.environ[var] = _env_set[var]
    _install_listeners()
    with _lock:
        _configured_dir = cache_dir
    if register_feed:
        _register_stats_feed()
    from tensorflowonspark_torch import telemetry

    telemetry.get_tracer().instant("compile/cache_configured", dir=cache_dir)
    logger.info("persistent compile cache at %s", cache_dir)
    return cache_dir


def configure_from_meta(cluster_meta):
    """Configure from ``cluster_meta["compile_cache_dir"]`` (remote
    processes — replacement nodes re-run the same start closure, so warm
    rejoin needs no extra plumbing); falls back to the env toggle, same
    policy as ``telemetry.configure_from_meta``."""
    return configure((cluster_meta or {}).get("compile_cache_dir"))


# -- AOT artifact store ---------------------------------------------------

def _aval_signature(tree):
    """Stable hash of a tree's array avals (tree structure + per-leaf
    shape/dtype) — the batch/param half of a fingerprint.  Hashed rather
    than stored raw: a params tree's spec runs to kilobytes."""
    from torch.utils import _pytree

    leaves, spec = _pytree.tree_flatten(tree)
    parts = [str(spec)]
    for leaf in leaves:
        shape = tuple(getattr(leaf, "shape", ()))
        dtype = getattr(leaf, "dtype", None)
        parts.append("%s:%s" % (dtype if dtype is not None
                                else type(leaf).__name__, shape))
    return hashlib.sha256("|".join(parts).encode("utf-8")).hexdigest()


def _tree_device(tree):
    """The device of the first tensor in ``tree`` (None without one)."""
    import torch
    from torch.utils import _pytree

    for leaf in _pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def kernels_digest():
    """The kernel sources' key, ``name:digest`` per kernel (each
    ``ops._build.library_path``'s digest)."""
    build = _build_module()
    return ",".join("%s:%s" % (name, build.digest(name))
                    for name in build.kernel_names())


def fingerprint(avals=None, mesh=None, donate=(), extra=None):
    """The compatibility key an AOT artifact is stored and checked under.

    A field-by-field dict (not one opaque hash) so a mismatch names the
    field that moved — the load path logs and traces exactly which of
    the torch / CUDA / ``nvcc`` versions, backend, device, device count,
    mesh shape, donation signature, aval signature or kernel sources
    diverged before falling back to eager dispatch.  The device is the
    first tensor's in ``avals`` (the CPU without one).
    """
    import torch

    device = _tree_device(avals) or torch.device("cpu")
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        name = "%s sm_%d%d" % ((torch.cuda.get_device_name(index),)
                               + torch.cuda.get_device_capability(index))
        count = torch.cuda.device_count()
    else:
        name, count = device.type, 1
    fp = {
        "format": _FORMAT,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": _build_module().toolkit(),
        "backend": device.type,
        "device": name,
        "device_count": count,
        "donate": tuple(donate),
        "kernels": kernels_digest(),
    }
    if mesh is not None:
        try:
            fp["mesh"] = repr(tuple(zip(mesh.mesh_dim_names,
                                        tuple(mesh.mesh.shape))))
        except Exception:
            fp["mesh"] = repr(mesh)
    if avals is not None:
        fp["avals"] = _aval_signature(avals)
    if extra:
        fp.update(extra)
    return fp


def _fp_canonical(fp):
    """Canonical JSON form of a fingerprint dict — the representation
    stored in the artifact header and compared on load (tuples coerce to
    lists identically on both sides; non-JSON values go through repr)."""
    return json.dumps(fp, sort_keys=True, default=repr)


def _tensor_digest(obj):
    """SHA-256 of a small array's bytes: numpy arrays as they are, torch
    tensors (CUDA and bf16 included) copied to the host as raw bytes; None
    for anything larger than 4096 elements, and for an ``nn.Parameter``: a
    module's weights are the program's state, not the program (a loss
    built from a model reaches its params through ``functional_call``)."""
    import numpy as np
    import torch

    if isinstance(obj, torch.Tensor):
        if obj.numel() > 4096 or isinstance(obj, torch.nn.Parameter):
            return None
        raw = obj.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        return hashlib.sha256(raw.numpy().tobytes()).hexdigest()
    arr = np.asarray(obj)
    if arr.size > 4096:
        return None
    return hashlib.sha256(arr.tobytes()).hexdigest()


def _identity_parts(obj, parts, seen, depth=0):
    """Recursive structural walk feeding :func:`program_identity`.

    Functions contribute bytecode, consts, names, defaults, and closure
    cell VALUES (recursively — a loss built by a factory keeps its model
    and hyperparameters in cells); arrays contribute shape/dtype plus a
    content digest when small; containers and plain objects recurse
    sorted.  Anything opaque falls back to its type name — a too-coarse
    hash only risks a spurious mismatch, which degrades to a clean
    recompile, never a stale load."""
    if depth > 12:
        parts.append("<depth>")
        return
    if obj is None or isinstance(obj, (bool, int, float, complex, str,
                                       bytes)):
        parts.append(repr(obj))
        return
    if id(obj) in seen:
        parts.append("<cycle>")
        return
    seen.add(id(obj))
    import functools

    if isinstance(obj, functools.partial):
        parts.append("partial")
        _identity_parts(obj.func, parts, seen, depth + 1)
        for a in obj.args:
            _identity_parts(a, parts, seen, depth + 1)
        for k in sorted(obj.keywords or {}):
            parts.append(repr(k))
            _identity_parts(obj.keywords[k], parts, seen, depth + 1)
        return
    func = getattr(obj, "__func__", None)
    if func is not None:                       # bound method
        _identity_parts(func, parts, seen, depth + 1)
        _identity_parts(getattr(obj, "__self__", None), parts, seen,
                        depth + 1)
        return
    code = getattr(obj, "__code__", None)
    if code is not None:                       # plain function / lambda
        parts.append("fn:%s" % getattr(obj, "__qualname__", ""))
        parts.append(code.co_code.hex())
        parts.append(repr(code.co_names))
        for c in code.co_consts:
            if hasattr(c, "co_code"):          # nested function's code
                parts.append(c.co_code.hex())
            else:
                parts.append(repr(c))
        for cell in getattr(obj, "__closure__", None) or ():
            try:
                _identity_parts(cell.cell_contents, parts, seen, depth + 1)
            except ValueError:                 # empty cell
                parts.append("<empty-cell>")
        for d in getattr(obj, "__defaults__", None) or ():
            _identity_parts(d, parts, seen, depth + 1)
        return
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):   # array-likes
        shape = tuple(getattr(obj, "shape", ()))
        parts.append("arr:%s:%s" % (obj.dtype, shape))
        try:
            digest = _tensor_digest(obj)
            if digest is not None:
                parts.append(digest)
        except Exception:                      # meta tensors etc.
            pass
        return
    if isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            parts.append(repr(k))
            _identity_parts(obj[k], parts, seen, depth + 1)
        return
    if isinstance(obj, (list, tuple)):         # incl. namedtuples
        parts.append(type(obj).__name__)
        for v in obj:
            _identity_parts(v, parts, seen, depth + 1)
        return
    if isinstance(obj, (set, frozenset)):
        for v in sorted(obj, key=repr):
            _identity_parts(v, parts, seen, depth + 1)
        return
    parts.append(type(obj).__qualname__)
    d = getattr(obj, "__dict__", None)
    if isinstance(d, dict):
        for k in sorted(d, key=repr):
            parts.append(repr(k))
            _identity_parts(d[k], parts, seen, depth + 1)


def program_identity(*objs):
    """Best-effort structural hash of the PYTHON half of a compiled
    program — the part no aval fingerprint can see.

    The trainer feeds its loss fn and optimizer through this and mixes
    the digest into every AOT fingerprint, so resuming in the same
    checkpoint dir after editing the loss or an optimizer hyperparameter
    (same shapes, different program) rejects the stale artifact and
    recompiles instead of silently training the old program.  Best-effort
    by design: an over-sensitive hash (e.g. a docstring edit) costs one
    recompile; only the caller can assert true equivalence, via an
    explicit ``program_version``."""
    parts = []
    seen = set()
    for obj in objs:
        try:
            _identity_parts(obj, parts, seen)
        except Exception:                      # pragma: no cover - exotic
            parts.append("<opaque:%s>" % type(obj).__name__)
    return hashlib.sha256(
        "|".join(parts).encode("utf-8", "backslashreplace")).hexdigest()


# -- what an artifact holds -----------------------------------------------

class KernelSet(object):
    """A Trainer program's compiled code: the kernel libraries its step
    launches.  AOTInductor compiles inference programs only (no backward,
    no optimizer step) and a CUDA graph cannot be serialized, so the
    libraries are what a warm start can skip: a load installs them through
    :func:`ops._build.install` without ``nvcc``.  The Trainer cannot see
    ahead of its first step which kernels its loss launches, so on a card
    the set is every kernel of ``csrc/`` (the flash forward and backward,
    what the flash LM's step launches); on the CPU it is empty."""

    kind = "kernels"

    def __init__(self, names):
        self.names = tuple(sorted(names))

    @classmethod
    def compile(cls, device):
        """Build (tier 1 aside) and load every kernel library on a CUDA
        ``device``; none on the CPU."""
        import torch

        if torch.device(device).type != "cuda":
            return cls(())
        build = _build_module()
        names = build.kernel_names()
        build.build(names)
        for name in names:
            build.load(name)
        return cls(names)

    def files(self):
        build = _build_module()
        for name in self.names:
            path = build.library_path(name)
            with open(path, "rb") as f:
                data = f.read()
            yield ({"name": name, "library": path.name,
                    "seconds": build.recorded_seconds(path)}, data)

    @classmethod
    def materialize(cls, files):
        build, names = _build_module(), []
        for meta, data in files:
            want = build.library_path(meta["name"]).name
            if meta.get("library") != want:
                raise ValueError("library %s is not this build's %s"
                                 % (meta.get("library"), want))
            build.install(meta["name"], data, meta.get("seconds", 0.0))
            names.append(meta["name"])
        return cls(names)


class AOTIProgram(object):
    """An AOTInductor package (``.pt2``) for ``device`` (a device type) and
    its loaded runner: a serving rung's compiled forward.  Called as
    ``program(params, *inputs)``."""

    kind = "aoti"

    def __init__(self, package, runner, device="cpu"):
        self.package = package
        self.runner = runner
        self.device = device

    def __call__(self, *args):
        return self.runner(*args)

    def files(self):
        yield ({"name": "program.pt2", "device": self.device}, self.package)

    @classmethod
    def materialize(cls, files):
        ((meta, data),) = files
        device = meta.get("device", "cpu")
        return cls(data, _load_package(data, device), device)


def _inductor_options(device):
    """Inductor settings for a package on ``device``: the compiler of
    ``ops._build.openmp_cxx``, and for a CUDA package no probe of the host's
    vector ISA (it has no CPU kernels to vectorize; each probe builds and
    loads a test library, seconds on a card's host)."""
    from torch._inductor import config

    options = {"cpp.cxx": (None, _build_module().openmp_cxx())}
    if device == "cuda" and hasattr(config.cpp, "vec_isa_ok"):
        options["cpp.vec_isa_ok"] = False
    return options


def _load_package(data, device="cpu"):
    """Load a ``.pt2`` package from its bytes: the loader takes a path, so
    the bytes go to a private temporary file first (removed after the
    load, which unpacks what it needs)."""
    import torch
    from torch._inductor import config

    tmp = tempfile.mkdtemp(prefix="tfos-aoti-")
    try:
        path = os.path.join(tmp, "program.pt2")
        with open(path, "wb") as f:
            f.write(data)
        with config.patch(_inductor_options(device)):
            return torch._inductor.aoti_load_package(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def aoti_compile(fn, *args):
    """Compile ``fn(*args)`` ahead of time with AOTInductor at the static
    shapes of ``args`` (trees of tensors) and load it: an
    :class:`AOTIProgram`.  A caller that applies a model through
    ``torch.func.functional_call`` passes its params as one of ``args``, so
    they are the program's inputs, not its constants: a weight swap in
    place or another params dict reuses the package.  Runs under
    ``no_grad``, so the flash attention ops enter the graph as opaque
    ``tfos::flash_fwd`` calls.  Built with :func:`_inductor_options`."""
    import torch
    from torch._inductor import config

    class _Export(torch.nn.Module):
        def forward(self, *inputs):
            return fn(*inputs)

    if _build_module().openmp_cxx() is None:
        raise RuntimeError("no C++ compiler here links -fopenmp, which "
                           "AOTInductor needs")
    device = (_tree_device(args) or torch.device("cpu")).type
    with torch.no_grad(), config.patch(_inductor_options(device)):
        program = torch.export.export(_Export(), tuple(args), strict=False)
        tmp = tempfile.mkdtemp(prefix="tfos-aoti-")
        try:
            path = torch._inductor.aoti_compile_and_package(
                program, package_path=os.path.join(tmp, "program.pt2"))
            with open(path, "rb") as f:
                data = f.read()
            runner = torch._inductor.aoti_load_package(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return AOTIProgram(data, runner, device)


_KINDS = {cls.kind: cls for cls in (KernelSet, AOTIProgram)}


def _encode(compiled):
    """The payload of ``compiled``: one line of JSON manifest (kind, each
    file's meta, size and SHA-256), then the files' bytes in order."""
    metas, blobs = [], []
    for meta, data in compiled.files():
        metas.append(dict(meta, size=len(data),
                          sha256=hashlib.sha256(data).hexdigest()))
        blobs.append(data)
    manifest = {"kind": compiled.kind, "files": metas}
    return (json.dumps(manifest, sort_keys=True).encode("utf-8") + b"\n"
            + b"".join(blobs))


def _decode(payload):
    """``(kind, [(meta, bytes)])`` of a payload; ``ValueError`` when a file
    is short, long or not the bytes its SHA-256 names."""
    end = payload.index(b"\n")
    manifest = json.loads(payload[:end].decode("utf-8"))
    files, offset = [], end + 1
    for meta in manifest["files"]:
        data = payload[offset:offset + meta["size"]]
        offset += meta["size"]
        if (len(data) != meta["size"]
                or hashlib.sha256(data).hexdigest() != meta["sha256"]):
            raise ValueError("file %s truncated or altered" % meta["name"])
        files.append((meta, data))
    if offset != len(payload):
        raise ValueError("%d trailing bytes" % (len(payload) - offset))
    if manifest["kind"] not in _KINDS:
        raise ValueError("unknown artifact kind %r" % manifest["kind"])
    return manifest["kind"], files


class AOTCache(object):
    """Artifact store: ``name`` -> one fingerprinted artifact.

    Artifacts are ``<name>.aotx`` files: :data:`_MAGIC`, one line of
    canonical-JSON fingerprint, then the payload (a JSON manifest line and
    the files' bytes), written atomically (tmp + rename) so a killed
    writer can never leave a half artifact under a reader.  Absent /
    mismatched / corrupt artifacts are all clean misses.

    Trust boundary (see the module docstring): the payload's shared
    libraries are ``dlopen``\\ ed on load, so the store directory must only
    be writable by principals trusted to run code in the warming processes
    — it is created ``0o700``, and the JSON header is verified BEFORE the
    payload is read.  Local filesystem / shared mount only: remote
    object-store URLs raise (``fit_supervised`` skips auto-attaching the
    store for remote checkpoint roots for the same reason).
    """

    def __init__(self, directory):
        from tensorflowonspark_torch import fsio

        directory = fsio.strip_file_scheme(str(directory))
        if fsio.is_remote(directory):
            raise ValueError(
                "AOTCache needs a local or shared-mount directory; remote "
                "URL %r is not supported (artifacts are local files whose "
                "shared libraries are loaded — see the compilecache "
                "trust-boundary note)" % (directory,))
        self.directory = os.path.abspath(directory)
        # 0o700 on creation: artifacts execute-by-loading in every process
        # that warms from here (no-op for pre-existing dirs)
        os.makedirs(self.directory, mode=0o700, exist_ok=True)

    def path(self, name):
        return os.path.join(self.directory, name + _SUFFIX)

    def load(self, name, fp):
        """Load ``name``'s artifact when its stored fingerprint equals
        ``fp`` exactly (a :class:`KernelSet` installed, or an
        :class:`AOTIProgram` ready to call); None otherwise.  Mismatch,
        corruption, and load failures bump ``compile_cache_fallback`` and
        emit a ``compile/jit_fallback`` instant naming the reason —
        absence is silent (a cold store is not a fallback)."""
        from tensorflowonspark_torch import telemetry

        path = self.path(name)
        if not os.path.exists(path):
            return None
        tracer = telemetry.get_tracer()
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                blob = f.read()
            if not blob.startswith(_MAGIC):
                raise ValueError("bad magic")
            header_end = blob.index(b"\n", len(_MAGIC))
            stored = json.loads(blob[len(_MAGIC):header_end]
                                .decode("utf-8"))
        except Exception as e:
            stats.fallback += 1
            logger.warning("AOT artifact %s unreadable (%s: %s); "
                           "falling back to eager dispatch", path,
                           type(e).__name__, e)
            tracer.instant("compile/jit_fallback", program=name,
                           reason="corrupt")
            return None
        # fingerprint gate runs on the plain-JSON header — a mismatched
        # artifact is rejected before its payload is ever read
        expect = json.loads(_fp_canonical(fp))
        if stored != expect:
            stats.fallback += 1
            diff = sorted(k for k in set(stored) | set(expect)
                          if stored.get(k) != expect.get(k))
            logger.warning("AOT artifact %s fingerprint mismatch on %s; "
                           "falling back to eager dispatch", path, diff)
            tracer.instant("compile/jit_fallback", program=name,
                           reason="fingerprint:" + ",".join(diff))
            return None
        try:
            kind, files = _decode(blob[header_end + 1:])
            compiled = _KINDS[kind].materialize(files)
        except Exception as e:
            stats.fallback += 1
            logger.warning("AOT artifact %s failed to load (%s: %s); "
                           "falling back to eager dispatch", path,
                           type(e).__name__, e)
            tracer.instant("compile/jit_fallback", program=name,
                           reason="deserialize")
            return None
        micros = int((time.perf_counter() - t0) * 1e6)
        stats.aot_load += 1
        stats.aot_load_us += micros
        stats.aot_bytes_read += len(blob)
        tracer.instant("compile/aot_load", program=name, micros=micros,
                       bytes=len(blob))
        return compiled

    def save(self, name, fp, compiled):
        """Store ``compiled`` under ``name``; returns whether an artifact
        landed.  Never raises: encode and I/O failures log and skip — the
        run proceeds on its live program either way."""
        from tensorflowonspark_torch import telemetry

        t0 = time.perf_counter()
        try:
            blob = (_MAGIC + _fp_canonical(fp).encode("utf-8") + b"\n"
                    + _encode(compiled))
        except Exception as e:
            logger.warning("AOT artifact of %s failed to encode (%s: %s); "
                           "artifact skipped", name, type(e).__name__, e)
            return False
        path = self.path(name)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("AOT artifact write %s failed (%s); skipped",
                           path, e)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        micros = int((time.perf_counter() - t0) * 1e6)
        stats.aot_save += 1
        stats.aot_bytes_written += len(blob)
        telemetry.get_tracer().instant("compile/aot_save", program=name,
                                       micros=micros, bytes=len(blob))
        return True


def load_or_compile(cache, name, fp, compile_fn, args):
    """The load-or-compile decision shared by the trainer and serving.

    Returns ``(compiled, verdict, micros)``: the store's loaded artifact
    (``"loaded"`` — no ``nvcc``, no Inductor, the warm-rejoin path), or
    ``compile_fn(*args)``'s freshly compiled one, persisted for the next
    restart (``"compiled"``), or ``(None, "jit", 0)`` when there is no
    store / even the explicit compile fails — callers then dispatch
    eagerly.
    """
    from tensorflowonspark_torch import telemetry

    if cache is None:
        return None, "jit", 0
    t0 = time.perf_counter()
    compiled = cache.load(name, fp)
    if compiled is not None:
        return compiled, "loaded", int((time.perf_counter() - t0) * 1e6)
    t0 = time.perf_counter()
    try:
        with telemetry.get_tracer().span("compile/aot_compile",
                                         program=name):
            compiled = compile_fn(*args)
    except Exception as e:
        logger.warning("explicit AOT compile of %s failed (%s: %s); "
                       "dispatching eagerly", name, type(e).__name__, e)
        return None, "jit", 0
    micros = int((time.perf_counter() - t0) * 1e6)
    stats.aot_compile_us += micros
    cache.save(name, fp, compiled)
    return compiled, "compiled", micros
