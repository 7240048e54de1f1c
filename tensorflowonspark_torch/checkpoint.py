"""Checkpoints and the serving export of the port (the counterpart of
:mod:`tensorflowonspark_tpu.checkpoint`, without orbax).

- :class:`CheckpointManager` — periodic, retained, atomic checkpoints of a
  train state (any nested dict/list of tensors and numbers, or an object
  with ``state_dict()``), with an async depth-1 writer, restore-latest and
  the validated restore that quarantines a bad step as
  ``<step>.corrupt``.  Steps are laid out as
  ``<directory>/<step>/state.pt``, written by ``torch.save`` under a
  temporary name and renamed into place.
- :func:`export_model` / :func:`load_model` — the serving export: a
  directory holding ``export.json`` (the JAX package's descriptor keys:
  ``model_name``, ``model_config``, ``input_signature``) and
  ``params.pt``, the model's ``state_dict``.  There is no compiled
  artifact: a server rebuilds the model from the registry by name and
  config.
"""

import json
import logging
import os
import queue as _queue
import shutil
import threading

import torch

from tensorflowonspark_torch import fault, telemetry

logger = logging.getLogger(__name__)

_DESCRIPTOR = "export.json"
_PARAMS_FILE = "params.pt"
_STATE_FILE = "state.pt"

#: async ``maybe_save`` toggle (default on): "0"/"off" forces synchronous
#: saves, as in the JAX package.
ASYNC_CKPT_ENV = "TFOS_ASYNC_CKPT"

#: how long :meth:`CheckpointManager.close` waits for the async worker
_CLOSE_JOIN_SECS = 120.0


def _fs_path(path):
    """A local path, with any ``file://`` / ``file:`` scheme stripped."""
    if path.startswith("file://"):
        path = path[len("file://"):] or "/"
    elif path.startswith("file:"):
        path = path[len("file:"):]
    return os.path.abspath(path)


def aot_root(directory):
    """The AOT artifact store beside a checkpoint root.

    Warm rejoin and restore share one directory tree: a replacement node
    that can see the checkpoints can also see the stored artifacts
    (:mod:`~tensorflowonspark_torch.compilecache`), so ``fit_supervised``
    restores state AND installs the step's kernels without ``nvcc`` from
    the same mount.  The subdirectory name is outside the checkpoint
    namespace, so retention and quarantine never touch it.
    """
    return os.path.join(_fs_path(directory), "aot_executables")


def _map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor; dicts, lists and tuples
    are rebuilt, other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _cuda_device(tree):
    """The device of the first CUDA tensor in ``tree``, or None."""
    found = []
    _map_tensors(tree, lambda t: found.append(t.device)
                 if t.is_cuda else None)
    return found[0] if found else None


class CheckpointManager(object):
    """Periodic checkpointing of a train state.

    Args:
      directory: checkpoint root; step ``s`` lands in ``<directory>/<s>/``.
      save_interval_steps: save when a multiple of this was crossed since
        the last save (0 = only ``force=True`` saves).
      max_to_keep: retained checkpoints; older step directories are
        removed after each save (None or 0 keeps all).
      is_chief: whether this process writes.  In a world of more than one
        process every rank calls :meth:`maybe_save` at the same steps (the
        JAX package's contract); only the chief writes, since the
        all-reduced params and optimizer state are the same on every rank
        (under a sharded layout, FSDP, tensor or expert parallel, every
        rank's ``state_dict()`` all-gathers the sharded optimizer state and
        the expert blocks, and the chief writes the one-card format, which
        restores into any mesh).
        A non-chief records the step it was asked for, so its save gate
        stays in step with the chief's, and writes nothing.  Every rank
        restores from the chief's files, once they are written (after the
        chief's :meth:`wait_until_finished` and a barrier).
      async_save: ``True`` (the default; ``None`` reads
        ``TFOS_ASYNC_CKPT``) makes :meth:`maybe_save` return once the state
        is snapshotted to fresh copies on its device and handed to a
        worker thread, which copies them to the host on a side CUDA stream
        and writes them while the next steps run.  The snapshot makes the
        save safe against the optimizer updating the params in place.  A
        depth-1 queue is the backpressure (one save queued, one in
        flight); a worker error surfaces on the next :meth:`maybe_save` or
        :meth:`wait_until_finished`.  Every read path drains pending saves
        first.  ``False`` saves synchronously.
    """

    def __init__(self, directory, save_interval_steps=100, max_to_keep=3,
                 is_chief=True, async_save=None):
        self.directory = _fs_path(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.is_chief = bool(is_chief)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        if async_save is None:
            async_save = os.environ.get(ASYNC_CKPT_ENV, "1").lower() not in (
                "0", "off", "false", "")
        self.async_save = bool(async_save)
        self._save_queue = _queue.Queue(maxsize=1)
        self._save_thread = None      # started lazily on first async save
        self._save_error = None       # worker exception, re-raised at a sync
        self._last_requested = None   # newest step handed to the worker
        self._copy_stream = None      # side stream of the device-to-host copy
        # resolved once: the corrupt_checkpoint fault fires once per
        # process, and a fresh from_env() per save would re-arm it
        self._injector = fault.from_env()

    def _saved_steps(self):
        """The committed steps, oldest first: digit-named directories only,
        so neither a write in progress (``<step>.tmp<pid>``) nor a
        quarantined step (``<step>.corrupt``) is listed."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self.directory, name)))

    def _latest_saved(self):
        steps = self._saved_steps()
        return steps[-1] if steps else None

    def _latest_effective(self):
        """Newest step saved OR handed to the async worker: the save gate
        must count requested steps, or it would queue one boundary
        twice while its save is in flight."""
        latest = self._latest_saved()
        if self._last_requested is not None and (
                latest is None or self._last_requested > latest):
            return self._last_requested
        return latest

    def maybe_save(self, step, state, force=False):
        """Save if an interval boundary was CROSSED since the last save;
        returns True if a save landed (sync) or was accepted (async).

        Boundary crossing, not ``step % interval == 0``: a caller that
        reports steps at a stride, or from a restored offset, still saves
        once per interval."""
        self._raise_pending_error()
        if not force:
            if not self.save_interval_steps:
                return False  # interval 0: explicit (force=True) saves only
            last = self._latest_effective() or 0
            if (step // self.save_interval_steps
                    <= last // self.save_interval_steps):
                return False
        if step == self._latest_effective():
            return False  # already saved (e.g. final force after interval hit)
        if hasattr(state, "state_dict"):
            # on every rank: under a sharded layout it all-gathers the
            # optimizer state and the expert blocks
            state = state.state_dict()
        if not self.is_chief:
            self._last_requested = step   # the chief writes this step
            return True
        if self.async_save:
            state = _map_tensors(state, lambda t: t.detach().clone())
        ready = None
        if _cuda_device(state) is not None:
            ready = torch.cuda.Event()   # the side-stream copy waits for it
            ready.record()
        if not self.async_save:
            self._write(step, state, ready, force)
            return True
        self._ensure_worker()
        telemetry.get_tracer().instant("checkpoint/save_requested",
                                       step=step, force=force)
        # blocking put: with one save in flight and one queued, a third
        # request waits here instead of stacking snapshots
        self._save_queue.put((step, state, ready, force))
        self._last_requested = step
        return True

    def _write(self, step, state, ready, force):
        """Copy ``state`` to the host (on the side stream, after the
        ``ready`` event of its snapshot), write it under a temporary name,
        rename it into place and apply retention, in a
        ``checkpoint/save`` span."""
        with telemetry.get_tracer().span(
                "checkpoint/save", step=step, force=force,
                asynchronous=self.async_save):
            self._write_files(step, state, ready)
        # chaos only: the save has landed, so the injector garbles a
        # finished step directory
        self._injector.corrupt_checkpoint(self.directory)

    def _write_files(self, step, state, ready):
        device = _cuda_device(state)
        if device is not None:
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=device)
            # into pinned host memory (non_blocking), which PyTorch's host
            # allocator caches for the next save: a copy to pageable memory
            # goes through CUDA's pageable staging buffers and holds the step
            # loop back while it runs (PERF.md)
            with torch.cuda.stream(self._copy_stream):
                if ready is not None:
                    self._copy_stream.wait_event(ready)
                state = _map_tensors(
                    state, lambda t: t.to("cpu", non_blocking=True))
            self._copy_stream.synchronize()
        final = os.path.join(self.directory, str(step))
        tmp = "{}.tmp{}".format(final, os.getpid())
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE_FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        logger.info("checkpointed step %d to %s", step, self.directory)
        if self.max_to_keep:
            for old in self._saved_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)

    # -- async save machinery ---------------------------------------------

    def _raise_pending_error(self):
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            # re-derive the request watermark from what actually landed,
            # so a retry after the failure can save the same step again
            self._last_requested = self._latest_saved()
            raise err

    def _ensure_worker(self):
        if self._save_thread is not None and self._save_thread.is_alive():
            return
        t = threading.Thread(target=self._save_worker, name="ckpt-async-save",
                             daemon=True)
        self._save_thread = t
        t.start()

    def _save_worker(self):
        while True:
            item = self._save_queue.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except Exception as e:  # surfaced at the next sync point
                logger.exception("async checkpoint save of step %s failed",
                                 item[0])
                self._save_error = e
            finally:
                self._save_queue.task_done()

    def _drain_pending(self):
        """Block until every queued async save has been written."""
        if self._save_thread is not None and self._save_thread.is_alive():
            self._save_queue.join()

    # -- read paths -------------------------------------------------------

    def restore_latest(self, map_location="cpu"):
        """The newest checkpoint as ``(state, step)``, its tensors on
        ``map_location``; ``(None, None)`` when there is none."""
        self._drain_pending()
        step = self._latest_saved()
        if step is None:
            return None, None
        with telemetry.get_tracer().span("checkpoint/restore", step=step):
            state = torch.load(
                os.path.join(self.directory, str(step), _STATE_FILE),
                map_location=map_location, weights_only=True)
        logger.info("restored checkpoint step %d from %s", step,
                    self.directory)
        return state, step

    def restore_latest_valid(self, map_location="cpu"):
        """Like :meth:`restore_latest`, but validate before trusting: a step
        directory may be partial (the writer was preempted), corrupt, or
        hold a state saved after a poisoned (nonfinite) update.

        Per candidate, newest first: the step directory must exist with
        content, ``torch.load`` must succeed, and every floating-point
        leaf of the whole tree (the optimizer state included) must be
        finite.  A step that fails is quarantined, renamed to
        ``<step>.corrupt`` (``.corrupt.N`` when taken) with a
        ``checkpoint/quarantine`` trace instant, and the next older step is
        tried.  Returns ``(state, step)`` from the newest valid step, or
        ``(None, None)`` when none is left (train from scratch)."""
        self._drain_pending()
        tracer = telemetry.get_tracer()
        tried = set()
        while True:
            step = self._latest_saved()
            # the save gate follows what is left on disk, so a step
            # trained again after a quarantine is saved again
            self._last_requested = step
            if step is None:
                return None, None
            if step in tried:
                # the quarantine did not take it out of the listing: give
                # up rather than loop
                logger.error("checkpoint step %d remains listed after "
                             "quarantine; recovering from scratch", step)
                return None, None
            tried.add(step)
            step_dir = os.path.join(self.directory, str(step))
            try:
                with tracer.span("checkpoint/restore", step=step,
                                 validated=True):
                    if not os.path.isdir(step_dir) or not os.listdir(step_dir):
                        raise ValueError("step dir {} missing or empty "
                                         "(uncommitted save)".format(step_dir))
                    state = torch.load(os.path.join(step_dir, _STATE_FILE),
                                       map_location=map_location,
                                       weights_only=True)
                    poisoned = _nonfinite_leaves(state)
                    if poisoned:
                        raise ValueError(
                            "nonfinite values in restored state: {}".format(
                                ", ".join(poisoned[:4])))
            except Exception:
                logger.warning(
                    "checkpoint step %d failed validation; quarantining and "
                    "falling back to the previous retained step", step,
                    exc_info=True)
                tracer.instant("checkpoint/quarantine", step=step)
                self._quarantine(step_dir)
                continue
            logger.info("restored validated checkpoint step %d from %s",
                        step, self.directory)
            return state, step

    @staticmethod
    def _quarantine(step_dir):
        """Rename a bad step directory to ``<step>.corrupt`` (suffixed
        ``.N`` if taken), out of the listing but kept for inspection;
        tolerates a directory that is already gone."""
        if not os.path.isdir(step_dir):
            return
        target = step_dir + ".corrupt"
        n = 0
        while os.path.exists(target):
            n += 1
            target = "{}.corrupt.{}".format(step_dir, n)
        try:
            os.rename(step_dir, target)
            logger.warning("quarantined bad checkpoint: %s -> %s",
                           step_dir, target)
        except OSError:
            logger.exception("could not quarantine %s", step_dir)

    def latest_step(self):
        """Newest saved step, or None; pending async saves are flushed
        first, so it includes every accepted :meth:`maybe_save`."""
        self._drain_pending()
        return self._latest_saved()

    def wait_until_finished(self):
        """Barrier: every accepted save is on storage when this returns,
        and a failed async save raises here instead of vanishing."""
        self._drain_pending()
        self._raise_pending_error()

    def close(self):
        """Flush pending saves and stop the worker.  Never raises for a
        failed in-flight save (close runs on unwind paths); the worker
        logged it."""
        if self._save_thread is not None and self._save_thread.is_alive():
            self._save_queue.join()
            self._save_queue.put(None)  # shutdown sentinel
            self._save_thread.join(timeout=_CLOSE_JOIN_SECS)
            if self._save_thread.is_alive():  # pragma: no cover - wedged fs
                logger.error("async checkpoint worker did not exit within "
                             "%.0fs; abandoning it", _CLOSE_JOIN_SECS)


def _nonfinite_leaves(tree, prefix=""):
    """Key paths of the floating-point tensors in ``tree`` (nested dicts,
    lists and tuples; other leaves are skipped) that hold any NaN or Inf,
    keys joined by dots: ``opt_state.state.3.exp_avg`` in a
    :meth:`~tensorflowonspark_torch.train.TrainState.state_dict`, the
    param name in a flat ``state_dict``.  One device sync per float leaf;
    recovery path only."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if (isinstance(tree, torch.Tensor) and torch.is_floating_point(tree)
                and not bool(torch.isfinite(tree).all())):
            return [prefix or "<root>"]
        return []
    return [path for key, value in items
            for path in _nonfinite_leaves(
                value, "{}.{}".format(prefix, key) if prefix else str(key))]


def should_export(ctx):
    """Who calls :func:`export_model` in a cluster: the chief only, in
    every world.

    The JAX package's rule differs in multi-process worlds, where every
    process calls its export because the orbax save is a cross-process
    collective.  The port writes with ``torch.save`` from one process and
    has no such collective, so any other process writing the same
    directory would only race the chief."""
    return ctx.is_chief()


_ARTIFACT_FILE = "apply.pt2"
_EMBEDDED_FILE = "apply_embedded.pt2"


def export_model(export_dir, params, model_name, model_config=None,
                 input_signature=None, model=None,
                 serialize_platforms=("cpu", "cuda"), embed_batch_size=None,
                 embed_platform="cuda"):
    """Export ``params`` (a ``state_dict`` or an ``nn.Module``) and the
    model descriptor for serving.

    When ``model`` (the ``nn.Module``) and ``input_signature`` are given,
    the serving fn is ALSO exported with ``torch.export``
    (:func:`~tensorflowonspark_torch.serving.serialize_apply`: params as
    inputs, batch-dynamic) to ``apply.pt2``, descriptor key ``"exported":
    {"file", "platforms"}``: a serving host then needs torch and the
    port's ops alone, no model registry and no user code.  Registry
    serving remains the fallback whenever the artifact is absent or made
    for other platforms.

    ``embed_batch_size`` additionally writes a **params-embedded**,
    fixed-batch AOTInductor package for the C++ runner
    (:func:`~tensorflowonspark_torch.serving.serialize_embedded`) to
    ``apply_embedded.pt2``, descriptor key ``"embedded_pt2"``: its io meta
    and ``"file"``; ``embed_platform`` is the device type it is built for
    (the compile runs there).  A failed serialization logs a warning and
    leaves the export registry-served, as in the JAX package."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    export_dir = _fs_path(export_dir)
    os.makedirs(export_dir, exist_ok=True)
    state = {name: t.detach().cpu().contiguous() for name, t in params.items()}
    path = os.path.join(export_dir, _PARAMS_FILE)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    descriptor = {
        "model_name": model_name,
        "model_config": model_config or {},
        "input_signature": input_signature or {},
    }
    if model is not None and input_signature:
        from tensorflowonspark_torch import serving

        try:
            blob, platforms = serving.serialize_apply(
                model, state, input_signature, platforms=serialize_platforms)
            _write_bytes(os.path.join(export_dir, _ARTIFACT_FILE), blob)
            descriptor["exported"] = {"file": _ARTIFACT_FILE,
                                      "platforms": list(platforms)}
        except Exception:
            # params + registry still serve; don't fail the export
            logger.warning("torch.export of the serving fn failed; export "
                           "remains registry-served", exc_info=True)
        if embed_batch_size:
            try:
                package, meta = serving.serialize_embedded(
                    model, state, input_signature,
                    batch_size=embed_batch_size, platform=embed_platform)
                _write_bytes(os.path.join(export_dir, _EMBEDDED_FILE),
                             package)
                meta["file"] = _EMBEDDED_FILE
                descriptor["embedded_pt2"] = meta
            except Exception:
                logger.warning("embedded package build failed; native "
                               "runner artifact omitted", exc_info=True)
    with open(os.path.join(export_dir, _DESCRIPTOR), "w") as f:
        json.dump(descriptor, f)
    logger.info("exported %s to %s", model_name, export_dir)


def _write_bytes(path, data):
    """``data`` to ``path`` through a temporary file and a rename."""
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def load_model(export_dir, validate=False):
    """Load an export: returns ``(state_dict, descriptor_dict)``, the
    tensors on the CPU.

    ``validate=True`` raises ``ValueError`` when any param holds NaN or
    Inf, so a poisoned export is refused before it serves."""
    export_dir = _fs_path(export_dir)
    with open(os.path.join(export_dir, _DESCRIPTOR)) as f:
        descriptor = json.load(f)
    state = torch.load(os.path.join(export_dir, _PARAMS_FILE),
                       map_location="cpu", weights_only=True)
    if validate:
        bad = _nonfinite_leaves(state)
        if bad:
            raise ValueError("export {} has nonfinite params at {}".format(
                export_dir, bad[:4]))
    return state, descriptor
