"""Multi-tensor serving core of the port (the counterpart of
:mod:`tensorflowonspark_tpu.serving`, registry-rebuild path).

The export (:func:`~tensorflowonspark_torch.checkpoint.export_model`) names
a registered model and its config; :class:`ModelServer` rebuilds it, loads
the params onto the device and serves padded batches under
``torch.inference_mode()``.  The feed and output conventions are the JAX
package's:

- inputs: ``input_mapping`` ``{column: tensor}`` with the sorted-column
  contract; per-tensor dtype and shape coercion from the export's input
  signature; single-input models are called positionally, multi-input
  models by tensor-name keyword;
- outputs: a single tensor, a tuple, or a dict of named outputs, zipped
  into output columns by ``output_mapping`` ``{tensor: column}``.

A live weight swap (:meth:`ModelServer.swap_export`) copies a compatible
export's params in place into the served module: nothing is rebuilt or
warmed again.

``warm_cache_dir`` is the JAX server's warm executable cache
(:mod:`~tensorflowonspark_torch.compilecache`): each ladder rung's forward
is compiled ahead of time with AOTInductor at its zero feed, the params
taken as inputs, and stored, so a restarted replica loads every rung with
``compile_count == 0``, and a weight swap keeps the rungs.  Without it the
rungs run the eager forward.  The exported StableHLO artifact of the JAX
server has no counterpart yet (ROADMAP item G): the port serves from the
registry.
"""

import logging
import time

import numpy as np
import torch

from tensorflowonspark_torch import checkpoint, telemetry
from tensorflowonspark_torch.device import resolve_device
from tensorflowonspark_torch.models import get_model
from tensorflowonspark_torch.pipeline import yield_batch

logger = logging.getLogger(__name__)


def _normalize_signature(signature):
    """Export signatures may be ``{tensor: shape_list}`` (legacy) or
    ``{tensor: {"shape": [...], "dtype": "float32"}}``; normalize to the
    dict form."""
    out = {}
    for name, spec in (signature or {}).items():
        if isinstance(spec, dict):
            out[name] = {"shape": spec.get("shape"),
                         "dtype": spec.get("dtype", "float32")}
        else:
            out[name] = {"shape": spec, "dtype": "float32"}
    return out


def bucket_ladder(max_batch):
    """Power-of-two padded-batch ladder up to and including ``max_batch``:
    every dispatched batch is padded up to one of these sizes.
    ``max_batch`` itself is always the top rung."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1, got %r" % (max_batch,))
    ladder, b = [], 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return tuple(ladder)


def bucket_for(count, ladder):
    """Smallest ladder rung holding ``count`` rows (the pad target).
    Counts above the top rung return ``count`` unchanged."""
    for b in ladder:
        if count <= b:
            return b
    return count


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class ModelServer(object):
    """Loads an export once and serves batched inference on ``device``
    (default: the CUDA card; ``device="cpu"`` only when asked)."""

    def __init__(self, export_dir, batch_size=128, device=None,
                 warm_cache_dir=None):
        self.device = resolve_device(device)
        state, desc = checkpoint.load_model(export_dir)
        self.batch_size = batch_size
        #: The padded-batch ladder every dispatch is rounded up to.
        self.buckets = bucket_ladder(batch_size)
        #: Distinct ladder rungs dispatched so far (the JAX server's
        #: compile count; eager PyTorch compiles nothing, but a rung seen
        #: first on the request path still pays its allocations).
        self.compile_count = 0
        self._seen_buckets = set()
        #: Per-rung verdicts of the last :meth:`warmup` (``{"buckets":
        #: [{bucket, verdict, micros}], "loaded": n, "compiled": m}``); the
        #: gateway publishes it on its roster registration.
        self.warmup_report = None
        #: Completed live weight swaps (:meth:`swap_export`).
        self.swap_count = 0
        # Warm-start artifact store (compilecache.AOTCache): each rung's
        # AOTInductor package, stored across restarts.  _warm_exec holds
        # the rungs' loaded programs, called with the served params.
        self._aot = None
        self._warm_exec = {}
        if warm_cache_dir:
            from tensorflowonspark_torch import compilecache

            self._aot = compilecache.AOTCache(warm_cache_dir)
        self.descriptor = desc
        self.signature = _normalize_signature(desc.get("input_signature"))
        self.model = self._registry_model(state)
        logger.info("loaded model %s from %s on %s (inputs: %s)",
                    desc["model_name"], export_dir, self.device,
                    sorted(self.signature) or "<unnamed>")

    @property
    def model_name(self):
        """Descriptor model name (the ``model`` label on serving metrics)."""
        return str(self.descriptor.get("model_name") or "default")

    @property
    def model_version(self):
        """Descriptor model version (the ``version`` label on serving
        metrics)."""
        return str(self.descriptor.get("model_version") or "0")

    def swap_export(self, export_dir, expected_version=None):
        """Live weight swap: copy ``export_dir``'s params in place into the
        served module.  Nothing is rebuilt or warmed again, and
        ``compile_count`` does not move.

        Refused with :class:`~tensorflowonspark_torch.fleet.SwapRefused`
        when the new export would need another model: a different model
        name, ``model_config`` or input signature, or different param
        names, shapes or dtypes; a ``ValueError`` when the new params hold
        NaN or Inf (``load_model(validate=True)``).  A refusal leaves the
        served model untouched.

        Single-dispatcher contract: the gateway applies swaps on its
        batcher thread between dispatches, on the stream its dispatches
        use, so no kernel reads a half-copied weight.  Returns the new
        version string.
        """
        from tensorflowonspark_torch import fleet

        state, desc = checkpoint.load_model(export_dir, validate=True)
        if str(desc.get("model_name")) != str(
                self.descriptor.get("model_name")):
            raise fleet.SwapRefused(
                "swap refused: model {} != {}".format(
                    desc.get("model_name"),
                    self.descriptor.get("model_name")))
        if (desc.get("model_config") or {}) != (
                self.descriptor.get("model_config") or {}):
            raise fleet.SwapRefused("swap refused: model_config differs "
                                    "(would rebuild the model)")
        if _normalize_signature(desc.get("input_signature")) != \
                self.signature:
            raise fleet.SwapRefused("swap refused: input signature differs "
                                    "(would rebuild the model)")

        def avals(sd):
            return {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}

        if avals(state) != avals(self.model.state_dict()):
            raise fleet.SwapRefused(
                "swap refused: params names/shapes/dtypes differ (would "
                "rebuild the model)")
        # in-place copies on the device's current stream, the one the
        # next dispatch's kernels queue behind
        self.model.load_state_dict(state)
        self.descriptor = dict(desc)
        if expected_version is not None:
            self.descriptor["model_version"] = str(expected_version)
        self.swap_count += 1
        logger.info("swapped model %s to version %s from %s (in place, %d "
                    "warm rungs kept)", self.model_name, self.model_version,
                    export_dir, len(self._seen_buckets))
        return self.model_version

    def _registry_model(self, state):
        """Rebuild the model from the registry by descriptor name, sized to
        the params' shapes, and load the params onto the device."""
        config = dict(self.descriptor.get("model_config") or {})
        arch = config.pop("architecture", None) \
            or self.descriptor["model_name"]
        with torch.device("meta"):
            model = get_model(arch, state_dict=state, **config)
        model.load_state_dict(state, assign=True)
        return model.to(self.device).eval()

    def _apply(self, inputs):
        """Single-input models positionally, multi-input by keyword."""
        if len(self.signature) > 1:
            return self.model(**inputs)
        (x,) = inputs.values()
        return self.model(x)

    def _functional(self, params, inputs):
        """:meth:`_apply` with ``params`` in place of the module's own (the
        form a rung's AOTInductor program is compiled from)."""
        if len(self.signature) > 1:
            return torch.func.functional_call(self.model, params, (), inputs)
        return torch.func.functional_call(self.model, params,
                                          tuple(inputs.values()))

    def _params(self):
        """The served module's params and buffers by name: the tensors a
        weight swap writes in place."""
        params = {k: v.detach() for k, v in self.model.named_parameters()}
        params.update((k, v.detach()) for k, v in self.model.named_buffers())
        return params

    def _inputs(self, feed):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in feed.items()}

    # -- input assembly ---------------------------------------------------

    def _feed_spec(self, input_mapping):
        """Feed order as ``[(column, tensor), ...]``: sorted by column name
        when a mapping is given (the sorted-column contract), else the
        signature's sorted tensor names with no column binding."""
        if input_mapping:
            return sorted(input_mapping.items())
        if self.signature:
            return [(None, t) for t in sorted(self.signature)]
        return [(None, None)]  # unnamed single input

    def _feed_dict_single(self, rows, input_mapping, dict_rows):
        """Single-input feed: all mapped columns (or all row fields)
        assemble positionally into the one input tensor."""
        tensor = next(iter(self.signature)) if self.signature else None
        cols = sorted(input_mapping) if input_mapping else None
        if dict_rows:
            if cols is None:
                if tensor and tensor in rows[0]:
                    cols = [tensor]   # column named after the tensor
                elif len(rows[0]) == 1:
                    cols = [next(iter(rows[0]))]
                else:
                    raise ValueError(
                        "dict rows with columns {} need an input_mapping "
                        "naming the input column(s) (no column matches the "
                        "signature tensor {!r})".format(
                            sorted(rows[0]), tensor))
            if len(cols) == 1:
                vals = [r[cols[0]] for r in rows]
            else:
                vals = [[r[c] for c in cols] for r in rows]
        else:
            vals = rows   # positional: the whole row is the input
        return {tensor or "_x": self._coerce(tensor, vals)}

    def _coerce(self, tensor, col):
        """Apply the signature's dtype/shape to one input column."""
        spec = None
        if tensor and self.signature:
            spec = self.signature.get(tensor)
            if spec is None:
                raise ValueError(
                    "tensor {!r} (from input_mapping) not in the export's "
                    "input signature {}".format(tensor,
                                                sorted(self.signature)))
        dtype = np.dtype(spec["dtype"]) if spec else np.float32
        x = np.asarray(col, dtype=dtype)
        if spec and spec.get("shape"):
            x = x.reshape([-1] + list(spec["shape"][1:]))
        return x

    def _feed_dict(self, rows, spec, input_mapping=None):
        """Build ``{tensor: array}`` from a batch of rows: single-input
        signatures assemble all columns into the one tensor; multi-input
        signatures bind per tensor, dict rows by column name and tuple rows
        positionally in sorted-column order."""
        dict_rows = bool(rows) and isinstance(rows[0], dict)
        if len(self.signature) <= 1:
            return self._feed_dict_single(rows, input_mapping, dict_rows)
        if not dict_rows and rows and len(rows[0]) != len(spec):
            raise ValueError(
                "rows have {} fields but the feed maps {} tensors {}; pass "
                "an input_mapping selecting exactly the input columns".format(
                    len(rows[0]), len(spec), [t for _, t in spec]))
        feed = {}
        for f, (column, tensor) in enumerate(spec):
            if dict_rows:
                if column is None:
                    column = tensor  # unmapped: column named after tensor
                vals = [r[column] for r in rows]
            else:
                vals = [r[f] for r in rows]
            feed[tensor] = self._coerce(tensor, vals)
        return feed

    # -- prediction -------------------------------------------------------

    def zero_feed(self, rows):
        """A zero-filled feed dict with ``rows`` leading rows, shaped from
        the export's input signature (the warmup payload); ``None`` when
        the signature cannot shape one."""
        if not self.signature:
            return None
        feed = {}
        for tensor, spec in self.signature.items():
            tail = list((spec.get("shape") or [None])[1:])
            if any(d is None for d in tail):
                return None
            feed[tensor] = np.zeros([rows] + [int(d) for d in tail],
                                    np.dtype(spec["dtype"]))
        return feed

    def warmup(self):
        """Warm every ladder rung before traffic arrives, largest first so
        the full batch — the steady-state shape — is warm earliest.
        Returns the number of rungs warmed (0 when the signature cannot
        shape a dummy feed; those exports warm on first use instead).

        Without a warm cache each rung is one zero-filled eager dispatch.
        With ``warm_cache_dir`` each rung first tries to LOAD its stored
        AOTInductor package (a restarted replica then reaches first
        prediction with ``compile_count == 0``); cold rungs compile
        explicitly and persist for the next restart.  Per-rung verdicts
        land in :attr:`warmup_report`."""
        report = []
        for b in reversed(self.buckets):
            feed = self.zero_feed(b)
            if feed is None:
                break
            verdict, micros = self._warm_bucket(b, feed)
            report.append({"bucket": b, "verdict": verdict,
                           "micros": micros})
        self.warmup_report = {
            "buckets": report,
            "loaded": sum(1 for r in report if r["verdict"] == "loaded"),
            "compiled": sum(1 for r in report if r["verdict"] != "loaded"),
        }
        return len(report)

    def _warm_bucket(self, bucket, feed):
        """Warm one ladder rung; returns ``(verdict, micros)`` where the
        verdict is ``"loaded"`` (a stored package, zero compiles) or
        ``"compiled"``."""
        t0 = time.perf_counter()
        if self._aot is not None:
            from tensorflowonspark_torch import compilecache

            name = "serving_b%d" % bucket
            params = self._params()
            fp = compilecache.fingerprint(
                avals=(params, feed),
                extra={"program": name,
                       "stablehlo": False,
                       "model": self.descriptor.get("model_name"),
                       "model_config": repr(sorted(
                           (self.descriptor.get("model_config")
                            or {}).items()))})
            compiled, verdict, _ = compilecache.load_or_compile(
                self._aot, name, fp, compilecache.aoti_compile,
                (self._functional, params, self._inputs(feed)))
            if compiled is not None:
                self._warm_exec[bucket] = compiled
                # loaded rungs never bump compile_count: predict_feed's
                # unseen-rung accounting must not count a load as a
                # compile
                if bucket not in self._seen_buckets:
                    self._seen_buckets.add(bucket)
                    if verdict != "loaded":
                        self.compile_count += 1
                return verdict, int((time.perf_counter() - t0) * 1e6)
            # the export or compile refused: warm by dispatch like the
            # cache-less path
        self.predict_feed(feed, bucket)
        return "compiled", int((time.perf_counter() - t0) * 1e6)

    def predict_feed(self, feed, count):
        """Run one batch padded to its ladder rung on the device; returns
        the model outputs for the first ``count`` rows as a dict of numpy
        arrays.  A rung with a warm program runs it; any rejection reverts
        that rung to the eager forward for good."""
        bucket = bucket_for(count, self.buckets)
        if bucket > count:
            def pad(x):
                width = [(0, bucket - count)] + [(0, 0)] * (x.ndim - 1)
                return np.pad(x, width)

            feed = {k: pad(v) for k, v in feed.items()}
        if bucket not in self._seen_buckets:
            self._seen_buckets.add(bucket)
            self.compile_count += 1
            # a cold rung on the request path is a classic p99 culprit:
            # mark it on the trace timeline next to the request flows
            telemetry.get_tracer().instant(
                "serving/compile", bucket=int(bucket), model=self.model_name)
        inputs = self._inputs(feed)
        with torch.inference_mode():
            warm = self._warm_exec.get(bucket)
            out = None
            if warm is not None:
                try:
                    out = warm(self._params(), inputs)
                except Exception:
                    # the warm program is an optimization only: any
                    # rejection reverts this rung to the eager forward
                    logger.warning("warm program for bucket %d rejected the "
                                   "call; reverting to eager dispatch",
                                   bucket, exc_info=True)
                    self._warm_exec.pop(bucket, None)
            if out is None:
                out = self._apply(inputs)
            return {k: _to_numpy(v[:count])
                    for k, v in _name_outputs(out).items()}

    def run_rows(self, iterator, input_mapping=None, output_mapping=None):
        """Yield one tuple of output-column values per input row (a bare
        value for single-output models): the pipeline transform contract."""
        spec = self._feed_spec(input_mapping)
        for rows, count in yield_batch(iterator, self.batch_size):
            outputs = self.predict_feed(
                self._feed_dict(rows, spec, input_mapping), count)
            cols = output_columns(output_mapping, outputs,
                                  allow_unmapped_multi=False)
            series = [outputs[t] for t, _ in cols]
            if len(series) == 1:
                for i in range(count):
                    yield _pyval(series[0][i])
            else:
                for i in range(count):
                    yield tuple(_pyval(s[i]) for s in series)

    def run_rows_dict(self, iterator, input_mapping=None, output_mapping=None):
        """Yield ``{column: value}`` dicts merged over dict input rows: the
        inference-CLI contract."""
        spec = self._feed_spec(input_mapping)
        for rows, count in yield_batch(iterator, self.batch_size):
            outputs = self.predict_feed(
                self._feed_dict(rows, spec, input_mapping), count)
            cols = output_columns(output_mapping, outputs)
            for i in range(count):
                out = dict(rows[i]) if isinstance(rows[i], dict) else {}
                for tensor, column in cols:
                    out[column] = _pyval(outputs[tensor][i])
                yield out


def _name_outputs(out):
    """Normalize a model's return value to ``{tensor_name: value}``: dicts
    pass through, tuples/lists get positional ``output_<i>`` names, a
    single tensor becomes ``{"output": tensor}``."""
    if isinstance(out, dict):
        return out
    if isinstance(out, (tuple, list)):
        return {"output_{}".format(i): v for i, v in enumerate(out)}
    return {"output": out}


def output_columns(output_mapping, outputs, allow_unmapped_multi=True):
    """Resolve ``output_mapping`` ``{tensor: column}`` against the model's
    named outputs; returns ``[(tensor, column), ...]`` in mapping order.
    Without a mapping: single-output models get the ``prediction`` column;
    multi-output models one column per output tensor named after itself,
    unless ``allow_unmapped_multi`` is False."""
    if output_mapping:
        if len(outputs) == 1 and len(output_mapping) == 1:
            # a single-entry mapping binds to the sole output whatever its key
            return [(next(iter(outputs)), next(iter(output_mapping.values())))]
        missing = [t for t in output_mapping if t not in outputs]
        if missing:
            raise ValueError(
                "output_mapping names tensors {} not among the model "
                "outputs {}".format(missing, sorted(outputs)))
        return list(output_mapping.items())
    if len(outputs) == 1:
        return [(next(iter(outputs)), "prediction")]
    if not allow_unmapped_multi:
        raise ValueError(
            "this model has {} named outputs {}; set an output_mapping "
            "{{tensor: column}} to choose/ name the output columns".format(
                len(outputs), sorted(outputs)))
    return [(t, t) for t in sorted(outputs)]


def _pyval(x):
    """ndarray cell -> plain Python value (scalars stay scalars, vectors
    become lists)."""
    arr = np.asarray(x)
    return arr.item() if arr.ndim == 0 else arr.tolist()
