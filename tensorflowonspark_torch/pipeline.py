"""ML pipeline API: Estimator/Model wrappers over the cluster lifecycle
(the port's counterpart of :mod:`tensorflowonspark_tpu.pipeline`).

The reference integrates with Spark ML (reference ``pipeline.py``): a
``TFEstimator`` whose ``fit(df)`` spawns a TFoS cluster, feeds the
DataFrame, and returns a ``TFModel`` that runs cached single-node
inference per executor (reference ``pipeline.py:330-446,454-520``).  This
module rebuilds that surface over the port:

- :class:`TFEstimator` / :class:`TFModel` work against any backend
  (built-in LocalBackend, or Spark when pyspark is installed — datasets may
  be plain row lists or DataFrames, see :func:`_dataset_rows`);
- the model artifact is the port's export (a ``state_dict`` and the model
  descriptor, :func:`~tensorflowonspark_torch.checkpoint.export_model`) —
  transform executors rebuild the model from the registry by name and run
  batched inference on ``device`` (the CUDA card unless ``device="cpu"``)
  with a process-global cache (the role of the reference's global
  ``pred_fn`` cache, ``pipeline.py:449-451,474-481``);
- the ~18 ``Has*`` Param mixins (reference ``pipeline.py:44-272``) become
  one declarative param table with the same merge-with-argparse semantics
  (:meth:`TFParams.merge_args_params`, reference ``pipeline.py:318-327``).

CUDA and fork: a transform that runs on an executor initializes CUDA in
that executor's process, and a SPARK-mode node forks its manager and its
user-fn child there.  So ``fit`` then ``transform`` (the order the API
implies) is safe on one backend; a ``fit`` after a CUDA ``transform`` on
the same executors is refused by the node with an error that names this
(:func:`tensorflowonspark_torch.node.refuse_if_cuda_initialized`).
"""

import argparse
import logging

import numpy as np

logger = logging.getLogger(__name__)

# pyspark.ml compatibility (reference ``pipeline.py:330-446`` subclasses
# ``pyspark.ml.Estimator/Model`` so TFoS stages compose into ML Pipelines):
# when pyspark is importable, TFEstimator/TFModel are real pipeline stages
# (ABCMeta + Params machinery + _fit/_transform dispatch); otherwise they
# degrade to plain framework classes with the same user-facing API.
try:
    from pyspark.ml import Estimator as _MLEstimator
    from pyspark.ml import Model as _MLModel

    HAS_PYSPARK_ML = True
except Exception:  # pyspark absent: framework-only classes
    _MLEstimator = object
    _MLModel = object
    HAS_PYSPARK_ML = False

# Process-global model cache for transform executors (reference
# ``pipeline.py:449-451``): survives across partitions on the same executor.
_model_cache = {}


class Namespace(object):
    """Dict/Namespace adapter (reference ``pipeline.py:275-315``): wraps a
    dict, an ``argparse.Namespace``, or another Namespace into attribute
    access with ``argv`` round-tripping."""

    def __init__(self, d=None, **kwargs):
        if d is None:
            d = {}
        elif isinstance(d, (Namespace, argparse.Namespace)):
            d = dict(vars(d))
        elif not isinstance(d, dict):
            raise ValueError("unsupported Namespace source: {!r}".format(type(d)))
        self.__dict__.update(d)
        self.__dict__.update(kwargs)

    def __iter__(self):
        return iter(self.__dict__)

    def __contains__(self, key):
        return key in self.__dict__

    def __repr__(self):
        return "Namespace({})".format(self.__dict__)

    def __eq__(self, other):
        return isinstance(other, (Namespace, argparse.Namespace)) and \
            vars(self) == vars(other)


# Declarative param table — the reference's Has* mixin surface
# (reference ``pipeline.py:44-272``) in one place: name -> (default, doc).
PARAMS = {
    "batch_size": (128, "number of records per batch"),
    "cluster_size": (1, "number of nodes in the cluster"),
    "epochs": (1, "number of epochs of training data"),
    "input_mapping": (None, "mapping of input column to tensor name"),
    "output_mapping": (None, "mapping of output tensor to output column"),
    "input_mode": (None, "input data mode (InputMode.SPARK when None)"),
    "master_node": ("chief", "job name of the chief/master node"),
    "model_dir": (None, "path to save/load model checkpoints"),
    "export_dir": (None, "path to export the trained model"),
    "model_name": (None, "registered model-zoo name for transform executors"),
    "model_config": (None, "model constructor config dict"),
    "num_ps": (0, "number of ps-like (long-running non-worker) nodes"),
    "grace_secs": (30, "grace period after feeding ends (chief export time)"),
    "steps": (1000, "max number of steps to train"),
    "steps_per_call": (1, "train steps per device dispatch (CUDA graph "
                          "replays; amortizes dispatch latency)"),
    "accum_steps": (1, "gradient-accumulation microbatches per step"),
    "chunk_size": (1024, "rows per columnar feed chunk"),
    "tensorboard": (False, "launch tensorboard on the chief"),
    "feed_timeout": (600, "timeout (secs) for feeding a partition"),
}


class TFParams(object):
    """Param storage with getters/setters and argparse merging (the role of
    the reference's ``TFParams`` + ``Has*`` mixins)."""

    def __init__(self, **kwargs):
        self._tfos_params = {name: default for name, (default, _) in PARAMS.items()}
        for key, val in kwargs.items():
            self.set(key, val)
        # Cooperative init: when a subclass also derives from
        # pyspark.ml.Estimator/Model, this initializes the Params/uid
        # machinery those base classes need.
        super(TFParams, self).__init__()

    def set(self, name, value):
        if name not in PARAMS:
            raise KeyError("unknown param {!r}; known: {}".format(
                name, sorted(PARAMS)))
        self._tfos_params[name] = value
        return self

    def get(self, name):
        return self._tfos_params[name]

    def __getattr__(self, name):
        # setBatchSize/getBatchSize-style accessors for reference familiarity
        if name.startswith(("set", "get")) and len(name) > 3:
            snake = "".join(
                "_" + c.lower() if c.isupper() else c for c in name[3:]).lstrip("_")
            if snake in PARAMS:
                if name.startswith("set"):
                    return lambda value: self.set(snake, value)
                return lambda: self.get(snake)
        raise AttributeError(name)

    def merge_args_params(self, args):
        """Merge this object's params over an args Namespace: params set here
        win, args fill the rest (reference ``pipeline.py:318-327``)."""
        merged = Namespace(args)
        for name, value in self._tfos_params.items():
            setattr(merged, name, value)
        return merged


# ---------------------------------------------------------------------------
# dataset adapters
# ---------------------------------------------------------------------------

def _dataset_rows(dataset, input_columns=None):
    """Normalize a dataset to (rows, columns): rows are tuples ordered by
    sorted column name (the reference's sorted-column contract,
    ``pipeline.py:387,428-429``).

    Accepts a Spark DataFrame (``.select(...).rdd`` path), a list of dicts,
    or a list of tuples (used as-is, assumed pre-ordered).
    """
    if hasattr(dataset, "select") and hasattr(dataset, "rdd"):  # Spark DF
        cols = sorted(input_columns or dataset.columns)
        return dataset.select(cols).rdd, cols
    rows = list(dataset)
    if rows and isinstance(rows[0], dict):
        cols = sorted(input_columns or rows[0].keys())
        return [tuple(row[c] for c in cols) for row in rows], cols
    return rows, sorted(input_columns) if input_columns else None


# ---------------------------------------------------------------------------
# Estimator
# ---------------------------------------------------------------------------

class TFEstimator(TFParams, _MLEstimator):
    """Trains a model on a dataset via a framework cluster and returns a
    :class:`TFModel` (reference ``TFEstimator``, ``pipeline.py:330-391``).

    When pyspark is installed this is a real ``pyspark.ml.Estimator``, so it
    composes into ``pyspark.ml.Pipeline`` alongside other stages (reference
    ``pipeline.py:330``); without pyspark the same API works standalone.

    Args:
      train_fn: user ``main_fun(args, ctx)`` run on every node; reads its
        data with a :class:`~tensorflowonspark_torch.datafeed.DataFeed` (the
        pipeline always uses SPARK input mode, reference ``pipeline.py:384``).
      tf_args: argparse Namespace / dict of extra args for ``train_fn``.
      backend: a :mod:`~tensorflowonspark_torch.backend` backend or live
        SparkContext; owns the executors used for the training cluster.
      device: where the returned :class:`TFModel` serves (the CUDA card
        unless ``"cpu"``); ``train_fn`` picks its own device.
    """

    def __init__(self, train_fn, tf_args, backend, device=None, **params):
        super(TFEstimator, self).__init__(**params)
        self.train_fn = train_fn
        self.args = Namespace(tf_args)
        self.backend = backend
        self.device = device

    def fit(self, dataset, params=None):
        """Spawn a cluster, feed the dataset, return a TFModel (reference
        ``pipeline.py:367-391``)."""
        if HAS_PYSPARK_ML and params is not None:
            # defer to pyspark's fit() param-map handling -> calls _fit
            return _MLEstimator.fit(self, dataset, params)
        return self._fit(dataset)

    def _fit(self, dataset):
        from tensorflowonspark_torch import cluster as cluster_mod

        local_args = self.merge_args_params(self.args)
        logger.info("fit: %s", vars(local_args))
        input_cols = (sorted(local_args.input_mapping)
                      if local_args.input_mapping else None)
        rows, cols = _dataset_rows(dataset, input_cols)
        if not hasattr(rows, "foreachPartition"):
            # local row list -> one partition per worker (the Spark path
            # arrives pre-partitioned as an RDD)
            from tensorflowonspark_torch import backend as backend_mod

            num_workers = max(local_args.cluster_size - local_args.num_ps, 1)
            rows = backend_mod.partition(rows, num_workers)

        tpu_cluster = cluster_mod.run(
            self.backend, self.train_fn, local_args,
            num_executors=local_args.cluster_size,
            num_ps=local_args.num_ps,
            tensorboard=local_args.tensorboard,
            input_mode=cluster_mod.InputMode.SPARK,
            master_node=local_args.master_node,
        )
        tpu_cluster.train(rows, num_epochs=local_args.epochs,
                          feed_timeout=local_args.feed_timeout,
                          chunk_size=local_args.chunk_size)
        tpu_cluster.shutdown(grace_secs=local_args.grace_secs)
        return TFModel(local_args, backend=self.backend, device=self.device)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class TFModel(TFParams, _MLModel):
    """Batched, cached, per-executor model inference over a dataset
    (reference ``TFModel``, ``pipeline.py:394-446``).

    When pyspark is installed this is a real ``pyspark.ml.Model`` pipeline
    stage; ``transform(df)`` then returns a DataFrame with the prediction
    column (reference ``_transform`` builds one, ``pipeline.py:445-446``).

    Loads the port's export (``export_dir``) on each executor — model
    rebuilt from the registry via the export descriptor, params from the
    ``state_dict`` — on ``device`` (the CUDA card unless ``"cpu"``), and
    maps partitions to predictions with a process-global cache, exactly
    the reference's single-node-inference design (model must fit on one
    card; reference ``pipeline.py:6-9``).  With ``backend=None`` the
    transform runs in this process.
    """

    def __init__(self, args=None, backend=None, device=None, **params):
        super(TFModel, self).__init__(**params)
        if args is not None:  # inherit estimator params (reference TFModel(args))
            for name in PARAMS:
                if name in args:
                    self._tfos_params[name] = getattr(args, name)
        self.backend = backend
        self.device = device

    def transform(self, dataset, params=None, num_partitions=None):
        """Run inference over the dataset (reference ``_transform``,
        ``pipeline.py:419-446``).  Returns a DataFrame (prediction column
        appended per the output_mapping) when given a DataFrame, else a list
        of output rows."""
        if HAS_PYSPARK_ML and params is not None:
            return _MLModel.transform(self, dataset, params)
        return self._transform(dataset, num_partitions)

    def _output_columns(self):
        """Output column names in mapping order (``["prediction"]`` when no
        output_mapping is set)."""
        out_map = self.get("output_mapping")
        return list(out_map.values()) if out_map else ["prediction"]

    def _transform(self, dataset, num_partitions=None):
        from tensorflowonspark_torch import backend as backend_mod

        export_dir = self.get("export_dir") or self.get("model_dir")
        assert export_dir, "export_dir (or model_dir) must be set for transform"
        input_cols = (sorted(self.get("input_mapping"))
                      if self.get("input_mapping") else None)
        rows, cols = _dataset_rows(dataset, input_cols)
        run = _run_model_fn(export_dir, self.get("batch_size"),
                            input_mapping=self.get("input_mapping"),
                            output_mapping=self.get("output_mapping"),
                            device=self.device)

        out_cols = self._output_columns()
        if hasattr(rows, "mapPartitions"):  # Spark RDD path
            out_rdd = rows.mapPartitions(run)
            spark = getattr(dataset, "sparkSession", None)
            if spark is None:
                return out_rdd
            # DataFrame in -> DataFrame out, one column per output tensor
            # (reference pipeline.py:445-446; M columns like TFModel.scala)
            if len(out_cols) == 1:
                out_rdd = out_rdd.map(lambda p: (p,))
            return spark.createDataFrame(out_rdd, out_cols)
        num_partitions = num_partitions or getattr(
            self.backend, "num_executors", 1)
        parts = backend_mod.partition(rows, num_partitions)
        if self.backend is None:
            return [out for part in parts for out in run(iter(part))]
        results = self.backend.map_partitions(parts, run)
        return [out for part in results if part for out in part]


def _run_model_fn(export_dir, batch_size, input_mapping=None,
                  output_mapping=None, device=None):
    """Build the per-partition inference closure (reference ``_run_model``,
    ``pipeline.py:454-520``); the closure is cloudpickled to executors.
    Rows in, output rows out — a bare value per row for single-output
    models, a tuple of output-column values for multi-output models."""

    def _run_model(iterator):
        import tensorflowonspark_torch.pipeline as pipeline_mod

        # Process-global cache: load/compile once per executor process, reuse
        # across partitions (reference pipeline.py:474-481).  The module must
        # be referenced absolutely — this closure runs cloudpickled, so its
        # own module globals would be by-value copies.  batch_size is part
        # of the key: a later transform with a different batch size must not
        # silently reuse a server padded for the old one.
        key = (export_dir, batch_size)
        server = pipeline_mod._model_cache.get(key)
        if server is None:
            from tensorflowonspark_torch import serving

            server = serving.ModelServer(export_dir, batch_size,
                                         device=device)
            pipeline_mod._model_cache[key] = server
        return list(server.run_rows(iterator, input_mapping=input_mapping,
                                    output_mapping=output_mapping))

    return _run_model


def yield_batch(iterator, batch_size):
    """Generate ``(rows, count)`` batches from a row iterator (reference
    ``yield_batch``, ``pipeline.py:540-562``)."""
    batch = []
    for row in iterator:
        batch.append(row)
        if len(batch) >= batch_size:
            yield batch, len(batch)
            batch = []
    if batch:
        yield batch, len(batch)
