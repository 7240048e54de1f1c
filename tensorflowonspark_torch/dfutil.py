"""TFRecord <-> row-table converters with schema inference (reference ``dfutil.py``).

The port's copy of :mod:`tensorflowonspark_tpu.dfutil` (it never imported jax);
the copy is the port's own.

The reference converts Spark DataFrames to/from TFRecord files through the
Hadoop input/output formats plus TF's Example classes (reference
``dfutil.py:29-81``), inferring a schema by probing the first record
(``dfutil.py:68-71``) with a ``binary_features`` hint disambiguating
bytes-vs-string (``dfutil.py:84-131``).  This module provides the same
surface over the first-party codec stack — C++ TFRecord framing
(:mod:`~tensorflowonspark_torch.tfrecord`) and the no-TF Example proto codec
(:mod:`~tensorflowonspark_torch.example_proto`) — with "DataFrame" generalized
to a list of row dicts (Spark DataFrames convert via ``.collect()``/rdds at
the call site; no JVM in the loop).

Schema types: ``int64 | float32 | string | binary`` and their
``array<...>`` forms.  Like the reference's inference, scalars vs arrays are
guessed from the value count (len 1 = scalar) — documented lossy
(reference ``DFUtilTest.scala:95-132``).
"""

import logging
import weakref

from tensorflowonspark_torch import example_proto, fsio, tfrecord

logger = logging.getLogger(__name__)

class Rows(list):
    """A list of row dicts with an attached ``schema`` ({col: type}) and,
    when loaded from TFRecords, the ``source_dir`` provenance."""

    def __init__(self, rows=(), schema=None, source_dir=None):
        super(Rows, self).__init__(rows)
        self.schema = schema or {}
        self.source_dir = source_dir


# ---------------------------------------------------------------------------
# row <-> Example
# ---------------------------------------------------------------------------

_SCALAR_KINDS = {"int64": "int64", "float32": "float",
                 "string": "bytes", "binary": "bytes"}


def _base_type(coltype):
    return coltype[len("array<"):-1] if coltype.startswith("array<") else coltype


def to_example(row, schema):
    """Encode one row dict as serialized Example bytes (reference
    ``toTFExample``, ``dfutil.py:84-131``)."""
    features = {}
    for name, coltype in schema.items():
        value = row[name]
        base = _base_type(coltype)
        kind = _SCALAR_KINDS[base]
        values = value if coltype.startswith("array<") else [value]
        features[name] = (kind, list(values))
    return example_proto.encode_example(features)


def from_example(serialized, schema, as_numpy=False):
    """Decode serialized Example bytes into a row dict (reference
    ``fromTFExample``, ``dfutil.py:171-212``).  Bytes-vs-string handling is
    driven entirely by the schema's column types (a ``binary_features`` hint
    only matters at schema-inference time, see :func:`infer_schema`).

    ``as_numpy=True`` returns ``array<float32>`` columns as numpy arrays
    (the vectorized fast path for the streaming FILES pipeline); the
    default keeps plain Python lists for DataFrame compatibility."""
    import numpy as np

    feats = example_proto.decode_example(serialized)
    row = {}
    for name, coltype in schema.items():
        kind, values = feats.get(name, ("bytes", []))
        base = _base_type(coltype)
        if base == "string":
            values = [v.decode("utf-8") if isinstance(v, bytes) else v
                      for v in values]
        elif base == "float32":
            values = np.asarray(values, np.float32)
            if not as_numpy:
                # plain Python floats: pyspark's ArrayType verifier (and
                # any list-expecting caller) rejects ndarrays
                values = values.tolist()
        elif base == "int64":
            values = [int(v) for v in values]
        if coltype.startswith("array<"):
            row[name] = values
        else:
            if len(values) == 0:
                row[name] = None
            else:
                v = values[0]
                row[name] = float(v) if base == "float32" else v
    return row


def infer_schema(serialized, binary_features=()):
    """Infer {col: type} from one serialized Example (reference
    ``infer_schema``, ``dfutil.py:134-168``): int64/float kinds map
    directly; bytes is ``string`` unless hinted ``binary``; count 1 means
    scalar, else array (documented lossy)."""
    feats = example_proto.decode_example(serialized)
    schema = {}
    for name, (kind, values) in feats.items():
        if kind == "int64":
            base = "int64"
        elif kind == "float":
            base = "float32"
        else:
            base = "binary" if name in binary_features else "string"
        schema[name] = base if len(values) <= 1 else "array<{}>".format(base)
    return schema


# ---------------------------------------------------------------------------
# file-level save/load
# ---------------------------------------------------------------------------

def save_as_tfrecords(rows, output_dir, schema=None, num_shards=1):
    """Write rows as sharded TFRecord part files (reference
    ``saveAsTFRecords``, ``dfutil.py:29-41``; part-file naming matches the
    Hadoop output format's convention).  Returns the shard paths."""
    if schema is None and isinstance(rows, Rows) and rows.schema:
        schema = rows.schema
    rows = list(rows)
    if schema is None:
        schema = infer_row_schema(rows[0]) if rows else {}
    fsio.makedirs(output_dir)
    paths = []
    num_shards = max(num_shards, 1)
    per_shard = (len(rows) + num_shards - 1) // num_shards
    for shard in range(num_shards):
        path = fsio.join(output_dir, "part-r-{:05d}".format(shard))
        with tfrecord.TFRecordWriter(path) as w:
            for row in rows[shard * per_shard:(shard + 1) * per_shard]:
                w.write(to_example(row, schema))
        paths.append(path)
    logger.info("saved %d rows to %d shards in %s", len(rows),
                len(paths), output_dir)
    return paths


def load_tfrecords(input_dir, binary_features=(), schema=None):
    """Load a TFRecord dir into :class:`Rows`, inferring the schema from the
    first record unless given (reference ``loadTFRecords``,
    ``dfutil.py:44-81``; schema probe 68-71)."""
    paths = fsio.glob(fsio.join(input_dir, "part-*"))
    if not paths:
        paths = fsio.glob(fsio.join(input_dir, "*.tfrecord*"))
    if not paths:
        raise IOError("no TFRecord part files under {}".format(input_dir))
    out = Rows()
    for path in paths:
        for record in tfrecord.tfrecord_iterator(path):
            if schema is None:
                schema = infer_schema(record, binary_features)
                logger.info("inferred schema: %s", schema)
            out.append(from_example(record, schema))
    out.schema = schema or {}
    out.source_dir = input_dir
    return out


# ---------------------------------------------------------------------------
# Spark-DataFrame-native save/load (reference ``dfutil.py:29-81``), no JVM:
# executors run the first-party TFRecord codec per partition.
# ---------------------------------------------------------------------------

# DataFrame provenance (reference ``loadedDF`` dict, ``dfutil.py:15-26``):
# weak-keyed by the DataFrame object so entries die with their DataFrames
# (an id-keyed table would leak and give false positives on recycled ids).
loadedDF = weakref.WeakKeyDictionary()


def isLoadedDF(df_or_rows):
    """True if the DataFrame/Rows came from :func:`load_tfrecords` /
    :func:`loadTFRecords` (reference ``dfutil.py:18-26``).

    Order matters: a pyspark DataFrame's ``__getattr__`` resolves COLUMN
    names, so a user DF with a ``source_dir`` column would answer a plain
    attribute probe — check the provenance dict and the Rows type instead.
    """
    try:
        if df_or_rows in loadedDF:
            return True
    except TypeError:  # unhashable dataset types are never loaded DFs
        pass
    return isinstance(df_or_rows, Rows) and df_or_rows.source_dir is not None


def _spark_type_to_dfutil(dataType, binary_features=(), name=""):
    """Map a ``pyspark.sql.types.DataType`` to a dfutil type string via its
    ``simpleString`` (the same SQL-name table the schema-hint parser uses)."""
    from tensorflowonspark_torch import schema as schema_mod

    simple = dataType.simpleString()
    coltype = schema_mod._parse_type(simple)
    if coltype == "string" and name in binary_features:
        coltype = "binary"
    return coltype


def _dfutil_type_to_spark(coltype):
    from pyspark.sql import types as T

    base = _base_type(coltype)
    spark_base = {"int64": T.LongType(), "float32": T.FloatType(),
                  "string": T.StringType(), "binary": T.BinaryType()}[base]
    if coltype.startswith("array<"):
        return T.ArrayType(spark_base)
    return spark_base


def df_schema(df, binary_features=()):
    """{col: dfutil type} from a DataFrame's SQL schema (reference derived
    Example kinds from the DataFrame schema, ``dfutil.py:99-103``)."""
    return {f.name: _spark_type_to_dfutil(f.dataType, binary_features, f.name)
            for f in df.schema.fields}


def saveAsTFRecords(df, output_dir, binary_features=()):
    """Save a Spark DataFrame as TFRecords under ``output_dir`` (reference
    ``saveAsTFRecords``, ``dfutil.py:29-41``): one part file per partition,
    written by the executors with the first-party codec (no Hadoop jar).
    ``output_dir`` must be on storage shared by driver and executors."""
    schema = df_schema(df, binary_features)
    columns = [f.name for f in df.schema.fields]
    fsio.makedirs(output_dir)

    def _write_part(index, iterator):
        from tensorflowonspark_torch import dfutil as dfutil_mod
        from tensorflowonspark_torch import tfrecord as tfr_mod

        path = fsio.join(output_dir, "part-r-{:05d}".format(index))
        count = 0
        with tfr_mod.TFRecordWriter(path) as w:
            for row in iterator:
                rowd = dict(zip(columns, row))
                w.write(dfutil_mod.to_example(rowd, schema))
                count += 1
        return [count]

    counts = df.rdd.mapPartitionsWithIndex(_write_part).collect()
    logger.info("saved %d rows to %d part files in %s",
                sum(counts), len(counts), output_dir)


def loadTFRecords(sc, input_dir, binary_features=(), schema_hint=None):
    """Load TFRecords under ``input_dir`` as a Spark DataFrame (reference
    ``loadTFRecords``, ``dfutil.py:44-81``): schema inferred by probing the
    first record on the driver (reference ``take(1)`` probe, 68-71) unless a
    schema hint (dfutil dict or ``struct<...>`` string) overrides it; rows
    decoded by the executors.  Records provenance in :data:`loadedDF`."""
    from pyspark.sql import SparkSession
    from pyspark.sql import types as T

    paths = fsio.glob(fsio.join(input_dir, "part-*"))
    if not paths:
        paths = fsio.glob(fsio.join(input_dir, "*.tfrecord*"))
    if not paths:
        raise IOError("no TFRecord part files under {}".format(input_dir))

    if isinstance(schema_hint, str):
        from tensorflowonspark_torch import schema as schema_mod

        schema_hint = schema_mod.parse(schema_hint)
    schema = schema_hint
    if schema is None:
        probe = None
        for path in paths:  # first part files may be empty (empty partitions)
            probe = next(tfrecord.tfrecord_iterator(path), None)
            if probe is not None:
                break
        if probe is None:
            raise IOError("no records under {}".format(input_dir))
        schema = infer_schema(probe, binary_features)
        logger.info("inferred schema: %s", schema)
    columns = list(schema)
    spark_schema = T.StructType([
        T.StructField(name, _dfutil_type_to_spark(coltype), True)
        for name, coltype in schema.items()])

    def _read_part(path_iter):
        from tensorflowonspark_torch import dfutil as dfutil_mod
        from tensorflowonspark_torch import tfrecord as tfr_mod

        for path in path_iter:
            for record in tfr_mod.tfrecord_iterator(path):
                row = dfutil_mod.from_example(record, schema)
                yield tuple(row[c] for c in columns)

    rdd = sc.parallelize(paths, len(paths)).mapPartitions(_read_part)
    spark = SparkSession.builder.getOrCreate()
    df = spark.createDataFrame(rdd, spark_schema)
    loadedDF[df] = input_dir
    return df


def infer_row_schema(row):
    """Infer {col: type} from a Python row dict (save-side inference; the
    reference derived this from the DataFrame's SQL schema,
    ``dfutil.py:99-103``)."""
    schema = {}
    for name, value in row.items():
        is_array = isinstance(value, (list, tuple))
        probe = value[0] if is_array and value else value
        if isinstance(probe, bool):
            raise ValueError("bool column {!r} unsupported (use int64)".format(name))
        if isinstance(probe, int):
            base = "int64"
        elif isinstance(probe, float):
            base = "float32"
        elif isinstance(probe, (bytes, bytearray)):
            base = "binary"
        elif isinstance(probe, str):
            base = "string"
        else:
            raise ValueError("unsupported type {!r} for column {!r}".format(
                type(probe), name))
        schema[name] = "array<{}>".format(base) if is_array else base
    return schema
