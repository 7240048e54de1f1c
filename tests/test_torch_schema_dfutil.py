"""The port's ``schema`` and ``dfutil`` against the JAX package's: the
same schema strings parse to the same dicts and fail with the same
``SchemaParseError``; the same rows and schema write byte-equal TFRecord
shards, and each side loads the other's files to equal rows and schema."""

import os

import numpy as np
import pytest

from tensorflowonspark_tpu import dfutil as jax_dfutil
from tensorflowonspark_tpu import schema as jax_schema
from tensorflowonspark_torch import dfutil, schema

# the strings of tests/test_schema.py (TestParse)
GOOD = [
    "struct<a:int,b:bigint,c:float,d:double,e:string,f:binary,g:boolean>",
    "struct<x:array<float>,y:array<bigint>>",
    "  STRUCT< a : INT , b : ARRAY<STRING> >  ",
    "struct<>",
    "struct<z:int,a:int,m:int>",
    "struct<tiny:tinyint,small:smallint,i:integer,l:long>",
]
BAD = [
    "notastruct",
    "struct<a>",
    "struct<a:unknowntype>",
    "struct<a:array<array<int>>>",
    "struct<a:int,a:float>",
    "struct<1bad:int>",
    "struct<a:array<int>",
    "struct<a:int>>",
]

# the rows of tests/test_dfutil.py (TestDFUtil): every column type
ROWS = [
    {"idx": i, "label": float(i) / 10, "name": "row{}".format(i),
     "raw": bytes([i, i + 1]), "vec": [float(i), float(i + 1)]}
    for i in range(20)
]
SCHEMA = {"idx": "int64", "label": "float32", "name": "string",
          "raw": "binary", "vec": "array<float32>"}


@pytest.mark.parametrize("text", GOOD)
def test_parse_matches_jax(text):
    got = schema.parse(text)
    want = jax_schema.parse(text)
    assert got == want
    assert list(got) == list(want)          # column order kept


@pytest.mark.parametrize("text", BAD)
def test_parse_errors_match_jax(text):
    with pytest.raises(jax_schema.SchemaParseError) as want:
        jax_schema.parse(text)
    with pytest.raises(schema.SchemaParseError) as got:
        schema.parse(text)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("with_schema", [True, False])
def test_tfrecord_shards_byte_equal(tmp_path, num_shards, with_schema):
    kwargs = {"schema": SCHEMA} if with_schema else {}
    got = dfutil.save_as_tfrecords(ROWS, str(tmp_path / "port"),
                                   num_shards=num_shards, **kwargs)
    want = jax_dfutil.save_as_tfrecords(ROWS, str(tmp_path / "jax"),
                                        num_shards=num_shards, **kwargs)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    port_files, jax_files = _files(str(tmp_path / "port")), \
        _files(str(tmp_path / "jax"))
    assert len(port_files) == num_shards
    assert port_files == jax_files


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("hint", [(), ("raw",)])
def test_each_side_loads_the_others_files(tmp_path, writer, hint):
    out = str(tmp_path / "tfr")
    save = (dfutil if writer == "port" else jax_dfutil).save_as_tfrecords
    save(ROWS, out, schema=SCHEMA, num_shards=3)
    got = dfutil.load_tfrecords(out, binary_features=hint)
    want = jax_dfutil.load_tfrecords(out, binary_features=hint)
    assert got.schema == want.schema
    assert list(got) == list(want)
    assert len(got) == len(ROWS)
    assert dfutil.isLoadedDF(got) and not dfutil.isLoadedDF(list(got))
    assert got.source_dir == out


def test_schema_hint_load_and_row_codecs_match_jax(tmp_path):
    out = str(tmp_path / "tfr")
    dfutil.save_as_tfrecords(ROWS, out, schema=SCHEMA)
    hint = schema.parse("struct<idx:bigint,vec:array<float>,raw:binary>")
    got = dfutil.load_tfrecords(out, schema=hint)
    want = jax_dfutil.load_tfrecords(out, schema=jax_schema.parse(
        "struct<idx:bigint,vec:array<float>,raw:binary>"))
    assert list(got) == list(want) and got.schema == want.schema
    for row in ROWS[:3]:
        payload = dfutil.to_example(row, SCHEMA)
        assert payload == jax_dfutil.to_example(row, SCHEMA)
        assert dfutil.infer_schema(payload, ("raw",)) == \
            jax_dfutil.infer_schema(payload, ("raw",))
        a = dfutil.from_example(payload, SCHEMA, as_numpy=True)
        b = jax_dfutil.from_example(payload, SCHEMA, as_numpy=True)
        assert isinstance(a["vec"], np.ndarray)
        np.testing.assert_array_equal(a.pop("vec"), b.pop("vec"))
        assert a == b
    assert dfutil.infer_row_schema(ROWS[0]) == \
        jax_dfutil.infer_row_schema(ROWS[0]) == SCHEMA
    with pytest.raises(ValueError):
        dfutil.infer_row_schema({"flag": True})
    with pytest.raises(IOError):
        dfutil.load_tfrecords(str(tmp_path / "empty"))
