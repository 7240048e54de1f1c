"""Schema-string parser (reference ``SimpleTypeParser.scala``).

The port's copy of :mod:`tensorflowonspark_tpu.schema` (it never imported jax);
the copy is the port's own.

The reference's JVM inference CLI accepts a Spark ``simpleString`` schema
hint — ``struct<name:type,...>`` with scalar and 1-D array columns
(reference ``SimpleTypeParser.scala:28-64``, used via ``--schema_hint``,
``Inference.scala:30-43``, ``DFUtil.scala:75``).  This module parses the
same grammar into the framework's dfutil schema dict
(``{col: int64|float32|string|binary|array<...>}``).
"""

import re

# Spark simpleString base types -> dfutil types (reference grammar accepts
# the SQL names; DFUtilTest.scala documents the lossy long/float collapse).
_BASE_TYPES = {
    "tinyint": "int64",
    "smallint": "int64",
    "int": "int64",
    "integer": "int64",
    "bigint": "int64",
    "long": "int64",
    "boolean": "int64",
    "float": "float32",
    "double": "float32",
    "string": "string",
    "binary": "binary",
}

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class SchemaParseError(ValueError):
    pass


def _parse_type(text):
    text = text.strip().lower()
    if text.startswith("array<") and text.endswith(">"):
        inner = _parse_type(text[len("array<"):-1])
        if inner.startswith("array<"):
            raise SchemaParseError(
                "nested arrays are not supported (reference grammar is "
                "1-D arrays only): {!r}".format(text))
        return "array<{}>".format(inner)
    if text not in _BASE_TYPES:
        raise SchemaParseError(
            "unknown type {!r}; expected one of {} or array<...>".format(
                text, sorted(set(_BASE_TYPES))))
    return _BASE_TYPES[text]


def _split_fields(body):
    """Split ``a:int,b:array<float>`` on commas not nested in ``<>``."""
    fields, depth, start = [], 0, 0
    for i, ch in enumerate(body):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
            if depth < 0:
                raise SchemaParseError("unbalanced '>' in {!r}".format(body))
        elif ch == "," and depth == 0:
            fields.append(body[start:i])
            start = i + 1
    if depth != 0:
        raise SchemaParseError("unbalanced '<' in {!r}".format(body))
    fields.append(body[start:])
    return fields


def parse(simple_string):
    """``struct<name:type,...>`` -> ``{name: dfutil_type}`` (ordered).

    Reference ``SimpleTypeParser.parse`` (``SimpleTypeParser.scala:28-31``);
    raises :class:`SchemaParseError` on malformed input.
    """
    text = simple_string.strip()
    if not (text.lower().startswith("struct<") and text.endswith(">")):
        raise SchemaParseError(
            "schema must look like struct<name:type,...>, got {!r}".format(
                simple_string))
    body = text[len("struct<"):-1].strip()
    if not body:
        return {}
    schema = {}
    for field in _split_fields(body):
        if ":" not in field:
            raise SchemaParseError("field {!r} is missing ':'".format(field))
        name, _, coltype = field.partition(":")
        name = name.strip()
        if not _NAME_RE.match(name):
            raise SchemaParseError("bad column name {!r}".format(name))
        if name in schema:
            raise SchemaParseError("duplicate column {!r}".format(name))
        schema[name] = _parse_type(coltype)
    return schema
