"""Row <-> TFRecord interchange (a copy of the JAX package's
``data/interchange.py``; original: tensorflowonspark/dfutil.py and
``DFUtil.scala``/``SimpleTypeParser.scala``).

Rows are plain dicts.  :func:`save_as_tfrecords` writes them as shards of
``tf.train.Example`` (byte for byte the JAX package's files for the same
rows and schema); :func:`load_tfrecords` reads them back, with the
schema inferred from the first record when none is given (the
``binary_features`` hint tells bytes from strings).  Schemas are
``[(name, type)]`` lists or ``struct<name:type,...>`` strings.  Remote
``scheme://`` paths go through ``fsspec`` (:mod:`..utils.fs`); the Spark
adapter in :mod:`.spark_io` maps DataFrames onto these rows.
"""

import logging
import re

import numpy as np

from . import example as ex
from . import tfrecord as tfr
from ..utils import fs as fs_utils

logger = logging.getLogger(__name__)

#: scalar schema types (the SimpleTypeParser base-type set,
#: SimpleTypeParser.scala:42-55, plus the narrow-dtype plane's
#: ``byte``/``ubyte`` extension: an image column declared ``ubyte``
#: ships uint8 end to end instead of the proto's int64)
SCALAR_TYPES = (
    "binary", "boolean", "double", "float", "int", "long", "string",
    "short", "byte", "ubyte",
)

#: schema base type → the numpy WIRE dtype a numeric column of that
#: type ships in (the storage dtype, not the proto kind: the proto
#: layer promotes everything to int64/float32, and the narrow plane
#: undoes that at ingest — see :func:`schema_wire_spec`)
WIRE_DTYPE_OF_BASE = {
    "boolean": "uint8",
    "ubyte": "uint8",
    "byte": "int8",
    "short": "int16",
    "int": "int32",
    "long": "int64",
    "float": "float32",
    "double": "float64",
}


# ----------------------------------------------------------------------
# schema strings:  struct<name:type,...>  with  array<base>
# ----------------------------------------------------------------------

_STRUCT_RE = re.compile(r"^\s*struct\s*<(.*)>\s*$", re.S)


def parse_schema(text):
    """Parse ``struct<a:int,b:array<float>,c:string>`` → ordered
    ``[(name, type)]`` (type is ``"base"`` or ``"array<base>"``)."""
    m = _STRUCT_RE.match(text)
    if not m:
        raise ValueError("schema must look like struct<name:type,...>: "
                         "{0!r}".format(text))
    body = m.group(1)
    fields = []
    depth, start = 0, 0
    parts = []
    for i, ch in enumerate(body):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
    parts.append(body[start:])
    for part in parts:
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError("field {0!r} missing ':'".format(part))
        name, typ = part.split(":", 1)
        fields.append((name.strip(), _check_type(typ.strip())))
    if not fields:
        raise ValueError("empty struct schema")
    return fields


def _check_type(typ):
    inner = typ
    m = re.match(r"^array\s*<(.*)>$", typ)
    if m:
        inner = m.group(1).strip()
        if inner not in SCALAR_TYPES:
            raise ValueError("unsupported array element type "
                             "{0!r}".format(inner))
        return "array<{0}>".format(inner)
    if typ not in SCALAR_TYPES:
        raise ValueError("unsupported type {0!r}".format(typ))
    return typ


def format_schema(fields):
    return "struct<{0}>".format(
        ",".join("{0}:{1}".format(n, t) for n, t in fields)
    )


# ----------------------------------------------------------------------
# schema inference from decoded examples
# ----------------------------------------------------------------------


def infer_schema(feature_dict, binary_features=()):
    """Infer ``[(name, type)]`` from one decoded example (reference:
    dfutil.py:134-168 — first record wins; single-element lists become
    scalars, longer lists arrays; bytes are string unless listed in
    ``binary_features``)."""
    fields = []
    for name in sorted(feature_dict):
        kind, values = feature_dict[name]
        if kind == ex.KIND_INT64:
            base = "long"
        elif kind == ex.KIND_FLOAT:
            base = "float"
        else:
            base = "binary" if name in binary_features else "string"
        if len(values) > 1:
            fields.append((name, "array<{0}>".format(base)))
        else:
            fields.append((name, base))
    return fields


# ----------------------------------------------------------------------
# rows <-> examples
# ----------------------------------------------------------------------

_KIND_OF_BASE = {
    "binary": ex.KIND_BYTES,
    "string": ex.KIND_BYTES,
    "boolean": ex.KIND_INT64,
    "byte": ex.KIND_INT64,
    "ubyte": ex.KIND_INT64,
    "short": ex.KIND_INT64,
    "int": ex.KIND_INT64,
    "long": ex.KIND_INT64,
    "float": ex.KIND_FLOAT,
    "double": ex.KIND_FLOAT,
}


def schema_wire_spec(schema):
    """Derive the narrow-dtype plane's per-column wire dtypes from a
    schema.

    ``schema`` is a ``struct<...>`` string or ``[(name, type)]``; the
    result is a :class:`~.columnar.WireSpec`
    over every numeric column — ``ubyte`` image columns come out
    uint8, ``short`` int16, etc. — ready for ``WireSpec.narrow`` /
    ``narrow_rows`` at the feeder, so a schema-declared storage dtype
    is honored end-to-end instead of riding the proto's int64/float32
    promotion.  String/binary columns are not wire-narrowable and are
    left out (they pass through feeds untouched)."""
    from . import columnar

    if isinstance(schema, str):
        schema = parse_schema(schema)
    dtypes = {}
    for name, typ in schema:
        base, _ = _base_of(typ)
        if base in WIRE_DTYPE_OF_BASE:
            dtypes[name] = WIRE_DTYPE_OF_BASE[base]
    return columnar.WireSpec(dtypes)


def _base_of(typ):
    m = re.match(r"^array<(.*)>$", typ)
    return (m.group(1), True) if m else (typ, False)


def row_to_example(row, schema=None):
    """Encode one dict row.  With a schema, fields are coerced to their
    declared kinds; without, kinds are inferred per value."""
    if schema is None:
        return ex.encode_example(row)
    feats = {}
    for name, typ in schema:
        if name not in row:
            raise KeyError("row missing field {0!r}".format(name))
        base, is_array = _base_of(typ)
        kind = _KIND_OF_BASE[base]
        value = row[name]
        if not is_array and not isinstance(value, (list, tuple, np.ndarray)):
            value = [value]
        if kind == ex.KIND_BYTES:
            value = [
                v.encode("utf-8") if isinstance(v, str) else bytes(v)
                for v in value
            ]
        elif kind == ex.KIND_INT64:
            value = [int(v) for v in value]
        else:
            value = [float(v) for v in value]
        feats[name] = (kind, value)
    return ex.encode_example(feats)


def example_to_row(record, schema):
    """Decode example bytes into a dict per the schema (reference:
    dfutil.py:171-212 fromTFExample)."""
    decoded = ex.decode_example(record)
    row = {}
    for name, typ in schema:
        base, is_array = _base_of(typ)
        if name not in decoded:
            row[name] = [] if is_array else None
            continue
        kind, values = decoded[name]
        if base == "string":
            values = [
                v.decode("utf-8") if isinstance(v, bytes) else v
                for v in values
            ]
        elif base == "boolean":
            values = [bool(v) for v in values]
        elif base in ("int", "short", "byte", "ubyte"):
            values = [int(v) for v in values]
        elif base == "double":
            values = [float(v) for v in values]
        row[name] = values if is_array else (values[0] if values else None)
    return row


# ----------------------------------------------------------------------
# files
# ----------------------------------------------------------------------


def save_as_tfrecords(rows, path, schema=None, num_shards=1):
    """Write rows to ``path`` (a directory of ``part-rNNNNN`` shards —
    the Hadoop OutputFormat layout the reference produced via Spark,
    dfutil.py:29-41; remote ``scheme://`` URIs go through fsspec like
    the reference's jar went through HDFS).  ``schema`` may be a
    ``struct<...>`` string, which the JAX package's copy does not take.
    Returns the number of records written."""
    if isinstance(schema, str):
        schema = parse_schema(schema)
    fs_utils.makedirs(path)
    writers = [
        tfr.TFRecordWriter(
            fs_utils.join(path, "part-r-{0:05d}".format(i))
        )
        for i in range(num_shards)
    ]
    count = 0
    try:
        for row in rows:
            writers[count % num_shards].write(row_to_example(row, schema))
            count += 1
    finally:
        for w in writers:
            w.close()
    logger.info("wrote %d records to %s (%d shards)", count, path, num_shards)
    return count


def _record_files(path):
    if fs_utils.isdir(path):
        files = [
            f
            for f in fs_utils.list_files(path)
            if not fs_utils.basename(f).startswith(("_", "."))
        ]
        if not files:
            raise FileNotFoundError("no record files under {0}".format(path))
        return files
    return [path]


def load_tfrecords(path, schema=None, binary_features=()):
    """Load a TFRecord file/dir → ``(rows, schema)``.  ``schema`` may
    be a ``struct<...>`` string or ``[(name, type)]``; inferred from
    the first record when absent (reference: dfutil.py:44-81)."""
    if isinstance(schema, str):
        schema = parse_schema(schema)
    files = _record_files(path)
    rows = []
    for f in files:
        for record in tfr.read_records(f):
            if schema is None:
                schema = infer_schema(
                    ex.decode_example(record), binary_features
                )
            rows.append(example_to_row(record, schema))
    return rows, schema
