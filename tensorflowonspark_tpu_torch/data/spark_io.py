"""The pyspark DataFrame adapter over the row interchange (a copy of the
JAX package's ``data/spark_io.py``; original: tensorflowonspark/
dfutil.py).

The codec itself is engine-agnostic (:mod:`.interchange`, on dict rows);
this module maps DataFrames onto it and imports ``pyspark`` only when a
DataFrame shows up, so the package never requires it.
"""


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
    except ImportError as e:  # pragma: no cover - pyspark not in test env
        raise ImportError(
            "pyspark is required for DataFrame interop; install it or "
            "pass plain dict rows instead"
        ) from e


def dataframe_to_rows(df):
    """DataFrame → list of dict rows (driver-side collect; the engine
    re-partitions for executor fan-out)."""
    _require_pyspark()
    return [row.asDict() for row in df.collect()]


def _spark_type(typ):
    from pyspark.sql import types as T

    base_map = {
        "binary": T.BinaryType(),
        "boolean": T.BooleanType(),
        "double": T.DoubleType(),
        "float": T.FloatType(),
        "int": T.IntegerType(),
        "long": T.LongType(),
        "string": T.StringType(),
        "short": T.ShortType(),
    }
    if typ.startswith("array<"):
        return T.ArrayType(base_map[typ[len("array<"):-1]])
    return base_map[typ]


def to_spark_schema(schema):
    """Interchange schema (``[(name, type)]`` or struct string) →
    ``pyspark.sql.types.StructType`` (the SimpleTypeParser role,
    reference: SimpleTypeParser.scala:36-63)."""
    _require_pyspark()
    from pyspark.sql import types as T

    from . import interchange

    if isinstance(schema, str):
        schema = interchange.parse_schema(schema)
    return T.StructType(
        [T.StructField(name, _spark_type(typ), True) for name, typ in schema]
    )


def rows_to_dataframe(spark, rows, schema=None):
    """Dict rows → DataFrame.  ``schema`` (interchange schema list or
    struct string) carries the column *types*, so empty row sets and
    None-valued columns don't break Spark's inference."""
    _require_pyspark()
    if schema:
        spark_schema = to_spark_schema(schema)
        cols = spark_schema.fieldNames()
        data = [tuple(r.get(c) for c in cols) for r in rows]
        return spark.createDataFrame(data, schema=spark_schema)
    if not rows:
        raise ValueError(
            "cannot infer a DataFrame schema from zero rows; pass schema="
        )
    return spark.createDataFrame(rows)


def save_df_as_tfrecords(df, path, num_shards=1):
    """DataFrame → TFRecord shards via the native codec
    (reference: dfutil.py:29-41 saveAsTFRecords).  A DataFrame loaded
    by :func:`load_tfrecords_df` reuses its known schema instead of
    re-inferring types per row."""
    from . import interchange

    return interchange.save_as_tfrecords(
        dataframe_to_rows(df),
        path,
        schema=loaded_schema(df),
        num_shards=num_shards,
    )


def load_tfrecords_df(spark, path, schema=None, binary_features=()):
    """TFRecords → DataFrame (reference: dfutil.py:44-81 loadTFRecords).
    The result is marked for :func:`is_loaded_df` provenance checks."""
    from . import interchange

    rows, schema = interchange.load_tfrecords(
        path, schema=schema, binary_features=binary_features
    )
    df = rows_to_dataframe(spark, rows, schema)
    mark_loaded_df(df, schema)
    return df


def mark_loaded_df(df, schema):
    """Record that ``df`` originated from TFRecords (its interchange
    schema is known exactly — no re-inference needed on save)."""
    df._tfos_loaded_schema = schema
    return df


def is_loaded_df(df):
    """True when ``df`` was produced by :func:`load_tfrecords_df`
    (reference: dfutil.py:15-26 ``isLoadedDF`` provenance registry;
    here the mark rides the DataFrame object itself — the reference's
    global dict keyed by id() could alias recycled ids)."""
    return getattr(df, "_tfos_loaded_schema", None) is not None


def loaded_schema(df):
    """The interchange schema a loaded DataFrame carries, or ``None``."""
    return getattr(df, "_tfos_loaded_schema", None)
