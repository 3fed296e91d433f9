"""The port's Spark side on the CPU, without ``pyspark``: ``SparkEngine``
and ``data/spark_io`` held to the JAX package's on the reference's
duck-typed fakes, the ``Engine`` defaults for native datasets, and the
cluster's native-dataset branches end to end.

For the end-to-end half, a ``SparkContext`` stand-in runs its RDD stages
on a ``LocalEngine``'s executor processes (each stage list travels as
``cloudpickle`` bytes, as Spark ships its closures): ``cluster.run``
must wrap it in a ``SparkEngine``, ``train``/``train_stream``/
``train_dstream`` must feed its RDDs in place (no rows through
``parallelize``), ``inference`` must return a lazy result RDD, and
``TFEstimator.fit`` must feed a DataFrame in place as sorted-column
tuples.  The real-Spark twin is ``tests/test_torch_spark_real.py``
(``-m spark``).
"""

import functools
import json
import logging
import sys
import types

import cloudpickle
import numpy as np
import pytest

from tensorflowonspark_tpu import engine as jengine
from tensorflowonspark_tpu.data import spark_io as jsio
from tensorflowonspark_tpu_torch import engine as tengine
from tensorflowonspark_tpu_torch.cluster import cluster
from tensorflowonspark_tpu_torch.data import spark_io as tsio

ENGINES = {"jax": jengine.SparkEngine, "torch": tengine.SparkEngine}
BOUNDS = dict(reservation_timeout=60)


# --- the reference's fakes (tests/test_engine_spark.py) -------------------


class _FakeRDD:
    def __init__(self, data):
        self._parts = data

    def mapPartitions(self, fn):
        self._mapped = [list(fn(iter(part))) for part in self._parts]
        return self

    def collect(self):
        return [x for part in self._mapped for x in part]

    def foreachPartition(self, fn):
        for part in self._parts:
            fn(iter(part))


class _FakeConf:
    def __init__(self, d):
        self._d = d

    def get(self, k, default=None):
        return self._d.get(k, default)


class _FakeStatusTracker:
    def getActiveJobsIds(self):
        return [1, 2]


class _FakeSC:
    def __init__(self):
        self.parallelize_calls = []

    def getConf(self):
        return _FakeConf({"spark.executor.instances": "3"})

    def parallelize(self, data, num_slices):
        self.parallelize_calls.append((data, num_slices))
        return _FakeRDD([[p] for p in data])

    def statusTracker(self):
        return _FakeStatusTracker()


class _FakeDataFrame:
    def __init__(self, rdd):
        self.rdd = rdd


def _rows_of(n):
    """A lazy partition's rows (module-level: shipped by reference)."""
    return list(range(100, 100 + n))


@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_spark_engine_metadata(pkg):
    eng = ENGINES[pkg](_FakeSC())
    assert eng.num_executors == 3
    assert eng.num_executors_exact is False
    assert eng.default_fs == "file://"
    assert eng.num_active_jobs() == 2


@pytest.mark.parametrize("collect", [True, False])
def test_spark_engine_run_job_matches_jax(collect):
    parts = [[1, 2], [3], functools.partial(_rows_of, 2)]
    out = {}
    for pkg, cls in ENGINES.items():
        sc = _FakeSC()
        seen = []

        def mapfn(it, seen=seen):
            rows = list(it)
            seen.append(rows)
            return [x * 2 for x in rows]

        result = cls(sc).run_job(mapfn, parts, collect=collect)
        out[pkg] = (result, seen, [n for _, n in sc.parallelize_calls])
    assert out["torch"] == out["jax"]
    result, seen, slices = out["torch"]
    assert slices == [3]  # one Spark partition per logical partition
    assert seen == [[1, 2], [3], [100, 101]]
    assert result == ([2, 4, 6, 200, 202] if collect else None)


@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_spark_engine_native_dataset_detection(pkg):
    eng = ENGINES[pkg](_FakeSC())
    assert eng.is_native_dataset(_FakeRDD([[1]]))
    assert eng.is_native_dataset(_FakeDataFrame(_FakeRDD([[1]])))
    assert not eng.is_native_dataset([[1, 2], [3]])
    assert not eng.is_native_dataset("not a dataset")


@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_spark_engine_run_data_job_feeds_in_place(pkg):
    sc = _FakeSC()
    eng = ENGINES[pkg](sc)
    seen = []
    eng.run_data_job(lambda it: seen.append(list(it)),
                     _FakeRDD([[1, 2], [3, 4, 5]]))
    assert seen == [[1, 2], [3, 4, 5]]
    assert eng.run_data_job(lambda it: [x + 1 for x in it],
                            _FakeRDD([[1], [2]]), collect=True) == [2, 3]
    df = _FakeDataFrame(_FakeRDD([[7], [8]]))
    eng.run_data_job(lambda it: seen.extend(it), df)
    assert seen[-2:] == [7, 8]
    assert sc.parallelize_calls == []  # no user data through the driver


@pytest.mark.parametrize("pkg", sorted(ENGINES))
def test_spark_engine_map_partitions_native(pkg):
    sc = _FakeSC()
    result = ENGINES[pkg](sc).map_partitions_native(
        lambda it: [x + 10 for x in it], _FakeRDD([[1, 2], [3]]))
    assert sorted(result.collect()) == [11, 12, 13]
    assert sc.parallelize_calls == []


# --- Engine defaults --------------------------------------------------------


class _ListEngine(tengine.Engine):
    """The base class's defaults over an in-process ``run_job``."""

    num_executors = 1

    def __init__(self):
        self.jobs = []

    def run_job(self, mapfn, partitions, collect=False):
        self.jobs.append(len(partitions))
        out = [x for p in partitions for x in mapfn(iter(p))]
        return out if collect else None


def test_engine_defaults_have_no_native_dataset():
    eng = _ListEngine()
    assert not eng.is_native_dataset(_FakeRDD([[1]]))
    with pytest.raises(NotImplementedError, match="no native dataset"):
        eng.run_data_job(list, _FakeRDD([[1]]))
    with pytest.raises(NotImplementedError, match="no native dataset"):
        eng.map_partitions_native(list, _FakeRDD([[1]]))
    assert eng.num_active_jobs() == 0
    lazy = eng.run_job_lazy(lambda it: [x * 3 for x in it], [[1, 2], [3]])
    assert eng.jobs == []  # nothing runs until the consumer advances
    assert list(lazy) == [[3, 6], [9]] and eng.jobs == [1, 1]


def test_local_engine_has_no_native_dataset():
    eng = tengine.LocalEngine(1)
    try:
        assert not eng.is_native_dataset([[1]])
        assert eng.num_active_jobs() == 0
        gen = eng.run_job_lazy(_double_rows, [[1], [2]])
        assert next(gen) == [2]
        assert list(gen) == [[4]]
    finally:
        eng.stop()


def _double_rows(it):
    return [x * 2 for x in it]


# --- spark_io on a stub pyspark (tests/test_spark_io.py) -------------------


def _stub_pyspark(monkeypatch):
    """A minimal ``pyspark.sql.types`` so the schema mapping runs without
    Spark."""

    class _T:
        def __init__(self, name):
            self.name = name

        def __repr__(self):
            return self.name

        def __eq__(self, other):
            return isinstance(other, _T) and other.name == self.name

    class ArrayType(_T):
        def __init__(self, inner):
            super().__init__("array<{0}>".format(inner))

    class StructField:
        def __init__(self, name, dtype, nullable):
            self.name, self.dtype, self.nullable = name, dtype, nullable

    class StructType:
        def __init__(self, fields):
            self.fields = fields

        def fieldNames(self):
            return [f.name for f in self.fields]

    T = types.ModuleType("pyspark.sql.types")
    for n in ("Binary", "Boolean", "Double", "Float", "Integer", "Long",
              "String", "Short"):
        setattr(T, n + "Type", lambda n=n: _T(n.lower()))
    T.ArrayType, T.StructField, T.StructType = ArrayType, StructField, \
        StructType
    pyspark = types.ModuleType("pyspark")
    sql = types.ModuleType("pyspark.sql")
    sql.types = T
    pyspark.sql = sql
    monkeypatch.setitem(sys.modules, "pyspark", pyspark)
    monkeypatch.setitem(sys.modules, "pyspark.sql", sql)
    monkeypatch.setitem(sys.modules, "pyspark.sql.types", T)


def test_require_pyspark_error_matches_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyspark", None)
    msgs = []
    for mod in (jsio, tsio):
        with pytest.raises(ImportError, match="pyspark is required") as e:
            mod._require_pyspark()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _schema_repr(st):
    return [(f.name, repr(f.dtype), f.nullable) for f in st.fields]


@pytest.mark.parametrize("schema", [
    "struct<a:int,b:array<float>,c:string,d:long,e:binary>",
    [("x", "short"), ("y", "array<double>"), ("z", "boolean")],
])
def test_to_spark_schema_matches_jax(monkeypatch, schema):
    _stub_pyspark(monkeypatch)
    assert _schema_repr(tsio.to_spark_schema(schema)) == \
        _schema_repr(jsio.to_spark_schema(schema))


class _Spark:
    def createDataFrame(self, data, schema=None):
        return (data, None if schema is None else _schema_repr(schema))


def test_rows_to_dataframe_matches_jax(monkeypatch):
    _stub_pyspark(monkeypatch)
    for mod in (tsio, jsio):
        with pytest.raises(ValueError, match="zero rows"):
            mod.rows_to_dataframe(_Spark(), [])
    rows = [{"a": 1, "b": "x"}, {"a": 2}]
    for schema in (None, "struct<a:int,b:string>"):
        assert tsio.rows_to_dataframe(_Spark(), rows, schema) == \
            jsio.rows_to_dataframe(_Spark(), rows, schema)


class _Row(dict):
    def asDict(self):
        return dict(self)


class _DF:
    def __init__(self, rows):
        self._rows = rows

    def collect(self):
        return [_Row(r) for r in self._rows]


def test_loaded_df_provenance_and_save(monkeypatch, tmp_path):
    _stub_pyspark(monkeypatch)
    df = _DF([{"x": i, "v": [float(i), 0.5]} for i in range(5)])
    assert not tsio.is_loaded_df(df) and tsio.loaded_schema(df) is None
    schema = [("v", "array<float>"), ("x", "long")]
    tsio.mark_loaded_df(df, schema)
    assert tsio.is_loaded_df(df) and tsio.loaded_schema(df) == schema
    assert jsio.is_loaded_df(df)  # the mark is the same attribute
    for name, mod in (("j", jsio), ("t", tsio)):
        assert mod.save_df_as_tfrecords(df, str(tmp_path / name),
                                        num_shards=2) == 5
    for shard in ("part-r-00000", "part-r-00001"):
        assert (tmp_path / "t" / shard).read_bytes() == \
            (tmp_path / "j" / shard).read_bytes()


def test_load_tfrecords_df_matches_jax(monkeypatch, tmp_path):
    _stub_pyspark(monkeypatch)

    class Spark:
        def createDataFrame(self, data, schema=None):
            return _DF([dict(zip(schema.fieldNames(), r)) for r in data])

    path = str(tmp_path / "recs")
    tsio.save_df_as_tfrecords(_DF([{"x": i, "s": "r%d" % i}
                                   for i in range(4)]), path)
    got = tsio.load_tfrecords_df(Spark(), path)
    want = jsio.load_tfrecords_df(Spark(), path)
    assert [dict(r) for r in got.collect()] == \
        [dict(r) for r in want.collect()]
    assert tsio.loaded_schema(got) == jsio.loaded_schema(want) == \
        [("s", "string"), ("x", "long")]


# --- end to end: a SparkContext stand-in over LocalEngine executors ---------


def _run_stages(stages_bytes, iterator):
    """Run an RDD's stages over one partition on an executor."""
    it = iterator
    for kind, fn in cloudpickle.loads(stages_bytes):
        if kind == "mapPartitions":
            it = iter(fn(it) or [])
        elif kind == "map":
            it = map(fn, it)
        else:  # foreachPartition
            fn(it)
            return []
    return list(it)


class _EngineRDD:
    """An RDD whose partitions are computed on a LocalEngine's
    executors; ``log`` records every job it runs."""

    def __init__(self, sc, parts, stages=()):
        self._sc, self._parts, self._stages = sc, parts, tuple(stages)

    def _then(self, kind, fn):
        return _EngineRDD(self._sc, self._parts,
                          self._stages + ((kind, fn),))

    def mapPartitions(self, fn):
        return self._then("mapPartitions", fn)

    def map(self, fn):
        return self._then("map", fn)

    def _run(self, stages, collect):
        self._sc.jobs.append(len(self._parts))
        return self._sc.engine.run_job(
            functools.partial(_run_stages, cloudpickle.dumps(stages)),
            self._parts, collect=collect)

    def collect(self):
        return self._run(self._stages, True)

    def foreachPartition(self, fn):
        self._run(self._stages + (("foreachPartition", fn),), False)


class _EngineSC:
    """A ``SparkContext`` stand-in: RDD jobs run on ``engine``."""

    def __init__(self, engine):
        self.engine = engine
        self.jobs = []
        self.parallelized = []

    def getConf(self):
        return _FakeConf({"spark.executor.instances":
                          str(self.engine.num_executors)})

    def parallelize(self, data, num_slices):
        self.parallelized.append(list(data))
        return _EngineRDD(self, [[d] for d in data])

    def statusTracker(self):
        return _FakeStatusTracker()

    def rdd(self, parts):
        return _EngineRDD(self, [list(p) for p in parts])


class _FakeDStream:
    def __init__(self, rdds):
        self._rdds = rdds

    def foreachRDD(self, fn):
        for rdd in self._rdds:
            fn(rdd)


def _count_fn(args, ctx):
    """Consume the feed; write how many rows came, their sum and the
    first row (``args`` is a dict, or the pipeline's Namespace)."""
    feed = ctx.get_data_feed()
    rows = []
    while not feed.should_stop():
        rows.extend(feed.next_batch(16))
    with open(args.out if hasattr(args, "out") else args["out"], "w") as f:
        json.dump({"rows": len(rows), "first": repr(_plain(rows[:1])),
                   "sum": _total(rows)}, f)


def _total(x):
    if isinstance(x, (list, tuple, np.ndarray)):
        return sum(_total(v) for v in x)
    return float(x)


def _plain(x):
    """A row with numpy values as Python ones (tuples stay tuples)."""
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    if isinstance(x, (list, np.ndarray)):
        return [_plain(v) for v in x]
    return x.item() if isinstance(x, np.generic) else x


def _square_fn(args, ctx):
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(10)
        if batch:
            feed.batch_results([x * x for x in batch])


@pytest.fixture()
def spark_sc():
    eng = tengine.LocalEngine(1, deterministic=True)
    yield _EngineSC(eng)
    eng.stop()


def test_cluster_feeds_native_rdds_in_place(spark_sc, tmp_path, caplog):
    caplog.set_level(logging.INFO, logger=cluster.__name__)
    out = str(tmp_path / "count.json")
    c = cluster.run(spark_sc, _count_fn, {"out": out}, elastic=True,
                    heartbeat_interval=0.5, **BOUNDS)
    assert isinstance(c.engine, tengine.SparkEngine)
    assert c.engine.sc is spark_sc
    starts = list(spark_sc.parallelized)  # the start job's executor ids
    c.train(spark_sc.rdd([[1, 2, 3], [4, 5]]), num_epochs=2,
            feed_timeout=60)
    assert c.train_stream([spark_sc.rdd([[10]]), spark_sc.rdd([[20, 30]])],
                          feed_timeout=60) == 2
    c.train_dstream(_FakeDStream([spark_sc.rdd([[40], [50]])]),
                    feed_timeout=60)
    c.shutdown(grace_secs=0, timeout=120)
    # only the start job went through parallelize: no fed row did
    assert spark_sc.parallelized == starts
    assert [len(p) for p in starts] == [1]
    with open(out) as f:
        got = json.load(f)
    assert got["rows"] == 2 * 5 + 3 + 2
    assert got["sum"] == 2 * 15 + 60 + 90
    assert "no partition requeue" in caplog.text


def test_cluster_inference_on_a_native_rdd_is_lazy(spark_sc):
    c = cluster.run(spark_sc, _square_fn, None, **BOUNDS)
    try:
        rdd = spark_sc.rdd([[1, 2, 3], [4], [5, 6]])
        jobs = len(spark_sc.jobs)
        lazy = c.inference(rdd, feed_timeout=60, lazy=True)
        assert len(spark_sc.jobs) == jobs  # nothing ran yet
        assert lazy.collect() == [1, 4, 9, 16, 25, 36]
        assert c.inference(rdd, feed_timeout=60) == [1, 4, 9, 16, 25, 36]
    finally:
        c.shutdown(grace_secs=0, timeout=120)


class _PysparkDataFrame:
    """A DataFrame stand-in whose type the pipeline takes for pyspark's."""

    def __init__(self, sc, parts):
        self._sc, self._parts = sc, parts
        self.selected = None

    def select(self, *cols):
        self.selected = cols
        return _PysparkDataFrame(self._sc, [
            [{c: r[c] for c in cols} for r in p] for p in self._parts])

    @property
    def rdd(self):
        return self._sc.rdd([[_SparkRow(r) for r in p] for p in self._parts])


class _SparkRow(tuple):
    """A pyspark ``Row`` stand-in: a tuple of the values, with
    ``asDict``."""

    def __new__(cls, d):
        row = tuple.__new__(cls, d.values())
        row._d = dict(d)
        return row

    def __reduce__(self):
        return _SparkRow, (self._d,)

    def asDict(self, recursive=False):
        return dict(self._d)


_PysparkDataFrame.__module__ = "pyspark.sql.dataframe"


def test_estimator_fit_feeds_a_dataframe_in_place(spark_sc, tmp_path):
    from tensorflowonspark_tpu_torch.pipeline import TFEstimator, TFModel

    out = str(tmp_path / "count.json")
    df = _PysparkDataFrame(spark_sc, [
        [{"b": [1, 2], "a": 3, "unused": "x"}] * 3,
        [{"b": [4, 5], "a": 6, "unused": "y"}] * 2])
    model = (TFEstimator(_count_fn, {"out": out}, engine=spark_sc)
             .setInputMapping({"b": "bee", "a": "ay"}).setGraceSecs(0)
             .setFeedTimeout(60).setReservationTimeout(60).fit(df))
    assert isinstance(model, TFModel)
    assert df.selected == ("a", "b")  # sorted input columns
    assert spark_sc.parallelized == [[("rows", [0])]]  # the start job only
    with open(out) as f:
        got = json.load(f)
    assert got["rows"] == 5
    assert got["first"] == repr([(3, [1, 2])])  # sorted-column tuples
    assert got["sum"] == 3 * (3 + 3) + 2 * (6 + 9)
