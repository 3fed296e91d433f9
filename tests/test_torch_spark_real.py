"""The port's ``SparkEngine`` against REAL pyspark executors
(``local-cluster[2,1,1024]``: two executor JVMs, each with its own Python
worker), as the reference's ``tests/test_spark_real.py`` runs the JAX
package's.

Gated: ``pyspark`` is not installed here nor on the GPU machine, so the
module skips; run it with ``pytest -m spark`` where ``pyspark`` is.
"""

import os
import sys

import pytest

pyspark = pytest.importorskip("pyspark")

pytestmark = pytest.mark.spark


@pytest.fixture(scope="module")
def sc():
    from pyspark import SparkConf, SparkContext

    # the executors' Python workers and the compute processes they spawn
    # import the package and this module by name
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [os.environ.get("PYTHONPATH", "")]
    ).strip(os.pathsep)
    conf = (
        SparkConf()
        .setMaster("local-cluster[2,1,1024]")
        .setAppName("tfos-torch-spark-e2e")
        .set("spark.executor.instances", "2")
        .set("spark.cores.max", "2")
        .set("spark.executor.memory", "1g")
        .set("spark.python.worker.reuse", "true")
    )
    context = SparkContext(conf=conf)
    yield context
    context.stop()


def _square_fn(args, ctx):
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(10)
        if batch:
            feed.batch_results([x * x for x in batch])


def _consume_fn(args, ctx):
    feed = ctx.get_data_feed(train_mode=True)
    total = 0
    while not feed.should_stop():
        total += len(feed.next_batch(16))
    ctx.mgr.set("consumed", total)


def _rows(n):
    return list(range(n))


def test_spark_engine_runs_jobs(sc):
    import functools

    from tensorflowonspark_tpu_torch.engine import SparkEngine

    eng = SparkEngine(sc)
    assert eng.num_executors == 2
    assert eng.run_job(sum_rows, [[1, 2], [3]], collect=True) == [3, 3]
    assert eng.run_job(sum_rows, [functools.partial(_rows, 4)],
                       collect=True) == [6]
    assert eng.is_native_dataset(sc.parallelize([1], 1))


def sum_rows(it):
    return [sum(it)]


def test_cluster_inference_on_spark_is_lazy(sc):
    from tensorflowonspark_tpu_torch.cluster import cluster

    c = cluster.run(sc, _square_fn, {}, num_executors=2,
                    reservation_timeout=120)
    try:
        rdd = sc.parallelize(list(range(100)), 4)
        result = c.inference(rdd, feed_timeout=120, lazy=True)
        assert sorted(result.collect()) == [x * x for x in range(100)]
    finally:
        c.shutdown(grace_secs=2, timeout=120)


def test_cluster_train_feeds_rdds_in_place_on_spark(sc):
    from tensorflowonspark_tpu_torch.cluster import cluster

    c = cluster.run(sc, _consume_fn, {}, num_executors=2,
                    reservation_timeout=120)
    rdd = sc.parallelize([(float(i), float(2 * i)) for i in range(200)], 4)
    c.train(rdd, num_epochs=2, feed_timeout=120)
    c.train_stream([sc.parallelize(list(range(40)), 2)], feed_timeout=120)
    c.shutdown(grace_secs=2, timeout=120)


def test_estimator_fit_over_a_dataframe_on_spark(sc):
    from pyspark.sql import SparkSession

    from tensorflowonspark_tpu_torch.pipeline import TFEstimator, TFModel

    spark = SparkSession(sc)
    df = spark.createDataFrame([(float(i), i) for i in range(64)],
                               ["x", "y"])
    model = (TFEstimator(_consume_fn, {}, engine=sc).setClusterSize(2)
             .setInputMapping({"x": "x", "y": "y"}).setGraceSecs(2)
             .setFeedTimeout(120).setReservationTimeout(120).fit(df))
    assert isinstance(model, TFModel)
