"""The port's batch inference and streaming entry points on a two-executor
``LocalEngine`` on the CPU, held to the JAX package.

- ``TPUCluster.inference`` (eager and ``lazy=True``): the tiny
  Transformer scores ``uint16`` token rows in each node's compute
  process through ``prefetch_to_device(host_prefetch=True)`` with an
  int32 widening preprocess; every row's mean next-token cross-entropy
  comes back in row order within 1e-5 relative of the JAX model's (the
  same f32 forward in another summation order, as the trajectories of
  ``test_torch_train.py``).
- ``train_stream`` of two micro-batches, then ``train_dstream`` of a
  duck-typed stream with a third, give the same per-step losses as one
  ``train`` of their concatenation; a STOP on the reservation server
  ends both.
- ``parallel_run.run`` of two instances gives each the node context the
  JAX package's gives it.

The user fns are module-level (the engine pickles them by reference and
the spawned processes import this module), so JAX is imported only
inside the tests.  Every run is bounded by the 60 s reservation, feed
and shutdown timeouts.
"""

import json
import os

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch.cluster import cluster, parallel_run
from tensorflowonspark_tpu_torch.engine import Engine, LocalEngine

BOUNDS = dict(reservation_timeout=60)
FEED_TIMEOUT = 60
WIDEN = {"columns": ["tokens"], "dtype": "int32"}
N_ROWS, BATCH = 24, 4


# --- user fns (module-level: pickled by reference) ----------------------


def _score_fn(args, ctx):
    """Score the fed rows with the tiny Transformer: batches of 4 (the
    last padded) through ``prefetch_to_device`` on the CPU."""
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.data.feed import prefetch_to_device
    from tensorflowonspark_tpu_torch.models import transformer as ttr

    model = convert.params_from_flax(
        args["tree"], ttr.TransformerConfig(**args["config"]), device="cpu",
        param_dtype=torch.float32)
    feed = ctx.get_data_feed(train_mode=False,
                             input_mapping={"tokens": "tokens"})
    batches = prefetch_to_device(feed.batches(BATCH, pad_to_batch=True),
                                 size=2, sharding="cpu", preprocess=WIDEN,
                                 host_prefetch=True)
    with torch.no_grad():
        for batch, n in batches:
            tokens = batch["tokens"]
            assert tokens.dtype == torch.int32
            tokens = tokens.to(torch.int64)
            logits = model(tokens)[:, :-1]
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 tokens[:, 1:].reshape(-1), reduction="none")
            feed.batch_results(ce.view(len(tokens), -1).mean(1)[:n].tolist())


def _context_fn(args, ctx):
    return {"executor_id": ctx.executor_id, "job_name": ctx.job_name,
            "task_index": ctx.task_index, "cluster_spec": ctx.cluster_spec,
            "num_workers": ctx.num_workers, "pid": os.getpid()}


# --- fixtures and helpers ------------------------------------------------


@pytest.fixture(scope="module")
def engine():
    eng = LocalEngine(2, deterministic=True)
    yield eng
    eng.stop()


def _tiny():
    from test_torch_feed import TINY, tiny_tree

    return TINY, tiny_tree()


def _token_rows(seed=5):
    rng = np.random.default_rng(seed)
    from test_torch_feed import S, TINY

    return rng.integers(0, TINY["vocab_size"], (N_ROWS, S)).astype(np.uint16)


def _jax_scores(tree, config, tokens):
    """The JAX model's mean next-token cross-entropy of each row."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import transformer as jtr

    model = jtr.Transformer(jtr.TransformerConfig(**config))

    @jax.jit
    def scores(params, tok):
        logits = model.apply({"params": params}, tok)[:, :-1]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        nll = -jnp.take_along_axis(logp, tok[:, 1:, None], axis=-1)[..., 0]
        return nll.mean(1)

    return np.asarray(scores(tree, jnp.asarray(tokens, jnp.int32)))


# --- tests ----------------------------------------------------------------


def test_inference_scores_rows_like_jax(engine):
    config, tree = _tiny()
    tokens = _token_rows()
    want = _jax_scores(tree, config, tokens)
    rows = [(t,) for t in tokens]
    parts = [rows[:10], rows[10:]]  # 10 rows: the last batch is padded
    c = cluster.run(engine, _score_fn, {"tree": tree, "config": config},
                    num_executors=2, **BOUNDS)
    try:
        eager = c.inference(parts, feed_timeout=FEED_TIMEOUT)
        lazy = c.inference(parts, feed_timeout=FEED_TIMEOUT, lazy=True)
        assert not isinstance(lazy, list)
        lazy = list(lazy)
    finally:
        c.shutdown(timeout=60)
    assert [len(p) for p in lazy] == [10, 14]
    assert len(eager) == N_ROWS
    np.testing.assert_allclose(eager, want, rtol=1e-5)
    np.testing.assert_array_equal(sum(lazy, []), eager)
    assert len(set(np.round(want, 4))) == N_ROWS  # rows are distinct


def test_train_stream_and_dstream_equal_one_train(engine, tmp_path):
    from test_torch_cluster import _train_tiny_fn
    from test_torch_feed import B, TINY, tiny_tree, token_rows

    tree = tiny_tree()
    rows = token_rows(24)
    micro = [rows[:8], rows[8:16], rows[16:]]
    losses = {}
    for how in ("stream", "train"):
        args = {"tree": tree, "config": TINY, "batch_size": B,
                "out": str(tmp_path / (how + ".json"))}
        c = cluster.run(engine, _train_tiny_fn, args, num_executors=1,
                        **BOUNDS)
        try:
            if how == "stream":
                assert c.train_stream([[m] for m in micro[:2]],
                                      feed_timeout=FEED_TIMEOUT) == 2
                c.train_dstream(_FakeDStream([_FakeRDD(engine, [micro[2]])]),
                                feed_timeout=FEED_TIMEOUT)
            else:
                c.train([rows], feed_timeout=FEED_TIMEOUT)
        finally:
            c.shutdown(timeout=60)
        with open(args["out"]) as f:
            losses[how] = json.load(f)
    assert losses["stream"]["steps"] == losses["train"]["steps"] == 24 // B
    assert losses["stream"]["losses"] == losses["train"]["losses"]


class _FakeRDD(object):
    """A duck-typed micro-batch RDD: ``foreachPartition`` runs the feed
    function on the executors through the engine."""

    def __init__(self, engine, partitions):
        self.engine = engine
        self.partitions = partitions

    def foreachPartition(self, fn):
        self.engine.run_job(fn, self.partitions)


class _FakeDStream(object):
    """The ``foreachRDD`` contract of a stream, driven synchronously."""

    def __init__(self, rdds):
        self.rdds = rdds
        self.callback = None

    def foreachRDD(self, fn):
        self.callback = fn
        for rdd in self.rdds:
            fn(rdd)


class _StopServer(object):
    stop_requested = False


class _RecordingEngine(Engine):
    """Records its jobs; the ``Engine`` base answers the native-dataset
    questions (it has none)."""

    def __init__(self):
        self.jobs = []

    def run_job(self, fn, partitions, collect=False):
        self.jobs.append(partitions)


def test_streams_end_on_a_stop_request():
    eng, server = _RecordingEngine(), _StopServer()
    c = cluster.TPUCluster(eng, {"id": "x"}, [], server, None,
                           cluster.InputMode.SPARK, ["input"])

    def batches():
        yield [[1, 2]]
        server.stop_requested = True
        yield [[3]]

    assert c.train_stream(batches()) == 1
    assert eng.jobs == [[[1, 2]]]
    fed = []

    class _CountingRDD(object):
        def foreachPartition(self, fn):
            fed.append(fn)

    stream = _FakeDStream([_CountingRDD()])
    server.stop_requested = False
    c.train_dstream(stream)
    server.stop_requested = True
    stream.callback(_CountingRDD())  # skipped after the stop
    assert len(fed) == 1


def test_parallel_run_gives_each_instance_the_reference_context(engine):
    from tensorflowonspark_tpu.cluster import parallel_run as jparallel
    from tensorflowonspark_tpu.engine import LocalEngine as JLocalEngine

    got = parallel_run.run(engine, _context_fn, num_executors=2,
                           barrier_timeout=60)
    jeng = JLocalEngine(2)
    try:
        want = jparallel.run(jeng, _context_fn, num_executors=2,
                             barrier_timeout=60)
    finally:
        jeng.stop()
    assert len(got) == len(want) == 2
    assert len({r["pid"] for r in got}) == 2
    assert os.getpid() not in {r["pid"] for r in got}
    for r in got + want:
        r.pop("pid")
    key = lambda r: r["executor_id"]  # noqa: E731
    assert sorted(got, key=key) == sorted(want, key=key)
    with pytest.raises(TypeError, match="module-level"):
        parallel_run.run(engine, lambda a, c: None)
    with pytest.raises(ValueError, match="exceeds"):
        parallel_run.run(engine, _context_fn, num_executors=3)
