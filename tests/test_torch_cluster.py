"""The port's cluster plane on its ``LocalEngine`` and the CPU: the
SPARK round trip, the whole slice (``cluster.run`` -> ``TPUCluster.train``
-> ``SyncTrainer.train_on_feed`` in the compute process -> ``shutdown``)
held to the JAX package's ``train_on_feed``, a compute failure surfacing
in the driver with the executor's id, the global stop over ``gloo``
across two executors with uneven partitions, a TENSORFLOW-mode run, and
an exiting executor waiting for its compute process's slow teardown.

The user fns are module-level: the engine ships them with ``pickle``, by
reference, and the spawned processes import this module, so it imports
JAX only inside the tests.  Every run is bounded (reservation and feed
timeouts of 60 s or less, ``shutdown(timeout=60)``) so a hang fails one
test instead of stalling the suite.

Tolerance: the slice's per-step losses at rtol 1e-5, as in
``tests/test_torch_feed.py``.
"""

import atexit
import json
import os
import queue
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import optim
from tensorflowonspark_tpu_torch.cluster import cluster, manager
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.parallel import dp

BOUNDS = dict(reservation_timeout=60)
FEED_TIMEOUT = 60

# --- user fns (module-level: pickled by reference) ----------------------


def _square_fn(args, ctx):
    # the reference suite's _square_fn (tests/test_cluster.py)
    feed = ctx.get_data_feed(train_mode=False)
    while not feed.should_stop():
        batch = feed.next_batch(10)
        if batch:
            feed.batch_results([x * x for x in batch])


def _train_tiny_fn(args, ctx):
    """Train the tiny Transformer on the CPU from the feed; write the
    per-step losses, the step count and whether JAX was loaded."""
    import sys

    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer as ttr

    model = convert.params_from_flax(
        args["tree"], ttr.TransformerConfig(**args["config"]), device="cpu",
        param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model),
                             optim.sgd(0.05, momentum=0.9))
    state = trainer.create_state(dict(model.named_parameters()))
    losses = []
    state = trainer.train_on_feed(
        state, ctx.get_data_feed(), batch_size=args["batch_size"],
        columnar=True,
        metrics_callback=lambda step, m: losses.append(m["loss"].item()))
    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "flax", "tensorflowonspark_tpu"))
    with open(args["out"], "w") as f:
        json.dump({"losses": losses, "steps": int(state.step),
                   "pid": os.getpid(), "jax_loaded": jax_loaded}, f)


def _fail_fn(args, ctx):
    raise RuntimeError("injected failure before consuming")


def _linear_loss(params, batch, rng):
    x, y = batch
    pred = x @ params["weight"].T + params["bias"]
    return torch.mean((pred[:, 0] - y) ** 2)


def _global_stop_fn(args, ctx):
    """Two processes over gloo: each trains on its own node's feed until
    the first runs dry."""
    dist = ctx.initialize_distributed()
    model = torch.nn.Linear(4, 1)
    trainer = dp.SyncTrainer(_linear_loss, optim.sgd(0.1))
    state = trainer.create_state(dict(model.named_parameters()))
    state = trainer.train_on_feed(state, ctx.get_data_feed(), batch_size=4,
                                  columnar=True)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend(), "steps": int(state.step)}
    dist.destroy_process_group()
    with open(os.path.join(args, "rank%d.json" % out["rank"]), "w") as f:
        json.dump(out, f)


def _slow_exit_fn(args, ctx):
    """Consume the feed, then exit slowly, as a process tearing down
    CUDA and NCCL does; the file shows that the teardown ran to its
    end."""
    feed = ctx.get_data_feed()
    while not feed.should_stop():
        feed.next_batch(4)

    def slow_exit():
        time.sleep(2.0)
        open(os.path.join(args, "exited"), "w").close()

    atexit.register(slow_exit)


def _foreground_fn(args, ctx):
    with open(os.path.join(args, "fg-%d.json" % ctx.executor_id), "w") as f:
        json.dump({"pid": os.getpid(), "job": ctx.job_name,
                   "task": ctx.task_index,
                   "workers": ctx.num_workers}, f)


# --- tests ---------------------------------------------------------------


@pytest.fixture()
def engine(request):
    eng = LocalEngine(request.param if hasattr(request, "param") else 1,
                      deterministic=True)
    yield eng
    eng.stop()


def _outputs(c):
    """Everything in the nodes' output queues."""
    out = []
    for n in c.cluster_info:
        q = manager.connect(tuple(n["addr"]),
                            bytes.fromhex(n["authkey"])).get_queue("output")
        while True:
            try:
                out.extend(q.get(block=False).items)
            except queue.Empty:
                break
    return out


@pytest.mark.parametrize("engine", [2], indirect=True)
def test_inputmode_spark_roundtrip(engine):
    c = cluster.run(engine, _square_fn, num_executors=2,
                    input_mode=cluster.InputMode.SPARK, **BOUNDS)
    data = list(range(100))
    c.train([data[i::10] for i in range(10)], feed_timeout=FEED_TIMEOUT)
    assert sorted(_outputs(c)) == sorted(x * x for x in data)
    c.shutdown(grace_secs=1, timeout=60)


def test_slice_trains_tiny_transformer_like_jax(engine, tmp_path):
    from test_torch_feed import (B, PACKAGES, TINY, jax_train_on_feed,
                                 tiny_tree, token_rows)

    tree = tiny_tree()
    rows = token_rows(16)
    parts = [rows[:8], rows[8:]]
    args = {"tree": tree, "config": TINY, "batch_size": B,
            "out": str(tmp_path / "losses.json")}
    c = cluster.run(engine, _train_tiny_fn, args, num_executors=1, **BOUNDS)
    c.train(parts, num_epochs=2, feed_timeout=FEED_TIMEOUT)
    c.shutdown(timeout=60)
    with open(args["out"]) as f:
        got = json.load(f)
    assert got["pid"] != os.getpid()
    assert got["jax_loaded"] == []  # the compute process runs the port only
    # the reference over the same blocks in the same order, on a local
    # manager: one executor takes the partitions in order, epoch by epoch
    jm, jmarker = PACKAGES["jax"][0], PACKAGES["jax"][1]
    mgr, _ = jm.start(b"slice", ["input", "output", "error"])
    try:
        items = [jmarker.pack_columnar(p) for p in parts] * 2 + [None]
        want, _, steps = jax_train_on_feed(mgr, items, tree, batch_size=B,
                                           columnar=True)
    finally:
        mgr.shutdown()
    assert got["steps"] == steps == 16 // B * 2
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


def test_failure_during_feed_names_the_executor(engine):
    c = cluster.run(engine, _fail_fn, num_executors=1, **BOUNDS)
    with pytest.raises(RuntimeError, match="executor 0") as err:
        c.train([[1, 2, 3]] * 2, feed_timeout=FEED_TIMEOUT)
    assert "injected failure" in str(err.value)
    with pytest.raises(RuntimeError, match="injected failure"):
        c.shutdown(timeout=60)


@pytest.mark.parametrize("kw,item", [
    ({"num_ps": 1}, None),
    ({"eval_node": True}, None),
    ({"tensorboard": True, "log_dir": "logs"}, None),
    ({"plan": "auto"}, "the rest: the planner"),
], ids=["num_ps", "eval_node", "tensorboard", "plan"])
def test_run_refuses_unported_args(kw, item):
    """``plan`` is still refused (before any process starts: no engine
    needed).  The roles ported since are accepted and reach the
    reference's size check, which raises its own error for a fleet of no
    executors (the flows themselves are in
    ``tests/test_torch_cluster_roles.py``)."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            cluster.run(object(), _fail_fn, num_executors=1, **kw)
        return
    from tensorflowonspark_tpu.cluster import cluster as jcluster

    class _NoFleet(object):
        num_executors = 0
        num_executors_exact = True
        default_fs = "file://"

    with pytest.raises(ValueError) as want:
        jcluster.run(_NoFleet(), _fail_fn, num_executors=0, **kw)
    with pytest.raises(ValueError) as got:
        cluster.run(_NoFleet(), _fail_fn, num_executors=0, **kw)
    assert str(got.value) == str(want.value)


def test_profile_dir_knob_matches_the_reference(monkeypatch, tmp_path):
    """``run(profile_dir=, profile_steps=)`` reaches the compute process
    as the reference's environment does: the same variables give both
    packages' ``maybe_start_profile_from_env`` a capture into
    ``<dir>/<pid>`` for the same steps.  The port's writes a
    ``torch.profiler`` trace there once its steps ran out; a capture that
    cannot start raises in the port (the reference goes on without)."""
    import jax

    from tensorflowonspark_tpu import tensorboard as jtb
    from tensorflowonspark_tpu_torch import tensorboard as ttb

    assert (ttb.PROFILE_DIR_ENV, ttb.PROFILE_STEPS_ENV) \
        == (jtb.PROFILE_DIR_ENV, jtb.PROFILE_STEPS_ENV)
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d, **kw: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    for mod in (ttb, jtb):
        monkeypatch.delenv(mod.PROFILE_DIR_ENV, raising=False)
        assert mod.maybe_start_profile_from_env() is None
    monkeypatch.setenv(ttb.PROFILE_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(ttb.PROFILE_STEPS_ENV, "2")
    want = jtb.maybe_start_profile_from_env()
    got = ttb.maybe_start_profile_from_env()
    assert got.log_dir == want.log_dir == os.path.join(str(tmp_path),
                                                       str(os.getpid()))
    assert got.remaining == want.remaining == 2
    want.stop()
    # one capture at a time: a second start while this one lives
    with pytest.raises(RuntimeError, match="did not start"):
        ttb.maybe_start_profile_from_env()
    ttb.profile_step(1)
    assert got.trace_path is None
    ttb.profile_step(1)  # its steps ran out: the trace is written
    assert os.path.dirname(got.trace_path) == got.log_dir
    assert got.trace_path.endswith(".pt.trace.json")


def test_profile_dir_stays_with_its_cluster(engine, tmp_path):
    """C9: the reference's ``run`` writes ``TFOS_PROFILE_DIR`` into the
    driver's environment for good (``cluster/cluster.py:1304-1311``), so
    every later cluster profiles too.  The port hands it to that
    cluster's compute processes only: a second cluster on the same
    driver and engine, without ``profile_dir``, captures nothing."""
    import fleet_workers

    prof = tmp_path / "prof"
    outs = [tmp_path / "run1", tmp_path / "run2"]
    rows = [[float(i) for i in range(8)]] * 2
    for out, kw in zip(outs, ({"profile_dir": str(prof),
                               "profile_steps": 2}, {})):
        out.mkdir()
        c = cluster.run(engine, fleet_workers.port_straggler_fn,
                        {"out": str(out)}, num_executors=1, **kw, **BOUNDS)
        c.train(rows, feed_timeout=FEED_TIMEOUT)
        c.shutdown(timeout=60)
        assert "TFOS_PROFILE_DIR" not in os.environ
    first, second = [json.load(open(out / "0.json")) for out in outs]
    assert first["profile_env"] == str(prof)
    assert second["profile_env"] is None
    assert os.listdir(prof) == [str(first["pid"])]
    (trace,) = os.listdir(prof / str(first["pid"]))
    assert trace.endswith(".pt.trace.json")
    with open(prof / str(first["pid"]) / trace) as f:
        events = json.load(f)["traceEvents"]
    assert events


def test_run_refuses_a_closure():
    with pytest.raises(TypeError, match="module-level"):
        cluster.run(object(), lambda args, ctx: None, num_executors=1)


def test_unported_cluster_surface_raises():
    """What of the cluster surface is still not ported: meshes and
    placement over several GPUs (``inference``, ``train_stream``,
    ``train_dstream``, ``prefetch_to_device`` and ``TFOS_SHM_FEED`` are
    held to the JAX package in ``test_torch_inference.py``,
    ``test_torch_preprocess.py`` and ``test_torch_shm_ring.py``)."""
    from tensorflowonspark_tpu_torch.cluster import node
    from tensorflowonspark_tpu_torch.data import feed

    with pytest.raises(NotImplementedError, match="multi-GPU DP"):
        node.NodeContext().mesh()
    with pytest.raises(NotImplementedError, match="multi-GPU DP"):
        feed.prefetch_to_device(iter([]), sharding=[torch.device("cpu")] * 2)


@pytest.mark.parametrize("engine", [2], indirect=True)
def test_global_stop_over_gloo_with_uneven_partitions(engine, tmp_path):
    rng = np.random.default_rng(0)

    def rows(n):
        return [(rng.standard_normal(4).astype(np.float32),
                 np.float32(rng.standard_normal())) for _ in range(n)]

    c = cluster.run(engine, _global_stop_fn, str(tmp_path), num_executors=2,
                    **BOUNDS)
    # deterministic routing: executor 0 gets 5 batches, executor 1 gets 3
    c.train([rows(20), rows(12)], feed_timeout=FEED_TIMEOUT)
    c.shutdown(timeout=60)
    out = [json.load(open(tmp_path / "rank{0}.json".format(r)))
           for r in range(2)]
    assert [o["world"] for o in out] == [2, 2]
    assert {o["backend"] for o in out} == {"gloo"}
    assert [o["steps"] for o in out] == [3, 3]


@pytest.mark.parametrize("engine", [2], indirect=True)
def test_inputmode_tensorflow_runs_in_the_foreground(engine, tmp_path):
    c = cluster.run(engine, _foreground_fn, str(tmp_path), num_executors=2,
                    master_node="chief",
                    input_mode=cluster.InputMode.TENSORFLOW, **BOUNDS)
    c.shutdown(timeout=60)
    out = [json.load(open(tmp_path / "fg-{0}.json".format(e)))
           for e in range(2)]
    assert [(o["job"], o["task"]) for o in out] == [("chief", 0),
                                                    ("worker", 0)]
    assert all(o["workers"] == 2 for o in out)
    assert len({o["pid"] for o in out} | {os.getpid()}) == 3


def test_feeder_packs_columns_unless_disabled(monkeypatch):
    from tensorflowonspark_tpu_torch.cluster import marker, node

    rows = [(np.float32(i), i) for i in range(4)]
    assert type(node._pack(rows)) is marker.ColumnarBlock
    assert type(node._pack([(1,), ("a",)])) is marker.Block  # mixed types
    monkeypatch.setenv("TFOS_COLUMNAR_FEED", "0")  # exact Python row types
    blk = node._pack(rows)
    assert type(blk) is marker.Block and blk.items == rows


def test_executor_exit_awaits_the_compute_process(engine, tmp_path):
    # a short heartbeat leaves well under 2 s between the compute
    # process's 'finished' and its executor's exit
    c = cluster.run(engine, _slow_exit_fn, str(tmp_path), num_executors=1,
                    heartbeat_interval=0.2, **BOUNDS)
    c.train([list(range(8))], feed_timeout=FEED_TIMEOUT)
    c.shutdown(timeout=60)
    engine.stop()
    assert (tmp_path / "exited").exists()


class _ClosingQueue(object):
    """An error-queue proxy whose first call fails the way a proxy
    connection closed by the GC mid-send fails; later calls see
    ``items``."""

    def __init__(self, items):
        self.items, self.calls, self.put_back = list(items), 0, []

    def get(self, block=True):
        self.calls += 1
        if self.calls == 1:
            raise TypeError("'NoneType' object cannot be interpreted as an "
                            "integer")
        if not self.items:
            raise queue.Empty
        return self.items.pop(0)

    def task_done(self):
        pass

    def put(self, item):
        self.put_back.append(item)


def test_error_queue_poll_survives_a_closed_connection():
    """The feeder's error-queue poll retries once on a fresh connection,
    as its queue puts do: an empty queue stays quiet, a posted error is
    raised naming the executor and put back."""
    from tensorflowonspark_tpu_torch.cluster import node

    empty = _ClosingQueue([])
    node._check_error_queue(None, empty, 0)
    assert empty.calls == 2
    posted = _ClosingQueue(["boom"])
    with pytest.raises(RuntimeError, match="executor 3 failed:\nboom"):
        node._check_error_queue(None, posted, 3)
    assert posted.put_back == ["boom"]
