"""The port's ML Pipeline API (``pipeline``) and the serving command line
(``serving.main``) against the JAX package's, on the CPU.

- Params, ``Namespace``, ``_to_partitions``, ``_infer_output_type`` and
  ``_py_value`` give what the reference's give on the same inputs.
- End to end: ``TFEstimator.fit`` over ``LocalEngine(1)`` trains the tiny
  Transformer from its feed (``tests/torch_dist_workers.py``'s
  module-level fn) and exports it with ``serving.infer_output_schema``;
  its losses must be within 1e-6 of a ``SyncTrainer`` stepped in this
  process on the same batches.  ``TFModel(schedule="continuous")
  .transform`` of that export must give the greedy tokens of the JAX
  package's ``load_predictor`` + ``predict_rows(continuous)`` on the same
  export, the schema must equal the reference's ``infer_output_schema``,
  and ``python -m tensorflowonspark_tpu_torch.serving`` must write the
  transform's tokens.
- ``_transform_native`` on the reference's duck-typed lazy DataFrame:
  laziness, the order of schema sources and the one-row probe.
- ``setTenantCol``, ``telemetrySnapshot`` and ``traceEvents`` behave as
  the reference's; what the pipeline does not port raises
  ``NotImplementedError`` naming its ROADMAP item.

Greedy tokens are compared exactly (both decodes in f32, the JAX package
through its ``gather`` paged decode), as ``tests/test_torch_serving_export.py``
compares them.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tensorflowonspark_tpu import pipeline as jpl  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu_torch import checkpoint as ckpt  # noqa: E402
from tensorflowonspark_tpu_torch import convert, serving  # noqa: E402
from tensorflowonspark_tpu_torch import pipeline as tpl  # noqa: E402
from tensorflowonspark_tpu_torch.data import interchange  # noqa: E402
from tensorflowonspark_tpu_torch.data import spark_io  # noqa: E402
from tensorflowonspark_tpu_torch.models import transformer as ttr  # noqa: E402

import torch_dist_workers as workers  # noqa: E402

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, SEQ = 4, 2, 64
LOSS_RTOL = 1e-6
MAPPING = {"prompt": "tokens"}
SLOTS = 3


def _jax_builder(params, config):
    """The JAX package's builder on the port's CPU export: its gather
    decode, and without the port's ``device`` knob."""
    config = {k: v for k, v in config.items() if k != "device"}
    return jtr.serving_builder(params, dict(config, paged_impl="gather"))


def _jax_static_builder(params, config):
    """The JAX package's builder for its static schedule (which needs the
    contiguous KV cache) on the same weights and knobs."""
    config = {k: v for k, v in config.items() if k != "device"}
    return jtr.serving_builder(params, dict(config, kv_layout="contiguous"))


def _prompts(n=7, seed=4):
    rng = np.random.RandomState(seed)
    return [{"prompt": rng.randint(0, 256, (int(m),)).astype(np.int32)}
            for m in rng.randint(1, 41, (n,))]


def _tokens(rows):
    return [np.asarray(r["generated"]).tolist() for r in rows]


# --- params and helpers against the reference --------------------------------


def test_namespace_matches_jax():
    src = argparse.Namespace(x=10)
    for mod in (jpl, tpl):
        n = mod.Namespace({"a": 1, "b": 2}, c=3)
        assert (n.a, n.b, n.c) == (1, 2, 3)
        assert "a" in n and "z" not in n and sorted(n) == ["a", "b", "c"]
        assert mod.Namespace(src) == mod.Namespace({"x": 10})
        with pytest.raises(ValueError):
            mod.Namespace(42)
    assert repr(tpl.Namespace({"q": 1})) == repr(jpl.Namespace({"q": 1}))


def _fn(args, ctx):
    """A module-level train fn (never run)."""


def _set(obj):
    return (obj.setEpochs(3).setBatchSize(16).setClusterSize(2)
            .setInputMapping({"b": "y", "a": "x"}).setGraceSecs(1)
            .setProtocol("dcn").setPreprocess({"dtype": "float32"}))


def test_estimator_params_merge_like_jax():
    got = _set(tpl.TFEstimator(_fn, {"base": 1, "epochs": 99}))
    want = _set(jpl.TFEstimator(_fn, {"base": 1, "epochs": 99}))
    assert got.getEpochs() == 3 and got.getBatchSize() == 16
    assert vars(got.merge_args_params()) == vars(want.merge_args_params())
    args = got.merge_args_params()
    assert args.epochs == 3 and args.base == 1
    assert args.num_ps == 0 and args.reservation_timeout == 600
    assert got.args.epochs == 99  # the source args are not mutated


def test_model_params_merge_like_jax():
    def chain(m):
        return (m.setSchedule("continuous").setModelConfig({"device": "cpu"})
                .setOnError("record").setOutputMapping({"generated": "g"}))

    got, want = chain(tpl.TFModel({})), chain(jpl.TFModel({}))
    assert tpl.TFModel({}).getSchedule() == "static"
    assert vars(got.merge_args_params()) == vars(want.merge_args_params())
    model = tpl.TFEstimator(_fn)._copy_params(tpl.TFModel())
    assert model._paramMap == {}
    assert [n for n in dir(tpl.TFModel) if n.startswith(("get", "set"))] \
        == [n for n in dir(jpl.TFModel) if n.startswith(("get", "set"))]
    assert [n for n in dir(tpl.TFEstimator) if n.startswith(("get", "set"))] \
        == [n for n in dir(jpl.TFEstimator) if n.startswith(("get", "set"))]
    assert tpl.TPUEstimator is tpl.TFEstimator and tpl.TPUModel is tpl.TFModel


PARTITION_CASES = {
    "flat_dicts": ([{"a": i, "b": -i} for i in range(7)], 3, None),
    "flat_selected": ([{"b": i, "a": -i, "c": 0} for i in range(5)], 2,
                      ["a", "b"]),
    "partitioned": ([[{"a": 1}], [], [{"a": 2}, {"a": 3}]], 5, None),
    "empty_first": ([[], [(1, 2)]], 2, None),
    "list_rows": ([[1, 2], [3, 4], [5, 6]], 2, None),
    "scalars": (list(range(5)), 8, None),
    "empty": ([], 3, None),
    "tuples_selected": ([(1, 2), (3, 4)], 1, ["x"]),
}


@pytest.mark.parametrize("name", sorted(PARTITION_CASES))
def test_to_partitions_matches_jax(name):
    rows, n, columns = PARTITION_CASES[name]
    assert tpl._to_partitions(rows, n, columns) == \
        jpl._to_partitions(rows, n, columns)
    assert tpl._looks_partitioned(rows) == jpl._looks_partitioned(rows)


def test_partitions_wrapper_matches_jax():
    parts = [[[1, 2]], [[3, 4], [5, 6]]]
    assert tpl._to_partitions(tpl.Partitions(parts), 9) == \
        jpl._to_partitions(jpl.Partitions(parts), 9) == parts


OUTPUT_VALUES = [
    np.float32(1.5), np.float64(2.5), np.int32(3), np.int64(4),
    np.bool_(True), np.arange(3, dtype=np.int32),
    np.zeros((2, 2), np.float32), np.arange(2, dtype=np.uint64),
    np.array(["x", "y"]), "text", 7, 0.25, [1, 2],
]


@pytest.mark.parametrize("i", range(len(OUTPUT_VALUES)))
def test_output_types_and_values_match_jax(i):
    v = OUTPUT_VALUES[i]
    assert tpl._infer_output_type(v) == jpl._infer_output_type(v)
    got, want = tpl._py_value(v), jpl._py_value(v)
    assert got == want and type(got) is type(want)


# --- once refused, now ported --------------------------------------------


class _RunCalled(Exception):
    pass


@pytest.mark.parametrize("call,key,value", [
    (lambda pl: pl.TFEstimator(_fn, {"num_ps": 1}).fit([]), "num_ps", 1),
    (lambda pl: pl.TFEstimator(_fn).setNumPS(1).fit([]), "num_ps", 1),
    (lambda pl: pl.TFEstimator(_fn).setTensorboard(True).fit([]),
     "tensorboard", True),
    (lambda pl: pl.TFEstimator(_fn).setModelDir("/logs").fit([]),
     "log_dir", "/logs"),
], ids=["num_ps_arg", "num_ps", "tensorboard", "model_dir"])
def test_pipeline_refuses_what_is_not_ported(call, key, value, monkeypatch):
    """Once refused, now ported (the parameter server and TensorBoard):
    ``fit`` hands ``cluster.run`` the same arguments as the JAX
    package's, the knob's value among them.  ``cluster.run`` is replaced
    by a recorder that stops the fit before any process starts; the
    roles themselves run in ``tests/test_torch_cluster_roles.py``."""
    from tensorflowonspark_tpu.cluster import cluster as jcluster
    from tensorflowonspark_tpu_torch.cluster import cluster as tcluster

    seen = {}

    def recorder(name):
        def run(engine, map_fun, args=None, **kw):
            seen[name] = kw
            raise _RunCalled()
        return run

    monkeypatch.setattr(jcluster, "run", recorder("jax"))
    monkeypatch.setattr(tcluster, "run", recorder("torch"))
    for name, pl in (("jax", jpl), ("torch", tpl)):
        with pytest.raises(_RunCalled):
            call(pl)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][key] == value


def _served_model_args(pkg, export, tenant_col):
    return (pkg.TFModel().setExportDir(export).setInputMapping(MAPPING)
            .setSchedule("continuous").setBatchSize(SLOTS)
            .setOnError("record").setTenantCol(tenant_col)
            .merge_args_params())


@pytest.mark.parametrize("case", ["setTenantCol", "telemetrySnapshot",
                                  "traceEvents", "tenant_col_arg"])
def test_pipeline_telemetry_matches_jax(case, request):
    """Once refused: ``setTenantCol``, ``TFModel.telemetrySnapshot`` and
    ``traceEvents`` behave as the JAX package's.  ``tenant_col_arg``
    serves an export with the tenant column through both packages'
    executor-side ``_run_model``: the same tokens, the same
    ``bad_tenant`` record, and the same per-tenant ledger tokens."""
    from tensorflowonspark_tpu import telemetry as jtel
    from tensorflowonspark_tpu_torch import telemetry as ttel

    if case == "setTenantCol":
        got, want = (pkg.TFModel().setTenantCol("who") for pkg in (tpl, jpl))
        assert got.getTenantCol() == want.getTenantCol() == "who"
        assert (got.merge_args_params().tenant_col
                == want.merge_args_params().tenant_col)
    elif case == "telemetrySnapshot":
        got, want = (pkg.TFModel().telemetrySnapshot() for pkg in (tpl, jpl))
        assert sorted(got) == sorted(want) == ["counters", "gauges",
                                               "histograms"]
        json.dumps(got)
    elif case == "traceEvents":
        got, want = (pkg.TFModel().traceEvents() for pkg in (tpl, jpl))
        assert sorted(got) == sorted(want)
        assert isinstance(got["traceEvents"], list)
        json.dumps(got)
    else:
        fitted = request.getfixturevalue("fitted")
        rows = [dict(r, who="ab"[i % 2]) for i, r in enumerate(_prompts(6))]
        rows[3]["who"] = ""
        res = []
        for pkg, tel, builder in ((tpl, ttel, None),
                                  (jpl, jtel, _jax_builder)):
            base = tel.get_ledger().snapshot()
            out = pkg._run_model([dict(r) for r in rows],
                                 _served_model_args(pkg, fitted["export"],
                                                    "who"),
                                 predictor_builder=builder)
            delta = tel.ledger.snapshot_delta(tel.get_ledger().snapshot(),
                                              base)["tenants"]
            res.append((out, {t: (v["tokens_in"], v["tokens_out"])
                              for t, v in delta.items()}))
        (got, gl), (want, wl) = res
        assert [r.get("error") for r in got] == [r.get("error")
                                                 for r in want]
        assert got[3]["error"]["kind"] == "bad_tenant"
        ok = [i for i, r in enumerate(want) if "error" not in r]
        assert _tokens([got[i] for i in ok]) == _tokens([want[i]
                                                         for i in ok])
        assert gl == wl and set(gl) >= {"a", "b"}


def test_model_requires_export_dir_and_mapping():
    m = tpl.TFModel({})
    with pytest.raises(ValueError, match="export_dir"):
        m.transform([{"x": 1}])
    m.setExportDir("/tmp/nope")
    with pytest.raises(ValueError, match="input_mapping"):
        m.transform([{"x": 1}])


def test_estimator_export_fn_runs_on_one_node(tmp_path):
    """Two executors, module-level ``export_fn``: exactly one node (worker
    0) exports, and each node gets its partition of sorted-column
    tuples."""
    rows = [{"y": [i, -i], "x": i} for i in range(6)]
    est = (tpl.TFEstimator(workers.pipeline_count_fn, {"out": str(tmp_path)},
                           export_fn=workers.pipeline_export_fn)
           .setClusterSize(2).setInputMapping({"y": "y", "x": "x"})
           .setGraceSecs(0).setFeedTimeout(60).setReservationTimeout(60))
    est.fit(rows)
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.startswith("export")) == ["export-worker-0"]
    got = []
    for eid in (0, 1):
        with open(tmp_path / "rows-{0}.json".format(eid)) as f:
            got.append(sorted(json.load(f)))
    want = sorted(sorted([r["x"], r["y"]] for r in part)
                  for part in (rows[0::2], rows[1::2]))
    assert sorted(got) == want


# --- end to end --------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """``TFEstimator.fit`` of the tiny Transformer over ``LocalEngine(1)``:
    the model it returned, its export, its losses, the initial tree and
    the fed token batches."""
    tmp = tmp_path_factory.mktemp("pipeline")
    tree = convert.init_params_tree(
        ttr.TransformerConfig(**workers.CKPT_TINY), seed=0)
    tokens = np.random.default_rng(3).integers(
        0, 256, (STEPS, BATCH, SEQ)).astype(np.int32)
    rows = [{"tokens": t, "unused": i}
            for i, t in enumerate(tokens.reshape(-1, SEQ))]
    export = str(tmp / "export")
    losses_path = str(tmp / "losses.json")
    model = (tpl.TFEstimator(workers.pipeline_train_fn,
                             {"tree": tree, "losses": losses_path})
             .setInputMapping({"tokens": "tokens"}).setClusterSize(1)
             .setEpochs(1).setBatchSize(BATCH).setExportDir(export)
             .setGraceSecs(0).setFeedTimeout(60).setReservationTimeout(60)
             .fit(rows))
    with open(losses_path) as f:
        losses = json.load(f)
    return dict(model=model, export=export, losses=losses, tree=tree,
                tokens=tokens, tmp=tmp)


def test_fit_losses_match_stacked_training(fitted):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, trainer, state = workers.pipeline_model(fitted["tree"])
        want = []
        for batch in fitted["tokens"]:
            state, m = trainer.step(state, {"tokens": batch})
            want.append(float(m["loss"]))
    finally:
        torch.set_num_threads(threads)
    got = np.asarray(fitted["losses"])
    assert got.shape == (STEPS,)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert got[-1] != got[0]


@pytest.fixture(scope="module")
def jax_predict(fitted):
    return jserving.load_predictor(fitted["export"], builder=_jax_builder,
                                   use_cache=False)


@pytest.fixture(scope="module")
def transformed(fitted):
    model = fitted["model"]
    assert isinstance(model, tpl.TFModel)
    assert model.getExportDir() == fitted["export"]
    model.setInputMapping(MAPPING).setSchedule("continuous") \
        .setBatchSize(SLOTS)
    return model.transform([dict(r) for r in _prompts()])


def test_transform_tokens_equal_the_jax_package(fitted, transformed,
                                                jax_predict):
    want = _tokens(jserving.predict_rows(
        jax_predict, [dict(r) for r in _prompts()], MAPPING,
        batch_size=SLOTS, schedule="continuous"))
    assert len(transformed) == len(want)
    assert _tokens(transformed) == want
    # training moved the weights far enough to change what is served
    untrained = _tokens(serving.predict_rows(
        ttr.serving_builder(fitted["tree"], dict(
            workers.CKPT_TINY, **workers.PIPELINE_GEN, device="cpu")),
        _prompts(), MAPPING, batch_size=SLOTS, schedule="continuous"))
    assert untrained != want


def test_transform_at_the_default_schedule(fitted, transformed):
    """``TFModel.transform`` at its default schedule (static, once
    refused) serves the export: the continuous schedule's tokens."""
    model = (tpl.TFModel().setExportDir(fitted["export"])
             .setInputMapping(MAPPING).setBatchSize(SLOTS))
    assert model.getSchedule() == "static"
    got = model.transform([dict(r) for r in _prompts()])
    assert _tokens(got) == _tokens(transformed)


def test_output_schema_equals_the_reference(fitted):
    """Both packages derive the schema through their static schedule.  On
    the same export the schemas must be equal."""
    with open(os.path.join(fitted["export"], "metadata.json")) as f:
        meta = json.load(f)
    sample = {"prompt": np.arange(5, dtype=np.int32)}
    jax_static = jserving.load_predictor(
        fitted["export"], builder=_jax_static_builder, use_cache=False)
    want = jserving.infer_output_schema(jax_static, dict(sample), MAPPING)
    assert want == [("generated", "array<int>")]
    assert [tuple(f) for f in meta["output_schema"]] == want
    port = serving.load_predictor(fitted["export"], use_cache=False)
    assert serving.infer_output_schema(port, dict(sample), MAPPING) == want
    assert serving.infer_output_schema(
        port, dict(sample), MAPPING, {"generated": "g"}) == \
        jserving.infer_output_schema(jax_static, dict(sample), MAPPING,
                                     {"generated": "g"})


def test_serving_cli_writes_the_transform_tokens(fitted, transformed):
    tmp = fitted["tmp"]
    inp, out = str(tmp / "cli-in"), str(tmp / "cli-out")
    interchange.save_as_tfrecords(_prompts(), inp,
                                  "struct<prompt:array<int>>")
    env = dict(os.environ, PYTHONPATH=PKG_ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.serving",
         "--export_dir", fitted["export"], "--input", inp,
         "--input_mapping", "prompt=tokens", "--output", out,
         "--batch_size", str(SLOTS), "--schedule", "continuous"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "wrote 7 predictions" in proc.stderr
    with open(os.path.join(out, "part-00000.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["generated"] for r in lines] == _tokens(transformed)
    assert "jax" not in proc.stderr.lower()


def test_serving_cli_in_process_and_refusals(fitted, transformed, tmp_path):
    inp = str(tmp_path / "in")
    interchange.save_as_tfrecords(_prompts(), inp)  # schema inferred
    out = str(tmp_path / "out")
    argv = ["--export_dir", fitted["export"], "--input", inp,
            "--input_mapping", '{"prompt": "tokens"}', "--output", out,
            "--batch_size", str(SLOTS)]
    assert serving.main(argv + ["--schedule", "continuous",
                                "--output_mapping", "generated=g"]) == 7
    with open(os.path.join(out, "part-00000.jsonl")) as f:
        assert [json.loads(line)["g"] for line in f] == \
            _tokens(transformed)
    # the default schedule (static; once refused) serves the same tokens
    out2 = str(tmp_path / "out-static")
    argv2 = argv[:argv.index("--output")] + ["--output", out2] + \
        argv[argv.index("--output") + 2:]
    assert serving.main(argv2 + ["--schedule", "static"]) == 7
    with open(os.path.join(out2, "part-00000.jsonl")) as f:
        assert [json.loads(line)["generated"] for line in f] == \
            _tokens(transformed)
    for extra, item in ((["--replicas", "2"], "fleet"),
                        (["--tp", "2"], "TP")):
        with pytest.raises(NotImplementedError, match=item):
            serving.main(argv + extra + ["--schedule", "continuous"])
    # --disaggregate (once refused) splits prefill from decode and writes
    # the same tokens
    out4 = str(tmp_path / "out-disagg")
    argv4 = argv[:argv.index("--output")] + ["--output", out4] + \
        argv[argv.index("--output") + 2:]
    assert serving.main(argv4 + ["--disaggregate", "--schedule",
                                 "continuous"]) == 7
    with open(os.path.join(out4, "part-00000.jsonl")) as f:
        assert [json.loads(line)["generated"] for line in f] == \
            _tokens(transformed)
    # --checkpoint_dir (once refused) watches a root of published steps;
    # the export's own weights published there serve the same tokens
    # whether or not the swap lands during the job
    root = str(tmp_path / "steps")
    ckpt.publish_for_serving(root, 1, ckpt.load_for_serving(
        fitted["export"])[0])
    out3 = str(tmp_path / "out-swap")
    argv3 = argv[:argv.index("--output")] + ["--output", out3] + \
        argv[argv.index("--output") + 2:]
    assert serving.main(argv3 + ["--schedule", "continuous",
                                 "--checkpoint_dir", root,
                                 "--checkpoint_poll", "0.01"]) == 7
    with open(os.path.join(out3, "part-00000.jsonl")) as f:
        assert [json.loads(line)["generated"] for line in f] == \
            _tokens(transformed)
    assert serving._parse_mapping("a=b, c = d") == \
        jserving._parse_mapping("a=b, c = d") == {"a": "b", "c": "d"}
    with pytest.raises(ValueError, match="key=value"):
        serving._parse_mapping("a")
    for v in (np.arange(2), np.float32(1.5), np.int64(3), b"\xffx"):
        assert serving._json_default(v) == jserving._json_default(v)
    with pytest.raises(TypeError):
        serving._json_default(object())


# --- _transform_native on the reference's lazy fakes --------------------------


class _FakeRow(dict):
    def asDict(self, recursive=False):
        return dict(self)


class _LazyRDD:
    """Partitioned fake RDD recording which partitions were computed."""

    def __init__(self, parts, log, stages=()):
        self._parts, self._log, self._stages = parts, log, list(stages)

    def mapPartitions(self, fn):
        return _LazyRDD(self._parts, self._log,
                        self._stages + [("mapPartitions", fn)])

    def map(self, f):
        return _LazyRDD(self._parts, self._log, self._stages + [("map", f)])

    def _compute(self, idx):
        self._log.append(idx)
        rows = iter(self._parts[idx])
        for kind, f in self._stages:
            rows = f(rows) if kind == "mapPartitions" else map(f, rows)
        return list(rows)

    def take(self, n):
        out = []
        for i in range(len(self._parts)):
            out.extend(self._compute(i))
            if len(out) >= n:
                break
        return out[:n]

    def collect(self):
        return [r for i in range(len(self._parts)) for r in self._compute(i)]

    def getNumPartitions(self):
        return len(self._parts)


class _FakeDataFrame:
    def __init__(self, parts, log):
        self.rdd = _LazyRDD(parts, log)
        self.sparkSession = _FakeSession()

    def select(self, *cols):
        return self


class _FakeResultDF:
    def __init__(self, rdd, schema):
        self.rdd, self.schema = rdd, schema

    def collect(self):
        return self.rdd.collect()


class _FakeSession:
    def createDataFrame(self, rdd, schema=None):
        return _FakeResultDF(rdd, schema)


class _FakeNativeEngine:
    num_executors = 2

    def is_native_dataset(self, dataset):
        return isinstance(dataset, _FakeDataFrame)

    def map_partitions_native(self, fn, dataset):
        return dataset.rdd.mapPartitions(fn)


def _native_model(export, monkeypatch, extra_args=None):
    # to_spark_schema needs pyspark; the flow under test does not
    monkeypatch.setattr(spark_io, "to_spark_schema", lambda s: s)
    m = (tpl.TFModel(dict(extra_args or {})).setExportDir(export)
         .setInputMapping(MAPPING).setSchedule("continuous")
         .setBatchSize(SLOTS))
    m.engine = _FakeNativeEngine()
    return m


def _parts(n_parts=3, rows_per=2):
    prompts = _prompts(n_parts * rows_per, seed=11)
    return [[_FakeRow(prompt=p["prompt"]) for p in
             prompts[i * rows_per:(i + 1) * rows_per]]
            for i in range(n_parts)], prompts


def _want(predict, prompts, rows_per):
    """Each partition served on its own, as the executors serve them."""
    out = []
    for i in range(0, len(prompts), rows_per):
        out += _tokens(serving.predict_rows(
            predict, [dict(p) for p in prompts[i:i + rows_per]], MAPPING,
            batch_size=SLOTS, schedule="continuous"))
    return out


@pytest.fixture(scope="module")
def port_predict(fitted):
    return serving.load_predictor(fitted["export"], use_cache=False)


def test_transform_native_lazy_with_explicit_schema(monkeypatch, fitted,
                                                    port_predict):
    parts, prompts = _parts()
    log = []
    m = _native_model(fitted["export"], monkeypatch,
                      {"output_schema": "struct<generated:array<int>>"})
    out = m.transform(_FakeDataFrame(parts, log))
    assert log == [], "an explicit schema must not evaluate anything"
    assert out.schema == [("generated", "array<int>")]
    assert out.rdd.getNumPartitions() == len(parts)
    got = [r[0] for r in out.collect()]
    assert got == _want(port_predict, prompts, 2)
    assert sorted(log) == list(range(len(parts)))  # each computed once


def test_transform_native_schema_from_export_metadata(monkeypatch, fitted,
                                                      port_predict):
    parts, prompts = _parts(2, 3)
    log = []
    out = _native_model(fitted["export"], monkeypatch).transform(
        _FakeDataFrame(parts, log))
    assert log == []  # the export's output_schema: still no evaluation
    assert out.schema == [("generated", "array<int>")]
    assert [r[0] for r in out.collect()] == _want(port_predict, prompts, 3)


def test_transform_native_probe_evaluates_one_partition(monkeypatch, fitted,
                                                        tmp_path):
    legacy = str(tmp_path / "legacy")
    shutil.copytree(fitted["export"], legacy)
    meta_path = os.path.join(legacy, "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["output_schema"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    parts, _ = _parts(3, 2)
    log = []
    out = _native_model(legacy, monkeypatch).transform(
        _FakeDataFrame(parts, log))
    assert log == [0]  # the probe computed partition 0 only
    assert out.schema == [("generated", "array<int>")]


def test_transform_native_on_error_record(monkeypatch, fitted, port_predict):
    parts, prompts = _parts(1, 3)
    parts[0][1] = _FakeRow(prompt=np.arange(60, dtype=np.int32))  # too long
    schema = [("generated", "array<int>"), ("error", "string")]
    m = _native_model(fitted["export"], monkeypatch,
                      {"output_schema": schema})
    assert m.getOnError() == "raise"
    with pytest.raises(Exception, match="exceeds the engine cache_len"):
        m.transform(_FakeDataFrame(parts, [])).collect()
    got = m.setOnError("record").transform(_FakeDataFrame(parts, [])) \
        .collect()
    assert len(got) == 3
    want = _want(port_predict, [prompts[0], prompts[2]], 1)
    assert [got[0][0], got[2][0]] == want and got[0][1] is None
    assert got[1][0] is None and got[1][1]["kind"] == "too_long"
    assert got[1][1]["request_index"] == 1


def test_transform_native_static_schedule_serves(monkeypatch, fitted,
                                                 port_predict):
    """The static schedule (once refused) at ``TFModel``'s default: the
    same greedy tokens as the continuous schedule's."""
    parts, prompts = _parts(1, 3)
    m = _native_model(fitted["export"], monkeypatch,
                      {"output_schema": "struct<generated:array<int>>"})
    m.setSchedule("static")
    got = m.transform(_FakeDataFrame(parts, [])).collect()
    assert [r[0] for r in got] == _want(port_predict, prompts, 1)
