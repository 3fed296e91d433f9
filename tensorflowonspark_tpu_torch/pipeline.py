"""ML-Pipeline adapter: Estimator/Model over the cluster API (port of the
JAX package's ``pipeline.py``; original: tensorflowonspark/pipeline.py).

A Spark-ML-style :class:`TFEstimator` whose ``fit`` runs distributed
training through the cluster API (``cluster.run`` -> ``train`` ->
``shutdown``) and returns a :class:`TFModel` whose ``transform`` runs
batch inference on the executors with a predictor cached per executor
process.  Both carry the reference's ``Has*`` params with their get/set
accessors, and ``TFParams.merge_args_params`` lays the set params over
the user's args.

Datasets are a list of dict rows, a list of row partitions
(:class:`Partitions`), or a pyspark DataFrame (through :mod:`.data.
spark_io`, or fed in place when the engine takes it natively).  A
serving export names its predictor's builder in its metadata
(``model_ref``, see :mod:`.serving`).

Everything shipped to an executor is a module-level function or a
``functools.partial`` of one (the engine pickles by reference), so a
user ``train_fn``, ``export_fn`` or ``predictor_builder`` must be
module-level too.  ``setTenantCol`` maps a column onto the reserved
``tenant`` serving input (the usage ledger charges each row to it);
``TFModel.telemetrySnapshot`` and ``traceEvents`` read this process's
registry and tracer.  ``setCheckpointDir`` has each executor's
continuous engine watch a ``publish_for_serving`` root and hot-swap
validated new weights mid-transform (:mod:`.hot_swap`).
"""

import copy
import functools
import json
import logging
import os

logger = logging.getLogger(__name__)


class Namespace(object):
    """Dict/argparse-interchangeable attribute bag."""

    def __init__(self, d=None, **kwargs):
        if d is None:
            pass
        elif isinstance(d, dict):
            self.__dict__.update(d)
        elif hasattr(d, "__dict__"):
            self.__dict__.update(d.__dict__)
        else:
            raise ValueError(
                "Namespace expects a dict or an argparse Namespace, got "
                "{0!r}".format(type(d))
            )
        self.__dict__.update(kwargs)

    def __contains__(self, key):
        return key in self.__dict__

    def __iter__(self):
        return iter(self.__dict__)

    def __eq__(self, other):
        return isinstance(other, Namespace) and vars(self) == vars(other)

    def __repr__(self):
        return "Namespace({0})".format(self.__dict__)


# ----------------------------------------------------------------------
# params: a light stand-in for pyspark.ml.param, with the same accessors
# ----------------------------------------------------------------------


class Param(object):
    def __init__(self, name, doc, default=None):
        self.name = name
        self.doc = doc
        self.default = default


def _mixin(param_name, doc, default=None, cap=None):
    """A ``Has<Cap>`` mixin class with ``get<Cap>``/``set<Cap>``."""
    cap = cap or "".join(w.capitalize() for w in param_name.split("_"))
    param = Param(param_name, doc, default)

    def setter(self, value):
        self._paramMap[param_name] = value
        return self

    def getter(self):
        return self._paramMap.get(param_name, param.default)

    return type("Has" + cap, (object,), {
        param_name: param, "set" + cap: setter, "get" + cap: getter,
    })


HasBatchSize = _mixin("batch_size", "number of records per batch", 128)
HasClusterSize = _mixin("cluster_size", "number of nodes in the cluster", 1)
HasEpochs = _mixin("epochs", "number of epochs of training data", 1)
HasExportDir = _mixin("export_dir", "directory to export the serving model")
HasGraceSecs = _mixin(
    "grace_secs", "seconds to wait after feed end before shutdown", 30
)
HasInputMapping = _mixin(
    "input_mapping", "mapping of input columns to predictor inputs"
)
HasInputMode = _mixin(
    "input_mode", "input mode (InputMode.SPARK | InputMode.TENSORFLOW)"
)
HasMasterNode = _mixin(
    "master_node", "job name of the chief/master node", None
)
HasModelDir = _mixin("model_dir", "directory for checkpoints/events")
HasNumPS = _mixin("num_ps", "number of parameter-server nodes", 0, cap="NumPS")
HasOnError = _mixin(
    "on_error",
    "per-request inference failure policy: 'raise' fails the job "
    "naming the poisoned request; 'record' isolates it as a typed "
    "error record at its row position",
    "raise",
)
HasOutputMapping = _mixin(
    "output_mapping", "mapping of predictor outputs to output columns"
)
#: TFModel.transform's schedule: "continuous" is slot-level in-flight
#: batching for generation exports (batch_size then counts KV slots);
#: the reference's default "static" is not ported and raises
HasSchedule = _mixin(
    "schedule",
    "inference batching schedule: 'static' | 'continuous'",
    "static",
)
HasCheckpointDir = _mixin(
    "checkpoint_dir",
    "step-numbered serving-export root to watch for validated live "
    "weight hot-swaps during continuous-schedule transforms",
    cap="CheckpointDir",
)
#: deployment-time model_config overrides laid over the export metadata
#: before the predictor builds (serving.load_predictor config_overrides),
#: e.g. {"device": "cpu"}
HasModelConfig = _mixin(
    "model_config",
    "dict of model_config keys laid over the serving export's "
    "metadata at load time",
)
HasTenantCol = _mixin(
    "tenant_col",
    "input column carrying the per-request tenant key for the usage "
    "ledger (mapped to the reserved 'tenant' serving input)",
    cap="TenantCol",
)
#: a data.preprocess.make_preprocess kwargs dict: on TFModel it is fused
#: in front of the predictor on the device (serving.with_preprocess); on
#: TFEstimator it rides the merged args, so a train_fn can build
#: SyncTrainer(device_preprocess=args.preprocess)
HasPreprocess = _mixin(
    "preprocess",
    "on-device preprocess spec (data.preprocess.make_preprocess "
    "kwargs dict): cast/scale/normalize narrow wire dtypes on the "
    "device instead of on the host",
)
#: the reference's RPC fabric choice, kept as a placement hint
HasProtocol = _mixin(
    "protocol", "collective transport hint: 'ici' | 'dcn'", "ici"
)
HasReservationTimeout = _mixin(
    "reservation_timeout", "startup barrier timeout (secs)", 600
)
HasFeedTimeout = _mixin("feed_timeout", "data feed timeout (secs)", 600)
HasSignatureDefKey = _mixin(
    "signature_def_key", "serving signature selector in export metadata"
)
HasTagSet = _mixin("tag_set", "serving export variant tag", "serve")
HasTensorboard = _mixin(
    "tensorboard", "launch TensorBoard on chief/worker:0", False
)
HasTFRecordDir = _mixin(
    "tfrecord_dir", "directory of TFRecords to feed in TENSORFLOW mode",
    cap="TFRecordDir",
)


class TFParams(object):
    """Base of the param holders."""

    def __init__(self):
        self._paramMap = {}
        self.args = None

    def merge_args_params(self):
        """A copy of ``self.args`` with every set param laid over it and
        every unset param at its default."""
        args = (Namespace(copy.deepcopy(vars(self.args))) if self.args
                else Namespace())
        for name, value in self._paramMap.items():
            setattr(args, name, value)
        for klass in type(self).__mro__:
            for p in vars(klass).values():
                if isinstance(p, Param) and not hasattr(args, p.name):
                    setattr(args, p.name, p.default)
        return args

    def _copy_params(self, other):
        other._paramMap = dict(self._paramMap)
        other.args = self.args
        return other


_ESTIMATOR_MIXINS = (
    HasBatchSize,
    HasClusterSize,
    HasEpochs,
    HasExportDir,
    HasGraceSecs,
    HasInputMapping,
    HasInputMode,
    HasMasterNode,
    HasModelDir,
    HasNumPS,
    HasPreprocess,
    HasProtocol,
    HasReservationTimeout,
    HasFeedTimeout,
    HasTensorboard,
    HasTFRecordDir,
)

_MODEL_MIXINS = (
    HasBatchSize,
    HasCheckpointDir,
    HasExportDir,
    HasInputMapping,
    HasModelConfig,
    HasModelDir,
    HasOnError,
    HasOutputMapping,
    HasPreprocess,
    HasSchedule,
    HasSignatureDefKey,
    HasTagSet,
    HasTenantCol,
)


# ----------------------------------------------------------------------
# datasets
# ----------------------------------------------------------------------


def _is_spark_dataframe(dataset):
    return type(dataset).__module__.startswith("pyspark")


class Partitions(object):
    """Explicit marker for pre-partitioned input: wrap a list of row
    lists so flat datasets of *list-typed rows* are never misread as
    partitions (``TFEstimator(...).fit(Partitions([[row, ...], ...]))``)."""

    def __init__(self, partitions):
        self.partitions = [list(p) for p in partitions]


def _to_partitions(dataset, num_partitions, columns=None):
    """A dataset as a list of row partitions.

    Accepts a list of dict rows, a :class:`Partitions`, a list of
    partitions (lists *of dict/tuple rows*; a flat dataset of list-typed
    rows splits like any other flat dataset), or a pyspark DataFrame.
    A flat dataset is dealt round robin into ``num_partitions``.
    ``columns`` selects and sorts dict rows into tuples (the driver-side
    twin of the reference's ``df.select(sorted(input_mapping))``).
    """
    if _is_spark_dataframe(dataset):
        from .data import spark_io

        dataset = spark_io.dataframe_to_rows(dataset)
    if isinstance(dataset, Partitions):
        partitions = dataset.partitions
        rows = None
    else:
        rows = list(dataset)
    if rows is not None and _looks_partitioned(rows):
        partitions = [list(p) for p in rows]
    elif rows is not None:
        num_partitions = max(1, num_partitions)
        partitions = [rows[i::num_partitions] for i in range(num_partitions)]
        partitions = [p for p in partitions if p] or [[]]
    if columns:
        partitions = [
            [_select(row, columns) for row in part] for part in partitions
        ]
    return partitions


def _looks_partitioned(rows):
    """True when ``rows`` is a list of row-lists of dict/tuple rows.
    Empty partitions are skipped when probing (an empty *first*
    partition must not make the dataset flat)."""
    if not rows or not all(isinstance(p, list) for p in rows):
        return False
    for p in rows:
        if p:
            return isinstance(p[0], (dict, tuple))
    return True  # all partitions empty: (vacuously) partitioned


def _select(row, columns):
    if isinstance(row, dict):
        return tuple(row[c] for c in columns)
    return tuple(row)


def _row_as_dict(row):
    return row.asDict()


# ----------------------------------------------------------------------
# Estimator
# ----------------------------------------------------------------------


def _train_then_export(train_fn, export_fn, args, ctx):
    """``train_fn(args, ctx)``, then ``export_fn(args, ctx)`` on exactly
    one node: the dedicated chief when the cluster has one, else
    worker 0."""
    result = train_fn(args, ctx)
    has_chief = any(j in ctx.cluster_spec for j in ("chief", "master"))
    is_exporter = (
        ctx.job_name in ("chief", "master") if has_chief
        else (ctx.job_name == "worker" and ctx.task_index == 0)
    )
    if is_exporter:
        export_fn(args, ctx)
    return result


class TFEstimator(TFParams, *_ESTIMATOR_MIXINS):
    """Distributed-training estimator.

    Args:
      train_fn: the user's module-level ``main_fun(args, ctx)``.
      tf_args: argparse Namespace / dict of user args (the set params
        are laid over them at fit time).
      export_fn: optional module-level exporter ``export_fn(args, ctx)``
        run after ``train_fn`` returns, on one node (the chief, else
        worker 0).
      engine: an Engine, a SparkContext or an int (forwarded to
        ``cluster.run``); defaults to ``cluster_size`` local executor
        processes.
    """

    def __init__(self, train_fn, tf_args=None, export_fn=None, engine=None):
        super(TFEstimator, self).__init__()
        self.train_fn = train_fn
        self.export_fn = export_fn
        self.engine = engine
        self.args = (tf_args if isinstance(tf_args, Namespace)
                     else Namespace(tf_args))

    def fit(self, dataset):
        return self._fit(dataset)

    def _fit(self, dataset):
        from .cluster import cluster as tfcluster

        args = self.merge_args_params()
        logger.info("fit: merged args: %s", args)
        input_mode = args.input_mode
        if input_mode is None:
            input_mode = tfcluster.InputMode.SPARK
        engine = self.engine if self.engine is not None else args.cluster_size
        train_fn = self.train_fn
        if self.export_fn is not None:
            train_fn = functools.partial(_train_then_export, train_fn,
                                         self.export_fn)
        cluster = tfcluster.run(
            engine,
            train_fn,
            args,
            num_executors=args.cluster_size,
            num_ps=args.num_ps,
            tensorboard=args.tensorboard,
            input_mode=input_mode,
            log_dir=args.model_dir,
            master_node=args.master_node,
            reservation_timeout=args.reservation_timeout,
        )
        try:
            if input_mode == tfcluster.InputMode.SPARK:
                cluster.train(self._fed(cluster, dataset, args), args.epochs,
                              feed_timeout=args.feed_timeout)
        except Exception:
            try:
                cluster.shutdown(grace_secs=0)
            except Exception:  # noqa: BLE001 - the feed's error is reported
                logger.warning("shutdown after a failed feed raised",
                               exc_info=True)
            raise
        cluster.shutdown(grace_secs=args.grace_secs)
        model = TFModel(args)
        self._copy_params(model)
        model.args = args
        return model

    @staticmethod
    def _fed(cluster, dataset, args):
        """What ``train`` feeds: a DataFrame the engine takes natively is
        fed in place (its rows never pass through the driver), as
        sorted-column tuples with an input mapping and dict rows
        without; anything else becomes driver-held partitions of the same
        row shape."""
        input_cols = sorted(args.input_mapping) if args.input_mapping else None
        if (_is_spark_dataframe(dataset) and hasattr(dataset, "select")
                and cluster.engine.is_native_dataset(dataset)):
            if input_cols:
                return dataset.select(*input_cols).rdd.map(tuple)
            return dataset.rdd.map(_row_as_dict)
        return _to_partitions(dataset, args.cluster_size, columns=input_cols)


# ----------------------------------------------------------------------
# Model
# ----------------------------------------------------------------------

#: the executor process's cached predictor (the reference keeps it in a
#: ``global`` of the python worker), keyed by what it was built from
_TRANSFORM_STATE = {"key": None, "predict": None}


def _run_model_iter(rows, args, predictor_builder=None):
    """Inference over one partition's dict rows, in an executor process;
    yields output dict rows as they are produced."""
    from . import serving

    preprocess = getattr(args, "preprocess", None)
    model_config = getattr(args, "model_config", None)
    key = (
        args.export_dir,
        args.signature_def_key,
        args.tag_set,
        serving._builder_key(predictor_builder),
        serving._preprocess_key(preprocess),
        json.dumps(model_config, sort_keys=True, default=str)
        if model_config else None,
    )
    if _TRANSFORM_STATE["key"] != key:
        logger.info("loading predictor for %s", key)
        _TRANSFORM_STATE["predict"] = serving.load_predictor(
            args.export_dir, builder=predictor_builder,
            preprocess=preprocess, config_overrides=model_config,
        )
        _TRANSFORM_STATE["key"] = key
    return serving.predict_rows(
        _TRANSFORM_STATE["predict"],
        rows,
        input_mapping=_model_inputs(args),
        output_mapping=args.output_mapping,
        batch_size=args.batch_size,
        schedule=getattr(args, "schedule", None) or "static",
        on_error=getattr(args, "on_error", None) or "raise",
        checkpoint_dir=getattr(args, "checkpoint_dir", None) or None,
    )


def _model_inputs(args):
    """The transform's input mapping, with ``setTenantCol``'s column
    mapped onto the reserved ``tenant`` serving input."""
    from .serving_engine import TENANT_INPUT

    mapping = dict(args.input_mapping or {})
    tenant_col = getattr(args, "tenant_col", None)
    if tenant_col:
        mapping[tenant_col] = TENANT_INPUT
    return mapping


def _run_model(rows, args, predictor_builder=None):
    return list(_run_model_iter(rows, args, predictor_builder))


def _transform_partition(args, builder, iterator):
    """The map of a transform over driver-held partitions."""
    return _run_model(list(iterator), args, builder)


def _transform_native_partition(args, builder, iterator):
    """The map of a transform over a native dataset: Spark ``Row``s (or
    mappings) in, output dict rows out, lazily."""
    rows = (r.asDict(recursive=True) if hasattr(r, "asDict") else dict(r)
            for r in iterator)
    for out in _run_model_iter(rows, args, builder):
        yield out


def _output_row(cols, out):
    return tuple(_py_value(out.get(c)) for c in cols)


def _py_value(v):
    """A numpy output as a Spark-compatible Python value (scalars via
    ``.item()``, arrays as flat lists: one ArrayType column per output,
    as the reference's ``TFModel.scala`` emits)."""
    import numpy as np

    if isinstance(v, np.ndarray):
        return v.ravel().tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _infer_output_type(v):
    """An output value's interchange type string."""
    import numpy as np

    a = np.asarray(v)
    kind = a.dtype.kind
    if kind == "f":
        base = "float" if a.dtype.itemsize <= 4 else "double"
    elif kind in "iu":
        base = "int" if a.dtype.itemsize <= 4 else "long"
    elif kind == "b":
        base = "boolean"
    else:
        base = "string"
    return "array<{0}>".format(base) if a.ndim >= 1 else base


class TFModel(TFParams, *_MODEL_MIXINS):
    """Batch-inference model: ``transform`` runs inference on the
    executors with a predictor cached per executor process, with no
    cluster start.

    Args:
      tf_args: args/params namespace (export_dir etc.).
      predictor_builder: optional module-level ``builder(params, config)
        -> predict`` shipped to the executors (overrides the export's
        ``model_ref``).
      engine: Engine / SparkContext / int; defaults to one local
        executor.
    """

    def __init__(self, tf_args=None, predictor_builder=None, engine=None):
        super(TFModel, self).__init__()
        self.args = (tf_args if isinstance(tf_args, Namespace)
                     else Namespace(tf_args))
        self.predictor_builder = predictor_builder
        self.engine = engine

    def transform(self, dataset, num_partitions=None):
        return self._transform(dataset, num_partitions)

    def telemetrySnapshot(self):
        """This process's metrics registry as a plain-dict snapshot
        (the driver's view when the model serves in-process)."""
        from . import telemetry

        return telemetry.get_registry().snapshot()

    def traceEvents(self):
        """This process's recorded spans as Chrome-trace JSON."""
        from . import telemetry

        return telemetry.get_tracer().export_chrome()

    def _transform(self, dataset, num_partitions=None):
        from .engine import Engine, LocalEngine, SparkEngine

        args = self.merge_args_params()
        if not args.export_dir:
            raise ValueError("export_dir must be set before transform()")
        if not args.input_mapping:
            raise ValueError("input_mapping must be set before transform()")
        engine = self.engine
        owns_engine = False
        if engine is None:
            engine = LocalEngine(1)
            owns_engine = True
        elif isinstance(engine, int):
            engine = LocalEngine(engine)
            owns_engine = True
        elif not isinstance(engine, Engine) and hasattr(engine, "parallelize"):
            engine = SparkEngine(engine)
        try:
            if engine.is_native_dataset(dataset):
                return self._transform_native(engine, dataset, args)
            partitions = _to_partitions(
                dataset, num_partitions or engine.num_executors)
            return engine.run_job(
                functools.partial(_transform_partition, args,
                                  self.predictor_builder),
                partitions, collect=True)
        finally:
            if owns_engine:
                engine.stop()

    def _transform_native(self, engine, dataset, args):
        """A lazy transform over an engine-native dataset, returning a
        typed DataFrame: its rows never pass through the driver.

        The output schema comes from, in order: ``args.output_schema``
        (interchange list or struct string), the export's
        ``metadata.json`` ``output_schema`` (written at export time with
        ``save_for_serving(..., output_schema=serving.
        infer_output_schema(...))``), or, for exports without it, a
        one-row probe job, which evaluates the predictor over partition
        0's first batch twice (probe and real job; a warning says so).
        """
        from .data import spark_io

        if _is_spark_dataframe(dataset):
            # ship only the predictor's input columns (and the tenant
            # column, which the reference drops here) to the map
            dataset = dataset.select(*sorted(_model_inputs(args)))
        out_rdd = engine.map_partitions_native(
            functools.partial(_transform_native_partition, args,
                              self.predictor_builder), dataset)
        schema = getattr(args, "output_schema", None)
        if not schema:
            meta_path = os.path.join(args.export_dir, "metadata.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    schema = json.load(f).get("output_schema")
        if not schema:
            logger.warning(
                "no output_schema in args or export metadata (%s): "
                "deriving it with a one-row probe job, which evaluates "
                "the predictor over partition 0's first batch TWICE. "
                "Export with save_for_serving(..., output_schema=serving."
                "infer_output_schema(...)) to skip the probe.",
                args.export_dir,
            )
            probe = out_rdd.take(1)
            if not probe:
                raise ValueError(
                    "cannot derive an output schema from an empty "
                    "dataset; set args.output_schema or write "
                    "output_schema into the export metadata"
                )
            schema = [(name, _infer_output_type(probe[0][name]))
                      for name in sorted(probe[0])]
        if isinstance(schema, str):
            from .data import interchange

            schema = interchange.parse_schema(schema)
        schema = [tuple(f) for f in schema]
        spark_schema = spark_io.to_spark_schema(schema)
        cols = tuple(name for name, _ in schema)
        spark = getattr(dataset, "sparkSession", None)
        if spark is None:
            from pyspark.sql import SparkSession

            spark = SparkSession.builder.getOrCreate()
        return spark.createDataFrame(
            out_rdd.map(functools.partial(_output_row, cols)),
            schema=spark_schema)


#: aliases beside the reference's names
TPUEstimator = TFEstimator
TPUModel = TFModel
