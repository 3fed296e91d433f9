"""Batch serving entry point (port of the JAX package's ``serving.py``).

Only the continuous schedule is ported: :func:`predict_rows` with
``schedule="continuous"`` runs a generation predictor (from
``models.transformer.serving_builder``) through the port's
:class:`~tensorflowonspark_tpu_torch.serving_engine.ServingEngine`.  The
static schedule, fleet replicas and the lifecycle knobs raise
``NotImplementedError``.

:func:`load_predictor` builds a predictor from a serving export
(:func:`..checkpoint.save_for_serving`) through the builder its
metadata names in ``model_ref``.  An export written by the JAX package
names that package's builder; :func:`resolve_ref` maps its module to
this package's module of the same name, so one export serves under
either package.
"""

import hashlib
import importlib
import json
import os
import pickle

from tensorflowonspark_tpu_torch import serving_engine
from tensorflowonspark_tpu_torch.serving_engine import (  # noqa: F401
    BUDGET_INPUT,
    RequestError,
    RequestValidationError,
    ServingEngine,
    ServingError,
    apply_output_mapping,
    error_record,
)
from tensorflowonspark_tpu_torch.utils import not_ported as _not_ported


def predict_rows(
    predict,
    rows,
    input_mapping,
    output_mapping=None,
    batch_size=128,
    pad_to_batch=True,
    schedule="static",
    stats=None,
    on_error="raise",
    queue_depth=None,
    policy="block",
    watchdog_timeout=None,
    default_deadline=None,
    checkpoint_dir=None,
    watcher=None,
    rollback_window=8,
    replicas=1,
    replica_policy="least_loaded",
    fleet_queue_depth=None,
):
    """Run ``predict`` over dict-rows; yields output dict-rows in input
    order.  The reference's signature; see its docstring for each
    argument.

    ``schedule="continuous"`` is in-flight batching: ``batch_size`` is
    the number of KV-cache slots, finished rows are evicted and queued
    rows admitted between decode chunks.  ``stats`` (optional dict) is
    filled with ``latency_sec`` / ``ttft_sec`` (per request, input
    index keys), ``admitted`` / ``chunks`` / ``completed`` /
    ``tokens_out`` and the page-pool gauges.  ``on_error="record"``
    turns a bad row into a typed error record at its position.
    """
    if schedule not in ("static", "continuous", "auto"):
        raise ValueError(
            "schedule must be 'static' or 'continuous', got %r"
            % (schedule,)
        )
    if on_error not in serving_engine.ON_ERROR:
        raise ValueError(
            "on_error must be one of %s, got %r"
            % (serving_engine.ON_ERROR, on_error)
        )
    if schedule != "continuous":
        raise _not_ported(
            "schedule={0!r}".format(schedule),
            "contiguous KV and static generate",
        )
    if batch_size == "auto":
        raise _not_ported("batch_size='auto'", "the engine planes")
    if int(replicas or 1) > 1 or replica_policy != "least_loaded" \
            or fleet_queue_depth is not None:
        raise _not_ported("fleet replicas", "fleet")
    if checkpoint_dir is not None or watcher is not None \
            or rollback_window != 8:
        raise _not_ported("live weight hot swap",
                          "the engine's robustness planes")
    engine = ServingEngine(
        predict, input_mapping, output_mapping, batch_size,
        queue_depth=queue_depth, policy=policy,
        default_deadline=default_deadline,
        watchdog_timeout=watchdog_timeout, on_error=on_error,
        stats=stats,
    )
    yield from engine.serve(rows)


# ----------------------------------------------------------------------
# serving exports -> predictors
# ----------------------------------------------------------------------

#: this package's name, and the reference package's, whose module paths
#: it mirrors (this package's name with ``_torch`` taken off)
_PACKAGE = __name__.partition(".")[0]
_REFERENCE = _PACKAGE[:-len("_torch")]

#: reference modules a ``model_ref`` may name that are not ported yet,
#: and their ROADMAP queue A items
_UNPORTED_MODULES = {
    "models.mlp": "multi-GPU DP over torch.distributed",
    "models.linear": "multi-GPU DP over torch.distributed",
    "models.resnet": "the rest: model state",
    "models.unet": "the rest: model state",
}

#: per-process predictor cache keyed by (export dir, builder digest,
#: preprocess key, overrides)
_PREDICTOR_CACHE = {}


def _builder_key(builder):
    """Content digest of a builder callable (``pickle``, by reference), or
    a fresh object that never hits the cache when it cannot be
    pickled."""
    if builder is None:
        return None
    try:
        return hashlib.sha256(pickle.dumps(builder)).hexdigest()
    except (pickle.PicklingError, AttributeError, TypeError):
        return object()


def resolve_ref(ref):
    """Resolve a ``"pkg.module:attr"`` reference to the object.  A module
    of the reference package resolves to this package's module of the
    same name (the reference is never imported); one this package does
    not have yet raises ``NotImplementedError`` naming its item."""
    module_name, _, attr = ref.partition(":")
    if not module_name or not attr:
        raise ValueError(
            "model_ref must look like 'pkg.module:attr', got {0!r}".format(ref)
        )
    top, _, rest = module_name.partition(".")
    if top == _REFERENCE:
        item = _UNPORTED_MODULES.get(rest, "the rest")
        module_name = _PACKAGE + ("." + rest if rest else "")
        try:
            obj = importlib.import_module(module_name)
        except ModuleNotFoundError as e:
            if e.name is None or not module_name.startswith(e.name):
                raise
            raise _not_ported("model_ref {0!r}".format(ref), item) from None
        try:
            for part in attr.split("."):
                obj = getattr(obj, part)
        except AttributeError:
            raise _not_ported("model_ref {0!r}".format(ref), item) from None
        return obj
    obj = importlib.import_module(module_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def with_preprocess(predict, preprocess):
    """``predict`` behind an on-device preprocess stage (a callable or a
    ``make_preprocess`` kwargs dict).  The predictor's batch-shape
    attributes (``column_padding``, ``pad_multiple``, ``pad_cap``,
    ``make_slot_decoder``) are carried over; the continuous schedule
    drives ``make_slot_decoder`` directly, so the stage applies to
    calls of ``predict`` itself."""
    from tensorflowonspark_tpu_torch.data import preprocess as pp_mod

    pre = pp_mod.resolve_preprocess(preprocess)

    def wrapped(batch):
        return predict(pre(batch))

    for attr in (
        "column_padding", "pad_multiple", "pad_cap", "make_slot_decoder"
    ):
        if hasattr(predict, attr):
            setattr(wrapped, attr, getattr(predict, attr))
    return wrapped


def _preprocess_key(preprocess):
    """Cache-key part of a preprocess argument: dict specs by their
    sorted contents, callables by content digest."""
    if preprocess is None:
        return None
    if isinstance(preprocess, dict):
        return json.dumps(preprocess, sort_keys=True, default=str)
    return _builder_key(preprocess)


def load_predictor(export_dir, builder=None, use_cache=True,
                   preprocess=None, config_overrides=None):
    """Load a serving export and return its ``predict`` callable.

    Args:
      export_dir: a directory written by
        :func:`~tensorflowonspark_tpu_torch.checkpoint.save_for_serving`
        (or by the JAX package's, in the layout this package reads).
      builder: ``builder(params, config) -> predict``; defaults to the
        metadata's ``model_ref`` (:func:`resolve_ref`).
      use_cache: reuse the predictor built before for the same export,
        builder, preprocess and overrides.
      preprocess: a stage fused in front of the predictor
        (:func:`with_preprocess`); defaults to the metadata's
        ``"preprocess"``; ``False`` disables even that.
      config_overrides: a dict laid over the metadata's ``model_config``
        before the builder runs (deployment knobs, e.g. ``device``).
    """
    key = (
        os.path.abspath(os.fspath(export_dir)),
        _builder_key(builder),
        _preprocess_key(preprocess),
        json.dumps(config_overrides, sort_keys=True, default=str)
        if config_overrides else None,
    )
    if use_cache and key in _PREDICTOR_CACHE:
        return _PREDICTOR_CACHE[key]

    from tensorflowonspark_tpu_torch.checkpoint import load_for_serving

    params, meta = load_for_serving(export_dir)
    if builder is None:
        ref = meta.get("model_ref")
        if not ref:
            raise ValueError(
                "export {0} has no model_ref metadata and no builder was "
                "given; write it via save_for_serving(..., extra_metadata="
                "{{'model_ref': 'pkg.module:builder'}})".format(export_dir)
            )
        builder = resolve_ref(ref)
    model_config = dict(meta.get("model_config") or {})
    if config_overrides:
        model_config.update(config_overrides)
    predict = builder(params, model_config)
    if preprocess is None:
        preprocess = meta.get("preprocess")
    if preprocess is not None and preprocess is not False:
        predict = with_preprocess(predict, preprocess)
    if use_cache:
        _PREDICTOR_CACHE[key] = predict
    return predict
