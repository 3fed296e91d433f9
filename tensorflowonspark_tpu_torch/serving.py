"""Batch serving entry point (port of the JAX package's ``serving.py``).

:func:`predict_rows` runs a predictor (from
``models.transformer.serving_builder``) over dict rows on either
schedule: ``"static"`` (the default: fixed-size batches, ragged prompts
left-padded, each batch one ``predict`` call) or ``"continuous"``
(in-flight batching through the port's
:class:`~tensorflowonspark_tpu_torch.serving_engine.ServingEngine`, with
its shedding, deadlines, watchdog and live weight hot swap).  Fleet
replicas and the telemetry histogram and usage ledger raise
``NotImplementedError``.

:func:`main` is the batch-inference command line (``python -m
tensorflowonspark_tpu_torch.serving``): an export over TFRecords,
predictions written as JSON lines.

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
import logging
import os
import pickle
import time

import numpy as np

from tensorflowonspark_tpu_torch import serving_engine
from tensorflowonspark_tpu_torch.serving_engine import (  # noqa: F401
    BUDGET_INPUT,
    DEADLINE_INPUT,
    RequestError,
    RequestValidationError,
    ServingEngine,
    ServingError,
    apply_output_mapping,
    error_record,
)
from tensorflowonspark_tpu_torch.utils import not_ported as _not_ported

logger = logging.getLogger(__name__)


def _stack_column(values, column=None):
    """Stack uniform rows into one batch array; ragged rows raise a
    ``ValueError`` naming the offending rows (a predictor without
    ``column_padding`` for this input takes uniform rows only)."""
    arrs = [np.asarray(v) for v in values]
    shapes = {a.shape for a in arrs}
    if len(shapes) > 1:
        majority = max(shapes, key=lambda s: sum(
            1 for a in arrs if a.shape == s
        ))
        ragged = [
            (i, a.shape) for i, a in enumerate(arrs)
            if a.shape != majority
        ][:8]
        raise ValueError(
            "cannot stack ragged rows for input {0}: batch majority "
            "shape is {1} but row(s) {2} differ.  This predictor "
            "declares no padding for this input — uniform-length rows "
            "only".format(
                repr(column) if column else "batch", majority, ragged
            )
        )
    return np.stack(arrs)


def _stack_ragged_left(values, pad_value, multiple=1, cap=None):
    """Stack ragged 1-D rows by LEFT-padding to the batch's longest row
    rounded up to ``multiple``; returns ``(stacked [n, max_len],
    pad_counts [n] int32)``.  ``cap`` bounds the rounded length
    (generation predictors set it to ``max_seq_len - max_new_tokens``);
    a row longer than ``cap`` still stacks at its own length and fails
    in the model's capacity check."""
    arrs = [np.asarray(v) for v in values]
    if any(a.ndim != 1 for a in arrs):
        raise ValueError(
            "ragged padding supports 1-D token rows; got shapes %s"
            % ([a.shape for a in arrs],)
        )
    raw_max = max(a.shape[0] for a in arrs)
    max_len = ((raw_max + multiple - 1) // multiple) * multiple
    if cap is not None:
        max_len = max(raw_max, min(max_len, int(cap)))
    pads = np.asarray([max_len - a.shape[0] for a in arrs], np.int32)
    out = np.full((len(arrs), max_len), pad_value, arrs[0].dtype)
    for i, a in enumerate(arrs):
        if a.shape[0]:
            out[i, max_len - a.shape[0]:] = a
    return out, pads


def _validate_static_row(row, idx, input_mapping):
    """Static-schedule admission: every mapped input column must be
    present (a typed ``missing_input`` error naming the request and the
    column)."""
    for col in sorted(input_mapping):
        if col not in row:
            raise serving_engine.RequestValidationError(
                "request {0} is missing input column {1!r} (mapped to "
                "predictor input {2!r}); present columns: {3}".format(
                    idx, col, input_mapping[col],
                    sorted(row) if isinstance(row, dict) else type(row),
                ),
                kind="missing_input", request_index=idx,
            )


def _predict_rows_static(predict, rows, input_mapping, output_mapping,
                         batch_size, pad_to_batch, stats, on_error):
    """Fixed-size batches in input order: ragged prompt columns (those in
    ``predict.column_padding``) stack left-padded with a ``<input>_pad``
    count column; the last short batch pads with zero rows up to
    ``batch_size`` when ``pad_to_batch`` (outputs cut back).  With
    ``on_error="record"`` a failed batch is re-run row by row at the same
    padded shape and only the rows that fail alone become error records.
    ``stats["latency_sec"]`` gets each request's seconds from its pull
    off ``rows`` to its emission."""
    serving_engine.refuse_reserved_inputs(input_mapping)
    cols = sorted(input_mapping)
    column_padding = getattr(predict, "column_padding", None) or {}
    submit_t = {}
    if stats is not None:
        stats.setdefault("latency_sec", {})

    def _assemble(chunk_rows, n_pad):
        batch = {}
        for c in cols:
            name = input_mapping[c]
            values = [r[c] for r in chunk_rows]
            if name in column_padding:
                batch[name], batch[name + "_pad"] = _stack_ragged_left(
                    values, column_padding[name],
                    getattr(predict, "pad_multiple", 1),
                    cap=getattr(predict, "pad_cap", None),
                )
            else:
                batch[name] = _stack_column(values, column=name)
        n = len(chunk_rows)
        if pad_to_batch and n < n_pad:
            batch = {
                k: np.concatenate(
                    [v, np.zeros((n_pad - n,) + v.shape[1:], v.dtype)]
                )
                for k, v in batch.items()
            }
        return batch

    def _predict_batch(chunk_rows):
        out = predict(_assemble(chunk_rows, batch_size))
        return {
            k: np.asarray(v)[:len(chunk_rows)] for k, v in out.items()
        }

    def _flush(chunk):
        ok = [(i, row) for i, (tag, row, _) in enumerate(chunk)
              if tag == "ok"]
        per_row = {}
        out = None
        if ok:
            try:
                out = _predict_batch([row for _, row in ok])
            except Exception as e:  # noqa: BLE001 - poison isolation
                if on_error == "raise":
                    raise
                logger.warning(
                    "batch of %d rows failed (%s); isolating per-row",
                    len(ok), e,
                )
                for pos, row in ok:
                    idx = chunk[pos][2]
                    try:
                        per_row[pos] = ("out", _predict_batch([row]))
                    except Exception as re:  # noqa: BLE001
                        per_row[pos] = ("rec", serving_engine.error_record(
                            "predict", idx,
                            "request {0} failed in predict: "
                            "{1}".format(idx, re),
                        ))
        ok_pos = {p: i for i, (p, _) in enumerate(ok)}
        for pos, (tag, payload, idx) in enumerate(chunk):
            if tag == "rec":
                yield idx, payload
            elif out is not None:
                i = ok_pos[pos]
                yield idx, apply_output_mapping(
                    {k: v[i] for k, v in out.items()}, output_mapping
                )
            else:
                kind, o = per_row[pos]
                yield idx, o if kind == "rec" else apply_output_mapping(
                    {k: v[0] for k, v in o.items()}, output_mapping
                )

    def _emit(flushed):
        for idx, r in flushed:
            t_sub = submit_t.pop(idx, None)
            if t_sub is not None and stats is not None:
                stats["latency_sec"][idx] = time.monotonic() - t_sub
            yield r

    buf = []  # ("ok", row, idx) | ("rec", error_record, idx), input order
    for idx, row in enumerate(rows):
        submit_t[idx] = time.monotonic()
        try:
            _validate_static_row(row, idx, input_mapping)
            buf.append(("ok", row, idx))
        except serving_engine.RequestValidationError as e:
            if on_error == "raise":
                raise
            buf.append((
                "rec", serving_engine.error_record(e.kind, idx, e), idx
            ))
        if len(buf) == batch_size:
            yield from _emit(_flush(buf))
            buf = []
    if buf:
        yield from _emit(_flush(buf))


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

    ``schedule="static"`` stacks ``batch_size`` rows per ``predict``
    call (see :func:`_predict_rows_static`); ``"continuous"`` is
    in-flight batching: ``batch_size`` is the number of KV-cache slots,
    finished rows are evicted and queued rows admitted between decode
    chunks; ``"auto"`` is continuous for a predictor with
    ``make_slot_decoder``, else static.  ``stats`` (optional dict) is
    filled with ``latency_sec`` (per request, input index keys) and, on
    the continuous schedule, ``ttft_sec`` / ``admitted`` / ``chunks`` /
    ``completed`` / ``tokens_out``, the robustness, reuse and swap
    counters and the page-pool gauges.  ``on_error="record"`` turns a bad
    row into a typed error record at its position.  ``queue_depth`` /
    ``policy`` / ``watchdog_timeout`` / ``default_deadline`` and
    ``checkpoint_dir`` / ``watcher`` / ``rollback_window`` (live weight
    hot swap, see :mod:`.hot_swap`) are continuous-schedule knobs of the
    :class:`ServingEngine`.
    """
    if batch_size == "auto":
        raise _not_ported("batch_size='auto'", "the engine planes")
    if schedule == "auto":
        schedule = ("continuous" if hasattr(predict, "make_slot_decoder")
                    else "static")
    if schedule not in ("static", "continuous"):
        raise ValueError(
            "schedule must be 'static' or 'continuous', got %r"
            % (schedule,)
        )
    if on_error not in serving_engine.ON_ERROR:
        raise ValueError(
            "on_error must be one of %s, got %r"
            % (serving_engine.ON_ERROR, on_error)
        )
    if int(replicas or 1) > 1 or replica_policy != "least_loaded" \
            or fleet_queue_depth is not None:
        raise _not_ported("fleet replicas", "fleet")
    if schedule == "static":
        if (policy != "block" or queue_depth is not None
                or watchdog_timeout is not None
                or default_deadline is not None
                or checkpoint_dir is not None or watcher is not None):
            raise ValueError(
                "queue_depth/policy/watchdog_timeout/default_deadline/"
                "checkpoint_dir/watcher are continuous-schedule knobs; "
                "the static schedule has no admission queue or swap plane"
            )
        yield from _predict_rows_static(
            predict, rows, input_mapping, output_mapping, int(batch_size),
            pad_to_batch, stats, on_error)
        return
    engine = ServingEngine(
        predict, input_mapping, output_mapping, batch_size,
        queue_depth=queue_depth, policy=policy,
        default_deadline=default_deadline,
        watchdog_timeout=watchdog_timeout, on_error=on_error,
        stats=stats, checkpoint_dir=checkpoint_dir, watcher=watcher,
        rollback_window=rollback_window,
    )
    yield from engine.serve(rows)


# ----------------------------------------------------------------------
# serving exports -> predictors
# ----------------------------------------------------------------------

#: this package's name, and the reference package's, whose module paths
#: it mirrors (this package's name with ``_torch`` taken off)
_PACKAGE = __name__.partition(".")[0]
_REFERENCE = _PACKAGE[:-len("_torch")]

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
    not have yet raises ``NotImplementedError`` (ROADMAP queue A: the
    rest)."""
    module_name, _, attr = ref.partition(":")
    if not module_name or not attr:
        raise ValueError(
            "model_ref must look like 'pkg.module:attr', got {0!r}".format(ref)
        )
    top, _, rest = module_name.partition(".")
    if top == _REFERENCE:
        module_name = _PACKAGE + ("." + rest if rest else "")
        try:
            obj = importlib.import_module(module_name)
        except ModuleNotFoundError as e:
            if e.name is None or not module_name.startswith(e.name):
                raise
            raise _not_ported("model_ref {0!r}".format(ref),
                              "the rest") from None
        try:
            for part in attr.split("."):
                obj = getattr(obj, part)
        except AttributeError:
            raise _not_ported("model_ref {0!r}".format(ref),
                              "the rest") from None
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


def infer_output_schema(predict, sample_row, input_mapping,
                        output_mapping=None):
    """The output schema of ``predict``, from ONE row run through
    :func:`predict_rows` at export time, so it can be written into the
    serving metadata (``save_for_serving(..., output_schema=...)``) and
    the distributed transform never runs its one-row probe job.

    The row runs through the static schedule, as in the reference.
    Returns an interchange field list ``[(column, type_str), ...]``.
    """
    from tensorflowonspark_tpu_torch.pipeline import _infer_output_type

    out = next(iter(predict_rows(
        predict, [sample_row], input_mapping, output_mapping,
        batch_size=1,
    )))
    return [(name, _infer_output_type(out[name])) for name in sorted(out)]


# ----------------------------------------------------------------------
# the batch-inference command line (the reference's Inference.scala)
# ----------------------------------------------------------------------


def _parse_mapping(text):
    """Accept JSON (``{"col":"x"}``) or ``col=x,col2=y`` shorthand."""
    text = text.strip()
    if text.startswith("{"):
        return json.loads(text)
    out = {}
    for part in text.split(","):
        k, sep, v = part.partition("=")
        if not sep:
            raise ValueError("mapping entries must be key=value: " + part)
        out[k.strip()] = v.strip()
    return out


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    raise TypeError("not JSON serializable: {0}".format(type(o)))


def main(argv=None):
    """Batch inference: load a serving export, read TFRecords, write one
    JSON line per row to ``<output>/part-00000.jsonl``; returns the
    number of rows written.  The reference's arguments; those of planes
    not ported yet raise ``NotImplementedError`` naming their item.  The
    device is the export's ``model_config["device"]`` (default
    ``cuda``)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="tensorflowonspark_tpu_torch.serving",
        description="Batch inference over TFRecords with a serving export",
    )
    p.add_argument("--export_dir", required=True,
                   help="serving export directory (save_for_serving output)")
    p.add_argument("--input", required=True,
                   help="TFRecord file or directory of shards")
    p.add_argument("--schema_hint", default=None,
                   help="struct<name:type,...> schema for the input records")
    p.add_argument("--input_mapping", required=True,
                   help="JSON or col=input,... mapping of record columns "
                        "to predictor inputs")
    p.add_argument("--output_mapping", default=None,
                   help="JSON or output=col,... mapping of predictor "
                        "outputs to result columns")
    p.add_argument("--output", required=True,
                   help="output directory for JSON-line part files")
    p.add_argument("--batch_size", type=int, default=128,
                   help="rows per batch (static schedule) or in-flight "
                        "KV-cache slots (continuous schedule)")
    p.add_argument("--schedule", choices=("static", "continuous"),
                   default="static",
                   help="batching schedule: 'static' fixed-size batches, "
                        "or 'continuous' in-flight batching for "
                        "generation exports (batch_size = in-flight "
                        "slots)")
    p.add_argument("--on_error", choices=serving_engine.ON_ERROR,
                   default="raise",
                   help="per-request failure policy: 'raise' fails "
                        "fast naming the request, 'record' isolates "
                        "poison rows as typed error records")
    p.add_argument("--policy", choices=serving_engine.POLICIES,
                   default="block", help="admission policy under overload")
    p.add_argument("--queue_depth", type=int, default=None,
                   help="admission-queue bound")
    p.add_argument("--watchdog_timeout", type=float, default=None,
                   help="seconds before a wedged decode chunk is abandoned")
    p.add_argument("--deadline", type=float, default=None,
                   help="default per-request deadline in seconds")
    p.add_argument("--checkpoint_dir", default=None,
                   help="step-numbered serving-export root to watch for "
                        "live weight hot swaps")
    p.add_argument("--checkpoint_poll", type=float, default=5.0,
                   help="seconds between checkpoint_dir scans")
    p.add_argument("--rollback_window", type=int, default=8,
                   help="clean requests a swapped-in generation must serve "
                        "before the previous weights are released")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through a fleet of N engine replicas")
    p.add_argument("--replica_policy", default="least_loaded",
                   choices=("least_loaded", "prefix_affinity",
                            "weighted_rr", "random"),
                   help="fleet dispatch policy")
    p.add_argument("--fleet_queue_depth", type=int, default=None,
                   help="fleet admission-queue bound")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel degree of the serving mesh")
    p.add_argument("--disaggregate", action="store_true",
                   help="split prefill and decode into separate programs")
    args = p.parse_args(argv)

    if args.replicas > 1:
        raise _not_ported("--replicas {0}".format(args.replicas), "fleet")
    if args.tp:
        raise _not_ported("--tp", "TP")
    if args.disaggregate:
        raise _not_ported("--disaggregate", "disaggregation")

    from tensorflowonspark_tpu_torch.data import interchange
    from tensorflowonspark_tpu_torch.utils import fs as fs_utils

    rows, schema = interchange.load_tfrecords(args.input,
                                              schema=args.schema_hint)
    logger.info("loaded %d rows (schema: %s)", len(rows),
                interchange.format_schema(schema))
    predict = load_predictor(args.export_dir)
    input_mapping = _parse_mapping(args.input_mapping)
    output_mapping = (_parse_mapping(args.output_mapping)
                      if args.output_mapping else None)
    fs_utils.makedirs(args.output)
    out_path = fs_utils.join(args.output, "part-00000.jsonl")
    count = 0
    stats = {}
    kwargs = {}
    if args.schedule == "continuous":
        kwargs = dict(
            queue_depth=args.queue_depth, policy=args.policy,
            watchdog_timeout=args.watchdog_timeout,
            default_deadline=args.deadline,
            rollback_window=args.rollback_window,
        )
        if args.checkpoint_dir:
            from tensorflowonspark_tpu_torch import hot_swap

            kwargs["watcher"] = hot_swap.CheckpointWatcher(
                args.checkpoint_dir, poll_interval=args.checkpoint_poll)
    try:
        with fs_utils.open_file(out_path, "w") as f:
            for out_row in predict_rows(
                predict, rows, input_mapping, output_mapping,
                args.batch_size, schedule=args.schedule, stats=stats,
                on_error=args.on_error, **kwargs
            ):
                f.write(json.dumps(out_row, default=_json_default) + "\n")
                count += 1
    finally:
        if "watcher" in kwargs:
            kwargs["watcher"].close()
    shed = stats.get("shed", 0) + stats.get("expired", 0)
    if shed or stats.get("errors"):
        logger.warning("robustness: %d shed/expired, %d error record(s), "
                       "%d watchdog fire(s)", shed, stats.get("errors", 0),
                       stats.get("watchdog_fires", 0))
    if stats.get("swaps") or stats.get("rollbacks"):
        logger.info("lifecycle: %d weight swap(s) (%d committed, %d rolled "
                    "back), %d in-flight request(s) requeued across swaps, "
                    "serving generation %d", stats.get("swaps", 0),
                    stats.get("swap_commits", 0), stats.get("rollbacks", 0),
                    stats.get("swap_requeued", 0),
                    stats.get("weight_generation", 0))
    latency = sorted((stats.get("latency_sec") or {}).values())
    if latency:
        logger.info(
            "%s schedule: %d request(s)%s, per-request latency "
            "p50=%.1fms p99=%.1fms", args.schedule, len(latency),
            " over %d chunks" % stats["chunks"] if stats.get("chunks")
            else "", 1e3 * float(np.percentile(latency, 50)),
            1e3 * float(np.percentile(latency, 99)))
    logger.info("wrote %d predictions to %s", count, out_path)
    return count


if __name__ == "__main__":
    # run the package's module, not this __main__ copy, so model_ref
    # resolution and the predictor cache see the package's names
    from tensorflowonspark_tpu_torch import serving as _serving

    logging.basicConfig(level=logging.INFO)
    _serving.main()
