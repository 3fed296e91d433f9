"""Batch serving entry point (port of the JAX package's ``serving.py``).

Only the continuous schedule is ported: :func:`predict_rows` with
``schedule="continuous"`` runs a generation predictor (from
``models.transformer.serving_builder``) through the port's
:class:`~tensorflowonspark_tpu_torch.serving_engine.ServingEngine`.  The
static schedule, fleet replicas and the lifecycle knobs raise
``NotImplementedError``.
"""

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
