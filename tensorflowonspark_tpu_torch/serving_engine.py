"""Overload-safe continuous serving over a generation predictor (port
of the JAX package's ``serving_engine.py``).

:class:`ServingEngine` feeds a queue of requests into the KV-cache slots
of a :class:`~tensorflowonspark_tpu_torch.models.transformer.SlotDecoder`:
between decode chunks, finished rows (first eos, or their token budget)
are evicted and new prompts admitted into the freed lanes, so a short
request never pays a long neighbour's decode.  Outputs come back in
input order, a failed request as a typed record at its position.

- **Admission control**: ``block`` pulls one request per free slot (the
  source is the backpressure); ``reject`` keeps ``queue_depth`` requests
  waiting and sheds the rest as ``shed`` records; ``degrade`` accepts
  everything and shrinks budgets against the backlog, down to
  ``degrade_floor``, after evicting cold prefix-cache branches.
- **Poison isolation**: validation at admission and per-request capture
  around the prefill (``on_error="record"``).
- **Deadlines**: a row column mapped to :data:`DEADLINE_INPUT`, or
  ``default_deadline``; an expired request leaves the queue, or its
  lane is cancelled between chunks, with a ``deadline`` record carrying
  its committed tokens.
- **Decode watchdog** (``watchdog_timeout``): the chunk (dispatch and
  resolve) runs on a worker thread in the decoder's CUDA device; a
  chunk that produces nothing in time is abandoned, the slot table torn
  down, and every in-flight request re-admitted from its committed
  tokens (greedy outputs stay token-identical).  An abandoned worker
  that wakes returns before it touches the decoder.
- **Live weight swaps** (``watcher`` / ``checkpoint_dir``, see
  :mod:`.hot_swap`): between chunks, in-flight requests quiesce through
  the same teardown, the new generation installs, a canary runs, and the
  previous weights stay resident until ``rollback_window`` clean
  requests commit the swap; a canary failure or a probation error rolls
  back.  :meth:`ServingEngine.drain` stops admissions for a graceful
  shutdown; :meth:`ServingEngine.request_retune` changes
  :attr:`ServingEngine.RETUNABLE` knobs between chunks.
- **Disaggregation** (``disaggregate``, or the predictor's flag): each
  admit runs through a :class:`.serving_disagg.PrefillWorker` (under
  its own abandonable watchdog when ``watchdog_timeout`` is set), whose
  page row the decoder adopts (:meth:`SlotDecoder.adopt`) under a
  ``handoff`` span.  A dead or wedged prefill is contained: its lease
  is reaped by owner, the request re-prefills through the unified
  admit, and the worker is rebuilt; every scheduling pass also reaps
  leases past their deadline (``lease_reaped`` marks).
- **Telemetry** (:mod:`.telemetry`): the ``serving.*`` counters, the
  latency, TTFT and queue-wait histograms (shared with the static
  schedule: :func:`latency_summary`), a span trace per request
  (``admission``, ``queue_wait``, ``prefill``, one ``decode_chunk`` per
  chunk on every in-flight request's trace, then the ``emit`` mark),
  journal marks of every shed, expiry, watchdog fire and swap, the usage
  ledger's row per request (decode chip-seconds and KV page-seconds
  accrued per chunk on the request's record and settled once at its end,
  under the tenant of the :data:`TENANT_INPUT` column), the flight
  recorder, the ``"serving"`` status provider and, with the builder's
  ``profile_dir``, a ``torch.profiler`` trace of the first decode
  chunks.  None of it synchronises with the device: chunk times are host
  intervals that end where the chunk's tokens reach the host anyway.

Faults for tests come from :mod:`.testing.chaos` (``wedge_dispatch`` and
the prefill faults through ``TFOS_CHAOS_PLAN``).
"""

import contextlib
import logging
import queue as queue_mod
import threading
import time
import weakref

import numpy as np

from tensorflowonspark_tpu_torch import telemetry
from tensorflowonspark_tpu_torch.prefix_cache import pages_for_tokens
from tensorflowonspark_tpu_torch.serving_disagg import (
    PrefillWorker,
    PrefillWorkerDead,
)
from tensorflowonspark_tpu_torch.telemetry import catalog as _catalog

logger = logging.getLogger(__name__)

#: the request-latency histogram both schedules observe (submit to emit)
LATENCY_METRIC = "serving.request_latency_sec"
#: the time-to-first-token histogram: submit to the first token's
#: arrival on the host
TTFT_METRIC = "serving.ttft_sec"


def latency_histogram():
    """The process-wide request-latency histogram (:data:`LATENCY_METRIC`)."""
    return telemetry.get_registry().histogram(LATENCY_METRIC)


def ttft_histogram():
    """The process-wide time-to-first-token histogram
    (:data:`TTFT_METRIC`)."""
    return telemetry.get_registry().histogram(TTFT_METRIC)


def _summary(hist, name, since):
    snap = hist.snapshot()
    if since:
        snap = telemetry.snapshot_delta(
            {"histograms": {name: snap}}, {"histograms": {name: since}},
        )["histograms"][name]
    return {
        "count": int(snap.get("count", 0)),
        "p50_ms": round(1e3 * telemetry.histogram_percentile(snap, 50), 3),
        "p99_ms": round(1e3 * telemetry.histogram_percentile(snap, 99), 3),
    }


def latency_summary(since=None):
    """``{"count", "p50_ms", "p99_ms"}`` of the shared latency histogram;
    ``since`` (an earlier ``latency_histogram().snapshot()``) scopes it
    to one job.  Zeros when telemetry is off.  The histogram interpolates
    inside its 1.25-ratio buckets, so it agrees with a nearest-rank
    percentile of ``stats["latency_sec"]`` to the bucket width."""
    return _summary(latency_histogram(), LATENCY_METRIC, since)


def ttft_summary(since=None):
    """:func:`latency_summary` of the TTFT histogram."""
    return _summary(ttft_histogram(), TTFT_METRIC, since)


#: reserved input name: a row column mapped to it carries that request's
#: token budget (evicted after ``min(max_new, budget)`` tokens)
BUDGET_INPUT = _catalog.BUDGET_COLUMN
#: reserved input name: a row column mapped to it carries that request's
#: deadline in seconds from submission
DEADLINE_INPUT = _catalog.DEADLINE_COLUMN
#: reserved input name: a row column mapped to it carries that request's
#: tenant key, under which the usage ledger charges it (a non-empty
#: string, checked at admission on both schedules; rows without one
#: land on ``telemetry.ledger.DEFAULT_TENANT``)
TENANT_INPUT = _catalog.TENANT_COLUMN
#: reserved input name: a row column mapped to it carries the request's
#: trace id (a non-empty string); unmapped requests trace as ``req<N>``
TRACE_INPUT = _catalog.TRACE_COLUMN

#: every column name the serving surface reserves
RESERVED_INPUTS = (
    BUDGET_INPUT, DEADLINE_INPUT, TENANT_INPUT, TRACE_INPUT,
)

if RESERVED_INPUTS != _catalog.RESERVED_INPUT_COLUMNS:
    raise ImportError(
        "serving_engine.RESERVED_INPUTS drifted from "
        "telemetry.catalog.RESERVED_INPUT_COLUMNS: %r != %r"
        % (RESERVED_INPUTS, _catalog.RESERVED_INPUT_COLUMNS))

POLICIES = ("block", "reject", "degrade")
ON_ERROR = ("raise", "record")


class ServingError(Exception):
    """Base for serving-engine failures."""


class RequestError(ServingError, ValueError):
    """A problem scoped to ONE request: carries the failure ``kind``
    (see :func:`error_record`) and the request's input index."""

    def __init__(self, message, kind="request", request_index=None):
        super().__init__(message)
        self.kind = kind
        self.request_index = request_index


class RequestValidationError(RequestError):
    """Admission-time validation failure (missing column, bad
    shape/dtype, oversized prompt, bad budget or deadline value)."""


class WatchdogTimeout(ServingError):
    """The decode watchdog gave up on a wedged chunk."""


def error_record(kind, request_index, message, tokens_done=0,
                 partial=None):
    """The typed record a failed, shed or expired request yields at its
    input-order position: ``{"error": {"kind", "request_index",
    "message", "tokens_done"[, "partial"]}}``.  ``kind`` is one of
    ``missing_input`` / ``bad_dtype`` / ``bad_shape`` / ``empty_prompt``
    / ``too_long`` / ``bad_budget`` / ``bad_deadline`` / ``bad_tenant`` /
    ``bad_trace`` (validation),
    ``admit`` / ``predict`` (per-request capture), ``shed`` (admission
    control), ``deadline`` (expiry, with the committed ``partial``
    tokens) or ``drained`` (:meth:`ServingEngine.drain`)."""
    rec = {
        "kind": str(kind),
        "request_index": int(request_index),
        "message": str(message),
        "tokens_done": int(tokens_done),
    }
    if partial is not None:
        rec["partial"] = [int(t) for t in partial]
    return {"error": rec}


def validate_tenant(row, idx, tenant_col):
    """The tenant check of both schedules: the :data:`TENANT_INPUT`
    column must hold a non-empty string (numpy strings and UTF-8 bytes
    normalize); anything else is a :class:`RequestValidationError` of
    kind ``bad_tenant`` naming the request and the value."""
    v = row[tenant_col]
    if isinstance(v, np.str_):
        v = str(v)
    if isinstance(v, bytes):
        try:
            v = v.decode("utf-8")
        except UnicodeDecodeError:
            v = None
    if not isinstance(v, str) or not v:
        raise RequestValidationError(
            "request {0}: tenant column {1!r} must hold a non-empty "
            "string tenant key, got {2!r}".format(
                idx, tenant_col, row[tenant_col]
            ),
            kind="bad_tenant", request_index=idx,
        )
    return v


def apply_output_mapping(out, output_mapping):
    """Rename predictor outputs to row columns; unknown names fail
    fast (a caller config error, never converted to a record)."""
    if not output_mapping:
        return out
    missing = [n for n in output_mapping if n not in out]
    if missing:
        raise KeyError(
            "output_mapping names {0} not produced by the predictor "
            "(outputs: {1})".format(missing, sorted(out))
        )
    return {col: out[name] for name, col in output_mapping.items()}


def device_scope(device):
    """The context a thread other than the caller's enters to run on
    ``device``: the current CUDA device is per thread, and a worker left
    on card 0 would allocate and launch there."""
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch

        return torch.cuda.device(device)
    return contextlib.nullcontext()


def stream_scope(stream):
    """The context that makes ``stream`` (a CUDA stream, or None) the
    calling thread's current stream: the current stream is per thread
    too."""
    if stream is None:
        return contextlib.nullcontext()
    import torch

    return torch.cuda.stream(stream)


def current_stream(device):
    """The calling thread's current CUDA stream on ``device``, or None
    off the card: a worker thread the caller starts runs on it (a fleet
    replica's engine keeps all of its work on its replica's stream)."""
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch

        return torch.cuda.current_stream(device)
    return None


class _DispatchWatchdog(object):
    """Runs the engine's decode chunk on a worker thread (inside
    :func:`device_scope` of ``device``, on the engine's ``stream``) so
    that a wedged chunk can be timed out instead of hanging the
    scheduler.

    On a timeout the watchdog is *abandoned*: the dispatched callable
    checks :attr:`abandoned` after its fault gate and returns before it
    touches the decoder, so a stale thread never launches work beside
    the replacement's (a launch cannot be taken back).  A chunk wedged
    inside the runtime keeps its daemon thread parked."""

    def __init__(self, device=None, stream=None):
        self._in = queue_mod.Queue()
        self._out = queue_mod.Queue()
        self.abandoned = False
        self._device = device
        self._stream = stream
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serving-watchdog"
        )
        self._thread.start()

    def _run(self):
        with device_scope(self._device), stream_scope(self._stream):
            while True:
                fn = self._in.get()
                if fn is None:
                    return
                try:
                    self._out.put(("ok", fn()))
                except BaseException as e:  # noqa: BLE001 - relayed
                    self._out.put(("err", e))

    def call(self, fn, timeout):
        """Run ``fn()`` on the worker; raise :class:`WatchdogTimeout`
        (and abandon the worker) when no result lands in time."""
        self._in.put(fn)
        try:
            kind, val = self._out.get(timeout=timeout)
        except queue_mod.Empty:
            self.abandoned = True
            raise WatchdogTimeout(
                "decode chunk dispatch produced no result within "
                "{0:.1f}s; abandoning the dispatch".format(timeout)
            )
        if kind == "err":
            raise val
        return val

    def close(self):
        if not self.abandoned:
            self._in.put(None)


class ServingEngine(object):
    """Continuous serving over a generation predictor exposing
    ``make_slot_decoder`` (``transformer.serving_builder(mode=
    "generate")``).  :meth:`serve` is a generator: feed it dict rows,
    get output rows back in INPUT order, with typed records at the
    positions of failed, shed or expired requests.

    Args:
      predict: the generation predictor.
      input_mapping: ``{column: input_name}``; exactly one column maps
        to the ragged prompt input, optionally one each to
        :data:`BUDGET_INPUT`, :data:`DEADLINE_INPUT`,
        :data:`TENANT_INPUT` and :data:`TRACE_INPUT`.
      output_mapping: optional ``{output_name: column}`` rename.
      num_slots: in-flight KV-cache slots.
      chunk: decode steps per dispatch (None = predictor default).
      queue_depth: bounded admission queue (default ``2 * num_slots``).
      policy: ``"block" | "reject" | "degrade"``.
      degrade_floor: the least budget ``degrade`` leaves a request.
      default_deadline: seconds, for rows without a mapped deadline.
      watchdog_timeout: seconds a chunk may take (None = no watchdog).
      on_error: ``"raise"`` or ``"record"``.
      wedge_fn: test hook ``fn(chunk_index)`` called before each chunk;
        default the chaos plan's (:func:`..testing.chaos.
        serving_wedge_fn`), None without a plan.
      stats: optional dict filled with the scheduling counters.
      clock: monotonic clock override (tests).
      watcher: a :class:`..hot_swap.CheckpointWatcher`; the checkpoints
        it validates swap in between chunks.
      checkpoint_dir: builds (and owns) a watcher over this root of
        ``publish_for_serving`` steps, polled every
        ``checkpoint_poll_sec``.
      rollback_window: clean completions that commit a swap.
      swap_canary: run the decoder's canary right after a swap; a
        failure rolls back and quarantines the step.
      disaggregate: admit through a prefill worker (None: the
        predictor's ``disaggregate``); needs a paged decoder.
    """

    def __init__(self, predict, input_mapping, output_mapping=None,
                 num_slots=8, *, chunk=None, queue_depth=None,
                 policy="block", degrade_floor=1, default_deadline=None,
                 watchdog_timeout=None, on_error="raise", wedge_fn=None,
                 stats=None, clock=None, watcher=None,
                 checkpoint_dir=None, checkpoint_poll_sec=5.0,
                 rollback_window=8, swap_canary=True, disaggregate=None):
        if policy not in POLICIES:
            raise ValueError(
                "policy must be one of {0}, got {1!r}".format(
                    POLICIES, policy
                )
            )
        if on_error not in ON_ERROR:
            raise ValueError(
                "on_error must be one of {0}, got {1!r}".format(
                    ON_ERROR, on_error
                )
            )
        factory = getattr(predict, "make_slot_decoder", None)
        if factory is None:
            raise ValueError(
                "continuous serving requires a generation predictor "
                "exposing make_slot_decoder (see transformer."
                "serving_builder with mode='generate'); this predictor "
                "has none"
            )
        column_padding = getattr(predict, "column_padding", None) or {}
        prompt_cols = [
            c for c in input_mapping if input_mapping[c] in column_padding
        ]
        if len(prompt_cols) != 1:
            raise ValueError(
                "continuous scheduling needs exactly one ragged prompt "
                "column in input_mapping; got {0}".format(prompt_cols)
            )
        self.input_mapping = dict(input_mapping)
        self.output_mapping = output_mapping
        self.prompt_col = prompt_cols[0]
        self.budget_col = next(
            (c for c in input_mapping
             if input_mapping[c] == BUDGET_INPUT), None
        )
        self.deadline_col = next(
            (c for c in input_mapping
             if input_mapping[c] == DEADLINE_INPUT), None
        )
        self.tenant_col = next(
            (c for c in input_mapping
             if input_mapping[c] == TENANT_INPUT), None
        )
        self.trace_col = next(
            (c for c in input_mapping
             if input_mapping[c] == TRACE_INPUT), None
        )
        self.policy = policy
        self.on_error = on_error
        self.degrade_floor = max(1, int(degrade_floor))
        self.default_deadline = (
            None if default_deadline is None else float(default_deadline)
        )
        self.watchdog_timeout = (
            None if watchdog_timeout is None else float(watchdog_timeout)
        )
        self.num_slots = int(num_slots)
        self.queue_depth = (
            max(1, int(queue_depth)) if queue_depth is not None
            else max(1, 2 * self.num_slots)
        )
        self.decoder = (
            factory(self.num_slots) if chunk is None
            else factory(self.num_slots, chunk)
        )
        if disaggregate is None:
            disaggregate = bool(getattr(predict, "disaggregate", False))
        self.disaggregate = bool(disaggregate)
        self._prefill_worker = None
        self._prefill_watchdog = None
        if self.disaggregate:
            from tensorflowonspark_tpu_torch.testing import chaos

            # one worker per engine (per job): the chaos plan's prefill
            # indices count from this job's first prefill.  The lease
            # deadline is generous against the dispatch timeout: the
            # deadline reaper fires only on leases whose supervised owner
            # vanished too
            self._prefill_worker = PrefillWorker(
                self.decoder, fault_fn=chaos.prefill_fault_fn(),
                lease_deadline_sec=(
                    None if self.watchdog_timeout is None
                    else 4.0 * self.watchdog_timeout))
            if self.watchdog_timeout is not None:
                self._prefill_watchdog = self._new_watchdog()
        self.max_new = self.decoder.max_new_tokens
        self.eos_id = self.decoder.eos_id
        self._fill = self.eos_id if self.eos_id is not None else 0
        # generated_len is emitted whenever a row can stop early
        self._emit_len = (self.eos_id is not None
                          or self.budget_col is not None
                          or policy == "degrade")
        self._clock = clock if clock is not None else time.monotonic
        if wedge_fn is None:
            from tensorflowonspark_tpu_torch.testing import chaos

            wedge_fn = chaos.serving_wedge_fn()
        self._wedge = wedge_fn
        self._watchdog = self._new_watchdog()
        self.rollback_window = max(1, int(rollback_window))
        self.swap_canary = bool(swap_canary)
        self._own_watcher = False
        if watcher is None and checkpoint_dir:
            from tensorflowonspark_tpu_torch import hot_swap

            watcher = hot_swap.CheckpointWatcher(
                checkpoint_dir, poll_interval=float(checkpoint_poll_sec),
                device=getattr(self.decoder, "device", None),
            )
            self._own_watcher = True
        self.watcher = watcher
        if self.watcher is not None:
            if not callable(getattr(self.decoder, "swap_weights", None)):
                if self._own_watcher:
                    self.watcher.close()
                raise ValueError(
                    "live weight hot-swap needs a decoder exposing "
                    "swap_weights/snapshot_weights (transformer."
                    "serving_builder generation decoders do); this "
                    "predictor's decoder has none"
                )
            # bind the live census so that the watcher's validation
            # rejects a mis-shaped checkpoint off the decode loop, and
            # the card its ingest copies onto
            if (getattr(self.watcher, "expect", None) is None
                    and callable(getattr(self.decoder, "param_spec",
                                         None))):
                self.watcher.expect = self.decoder.param_spec()
            if getattr(self.watcher, "device", False) is None:
                self.watcher.device = getattr(self.decoder, "device", None)
        self._swap_request = None
        self._prev_weights = None    # (snapshot, WeightSet) in probation
        self._probation_clean = 0
        self._probation_errors = 0
        self._draining = False
        self._drain_deadline_at = None
        self._retune_request = {}
        self.stats = stats if stats is not None else {}
        self.stats.update({
            "latency_sec": {}, "done_at": {}, "ttft_sec": {},
            "admitted": 0, "chunks": 0,
            "chunk_size": self.decoder.chunk_size,
            "completed": 0, "errors": 0, "shed": 0, "expired": 0,
            "degraded": 0, "watchdog_fires": 0, "recovered": 0,
            # cross-request reuse, as per-job deltas of the decoder's
            # cumulative counters (the decoder outlives the job)
            "prefix_hits": 0, "prefix_tokens_saved": 0, "evictions": 0,
            "pressure_evictions": 0, "prefix_hit_admits": 0,
            "spec_accepted": 0, "spec_proposed": 0, "spec_accept_rate": 0.0,
            # the swap lifecycle
            "swaps": 0, "swap_commits": 0, "rollbacks": 0,
            "swap_requeued": 0, "swap_latency_sec": [], "drained": 0,
            "swap_events": [],
            "weight_generation": int(getattr(
                self.decoder, "weight_generation", 0)),
            "kv_layout": getattr(self.decoder, "kv_layout", "contiguous"),
            "decode_wall_sec": 0.0, "prefill_wall_sec": 0.0,
            "tokens_out": 0,
            # the disaggregation plane and its fault containment
            "disaggregated": self.disaggregate,
            "prefill_watchdog_fires": 0, "prefill_worker_deaths": 0,
            "prefill_restarts": 0, "leases_reaped": 0,
        })
        self._reuse_base = dict(self._decoder_reuse_stats())
        self._pending = []      # validated, waiting for a slot
        self._slot_req = {}     # slot -> in-flight request record
        self._rids = {}         # input idx -> trace id (the emit marks)
        self._finished = {}     # input idx -> output row / record
        self._emit_next = 0
        self._n_in = 0
        self._exhausted = False
        self._idle_source = False
        self._chunk_index = 0
        self._t0 = self._clock()
        self._init_telemetry(predict)

    def _init_telemetry(self, predict):
        """Resolve the metrics once (null ones when telemetry is off),
        install the flight recorder, start a profile the predictor asks
        for, and register the ``"serving"`` status provider."""
        reg = telemetry.get_registry()
        self._tracer = telemetry.get_tracer()
        self._ledger = telemetry.get_ledger()
        # page-seconds are counted in pages of the paged layout, else of
        # the radix block, else of the fingerprint block
        from tensorflowonspark_tpu_torch import prefix_cache as _pc

        pc = getattr(self.decoder, "prefix_cache", None)
        self._page_tokens = int(
            getattr(self.decoder, "_page_tokens", 0)
            or (pc.block_tokens if pc is not None else 0)
            or _pc.FINGERPRINT_TOKENS
        )
        from tensorflowonspark_tpu_torch.telemetry import blackbox

        blackbox.install()
        self._m_lat = reg.histogram(LATENCY_METRIC)
        self._m_ttft = reg.histogram(TTFT_METRIC)
        self._m_queue_wait = reg.histogram("serving.queue_wait_sec")
        self._m = {
            "admitted": reg.counter("serving.admitted"),
            "completed": reg.counter("serving.completed"),
            "errors": reg.counter("serving.errors"),
            "shed": reg.counter("serving.shed"),
            "expired": reg.counter("serving.expired"),
            "degraded": reg.counter("serving.degraded"),
            "chunks": reg.counter("serving.chunks"),
            "watchdog_fires": reg.counter("serving.watchdog_fires"),
            "recovered": reg.counter("serving.recovered"),
            "prefix_hit_admits": reg.counter("serving.prefix_hit_admits"),
            "swaps": reg.counter("serving.swaps"),
            "swap_commits": reg.counter("serving.swap_commits"),
            "swap_rollbacks": reg.counter("serving.swap_rollbacks"),
            "drained": reg.counter("serving.drained"),
        }
        self._m_gen = reg.gauge("serving.weight_generation")
        self._m_gen.set(self.stats["weight_generation"])
        self._profile = None
        prof = getattr(predict, "profile", None)
        if prof and prof.get("dir"):
            from tensorflowonspark_tpu_torch import tensorboard

            self._profile = tensorboard.start_profile(prof["dir"],
                                                      prof.get("steps"))
        # the provider holds the engine through a weakref: a finished
        # engine, its decoder and the weights on the card must not stay
        # alive for the status registry's sake
        ref = weakref.ref(self)

        def _serving_status():
            eng = ref()
            return {"finished": True} if eng is None else eng.health_status()

        from tensorflowonspark_tpu_torch.telemetry import health

        health.register_status_provider("serving", _serving_status)

    def load(self):
        """The fleet router's placement signal: plain host ints read off
        the scheduler's state, with no lock, no device sync and no
        telemetry-registry traffic (the router polls it at dispatch
        rate).  :meth:`health_status` carries the same fields."""
        in_flight = len(self._slot_req)
        slots = int(getattr(self.decoder, "num_slots", self.num_slots))
        pc = getattr(self.decoder, "prefix_cache", None)
        return {
            "slots": slots,
            "free_slots": max(0, slots - in_flight),
            "in_flight": in_flight,
            "queued": len(self._pending),
            "queue_depth": self.queue_depth,
            "prefix_blocks": len(pc) if pc is not None else 0,
            "weight_generation": self.stats["weight_generation"],
            "draining": self._draining,
        }

    def health_status(self):
        """The engine's compact ``/status`` summary: load, the shed,
        deadline and watchdog counts, the swap lifecycle, and its cost
        row."""
        pc = getattr(self.decoder, "prefix_cache", None)
        return {
            "slots": getattr(self.decoder, "num_slots", None),
            "free_slots": max(
                0, int(getattr(self.decoder, "num_slots",
                               self.num_slots)) - len(self._slot_req)
            ),
            "in_flight": len(self._slot_req),
            "queued": len(self._pending),
            "queue_depth": self.queue_depth,
            "prefix_blocks": len(pc) if pc is not None else 0,
            "policy": self.policy,
            "draining": self._draining,
            "admitted": self.stats["admitted"],
            "completed": self.stats["completed"],
            "shed": self.stats["shed"],
            "expired": self.stats["expired"],
            "errors": self.stats["errors"],
            "watchdog_fires": self.stats["watchdog_fires"],
            "weight_generation": self.stats["weight_generation"],
            "swaps": self.stats["swaps"],
            "rollbacks": self.stats["rollbacks"],
            "usage": {
                "chip_sec": round(self.stats["decode_wall_sec"], 6),
                "prefill_chip_sec": round(
                    self.stats["prefill_wall_sec"], 6
                ),
                "tokens_out": self.stats["tokens_out"],
                "prefix_tokens_saved": self.stats["prefix_tokens_saved"],
            },
        }

    def _new_watchdog(self):
        if self.watchdog_timeout is None:
            return None
        device = getattr(self.decoder, "device", None)
        return _DispatchWatchdog(device, current_stream(device))

    # -- cross-request reuse accounting --------------------------------

    def _decoder_reuse_stats(self):
        fn = getattr(self.decoder, "reuse_stats", None)
        return fn() if callable(fn) else {}

    def _update_reuse_stats(self):
        """Fold the decoder's reuse counters into ``stats`` as per-job
        deltas, and the pool gauges as their current values."""
        cur = self._decoder_reuse_stats()
        base = self._reuse_base
        for key in ("prefix_hits", "prefix_tokens_saved", "evictions",
                    "spec_accepted", "spec_proposed"):
            if key in cur:
                self.stats[key] = int(cur[key]) - int(base.get(key, 0))
        for key in ("pool_pages", "pool_pages_used", "pool_pages_shared",
                    "pool_pages_free"):
            if key in cur:
                self.stats[key] = int(cur[key])
        prop = self.stats["spec_proposed"]
        self.stats["spec_accept_rate"] = (
            self.stats["spec_accepted"] / float(prop) if prop else 0.0)

    # -- admission ------------------------------------------------------

    def _rid_of(self, row, idx):
        """The request's trace id: the :data:`TRACE_INPUT` column's
        string when it holds one (:meth:`_validate` rejects anything
        else), else ``req<idx>``."""
        if self.trace_col is not None and isinstance(row, dict):
            v = row.get(self.trace_col)
            if isinstance(v, str) and v:
                return v
        return "req%d" % idx

    def _validate(self, row, idx, rid):
        """Admission-time request validation; returns the request
        record or raises :class:`RequestValidationError` naming the
        request index and the offending column."""
        for col in sorted(self.input_mapping):
            if col not in row:
                raise RequestValidationError(
                    "request {0} is missing input column {1!r} (mapped "
                    "to predictor input {2!r}); present columns: "
                    "{3}".format(
                        idx, col, self.input_mapping[col],
                        sorted(row) if isinstance(row, dict) else type(row),
                    ),
                    kind="missing_input", request_index=idx,
                )
        try:
            prompt = np.asarray(row[self.prompt_col])
        except Exception as e:  # noqa: BLE001 - anything non-arrayable
            raise RequestValidationError(
                "request {0}: prompt column {1!r} is not array-like: "
                "{2}".format(idx, self.prompt_col, e),
                kind="bad_dtype", request_index=idx,
            )
        if prompt.dtype.kind not in "iu":
            raise RequestValidationError(
                "request {0}: prompt column {1!r} must hold integer "
                "token ids, got dtype {2}".format(
                    idx, self.prompt_col, prompt.dtype
                ),
                kind="bad_dtype", request_index=idx,
            )
        if prompt.ndim != 1:
            raise RequestValidationError(
                "request {0}: prompt column {1!r} must be 1-D, got "
                "shape {2}".format(idx, self.prompt_col, prompt.shape),
                kind="bad_shape", request_index=idx,
            )
        if prompt.shape[0] == 0:
            raise RequestValidationError(
                "request {0}: prompt column {1!r} is empty".format(
                    idx, self.prompt_col
                ),
                kind="empty_prompt", request_index=idx,
            )
        n = int(prompt.shape[0])
        if n + self.max_new > self.decoder.cache_len and not (
                n + self._row_budget(row) <= self.decoder.cache_len):
            # a row needs room for its own budget only: a fleet router
            # re-dispatches a request with its committed tokens in the
            # prompt and the rest of its budget (the reference asks for
            # max_new_tokens, and refuses a long prompt)
            raise RequestValidationError(
                "request {0}: prompt ({1} tokens) + max_new_tokens "
                "({2}) exceeds the engine cache_len={3}".format(
                    idx, n, self.max_new, self.decoder.cache_len
                ),
                kind="too_long", request_index=idx,
            )
        budget = self.max_new
        if self.budget_col is not None:
            try:
                budget = int(row[self.budget_col])
            except (TypeError, ValueError) as e:
                raise RequestValidationError(
                    "request {0}: budget column {1!r} is not an "
                    "integer: {2}".format(idx, self.budget_col, e),
                    kind="bad_budget", request_index=idx,
                )
            budget = max(1, min(budget, self.max_new))
        deadline = self.default_deadline
        if self.deadline_col is not None:
            try:
                deadline = float(row[self.deadline_col])
            except (TypeError, ValueError) as e:
                raise RequestValidationError(
                    "request {0}: deadline column {1!r} is not a "
                    "number: {2}".format(idx, self.deadline_col, e),
                    kind="bad_deadline", request_index=idx,
                )
        tenant = (validate_tenant(row, idx, self.tenant_col)
                  if self.tenant_col is not None else None)
        if self.trace_col is not None:
            tv = row[self.trace_col]
            if not isinstance(tv, str) or not tv:
                raise RequestValidationError(
                    "request {0}: trace column {1!r} must hold a "
                    "non-empty string trace id, got {2!r}".format(
                        idx, self.trace_col, tv
                    ),
                    kind="bad_trace", request_index=idx,
                )
        now = self._clock()
        return {
            "idx": idx,
            "rid": rid,
            TENANT_INPUT: tenant,
            "prompt": prompt.astype(np.int32, copy=False),
            "budget": budget,
            "eos_at": None,
            "out": None,
            "submit": now,
            "deadline_at": None if deadline is None else now + deadline,
        }

    def _row_budget(self, row):
        """The row's budget as validation will read it, or
        ``max_new`` when it has none or a malformed one (validation names
        that)."""
        if self.budget_col is None:
            return self.max_new
        try:
            return max(1, min(int(row[self.budget_col]), self.max_new))
        except (KeyError, TypeError, ValueError):
            return self.max_new

    def _record(self, idx, kind, message, tokens_done=0, partial=None):
        self._finished[idx] = error_record(
            kind, idx, message, tokens_done=tokens_done, partial=partial
        )

    def _ledger_close(self, req, tokens_out, latency_sec=None):
        self._ledger_settle(req, tokens_out=tokens_out,
                            latency_sec=latency_sec)

    def _ledger_settle(self, req, tokens_out=None, latency_sec=None,
                       close=True):
        """The request's one ledger crossing, at its terminal point: the
        admission fields and the decode cost accrued on its record
        (:meth:`_admit_free`, :meth:`_run_chunk`) settle together.
        ``close=False`` is a fleet replica's wreckage flush: a dead
        replica's spend stays on the row, which the surviving replica
        goes on with (:mod:`..fleet.replica`)."""
        self._ledger.settle(
            req["rid"], tenant=req.get(TENANT_INPUT),
            tokens_in=len(req["prompt"]),
            wire_bytes=req.pop("wire_bytes_acc", 0),
            prefix_tokens_saved=req.pop("prefix_saved_acc", 0),
            queue_wait_sec=req.pop("queue_wait_acc", 0.0),
            chip_sec=req.pop("chip_sec", 0.0),
            prefill_chip_sec=req.pop("prefill_chip_sec", 0.0),
            page_sec=req.pop("page_sec", 0.0),
            tokens_out=tokens_out, latency_sec=latency_sec, close=close,
        )

    def _pull_one(self, it):
        """Pull + validate ONE row from the source; returns a request,
        or None when the source is exhausted.  Invalid rows become
        records (``on_error="record"``) and pulling continues.

        A source may yield ``None`` as a heartbeat (no request right now:
        a fleet replica's feed between arrivals, :mod:`.fleet.replica`):
        the pull returns None without marking the source exhausted, and
        the scheduler goes on to its next chunk or lifecycle pass.  Such
        a source paces itself (blocks until a row arrives) whenever the
        engine is otherwise idle."""
        while not self._exhausted:
            try:
                row = next(it)
            except StopIteration:
                self._exhausted = True
                return None
            if row is None:
                self._idle_source = True
                return None
            idx = self._n_in
            self._n_in += 1
            rid = self._rid_of(row, idx)
            self._rids[idx] = rid
            try:
                with self._tracer.span("admission", trace=rid):
                    return self._validate(row, idx, rid)
            except RequestValidationError as e:
                if self.on_error == "raise":
                    raise
                self.stats["errors"] += 1
                self._m["errors"].inc()
                self._ledger.settle(rid, tokens_out=0)
                self._record(idx, e.kind, e)
        return None

    def _refill(self, it):
        """Policy-dependent queue refill: ``block`` pulls nothing here
        (one request per free slot at admission); ``reject`` and
        ``degrade`` drain the source eagerly, ``reject`` keeping
        ``queue_depth`` (plus the free slots) waiting and shedding the
        rest.  A draining engine pulls nothing."""
        if self.policy == "block" or self._draining:
            return
        # a free slot is admission capacity too: the refill runs just
        # before _admit_free
        cap = self.queue_depth + len(self.decoder.free_slots())
        while not self._exhausted:
            if self.policy == "reject" and len(self._pending) >= cap:
                req = self._pull_one(it)
                if req is None:
                    return
                self.stats["shed"] += 1
                self._m["shed"].inc()
                self._tracer.mark(
                    "shed", trace=req["rid"], severity="warn",
                    request_index=req["idx"], trace_id=req["rid"],
                    queue_depth=self.queue_depth,
                )
                self._ledger_close(req, tokens_out=0)
                self._record(
                    req["idx"], "shed",
                    "request {0} shed: admission queue full "
                    "({1} waiting, depth {2}, policy 'reject')".format(
                        req["idx"], len(self._pending), self.queue_depth
                    ),
                )
                continue
            req = self._pull_one(it)
            if req is None:
                return
            self._pending.append(req)

    def _expire_pending(self):
        """Queued requests whose deadline passed before a slot freed
        expire in place (typed record, nothing dispatched)."""
        now = self._clock()
        keep = []
        for req in self._pending:
            if req["deadline_at"] is not None and now > req["deadline_at"]:
                self.stats["expired"] += 1
                self._m["expired"].inc()
                # a requeued request may carry committed tokens already
                committed = [t for t in (req["out"] or [])
                             if isinstance(t, int)]
                self._ledger_close(req, tokens_out=len(committed),
                                   latency_sec=now - req["submit"])
                self._record(
                    req["idx"], "deadline",
                    "request {0} expired after {1:.3f}s waiting for a "
                    "slot (deadline {2:.3f}s)".format(
                        req["idx"], now - req["submit"],
                        req["deadline_at"] - req["submit"],
                    ),
                    tokens_done=len(committed), partial=committed,
                )
            else:
                keep.append(req)
        self._pending = keep

    def _admit_free(self, it):
        """Admit into every free slot: queued requests first, then
        (``block``) straight from the source.  A request whose prefill
        raises becomes an ``admit`` record under ``on_error="record"``.
        Returns True when at least one request was consumed."""
        progressed = False
        for slot in self.decoder.free_slots():
            if self._draining:
                # only requeued in-flight work may re-enter a draining
                # engine
                req = (self._pending.pop(0)
                       if self._pending and "resume_prompt" in
                       self._pending[0] else None)
            else:
                req = self._pending.pop(0) if self._pending else (
                    self._pull_one(it) if self.policy == "block" else None
                )
            if req is None:
                return progressed
            progressed = True
            if self.policy == "degrade" and "resume_prompt" not in req:
                # never shrink a recovered request again: its committed
                # prefix counts against its budget already
                backlog = len(self._pending)
                if backlog > self.queue_depth:
                    # backlog pressure gives back cold prefix-cache
                    # branches first (down to half the cache budget)
                    pc = getattr(self.decoder, "prefix_cache", None)
                    if pc is not None:
                        self.stats["pressure_evictions"] += pc.evict_cold(
                            pc.mem_budget_bytes // 2)
                    shrunk = max(
                        self.degrade_floor,
                        (req["budget"] * self.queue_depth) // backlog,
                    )
                    if shrunk < req["budget"]:
                        req["budget"] = shrunk
                        self.stats["degraded"] += 1
                        self._m["degraded"].inc()
            prompt = req.get("resume_prompt", req["prompt"])
            # a requeued request's committed tokens count against its
            # budget: it needs room only for the rest (the reference asks
            # for the whole budget again, and fails a long prompt)
            kw = {} if "resume_prompt" not in req else {
                "new_tokens": req["budget"] - len(req["out"] or ())}
            if not kw and req["budget"] < self.max_new:
                # a row whose own budget is what fits (a fleet
                # re-dispatch: its committed tokens are in its prompt)
                kw = {"new_tokens": req["budget"]}
            rid = req["rid"]
            wait = self._clock() - req["submit"]
            self._m_queue_wait.observe(wait)
            if self._tracer.enabled:
                # the wait ended when this admit pass reached the request
                self._tracer.add("queue_wait", time.perf_counter() - wait,
                                 wait, trace=rid)
            t_admit0 = time.perf_counter()
            try:
                # the first token comes back as an unsynchronised device
                # scalar, resolved at the next chunk boundary
                if self._prefill_worker is not None:
                    first, cached = self._admit_split(slot, prompt, rid, kw)
                else:
                    with self._tracer.span("prefill", trace=rid) as sp:
                        first = self.decoder.admit(slot, prompt, **kw)
                        cached = int(getattr(self.decoder,
                                             "last_admit_cached_tokens", 0))
                        sp.set("prefix_hit", cached > 0)
                        if cached:
                            sp.set("prefix_tokens", cached)
            except Exception as e:  # noqa: BLE001 - per-request capture
                if self.on_error == "raise":
                    raise RequestError(
                        "request {0}: admission failed: {1}".format(
                            req["idx"], e
                        ),
                        kind="admit", request_index=req["idx"],
                    ) from e
                self.stats["errors"] += 1
                self._m["errors"].inc()
                if self._prev_weights is not None:
                    # a failure inside the rollback window counts
                    # against the new generation
                    self._probation_errors += 1
                self._ledger_close(req, tokens_out=0)
                self._record(req["idx"], "admit", e)
                continue  # the slot stays free for the next request
            t_admit = time.perf_counter() - t_admit0
            self.stats["prefill_wall_sec"] += t_admit
            if cached:
                self.stats["prefix_hit_admits"] += 1
                self._m["prefix_hit_admits"].inc()
            req["out"] = list(req["out"] or []) + [first]
            req["admit_len"] = int(len(prompt))
            self.stats["admitted"] += 1
            self._m["admitted"].inc()
            if self._ledger.enabled:
                # settled at the request's end (_ledger_close); a
                # requeued request's wait since its submit includes
                # decode charged already, so only a first admit adds it
                req["prefill_chip_sec"] = req.get("prefill_chip_sec",
                                                  0.0) + t_admit
                req["wire_bytes_acc"] = req.get("wire_bytes_acc", 0) + int(
                    prompt.nbytes)
                if cached:
                    req["prefix_saved_acc"] = req.get("prefix_saved_acc",
                                                      0) + cached
                if "resume_prompt" not in req:
                    req["queue_wait_acc"] = req.get("queue_wait_acc",
                                                    0.0) + wait
            self._slot_req[slot] = req
        return progressed

    # -- disaggregated admits and their fault containment --------------

    def _admit_split(self, slot, prompt, rid, kw):
        """The disaggregated admit: the worker's prefill under the
        ``prefill`` span, then the decoder's adopt under ``handoff``, both
        on the request's trace.  A contained fault (dead worker, wedged
        prefill) re-prefills through the unified admit inside the same
        span.  Returns ``(first, cached tokens)``."""
        handoff = None
        with self._tracer.span("prefill", trace=rid) as sp:
            sp.set("disaggregated", True)
            try:
                handoff = self._prefill_dispatch(prompt, rid, kw)
            except (WatchdogTimeout, PrefillWorkerDead) as e:
                # the contained faults: a dead worker, or a prefill its
                # watchdog abandoned
                # the faulted prefill drew nothing from the generator and
                # wrote no pool, so the re-prefill is token-identical
                self._contain_prefill_fault(e, rid)
                first = self.decoder.admit(slot, prompt, **kw)
                cached = int(getattr(self.decoder,
                                     "last_admit_cached_tokens", 0))
                sp.set("prefill_recovered", True)
            else:
                cached = int(handoff.cached_tokens)
            sp.set("prefix_hit", cached > 0)
            if cached:
                sp.set("prefix_tokens", cached)
        if handoff is not None:
            try:
                with self._tracer.span("handoff", trace=rid):
                    first = self.decoder.adopt(slot, handoff)
            except Exception:
                # an un-adopted handoff never leaks its pool pages
                self._prefill_worker.abandon(handoff)
                raise
        return first, cached

    def _prefill_dispatch(self, prompt, rid, kw):
        """The worker's prefill, under the prefill watchdog when one is
        armed; ``rid`` owns the pool lease.  A wedged prefill that wakes
        after its watchdog gave up stops itself (``abandoned_fn``)."""
        worker = self._prefill_worker
        wd = self._prefill_watchdog
        if wd is None:
            return worker.prefill(prompt, owner=rid, **kw)
        return wd.call(
            lambda: worker.prefill(prompt, owner=rid,
                                   abandoned_fn=lambda: wd.abandoned, **kw),
            self.watchdog_timeout,
        )

    def _contain_prefill_fault(self, exc, rid):
        """A prefill died or wedged mid-handoff: reap its lease by owner
        (one reference per page), mark the fault at page severity (the
        flight recorder dumps), and rebuild the worker."""
        dead = not isinstance(exc, WatchdogTimeout)
        kind = "prefill_worker_dead" if dead else "prefill_watchdog_fire"
        self.stats["prefill_worker_deaths" if dead
                   else "prefill_watchdog_fires"] += 1
        reaped = self.decoder.page_pool.reap_orphans(owner=rid)
        self.stats["leases_reaped"] += len(reaped)
        pages = sum(r["pages"] for r in reaped)
        logger.warning(
            "prefill containment (%s) for request %s: %s — reaped %d "
            "lease(s) / %d page(s); re-prefilling through the unified "
            "path", kind, rid, exc, len(reaped), pages)
        self._tracer.mark(kind, trace=rid, severity="page", error=str(exc),
                          leases_reaped=len(reaped), pages_reclaimed=pages)
        self.restart_prefill_worker(reason=kind)

    def restart_prefill_worker(self, reason="operator"):
        """Rebuild the prefill worker (and its watchdog) in place: the
        containment path's actuator.  The chaos hook and the prefill
        count carry over, so that spent faults do not fire again."""
        old = self._prefill_worker
        if old is None:
            return None
        worker = PrefillWorker(self.decoder, fault_fn=old._fault,
                               lease_deadline_sec=old.lease_deadline_sec)
        worker._prefills = old._prefills
        self._prefill_worker = worker
        if self.watchdog_timeout is not None:
            # never reuse a possibly abandoned watchdog
            if self._prefill_watchdog is not None:
                self._prefill_watchdog.close()
            self._prefill_watchdog = self._new_watchdog()
        self.stats["prefill_restarts"] += 1
        self._tracer.mark("prefill_restart", trace="serve", severity="warn",
                          reason=reason)
        return worker

    def _maybe_reap(self):
        """Once per scheduling pass: reclaim the pool's handoff leases
        past their deadline (an owner that vanished unnoticed, e.g. the
        chaos ``leak_lease``), one page-severity ``lease_reaped`` mark
        each."""
        pool = getattr(self.decoder, "page_pool", None)
        if pool is None:
            return
        for r in pool.reap_orphans():
            self.stats["leases_reaped"] += 1
            self._tracer.mark(
                "lease_reaped", trace="serve", severity="page",
                owner=r["owner"], lease=r["lease"], pages=r["pages"],
                age_sec=round(r["age_sec"], 3))

    # -- decode + recovery ---------------------------------------------

    def _run_chunk(self):
        """One decode chunk, under the watchdog when one is armed;
        returns ``(tokens [B, T], valid [B])``, or None when the
        watchdog fired (the state is recovered already)."""
        idx = self._chunk_index
        self._chunk_index += 1
        t_chunk0 = time.perf_counter()
        wedge = self._wedge
        wd = self._watchdog
        if wd is None:
            if wedge is not None:
                wedge(idx)
            block = self.decoder.step_chunk()
        else:
            def dispatch():
                if wedge is not None:
                    wedge(idx)
                if wd.abandoned:
                    # timed out while the fault gate held it: never
                    # touch the decoder from the stale thread
                    return None
                # dispatch and resolve both here: a wedge in either
                # shows as no result
                return self.decoder.step_chunk()

            try:
                block = wd.call(dispatch, self.watchdog_timeout)
            except WatchdogTimeout as e:
                logger.warning("serving watchdog: %s; recovering %d "
                               "in-flight request(s)", e,
                               len(self._slot_req))
                self._recover()
                return None
        self.stats["chunks"] += 1
        self._m["chunks"].inc()
        if self._profile is not None:
            self._profile.step()
        # a host interval ending where the tokens reached the host
        dur = time.perf_counter() - t_chunk0
        self.stats["decode_wall_sec"] += dur
        if self._tracer.enabled:
            # one dispatch served every in-flight lane: the same interval
            # goes on each request's trace
            for req in self._slot_req.values():
                self._tracer.add("decode_chunk", t_chunk0, dur,
                                 trace=req["rid"], chunk=idx)
        if self._slot_req and self._ledger.enabled:
            # the chunk's wall split by live slot share (the rows sum back
            # to decode_wall_sec), and the pages each lane holds times the
            # chunk's duration; plain adds on the request's own record,
            # settled once at its end
            share = dur / len(self._slot_req)
            for req in self._slot_req.values():
                ctx = req.get("admit_len", len(req["prompt"])) + len(
                    req["out"] or ())
                req["chip_sec"] = req.get("chip_sec", 0.0) + share
                req["page_sec"] = req.get("page_sec", 0.0) + (
                    pages_for_tokens(ctx, self._page_tokens) * dur)
        self._update_reuse_stats()
        return block

    def _teardown_and_requeue(self, mark_event):
        """Shared by the watchdog and the swap path: every in-flight
        request's committed tokens are appended to its prompt, and the
        pair re-admits at the FRONT of the queue in input order (the
        lost chunk's tokens and any unresolved first token are dropped;
        deadlines keep running).  Each request gets a ``mark_event``
        mark."""
        inflight = sorted(self._slot_req.values(), key=lambda r: r["idx"])
        self._slot_req.clear()
        self.decoder.reset()
        for req in inflight:
            committed = [t for t in (req["out"] or [])
                         if isinstance(t, int)]
            req["out"] = committed
            req["resume_prompt"] = (
                np.concatenate([req["prompt"],
                                np.asarray(committed, np.int32)])
                if committed else req["prompt"]
            )
            self._tracer.mark(
                mark_event, trace=req["rid"],
                severity=("warn" if mark_event == "watchdog_recover"
                          else "info"),
                request_index=req["idx"], trace_id=req["rid"],
                tokens_committed=len(committed),
            )
        self._pending[:0] = inflight
        return inflight

    def _recover(self):
        """After a wedged chunk: tear down, requeue the in-flight
        requests from their committed tokens, and start a fresh
        watchdog (the abandoned one may still post a stale result)."""
        self.stats["watchdog_fires"] += 1
        self._m["watchdog_fires"].inc()
        if self._prev_weights is not None:
            self._probation_errors += 1
        self._tracer.mark(
            "watchdog_fire", trace="serve", severity="page",
            inflight=len(self._slot_req), chunk=self._chunk_index - 1,
        )
        recovered = self._teardown_and_requeue("watchdog_recover")
        self.stats["recovered"] += len(recovered)
        self._m["recovered"].inc(len(recovered))
        self._watchdog = self._new_watchdog()

    # -- live weight swap / rollback -----------------------------------

    def request_swap(self, params, step=None, draft_params=None):
        """Queue a manual weight swap, applied between chunks with the
        watcher's quiesce / canary / rollback contract."""
        if not callable(getattr(self.decoder, "swap_weights", None)):
            raise ValueError(
                "live weight hot-swap needs a decoder exposing "
                "swap_weights/snapshot_weights (transformer."
                "serving_builder generation decoders do); this "
                "predictor's decoder has none"
            )
        from tensorflowonspark_tpu_torch import hot_swap

        self._swap_request = hot_swap.WeightSet(
            self.stats["weight_generation"] + 1 if step is None else step,
            "<request_swap>", params, draft_params=draft_params,
        )

    def _set_generation(self):
        gen = int(getattr(self.decoder, "weight_generation", 0))
        self.stats["weight_generation"] = gen
        self._m_gen.set(gen)
        return gen

    #: the knobs :meth:`request_retune` may change: host-side scalars
    #: whose change needs no quiesce
    RETUNABLE = ("watchdog_timeout", "default_deadline", "queue_depth")

    def request_retune(self, **knobs):
        """Queue scalar knob changes, applied between chunks at the next
        scheduling pass; an unknown knob raises at once."""
        bad = sorted(set(knobs) - set(self.RETUNABLE))
        if bad:
            raise ValueError(
                "retunable engine knobs are {0}; got {1}".format(
                    self.RETUNABLE, bad
                )
            )
        self._retune_request.update(knobs)

    def _maybe_retune(self):
        if not self._retune_request:
            return
        knobs, self._retune_request = self._retune_request, {}
        applied = {}
        for name, value in knobs.items():
            old = getattr(self, name)
            if name == "queue_depth":
                value = max(1, int(value))
            elif value is not None:
                value = float(value)
            setattr(self, name, value)
            if name == "watchdog_timeout":
                if self._watchdog is not None:
                    self._watchdog.close()
                self._watchdog = self._new_watchdog()
                if self._prefill_worker is not None:
                    if self._prefill_watchdog is not None:
                        self._prefill_watchdog.close()
                    self._prefill_watchdog = self._new_watchdog()
            applied[name] = {"old": old, "new": value}
        self._tracer.mark("engine_retune", trace="planner", severity="info",
                          knobs=applied)

    def _quarantine(self, w, kind, message):
        if self.watcher is not None and w.path != "<request_swap>":
            self.watcher.quarantine_step(w, kind, message)

    def _maybe_swap(self):
        """Between chunks: roll back first when the probation window saw
        errors, then apply at most one pending swap."""
        if self._prev_weights is not None and self._probation_errors:
            self._rollback(
                "{0} device-side error(s)/wedge(s) within the first "
                "{1} requests of the new generation".format(
                    self._probation_errors, self.rollback_window
                )
            )
        if self._draining:
            return
        w, self._swap_request = self._swap_request, None
        if w is None and self.watcher is not None:
            w = self.watcher.poll()
        if w is not None:
            self._apply_swap(w)

    def _swap_event(self, event, w, requeued):
        self.stats["swap_requeued"] += len(requeued)
        self.stats["swap_events"].append({
            "event": event, "step": w.step,
            "requeued": {r["idx"]: len(r["out"]) for r in requeued},
        })

    def _apply_swap(self, w):
        """The swap transaction: quiesce in-flight requests through the
        watchdog's teardown, install the new generation, run the canary,
        and arm the rollback window (the previous weights stay
        resident)."""
        t0 = time.perf_counter()
        with self._tracer.span("swap", trace="swap", step=w.step):
            requeued = self._teardown_and_requeue("swap_requeue")
            self._swap_event("swap", w, requeued)
            snapshot = self.decoder.snapshot_weights()
            try:
                # a background ingest's copy onto the card lands first
                kw = {} if w.ready is None else {"ready": w.ready}
                self.decoder.swap_weights(w.params, w.draft_params, **kw)
            except Exception as e:  # noqa: BLE001 - typed quarantine
                # nothing was installed: serving goes on with the old
                # weights
                logger.warning("hot-swap: install of step %s refused: %s",
                               w.step, e)
                self._quarantine(w, "shape_mismatch", e)
                return
            ok = True
            if self.swap_canary:
                try:
                    ok = self.decoder.canary_check() is not False
                except Exception:  # noqa: BLE001 - the canary is a verdict
                    ok = False
            if not ok:
                self.decoder.restore_weights(snapshot)
                self.stats["rollbacks"] += 1
                self._m["swap_rollbacks"].inc()
                self._quarantine(
                    w, "canary_failed",
                    "post-install canary failed for step {0}; rolled back "
                    "to the previous generation".format(w.step),
                )
                self._tracer.mark(
                    "swap_rollback", trace="swap", severity="page",
                    step=w.step, reason="canary_failed",
                )
                self._set_generation()
                return
        self._prev_weights = (snapshot, w)
        self._probation_clean = 0
        self._probation_errors = 0
        self.stats["swaps"] += 1
        self._m["swaps"].inc()
        dt = time.perf_counter() - t0
        self.stats["swap_latency_sec"].append(round(dt, 6))
        gen = self._set_generation()
        self._tracer.mark(
            "swap_apply", trace="swap", step=w.step, generation=gen,
            requeued=len(requeued), latency_sec=round(dt, 6),
        )
        logger.info("hot-swap: step %s serving as generation %d (%d "
                    "in-flight requeued, %.1fms)", w.step, gen,
                    len(requeued), 1e3 * dt)

    def _note_clean_completion(self):
        """A completed request under probation; ``rollback_window`` of
        them commit the swap (the previous weights are let go)."""
        if self._prev_weights is None:
            return
        self._probation_clean += 1
        if self._probation_clean >= self.rollback_window:
            _snapshot, w = self._prev_weights
            self._prev_weights = None
            self.stats["swap_commits"] += 1
            self._m["swap_commits"].inc()
            self._tracer.mark(
                "swap_commit", trace="swap", step=w.step,
                clean_requests=self._probation_clean,
            )

    def _rollback(self, why):
        """Automatic rollback: requeue in-flight requests (their
        committed prefixes kept), restore the resident previous
        weights, and quarantine the step."""
        snapshot, w = self._prev_weights
        self._prev_weights = None
        self._probation_errors = 0
        requeued = self._teardown_and_requeue("swap_requeue")
        self._swap_event("rollback", w, requeued)
        self.decoder.restore_weights(snapshot)
        self.stats["rollbacks"] += 1
        self._m["swap_rollbacks"].inc()
        self._quarantine(w, "rollback",
                         "rolled back from step {0}: {1}".format(w.step, why))
        gen = self._set_generation()
        self._tracer.mark(
            "swap_rollback", trace="swap", severity="page",
            step=w.step, generation=gen, reason=why,
        )
        logger.warning("hot-swap: rolled back step %s -> generation %d "
                       "(%s)", w.step, gen, why)

    # -- graceful drain ------------------------------------------------

    def drain(self, deadline=None):
        """Begin a graceful drain: admissions stop (queued requests that
        never got a slot return ``drained`` records), in-flight requests
        run to completion, and past ``deadline`` seconds the stragglers
        are cancelled between chunks with records carrying their
        committed tokens.  :meth:`serve` then ends even if the source
        has more rows."""
        self._draining = True
        if deadline is not None:
            self._drain_deadline_at = self._clock() + float(deadline)

    def _drain_pending(self):
        keep = []
        for req in self._pending:
            if "resume_prompt" in req:
                keep.append(req)  # requeued in-flight work re-admits
                continue
            self.stats["drained"] += 1
            self._m["drained"].inc()
            self._ledger_close(req, tokens_out=0)
            self._record(
                req["idx"], "drained",
                "request {0} drained: engine stopped admissions "
                "before a slot freed".format(req["idx"]),
                tokens_done=0, partial=[],
            )
        self._pending = keep

    def _drain_cancel_slots(self, now):
        for slot, req in list(self._slot_req.items()):
            committed = [t for t in req["out"] if isinstance(t, int)]
            self.stats["drained"] += 1
            self._m["drained"].inc()
            self._ledger_close(req, tokens_out=len(committed),
                               latency_sec=now - req["submit"])
            self._record(
                req["idx"], "drained",
                "request {0} cancelled by drain deadline; {1} "
                "token(s) completed".format(req["idx"], len(committed)),
                tokens_done=len(committed), partial=committed,
            )
            self.decoder.cancel(slot)
            del self._slot_req[slot]

    # -- consume / finalize --------------------------------------------

    def _consume(self, req, chunk_row):
        """Fold a slot's chunk tokens into its request; True when the
        request completed (first eos, or its budget).  The trailing
        element of ``out`` may be the admit's unresolved device scalar:
        resolving it here is the sync the chunk pull already paid."""
        out = req["out"]
        if out and not isinstance(out[-1], int):
            last = int(out[-1])
            out[-1] = last
            if "ttft" not in req:
                req["ttft"] = self._clock() - req["submit"]
                self.stats["ttft_sec"][req["idx"]] = req["ttft"]
                self._m_ttft.observe(req["ttft"], exemplar=req["rid"])
            if self.eos_id is not None and last == self.eos_id:
                req["eos_at"] = len(out) - 1
        for t in chunk_row:
            if req["eos_at"] is not None or len(out) >= req["budget"]:
                break
            out.append(int(t))
            if self.eos_id is not None and int(t) == self.eos_id:
                req["eos_at"] = len(out) - 1
        return req["eos_at"] is not None or len(out) >= req["budget"]

    def _finalize(self, req, t_done):
        arr = np.full((self.max_new,), self._fill, np.int32)
        toks = req["out"][:self.max_new]
        arr[:len(toks)] = toks
        gen_len = (
            req["eos_at"] if req["eos_at"] is not None else req["budget"]
        )
        out = {"generated": arr}
        if self._emit_len:
            out["generated_len"] = np.int32(gen_len)
        self._finished[req["idx"]] = apply_output_mapping(
            out, self.output_mapping
        )
        lat = t_done - req["submit"]
        self.stats["completed"] += 1
        self.stats["tokens_out"] += int(gen_len)
        self.stats["latency_sec"][req["idx"]] = lat
        self.stats["done_at"][req["idx"]] = t_done - self._t0
        self._m["completed"].inc()
        # the trace id as exemplar: a tail bucket names its request
        self._m_lat.observe(lat, exemplar=req["rid"])
        self._ledger_close(req, tokens_out=int(gen_len), latency_sec=lat)
        self._note_clean_completion()

    def _expire_slot(self, slot, req, now):
        """Cancel an expired in-flight lane between chunks; its
        neighbours keep decoding undisturbed."""
        committed = [t for t in req["out"] if isinstance(t, int)]
        self.stats["expired"] += 1
        self._m["expired"].inc()
        self._tracer.mark(
            "deadline_cancel", trace=req["rid"], severity="warn",
            request_index=req["idx"], trace_id=req["rid"],
            tokens_done=len(committed),
        )
        self._ledger_close(req, tokens_out=len(committed),
                           latency_sec=now - req["submit"])
        self._record(
            req["idx"], "deadline",
            "request {0} cancelled after {1:.3f}s (deadline "
            "{2:.3f}s); {3} token(s) completed".format(
                req["idx"], now - req["submit"],
                req["deadline_at"] - req["submit"], len(committed),
            ),
            tokens_done=len(committed), partial=committed,
        )
        self.decoder.cancel(slot)
        del self._slot_req[slot]

    def _drain_ready(self):
        """Stream completed rows in input order as soon as the head of
        the reorder buffer is ready."""
        while self._emit_next in self._finished:
            self._tracer.mark("emit", trace=self._rids.pop(
                self._emit_next, "req%d" % self._emit_next))
            yield self._finished.pop(self._emit_next)
            self._emit_next += 1

    # -- the scheduling loop -------------------------------------------

    def serve(self, rows):
        """Run the engine over ``rows``; yields output rows/records in
        input order and fills ``self.stats`` (``latency_sec`` /
        ``ttft_sec`` / ``done_at`` per completed request, the scheduling
        counters, the robustness counters ``errors`` / ``shed`` /
        ``expired`` / ``degraded`` / ``watchdog_fires`` / ``recovered``
        / ``drained``, the reuse counters and the swap lifecycle's)."""
        it = iter(rows)
        try:
            while True:
                # the lifecycle first, between chunks: a probation
                # rollback, at most one swap, queued retunes
                self._maybe_swap()
                self._maybe_retune()
                self._maybe_reap()
                self._refill(it)
                self._expire_pending()
                if self._draining:
                    self._drain_pending()
                progressed = self._admit_free(it)
                yield from self._drain_ready()
                if not self._slot_req:
                    if self._draining:
                        yield from self._drain_ready()
                        return
                    if self._pending or not self._exhausted:
                        if progressed:
                            # every admit this pass failed into records;
                            # requests are still being consumed
                            continue
                        if self._idle_source:
                            # the source is alive but dry for now (a None
                            # heartbeat); it paces itself by blocking, so
                            # looping back to the lifecycle pass is no
                            # spin
                            self._idle_source = False
                            continue
                        raise RuntimeError(
                            "continuous scheduler cannot make progress "
                            "(no slots available)"
                        )
                    yield from self._drain_ready()
                    return
                block = self._run_chunk()
                if block is None:
                    continue  # the watchdog fired; state recovered
                toks, valid = block
                t_chunk = self._clock()
                for slot, req in list(self._slot_req.items()):
                    if self._consume(req, toks[slot][:int(valid[slot])]):
                        self._finalize(req, t_chunk)
                        self.decoder.evict(slot)
                        del self._slot_req[slot]
                    elif (req["deadline_at"] is not None
                          and t_chunk > req["deadline_at"]):
                        self._expire_slot(slot, req, t_chunk)
                if (self._draining
                        and self._drain_deadline_at is not None
                        and t_chunk > self._drain_deadline_at):
                    self._drain_cancel_slots(t_chunk)
                yield from self._drain_ready()
        finally:
            self._update_reuse_stats()
            if self._profile is not None:
                self._profile.stop()
            if self._watchdog is not None:
                self._watchdog.close()
            if self._prefill_watchdog is not None:
                self._prefill_watchdog.close()
            if self._own_watcher and self.watcher is not None:
                self.watcher.close()
