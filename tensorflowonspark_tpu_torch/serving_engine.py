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

Not ported yet (ROADMAP queue A): telemetry, the usage ledger, the
journal, tracing and the flight recorder (the ``tenant`` and
``trace_id`` reserved inputs raise ``NotImplementedError``), and
prefill/decode disaggregation.  Faults for tests come from
:mod:`.testing.chaos` (``wedge_dispatch`` through ``TFOS_CHAOS_PLAN``).
"""

import contextlib
import logging
import queue as queue_mod
import threading
import time

import numpy as np

from tensorflowonspark_tpu_torch.utils import not_ported as _not_ported

logger = logging.getLogger(__name__)

#: reserved input name: a row column mapped to it carries that request's
#: token budget (evicted after ``min(max_new, budget)`` tokens)
BUDGET_INPUT = "max_new"
#: reserved input name: a row column mapped to it carries that request's
#: deadline in seconds from submission
DEADLINE_INPUT = "deadline_sec"
#: reserved input names of the telemetry plane, not ported yet; mapping
#: a column to one raises NotImplementedError
TENANT_INPUT = "tenant"
TRACE_INPUT = "trace_id"

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


def refuse_reserved_inputs(input_mapping):
    """Raise ``NotImplementedError`` when a row column is mapped to a
    reserved input of the telemetry plane (the usage ledger's tenant,
    the trace id); both schedules call it."""
    for name, plane in ((TENANT_INPUT, "the usage ledger"),
                        (TRACE_INPUT, "request tracing")):
        if name in input_mapping.values():
            raise _not_ported(
                "the reserved input {0!r} ({1})".format(name, plane),
                "the engine's robustness and telemetry planes",
            )


def error_record(kind, request_index, message, tokens_done=0,
                 partial=None):
    """The typed record a failed, shed or expired request yields at its
    input-order position: ``{"error": {"kind", "request_index",
    "message", "tokens_done"[, "partial"]}}``.  ``kind`` is one of
    ``missing_input`` / ``bad_dtype`` / ``bad_shape`` / ``empty_prompt``
    / ``too_long`` / ``bad_budget`` / ``bad_deadline`` (validation),
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


class _DispatchWatchdog(object):
    """Runs the engine's decode chunk on a worker thread (inside
    :func:`device_scope` of ``device``) so that a wedged chunk can be
    timed out instead of hanging the scheduler.

    On a timeout the watchdog is *abandoned*: the dispatched callable
    checks :attr:`abandoned` after its fault gate and returns before it
    touches the decoder, so a stale thread never launches work beside
    the replacement's (a launch cannot be taken back).  A chunk wedged
    inside the runtime keeps its daemon thread parked."""

    def __init__(self, device=None):
        self._in = queue_mod.Queue()
        self._out = queue_mod.Queue()
        self.abandoned = False
        self._device = device
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serving-watchdog"
        )
        self._thread.start()

    def _run(self):
        with device_scope(self._device):
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
        :data:`BUDGET_INPUT` and :data:`DEADLINE_INPUT`.
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
        if disaggregate or getattr(predict, "disaggregate", False):
            raise _not_ported("prefill/decode disaggregation",
                              "disaggregation")
        refuse_reserved_inputs(input_mapping)
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
            # the swap lifecycle
            "swaps": 0, "swap_commits": 0, "rollbacks": 0,
            "swap_requeued": 0, "swap_latency_sec": [], "drained": 0,
            "swap_events": [],
            "weight_generation": int(getattr(
                self.decoder, "weight_generation", 0)),
            "kv_layout": getattr(self.decoder, "kv_layout", "contiguous"),
            "decode_wall_sec": 0.0, "prefill_wall_sec": 0.0,
            "tokens_out": 0,
        })
        self._reuse_base = dict(self._decoder_reuse_stats())
        self._pending = []      # validated, waiting for a slot
        self._slot_req = {}     # slot -> in-flight request record
        self._finished = {}     # input idx -> output row / record
        self._emit_next = 0
        self._n_in = 0
        self._exhausted = False
        self._chunk_index = 0
        self._t0 = self._clock()

    def _new_watchdog(self):
        if self.watchdog_timeout is None:
            return None
        return _DispatchWatchdog(getattr(self.decoder, "device", None))

    # -- cross-request reuse accounting --------------------------------

    def _decoder_reuse_stats(self):
        fn = getattr(self.decoder, "reuse_stats", None)
        return fn() if callable(fn) else {}

    def _update_reuse_stats(self):
        """Fold the decoder's reuse counters into ``stats`` as per-job
        deltas, and the pool gauges as their current values."""
        cur = self._decoder_reuse_stats()
        base = self._reuse_base
        for key in ("prefix_hits", "prefix_tokens_saved", "evictions"):
            if key in cur:
                self.stats[key] = int(cur[key]) - int(base.get(key, 0))
        for key in ("pool_pages", "pool_pages_used", "pool_pages_shared",
                    "pool_pages_free"):
            if key in cur:
                self.stats[key] = int(cur[key])

    # -- admission ------------------------------------------------------

    def _validate(self, row, idx):
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
        if n + self.max_new > self.decoder.cache_len:
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
        now = self._clock()
        return {
            "idx": idx,
            "prompt": prompt.astype(np.int32, copy=False),
            "budget": budget,
            "eos_at": None,
            "out": None,
            "submit": now,
            "deadline_at": None if deadline is None else now + deadline,
        }

    def _record(self, idx, kind, message, tokens_done=0, partial=None):
        self._finished[idx] = error_record(
            kind, idx, message, tokens_done=tokens_done, partial=partial
        )

    def _pull_one(self, it):
        """Pull + validate ONE row from the source; returns a request,
        or None when the source is exhausted.  Invalid rows become
        records (``on_error="record"``) and pulling continues."""
        while not self._exhausted:
            try:
                row = next(it)
            except StopIteration:
                self._exhausted = True
                return None
            idx = self._n_in
            self._n_in += 1
            try:
                return self._validate(row, idx)
            except RequestValidationError as e:
                if self.on_error == "raise":
                    raise
                self.stats["errors"] += 1
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
                # a requeued request may carry committed tokens already
                committed = [t for t in (req["out"] or [])
                             if isinstance(t, int)]
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
            prompt = req.get("resume_prompt", req["prompt"])
            # a requeued request's committed tokens count against its
            # budget: it needs room only for the rest (the reference asks
            # for the whole budget again, and fails a long prompt)
            kw = {} if "resume_prompt" not in req else {
                "new_tokens": req["budget"] - len(req["out"] or ())}
            t_admit0 = time.perf_counter()
            try:
                # the first token comes back as an unsynchronised device
                # scalar, resolved at the next chunk boundary
                first = self.decoder.admit(slot, prompt, **kw)
            except Exception as e:  # noqa: BLE001 - per-request capture
                if self.on_error == "raise":
                    raise RequestError(
                        "request {0}: admission failed: {1}".format(
                            req["idx"], e
                        ),
                        kind="admit", request_index=req["idx"],
                    ) from e
                self.stats["errors"] += 1
                if self._prev_weights is not None:
                    # a failure inside the rollback window counts
                    # against the new generation
                    self._probation_errors += 1
                self._record(req["idx"], "admit", e)
                continue  # the slot stays free for the next request
            self.stats["prefill_wall_sec"] += time.perf_counter() - t_admit0
            if int(getattr(self.decoder, "last_admit_cached_tokens", 0)):
                self.stats["prefix_hit_admits"] += 1
            req["out"] = list(req["out"] or []) + [first]
            self.stats["admitted"] += 1
            self._slot_req[slot] = req
        return progressed

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
        self.stats["decode_wall_sec"] += time.perf_counter() - t_chunk0
        self._update_reuse_stats()
        return block

    def _teardown_and_requeue(self):
        """Shared by the watchdog and the swap path: every in-flight
        request's committed tokens are appended to its prompt, and the
        pair re-admits at the FRONT of the queue in input order (the
        lost chunk's tokens and any unresolved first token are dropped;
        deadlines keep running)."""
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
        self._pending[:0] = inflight
        return inflight

    def _recover(self):
        """After a wedged chunk: tear down, requeue the in-flight
        requests from their committed tokens, and start a fresh
        watchdog (the abandoned one may still post a stale result)."""
        self.stats["watchdog_fires"] += 1
        if self._prev_weights is not None:
            self._probation_errors += 1
        recovered = self._teardown_and_requeue()
        self.stats["recovered"] += len(recovered)
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
        for name, value in knobs.items():
            if name == "queue_depth":
                value = max(1, int(value))
            elif value is not None:
                value = float(value)
            setattr(self, name, value)
            if name == "watchdog_timeout":
                if self._watchdog is not None:
                    self._watchdog.close()
                self._watchdog = self._new_watchdog()

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
        requeued = self._teardown_and_requeue()
        self._swap_event("swap", w, requeued)
        snapshot = self.decoder.snapshot_weights()
        try:
            # a background ingest's copy onto the card lands first
            kw = {} if w.ready is None else {"ready": w.ready}
            self.decoder.swap_weights(w.params, w.draft_params, **kw)
        except Exception as e:  # noqa: BLE001 - typed quarantine
            # nothing was installed: serving goes on with the old weights
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
            self._quarantine(
                w, "canary_failed",
                "post-install canary failed for step {0}; rolled back to "
                "the previous generation".format(w.step),
            )
            self._set_generation()
            return
        self._prev_weights = (snapshot, w)
        self._probation_clean = 0
        self._probation_errors = 0
        self.stats["swaps"] += 1
        dt = time.perf_counter() - t0
        self.stats["swap_latency_sec"].append(round(dt, 6))
        gen = self._set_generation()
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
            self._prev_weights = None
            self.stats["swap_commits"] += 1

    def _rollback(self, why):
        """Automatic rollback: requeue in-flight requests (their
        committed prefixes kept), restore the resident previous
        weights, and quarantine the step."""
        snapshot, w = self._prev_weights
        self._prev_weights = None
        self._probation_errors = 0
        requeued = self._teardown_and_requeue()
        self._swap_event("rollback", w, requeued)
        self.decoder.restore_weights(snapshot)
        self.stats["rollbacks"] += 1
        self._quarantine(w, "rollback",
                         "rolled back from step {0}: {1}".format(w.step, why))
        gen = self._set_generation()
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
            self._record(
                req["idx"], "drained",
                "request {0} drained: engine stopped admissions "
                "before a slot freed".format(req["idx"]),
                tokens_done=0, partial=[],
            )
        self._pending = keep

    def _drain_cancel_slots(self):
        for slot, req in list(self._slot_req.items()):
            committed = [t for t in req["out"] if isinstance(t, int)]
            self.stats["drained"] += 1
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
        self.stats["completed"] += 1
        self.stats["tokens_out"] += int(gen_len)
        self.stats["latency_sec"][req["idx"]] = t_done - req["submit"]
        self.stats["done_at"][req["idx"]] = t_done - self._t0
        self._note_clean_completion()

    def _expire_slot(self, slot, req, now):
        """Cancel an expired in-flight lane between chunks; its
        neighbours keep decoding undisturbed."""
        committed = [t for t in req["out"] if isinstance(t, int)]
        self.stats["expired"] += 1
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
                    self._drain_cancel_slots()
                yield from self._drain_ready()
        finally:
            self._update_reuse_stats()
            if self._watchdog is not None:
                self._watchdog.close()
            if self._own_watcher and self.watcher is not None:
                self.watcher.close()
