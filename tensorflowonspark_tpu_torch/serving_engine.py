"""Continuous in-flight batching over a generation predictor (the lean
port of the JAX package's ``serving_engine.py``).

:class:`ServingEngine` feeds a queue of requests into the KV-cache slots
of a :class:`~tensorflowonspark_tpu_torch.models.transformer.SlotDecoder`:
between decode chunks, finished rows (first eos, or their token budget)
are evicted and new prompts admitted into the freed lanes, so a short
request never pays a long neighbour's decode.  Outputs come back in
input order.

Ported: the ``block`` admission policy (the source iterator is the
backpressure), ``on_error="raise" | "record"`` with typed error records,
the reserved budget column, ``output_mapping``, and the stats
``admitted`` / ``chunks`` / ``completed`` / ``tokens_out`` /
``latency_sec`` / ``ttft_sec``.  Telemetry, the usage ledger, journal,
tracing, the decode watchdog, hot swap, deadlines, shedding
(``reject``/``degrade``, ``queue_depth``), disaggregation and retune
are not ported yet: asking for one raises ``NotImplementedError``.
"""

import time

import numpy as np

#: reserved input name: a row column mapped to it carries that request's
#: token budget (evicted after ``min(max_new, budget)`` tokens)
BUDGET_INPUT = "max_new"
#: reserved input names of planes not ported yet (deadlines, the usage
#: ledger, tracing); mapping a column to one raises NotImplementedError
DEADLINE_INPUT = "deadline_sec"
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
    shape/dtype, oversized prompt, bad budget value)."""


def refuse_reserved_inputs(input_mapping):
    """Raise ``NotImplementedError`` when a row column is mapped to a
    reserved input whose plane is not ported (deadlines, the usage
    ledger, tracing); both schedules call it."""
    for name, plane in ((DEADLINE_INPUT, "request deadlines"),
                        (TENANT_INPUT, "the usage ledger"),
                        (TRACE_INPUT, "request tracing")):
        if name in input_mapping.values():
            raise _not_ported(
                "the reserved input {0!r} ({1})".format(name, plane),
                "the engine's robustness and telemetry planes",
            )


def error_record(kind, request_index, message, tokens_done=0,
                 partial=None):
    """The typed record a failed request yields at its input-order
    position: ``{"error": {"kind", "request_index", "message",
    "tokens_done"[, "partial"]}}``.  ``kind`` is one of
    ``missing_input`` / ``bad_dtype`` / ``bad_shape`` / ``empty_prompt``
    / ``too_long`` / ``bad_budget`` (validation) or ``admit``."""
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


def _not_ported(what, item):
    return NotImplementedError(
        "{0} is not ported to the PyTorch package yet (ROADMAP queue A: "
        "{1})".format(what, item)
    )


class ServingEngine(object):
    """Continuous serving over a generation predictor exposing
    ``make_slot_decoder`` (``transformer.serving_builder(mode=
    "generate")``).  :meth:`serve` is a generator: feed it dict rows,
    get output rows back in INPUT order, with typed records at the
    positions of failed requests.

    Args:
      predict: the generation predictor.
      input_mapping: ``{column: input_name}``; exactly one column maps
        to the ragged prompt input, optionally one to
        :data:`BUDGET_INPUT`.
      output_mapping: optional ``{output_name: column}`` rename.
      num_slots: in-flight KV-cache slots.
      chunk: decode steps per dispatch (None = predictor default).
      on_error: ``"raise"`` or ``"record"``.
      stats: optional dict filled with the scheduling counters.
      clock: monotonic clock override (tests).
    """

    def __init__(self, predict, input_mapping, output_mapping=None,
                 num_slots=8, *, chunk=None, queue_depth=None,
                 policy="block", default_deadline=None,
                 watchdog_timeout=None, on_error="raise", stats=None,
                 clock=None, watcher=None, checkpoint_dir=None,
                 disaggregate=None):
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
        if policy != "block" or queue_depth is not None:
            raise _not_ported(
                "load shedding (policy={0!r}, queue_depth={1!r})".format(
                    policy, queue_depth
                ), "the engine's robustness planes"
            )
        if default_deadline is not None:
            raise _not_ported("request deadlines",
                              "the engine's robustness planes")
        if watchdog_timeout is not None:
            raise _not_ported("the decode watchdog",
                              "the engine's robustness planes")
        if watcher is not None or checkpoint_dir is not None:
            raise _not_ported("live weight hot swap",
                              "the engine's robustness planes")
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
        self.on_error = on_error
        self.num_slots = int(num_slots)
        self.decoder = (
            factory(self.num_slots) if chunk is None
            else factory(self.num_slots, chunk)
        )
        self.max_new = self.decoder.max_new_tokens
        self.eos_id = self.decoder.eos_id
        self._fill = self.eos_id if self.eos_id is not None else 0
        # generated_len is emitted whenever a row can stop early
        self._emit_len = self.eos_id is not None or self.budget_col is not None
        self._clock = clock if clock is not None else time.monotonic
        self.stats = stats if stats is not None else {}
        self.stats.update({
            "latency_sec": {}, "ttft_sec": {}, "admitted": 0, "chunks": 0,
            "completed": 0, "errors": 0, "tokens_out": 0,
            "decode_wall_sec": 0.0, "prefill_wall_sec": 0.0,
            "kv_layout": self.decoder.kv_layout,
        })
        self._slot_req = {}     # slot -> in-flight request record
        self._finished = {}     # input idx -> output row / record
        self._emit_next = 0
        self._n_in = 0
        self._exhausted = False

    def _update_reuse_stats(self):
        """Page-pool occupancy gauges (point-in-time values)."""
        for key, val in self.decoder.reuse_stats().items():
            if key.startswith("pool_pages"):
                self.stats[key] = int(val)

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
        except (TypeError, ValueError) as e:
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
        return {
            "idx": idx,
            "prompt": prompt.astype(np.int32, copy=False),
            "budget": budget,
            "eos_at": None,
            "out": None,
            "submit": self._clock(),
        }

    def _record(self, idx, kind, message):
        self._finished[idx] = error_record(kind, idx, message)

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

    def _admit_free(self, it):
        """Admit into every free slot straight from the source (the
        ``block`` policy).  A request whose prefill raises becomes an
        ``admit`` record under ``on_error="record"``.  Returns True when
        at least one request was consumed (admitted OR recorded)."""
        progressed = False
        for slot in self.decoder.free_slots():
            req = self._pull_one(it)
            if req is None:
                return progressed
            progressed = True
            t_admit0 = time.perf_counter()
            try:
                # the first token comes back as an unsynchronised
                # device scalar, resolved at the next chunk boundary
                first = self.decoder.admit(slot, req["prompt"])
            except Exception as e:  # noqa: BLE001 - per-request capture
                if self.on_error == "raise":
                    raise RequestError(
                        "request {0}: admission failed: {1}".format(
                            req["idx"], e
                        ),
                        kind="admit", request_index=req["idx"],
                    ) from e
                self.stats["errors"] += 1
                self._record(req["idx"], "admit", e)
                continue  # the slot stays free for the next request
            self.stats["prefill_wall_sec"] += time.perf_counter() - t_admit0
            req["out"] = [first]
            self.stats["admitted"] += 1
            self._slot_req[slot] = req
        return progressed

    # -- decode ---------------------------------------------------------

    def _run_chunk(self):
        """One decode chunk; returns ``(tokens [B, T], valid [B])``."""
        t_chunk0 = time.perf_counter()
        toks, valid = self.decoder.step_chunk()
        self.stats["chunks"] += 1
        self.stats["decode_wall_sec"] += time.perf_counter() - t_chunk0
        return toks, valid

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

    def _drain_ready(self):
        """Stream completed rows in input order as soon as the head of
        the reorder buffer is ready."""
        while self._emit_next in self._finished:
            yield self._finished.pop(self._emit_next)
            self._emit_next += 1

    # -- the scheduling loop -------------------------------------------

    def serve(self, rows):
        """Run the engine over ``rows``; yields output rows/records in
        input order and fills ``self.stats``."""
        it = iter(rows)
        try:
            while True:
                progressed = self._admit_free(it)
                yield from self._drain_ready()
                if not self._slot_req:
                    if not self._exhausted:
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
                toks, valid = self._run_chunk()
                t_chunk = self._clock()
                for slot, req in list(self._slot_req.items()):
                    if self._consume(req, toks[slot][:int(valid[slot])]):
                        self._finalize(req, t_chunk)
                        self.decoder.evict(slot)
                        del self._slot_req[slot]
                yield from self._drain_ready()
        finally:
            self._update_reuse_stats()
