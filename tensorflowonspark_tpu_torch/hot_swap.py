"""Validated live weight hot swap for the serving engine (port of the
JAX package's ``hot_swap.py``).

- **Publish**: training publishes step-numbered serving exports with
  :func:`..checkpoint.publish_for_serving` (staged, manifest last,
  published by rename), so a poller never sees a torn step.
- **Watch and validate**: :class:`CheckpointWatcher` polls the root for
  new steps and walks each through the stages below; a step that fails
  one is quarantined with a typed reason (a :data:`QUARANTINE_NAME`
  marker in its directory) and never offered again, while serving goes
  on with the old weights:

  1. *manifest*: present, parseable, ``complete: true``
     (``bad_manifest`` / ``incomplete``);
  2. *load*: :func:`..checkpoint.load_for_serving`, and the copy onto
     the watcher's ``device`` (``load_failed``);
  3. *tree/shape/dtype*: against the live decoder's
     ``SlotDecoder.param_spec`` (``tree_mismatch`` /
     ``shape_mismatch`` / ``dtype_mismatch``; the dtype KIND must
     match, ingest casts or re-quantizes);
  4. *canary*: ``canary_fn(params)`` when given (``canary_failed``).

  Ingest runs on the watcher's thread by default, so a slow store never
  stalls decode.  Its copy onto the card runs there too, on that
  thread's stream: the :class:`WeightSet` carries a CUDA event recorded
  after the copy (``ready``), which the swap waits on before it reads
  the weights.
- **Swap**: ``ServingEngine`` quiesces in-flight requests through the
  watchdog's teardown and re-admit, installs the new generation
  (``SlotDecoder.swap_weights``: a new model, re-quantized for quantized
  decoders, the prefix cache flushed), runs a canary, and keeps the
  previous generation resident until ``rollback_window`` clean requests
  commit the swap; a canary failure or an error in that window rolls
  back and quarantines the step.

Every transition is telemetry: the spans ``swap_ingest`` (here) and
``swap`` (the engine), the marks ``checkpoint_quarantined`` (here),
``swap_apply``, ``swap_commit`` and ``swap_rollback`` (the engine), and
the counters ``serving.checkpoints_quarantined``, ``serving.swaps``,
``serving.swap_commits`` and ``serving.swap_rollbacks``.
"""

import json
import logging
import os
import threading
import time

from tensorflowonspark_tpu_torch import telemetry

logger = logging.getLogger(__name__)

#: Typed quarantine marker written into a rejected step directory
QUARANTINE_NAME = "quarantine.json"

#: validation failure kinds, in stage order (module docstring)
VALIDATION_KINDS = (
    "bad_manifest", "incomplete", "load_failed", "tree_mismatch",
    "shape_mismatch", "dtype_mismatch", "canary_failed",
)


class SwapError(Exception):
    """Base for hot-swap failures."""


class CheckpointRejected(SwapError):
    """A checkpoint failed validation: its typed ``kind`` (one of
    :data:`VALIDATION_KINDS`) and ``step``, as the quarantine marker
    records them."""

    def __init__(self, message, kind, step=None):
        super().__init__(message)
        self.kind = str(kind)
        self.step = step


class WeightSet(object):
    """A validated weight generation ready to swap: the raw ``params``
    (and a ``draft`` sibling, if the export has one), the publishing
    ``step``, its directory, and ``ready``: None, or the CUDA event the
    ingest recorded after copying ``params`` onto the card."""

    def __init__(self, step, path, params, draft_params=None,
                 metadata=None, ready=None):
        self.step = int(step)
        self.path = path
        self.params = params
        self.draft_params = draft_params
        self.metadata = metadata or {}
        self.ready = ready

    def __repr__(self):
        return "WeightSet(step={0}, path={1!r})".format(self.step,
                                                       self.path)


# ----------------------------------------------------------------------
# quarantine markers
# ----------------------------------------------------------------------


def quarantine(step_dir, kind, message):
    """Write the typed quarantine marker into ``step_dir`` (the step's
    files stay for a post-mortem; the marker hides the step from every
    later poll)."""
    rec = {"kind": str(kind), "message": str(message)}
    try:
        with open(os.path.join(step_dir, QUARANTINE_NAME), "w") as f:
            json.dump(rec, f)
    except OSError:
        # the watcher still remembers the step for this session
        logger.warning("could not persist quarantine marker in %s",
                       step_dir, exc_info=True)
    return rec


def read_quarantine(step_dir):
    """The step's quarantine record, or None."""
    try:
        with open(os.path.join(step_dir, QUARANTINE_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ----------------------------------------------------------------------
# validation
# ----------------------------------------------------------------------


def _dtype_kind(dtype_str):
    """numpy's kind letter of a census dtype name (``bfloat16``, which
    numpy does not know, is a float)."""
    import numpy as np

    if str(dtype_str) == "bfloat16":
        return "f"
    try:
        return np.dtype(dtype_str).kind
    except TypeError:
        return "?"


def check_tree(expect, got_manifest):
    """Compare an ingested checkpoint's census with the live decoder's
    ``expect``; raises :class:`CheckpointRejected` of the stage's kind,
    naming the first offending leaf."""
    missing = sorted(set(expect) - set(got_manifest))
    extra = sorted(set(got_manifest) - set(expect))
    if missing or extra:
        raise CheckpointRejected(
            "param tree mismatch vs live model: missing {0}, "
            "unexpected {1}".format(missing[:4], extra[:4]),
            kind="tree_mismatch",
        )
    for path in sorted(expect):
        if got_manifest[path]["shape"] != expect[path]["shape"]:
            raise CheckpointRejected(
                "shape mismatch at {0}: live {1} vs checkpoint "
                "{2}".format(path, expect[path]["shape"],
                             got_manifest[path]["shape"]),
                kind="shape_mismatch",
            )
        if (_dtype_kind(got_manifest[path]["dtype"])
                != _dtype_kind(expect[path]["dtype"])):
            raise CheckpointRejected(
                "dtype kind mismatch at {0}: live {1} vs checkpoint "
                "{2} (exact dtype may differ — ingest re-casts; the "
                "KIND must match)".format(
                    path, expect[path]["dtype"],
                    got_manifest[path]["dtype"],
                ),
                kind="dtype_mismatch",
            )


def to_device(params, device):
    """``(tree, ready)``: every leaf of ``params`` as a tensor on
    ``device``, and on a CUDA device the event recorded on this thread's
    stream after the copies (None elsewhere).  A reader on another
    stream waits on it before reading."""
    import numpy as np
    import torch

    device = torch.device(device)

    def _leaf(x):
        if isinstance(x, dict):
            return {k: _leaf(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)

    tree = _leaf(params)
    ready = None
    if device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
    return tree, ready


def validate_checkpoint(step_dir, step, expect=None, canary_fn=None,
                        device=None):
    """Run the validation stages over one step directory and return its
    :class:`WeightSet` (its params copied onto ``device`` when one is
    given); raises :class:`CheckpointRejected` at the first failing
    stage."""
    from tensorflowonspark_tpu_torch import checkpoint as ckpt

    mpath = os.path.join(step_dir, ckpt.MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise CheckpointRejected(
            "step {0}: manifest missing — a torn or foreign "
            "directory (atomic publishes always carry one)".format(step),
            kind="bad_manifest", step=step,
        )
    manifest = ckpt.read_manifest(step_dir)
    if manifest is None:
        raise CheckpointRejected(
            "step {0}: manifest present but unparseable".format(step),
            kind="bad_manifest", step=step,
        )
    if not manifest.get("complete"):
        raise CheckpointRejected(
            "step {0}: manifest lacks complete=true (writer died "
            "mid-save?)".format(step),
            kind="incomplete", step=step,
        )
    ready = None
    try:
        params, meta = ckpt.load_for_serving(step_dir)
        if device is not None:
            params, ready = to_device(params, device)
    except Exception as e:  # noqa: BLE001 - corrupt stores throw anything
        raise CheckpointRejected(
            "step {0}: checkpoint failed to load (corrupt/truncated "
            "array files?): {1}".format(step, e),
            kind="load_failed", step=step,
        )
    draft = None
    if isinstance(params, dict) and "draft" in params:
        params = dict(params)
        draft = params.pop("draft")
    if expect is not None:
        try:
            check_tree(expect, ckpt.param_manifest(params))
        except CheckpointRejected as e:
            e.step = step
            raise
    if canary_fn is not None:
        try:
            ok = canary_fn(params)
        except Exception as e:  # noqa: BLE001 - canary faults are typed
            raise CheckpointRejected(
                "step {0}: canary raised: {1}".format(step, e),
                kind="canary_failed", step=step,
            )
        if ok is False:
            raise CheckpointRejected(
                "step {0}: canary forward pass failed (non-finite "
                "logits or explicit False)".format(step),
                kind="canary_failed", step=step,
            )
    return WeightSet(step, step_dir, params, draft_params=draft,
                     metadata=meta, ready=ready)


# ----------------------------------------------------------------------
# the watcher
# ----------------------------------------------------------------------


class CheckpointWatcher(object):
    """Poll a root of step-numbered serving exports for new weight
    generations, validating each before it can serve.

    Args:
      root: directory of :func:`..checkpoint.publish_for_serving` steps.
      poll_interval: seconds between scans.
      expect: the live census (``SlotDecoder.param_spec``) the
        tree/shape/dtype stage checks; the engine binds it when unset.
      canary_fn: optional ``fn(params) -> bool``, the last stage, run in
        the ingest thread.
      background: ingest on a daemon thread (default); ``False`` scans
        inside :meth:`poll` (deterministic, for tests).
      start_step: only steps strictly greater are offered.
      clock: monotonic clock override (tests).
      ingest_delay: seconds slept at the top of every ingest; default
        the chaos plan's ``slow_ingest`` (None without a plan).
      device: where ingest copies the weights (the engine binds its
        decoder's device when unset); None keeps host arrays.
    """

    def __init__(self, root, *, poll_interval=5.0, expect=None,
                 canary_fn=None, background=True, start_step=None,
                 clock=None, ingest_delay=None, device=None):
        self.root = os.path.abspath(os.fspath(root))
        self.poll_interval = float(poll_interval)
        self.expect = expect
        self.canary_fn = canary_fn
        self.device = device
        self._clock = clock if clock is not None else time.monotonic
        if ingest_delay is None:
            from tensorflowonspark_tpu_torch.testing import chaos

            ingest_delay = chaos.ingest_delay()
        self._ingest_delay = ingest_delay
        self._floor = -1 if start_step is None else int(start_step)
        self._lock = threading.Lock()
        self._ready = None
        self._last_scan = None
        self._quarantined = {}  # step -> record (session memory)
        self.quarantined = []   # ordered records for callers/tests
        self.stats = {"scans": 0, "ingested": 0, "quarantined": 0,
                      "offered": 0, "ingest_sec": []}
        self._tracer = telemetry.get_tracer()
        self._m_quar = telemetry.get_registry().counter(
            "serving.checkpoints_quarantined")
        self._stop = threading.Event()
        self._thread = None
        if background:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="ckpt-watcher"
            )
            self._thread.start()

    # -- scanning ------------------------------------------------------

    def _candidates(self):
        """Step numbers under root, newest first, without quarantined
        steps and those at or below the floor."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        steps = []
        for name in names:
            try:
                step = int(name)
            except ValueError:
                continue
            if step <= self._floor or step in self._quarantined:
                continue
            if read_quarantine(os.path.join(self.root, name)):
                self._quarantined[step] = True
                continue
            steps.append(step)
        return sorted(steps, reverse=True)

    def _ingest(self, step):
        step_dir = os.path.join(self.root, str(step))
        t0 = time.perf_counter()
        with self._tracer.span("swap_ingest", trace="swap", step=step):
            if self._ingest_delay:
                time.sleep(float(self._ingest_delay))
            try:
                w = validate_checkpoint(step_dir, step, expect=self.expect,
                                        canary_fn=self.canary_fn,
                                        device=self.device)
            except CheckpointRejected as e:
                self._record_quarantine(step, step_dir, e.kind, e)
                return None
        self.stats["ingested"] += 1
        self.stats["ingest_sec"].append(time.perf_counter() - t0)
        return w

    def _record_quarantine(self, step, step_dir, kind, message):
        rec = quarantine(step_dir, kind, message)
        rec["step"] = step
        self._quarantined[step] = rec
        self.quarantined.append(rec)
        self.stats["quarantined"] += 1
        self._m_quar.inc()
        self._tracer.mark(
            "checkpoint_quarantined", trace="swap", severity="warn",
            step=step, kind=kind,
        )
        logger.warning("hot-swap: quarantined checkpoint step %s (%s): %s",
                       step, kind, message)

    def _scan_once(self):
        """Validate candidates newest first until one passes (older torn
        steps still get their quarantine)."""
        self.stats["scans"] += 1
        for step in self._candidates():
            w = self._ingest(step)
            if w is not None:
                with self._lock:
                    # the newest wins: an untaken older set is superseded
                    self._ready = w
                    self._floor = max(self._floor, w.step)
                return w
        return None

    def _run(self):
        while not self._stop.wait(self.poll_interval):
            try:
                self._scan_once()
            except Exception:  # noqa: BLE001 - the watcher must survive
                logger.warning("checkpoint watcher scan failed",
                               exc_info=True)

    # -- the engine-facing surface -------------------------------------

    def poll(self):
        """The newest validated :class:`WeightSet` not taken yet, or
        None.  Never blocks on ingest in background mode; otherwise a
        scan runs inline at most every ``poll_interval`` seconds."""
        if self._thread is None:
            now = self._clock()
            if (self._last_scan is None
                    or now - self._last_scan >= self.poll_interval):
                self._last_scan = now
                self._scan_once()
        with self._lock:
            w, self._ready = self._ready, None
        if w is not None:
            self._floor = max(self._floor, w.step)
            self.stats["offered"] += 1
        return w

    def quarantine_step(self, weightset, kind, message):
        """Quarantine a step that passed validation but failed after its
        install (canary, probation errors)."""
        self._record_quarantine(weightset.step, weightset.path, kind,
                                message)

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def flag_probation_fault(engine, reason="slo_burn", count=1):
    """Count an external fault against ``engine``'s post-swap probation
    window (the rollback lands on its next scheduling pass).  True when
    a swap is on probation, False when there is nothing to roll back."""
    if getattr(engine, "_prev_weights", None) is None:
        return False
    engine._probation_errors += max(1, int(count))
    telemetry.get_tracer().mark(
        "probation_slo_fault", trace="serve", severity="warn",
        reason=str(reason),
        weight_generation=engine.stats.get("weight_generation"),
    )
    logger.warning("probation fault (%s) counted against weight "
                   "generation %s", reason,
                   engine.stats.get("weight_generation"))
    return True
