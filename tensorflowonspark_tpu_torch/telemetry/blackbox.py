"""Per-process flight recorder: always-on rings, dumps on faults (port of
the JAX package's ``telemetry/blackbox.py``).

Every instrumented process keeps its recent spans, journal events and
metrics in bounded rings (the tracer, journal and registry it runs
anyway); the :class:`FlightRecorder` freezes them into a dump bundle the
moment a fault event lands, before a teardown erases the evidence.

The recorder listens on the journal's bus: an event whose ``kind`` is in
:data:`DUMP_TRIGGERS`, or whose severity is ``page``, produces a dump.
In the port's serving engine that is a ``watchdog_fire`` (a wedged
decode chunk) and a ``swap_rollback`` (a weight generation rolled back).

A bundle is one JSON file (format :data:`BUNDLE_FORMAT`): the trigger
event, the journal's rings, the tracer's spans with its wall-clock epoch,
the registry's snapshot and its delta since the recorder started, and
the process's identity.  Dumps are rate-limited per trigger kind
(:data:`MIN_INTERVAL`) and capped per process (:data:`MAX_DUMPS`).

:func:`install` is the idempotent one-call setup (the serving engine
calls it); ``TFOS_BLACKBOX=0`` turns the recorder off.  Collecting dumps
from executors is the cluster side of the plane, not ported yet.
"""

import json
import logging
import os
import tempfile
import threading
import time

from tensorflowonspark_tpu_torch.telemetry import journal as _journal
from tensorflowonspark_tpu_torch.telemetry import registry as _registry
from tensorflowonspark_tpu_torch.telemetry import tracing as _tracing

logger = logging.getLogger(__name__)

#: Env kill-switch of the recorder alone: ``TFOS_BLACKBOX=0``.
BLACKBOX_ENV = "TFOS_BLACKBOX"

#: Where dumps land (``TFOS_BLACKBOX_DIR``); default
#: ``<tmp>/tfos_blackbox``.
DUMP_DIR_ENV = "TFOS_BLACKBOX_DIR"

#: Event kinds that dump whatever their severity (any ``page`` event
#: dumps too).
DUMP_TRIGGERS = frozenset({
    "watchdog_fire",
    "swap_rollback",
    "restart",
    "executor_restart",
    "restart_budget_exhausted",
    "executor_dead",
    "leader_failover",
})

#: Bundle format tag.
BUNDLE_FORMAT = "tfos-blackbox-1"

#: Per-process dump cap and per-kind rate limit in seconds.
MAX_DUMPS = int(os.environ.get("TFOS_BLACKBOX_MAX_DUMPS", "16"))
MIN_INTERVAL = float(os.environ.get("TFOS_BLACKBOX_MIN_INTERVAL", "5.0"))


def _env_enabled():
    return os.environ.get(BLACKBOX_ENV, "1").lower() not in (
        "0", "false", "off", "no",
    )


class FlightRecorder(object):
    """Always-on recorder over one process's journal, tracer and registry.

    Args:
      journal, tracer, registry: the rings to freeze (default: the
        process-wide ones).
      dump_dir: where bundles land (made at the first dump; default
        ``TFOS_BLACKBOX_DIR``, else ``<tmp>/tfos_blackbox``).
      triggers: the event kinds that dump (default
        :data:`DUMP_TRIGGERS`; ``page`` severity always dumps).
      max_dumps, min_interval: the cap per recorder and the interval per
        trigger kind.
      clock: wall-clock source (tests).
    """

    def __init__(self, journal=None, tracer=None, registry=None,
                 dump_dir=None, triggers=None, max_dumps=None,
                 min_interval=None, clock=None):
        self.journal = journal or _journal.get_journal()
        self.tracer = tracer or _tracing.get_tracer()
        self.registry = registry or _registry.get_registry()
        self.dump_dir = os.fspath(
            dump_dir
            or os.environ.get(DUMP_DIR_ENV)
            or os.path.join(tempfile.gettempdir(), "tfos_blackbox")
        )
        self.triggers = (
            DUMP_TRIGGERS if triggers is None else frozenset(triggers)
        )
        self.max_dumps = MAX_DUMPS if max_dumps is None else int(max_dumps)
        self.min_interval = (
            MIN_INTERVAL if min_interval is None else float(min_interval)
        )
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._last_dump = {}   # kind -> wall time of its last dump
        self._seq = 0
        self._started = False
        self._baseline = None
        self._m_dumps = self.registry.counter("blackbox.dumps")
        self._m_suppressed = self.registry.counter(
            "blackbox.dumps_suppressed"
        )
        #: ``{"path", "reason", "time", "executor"}`` of each dump
        self.dumps = []

    def start(self):
        """Subscribe to the journal (idempotent) and snapshot the metrics
        baseline the bundles' deltas start from."""
        with self._lock:
            if self._started:
                return self
            self._started = True
        self._baseline = self.registry.snapshot()
        self.journal.add_listener(self._on_event)
        return self

    def stop(self):
        with self._lock:
            self._started = False
        self.journal.remove_listener(self._on_event)

    def _on_event(self, ev):
        if ev.kind not in self.triggers and ev.severity != "page":
            return
        self.dump(ev.kind, trigger=ev)

    def dump(self, reason, trigger=None):
        """Freeze the rings into one bundle file; returns its path, or
        None when suppressed (the cap, the rate limit) or unwritable."""
        now = self._clock()
        with self._lock:
            if len(self.dumps) >= self.max_dumps:
                self._m_suppressed.inc()
                return None
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.min_interval:
                self._m_suppressed.inc()
                return None
            self._last_dump[reason] = now
            self._seq += 1
            seq = self._seq
        bundle = self.bundle(reason, trigger=trigger, now=now)
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir,
                "blackbox-{0}-{1:03d}-{2}.json".format(
                    os.getpid(), seq, _safe(reason)
                ),
            )
            with open(path, "w") as f:
                json.dump(bundle, f)
        except (OSError, TypeError, ValueError):
            logger.warning(
                "flight recorder could not write a dump for %r",
                reason, exc_info=True,
            )
            return None
        rec = {
            "path": path, "reason": reason, "time": now,
            "executor": self.journal.executor,
        }
        with self._lock:
            self.dumps.append(rec)
        self._m_dumps.inc()
        logger.warning(
            "flight recorder: dumped %r bundle to %s", reason, path
        )
        return path

    def bundle(self, reason, trigger=None, now=None):
        """The in-memory bundle that :meth:`dump` writes."""
        now = self._clock() if now is None else now
        delta = None
        snap = self.registry.snapshot()
        if self._baseline is not None:
            try:
                delta = _registry.snapshot_delta(snap, self._baseline)
            except Exception:  # noqa: BLE001 - the delta is advisory
                delta = None
        return {
            "format": BUNDLE_FORMAT,
            "reason": reason,
            "time": now,
            "pid": os.getpid(),
            "executor": self.journal.executor,
            "trigger": trigger.to_dict() if trigger is not None else None,
            # span t0/dur are relative to the tracer's perf_counter
            # epoch; epoch_wall puts them on the journal's wall clock
            "clock": {"epoch_wall": self.tracer.epoch_wall},
            "events": [e.to_dict() for e in self.journal.events()],
            "spans": self.tracer.spans(),
            "metrics": snap,
            "metrics_delta": delta,
        }


def _safe(name):
    return "".join(
        c if c.isalnum() or c in "-_" else "_" for c in str(name)
    )[:48]


def load_dump(path):
    """Read a bundle back; raises ``ValueError`` on any other file."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("format") != BUNDLE_FORMAT:
        raise ValueError(
            "{0} is not a {1} bundle".format(path, BUNDLE_FORMAT)
        )
    return data


_GLOBAL = None
_GLOBAL_LOCK = threading.Lock()


def install(**kwargs):
    """Start (or return) the process-wide recorder; None when it is off
    (``TFOS_BLACKBOX=0``, or telemetry disabled)."""
    global _GLOBAL
    if not _env_enabled() or not _registry.get_registry().enabled:
        return None
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = FlightRecorder(**kwargs).start()
    return _GLOBAL


def get_recorder():
    """The installed process-wide recorder, or None."""
    return _GLOBAL
