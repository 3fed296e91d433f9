"""Typed event journal: the process's incident record (port of the JAX
package's ``telemetry/journal.py``).

- :class:`Event`: one typed occurrence: wall-clock ``ts``, per-process
  ``seq``, ``executor``, ``severity`` (info / warn / page), ``kind``, an
  optional ``trace`` id and a flat ``attrs`` dict; plain-dict
  serializable (``to_dict``/``from_dict``), so the two packages read
  each other's files.
- :class:`EventJournal`: the bounded per-process store, in two rings
  split by severity: routine ``info`` events and ``warn``/``page``
  faults each have their own ``deque``, so a flood of routine events
  never evicts the fault record.  Optional size-rotated JSONL
  persistence (``journal.jsonl`` -> ``journal.jsonl.1`` -> ...).
- Every :meth:`~.tracing.Tracer.mark` of an enabled tracer forwards to
  its journal (the global one by default), so the serving engine's fault
  and lifecycle marks become journal events.
- ``add_listener(fn)`` is the event bus the :mod:`.blackbox` flight
  recorder subscribes its dump triggers to.
- The shipping cursor, ``drain_unshipped()`` / ``events_since(seq)``,
  feeds the heartbeats: each node's supervisor ships new events to the
  reservation server's fleet-wide ``EventStore``
  (:mod:`..cluster.reservation`), which ``TPUCluster.journal()`` reads.

Disabled (``TFOS_TELEMETRY=0``): ``emit`` returns None and stores
nothing.
"""

import collections
import itertools
import json
import logging
import os
import threading
import time

from tensorflowonspark_tpu_torch.telemetry import registry as _registry

logger = logging.getLogger(__name__)

#: The severities; an unknown one normalizes to ``warn`` (a typo at a
#: fault site lands in the fault ring, never vanishes).
SEVERITIES = ("info", "warn", "page")

#: Ring bound per severity class (``TFOS_JOURNAL_MAX_EVENTS``).
MAX_EVENTS = int(os.environ.get("TFOS_JOURNAL_MAX_EVENTS", "4096"))

#: JSONL rotation threshold in bytes (``TFOS_JOURNAL_MAX_BYTES``) and the
#: rotated files kept (``TFOS_JOURNAL_MAX_FILES``).
MAX_BYTES = int(os.environ.get("TFOS_JOURNAL_MAX_BYTES", str(1 << 20)))
MAX_FILES = int(os.environ.get("TFOS_JOURNAL_MAX_FILES", "3"))

#: Directory of the global journal's JSONL file; unset keeps it in
#: memory only.
JOURNAL_DIR_ENV = "TFOS_JOURNAL_DIR"


class Event(object):
    """One typed journal event (see the module docstring)."""

    __slots__ = ("ts", "seq", "executor", "severity", "kind", "trace",
                 "attrs", "pid")

    def __init__(self, kind, ts=None, seq=0, executor=None,
                 severity="info", trace=None, attrs=None, pid=None):
        self.kind = str(kind)
        self.ts = time.time() if ts is None else float(ts)
        self.seq = int(seq)
        self.executor = executor
        self.severity = severity if severity in SEVERITIES else "warn"
        self.trace = trace
        self.attrs = dict(attrs) if attrs else {}
        self.pid = os.getpid() if pid is None else int(pid)

    def to_dict(self):
        out = {
            "ts": self.ts, "seq": self.seq, "kind": self.kind,
            "severity": self.severity, "pid": self.pid,
        }
        if self.executor is not None:
            out["executor"] = self.executor
        if self.trace is not None:
            out["trace"] = self.trace
        if self.attrs:
            out["attrs"] = self.attrs
        return out

    @classmethod
    def from_dict(cls, d):
        return cls(
            d.get("kind", "?"), ts=d.get("ts"), seq=d.get("seq", 0),
            executor=d.get("executor"),
            severity=d.get("severity", "info"), trace=d.get("trace"),
            attrs=d.get("attrs"), pid=d.get("pid"),
        )

    def __repr__(self):
        return "Event({0} {1} seq={2} executor={3})".format(
            self.severity, self.kind, self.seq, self.executor
        )


class EventJournal(object):
    """Bounded, optionally persisted per-process event store.

    Args:
      max_events: bound of each severity ring.
      path: JSONL base path (None: memory only).  Past ``max_bytes`` the
        live file rotates to ``path.1`` (older files shift up; the one
        past ``max_files`` is deleted).
      executor: stamped on every event.
      registry: where ``journal.events``/``journal.dropped_events`` count
        (default: the process registry).
      clock: wall-clock source (tests).
      enabled: None follows ``TFOS_TELEMETRY``.
    """

    def __init__(self, max_events=None, path=None, max_bytes=None,
                 max_files=None, executor=None, registry=None,
                 clock=None, enabled=None):
        n = MAX_EVENTS if max_events is None else int(max_events)
        self._info = collections.deque(maxlen=n)
        self._fault = collections.deque(maxlen=n)
        self.path = os.fspath(path) if path else None
        self.max_bytes = MAX_BYTES if max_bytes is None else int(max_bytes)
        self.max_files = MAX_FILES if max_files is None else int(max_files)
        self.executor = executor
        self._clock = clock or time.time
        self._enabled = (
            _registry._env_enabled() if enabled is None else bool(enabled)
        )
        self._registry = registry
        self._m_events = None
        self._m_dropped = None
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._listeners = []
        self._ship_cursor = 0
        #: events evicted from either ring
        self.dropped_events = 0

    @property
    def enabled(self):
        return self._enabled

    def set_enabled(self, flag):
        self._enabled = bool(flag)

    def set_identity(self, executor):
        """Stamp later events with this executor id (a compute process
        learns its id after the journal exists)."""
        self.executor = executor

    def add_listener(self, fn):
        """Call ``fn(event)`` after every append.  A listener that raises
        is logged and never propagates."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn):
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- recording ------------------------------------------------------

    def emit(self, kind, severity="info", trace=None, executor=None,
             attrs=None, ts=None, **extra):
        """Append one event and return it (None when disabled); ``attrs``
        and keyword extras merge into its attrs."""
        if not self._enabled:
            return None
        merged = dict(attrs) if attrs else {}
        if extra:
            merged.update(extra)
        with self._lock:
            # the seq is drawn under the lock that appends: events enter
            # the rings in seq order, so a cursor reader (``events_since``,
            # ``drain_unshipped``) never passes a seq whose event is not
            # appended yet
            ev = Event(
                kind, ts=self._clock() if ts is None else ts,
                seq=next(self._seq),
                executor=self.executor if executor is None else executor,
                severity=severity, trace=trace, attrs=merged or None,
            )
            ring = self._info if ev.severity == "info" else self._fault
            if len(ring) == ring.maxlen:
                self.dropped_events += 1
                if self._m_dropped is None:
                    self._m_dropped = self._reg().counter(
                        "journal.dropped_events"
                    )
                self._m_dropped.inc()
            ring.append(ev)
            listeners = list(self._listeners)
        if self._m_events is None:
            self._m_events = self._reg().counter("journal.events")
        self._m_events.inc()
        if self.path is not None:
            try:
                self._persist(ev)
            except OSError:
                logger.warning(
                    "journal persistence to %s failed", self.path,
                    exc_info=True,
                )
        for fn in listeners:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001 - see add_listener
                logger.warning("journal listener failed", exc_info=True)
        return ev

    def _reg(self):
        return self._registry or _registry.get_registry()

    # -- persistence ----------------------------------------------------

    def _persist(self, ev):
        line = json.dumps(ev.to_dict()) + "\n"
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        if size and size + len(line) > self.max_bytes:
            self._rotate()
        with open(self.path, "a") as f:
            f.write(line)

    def _rotate(self):
        """Shift ``path.N`` up one; the oldest past ``max_files`` goes."""
        oldest = "{0}.{1}".format(self.path, self.max_files)
        if os.path.exists(oldest):
            try:
                os.remove(oldest)
            except OSError:
                pass
        for i in range(self.max_files - 1, 0, -1):
            src = "{0}.{1}".format(self.path, i)
            if os.path.exists(src):
                try:
                    os.replace(src, "{0}.{1}".format(self.path, i + 1))
                except OSError:
                    pass
        try:
            os.replace(self.path, "{0}.1".format(self.path))
        except OSError:
            pass

    # -- queries --------------------------------------------------------

    def events(self, kind=None, severity=None, trace=None, limit=None):
        """The retained events of both rings in ``seq`` order, optionally
        filtered; ``limit`` keeps the newest N."""
        with self._lock:
            out = list(self._info) + list(self._fault)
        out.sort(key=lambda e: e.seq)
        if kind is not None:
            out = [e for e in out if e.kind == kind]
        if severity is not None:
            out = [e for e in out if e.severity == severity]
        if trace is not None:
            out = [e for e in out if e.trace == trace]
        if limit is not None:
            out = out[-int(limit):]
        return out

    def tail(self, n):
        return self.events(limit=n)

    def count(self, kind, severity=None):
        return len(self.events(kind=kind, severity=severity))

    def events_since(self, seq, limit=None):
        """Events whose ``seq`` is above the cursor ``seq`` (seqs rise
        within a process), oldest first, at most ``limit``."""
        out = [e for e in self.events() if e.seq > int(seq)]
        if limit is not None:
            out = out[: int(limit)]
        return out

    def drain_unshipped(self, limit=128):
        """Events no earlier drain returned (one consumer: the node's
        heartbeat).  The cursor moves only over what is returned, so a
        bounded drain never skips an event."""
        with self._lock:
            cursor = self._ship_cursor
        out = self.events_since(cursor, limit=limit)
        if out:
            with self._lock:
                self._ship_cursor = max(self._ship_cursor, out[-1].seq)
        return out

    def clear(self):
        with self._lock:
            self._info.clear()
            self._fault.clear()
            self._ship_cursor = 0

    def save(self, path):
        """Write every retained event as JSONL; returns ``path``."""
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev.to_dict()) + "\n")
        return path


def load_journal(path):
    """Read a JSONL journal back as ``[Event]``, rotated files
    (``path.N``, oldest first) included.  Unparseable lines (a torn last
    line of a killed process) are skipped with a warning."""
    path = os.fspath(path)
    files = []
    for i in range(MAX_FILES + 8, 0, -1):
        p = "{0}.{1}".format(path, i)
        if os.path.exists(p):
            files.append(p)
    if os.path.exists(path):
        files.append(path)
    out = []
    for p in files:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(Event.from_dict(json.loads(line)))
                except (ValueError, TypeError):
                    logger.warning("skipping unparseable journal line "
                                   "in %s", p)
    return out


_GLOBAL = None
_GLOBAL_LOCK = threading.Lock()


def get_journal():
    """The process-wide journal; it persists to
    ``$TFOS_JOURNAL_DIR/journal-<pid>.jsonl`` when that names a
    directory, and stays in memory otherwise."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                path = None
                d = os.environ.get(JOURNAL_DIR_ENV)
                if d:
                    try:
                        os.makedirs(d, exist_ok=True)
                        path = os.path.join(
                            d, "journal-{0}.jsonl".format(os.getpid())
                        )
                    except OSError:
                        logger.warning(
                            "cannot create journal dir %r; the journal "
                            "stays in memory", d, exc_info=True,
                        )
                _GLOBAL = EventJournal(path=path)
    return _GLOBAL
