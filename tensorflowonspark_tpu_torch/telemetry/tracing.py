"""Structured span tracing with id propagation and Chrome-trace export
(port of the JAX package's ``telemetry/tracing.py``).

A span is one timed region with a name, a trace id (the request it
belongs to), a span id and the enclosing span's id.  Two recording
styles:

- ``with tracer.span("prefill", trace="req3", prefix_hit=True): ...``,
  whose parent id comes from a thread-local stack;
- ``tracer.add("decode_chunk", t0, dur, trace="req3", chunk=2)``, for
  an interval timed once and attributed to several traces (the serving
  engine labels one chunk onto every in-flight request's trace).

Export is Chrome-trace JSON (``{"traceEvents": [...]}``, loadable in
Perfetto); ``ts``/``dur`` are microseconds since the tracer's epoch.
Device timelines are the job of :func:`..tensorboard.start_profile`
(``torch.profiler``); this module covers the host's scheduling story.

Disabled (``TFOS_TELEMETRY=0`` or ``set_enabled(False)``): ``span()``
returns a shared null context manager and ``add``/``mark`` do nothing.
"""

import collections
import itertools
import os
import threading
import time

from tensorflowonspark_tpu_torch.telemetry import registry as _registry

#: Bounded span store per tracer: the newest spans stay, the oldest go.
MAX_SPANS = int(os.environ.get("TFOS_TRACE_MAX_SPANS", "20000"))


class _NullSpan(object):
    """Shared no-op context manager for disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        pass


_NULL_SPAN = _NullSpan()


class _SpanCtx(object):
    """Live span context: records on ``__exit__``."""

    __slots__ = ("_tracer", "name", "trace", "attrs", "_t0", "_id",
                 "_parent")

    def __init__(self, tracer, name, trace, attrs):
        self._tracer = tracer
        self.name = name
        self.trace = trace
        self.attrs = attrs

    def set(self, key, value):
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        if self.trace is None and stack:
            self.trace = stack[-1][0]
        self._parent = stack[-1][1] if stack else None
        self._id = next(tr._ids)
        stack.append((self.trace, self._id))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        tr = self._tracer
        stack = tr._stack()
        if stack:
            stack.pop()
        tr._record(
            self.name, self.trace, self._id, self._parent,
            self._t0, dur, self.attrs,
        )
        return False


class Tracer(object):
    """Bounded in-process span store (see the module docstring).

    Args:
      enabled: None follows ``TFOS_TELEMETRY``.
      max_spans: the store's bound (default :data:`MAX_SPANS`).
      journal: the :class:`~.journal.EventJournal` every :meth:`mark`
        forwards to (None: the process-wide one).
    """

    def __init__(self, enabled=None, max_spans=None, journal=None):
        self._enabled = (
            _registry._env_enabled() if enabled is None else bool(enabled)
        )
        self._spans = collections.deque(
            maxlen=max_spans if max_spans else MAX_SPANS
        )
        self._ids = itertools.count(1)
        self._local = threading.local()
        #: spans evicted by the bounded store (also the
        #: ``tracing.dropped_spans`` counter)
        self.dropped_spans = 0
        self._m_dropped = None
        #: perf_counter at construction: span times are relative to it
        self.epoch = time.perf_counter()
        #: the wall clock at the same instant (``epoch_wall + t0`` puts a
        #: span on the journal's wall timeline)
        self.epoch_wall = time.time()
        self._journal = journal
        #: Chrome-trace process label (default ``"pid<pid>"``)
        self.process_name = None

    @property
    def enabled(self):
        return self._enabled

    def set_enabled(self, flag):
        self._enabled = bool(flag)

    # -- recording ------------------------------------------------------

    def _stack(self):
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def span(self, name, trace=None, **attrs):
        """Context manager timing a region.  ``trace`` names the request
        the span belongs to (the enclosing span's when omitted); keyword
        arguments become span attributes."""
        if not self._enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, trace, attrs or None)

    def add(self, name, t0, dur, trace=None, **attrs):
        """Record an interval measured already (``t0`` from
        ``time.perf_counter()``)."""
        if not self._enabled:
            return
        self._record(
            name, trace, next(self._ids), None, t0, dur, attrs or None
        )

    def mark(self, name, trace=None, severity="info", attrs=None,
             **extra):
        """Record an instantaneous event (a zero-duration span) with a
        ``severity`` (info / warn / page) and attributes (``attrs``
        merged with keyword extras), and forward it to the journal as a
        typed event."""
        if not self._enabled:
            return
        merged = dict(attrs) if attrs else {}
        if extra:
            merged.update(extra)
        self._record(
            name, trace, next(self._ids), None, time.perf_counter(),
            0.0, merged or None, severity=severity,
        )
        j = self._journal
        if j is None:
            from tensorflowonspark_tpu_torch.telemetry import (
                journal as _journal,
            )

            j = _journal.get_journal()
        try:
            j.emit(
                name, severity=severity, trace=trace,
                attrs=merged or None,
            )
        except Exception:  # noqa: BLE001 - the mark landed already;
            pass  # journalling never breaks the instrumented path

    def _record(self, name, trace, span_id, parent, t0, dur, attrs,
                severity=None):
        if len(self._spans) == self._spans.maxlen:
            # the deque is about to evict its oldest span: count it
            self.dropped_spans += 1
            if self._m_dropped is None:
                self._m_dropped = _registry.get_registry().counter(
                    "tracing.dropped_spans"
                )
            self._m_dropped.inc()
        rec = {
            "name": name,
            "trace": trace,
            "id": span_id,
            "t0": t0 - self.epoch,
            "dur": dur,
            "tid": threading.get_ident(),
        }
        if parent is not None:
            rec["parent"] = parent
        if attrs:
            rec["attrs"] = attrs
        if severity is not None:
            rec["severity"] = severity
        self._spans.append(rec)

    # -- introspection / export -----------------------------------------

    def spans(self, name=None, trace=None):
        """The recorded spans, optionally filtered."""
        out = list(self._spans)
        if name is not None:
            out = [s for s in out if s["name"] == name]
        if trace is not None:
            out = [s for s in out if s.get("trace") == trace]
        return out

    def clear(self):
        self._spans.clear()

    def export_chrome(self, trace=None):
        """Chrome-trace JSON object: spans as complete (``"X"``) events,
        the trace id in ``args.trace``, the parent in ``args.parent``;
        ``process_name``/``thread_name`` metadata (``"M"``) events come
        after the spans.  ``trace`` keeps one trace id's spans."""
        pid = os.getpid()
        pname = self.process_name or "pid{0}".format(pid)
        events = []
        meta = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": pname},
        }]
        tids = []
        spans = list(self._spans)
        if trace is not None:
            spans = [s for s in spans if s.get("trace") == trace]
        for s in spans:
            if s["tid"] not in tids:
                tids.append(s["tid"])
                meta.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": s["tid"],
                    "args": {"name": "thread-{0}".format(s["tid"])},
                })
            args = dict(s.get("attrs") or {})
            if s.get("trace") is not None:
                args["trace"] = s["trace"]
            if s.get("parent") is not None:
                args["parent"] = s["parent"]
            if s.get("severity") is not None:
                args["severity"] = s["severity"]
            events.append({
                "name": s["name"],
                "ph": "X",
                "ts": round(s["t0"] * 1e6, 3),
                "dur": round(s["dur"] * 1e6, 3),
                "pid": pid,
                "tid": s["tid"],
                "args": args,
            })
        return {"traceEvents": events + meta, "displayTimeUnit": "ms"}


def merge_traces(parts):
    """Merge per-process Chrome traces into one, shifting each by its
    clock offset.

    ``parts`` holds ``(trace, offset_sec, label)`` tuples or dicts with
    ``trace``/``offset``/``label`` keys: ``offset_sec`` is added to the
    part's timestamps, ``label`` names its process row.  Each part's pid
    becomes its index, so two parts with one OS pid never share a row.
    The non-metadata events come back sorted by time."""
    events = []
    meta = []
    for i, part in enumerate(parts):
        if isinstance(part, dict):
            trace = part.get("trace") or {}
            offset = float(part.get("offset", 0.0) or 0.0)
            label = part.get("label")
        else:
            trace, offset = part[0], float(part[1] or 0.0)
            label = part[2] if len(part) > 2 else None
        shift_us = offset * 1e6
        named = False
        for ev in (trace or {}).get("traceEvents", []):
            ev = dict(ev, pid=i)
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    if label is not None:
                        ev["args"] = {"name": label}
                    named = True
                meta.append(ev)
                continue
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] + shift_us, 3)
            events.append(ev)
        if not named and label is not None:
            meta.append({
                "name": "process_name", "ph": "M", "pid": i, "tid": 0,
                "args": {"name": label},
            })
    events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


_GLOBAL = None
_GLOBAL_LOCK = threading.Lock()


def get_tracer():
    """The process-wide tracer."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Tracer()
    return _GLOBAL
