"""Process-wide metrics registry: counters, gauges, bucket histograms
(port of the JAX package's ``telemetry/registry.py``).

- A counter ``inc`` is one lock acquire and an integer add; a histogram
  ``observe`` is one ``bisect`` and a few adds.  Instrumented objects
  resolve their metrics once and keep the references, so the hot path
  never touches the registry's dict.
- One small lock per metric; the registry's own lock guards only the
  name to metric resolution.
- ``snapshot()`` returns JSON-serializable dicts; ``snapshot_delta``
  subtracts two snapshots (per-job accounting).
- A disabled registry (``TFOS_TELEMETRY=0``, or :func:`set_enabled`)
  hands out shared null singletons whose mutators do nothing.

Histograms use fixed geometric buckets (ratio 1.25 from 1e-5 to ~460
seconds), so two processes' histograms merge bucket-wise; ``p50``/``p99``
are interpolated inside the bucket the rank falls in.

The running sum of a histogram is kept with Neumaier's compensation, the
algorithm of Python 3.12's ``sum()`` over floats, so a snapshot's
``sum`` equals ``sum(values)`` bit for bit.  (The reference adds with a
plain ``+=``, whose rounding differs in the last digits.)
"""

import bisect
import math
import os
import threading
import time

#: Env kill-switch: ``TFOS_TELEMETRY=0`` disables the default registry,
#: tracer and journal, and with the registry the usage ledger.
TELEMETRY_ENV = "TFOS_TELEMETRY"


def _env_enabled():
    return os.environ.get(TELEMETRY_ENV, "1").lower() not in (
        "0", "false", "off", "no",
    )


# ----------------------------------------------------------------------
# metric types
# ----------------------------------------------------------------------


class Counter(object):
    """Monotonic counter.  ``inc`` is thread-safe (per-metric lock)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    add = inc

    @property
    def value(self):
        return self._value


class Gauge(object):
    """Last-write-wins scalar."""

    __slots__ = ("name", "_value")

    def __init__(self, name):
        self.name = name
        self._value = 0.0

    def set(self, v):
        self._value = float(v)

    @property
    def value(self):
        return self._value


def default_buckets():
    """Geometric latency buckets: 1e-5 s to ~460 s at ratio 1.25 (88
    upper bounds), fixed so that histograms merge bucket-wise."""
    out = []
    b = 1e-5
    for _ in range(88):
        out.append(b)
        b *= 1.25
    return out


class Histogram(object):
    """Fixed-bucket histogram with interpolated percentiles.

    ``observe(v)`` bumps ``v``'s bucket under the metric lock;
    ``percentile(q)`` interpolates linearly inside the bucket the q-th
    observation falls in (values above the top bound clamp to it).
    ``snapshot()`` exports the nonzero buckets as ``[lower, upper,
    count]`` triples (``upper`` None for the overflow bucket)."""

    __slots__ = (
        "name", "bounds", "_counts", "_count", "_sum", "_comp", "_min",
        "_max", "_lock", "_exemplars",
    )

    def __init__(self, name, buckets=None):
        self.name = name
        self.bounds = sorted(float(b) for b in (buckets or default_buckets()))
        # one overflow bucket past the top bound
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._comp = 0.0  # Neumaier's running compensation
        self._min = None
        self._max = None
        self._lock = threading.Lock()
        # bucket index -> (ref, value, wall ts): the newest observation
        # of each bucket that carried an exemplar (a trace id)
        self._exemplars = {}

    def observe(self, v, exemplar=None):
        """Record ``v``; ``exemplar`` (a trace id) is kept as the newest
        reference of ``v``'s bucket."""
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            s = self._sum
            t = s + v
            if abs(s) >= abs(v):
                self._comp += (s - t) + v
            else:
                self._comp += (v - t) + s
            self._sum = t
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if exemplar is not None:
                self._exemplars[i] = (str(exemplar), v, time.time())

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        with self._lock:
            return self._total()

    def _total(self):
        # as sum(): the compensation joins the sum once, at the end, and
        # never turns an infinite or overflowed sum into a NaN
        c = self._comp
        return self._sum + c if c and math.isfinite(c) else self._sum

    def percentile(self, q):
        """Interpolated q-th percentile (q in [0, 100]); 0.0 when
        empty."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        return _percentile_from_counts(counts, self.bounds, total, q)

    def snapshot(self):
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._total()
            lo, hi = self._min, self._max
            exemplars = dict(self._exemplars)
        out = {
            "count": total,
            # the exact running sum (never derived from buckets): means
            # stay exact through deltas and merges
            "sum": s,
            "min": lo,
            "max": hi,
            "p50": _percentile_from_counts(counts, self.bounds, total, 50),
            "p99": _percentile_from_counts(counts, self.bounds, total, 99),
            "buckets": [
                [
                    self.bounds[i - 1] if i > 0 else 0.0,
                    self.bounds[i] if i < len(self.bounds) else None,
                    c,
                ]
                for i, c in enumerate(counts)
                if c
            ],
        }
        if exemplars:
            out["exemplars"] = [
                [
                    self.bounds[i - 1] if i > 0 else 0.0,
                    self.bounds[i] if i < len(self.bounds) else None,
                    {"ref": ref, "value": val, "ts": ts},
                ]
                for i, (ref, val, ts) in sorted(exemplars.items())
            ]
        if total:
            out["mean"] = s / total
        return out


def _percentile_from_counts(counts, bounds, total, q):
    """The percentile rule over per-bucket counts, shared by live
    histograms, deltas and merges."""
    if not total:
        return 0.0
    rank = max(1.0, (q / 100.0) * total)
    seen = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        if seen + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (rank - seen) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        seen += c
    return bounds[-1]


def histogram_percentile(snapshot, q):
    """Percentile of a histogram snapshot (or a delta or a merge), with
    the live metric's interpolation over its bucket triples."""
    if not snapshot or not snapshot.get("count"):
        return 0.0
    triples = snapshot.get("buckets") or []
    total = int(snapshot["count"])
    rank = max(1.0, (q / 100.0) * total)
    seen = 0
    result = 0.0
    for lo, hi, c in triples:
        top = lo if hi is None else hi  # overflow clamps to its edge
        result = top
        if not c:
            continue
        if seen + c >= rank:
            frac = (rank - seen) / c
            return lo + (top - lo) * min(1.0, max(0.0, frac))
        seen += c
    return result


def tail_exemplars(snapshot, q=99):
    """Exemplars of the buckets at or above the ``q``-th percentile of a
    histogram snapshot, heaviest first: ``[{"ref", "value", "ts",
    "bucket_lo", "bucket_hi"}]``."""
    if not snapshot:
        return []
    p = histogram_percentile(snapshot, q)
    out = []
    for lo, hi, ex in snapshot.get("exemplars", []) or []:
        top = lo if hi is None else hi
        if top >= p:
            out.append(dict(ex, bucket_lo=lo, bucket_hi=hi))
    out.sort(key=lambda e: -e["value"])
    return out


# ----------------------------------------------------------------------
# null objects: the disabled-mode fast path
# ----------------------------------------------------------------------


class _NullCounter(object):
    __slots__ = ()
    name = "<disabled>"
    value = 0

    def inc(self, n=1):
        pass

    add = inc


class _NullGauge(object):
    __slots__ = ()
    name = "<disabled>"
    value = 0.0

    def set(self, v):
        pass


class _NullHistogram(object):
    __slots__ = ()
    name = "<disabled>"
    count = 0
    sum = 0.0

    def observe(self, v, exemplar=None):
        pass

    def percentile(self, q):
        return 0.0

    def snapshot(self):
        return {"count": 0, "sum": 0.0, "buckets": []}


#: Shared singletons a disabled registry hands out: its accessors
#: allocate nothing.
NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------


class MetricsRegistry(object):
    """Name to metric store; accessors get-or-create and memoize."""

    def __init__(self, enabled=None):
        self._enabled = _env_enabled() if enabled is None else bool(enabled)
        self._metrics = {}
        self._lock = threading.Lock()

    @property
    def enabled(self):
        return self._enabled

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def _get(self, name, cls, *args):
        if not self._enabled:
            return _NULLS[cls]
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    "metric {0!r} is a {1}, not a {2}".format(
                        name, type(m).__name__, cls.__name__
                    )
                )
            return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, buckets=None):
        return self._get(name, Histogram, buckets)

    def snapshot(self):
        """``{"counters": {name: int}, "gauges": {name: float},
        "histograms": {name: histogram snapshot}}``."""
        with self._lock:
            metrics = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in metrics:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out


_NULLS = {
    Counter: NULL_COUNTER,
    Gauge: NULL_GAUGE,
    Histogram: NULL_HISTOGRAM,
}


def snapshot_delta(cur, base):
    """``cur - base`` over two :meth:`MetricsRegistry.snapshot` dicts:
    counters and histogram counts, sums and buckets subtract
    (percentiles recomputed over the delta), gauges keep ``cur``'s
    value."""
    base = base or {}
    out = {"counters": {}, "gauges": dict(cur.get("gauges", {})),
           "histograms": {}}
    bc = base.get("counters", {})
    for name, v in cur.get("counters", {}).items():
        out["counters"][name] = v - bc.get(name, 0)
    bh = base.get("histograms", {})
    for name, h in cur.get("histograms", {}).items():
        b = bh.get(name)
        if not b or not b.get("count"):
            out["histograms"][name] = dict(h)
            continue
        base_counts = {
            (lo, hi): c for lo, hi, c in b.get("buckets", [])
        }
        triples = []
        for lo, hi, c in h.get("buckets", []):
            dc = c - base_counts.get((lo, hi), 0)
            if dc:
                triples.append([lo, hi, dc])
        d = {
            "count": h.get("count", 0) - b.get("count", 0),
            "sum": h.get("sum", 0.0) - b.get("sum", 0.0),
            "buckets": triples,
        }
        if h.get("exemplars"):
            # only exemplars of buckets that saw traffic in this window
            live = {(lo, hi) for lo, hi, _c in triples}
            ex = [e for e in h["exemplars"] if (e[0], e[1]) in live]
            if ex:
                d["exemplars"] = ex
        d["p50"] = histogram_percentile(d, 50)
        d["p99"] = histogram_percentile(d, 99)
        if d["count"]:
            d["mean"] = d["sum"] / d["count"]
        out["histograms"][name] = d
    return out


# ----------------------------------------------------------------------
# process-global default
# ----------------------------------------------------------------------

_GLOBAL = None
_GLOBAL_LOCK = threading.Lock()


def get_registry():
    """The process-wide registry the serving surfaces publish into."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = MetricsRegistry()
    return _GLOBAL


def enabled():
    return get_registry().enabled


def set_enabled(flag):
    """Flip the default registry and tracer.  Objects that resolved a
    null metric while disabled keep it: set the flag before building the
    surfaces to be measured."""
    reg = get_registry()
    if flag:
        reg.enable()
    else:
        reg.disable()
    from tensorflowonspark_tpu_torch.telemetry import tracing

    tracing.get_tracer().set_enabled(flag)
