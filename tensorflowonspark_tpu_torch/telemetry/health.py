"""Fleet health plane: time series, SLO burn-rate alerting, stragglers
(port of the JAX package's ``telemetry/health.py``).

The collection plane gives a one-shot merged snapshot
(``TPUCluster.metrics()``): no history, no rates, no SLO evaluation.
This module is the consumption half:

- :class:`TimeSeriesStore`: bounded per-executor ring buffers of
  ``snapshot_delta`` frames with windowed queries (``rate()``,
  ``p99_over()``, per-executor series).  A counter reset (a restarted
  executor's registry starts from zero) follows the Prometheus rule: a
  negative delta is a reset and the post-reset value is the delta, so
  rates never go negative and never count twice;
- :class:`SloEngine`: declarative rules (an ``slo.yaml`` or a plain
  dict, :func:`load_rules`) evaluated against the store: threshold rules
  (``p99 < X`` over a window) and error-budget burn-rate rules (a short
  and a long window must both burn) with hysteresis on both edges
  (``for_count`` breaches to fire, ``clear_after`` clean rounds to
  resolve).  Transitions emit :class:`Alert` records, the
  ``health.alerts_fired`` / ``health.alerts_resolved`` counters and the
  ``alert_firing`` / ``alert_resolved`` marks;
- :class:`StragglerDetector`: per-executor outliers over the windowed
  series (median absolute deviation, with a leave-one-out ratio gate so
  fleets of 2-3 nodes still detect) that names the slow executor and its
  dominant phase: ``feed`` (``train.feed_wait_sec``), ``h2d`` /
  ``dispatch`` (``train.h2d_sec`` / ``train.dispatch_sec``), ``wire``
  (``ps.round_trip_sec``), or ``host`` (step time no instrumented phase
  explains);
- :class:`HealthPlane`: the standing driver-side loop: scrape
  ``ClusterMonitor.metrics()`` (the heartbeat path: no new connections)
  every ``interval``, append frames, evaluate the rules, diagnose
  stragglers and, on a fresh straggler, ask the flagged node alone for a
  profile capture (its ``profile_request`` kv, which its
  ``telemetry.aggregate.NodePublisher`` serves).  The HTTP surface
  (``/metrics``, ``/healthz``, ``/status``, ``/usage``, ``/journal``)
  is :mod:`.exposition`.

Everything here is driver-side host work on dict snapshots: nothing
touches the training or serving loops.  The planner's sensors (the
clean-rounds gate and the drift statistic) are not ported.
"""

import collections
import json
import logging
import os
import threading
import time

from tensorflowonspark_tpu_torch.telemetry import aggregate as _aggregate
from tensorflowonspark_tpu_torch.telemetry import registry as _registry

logger = logging.getLogger(__name__)

#: Seconds between driver-side scrapes (env-tunable:
#: TFOS_HEALTH_SCRAPE_INTERVAL).  Rides the same snapshots the
#: heartbeat plane already ships, so scraping faster than the node
#: publish interval (TFOS_TELEMETRY_PUBLISH_INTERVAL, 2s) only
#: re-reads unchanged data.
SCRAPE_INTERVAL = float(os.environ.get("TFOS_HEALTH_SCRAPE_INTERVAL", "2.0"))

#: Seconds of history each per-executor ring buffer answers queries
#: over (env-tunable: TFOS_HEALTH_WINDOW).
DEFAULT_WINDOW = float(os.environ.get("TFOS_HEALTH_WINDOW", "300"))


# ----------------------------------------------------------------------
# time-series store
# ----------------------------------------------------------------------


def _reset_safe_delta(cur, base):
    """``snapshot_delta`` with Prometheus counter-reset semantics: a
    restarted executor's registry starts from zero, so ``cur - base``
    goes negative — treat that as a reset and use ``cur`` itself as
    the delta (the post-reset increments are real work; a negative
    rate or a double-count are both lies)."""
    d = _registry.snapshot_delta(cur, base or {})
    for name, v in list(d.get("counters", {}).items()):
        if v < 0:
            d["counters"][name] = cur.get("counters", {}).get(name, 0)
    bh = (base or {}).get("histograms", {})
    for name, h in list(d.get("histograms", {}).items()):
        # a restarted executor can accumulate a HIGHER count than the
        # pre-restart base (count delta positive) while individual
        # buckets shrink — any bucket going backwards (or a negative
        # count/sum delta) means the base is from a previous life, so
        # substitute the raw post-restart snapshot
        cur_h = cur.get("histograms", {}).get(name) or {}
        cur_counts = {
            (lo, hi): c for lo, hi, c in cur_h.get("buckets") or ()
        }
        b = bh.get(name) or {}
        if (
            h.get("count", 0) < 0
            or h.get("sum", 0.0) < 0
            or any(
                cur_counts.get((lo, hi), 0) < c
                for lo, hi, c in b.get("buckets") or ()
            )
        ):
            d["histograms"][name] = dict(cur_h)
    return d


class TimeSeriesStore(object):
    """Bounded per-executor ring buffers of scrape frames.

    Each :meth:`append` computes the delta vs the executor's previous
    raw snapshot (:func:`_reset_safe_delta`) and stores a *frame*
    ``{"t", "delta", "raw"}`` in a ``deque(maxlen=max_frames)`` — the
    memory bound is ``executors × max_frames × snapshot size``
    regardless of how long the fleet runs.  Queries are windowed
    (seconds back from *now*) and work per-executor or fleet-wide.
    """

    def __init__(self, window=None, max_frames=600, clock=None):
        self.window = DEFAULT_WINDOW if window is None else float(window)
        self.max_frames = int(max_frames)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._frames = {}   # eid -> deque of frames
        self._last_raw = {}  # eid -> last raw snapshot
        self.scrapes = 0

    def executors(self):
        with self._lock:
            return sorted(self._frames)

    def append(self, executor_id, snapshot, t=None):
        """Record one scraped snapshot for ``executor_id``.  Returns
        the stored frame (or None for a falsy snapshot)."""
        if not snapshot:
            return None
        eid = int(executor_id)
        t = self._clock() if t is None else float(t)
        with self._lock:
            dq = self._frames.get(eid)
            if dq is None:
                dq = self._frames[eid] = collections.deque(
                    maxlen=self.max_frames
                )
            frame = {
                "t": t,
                "delta": _reset_safe_delta(
                    snapshot, self._last_raw.get(eid)
                ),
                "raw": snapshot,
            }
            self._last_raw[eid] = snapshot
            dq.append(frame)
            self.scrapes += 1
        return frame

    # -- frame access ---------------------------------------------------

    def frames(self, executor=None, window=None):
        """Frames inside the window, newest last.  ``executor=None``
        returns every executor's (interleaved, time-ordered)."""
        window = self.window if window is None else float(window)
        cutoff = self._clock() - window
        with self._lock:
            if executor is not None:
                out = [
                    f for f in self._frames.get(int(executor), ())
                    if f["t"] >= cutoff
                ]
            else:
                out = [
                    f for dq in self._frames.values() for f in dq
                    if f["t"] >= cutoff
                ]
        out.sort(key=lambda f: f["t"])
        return out

    def latest_raw(self, executor=None):
        """Newest raw snapshot per executor (``{eid: snapshot}``), or
        one executor's."""
        with self._lock:
            if executor is not None:
                return self._last_raw.get(int(executor))
            return dict(self._last_raw)

    # -- windowed queries ----------------------------------------------

    def sum_over(self, name, window=None, executor=None):
        """Total counter increments for ``name`` inside the window."""
        return sum(
            f["delta"].get("counters", {}).get(name, 0)
            for f in self.frames(executor, window)
        )

    def rate(self, name, window=None, executor=None):
        """Counter increments per second over the window (0.0 when the
        window holds fewer than two frames — a rate needs an
        interval)."""
        frames = self.frames(executor, window)
        if len(frames) < 2:
            return 0.0
        span = frames[-1]["t"] - frames[0]["t"]
        if span <= 0:
            return 0.0
        total = sum(
            f["delta"].get("counters", {}).get(name, 0) for f in frames
        )
        return total / span

    def hist_over(self, name, window=None, executor=None):
        """Histogram activity for ``name`` inside the window: the
        bucket-wise merge of every frame's delta (exact — the fixed
        bucket scheme again), shaped like a histogram snapshot."""
        deltas = [
            {"histograms": {name: f["delta"]["histograms"][name]}}
            for f in self.frames(executor, window)
            if name in f["delta"].get("histograms", {})
        ]
        merged = _aggregate.merge_snapshots(deltas)
        return merged["histograms"].get(
            name, {"count": 0, "sum": 0.0, "buckets": []}
        )

    def p99_over(self, name, window=None, executor=None, q=99):
        """Interpolated q-th percentile of ``name`` over the window."""
        return _registry.histogram_percentile(
            self.hist_over(name, window, executor), q
        )

    def mean_over(self, name, window=None, executor=None):
        """Exact windowed mean of histogram ``name`` (sum/count from
        the exact running sums — never bucket-interpolated), or None
        when nothing was observed."""
        h = self.hist_over(name, window, executor)
        if not h.get("count"):
            return None
        return h["sum"] / h["count"]

    def gauge_last(self, name, executor=None):
        """Latest gauge value (max across executors fleet-wide — same
        rule as :func:`.aggregate.merge_snapshots`), or None when never reported."""
        raws = (
            [self.latest_raw(executor)] if executor is not None
            else list(self.latest_raw().values())
        )
        vals = [
            r["gauges"][name] for r in raws
            if r and name in r.get("gauges", {})
        ]
        return max(vals) if vals else None

    def series(self, name, executor, window=None, kind="counter"):
        """``[(t, value)]`` per-frame points for one executor — the
        plotting/debugging primitive.  ``kind``: ``counter`` (per-frame
        delta), ``gauge`` (raw value), ``hist_count`` / ``hist_mean``
        (per-frame delta count / exact mean)."""
        out = []
        for f in self.frames(executor, window):
            if kind == "counter":
                out.append((f["t"], f["delta"].get("counters", {}).get(name, 0)))
            elif kind == "gauge":
                g = f["raw"].get("gauges", {})
                if name in g:
                    out.append((f["t"], g[name]))
            else:
                h = f["delta"].get("histograms", {}).get(name)
                if not h:
                    continue
                if kind == "hist_count":
                    out.append((f["t"], h.get("count", 0)))
                elif kind == "hist_mean":
                    if h.get("count"):
                        out.append((f["t"], h["sum"] / h["count"]))
                else:
                    raise ValueError("unknown series kind %r" % kind)
        return out


# ----------------------------------------------------------------------
# SLO engine
# ----------------------------------------------------------------------


class Alert(object):
    """One typed alert transition (firing or resolved).

    Plain data: ``to_dict()`` rides the ``/status`` JSON unchanged."""

    __slots__ = ("rule", "state", "value", "threshold", "window",
                 "severity", "executor", "t", "message", "seq")

    def __init__(self, rule, state, value, threshold, window,
                 severity="warn", executor=None, t=None, message="",
                 seq=0):
        self.rule = rule
        self.state = state            # "firing" | "resolved"
        self.value = value
        self.threshold = threshold
        self.window = window
        self.severity = severity
        self.executor = executor
        self.t = time.time() if t is None else t
        self.message = message
        # monotonic per-engine transition id, stamped by SloEngine when
        # the transition enters history; cursor key for alerts_since()
        self.seq = seq

    def to_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return "Alert({0} {1}: value={2} vs {3})".format(
            self.rule, self.state, self.value, self.threshold
        )


#: Comparison ops an SLO objective may use; the RULE describes the
#: objective ("p99 < 0.5"), the alert fires on its violation.
_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}

#: Stats a threshold rule may evaluate (validated at construction so a
#: typo'd rule fails at load time, not inside the standing loop).
_STATS = ("p50", "p90", "p99", "mean", "rate", "count", "gauge")


class SloRule(object):
    """One declarative SLO rule.  Two kinds:

    - **threshold** (default): ``stat`` of ``metric`` over ``window``
      must satisfy ``op threshold`` — e.g.
      ``{"name": "serving-p99", "metric": "serving.request_latency_sec",
      "stat": "p99", "op": "<", "threshold": 0.5, "window": 30}``.
      ``stat`` ∈ p50/p90/p99 (histogram percentile), ``mean`` (exact),
      ``rate`` (counter/sec), ``count`` (counter increments), ``gauge``
      (latest value).
    - **burn_rate**: error-budget burn over a short AND a long window
      must both exceed ``burn_threshold`` — e.g.
      ``{"name": "serving-errors", "kind": "burn_rate",
      "bad": "serving.errors", "total": "serving.completed",
      "objective": 0.999, "short_window": 60, "long_window": 600,
      "burn_threshold": 2.0}`` (burn rate 1.0 = spending the budget
      exactly at the rate that exhausts it at the objective horizon).
      ``good`` may replace ``bad`` (bad = total − good).

    Hysteresis on both edges: ``for_count`` consecutive breaching
    evaluations before firing (default 1), ``clear_after`` consecutive
    clean ones before resolving (default 2).  ``per_executor: true``
    evaluates each executor's own series and names the worst offender.
    """

    def __init__(self, spec):
        spec = dict(spec)
        self.name = str(spec.pop("name"))
        self.kind = str(spec.pop("kind", "threshold"))
        self.severity = str(spec.pop("severity", "warn"))
        self.for_count = max(1, int(spec.pop("for_count", 1)))
        self.clear_after = max(1, int(spec.pop("clear_after", 2)))
        self.per_executor = bool(spec.pop("per_executor", False))
        if self.kind == "threshold":
            self.metric = str(spec.pop("metric"))
            self.stat = str(spec.pop("stat", "p99"))
            if self.stat not in _STATS:
                raise ValueError(
                    "rule {0!r}: unknown stat {1!r} (one of {2})".format(
                        self.name, self.stat, "/".join(_STATS)
                    )
                )
            self.op = str(spec.pop("op", "<"))
            if self.op not in _OPS:
                raise ValueError(
                    "rule {0!r}: unknown op {1!r}".format(self.name, self.op)
                )
            self.threshold = float(spec.pop("threshold"))
            self.window = float(spec.pop("window", 60))
        elif self.kind == "burn_rate":
            self.bad = spec.pop("bad", None)
            self.good = spec.pop("good", None)
            if not self.bad and not self.good:
                raise ValueError(
                    "burn_rate rule {0!r} needs 'bad' or 'good'".format(
                        self.name
                    )
                )
            self.total = str(spec.pop("total"))
            objective = float(spec.pop("objective"))
            if not 0.0 < objective < 1.0:
                raise ValueError(
                    "rule {0!r}: objective must be in (0, 1)".format(
                        self.name
                    )
                )
            self.budget = 1.0 - objective
            self.short_window = float(spec.pop("short_window", 60))
            self.long_window = float(spec.pop("long_window", 600))
            self.burn_threshold = float(spec.pop("burn_threshold", 2.0))
        else:
            raise ValueError(
                "rule {0!r}: unknown kind {1!r}".format(self.name, self.kind)
            )
        if spec:
            raise ValueError(
                "rule {0!r}: unknown keys {1}".format(
                    self.name, sorted(spec)
                )
            )

    # -- evaluation -----------------------------------------------------

    def _threshold_value(self, store, executor):
        if self.stat in ("p50", "p90", "p99"):
            return store.p99_over(
                self.metric, self.window, executor, q=int(self.stat[1:])
            )
        if self.stat == "mean":
            return store.mean_over(self.metric, self.window, executor)
        if self.stat == "rate":
            return store.rate(self.metric, self.window, executor)
        if self.stat == "count":
            return store.sum_over(self.metric, self.window, executor)
        if self.stat == "gauge":
            return store.gauge_last(self.metric, executor)
        raise ValueError(
            "rule {0!r}: unknown stat {1!r}".format(self.name, self.stat)
        )

    def _burn(self, store, window, executor):
        total = store.sum_over(self.total, window, executor)
        if total <= 0:
            return 0.0
        if self.bad:
            bad = store.sum_over(self.bad, window, executor)
        else:
            bad = total - store.sum_over(self.good, window, executor)
        return (bad / total) / self.budget

    def breach(self, store, executor=None):
        """``(breaching, value, threshold, window)`` for one evaluation
        of this rule against the store."""
        if self.kind == "threshold":
            v = self._threshold_value(store, executor)
            if v is None:
                return False, None, self.threshold, self.window
            return (
                not _OPS[self.op](v, self.threshold), v,
                self.threshold, self.window,
            )
        short = self._burn(store, self.short_window, executor)
        long_ = self._burn(store, self.long_window, executor)
        # multiwindow: BOTH must burn — the short window catches the
        # fast burn, the long window keeps a momentary blip from paging
        return (
            short > self.burn_threshold and long_ > self.burn_threshold,
            round(min(short, long_), 4), self.burn_threshold,
            self.long_window,
        )


def load_rules(source):
    """Normalize an SLO config into ``[SloRule]``.

    ``source`` may be: a list of rule dicts, a dict with a ``rules``
    key, a path to a ``.json`` file, or a path to a ``slo.yaml``
    written in the restricted grammar below (parsed without a yaml
    dependency — PyYAML is used when importable)::

        rules:
          - name: serving-p99
            metric: serving.request_latency_sec
            stat: p99
            op: "<"
            threshold: 0.5
            window: 30
          - name: serving-errors
            kind: burn_rate
            bad: serving.errors
            total: serving.completed
            objective: 0.999

    (one ``rules:`` list of flat ``key: value`` mappings — scalars
    only, strings optionally quoted).
    """
    if isinstance(source, (list, tuple)):
        specs = list(source)
    elif isinstance(source, dict):
        specs = list(source.get("rules", []))
    else:
        path = os.fspath(source)
        with open(path) as f:
            text = f.read()
        if path.endswith(".json"):
            data = json.loads(text)
        else:
            data = _parse_restricted_yaml(text)
        return load_rules(data)
    return [r if isinstance(r, SloRule) else SloRule(r) for r in specs]


def _parse_restricted_yaml(text):
    """Parse the restricted ``slo.yaml`` grammar (see
    :func:`load_rules`).  Prefers a real yaml parser when one is
    importable; otherwise :func:`_parse_restricted_yaml_fallback`."""
    try:
        import yaml  # noqa: PLC0415 - optional dependency

        return yaml.safe_load(text)
    except ImportError:
        return _parse_restricted_yaml_fallback(text)


def _parse_restricted_yaml_fallback(text):
    """The no-dependency parser: exactly one top-level key whose value
    is a list of flat scalar mappings (directly unit-tested so the
    grammar holds on PyYAML-less deployments too)."""
    out = {}
    key, items, cur = None, None, None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        if not raw.startswith((" ", "\t")) and line.endswith(":"):
            key = line[:-1].strip()
            items = out[key] = []
            cur = None
            continue
        stripped = line.strip()
        if stripped.startswith("- "):
            if items is None:
                raise ValueError(
                    "slo.yaml: list item before any top-level key"
                )
            cur = {}
            items.append(cur)
            stripped = stripped[2:].strip()
            if not stripped:
                continue
        if ":" not in stripped or cur is None:
            raise ValueError(
                "slo.yaml: cannot parse line {0!r} (restricted "
                "grammar: one top-level list of flat 'key: value' "
                "mappings)".format(raw)
            )
        k, v = stripped.split(":", 1)
        cur[k.strip()] = _yaml_scalar(v.strip())
    return out


def _yaml_scalar(v):
    if v.startswith(("'", '"')) and v.endswith(v[0]) and len(v) >= 2:
        return v[1:-1]
    low = v.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


class SloEngine(object):
    """Evaluates rules against a :class:`TimeSeriesStore`, tracking
    per-rule firing state with hysteresis; transitions emit
    :class:`Alert` records, registry counters, and tracer marks (see
    module docstring)."""

    MAX_HISTORY = 200

    def __init__(self, store, rules, registry=None, tracer=None):
        self.store = store
        self.rules = load_rules(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError("duplicate SLO rule names: %s" % names)
        from tensorflowonspark_tpu_torch import telemetry as _t

        self._registry = registry or _t.get_registry()
        self._tracer = tracer or _t.get_tracer()
        self._m_fired = self._registry.counter("health.alerts_fired")
        self._m_resolved = self._registry.counter("health.alerts_resolved")
        self._m_active = self._registry.gauge("health.alerts_active")
        self._state = {
            r.name: {"firing": False, "breaches": 0, "clean": 0,
                     "executor": None}
            for r in self.rules
        }
        self.history = collections.deque(maxlen=self.MAX_HISTORY)
        # monotonic transition counter; every Alert appended to history
        # carries the next value so cursor readers (alerts_since) can
        # detect both new transitions AND ones that aged out of the
        # bounded deque between polls.
        self._alert_seq = 0

    def _stamp(self, alert):
        self._alert_seq += 1
        alert.seq = self._alert_seq
        return alert

    def _evaluate_rule(self, rule):
        """Worst-case breach across the rule's scope (fleet, or each
        executor when ``per_executor``)."""
        if not rule.per_executor:
            return rule.breach(self.store) + (None,)
        worst = (False, None, None, None, None)
        for eid in self.store.executors():
            b, v, th, w = rule.breach(self.store, executor=eid)
            if b and (not worst[0] or (v or 0) > (worst[1] or 0)):
                worst = (b, v, th, w, eid)
            elif not worst[0] and worst[1] is None:
                worst = (False, v, th, w, eid)
        return worst

    def evaluate(self):
        """One evaluation round; returns the list of alert
        *transitions* (new firings + resolutions) this round."""
        transitions = []
        for rule in self.rules:
            st = self._state[rule.name]
            breaching, value, threshold, window, executor = (
                self._evaluate_rule(rule)
            )
            if breaching:
                st["breaches"] += 1
                st["clean"] = 0
                st["executor"] = executor
                if not st["firing"] and st["breaches"] >= rule.for_count:
                    st["firing"] = True
                    a = Alert(
                        rule.name, "firing", value, threshold, window,
                        severity=rule.severity, executor=executor,
                        message="{0}: {1} breached (value {2} vs {3} "
                        "over {4:.0f}s)".format(
                            rule.name, rule.kind, value, threshold,
                            window or 0,
                        ),
                    )
                    transitions.append(a)
                    self.history.append(self._stamp(a))
                    self._m_fired.inc()
                    # the mark's severity IS the rule's severity — a
                    # page-severity firing is a flight-recorder dump
                    # trigger (telemetry/blackbox.py)
                    self._tracer.mark(
                        "alert_firing", trace="slo",
                        severity=(
                            rule.severity
                            if rule.severity in ("warn", "page")
                            else "warn"
                        ),
                        rule=rule.name, value=value, threshold=threshold,
                        executor=executor,
                    )
                    logger.warning("SLO alert firing: %s", a.message)
            else:
                st["breaches"] = 0
                if st["firing"]:
                    st["clean"] += 1
                    if st["clean"] >= rule.clear_after:
                        st["firing"] = False
                        st["clean"] = 0
                        a = Alert(
                            rule.name, "resolved", value, threshold,
                            window, severity=rule.severity,
                            executor=st["executor"],
                            message="%s: recovered" % rule.name,
                        )
                        transitions.append(a)
                        self.history.append(self._stamp(a))
                        self._m_resolved.inc()
                        self._tracer.mark(
                            "alert_resolved", trace="slo", rule=rule.name,
                        )
                        logger.info("SLO alert resolved: %s", rule.name)
        self._m_active.set(
            sum(1 for s in self._state.values() if s["firing"])
        )
        return transitions

    def active(self):
        """Currently-firing alerts as plain dicts (``/status`` rides
        this)."""
        by_name = {r.name: r for r in self.rules}
        return [
            {"rule": name, "severity": by_name[name].severity,
             "executor": s["executor"]}
            for name, s in sorted(self._state.items())
            if s["firing"]
        ]

    def alert_history(self, limit=50):
        """The bounded alert history: every
        fired/resolved transition with its timestamp, newest last — so
        an operator can see what paged during a window that already
        cleared.  Rides ``/status`` (``alert_history``) and
        ``TPUCluster.metrics()["fleet"]["alert_history"]``."""
        out = [a.to_dict() for a in self.history]
        if limit is not None:
            out = out[-int(limit):]
        return out

    @property
    def last_alert_seq(self):
        """Seq of the newest transition ever stamped (0 before the
        first) — NOT the oldest one still in the bounded history."""
        return self._alert_seq

    def alerts_since(self, seq):
        """Cursor read over alert transitions (mirrors the journal's
        shipping cursors): every :class:`Alert` whose ``seq`` is
        strictly greater than ``seq``, oldest first.

        ``alert_history`` is a bounded deque, so a subscriber attaching
        late or polling slowly can miss a fired→resolved edge entirely
        if it diff's the rendered history.  A cursor makes the gap
        *detectable*: if the first returned alert's seq is not
        ``seq + 1`` (or, on an empty result, ``last_alert_seq > seq``),
        transitions aged out before the caller saw them and it should
        resync from :meth:`active` rather than assume continuity.  The
        remediation policy engine polls through this API."""
        seq = int(seq)
        return [a for a in list(self.history) if a.seq > seq]


# ----------------------------------------------------------------------
# straggler / anomaly auto-diagnosis
# ----------------------------------------------------------------------

#: The phases (spans and their histogram twins) the detector
#: attributes a straggler to.  ``host`` is the residual: step time not
#: explained by any instrumented phase.
PHASE_METRICS = (
    ("feed", "train.feed_wait_sec"),
    ("h2d", "train.h2d_sec"),
    ("dispatch", "train.dispatch_sec"),
    ("wire", "ps.round_trip_sec"),
)


def _median(values):
    vals = sorted(values)
    n = len(vals)
    if not n:
        return None
    mid = n // 2
    return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])


class StragglerDetector(object):
    """Names the slow executor and its dominant phase.

    Outlier rule over the windowed per-executor mean of ``metric``
    (default ``train.step_sec`` + the ``feed`` phase, since a stalled
    feed shows up in ``feed_wait`` rather than step time):

    - **MAD gate** (fleets of ≥4): flag executors whose mean exceeds
      ``fleet median + mad_k × 1.4826 × MAD``;
    - **ratio gate** (always, and the only gate for 2–3 node fleets
      where MAD degenerates): flag executors whose mean exceeds
      ``ratio × median of the OTHER executors`` (leave-one-out, so the
      straggler can't drag the baseline toward itself).

    An executor needs ``min_samples`` observations in the window to be
    judged (quiet nodes are a liveness question, not a straggler one).
    Attribution: the phase with the largest per-step excess over the
    peer median; if no instrumented phase explains at least
    ``phase_floor`` of the step-time excess, the phase is ``host``.
    """

    def __init__(self, store, window=60.0, mad_k=3.5, ratio=2.0,
                 min_samples=3, phase_floor=0.3):
        self.store = store
        self.window = float(window)
        self.mad_k = float(mad_k)
        self.ratio = float(ratio)
        self.min_samples = int(min_samples)
        self.phase_floor = float(phase_floor)

    def _per_executor_means(self, metric):
        out = {}
        for eid in self.store.executors():
            h = self.store.hist_over(metric, self.window, eid)
            if h.get("count", 0) >= self.min_samples:
                out[eid] = h["sum"] / h["count"]
        return out

    def _outliers(self, means):
        if len(means) < 2:
            return {}
        flagged = {}
        values = list(means.values())
        med = _median(values)
        mad = _median([abs(v - med) for v in values]) or 0.0
        mad_gate = med + self.mad_k * 1.4826 * mad
        for eid, v in means.items():
            peers = [m for e, m in means.items() if e != eid]
            peer_med = _median(peers)
            if peer_med is None or peer_med <= 0:
                continue
            if v > self.ratio * peer_med and (
                len(means) < 4 or v > mad_gate
            ):
                flagged[eid] = {
                    "value": v, "peer_median": peer_med,
                    "excess": v - peer_med,
                }
            # an executor *behind in wall-clock* but with a normal mean
            # is a liveness/feed question — not flagged here
        return flagged

    def _dominant_phase(self, eid, means_by_phase, step_excess):
        """The phase whose per-step excess over the peer median is
        largest; ``host`` when no phase explains the step excess."""
        best, best_excess = None, 0.0
        for phase, _metric in PHASE_METRICS:
            means = means_by_phase.get(phase) or {}
            if eid not in means or len(means) < 2:
                continue
            peers = [m for e, m in means.items() if e != eid]
            peer_med = _median(peers) or 0.0
            excess = means[eid] - peer_med
            if excess > best_excess:
                best, best_excess = phase, excess
        if best is None:
            return "host", 0.0
        # feed stalls live OUTSIDE step time, so a feed excess stands
        # on its own; device/host phases must explain the step excess
        if best != "feed" and step_excess > 0 and (
            best_excess < self.phase_floor * step_excess
        ):
            return "host", best_excess
        return best, best_excess

    def diagnose(self):
        """One detection round → ``[straggler dict]`` (empty when the
        fleet is even).  Each dict names the executor, the dominant
        phase, and the measured excess."""
        step_means = self._per_executor_means("train.step_sec")
        feed_means = self._per_executor_means("train.feed_wait_sec")
        # an executor can be step-normal but feed-starved: judge the
        # sum of both as its per-step wall contribution
        combined = {}
        for eid in set(step_means) | set(feed_means):
            combined[eid] = (
                step_means.get(eid, 0.0) + feed_means.get(eid, 0.0)
            )
        flagged = self._outliers(combined)
        if not flagged:
            return []
        means_by_phase = {
            phase: self._per_executor_means(metric)
            for phase, metric in PHASE_METRICS
        }
        out = []
        for eid, info in sorted(flagged.items()):
            step_excess = info["excess"]
            phase, phase_excess = self._dominant_phase(
                eid, means_by_phase, step_excess
            )
            out.append({
                "executor": eid,
                "phase": phase,
                "step_sec": round(info["value"], 6),
                "fleet_median_sec": round(info["peer_median"], 6),
                "excess_sec": round(step_excess, 6),
                "phase_excess_sec": round(phase_excess, 6),
                "window": self.window,
            })
        return out


class CleanRoundsSensor(object):
    """Quality gate over the health plane: ready after ``rounds``
    CONSECUTIVE clean health rounds (no straggler hints, no firing SLO
    alerts), not after a timer.

    A round is one plane scrape (keyed off ``plane.store.scrapes``, which
    advances only when the scrape loop appends frames), so callers may
    :meth:`poll` as often as they like: polls between scrapes fold into
    the same round, and the streak advances at most once a round.  Any
    dirty round resets the streak to zero.

    The fleet router's ``readmit_gate`` reads it: a slow replica with
    enough clean probe rounds still waits for the plane, and the router
    journals ``readmit_gated`` / ``readmit_cleared`` transitions.
    """

    def __init__(self, plane, rounds=3):
        self.plane = plane
        self.rounds = max(1, int(rounds))
        self.streak = 0
        self._last_round = None

    def dirty(self):
        """Is the CURRENT plane state unhealthy?  (straggler hints or
        firing SLO alerts, the signals ``/status`` surfaces)"""
        if getattr(self.plane, "hints", None):
            return True
        slo = getattr(self.plane, "slo", None)
        return slo is not None and bool(slo.active())

    def poll(self):
        """Score the current health round; returns :meth:`ready`.
        Idempotent within a round; a dirty observation resets the streak
        even mid-round (unhealth is never smoothed away)."""
        round_id = getattr(getattr(self.plane, "store", None), "scrapes",
                           None)
        if self.dirty():
            self.streak = 0
            self._last_round = round_id
            return False
        if round_id is None or round_id != self._last_round:
            self.streak += 1
            self._last_round = round_id
        return self.ready()

    def ready(self):
        return self.streak >= self.rounds

    def reset(self):
        self.streak = 0
        self._last_round = None


# ----------------------------------------------------------------------
# /status providers (serving engine, cluster ledger, ...)
# ----------------------------------------------------------------------

_STATUS_PROVIDERS = {}
_STATUS_LOCK = threading.Lock()


def register_status_provider(name, fn):
    """Register a zero-arg callable whose small dict rides the
    ``/status`` summary under ``name`` (latest registration wins — a
    new ServingEngine replaces its predecessor's entry).  A raising
    provider is reported as ``{"error": ...}``, never propagated."""
    with _STATUS_LOCK:
        _STATUS_PROVIDERS[str(name)] = fn


def unregister_status_provider(name):
    with _STATUS_LOCK:
        _STATUS_PROVIDERS.pop(str(name), None)


def provider_statuses():
    with _STATUS_LOCK:
        providers = list(_STATUS_PROVIDERS.items())
    out = {}
    for name, fn in providers:
        try:
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 - status is best effort
            out[name] = {"error": str(e)}
    return out


# ----------------------------------------------------------------------
# the standing health plane
# ----------------------------------------------------------------------


class HealthPlane(object):
    """Driver-side scrape → store → SLO → straggler loop.

    Args:
      metrics_fn: zero-arg callable returning the per-executor view —
        ``{eid: {"metrics": snapshot, "heartbeat_age": ..., ...}}``
        (exactly ``ClusterMonitor.metrics()``; :meth:`local` wraps a
        single process's own registry for serving-only deployments).
      interval: seconds between scrapes (default
        :data:`SCRAPE_INTERVAL`).
      window: ring-buffer query horizon (default
        :data:`DEFAULT_WINDOW`).
      slo: SLO rule config (anything :func:`load_rules` accepts), or
        None for no rules.
      straggler: enable the :class:`StragglerDetector` (kwargs via
        ``straggler_opts``).
      on_straggler: ``fn(hint_dict)`` called ONCE per (executor, phase)
        flag — the profiler trigger (``TPUCluster.start_health_plane``
        wires it to the flagged node's ``profile_request`` kv).  The
        dedup clears when the executor recovers (see
        ``straggler_clear_rounds``), so a regression that recurs after
        a recovery fires the hook again.
      on_straggler_cleared: ``fn(executor_id)`` called when a
        previously-flagged executor has been absent from
        ``straggler_clear_rounds`` consecutive diagnosis rounds — the
        recovery mirror of ``on_straggler``
        (``TPUCluster.start_health_plane`` wires it to clear the
        node's ``health_hint`` kv so its ``health.straggler`` gauge
        drops).
      straggler_clear_rounds: consecutive clean diagnosis rounds
        before a straggler hint expires from ``/status`` and the
        (executor, phase) dedup resets.
      liveness_fn: zero-arg callable returning the liveness health
        summary (``reservation.Liveness.health()``); feeds
        ``/healthz``.
      max_snapshot_age: scraped snapshots older than this (the
        ``metrics_age`` field — executor stopped publishing) are
        SKIPPED instead of re-appended, so a dead node's last frame is
        never double-counted into rates.
      merge_own_registry: append this (driver) process's own registry
        snapshot to :meth:`merged_snapshot`.  :meth:`local` turns this
        OFF when the scraped registry IS the plane's registry —
        otherwise every local-mode metric would be exposed doubled.
    """

    def __init__(self, metrics_fn, interval=None, window=None, slo=None,
                 straggler=True, straggler_opts=None, on_straggler=None,
                 on_straggler_cleared=None, straggler_clear_rounds=5,
                 liveness_fn=None, max_snapshot_age=None, registry=None,
                 merge_own_registry=True, journal_fn=None):
        self.metrics_fn = metrics_fn
        #: zero-arg callable backing the ``/journal`` route: the fleet
        #: event record (``TPUCluster.start_health_plane`` wires the
        #: reservation server's EventStore; default = this process's
        #: own journal — the local/serving-only shape)
        self.journal_fn = journal_fn
        self.interval = SCRAPE_INTERVAL if interval is None else float(
            interval
        )
        self.store = TimeSeriesStore(window=window)
        self.slo = (
            SloEngine(self.store, slo, registry=registry)
            if slo else None
        )
        self.detector = (
            StragglerDetector(self.store, **(straggler_opts or {}))
            if straggler else None
        )
        self.on_straggler = on_straggler
        self.on_straggler_cleared = on_straggler_cleared
        self.straggler_clear_rounds = max(1, int(straggler_clear_rounds))
        self.merge_own_registry = bool(merge_own_registry)
        self.liveness_fn = liveness_fn
        self.max_snapshot_age = (
            3 * self.interval if max_snapshot_age is None
            else float(max_snapshot_age)
        )
        from tensorflowonspark_tpu_torch import telemetry as _t

        self._registry = registry or _t.get_registry()
        self._tracer = _t.get_tracer()
        self._m_scrapes = self._registry.counter("health.scrapes")
        self._m_flagged = self._registry.counter(
            "health.stragglers_flagged"
        )
        self._m_cleared = self._registry.counter(
            "health.stragglers_cleared"
        )
        #: executor → newest straggler hint (also pushed to
        #: ``on_straggler`` and visible in ``/status``); expires after
        #: ``straggler_clear_rounds`` clean diagnosis rounds
        self.hints = {}
        self._hinted = set()  # (executor, phase) already actioned
        self._clean_rounds = {}  # executor → consecutive unflagged rounds
        #: push subscribers (``fn(alert)`` per SLO transition, called
        #: from the scrape thread); the remediation engine prefers the
        #: pull-side ``slo.alerts_since`` cursor, but push consumers
        #: (recorders, paging bridges) hook here
        self._alert_listeners = []
        self.started_at = time.time()
        self._stop = threading.Event()
        self._thread = None
        self._exposition = None
        # arm the process-wide flight recorder: the executor_dead /
        # page-alert marks this plane emits are dump triggers
        # (telemetry/blackbox.py; None when disabled)
        from tensorflowonspark_tpu_torch.telemetry import (
            blackbox as _blackbox,
        )

        _blackbox.install()

    @classmethod
    def local(cls, registry=None, **kwargs):
        """A single-process plane scraping this process's own registry
        as executor 0 (the serving-only deployment).
        The plane's own counters live in the scraped registry, which
        is therefore NOT re-appended by :meth:`merged_snapshot`
        (otherwise every metric on ``/metrics`` would read doubled)."""
        from tensorflowonspark_tpu_torch import telemetry as _t

        reg = registry or _t.get_registry()

        def metrics_fn():
            return {0: {"metrics": reg.snapshot(), "metrics_age": 0.0}}

        kwargs.setdefault("merge_own_registry", False)
        return cls(metrics_fn, registry=reg, **kwargs)

    @classmethod
    def for_reservation_server(cls, server, **kwargs):
        """A plane scraping a bare
        :class:`~..cluster.reservation.Server`
        directly (no cluster handle) — lets the rendezvous process
        itself expose ``/metrics``/``/healthz`` when the driver isn't
        running the full :class:`~..cluster.cluster.TPUCluster` plane."""

        def metrics_fn():
            per = {}
            for eid_s, rec in server.metrics.snapshot().items():
                per[int(eid_s)] = {
                    "metrics": rec["metrics"], "metrics_age": rec["age"],
                }
            return per

        kwargs.setdefault("liveness_fn", server.liveness.health)
        return cls(metrics_fn, **kwargs)

    # -- one scrape round ----------------------------------------------

    def scrape_once(self):
        """Pull → append → evaluate → diagnose.  Returns the list of
        SLO transitions this round.  Never raises: the health plane
        must observe failures, not cause them."""
        try:
            per = self.metrics_fn() or {}
        except Exception:  # noqa: BLE001 - source mid-teardown
            logger.warning("health scrape failed", exc_info=True)
            return []
        for eid, rec in per.items():
            if not isinstance(rec, dict):
                continue
            snap = rec.get("metrics")
            age = rec.get("metrics_age", 0.0) or 0.0
            if snap is None or age > self.max_snapshot_age:
                continue
            try:
                self.store.append(eid, snap)
            except Exception:  # noqa: BLE001 - one bad snapshot must
                logger.warning(  # not stall the whole scrape
                    "health: unappendable snapshot from executor %s",
                    eid, exc_info=True,
                )
        self._m_scrapes.inc()
        transitions = []
        if self.slo is not None:
            try:
                transitions = self.slo.evaluate()
            except Exception:  # noqa: BLE001 - one bad rule must not
                logger.warning(  # kill the standing loop
                    "SLO evaluation failed", exc_info=True
                )
        if self.detector is not None:
            try:
                self._diagnose()
            except Exception:  # noqa: BLE001 - diagnosis is advisory
                logger.warning("straggler diagnosis failed", exc_info=True)
        for a in transitions:
            for fn in list(self._alert_listeners):
                try:
                    fn(a)
                except Exception:  # noqa: BLE001 - a bad subscriber
                    logger.warning(  # must not stall the scrape loop
                        "alert listener failed", exc_info=True
                    )
        return transitions

    def add_alert_listener(self, fn):
        """Subscribe ``fn(alert)`` to every SLO transition (firing and
        resolved), called inline from the scrape thread — keep it
        cheap and never raise.  For at-most-once edge delivery with
        gap detection use ``plane.slo.alerts_since(seq)`` instead."""
        self._alert_listeners.append(fn)
        return fn

    def _diagnose(self):
        try:
            stragglers = self.detector.diagnose()
        except Exception:  # noqa: BLE001 - diagnosis is advisory
            logger.warning("straggler diagnosis failed", exc_info=True)
            return
        self._expire_hints({h["executor"] for h in stragglers})
        for hint in stragglers:
            eid = hint["executor"]
            self.hints[eid] = hint
            key = (eid, hint["phase"])
            if key in self._hinted:
                continue
            self._hinted.add(key)
            self._m_flagged.inc()
            self._tracer.mark(
                "straggler_flagged", trace="health", severity="warn",
                executor=eid, phase=hint["phase"],
                excess_sec=hint["excess_sec"],
            )
            logger.warning(
                "straggler: executor %d is %.1fx the fleet (%.3fs vs "
                "%.3fs per step), dominant phase %r — firing the "
                "profiler hook",
                eid, hint["step_sec"] / max(hint["fleet_median_sec"], 1e-9),
                hint["step_sec"], hint["fleet_median_sec"], hint["phase"],
            )
            if self.on_straggler is not None:
                try:
                    self.on_straggler(hint)
                except Exception:  # noqa: BLE001 - the hint stands even
                    logger.warning(  # if the profiler trigger fails
                        "straggler hook failed for executor %d", eid,
                        exc_info=True,
                    )

    def _expire_hints(self, flagged):
        """Age out recovered stragglers: an executor absent from
        ``straggler_clear_rounds`` consecutive diagnosis rounds drops
        its hint from ``/status``, resets the (executor, phase) dedup
        (so a recurrence re-fires ``on_straggler``), and notifies
        ``on_straggler_cleared`` (the driver clears the node's
        ``health_hint`` kv so its ``health.straggler`` gauge drops)."""
        for eid in flagged:
            self._clean_rounds.pop(eid, None)
        for eid in [e for e in self.hints if e not in flagged]:
            clean = self._clean_rounds.get(eid, 0) + 1
            if clean < self.straggler_clear_rounds:
                self._clean_rounds[eid] = clean
                continue
            self._clean_rounds.pop(eid, None)
            self.hints.pop(eid, None)
            self._hinted = {k for k in self._hinted if k[0] != eid}
            self._m_cleared.inc()
            self._tracer.mark(
                "straggler_cleared", trace="health", executor=eid,
            )
            logger.info(
                "straggler: executor %d recovered (%d clean rounds) — "
                "clearing the flag", eid, clean,
            )
            if self.on_straggler_cleared is not None:
                try:
                    self.on_straggler_cleared(eid)
                except Exception:  # noqa: BLE001 - recovery is advisory
                    logger.warning(
                        "straggler-cleared hook failed for executor %d",
                        eid, exc_info=True,
                    )

    # -- consumption surfaces ------------------------------------------

    def merged_snapshot(self):
        """Fleet-merged view for ``/metrics``: every executor's newest
        raw snapshot plus this (driver) process's own registry — the
        scrape/SLO/alert counters live here.  When the plane's
        registry is itself one of the scraped sources
        (:meth:`local`), it is NOT re-appended: that would expose
        every metric doubled."""
        snaps = [
            rec for rec in self.store.latest_raw().values() if rec
        ]
        if self.merge_own_registry:
            snaps.append(self._registry.snapshot())
        return _aggregate.merge_snapshots(snaps)

    def healthz(self):
        """Liveness merged with the health plane's own state:
        unhealthy on any dead executor (heartbeat age past the
        deadline or an explicit compute-dead report) or a firing
        page-severity alert."""
        out = {"healthy": True, "reasons": []}
        if self.liveness_fn is not None:
            try:
                lv = self.liveness_fn() or {}
            except Exception as e:  # noqa: BLE001 - source down IS a
                lv = {"healthy": False,  # health signal
                      "dead": {"liveness": str(e)}}
            out["liveness"] = lv
            if not lv.get("healthy", True):
                out["healthy"] = False
                for eid, reason in (lv.get("dead") or {}).items():
                    out["reasons"].append(
                        "executor {0} dead: {1}".format(eid, reason)
                    )
        if self.slo is not None:
            pages = [
                a for a in self.slo.active() if a["severity"] == "page"
            ]
            if pages:
                out["healthy"] = False
                out["reasons"].extend(
                    "SLO page: %s" % a["rule"] for a in pages
                )
        return out

    def status(self):
        """Compact JSON fleet summary (``/status``)."""
        per = {}
        for eid in self.store.executors():
            per[str(eid)] = {
                "step_rate": round(
                    self.store.rate("train.steps", executor=eid), 3
                ),
                "step_p99_sec": round(
                    self.store.p99_over(
                        "train.step_sec", executor=eid
                    ), 6
                ),
            }
        out = {
            "uptime_sec": round(time.time() - self.started_at, 1),
            "scrapes": self.store.scrapes,
            "executors": per,
            "alerts": self.slo.active() if self.slo else [],
            # fired/resolved transitions, newest last: what paged
            # even if it already cleared
            "alert_history": (
                self.slo.alert_history() if self.slo else []
            ),
            "stragglers": sorted(
                self.hints.values(), key=lambda h: h["executor"]
            ),
            "healthz": self.healthz(),
            # registered subsystem providers: serving engine, cluster
            # ledger, ...
            "providers": provider_statuses(),
        }
        return out

    def usage(self):
        """The ``/usage`` payload: the fleet-wide per-tenant
        cost table, recovered from the merged scrape's
        ``usage.<field>.<tenant>`` mirror counters (every executor's
        ledger publishes them into its registry, the heartbeat
        piggyback ships them, the normal counter merge sums them —
        no second wire format), plus this process's own ledger detail
        (top-K heavy hitters with sketch error bounds, tracked row
        count)."""
        from tensorflowonspark_tpu_torch.telemetry import (
            ledger as _ledger_mod,
        )

        tenants = _ledger_mod.tenants_from_snapshot(
            self.merged_snapshot()
        )
        local = _ledger_mod.get_ledger().snapshot()
        if not tenants:
            # nothing scraped yet (or a bare plane with no mirror
            # counters): fall back to the local ledger's own table
            tenants = local.get("tenants", {})
        return {
            "tenants": tenants,
            "top": local.get("top", []),
            "requests_tracked": local.get("requests_tracked", 0),
            "rows_evicted": local.get("rows_evicted", 0),
            "tenants_folded": local.get("tenants_folded", 0),
        }

    def journal_events(self, limit=None):
        """The ``/journal`` payload: the fleet event record via
        ``journal_fn`` when wired, else this process's own journal."""
        if self.journal_fn is not None:
            out = self.journal_fn()
            if isinstance(out, dict):
                return out
            return {"events": out}
        from tensorflowonspark_tpu_torch.telemetry import journal as _journal

        return {
            "events": [
                e.to_dict()
                for e in _journal.get_journal().events(limit=limit)
            ],
        }

    # -- lifecycle ------------------------------------------------------

    def _run(self):
        while not self._stop.wait(self.interval):
            self.scrape_once()

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="health-plane"
        )
        self._thread.start()
        return self

    def serve(self, port=0, host="127.0.0.1"):
        """Start the HTTP exposition surface for this plane; returns the
        :class:`~.exposition.ExpositionServer` (``.port`` is the bound
        port)."""
        from tensorflowonspark_tpu_torch.telemetry import exposition

        self._exposition = exposition.ExpositionServer(
            self, port=port, host=host
        ).start()
        return self._exposition

    @property
    def exposition(self):
        return self._exposition

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
        if self._exposition is not None:
            self._exposition.stop()
            self._exposition = None
