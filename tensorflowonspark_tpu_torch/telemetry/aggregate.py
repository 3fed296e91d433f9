"""Cluster aggregation: node snapshots into one driver-side fleet view
(port of the JAX package's ``telemetry/aggregate.py``).

The wire path:

1. each compute process runs a :class:`NodePublisher` (started by
   ``cluster.node._compute_process_main``) that writes its registry's
   snapshot and its newest journal events into the node manager's kv
   (``metrics``, ``journal_events``) every ``interval`` seconds;
2. the node's :class:`~..cluster.supervisor.Supervisor` reads them and
   ships them on its HEARTBEAT frames, with its own restart count and
   generation folded in;
3. the reservation server keeps the newest snapshot per executor and the
   fleet's events, and answers the ``METRICS`` and ``JOURNAL`` ops;
4. ``TPUCluster.metrics()`` folds the snapshots into one fleet view with
   :func:`merge_snapshots`: counters summed, histograms merged
   bucket-wise (the fixed geometric buckets make that exact) with their
   percentiles recomputed, gauges kept at their largest value.

The same publisher loop serves the health plane's ``profile_request``:
a sequenced request in the kv starts a ``torch.profiler`` capture in the
compute process, acknowledged in ``profile_state``.
"""

import logging
import math
import os
import threading

from tensorflowonspark_tpu_torch.telemetry import registry as _registry

logger = logging.getLogger(__name__)

#: Seconds between the publisher's writes into the node kv
#: (``TFOS_TELEMETRY_PUBLISH_INTERVAL``).
PUBLISH_INTERVAL = float(
    os.environ.get("TFOS_TELEMETRY_PUBLISH_INTERVAL", "2.0")
)


def merge_snapshots(snapshots):
    """Fold per-executor registry snapshots into ONE fleet snapshot.

    Counters sum; histograms merge bucket-wise (the fixed geometric
    bucket scheme makes this exact) with ``p50``/``p99`` recomputed
    over the merged counts; gauges take the max (a per-executor gauge
    summed across the fleet would be meaningless — the per-executor
    values stay available in the unmerged view).
    """
    counters = {}
    gauges = {}
    hists = {}  # name -> {"count","sum","buckets": {le: count}, min, max}
    for snap in snapshots:
        if not snap:
            continue
        for name, v in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + v
        for name, v in (snap.get("gauges") or {}).items():
            gauges[name] = max(gauges.get(name, v), v)
        for name, h in (snap.get("histograms") or {}).items():
            agg = hists.setdefault(
                name,
                {"count": 0, "sum": 0.0, "buckets": {},
                 "min": None, "max": None, "exemplars": {}},
            )
            agg["count"] += h.get("count", 0)
            agg["sum"] += h.get("sum", 0.0)
            for lo, hi, c in h.get("buckets", []):
                key = (lo, hi)
                agg["buckets"][key] = agg["buckets"].get(key, 0) + c
            for lo, hi, ex in h.get("exemplars", []) or []:
                # newest exemplar per bucket wins across executors —
                # the reference stays one concrete recent request
                key = (lo, hi)
                prev = agg["exemplars"].get(key)
                if prev is None or ex.get("ts", 0) > prev.get("ts", 0):
                    agg["exemplars"][key] = ex
            for k, pick in (("min", min), ("max", max)):
                v = h.get(k)
                if v is not None:
                    agg[k] = v if agg[k] is None else pick(agg[k], v)
    merged_h = {}
    for name, agg in hists.items():
        triples = sorted(
            ([lo, hi, c] for (lo, hi), c in agg["buckets"].items()),
            key=lambda t: t[0],
        )
        h = {
            # exact sum (registry.Histogram.snapshot carries the exact
            # running sum): the merged mean is sum/count, never
            # bucket-interpolated
            "count": agg["count"], "sum": agg["sum"],
            "min": agg["min"], "max": agg["max"], "buckets": triples,
        }
        if agg["exemplars"]:
            h["exemplars"] = sorted(
                ([lo, hi, ex] for (lo, hi), ex in agg["exemplars"].items()),
                key=lambda t: t[0],
            )
        h["p50"] = _registry.histogram_percentile(h, 50)
        h["p99"] = _registry.histogram_percentile(h, 99)
        if h["count"]:
            h["mean"] = h["sum"] / h["count"]
        merged_h[name] = h
    return {"counters": counters, "gauges": gauges,
            "histograms": merged_h}


def fleet_view(per_executor):
    """``{executor_id: {"metrics": snapshot, ...}}`` ->
    ``{"executors": <input>, "fleet": merged snapshot}`` (the shape of
    the reference's ``TPUCluster.metrics()``)."""
    return {
        "executors": per_executor,
        "fleet": merge_snapshots(
            rec.get("metrics") for rec in per_executor.values()
        ),
    }


def wire_snapshot(snapshot):
    """``snapshot`` as it may cross the JSON wire: gauges that are not
    finite numbers are dropped, and numpy scalars become Python numbers
    (a numpy scalar is not JSON, and ``NaN`` is not strict JSON)."""
    if not isinstance(snapshot, dict):
        return snapshot
    out = dict(snapshot)
    out["counters"] = {str(k): _plain(v) for k, v
                       in (snapshot.get("counters") or {}).items()}
    gauges = {}
    for k, v in (snapshot.get("gauges") or {}).items():
        v = _plain(v)
        if isinstance(v, (int, float)) and math.isfinite(v):
            gauges[str(k)] = v
    out["gauges"] = gauges
    return out


def _plain(v):
    return v.item() if hasattr(v, "item") else v


class NodePublisher(object):
    """Background thread writing the process registry's snapshot and its
    newest journal events into the node manager's kv every ``interval``
    seconds (step 1 of the module docstring's path), and starting the
    captures the health plane requests.  Publication is best effort: a
    failing write is logged once and retried at the next interval, and
    never reaches the training loop."""

    KV_KEY = "metrics"
    KV_JOURNAL_KEY = "journal_events"
    PROFILE_REQ_KEY = "profile_request"
    PROFILE_STATE_KEY = "profile_state"

    #: Newest journal events kept in the kv (the supervisor ships by seq
    #: cursor, so this covers a few publish intervals).
    JOURNAL_PUBLISH_MAX = 256

    def __init__(self, mgr, interval=None, registry=None, journal=None):
        self.mgr = mgr
        self.interval = PUBLISH_INTERVAL if interval is None else float(
            interval
        )
        self.registry = registry
        self.journal = journal
        self._stop = threading.Event()
        self._warned = False
        self._thread = None
        self._profile_seq = 0
        self._journal_seq = 0
        #: the request handed to the training thread, and its outcome
        self._waiting = None
        self._started = None

    def _snapshot(self):
        reg = self.registry or _registry.get_registry()
        return reg.snapshot()

    def publish_once(self):
        """One publication (also made when the loop ends, so the final
        state of a finished compute process is visible)."""
        try:
            self.mgr.set(self.KV_KEY, self._snapshot())
        except Exception as e:  # noqa: BLE001 - observability best effort
            if not self._warned:
                self._warned = True
                logger.warning(
                    "telemetry publication to the node manager failed "
                    "(%r); retrying quietly at every interval", e,
                    exc_info=True,
                )
            return False
        self.publish_journal()
        return True

    def publish_journal(self):
        """Mirror this process's newest journal events into the node kv
        (``journal_events``): one window tagged with this pid.  The
        supervisor ships the events past its cursor (a new pid resets the
        cursor), so a race between this write and that read can only send
        an event again, and the server's ``EventStore`` drops repeats by
        (pid, seq)."""
        from tensorflowonspark_tpu_torch.telemetry import journal as _journal

        j = self.journal or _journal.get_journal()
        evs = j.tail(self.JOURNAL_PUBLISH_MAX)
        newest = evs[-1].seq if evs else 0
        if newest <= self._journal_seq:
            return False
        try:
            self.mgr.set(self.KV_JOURNAL_KEY, {
                "pid": os.getpid(),
                "events": [e.to_dict() for e in evs],
            })
        except Exception:  # noqa: BLE001 - observability best effort
            return False
        self._journal_seq = newest
        return True

    def check_profile_request(self):
        """Serve the driver's ``profile_request`` kv.  Requests are
        sequenced: each fires once, also across a restart of this
        publisher (the ``profile_state`` ack persists in the kv).  The
        capture starts on the training thread at its next step boundary
        (``tensorboard.request_profile``); the ack follows on the pass
        after, or at once with ``started: False`` when a session is
        already live.  Returns the ack written in this call, else None."""
        from tensorflowonspark_tpu_torch import tensorboard as _tb

        done = self._started
        if done is not None:
            self._started = None
            return self._ack(*done)
        try:
            req = self.mgr.get(self.PROFILE_REQ_KEY)
            if hasattr(req, "_getvalue"):
                req = req._getvalue()
        except Exception:  # noqa: BLE001 - kv missing or manager down
            return None
        if not isinstance(req, dict) or not req.get("seq"):
            return None
        seq = int(req["seq"])
        if seq <= self._profile_seq:
            return None
        if self._profile_seq == 0:
            # a fresh publisher (a restarted process): an already served
            # request must not fire again
            try:
                prev = self.mgr.get(self.PROFILE_STATE_KEY)
                if hasattr(prev, "_getvalue"):
                    prev = prev._getvalue()
                if isinstance(prev, dict) and int(
                    prev.get("seq", 0)
                ) >= seq:
                    self._profile_seq = int(prev["seq"])
                    return None
            except Exception:  # noqa: BLE001 - no ack in the kv yet
                pass
        self._profile_seq = seq
        log_dir = req.get("log_dir") or "tfos_profile"
        sub = os.path.join(str(log_dir), str(os.getpid()))

        def on_start(sess):  # on the training thread: no kv call here
            self._started = (seq, sub, sess is not None)

        if _tb.request_profile(sub, req.get("steps"), on_start=on_start):
            self._waiting = (seq, sub)
            return None
        return self._ack(seq, sub, False)

    def _ack(self, seq, sub, started):
        from tensorflowonspark_tpu_torch import telemetry as _t

        self._waiting = None
        state = {"seq": seq, "started": started, "log_dir": sub,
                 "pid": os.getpid()}
        try:
            self.mgr.set(self.PROFILE_STATE_KEY, state)
        except Exception:  # noqa: BLE001 - the ack is observability
            logger.warning(
                "unable to ack profile request %d", seq, exc_info=True
            )
        reg = self.registry or _registry.get_registry()
        reg.counter("health.profile_captures").inc()
        _t.get_tracer().mark(
            "profile_capture", trace="health", seq=seq, started=started,
            log_dir=sub,
        )
        logger.info(
            "health plane profile request %d: capture %s into %s",
            seq, "started" if started else "unavailable", sub,
        )
        return state

    def _run(self):
        from tensorflowonspark_tpu_torch import tensorboard as _tb

        while not self._stop.wait(self.interval):
            self.publish_once()
            self.check_profile_request()
        if self._waiting is not None and _tb.cancel_request() is not None:
            # no step boundary came to serve it
            self._ack(*self._waiting, started=False)
        elif self._started is not None:
            self._ack(*self._started)
        self.publish_once()

    def start(self):
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="telemetry-publisher"
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)


def start_node_publisher(mgr, interval=None):
    """A started :class:`NodePublisher` when telemetry is on, else None
    (no thread at all)."""
    if not _registry.get_registry().enabled:
        return None
    return NodePublisher(mgr, interval=interval).start()
