"""Fleet router: bounded admission and pluggable dispatch over replicas
(port of the JAX package's ``fleet/router.py``).

One level above the engine's admission control, the router keeps the
fleet's: a bounded fleet admission queue with the engine's ``block |
reject | degrade`` vocabulary, except that pressure first spills to a
sibling replica.  An engine only sees traffic the router already sized to
its slots and queue bound, so no engine sheds while a sibling has room.

Dispatch policies (:data:`DISPATCH_POLICIES`, or any callable of the same
shape):

- ``least_loaded``: fewest router-assigned requests per weight;
- ``prefix_affinity``: the prompt's block-granular fingerprint
  (:func:`~tensorflowonspark_tpu_torch.prefix_cache.fingerprint`, the
  radix cache's key) routed by rendezvous hashing, so that a shared
  prefix lands on the replica whose radix cache holds it; when that
  replica's backlog runs more than ``imbalance`` ahead of the least
  loaded, least-loaded instead (an affinity spill);
- ``weighted_rr``: smooth weighted round-robin;
- ``random``: a seeded uniform pick (the affinity baseline).

A replica's death re-dispatches its work from the committed tokens: its
wreckage (finished-but-unemitted rows, each request's committed tokens,
see ``Replica._wreckage``) goes back to the front of the fleet queue with
the dead replica excluded, and a greedy continuation of ``prompt +
committed`` equals an undisturbed run.  A slow replica is routed around
(its latency EWMA against the fleet median), kept on probe traffic, and
re-admitted after clean probe rounds (and, with a ``readmit_gate``, clean
health rounds).  Every action is a journal event (``replica_dead``,
``replica_quarantined``, ``fleet_redispatch``, ``replica_evicted``,
``replica_readmitted``, ``fleet_shed``, ...).

Rolling deploys (:mod:`.deploy`) are a state machine stepped by the
router's loop: drain one replica, hot-swap it, gate on its health,
re-admit, next.
"""

import collections
import itertools
import logging
import queue as queue_mod
import threading
import time
import weakref

import numpy as np

from tensorflowonspark_tpu_torch import serving_engine, telemetry
from tensorflowonspark_tpu_torch.fleet.replica import ReplicaSet
from tensorflowonspark_tpu_torch.prefix_cache import fingerprint
from tensorflowonspark_tpu_torch.telemetry import health as health_mod
from tensorflowonspark_tpu_torch.telemetry import ledger as ledger_mod

logger = logging.getLogger(__name__)

#: internal row column carrying each request's (possibly resumed) token
#: budget into the replica engines, added to the engine-level mapping
#: unless the caller mapped a budget column
FLEET_BUDGET_COL = "__fleet_max_new__"

#: internal row column carrying each request's fleet-minted trace id into
#: the replica engines (mapped to ``serving_engine.TRACE_INPUT`` unless
#: the caller mapped a trace column): the engine's spans join the
#: router's trace, and a re-dispatch goes on with the same trace on the
#: surviving replica
FLEET_TRACE_COL = "__fleet_trace__"

#: per-process router sequence: trace ids are ``flt<router>-req<fid>``,
#: so rows of the process-wide usage ledger never collide across routers
_ROUTER_SEQ = itertools.count(1)

#: error-record kinds that raise under ``on_error="raise"`` (the replica
#: engines always record; the router restores fail-fast for request
#: faults).  Policy records (shed, deadline, drained, replica_lost) never
#: raise.
_RAISE_KINDS = frozenset({
    "missing_input", "bad_dtype", "bad_shape", "empty_prompt",
    "too_long", "bad_budget", "bad_deadline", "admit", "predict",
})


def _mix(fp, rid):
    """Deterministic 64-bit rendezvous score of (fingerprint, replica),
    stable across processes (no salted ``hash``)."""
    x = (int(fp) ^ (int(rid) * 0x9E3779B97F4A7C15)) & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return None
    return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1]
                                             + vals[n // 2])


# ----------------------------------------------------------------------
# dispatch policies
# ----------------------------------------------------------------------


def _least_loaded(router, req, candidates):
    return min(
        candidates,
        key=lambda r: (router._assigned_count(r.replica_id)
                       / router._weight(r.replica_id), r.replica_id),
    )


def _weighted_rr(router, req, candidates):
    """Smooth weighted round-robin (nginx's): deterministic, in
    proportion to the weights, without bursts."""
    cw = router._rr_current
    total = 0.0
    for r in candidates:
        w = router._weight(r.replica_id)
        cw[r.replica_id] = cw.get(r.replica_id, 0.0) + w
        total += w
    best = max(candidates, key=lambda r: (cw[r.replica_id], -r.replica_id))
    cw[best.replica_id] -= total
    return best


def _random(router, req, candidates):
    return candidates[router._rng.randint(len(candidates))]


def _prefix_affinity(router, req, candidates):
    """Rendezvous-hash the prompt's fingerprint over every routable
    replica (stable while membership is: one replica's death remaps only
    its own keys) and dispatch there, unless its backlog runs more than
    ``imbalance`` ahead of the least-loaded candidate (or it has no room
    or is excluded): then least-loaded."""
    fp = req["fingerprint"]
    if fp is None:
        return _least_loaded(router, req, candidates)
    routable = [r for r in router.replicas
                if r.alive and r.state == "live"] or candidates
    target = max(routable, key=lambda r: _mix(fp, r.replica_id))
    floor = min(router._assigned_count(r.replica_id) for r in candidates)
    if (target in candidates
            and router._assigned_count(target.replica_id) - floor
            <= router.imbalance):
        router.stats["affinity_hits"] += 1
        router._m["affinity_hits"].inc()
        return target
    router.stats["affinity_spills"] += 1
    with router._pressure_lock:
        router._spill_times.append(router._clock())
    return _least_loaded(router, req, candidates)


#: name -> policy ``(router, req, candidates) -> Replica``; FleetRouter
#: also takes a bare callable of that shape
DISPATCH_POLICIES = {
    "least_loaded": _least_loaded,
    "prefix_affinity": _prefix_affinity,
    "weighted_rr": _weighted_rr,
    "random": _random,
}


class FleetRouter(object):
    """Route a request stream over a :class:`ReplicaSet` (see the module
    docstring).  :meth:`serve` keeps the engine's contract: dict rows in,
    output rows or typed records out, in fleet input order.

    Args:
      predict: generation predictor (replicas past the first come from
        ``predict.make_replica()``); None when ``replica_set`` or
        ``predict_factory`` is given.
      input_mapping: ``{column: input_name}``, the user's mapping; the
        router adds its internal budget and trace columns for the
        replica engines unless those are mapped already.
      output_mapping: optional ``{output_name: column}`` rename, applied
        by the router.
      replicas: replica count (or a prebuilt ``replica_set`` whose
        engines were built with :meth:`engine_input_mapping`).
      num_slots / chunk / replica_queue_depth / engine_opts / devices /
        predict_factory: forwarded to :class:`ReplicaSet`.
      policy: fleet admission policy: ``block`` (backpressure the
        source), ``reject`` (typed shed records past the fleet queue
        bound), ``degrade`` (shrink budgets against the fleet backlog);
        pressure spills across replicas first.
      dispatch: a :data:`DISPATCH_POLICIES` name or a callable
        ``(router, req, candidates) -> Replica``.
      queue_depth: fleet admission queue bound (default: the summed
        replica capacity).
      degrade_floor: the least per-request budget under ``degrade``.
      on_error: ``"record"`` (typed records) or ``"raise"`` (request
        faults raise, naming the fleet index).
      replica_weights: optional ``{replica_id: weight}`` for
        ``weighted_rr`` / ``least_loaded``.
      imbalance: affinity fallback threshold (default one replica's
        capacity of assigned requests ahead of the least loaded).
      affinity_width: fingerprint width in tokens (default the prefix
        cache's ``FINGERPRINT_TOKENS``).
      slow_factor / min_slow_sec / suspect_rounds / probe_every /
        readmit_rounds: the straggler policy: a live replica whose
        completion-latency EWMA exceeds ``max(min_slow_sec, slow_factor
        * fleet median)`` for ``suspect_rounds`` completions in a row is
        routed around, then receives one probe request every
        ``probe_every`` dispatches, and is re-admitted after
        ``readmit_rounds`` clean probes in a row.
      readmit_gate: optional quality gate on re-admission
        (:class:`~..telemetry.health.CleanRoundsSensor`).
      stats: optional dict filled with the fleet's counters.
      clock / seed / poll_sec / pressure_window: determinism knobs and
        the admission-pressure window (seconds).
    """

    def __init__(self, predict, input_mapping, output_mapping=None, *,
                 replicas=2, num_slots=4, chunk=None,
                 replica_queue_depth=None, engine_opts=None,
                 devices=None, predict_factory=None,
                 replica_set=None, policy="block",
                 dispatch="least_loaded", queue_depth=None,
                 degrade_floor=1, on_error="record", replica_weights=None,
                 imbalance=None, affinity_width=None, slow_factor=4.0,
                 min_slow_sec=0.05, suspect_rounds=2, probe_every=8,
                 readmit_rounds=3, readmit_gate=None, stats=None,
                 clock=None, seed=0, poll_sec=0.05,
                 pressure_window=30.0):
        if policy not in serving_engine.POLICIES:
            raise ValueError(
                "fleet policy must be one of {0}, got {1!r}".format(
                    serving_engine.POLICIES, policy))
        if on_error not in serving_engine.ON_ERROR:
            raise ValueError(
                "on_error must be one of {0}, got {1!r}".format(
                    serving_engine.ON_ERROR, on_error))
        if callable(dispatch):
            self._dispatch_policy = dispatch
            self.dispatch_name = getattr(dispatch, "__name__", "custom")
        else:
            if dispatch not in DISPATCH_POLICIES:
                raise ValueError(
                    "dispatch must be a callable or one of {0}, got "
                    "{1!r}".format(sorted(DISPATCH_POLICIES), dispatch))
            self._dispatch_policy = DISPATCH_POLICIES[dispatch]
            self.dispatch_name = dispatch
        self.user_mapping = dict(input_mapping)
        self.output_mapping = output_mapping
        self.user_budget_col = next(
            (c for c in input_mapping
             if input_mapping[c] == serving_engine.BUDGET_INPUT), None)
        self.budget_col = self.user_budget_col or FLEET_BUDGET_COL
        self.user_trace_col = next(
            (c for c in input_mapping
             if input_mapping[c] == serving_engine.TRACE_INPUT), None)
        self.trace_col = self.user_trace_col or FLEET_TRACE_COL
        self.tenant_col = next(
            (c for c in input_mapping
             if input_mapping[c] == serving_engine.TENANT_INPUT), None)
        self._trace_prefix = "flt%d" % next(_ROUTER_SEQ)
        self._ledger = ledger_mod.get_ledger()
        self.policy = policy
        self.on_error = on_error
        self.degrade_floor = max(1, int(degrade_floor))
        if replica_set is None:
            replica_set = ReplicaSet(
                predict, replicas, self.engine_input_mapping(input_mapping),
                num_slots=num_slots, chunk=chunk,
                queue_depth=replica_queue_depth, engine_opts=engine_opts,
                devices=devices, predict_factory=predict_factory,
            )
        self.replica_set = replica_set.start()
        self.replicas = replica_set.replicas
        self._completions = replica_set.completions
        eng0 = self.replicas[0].engine
        self.prompt_col = eng0.prompt_col
        self.max_new = int(eng0.max_new)
        self._eos_id = eng0.eos_id
        # the user-facing generated_len rule (the engine's _emit_len,
        # without the router's internal budget column)
        self._user_emit_len = (self._eos_id is not None
                               or self.user_budget_col is not None
                               or policy == "degrade")
        self.queue_depth = (
            max(1, int(queue_depth)) if queue_depth is not None
            else sum(r.capacity() for r in self.replicas))
        # affinity falls back to least-loaded only when its target runs a
        # replica's whole capacity ahead (the per-replica room bound
        # already stops overload; a tighter default would turn every
        # burst into least-loaded and forfeit the cache hits)
        self.imbalance = (int(eng0.num_slots) + int(eng0.queue_depth)
                          if imbalance is None else max(0, int(imbalance)))
        self.affinity_width = affinity_width
        self.slow_factor = float(slow_factor)
        self.min_slow_sec = float(min_slow_sec)
        self.suspect_rounds = max(1, int(suspect_rounds))
        self.probe_every = max(1, int(probe_every))
        self.readmit_rounds = max(1, int(readmit_rounds))
        #: optional quality gate on re-admission: a replica with enough
        #: clean probe rounds still waits until the health plane saw N
        #: clean rounds in a row
        self.readmit_gate = readmit_gate
        self._gate_blocked = {}   # rid -> True while the gate holds it
        self._weights = dict(replica_weights or {})
        self._rr_current = {}
        self._rng = np.random.RandomState(int(seed))
        self._clock = clock if clock is not None else time.monotonic
        self._poll = float(poll_sec)
        # scheduling state
        self._queue = collections.deque()   # fids awaiting dispatch
        self._reqs = {}                     # fid -> request record
        self._assigned = collections.defaultdict(set)  # rid -> fids
        self._finished = {}
        self._emit_next = 0
        self._n_in = 0
        self._exhausted = False
        self._dispatch_count = 0
        self._lat_ewma = {}
        self._suspect = collections.defaultdict(int)
        self._clean = collections.defaultdict(int)
        self._deploy = None
        self.deploy_history = []
        self.stats = stats if stats is not None else {}
        self.stats.update({
            "latency_sec": {}, "done_at": {}, "dispatched": 0,
            "completed": 0, "errors": 0, "shed": 0, "expired": 0,
            "degraded": 0, "drained": 0, "redispatched": 0,
            "replica_deaths": 0, "quarantined": 0, "affinity_hits": 0,
            "affinity_spills": 0, "evicted": 0, "readmitted": 0,
            "scaled_up": 0, "scaled_down": 0,
            "replicas": len(self.replicas),
            "dispatch_policy": self.dispatch_name,
            "fleet_policy": policy,
            # fleet request id -> minted trace id
            "trace_ids": {},
        })
        self._tracer = telemetry.get_tracer()
        reg = telemetry.get_registry()
        self._m = {
            "dispatched": reg.counter("fleet.dispatched"),
            "redispatched": reg.counter("fleet.redispatched"),
            "completed": reg.counter("fleet.completed"),
            "shed": reg.counter("fleet.shed"),
            "affinity_hits": reg.counter("fleet.affinity_hits"),
            "replica_deaths": reg.counter("fleet.replica_deaths"),
            "evictions": reg.counter("fleet.evictions"),
            "readmissions": reg.counter("fleet.readmissions"),
        }
        self._m_live = reg.gauge("fleet.live_replicas")
        self._m_live.set(len(self.replicas))
        self._m_spawned = reg.counter("fleet.replicas_spawned")
        self._m_retired = reg.counter("fleet.replicas_retired")
        self._t0 = self._clock()
        # the windowed admission-pressure statistic: occupancy samples
        # and shed/spill times over the last pressure_window seconds,
        # read off-thread (/status) while the serve pass appends
        self.pressure_window = max(1.0, float(pressure_window))
        self._occupancy_samples = collections.deque()  # (t, occupancy)
        self._shed_times = collections.deque()
        self._spill_times = collections.deque()
        self._pressure_lock = threading.Lock()
        # the /status provider holds the router weakly: a finished
        # router never pins its replicas' decoders
        ref = weakref.ref(self)

        def _fleet_status():
            rt = ref()
            return {"finished": True} if rt is None else rt.health_status()

        health_mod.register_status_provider("fleet", _fleet_status)

    # -- small helpers ---------------------------------------------------

    def _weight(self, rid):
        return float(self._weights.get(rid, 1.0)) or 1.0

    def _assigned_count(self, rid):
        return len(self._assigned[rid])

    def _routable(self):
        return [r for r in self.replicas if r.alive and r.state == "live"]

    def _set_live_gauge(self):
        self._m_live.set(len(self._routable()))

    def outstanding_of(self, rid):
        """``(request_ids, trace_ids)`` assigned to replica ``rid`` now:
        what fleet-action journal events carry, so that a forensics
        timeline connects an action to the requests it touched."""
        fids = sorted(self._assigned[rid])
        return fids, [self.stats["trace_ids"].get(f) for f in fids]

    def _trace_ids(self, fids):
        return [self.stats["trace_ids"].get(f) for f in fids]

    def _note_pressure(self):
        """One admission-pressure sample per serve pass (the window is
        trimmed on both sample and read)."""
        now = self._clock()
        with self._pressure_lock:
            self._occupancy_samples.append(
                (now, len(self._queue) / float(self.queue_depth)))
            horizon = now - self.pressure_window
            while (self._occupancy_samples
                   and self._occupancy_samples[0][0] < horizon):
                self._occupancy_samples.popleft()
            for dq in (self._shed_times, self._spill_times):
                while dq and dq[0] < horizon:
                    dq.popleft()

    def pressure(self):
        """The windowed admission pressure: queue occupancy (now, mean and
        peak over the last ``pressure_window`` seconds) and the shed and
        affinity-spill rates over the same window; rides ``/status``."""
        now = self._clock()
        horizon = now - self.pressure_window
        with self._pressure_lock:
            occ = [v for (t, v) in self._occupancy_samples if t >= horizon]
            sheds = sum(1 for t in self._shed_times if t >= horizon)
            spills = sum(1 for t in self._spill_times if t >= horizon)
        occ_now = len(self._queue) / float(self.queue_depth)
        return {
            "window_sec": self.pressure_window,
            "occupancy": round(occ_now, 4),
            "occupancy_mean": round(sum(occ) / len(occ) if occ
                                    else occ_now, 4),
            "occupancy_peak": round(max(occ) if occ else occ_now, 4),
            "queued": len(self._queue),
            "queue_depth": self.queue_depth,
            "shed_per_sec": round(sheds / self.pressure_window, 4),
            "spill_per_sec": round(spills / self.pressure_window, 4),
            "free_slots": sum(max(0, self._room(r))
                              for r in self._routable()),
        }

    def health_status(self):
        """The fleet's ``/status`` summary: pressure, routing policy,
        per-replica load snapshots and cost rows, the deploy's state."""
        return {
            "pressure": self.pressure(),
            "replicas": len(self.replicas),
            "live": len(self._routable()),
            "dispatch": self.dispatch_name,
            "policy": self.policy,
            "queued": len(self._queue),
            "queue_depth": self.queue_depth,
            "outstanding": sum(len(v) for v in self._assigned.values()),
            "completed": self.stats["completed"],
            "shed": self.stats["shed"],
            "replica_deaths": self.stats["replica_deaths"],
            "deploy": (self._deploy.status if self._deploy is not None
                       else (self.deploy_history[-1]
                             if self.deploy_history else None)),
            "loads": self.replica_set.load(),
            # what each replica burned and produced so far
            "costs": {
                r.replica_id: {
                    "state": r.state,
                    "chip_sec": round(float(
                        r.stats.get("decode_wall_sec", 0.0)), 6),
                    "tokens_out": int(r.stats.get("tokens_out", 0)),
                    "completed": int(r.stats.get("completed", 0)),
                    "prefix_tokens_saved": int(
                        r.stats.get("prefix_tokens_saved", 0)),
                }
                for r in self.replicas
            },
        }

    def load(self):
        """Fleet-level load: free slots and queue depths summed over live
        replicas, plus the router's own backlog."""
        live = [r.load() for r in self.replicas if r.alive]
        return {
            "replicas": len(self.replicas),
            "live": len(live),
            "free_slots": sum(s["free_slots"] for s in live),
            "in_flight": sum(s["in_flight"] for s in live),
            "queued": sum(s["queued"] for s in live) + len(self._queue),
            "queue_depth": self.queue_depth,
        }

    def engine_input_mapping(self, input_mapping=None):
        """The engine-level mapping the replicas are built with: the user
        mapping plus the router's internal budget column (re-dispatches
        carry reduced budgets through it) and trace column."""
        m = dict(input_mapping or self.user_mapping)
        if not any(v == serving_engine.BUDGET_INPUT for v in m.values()):
            m[FLEET_BUDGET_COL] = serving_engine.BUDGET_INPUT
        if not any(v == serving_engine.TRACE_INPUT for v in m.values()):
            m[FLEET_TRACE_COL] = serving_engine.TRACE_INPUT
        return m

    # -- admission -------------------------------------------------------

    def _shed(self, fid, rid, why):
        self.stats["shed"] += 1
        self._m["shed"].inc()
        with self._pressure_lock:
            self._shed_times.append(self._clock())
        self._tracer.mark("fleet_shed", trace=rid, severity="warn",
                          request_index=fid, trace_id=rid,
                          queue_depth=self.queue_depth)
        self._ledger.close(rid, tokens_out=0)
        self._finished[fid] = serving_engine.error_record("shed", fid, why)

    def _rid_of(self, fid, row):
        """The request's trace id: the caller's, when a mapped
        ``TRACE_INPUT`` column holds a usable one, else minted here."""
        if self.user_trace_col is not None and isinstance(row, dict):
            v = row.get(self.user_trace_col)
            if isinstance(v, str) and v:
                return v
        return "%s-req%d" % (self._trace_prefix, fid)

    def _admit(self, row):
        fid = self._n_in
        self._n_in += 1
        rid = self._rid_of(fid, row)
        self.stats["trace_ids"][fid] = rid
        if self.policy == "reject":
            # spill before shed: free replica room is admission capacity
            # too (dispatch runs after this pull)
            cap = self.queue_depth + sum(max(0, self._room(r))
                                         for r in self._routable())
            if len(self._queue) >= cap:
                self._shed(
                    fid, rid,
                    "request {0} shed: fleet admission queue full ({1} "
                    "waiting, depth {2}, policy 'reject')".format(
                        fid, len(self._queue), self.queue_depth))
                return
        budget = self.max_new
        if self.user_budget_col is not None:
            try:
                budget = max(1, min(int(row[self.user_budget_col]),
                                    self.max_new))
            except (KeyError, TypeError, ValueError):
                pass  # the engine's validation names the bad column
        if self.policy == "degrade":
            backlog = len(self._queue)
            if backlog > self.queue_depth:
                shrunk = max(self.degrade_floor,
                             (budget * self.queue_depth) // backlog)
                if shrunk < budget:
                    budget = shrunk
                    self.stats["degraded"] += 1
        prompt, fp = None, None
        try:
            prompt = np.asarray(row[self.prompt_col], np.int32).ravel()
            fp = (fingerprint(prompt, self.affinity_width)
                  if self.affinity_width else fingerprint(prompt))
        except Exception:  # noqa: BLE001 - validation is the engine's
            pass
        tenant = None
        if self.tenant_col is not None and isinstance(row, dict):
            v = row.get(self.tenant_col)
            if isinstance(v, str) and v:
                tenant = v  # junk values: the engine names the error
        self._reqs[fid] = {
            "row": row, "prompt": prompt, "budget": budget,
            "committed": [], "excluded": set(), "replica": None,
            "fingerprint": fp, "submit": self._clock(),
            "sent_at": None, "redispatches": 0,
            "rid": rid, serving_engine.TENANT_INPUT: tenant,
        }
        # the cost row opens at fleet admission with the user's prompt
        # size (a re-dispatch re-admits prompt + committed in an engine;
        # the ledger keeps the first value)
        self._ledger.open(rid, tenant=tenant, tokens_in=(
            int(prompt.shape[0]) if prompt is not None else None))
        self._tracer.mark("fleet_admission", trace=rid, request_index=fid,
                          trace_id=rid)
        self._queue.append(fid)

    def _room(self, replica):
        return replica.capacity() - self._assigned_count(replica.replica_id)

    def _pull(self, it):
        """Pull from the source per the fleet admission policy."""
        if self._exhausted:
            return
        if self.policy == "block":
            # backpressure: pull no faster than the fleet can place (the
            # routable replicas' free room), and at most one row per live
            # replica a pass, so that a paced source never holds the loop
            # inside next(it) building a burst
            live = self._routable()
            room = sum(max(0, self._room(r)) for r in live)
            budget = max(1, len(live))
            while budget and len(self._queue) < room:
                try:
                    row = next(it)
                except StopIteration:
                    self._exhausted = True
                    return
                self._admit(row)
                budget -= 1
            return
        # reject/degrade: every available request has arrived; _admit
        # sheds or shrinks against the backlog
        while True:
            try:
                row = next(it)
            except StopIteration:
                self._exhausted = True
                return
            self._admit(row)

    # -- dispatch --------------------------------------------------------

    def _candidates(self, req):
        live = [r for r in self._routable()
                if r.replica_id not in req["excluded"]]
        cands = [r for r in live if self._room(r) > 0]
        if cands or live:
            return cands
        # every live replica excluded, or none live: routed-around
        # replicas (serve slowly rather than drop), then the excluded set
        # cleared (a re-dispatch never wedges on an excluded fleet)
        around = [r for r in self.replicas
                  if r.alive and r.state == "routed_around"
                  and r.replica_id not in req["excluded"]
                  and self._room(r) > 0]
        if around:
            return around
        retry = [r for r in self.replicas
                 if r.alive and r.state in ("live", "routed_around")
                 and self._room(r) > 0]
        if retry:
            req["excluded"].clear()
        return retry

    def _probe_target(self, req):
        """Every ``probe_every``-th dispatch goes to a routed-around
        replica (lowest id with room), so that its recovery shows."""
        if self._dispatch_count % self.probe_every:
            return None
        for r in self.replicas:
            if (r.alive and r.state == "routed_around"
                    and r.replica_id not in req["excluded"]
                    and self._room(r) > 0):
                return r
        return None

    def _dispatch(self):
        while self._queue:
            fid = self._queue[0]
            req = self._reqs[fid]
            if req["committed"] and len(req["committed"]) >= req["budget"]:
                # the dead replica committed the whole budget already
                self._queue.popleft()
                self._finalize_resumed_complete(fid, req)
                continue
            if not any(r.alive and r.state in ("live", "routed_around")
                       for r in self.replicas):
                self._queue.popleft()
                self.stats["errors"] += 1
                self._ledger.close(req["rid"],
                                   tokens_out=len(req["committed"]))
                self._finished[fid] = serving_engine.error_record(
                    "replica_lost", fid,
                    "request {0}: no live replica remains in the "
                    "fleet".format(fid),
                    tokens_done=len(req["committed"]),
                    partial=req["committed"])
                self._reqs.pop(fid, None)
                continue
            target = self._probe_target(req)
            if target is None:
                cands = self._candidates(req)
                if not cands:
                    return  # every routable replica full: wait
                target = self._dispatch_policy(self, req, cands)
            self._queue.popleft()
            self._send(fid, req, target)

    def _send(self, fid, req, replica):
        rid = replica.replica_id
        row = dict(req["row"])
        committed = req["committed"]
        if committed:
            row[self.prompt_col] = np.concatenate(
                [req["prompt"], np.asarray(committed, np.int32)])
        row[self.budget_col] = req["budget"] - len(committed)
        # the trace id rides the row into the replica engine; a
        # re-dispatch goes on with the same trace
        row[self.trace_col] = req["rid"]
        req["replica"] = rid
        req["sent_at"] = self._clock()
        self._assigned[rid].add(fid)
        self._dispatch_count += 1
        self.stats["dispatched"] += 1
        self._m["dispatched"].inc()
        if self._tracer.enabled:
            self._tracer.add("fleet_dispatch", time.perf_counter(), 0.0,
                             trace=req["rid"], replica=rid,
                             request_index=fid,
                             resumed_tokens=len(committed))
        replica.dispatch(fid, row)

    # -- completion / death handling -------------------------------------

    def _collect(self):
        block = bool(self._queue or self._reqs)
        try:
            ev = self._completions.get(timeout=self._poll if block else 0.0)
        except queue_mod.Empty:
            return
        while True:
            self._handle(ev)
            try:
                ev = self._completions.get_nowait()
            except queue_mod.Empty:
                return

    def _handle(self, ev):
        kind = ev[0]
        if kind == "done":
            _, rid, fid, out = ev
            self._assigned[rid].discard(fid)
            req = self._reqs.pop(fid, None)
            if req is None:
                return
            self._observe_latency(rid, req)
            self._finalize(fid, req, out, rid)
        elif kind == "dead":
            self._on_death(ev[1], ev[2])
        elif kind == "quarantine":
            self._on_quarantine(ev[1], ev[2])
        # "stopped" needs nothing (a clean close)

    def _mark_wreck(self, event, rid, wreck):
        replica = self.replicas[rid]
        n_redisp = len(wreck["committed"]) + len(wreck["queued"])
        touched = sorted(set(wreck["committed"]) | set(wreck["queued"])
                         | set(wreck["finished"]))
        self._tracer.mark(event, trace="fleet", severity="page",
                          replica=rid, error=str(replica.error),
                          finished=len(wreck["finished"]),
                          redispatching=n_redisp, request_ids=touched,
                          trace_ids=self._trace_ids(touched))
        return n_redisp

    def _on_death(self, rid, wreck):
        self.stats["replica_deaths"] += 1
        self._m["replica_deaths"].inc()
        self._m_live.set(sum(1 for r in self.replicas if r.alive))
        n_redisp = self._mark_wreck("replica_dead", rid, wreck)
        logger.warning("fleet: replica %d died (%s); delivering %d "
                       "finished row(s), re-dispatching %d request(s)",
                       rid, self.replicas[rid].error,
                       len(wreck["finished"]), n_redisp)
        self._requeue_wreckage(rid, wreck)

    def _on_quarantine(self, rid, wreck):
        """A replica contained a device error: route around it (probe
        traffic only while it rebuilds and proves itself) and go on with
        its in-flight requests from their committed tokens on a
        survivor."""
        self.replica_set.evict(rid)
        self._suspect[rid] = 0
        self._clean[rid] = 0
        self.stats["quarantined"] += 1
        self.stats["evicted"] += 1
        self._m["evictions"].inc()
        n_redisp = self._mark_wreck("replica_quarantined", rid, wreck)
        logger.warning("fleet: replica %d quarantined on device error "
                       "(%s); delivering %d finished row(s), "
                       "re-dispatching %d request(s) on survivors", rid,
                       self.replicas[rid].error, len(wreck["finished"]),
                       n_redisp)
        self._requeue_wreckage(rid, wreck)

    def _requeue_wreckage(self, rid, wreck):
        """Deliver a wrecked replica's finished rows and re-dispatch the
        rest from the committed tokens (the death and quarantine paths
        share it)."""
        for fid, out in sorted(wreck["finished"].items()):
            self._assigned[rid].discard(fid)
            req = self._reqs.pop(fid, None)
            if req is not None:
                self._finalize(fid, req, out, rid)
        # in-flight work goes on from its committed tokens, queued work
        # from scratch, the wrecked replica excluded
        resumed = []
        for fid, committed in wreck["committed"].items():
            req = self._reqs.get(fid)
            if req is None:
                continue
            req["committed"] = req["committed"] + [int(t)
                                                   for t in committed]
            resumed.append(fid)
        resumed += [fid for fid in wreck["queued"] if fid in self._reqs]
        # anything still counted against the replica that the wreckage
        # missed re-dispatches too
        resumed += [fid for fid in sorted(self._assigned.pop(rid, set()))
                    if fid in self._reqs]
        resumed = sorted(set(resumed))
        for fid in resumed:
            req = self._reqs[fid]
            req["excluded"].add(rid)
            req["replica"] = None
            req["redispatches"] += 1
            self.stats["redispatched"] += 1
            self._m["redispatched"].inc()
            self._ledger.redispatch(req["rid"])
            # the mark rides the request's own trace
            self._tracer.mark("fleet_redispatch", trace=req["rid"],
                              severity="warn", request_index=fid,
                              trace_id=req["rid"], from_replica=rid,
                              tokens_committed=len(req["committed"]))
        self._queue.extendleft(reversed(resumed))

    # -- straggler policy ------------------------------------------------

    def _observe_latency(self, rid, req):
        if req["sent_at"] is None:
            return
        lat = self._clock() - req["sent_at"]
        prev = self._lat_ewma.get(rid)
        self._lat_ewma[rid] = lat if prev is None else 0.5 * prev + 0.5 * lat
        replica = self.replicas[rid]
        med = _median([v for r2, v in self._lat_ewma.items()
                       if r2 != rid and self.replicas[r2].alive])
        if med is None:
            return
        threshold = max(self.min_slow_sec, self.slow_factor * med)
        if replica.state == "live":
            if self._lat_ewma[rid] <= threshold:
                self._suspect[rid] = 0
                return
            self._suspect[rid] += 1
            if self._suspect[rid] >= self.suspect_rounds:
                self._evict_slow(rid, med)
        elif replica.state == "routed_around":
            if lat > threshold:
                self._clean[rid] = 0
                return
            self._clean[rid] += 1
            if self._clean[rid] >= self.readmit_rounds:
                self._maybe_readmit(rid, lat)

    def _evict_slow(self, rid, med):
        self.replica_set.evict(rid)
        self._suspect[rid] = 0
        self._clean[rid] = 0
        self.stats["evicted"] += 1
        self._m["evictions"].inc()
        fids, traces = self.outstanding_of(rid)
        self._tracer.mark("replica_evicted", trace="fleet", severity="warn",
                          replica=rid, ewma_sec=round(self._lat_ewma[rid], 4),
                          fleet_median_sec=round(med, 4), request_ids=fids,
                          trace_ids=traces)
        logger.warning("fleet: routing around slow replica %d (ewma %.3fs "
                       "vs fleet median %.3fs)", rid, self._lat_ewma[rid],
                       med)

    def _maybe_readmit(self, rid, lat):
        gate = self.readmit_gate
        if gate is not None:
            gate.poll()
            if not gate.ready():
                # the health plane has not seen its clean rounds yet:
                # journal once per blocked streak, keep probing
                if not self._gate_blocked.get(rid):
                    self._gate_blocked[rid] = True
                    self._tracer.mark(
                        "readmit_gated", trace="fleet", severity="warn",
                        replica=rid, clean_probe_rounds=self._clean[rid],
                        clean_health_rounds=gate.streak,
                        required_rounds=gate.rounds)
                    logger.info("fleet: re-admission of replica %d gated "
                                "on the health plane (%d/%d clean rounds)",
                                rid, gate.streak, gate.rounds)
                return
        if self._gate_blocked.pop(rid, None):
            self._tracer.mark(
                "readmit_cleared", trace="fleet", replica=rid,
                clean_health_rounds=gate.streak if gate is not None
                else None)
        self.replica_set.readmit(rid)
        self._clean[rid] = 0
        self._lat_ewma[rid] = lat
        self.stats["readmitted"] += 1
        self._m["readmissions"].inc()
        self._tracer.mark("replica_readmitted", trace="fleet", replica=rid)
        logger.info("fleet: re-admitted replica %d after %d clean probe "
                    "round(s)", rid, self.readmit_rounds)

    # -- finalize --------------------------------------------------------

    def _fill(self):
        return self._eos_id if self._eos_id is not None else 0

    def _finalize_resumed_complete(self, fid, req):
        """A re-dispatched request whose committed tokens cover its
        budget: the final row without decoding anything."""
        arr = np.full((self.max_new,), self._fill(), np.int32)
        toks = req["committed"][:self.max_new]
        arr[:len(toks)] = toks
        out = {"generated": arr,
               "generated_len": np.int32(min(req["budget"], len(toks)))}
        req["committed"] = []
        self._reqs.pop(fid, None)
        self._finalize(fid, req, out, None)

    def _finalize(self, fid, req, out, rid):
        committed = req["committed"]
        if "error" in out:
            rec = dict(out["error"])
            rec["request_index"] = fid
            if rid is not None:
                rec["replica"] = rid
            if committed:
                rec["partial"] = committed + list(rec.get("partial", []))
                rec["tokens_done"] = len(rec["partial"])
            if self.on_error == "raise" and rec["kind"] in _RAISE_KINDS:
                raise serving_engine.RequestError(
                    "fleet request {0} failed on replica {1}: {2}".format(
                        fid, rid, rec["message"]),
                    kind=rec["kind"], request_index=fid)
            if rec["kind"] == "deadline":
                self.stats["expired"] += 1
            elif rec["kind"] == "drained":
                self.stats["drained"] += 1
            else:
                self.stats["errors"] += 1
            self._ledger.close(req["rid"],
                               tokens_out=rec.get("tokens_done", 0),
                               latency_sec=self._clock() - req["submit"])
            self._finished[fid] = {"error": rec}
            return
        if committed:
            # the committed prefix and the resumed continuation: equal to
            # an undisturbed greedy run
            gen = np.asarray(out["generated"], np.int32).ravel()
            merged = np.concatenate([np.asarray(committed, np.int32),
                                     gen])[:self.max_new]
            if merged.shape[0] < self.max_new:
                merged = np.concatenate([merged, np.full(
                    (self.max_new - merged.shape[0],), self._fill(),
                    np.int32)])
            out = dict(out, generated=merged)
            if "generated_len" in out:
                out["generated_len"] = np.int32(
                    len(committed) + int(out["generated_len"]))
        # the cost row's authoritative token count: committed plus the
        # continuation (the replica engine closed with its continuation)
        if "generated_len" in out:
            tokens_out = int(out["generated_len"])
        else:
            tokens_out = len(committed) + self.max_new
        if not self._user_emit_len:
            out.pop("generated_len", None)
        out = serving_engine.apply_output_mapping(out, self.output_mapping)
        now = self._clock()
        self.stats["completed"] += 1
        self.stats["latency_sec"][fid] = now - req["submit"]
        self.stats["done_at"][fid] = now - self._t0
        self._m["completed"].inc()
        self._ledger.close(req["rid"], tokens_out=tokens_out,
                           latency_sec=now - req["submit"])
        self._finished[fid] = out

    def _drain_ready(self):
        while self._emit_next in self._finished:
            yield self._finished.pop(self._emit_next)
            self._emit_next += 1

    # -- operator and remediation verbs ----------------------------------

    def deploy_active(self):
        """True while a rolling deploy is mid-step."""
        return self._deploy is not None and not self._deploy.finished

    def set_policy(self, policy):
        """Switch the fleet admission policy at run time (``_pull`` and
        ``_admit`` read it every pass); returns the prior policy."""
        if policy not in serving_engine.POLICIES:
            raise ValueError(
                "fleet policy must be one of {0}, got {1!r}".format(
                    serving_engine.POLICIES, policy))
        prior, self.policy = self.policy, policy
        self.stats["fleet_policy"] = policy
        if policy != prior:
            self._tracer.mark("fleet_policy_changed", trace="fleet",
                              policy=policy, prior=prior)
        return prior

    def scale_up(self):
        """Spawn one replica (:meth:`ReplicaSet.spawn`) and route to it at
        once; returns its id."""
        r = self.replica_set.spawn()
        self.stats["replicas"] = len(self.replicas)
        self.stats["scaled_up"] += 1
        self._m_spawned.inc()
        self._set_live_gauge()
        self._tracer.mark("replica_spawned", trace="fleet",
                          replica_id=r.replica_id,
                          replicas=len(self.replicas))
        return r.replica_id

    def scale_down(self, replica_id=None):
        """Retire one live replica: drain it (no new traffic; its
        in-flight work completes) and close it.  Picks the least-loaded
        live replica when ``replica_id`` is None and never retires the
        last one.  Returns the retired id, or None."""
        live = self._routable()
        if len(live) <= 1:
            return None
        if replica_id is None:
            r = min(live, key=lambda x: (self._assigned_count(x.replica_id),
                                         x.replica_id))
        else:
            r = self.replicas[replica_id]
            if not (r.alive and r.state == "live"):
                return None
        rid = r.replica_id
        fids, trace_ids = self.outstanding_of(rid)
        self.replica_set.drain(rid)
        # the STOP sentinel queues behind any dispatched rows: the worker
        # finishes them, posts "stopped" and exits
        r.close()
        self.stats["scaled_down"] += 1
        self._m_retired.inc()
        self._set_live_gauge()
        self._tracer.mark("replica_retired", trace="fleet", severity="warn",
                          replica_id=rid, request_ids=fids,
                          trace_ids=trace_ids)
        return rid

    # -- rolling deploys -------------------------------------------------

    def start_rolling_deploy(self, params=None, step=None, step_dir=None,
                             **opts):
        """Arm a zero-downtime rolling deploy, advanced one step per serve
        pass (:mod:`.deploy`); returns the
        :class:`~.deploy.RollingDeploy` (poll ``.status``)."""
        from tensorflowonspark_tpu_torch.fleet.deploy import RollingDeploy

        if self._deploy is not None and not self._deploy.finished:
            raise RuntimeError(
                "a rolling deploy is already in progress ({0})".format(
                    self._deploy.status))
        self._deploy = RollingDeploy(params=params, step=step,
                                     step_dir=step_dir, **opts)
        return self._deploy

    def _deploy_step(self):
        if self._deploy is None:
            return
        if self._deploy.step_machine(self):
            self.deploy_history.append(self._deploy.status)
            self._deploy = None

    # -- the routing loop ------------------------------------------------

    def serve(self, rows):
        """Route ``rows`` over the fleet; yields output rows or typed
        records in fleet input order.  The replicas keep running after
        the stream ends (warm caches, pending deploys): close them with
        :meth:`close` (or use :func:`predict_rows_fleet`).  Each call
        opens a fresh stream over the same warm fleet."""
        it = iter(rows)
        self._exhausted = False
        while True:
            self._deploy_step()
            self._pull(it)
            self._note_pressure()
            self._dispatch()
            self._collect()
            yield from self._drain_ready()
            if self._exhausted and not self._reqs and not self._queue:
                # a deploy armed mid-stream finishes against the idle
                # replicas before the generator returns
                while self._deploy is not None:
                    self._deploy_step()
                    time.sleep(self._poll / 5.0)
                yield from self._drain_ready()
                self._roll_up_stats()
                return

    def _roll_up_stats(self):
        per = {}
        for r in self.replicas:
            per[r.replica_id] = dict(r.stats, state=r.state)
        self.stats["per_replica"] = per
        for key in ("admitted", "prefix_hits", "prefix_tokens_saved",
                    "swaps", "swap_commits", "rollbacks", "swap_requeued",
                    "watchdog_fires", "tokens_out"):
            self.stats[key] = sum(int(s.get(key, 0)) for s in per.values())
        # the fleet's decode wall: summed over replicas (the ledger's
        # chip-second rows sum back to it)
        self.stats["decode_wall_sec"] = sum(
            float(s.get("decode_wall_sec", 0.0)) for s in per.values())

    def close(self, timeout=30.0):
        self.replica_set.close(timeout=timeout)


def predict_rows_fleet(predict, rows, input_mapping, output_mapping=None,
                       num_slots=4, *, replicas, stats=None,
                       on_error="raise", queue_depth=None, policy="block",
                       watchdog_timeout=None, default_deadline=None,
                       replica_policy="least_loaded",
                       fleet_queue_depth=None, chunk=None, devices=None):
    """The fleet twin of ``predict_rows(schedule="continuous")``
    (``serving.predict_rows`` routes here when ``replicas > 1``): N
    in-process engine replicas behind a :class:`FleetRouter`.  The same
    contract (dict rows in, rows or typed records out in input order),
    with the engine's overload knobs applied per replica and the
    admission policy fleet-wide (spill before shed)."""
    engine_opts = {}
    if watchdog_timeout is not None:
        engine_opts["watchdog_timeout"] = watchdog_timeout
    if default_deadline is not None:
        engine_opts["default_deadline"] = default_deadline
    router = FleetRouter(
        predict, input_mapping, output_mapping, replicas=int(replicas),
        num_slots=num_slots, chunk=chunk, replica_queue_depth=queue_depth,
        engine_opts=engine_opts, policy=policy, dispatch=replica_policy,
        queue_depth=fleet_queue_depth, on_error=on_error, stats=stats,
        devices=devices,
    )
    try:
        yield from router.serve(rows)
    finally:
        router.close()
