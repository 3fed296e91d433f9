"""The metric-name catalog: one table every metric name of the port
answers to (port of the JAX package's ``telemetry/catalog.py``, cut to
the metrics the port creates; each row is the reference's row for that
name).

- :data:`METRICS`: name, kind (counter / gauge / histogram), owning
  subsystem, one-line meaning.
- :data:`DYNAMIC_PREFIXES`: families whose full names are minted at run
  time (the usage ledger's per-tenant ``usage.*`` counters).
- :data:`RESERVED_INPUT_COLUMNS`: the reserved request-row inputs, which
  ``serving_engine.RESERVED_INPUTS`` equals.

``tests/test_torch_telemetry.py`` scans the package for literal metric
names and holds each against this table.
"""

import collections

#: The reserved request-row input columns (``serving_engine``'s
#: ``BUDGET_INPUT``, ``DEADLINE_INPUT``, ``TENANT_INPUT``,
#: ``TRACE_INPUT``).
BUDGET_COLUMN = "max_new"          # per-request token budget
DEADLINE_COLUMN = "deadline_sec"   # per-request deadline (seconds)
TENANT_COLUMN = "tenant"           # usage-ledger attribution key
TRACE_COLUMN = "trace_id"          # request trace id

RESERVED_INPUT_COLUMNS = (
    BUDGET_COLUMN, DEADLINE_COLUMN, TENANT_COLUMN, TRACE_COLUMN,
)

Metric = collections.namedtuple("Metric", "name kind source desc")

_C, _G, _H = "counter", "gauge", "histogram"


def _m(kind, source, *pairs):
    return [Metric(name, kind, source, desc) for name, desc in pairs]


#: the metric table, grouped by subsystem prefix
METRICS = tuple(
    # --- serving engine (serving_engine.py + static predict_rows) ---
    _m(_C, "ServingEngine",
       ("serving.admitted", "requests past admission validation"),
       ("serving.completed", "requests emitted with output tokens"),
       ("serving.errors", "typed per-request error records"),
       ("serving.shed", "requests shed by the admission policy"),
       ("serving.expired", "deadline cancellations"),
       ("serving.degraded", "budgets shrunk by the degrade policy"),
       ("serving.chunks", "decode chunks dispatched"),
       ("serving.watchdog_fires", "wedged chunk syncs abandoned"),
       ("serving.recovered", "requests re-admitted after a watchdog teardown"),
       ("serving.prefix_hit_admits", "admits served from the radix cache"),
       ("serving.swaps", "weight swaps installed"),
       ("serving.swap_commits", "probation windows closed clean"),
       ("serving.swap_rollbacks", "swaps rolled back inside the window"),
       ("serving.drained", "requests returned as typed drained records"))
    + _m(_H, "ServingEngine",
         ("serving.request_latency_sec",
          "submit→emit latency, BOTH schedules (the authoritative "
          "p50/p99 source; carries trace-id exemplars)"),
         ("serving.ttft_sec",
          "submit→first-token latency (the number the prefill/decode "
          "split bounds; trace-id exemplars)"),
         ("serving.queue_wait_sec", "admission-queue wait"))
    + _m(_G, "ServingEngine",
         ("serving.weight_generation", "live weight generation tag"))
    + _m(_C, "hot_swap.CheckpointWatcher",
         ("serving.checkpoints_quarantined",
          "serving exports rejected by the validation pipeline"))
    # --- fleet router (fleet/router.py) ---
    + _m(_C, "fleet.FleetRouter",
         ("fleet.dispatched", "requests handed to a replica"),
         ("fleet.redispatched", "in-flight work re-dispatched off a dead replica"),
         ("fleet.completed", "requests emitted fleet-wide"),
         ("fleet.shed", "fleet-level admission sheds (spill-before-shed)"),
         ("fleet.affinity_hits", "prefix-affinity dispatches that hit their replica"),
         ("fleet.replica_deaths", "replica worker deaths observed"),
         ("fleet.evictions", "slow replicas routed around"),
         ("fleet.readmissions", "probed replicas re-admitted"))
    + _m(_C, "fleet.FleetRouter remediation verbs",
         ("fleet.replicas_spawned", "replicas added by scale_up"),
         ("fleet.replicas_retired", "replicas drained away by scale_down"))
    + _m(_G, "fleet.FleetRouter",
         ("fleet.live_replicas", "replicas currently taking dispatch"))
    # --- radix prefix cache (prefix_cache.py) ---
    + _m(_C, "radix prefix cache",
         ("prefix_cache.hits", "cached-prefix admit hits"),
         ("prefix_cache.misses", "cold admits"),
         ("prefix_cache.tokens_saved", "prompt tokens not re-prefilled"),
         ("prefix_cache.evictions", "cold leaves evicted under the HBM budget"))
    + _m(_G, "radix prefix cache",
         ("prefix_cache.bytes_used", "device bytes held by committed blocks"))
    # --- training loop (parallel/dp.py) ---
    + _m(_C, "SyncTrainer.train_on_feed",
         ("train.steps", "optimizer steps taken"))
    + _m(_H, "SyncTrainer.train_on_feed",
         ("train.step_sec", "per-step wall time"),
         ("train.feed_wait_sec", "feed-starvation wait per step"),
         ("train.h2d_sec", "host→device transfer (straggler phase series)"),
         ("train.dispatch_sec", "step dispatch (straggler phase series)"))
    # --- parameter-server wire (parallel/ps.py) ---
    + _m(_C, "PSClient",
         ("ps.bytes_sent", "exact frame bytes onto the wire"),
         ("ps.bytes_recv", "exact frame bytes off the wire (delta replies)"),
         ("ps.round_trips", "push/pull round trips"))
    + _m(_H, "PSClient / AsyncTrainer drain",
         ("ps.round_trip_sec", "wire round-trip latency"),
         ("ps.grad_readback_sec", "device→host gradient readback"))
    # --- data plane (data/feed.py, data/shm_ring.py) ---
    + _m(_C, "DataFeed",
         ("feed.wire_bytes", "feed payload bytes (twin of wire_stats())"),
         ("feed.wire_records", "wire records decoded"),
         ("feed.wire_rows", "rows decoded"))
    + _m(_C, "ShmRing",
         ("ring.push_records", "records pushed into the shm ring"),
         ("ring.push_bytes", "bytes pushed into the shm ring"),
         ("ring.pop_records", "records popped off the shm ring"),
         ("ring.pop_bytes", "bytes popped off the shm ring"))
    # --- cluster lifecycle (cluster/supervisor.py, cluster/cluster.py) ---
    + _m(_C, "supervisor + driver monitor",
         ("cluster.restarts", "compute-process restarts (supervisor-side)"),
         ("cluster.restart_events", "restarts observed by the driver monitor"))
    + _m(_G, "supervisor heartbeat",
         ("cluster.generation", "rendezvous generation on the beat"))
    # --- health plane (telemetry/health.py) ---
    + _m(_C, "HealthPlane / SloEngine / StragglerDetector",
         ("health.scrapes", "scrape→store→evaluate rounds"),
         ("health.alerts_fired", "SLO alert fire transitions"),
         ("health.alerts_resolved", "SLO alert resolve transitions"),
         ("health.stragglers_flagged", "executors flagged as stragglers"),
         ("health.stragglers_cleared", "straggler hints expired clean"),
         ("health.profile_captures", "auto-triggered profile captures"))
    + _m(_G, "HealthPlane / supervisor beat",
         ("health.alerts_active", "currently-firing alerts"),
         ("health.straggler", "per-node straggler hint flag (beat-side)"))
    # --- telemetry substrate itself ---
    + _m(_C, "Tracer bounded store",
         ("tracing.dropped_spans", "spans evicted by the bounded ring"))
    + _m(_C, "EventJournal",
         ("journal.events", "typed events appended"),
         ("journal.dropped_events", "events evicted from a severity ring"))
    + _m(_C, "blackbox.FlightRecorder",
         ("blackbox.dumps", "dump bundles frozen to disk"),
         ("blackbox.dumps_suppressed", "triggers rate-limited away"))
    # --- remediation engine (remediation/engine.py) ---
    + _m(_C, "remediation.RemediationEngine",
         ("remediation.decisions", "policy intents that reached the audit log"),
         ("remediation.actions_executed", "actuator verbs actually invoked"),
         ("remediation.actions_suppressed",
          "intents stopped by a cooldown or rate limit"),
         ("remediation.actions_deferred",
          "intents parked by the deploy-conflict rule"))
    + _m(_G, "remediation.RemediationEngine",
         ("remediation.budget_remaining",
          "global action budget left before hands-off"))
)

#: families whose full names are minted at run time: a name under one of
#: these prefixes is known without a row of its own
DYNAMIC_PREFIXES = {
    "usage.":
        "per-tenant usage-ledger mirror counters "
        "(``usage.<field>.<tenant>``, bounded tenant set — "
        "telemetry/ledger.py)",
}

#: the set of names, for membership checks
NAMES = frozenset(m.name for m in METRICS)


def known(name):
    """True when ``name`` is a row of :data:`METRICS` or under a
    :data:`DYNAMIC_PREFIXES` family."""
    return name in NAMES or any(
        name.startswith(p) for p in DYNAMIC_PREFIXES
    )


def duplicates():
    """Names declared twice (the tests hold this empty)."""
    seen, dups = set(), []
    for m in METRICS:
        if m.name in seen:
            dups.append(m.name)
        seen.add(m.name)
    return dups
