"""The telemetry plane (port of the JAX package's ``telemetry/``):

- :mod:`.registry`: counters, gauges and fixed-bucket histograms with
  interpolated p50/p99, exported as plain dicts (``snapshot`` /
  ``snapshot_delta``);
- :mod:`.tracing`: spans with trace and parent ids, exported as Chrome
  trace JSON;
- :mod:`.journal`: the typed event journal every tracer mark forwards
  to, in severity-split rings with optional JSONL persistence;
- :mod:`.blackbox`: the flight recorder, which freezes the rings into a
  dump bundle on a fault event;
- :mod:`.ledger`: the per-request and per-tenant usage ledger (decode
  chip-seconds, KV page-seconds, tokens, prefix tokens saved);
- :mod:`.aggregate`: the compute process's publisher into the node's kv
  (shipped on the heartbeats) and merging snapshots into a fleet view;
- :mod:`.health`: the fleet health plane (windowed time series, SLO
  rules, straggler diagnosis) and the ``/status`` provider registry;
- :mod:`.exposition`: its HTTP surface (OpenMetrics ``/metrics``,
  ``/healthz``, ``/status``, ``/usage``, ``/journal``) and the strict
  OpenMetrics parser;
- :mod:`.catalog`: the table of metric names.

``TFOS_TELEMETRY=0`` (or ``set_enabled(False)``) makes the registry hand
out shared null metrics and the tracer a shared null span: nothing
allocates or locks on the hot path.
"""

from tensorflowonspark_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_COUNTER,
    NULL_GAUGE,
    NULL_HISTOGRAM,
    enabled,
    get_registry,
    histogram_percentile,
    set_enabled,
    snapshot_delta,
    tail_exemplars,
)
from tensorflowonspark_tpu_torch.telemetry.tracing import (  # noqa: F401
    Tracer,
    get_tracer,
    merge_traces,
)
from tensorflowonspark_tpu_torch.telemetry.journal import (  # noqa: F401
    Event,
    EventJournal,
    get_journal,
    load_journal,
)
from tensorflowonspark_tpu_torch.telemetry.blackbox import (  # noqa: F401
    FlightRecorder,
    get_recorder,
    load_dump,
)
from tensorflowonspark_tpu_torch.telemetry.aggregate import (  # noqa: F401
    NodePublisher,
    fleet_view,
    merge_snapshots,
    start_node_publisher,
)
from tensorflowonspark_tpu_torch.telemetry.ledger import (  # noqa: F401
    DEFAULT_TENANT,
    SpaceSaving,
    UsageLedger,
    get_ledger,
    merge_usage,
    tenants_from_snapshot,
    usage_openmetrics,
)
from tensorflowonspark_tpu_torch.telemetry.health import (  # noqa: F401
    Alert,
    HealthPlane,
    SloEngine,
    SloRule,
    StragglerDetector,
    TimeSeriesStore,
    load_rules,
    provider_statuses,
    register_status_provider,
    unregister_status_provider,
)
from tensorflowonspark_tpu_torch.telemetry.exposition import (  # noqa: F401
    ExpositionServer,
    parse_openmetrics,
    to_openmetrics,
)
