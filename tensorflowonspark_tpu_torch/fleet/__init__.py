"""The fleet serving plane: N engine replicas behind one router (port of
the JAX package's ``fleet/``).

Below this package the serving stack is one engine
(:class:`~tensorflowonspark_tpu_torch.serving_engine.ServingEngine`:
admission control, deadlines, watchdog recovery, prefix cache, live hot
swap).  This package is the plane one level above it:

- :mod:`.replica`: :class:`ReplicaSet` owns N in-process engine replicas
  (each with its own slot decoder, KV pool, radix cache, thread and CUDA
  stream), with per-replica lifecycle (spawn, drain, evict, re-admit) and
  a cheap ``load()`` snapshot;
- :mod:`.router`: :class:`FleetRouter`, a bounded fleet admission queue,
  dispatch policies (least-loaded, prefix affinity over block-granular
  prompt fingerprints, weighted round-robin, random), fleet-level shed and
  degrade that spill to a sibling replica before any engine sheds, and
  re-dispatch from the committed tokens when a replica dies;
- :mod:`.deploy`: :class:`RollingDeploy`, rolling weight deploys one
  replica at a time behind the router's drain, gated on each replica's
  health after the swap, halted fleet-wide when the canary burns.
"""

from tensorflowonspark_tpu_torch.fleet.deploy import (  # noqa: F401
    DeployHalted,
    RollingDeploy,
)
from tensorflowonspark_tpu_torch.fleet.replica import (  # noqa: F401
    Replica,
    ReplicaKilled,
    ReplicaSet,
)
from tensorflowonspark_tpu_torch.fleet.router import (  # noqa: F401
    DISPATCH_POLICIES,
    FleetRouter,
    predict_rows_fleet,
)
