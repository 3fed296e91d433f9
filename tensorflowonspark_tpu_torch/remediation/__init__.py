"""Audited remediation: the policy engine that closes the fleet's
sensor->actuator loop (port of the JAX package's ``remediation/``).

The sensors (SLO burn and straggler attribution in
``telemetry/health.py``, the typed event journal, the usage ledger's
cost rows, the router's windowed admission pressure) and the actuators
(elastic holds in ``cluster/``, probation rollback in ``hot_swap.py``,
the fleet's replica verbs) exist below this package.  This package is
the middle: policies read the sensors through cursors, guardrails
(cooldowns, a rate limit, a global action budget, hysteresis, dry-run,
the deploy-conflict rule) bound what may execute, and every decision
lands in the journal as a typed ``remediation_decision`` event carrying
its triggering evidence, so ``forensics explain`` answers "why did the
fleet do that?" the same way it answers "what failed?".

Quick start (serving only)::

    from tensorflowonspark_tpu_torch import remediation

    eng = remediation.wire(plane, router=router).start()
    ...
    eng.stop()

Training: ``TPUCluster.start_remediation(...)`` wires the engine over a
cluster's health plane (elastic shrink and grow through
``hold_executor`` / ``release_executor``).  Nothing here imports
``torch``: the cluster plane runs it in the driver.
"""

from tensorflowonspark_tpu_torch.remediation.actuators import (  # noqa: F401
    Actuators, ClusterActuators, CombinedActuators, FleetActuators,
    UnsupportedAction,
)
from tensorflowonspark_tpu_torch.remediation.engine import (  # noqa: F401
    Guardrails, RemediationEngine, Sensors, SensorSnapshot,
)
from tensorflowonspark_tpu_torch.remediation.policy import (  # noqa: F401
    ACTIONS, AutoscalePolicy, CostPolicy, FaultResponsePolicy, Intent,
    PageAlertPolicy, Policy, SloRollbackPolicy, StragglerPolicy,
    default_policies,
)


def wire(plane=None, router=None, cluster=None, policies=None,
         guardrails=None, interval=1.0, clock=None, **overrides):
    """Build a :class:`RemediationEngine` over the live planes.

    Args:
      plane: a :class:`~tensorflowonspark_tpu_torch.telemetry.health.
        HealthPlane` (alerts via the ``alerts_since`` cursor and the
        straggler hints).  None is allowed for router-only wiring.
      router: a :class:`~tensorflowonspark_tpu_torch.fleet.router.
        FleetRouter`: binds the serving verbs, the pressure sensor, the
        probation sensor and the deploy-conflict rule.
      cluster: a :class:`~tensorflowonspark_tpu_torch.cluster.cluster.
        TPUCluster`: binds elastic shrink/grow and the fleet-shipped
        journal sensor (without it, this process's own journal).
      policies / guardrails / interval / clock: forwarded to the engine;
        ``overrides`` forward to :func:`default_policies` when
        ``policies`` is None.
    """
    from tensorflowonspark_tpu_torch import telemetry

    slo = hints_fn = None
    if plane is not None:
        slo = plane.slo
        hints_fn = lambda: dict(plane.hints)  # noqa: E731
    journal = events_fn = None
    if cluster is not None:
        def events_fn():
            return (cluster.journal() or {}).get("events", [])
    else:
        journal = telemetry.get_journal()
    pressure_fn = fleet_fn = probation_fn = deploy_fn = None
    if router is not None:
        pressure_fn = router.pressure

        def fleet_fn():
            status = router.health_status()
            return {
                "replicas": len(router.replicas),
                "live": sum(1 for r in router.replicas
                            if r.alive and r.state == "live"),
                # the usage-ledger cost rows: CostPolicy's input
                "costs": status.get("costs", {}),
            }

        def probation_fn():
            return [r.replica_id for r in router.replicas
                    if r.alive and getattr(r.engine, "_prev_weights",
                                           None) is not None]

        deploy_fn = router.deploy_active
    sensors = Sensors(
        slo=slo, hints_fn=hints_fn, journal=journal, events_fn=events_fn,
        pressure_fn=pressure_fn, fleet_fn=fleet_fn,
        probation_fn=probation_fn, deploy_active_fn=deploy_fn, clock=clock,
    )
    acts = []
    if cluster is not None:
        acts.append(ClusterActuators(cluster))
    if router is not None:
        acts.append(FleetActuators(router))
    if not acts:
        actuators = Actuators()  # every verb journals as unsupported
    elif len(acts) == 1:
        actuators = acts[0]
    else:
        actuators = CombinedActuators(*acts)
    if policies is None:
        policies = default_policies(**overrides)
    elif overrides:
        raise ValueError("pass policy overrides OR an explicit policy "
                         "list, not both")
    return RemediationEngine(sensors, actuators, policies=policies,
                             guardrails=guardrails, interval=interval,
                             clock=clock)
