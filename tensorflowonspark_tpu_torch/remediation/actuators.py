"""Actuator bindings: the verbs the remediation engine may drive (port of
the JAX package's ``remediation/actuators.py``).

An actuator object exposes (a subset of) the
:data:`~tensorflowonspark_tpu_torch.remediation.policy.ACTIONS`
vocabulary as methods; the engine resolves ``intent.action`` by
``getattr`` and journals a failure instead of crashing when a verb is
missing or raises (:class:`UnsupportedAction` for a verb that cannot
act).  Production wiring composes:

- :class:`FleetActuators`: serving-side verbs over a
  :class:`~tensorflowonspark_tpu_torch.fleet.router.FleetRouter`:
  spawn/retire/probe replicas, degrade/restore admission, the
  SLO-probation rollback (:func:`~tensorflowonspark_tpu_torch.hot_swap.
  flag_probation_fault` over every probation engine) and the prefill
  worker restart;
- :class:`ClusterActuators`: training-side elastic shrink/grow over a
  :class:`~tensorflowonspark_tpu_torch.cluster.cluster.TPUCluster`:
  ``hold_executor`` quiesces a straggler's compute and re-rendezvouses
  the survivors at reduced width, ``release_executor`` grows it back in
  (behind an optional clean-rounds gate);
- :class:`CombinedActuators`: first-match dispatch over both.

Tests pass a recording fake instead; the engine cannot tell the
difference, so the decision, guardrail and audit layer is the same
against fakes and against the live fleet.  Nothing here imports
``torch`` (``hot_swap`` is imported only when a rollback runs).
"""

import logging

logger = logging.getLogger(__name__)


class UnsupportedAction(RuntimeError):
    """This actuator set has no binding for the requested verb —
    journaled as a failed decision, never a crash."""


class Actuators(object):
    """Base: every verb unsupported.  Subclass and override what the
    deployment can actually drive."""

    def elastic_shrink(self, executor, **kw):
        raise UnsupportedAction("elastic_shrink unbound")

    def elastic_grow(self, executor, **kw):
        raise UnsupportedAction("elastic_grow unbound")

    def spawn_replica(self, **kw):
        raise UnsupportedAction("spawn_replica unbound")

    def retire_replica(self, replica_id=None, **kw):
        raise UnsupportedAction("retire_replica unbound")

    def probe_replica(self, replica_id=None, **kw):
        raise UnsupportedAction("probe_replica unbound")

    def degrade_admission(self, **kw):
        raise UnsupportedAction("degrade_admission unbound")

    def restore_admission(self, **kw):
        raise UnsupportedAction("restore_admission unbound")

    def rollback_generation(self, replicas=None, **kw):
        raise UnsupportedAction("rollback_generation unbound")

    def restart_prefill(self, replica_id=None, **kw):
        raise UnsupportedAction("restart_prefill unbound")


class FleetActuators(Actuators):
    """Serving-side verbs over a live FleetRouter."""

    def __init__(self, router):
        self.router = router
        self._prior_policy = None

    def spawn_replica(self, **kw):
        return self.router.scale_up()

    def retire_replica(self, replica_id=None, **kw):
        rid = self.router.scale_down(replica_id)
        if rid is None:
            raise UnsupportedAction(
                "no retirable replica (last live replica is never "
                "retired)"
            )
        return rid

    def probe_replica(self, replica_id=None, **kw):
        """Route around ``replica_id`` and put it on probe traffic —
        the REVERSIBLE counterpart of ``retire_replica``: the router
        keeps sending it one probe request per ``probe_every``
        dispatches and readmits it after ``readmit_rounds`` clean
        probes (the straggler-detection machinery, driven here by the
        cost policy instead of the latency EWMA)."""
        if replica_id is None:
            raise UnsupportedAction(
                "probe_replica needs a replica_id target"
            )
        rid = int(replica_id)
        replica = (
            self.router.replicas[rid]
            if 0 <= rid < len(self.router.replicas) else None
        )
        if replica is None or not replica.alive:
            raise UnsupportedAction(
                "replica {0} not alive".format(replica_id)
            )
        if replica.state != "live":
            raise UnsupportedAction(
                "replica {0} already {1}".format(rid, replica.state)
            )
        live = sum(
            1 for r in self.router.replicas
            if r.alive and r.state == "live"
        )
        if live <= 1:
            raise UnsupportedAction(
                "refusing to probe the last live replica"
            )
        self.router.replica_set.evict(rid)
        return rid

    def degrade_admission(self, **kw):
        prior = self.router.set_policy("degrade")
        if self._prior_policy is None:
            self._prior_policy = prior
        return prior

    def restore_admission(self, **kw):
        prior, self._prior_policy = self._prior_policy, None
        return self.router.set_policy(prior or "block")

    def rollback_generation(self, replicas=None, **kw):
        """Flag an SLO-probation fault on every (named) replica
        engine still holding a rollback snapshot; each engine rolls
        back between decode chunks on its own scheduling pass."""
        from tensorflowonspark_tpu_torch import hot_swap

        flagged = []
        for r in self.router.replicas:
            if replicas is not None and r.replica_id not in replicas:
                continue
            if hot_swap.flag_probation_fault(
                    r.engine, reason="slo_burn"):
                flagged.append(r.replica_id)
        if not flagged:
            raise UnsupportedAction(
                "no replica engine on post-swap probation — nothing "
                "to roll back"
            )
        return flagged

    def restart_prefill(self, replica_id=None, **kw):
        """Rebuild the PrefillWorker of every (named) disaggregated
        replica engine — the remediation response to
        ``prefill_worker_dead`` / ``prefill_watchdog_fire`` page
        events.  Idempotent with the engine's own in-line containment
        (which already rebuilt the worker it fell over on): a rebuild
        of a healthy worker is cheap (its decoder carries over)
        and re-arms the watchdog."""
        restarted = []
        for r in self.router.replicas:
            eng = r.engine
            if getattr(eng, "_prefill_worker", None) is None:
                continue
            if replica_id is not None and \
                    r.replica_id != int(replica_id):
                continue
            if not r.alive:
                continue
            eng.restart_prefill_worker(reason="remediation")
            restarted.append(r.replica_id)
        if not restarted:
            raise UnsupportedAction(
                "no live disaggregated replica engine to restart a "
                "prefill worker on"
            )
        return restarted


class ClusterActuators(Actuators):
    """Training-side elastic shrink/grow over a TPUCluster (driver
    side).  The supervisor on the held node quiesces its compute and
    bumps the gang generation so survivors re-rendezvous at reduced
    width (cluster/supervisor.py); release takes the same path back
    to full width."""

    def __init__(self, cluster, release_gate=None):
        self.cluster = cluster
        #: optional :class:`~tensorflowonspark_tpu_torch.telemetry.health.
        #: CleanRoundsSensor`: ``elastic_grow`` (releasing a held
        #: executor back into the gang) requires N consecutive clean
        #: health rounds, not a timer — the same quality gate as fleet
        #: re-admission
        self.release_gate = release_gate
        self._gate_blocked = False

    def elastic_shrink(self, executor, **kw):
        return self.cluster.hold_executor(
            executor, reason=kw.get("reason", "remediation")
        )

    def elastic_grow(self, executor, **kw):
        gate = self.release_gate
        if gate is not None:
            gate.poll()
            if not gate.ready():
                if not self._gate_blocked:
                    self._gate_blocked = True
                    from tensorflowonspark_tpu_torch import telemetry

                    telemetry.get_tracer().mark(
                        "readmit_gated", trace="remediation",
                        severity="warn", executor=int(executor),
                        clean_health_rounds=gate.streak,
                        required_rounds=gate.rounds,
                    )
                raise UnsupportedAction(
                    "elastic_grow gated: health plane has {0}/{1} "
                    "clean rounds".format(gate.streak, gate.rounds)
                )
            if self._gate_blocked:
                self._gate_blocked = False
                from tensorflowonspark_tpu_torch import telemetry

                telemetry.get_tracer().mark(
                    "readmit_cleared", trace="remediation",
                    executor=int(executor),
                    clean_health_rounds=gate.streak,
                )
        return self.cluster.release_executor(executor)


class CombinedActuators(Actuators):
    """First-match dispatch over an ordered actuator list — the full
    self-driving deployment binds ``CombinedActuators(
    ClusterActuators(cluster), FleetActuators(router))``."""

    def __init__(self, *actuators):
        self.actuators = list(actuators)

    def _dispatch(self, verb, *a, **kw):
        last = None
        for act in self.actuators:
            try:
                return getattr(act, verb)(*a, **kw)
            except UnsupportedAction as e:
                last = e
        raise last or UnsupportedAction("%s unbound" % verb)

    def elastic_shrink(self, executor, **kw):
        return self._dispatch("elastic_shrink", executor, **kw)

    def elastic_grow(self, executor, **kw):
        return self._dispatch("elastic_grow", executor, **kw)

    def spawn_replica(self, **kw):
        return self._dispatch("spawn_replica", **kw)

    def retire_replica(self, replica_id=None, **kw):
        return self._dispatch(
            "retire_replica", replica_id=replica_id, **kw
        )

    def probe_replica(self, replica_id=None, **kw):
        return self._dispatch(
            "probe_replica", replica_id=replica_id, **kw
        )

    def degrade_admission(self, **kw):
        return self._dispatch("degrade_admission", **kw)

    def restore_admission(self, **kw):
        return self._dispatch("restore_admission", **kw)

    def rollback_generation(self, replicas=None, **kw):
        return self._dispatch(
            "rollback_generation", replicas=replicas, **kw
        )

    def restart_prefill(self, replica_id=None, **kw):
        return self._dispatch(
            "restart_prefill", replica_id=replica_id, **kw
        )
