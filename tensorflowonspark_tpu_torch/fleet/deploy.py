"""Zero-downtime rolling deploys across a serving fleet (port of the JAX
package's ``fleet/deploy.py``).

The engine's hot swap gives one replica a weight swap that drops nothing:
quiesce between chunks, install, canary, probation window, automatic
rollback, typed quarantine.  A fleet deploy is that transaction one
replica at a time behind the router's drain, gated on each replica's
health after the swap:

1. **drain**: the router stops dispatching to the target (its state turns
   ``draining``; siblings take the traffic) and waits for its assigned
   requests to complete;
2. **swap**: the new generation is resolved for this replica, either
   in-process ``params`` or a published ``step_dir`` run through the hot
   swap's validation
   (:func:`~tensorflowonspark_tpu_torch.hot_swap.validate_checkpoint`:
   manifest, load, tree shapes and dtypes against the replica's own
   census), then queued with the engine's ``request_swap``; the idle
   replica's lifecycle pass applies it between heartbeats;
3. **gate**: the replica is routed to again and must prove the new
   generation healthy: ``gate="commit"`` (default) waits for the engine's
   probation window to close (``rollback_window`` clean requests, a
   ``swap_commit``), ``gate="applied"`` takes the canary after the
   install alone (deploys against an idle fleet);
4. **next replica**, in order; the first is the canary.

Any failure (a validation rejection, an install refusal, a canary or
probation rollback, a phase timeout) halts the rollout fleet-wide: no
further replica is touched (a canary burn leaves every sibling on the old
generation), the offending step is quarantined so that no watcher offers
it again, and the halt is a ``page``-severity journal event
(``deploy_halted``).

The router's scheduling loop steps the machine
(:meth:`FleetRouter._deploy_step`): one thread, deterministic, and always
interleaved with live traffic.
"""

import logging
import time

from tensorflowonspark_tpu_torch import telemetry

logger = logging.getLogger(__name__)


class DeployHalted(Exception):
    """Raised by :meth:`RollingDeploy.raise_if_halted` for callers that
    want the halt as an exception rather than a status."""


class RollingDeploy(object):
    """One rolling-deploy transaction (see the module docstring).

    Exactly one weight source:

    Args:
      params: in-process new-generation params (``request_swap``'s
        shape).
      step: generation tag for ``params`` (default: each engine's
        ``weight_generation + 1``).
      step_dir: a published step export (``publish_for_serving`` layout),
        validated per replica before it may install.
      gate: ``"commit"`` (the probation window must close under live
        traffic: deploying against an idle fleet with it runs into
        ``phase_timeout``) or ``"applied"`` (the post-install canary
        alone).
      order: replica-id order (default: ascending live ids; the first is
        the canary).
      phase_timeout: seconds a phase may take before the rollout halts
        (``timeout``).
      refuse_grace: seconds a consumed but unapplied swap request may
        dangle before it counts as an install refusal.
      clock: monotonic clock (tests).
    """

    def __init__(self, params=None, step=None, step_dir=None, *,
                 gate="commit", order=None, phase_timeout=120.0,
                 refuse_grace=5.0, clock=None):
        if (params is None) == (step_dir is None):
            raise ValueError(
                "pass exactly one of params= (in-process weights) or "
                "step_dir= (published step export)")
        if gate not in ("commit", "applied"):
            raise ValueError(
                "gate must be 'commit' or 'applied', got %r" % (gate,))
        self.params = params
        self.step = step
        self.step_dir = step_dir
        self.gate = gate
        self.order = list(order) if order is not None else None
        self.phase_timeout = float(phase_timeout)
        self.refuse_grace = float(refuse_grace)
        self._clock = clock if clock is not None else time.monotonic
        self._tracer = telemetry.get_tracer()
        self._i = 0              # index into the replica order
        self._phase = "start"
        self._phase_t0 = None
        self._base = None        # engine stats at the swap's issue
        self._refuse_t0 = None
        self._order_list = []
        self._order0 = None
        self.finished = False
        self.status = {
            "state": "running", "phase": "start", "replica": None,
            "target_step": step if step is not None else (
                "dir:%s" % step_dir if step_dir else None),
            "gate": gate, "replicas_done": [], "halted": None,
            "generations": {},
        }

    # -- bookkeeping -----------------------------------------------------

    def raise_if_halted(self):
        if self.status["state"] == "halted":
            raise DeployHalted(str(self.status["halted"]))

    def _enter(self, phase, rid):
        self._phase = phase
        self._phase_t0 = self._clock()
        self.status["phase"] = phase
        self.status["replica"] = rid
        self._refuse_t0 = None

    @staticmethod
    def _generations(router):
        return {r.replica_id: int(r.stats.get("weight_generation", 0))
                for r in router.replicas}

    def _halt(self, router, rid, kind, message):
        self.status.update({
            "state": "halted",
            "halted": {"replica": rid, "kind": str(kind),
                       "message": str(message)},
            "generations": self._generations(router),
        })
        self.finished = True
        # the halted replica returns to routing on whatever generation it
        # serves (the old one if the swap never landed; the engine rolled
        # itself back otherwise)
        if rid is not None and router.replicas[rid].alive:
            router.replica_set.readmit(rid)
        if self.step_dir is not None and kind != "timeout":
            from tensorflowonspark_tpu_torch import hot_swap

            hot_swap.quarantine(self.step_dir, kind, message)
        fids, traces = ([], []) if rid is None else \
            router.outstanding_of(rid)
        self._tracer.mark(
            "deploy_halted", trace="deploy", severity="page", replica=rid,
            kind=str(kind), canary=(rid == self._order0),
            replicas_done=len(self.status["replicas_done"]),
            request_ids=fids, trace_ids=traces)
        logger.warning("rolling deploy HALTED at replica %s (%s): %s; %d "
                       "of %d replicas deployed", rid, kind, message,
                       len(self.status["replicas_done"]),
                       len(self._order_list))
        return True

    def _done(self, router):
        self.status.update({
            "state": "done", "replica": None, "phase": "done",
            "generations": self._generations(router),
        })
        self.finished = True
        self._tracer.mark("deploy_done", trace="deploy",
                          replicas=len(self.status["replicas_done"]))
        logger.info("rolling deploy done: %d replica(s) on the new "
                    "generation", len(self.status["replicas_done"]))
        return True

    # -- the machine -----------------------------------------------------

    def step_machine(self, router):
        """Advance one step; True once the deploy finished (done or
        halted).  Called from the router's loop: never blocks, never
        raises (a fault is a halt)."""
        try:
            return self._step(router)
        except Exception as e:  # noqa: BLE001 - faults halt, not crash
            logger.warning("rolling deploy step failed", exc_info=True)
            return self._halt(router, self.status.get("replica"),
                              "deploy_error", e)

    def _step(self, router):
        if self.finished:
            return True
        if self._phase == "start":
            self._order_list = (
                self.order if self.order is not None
                else [r.replica_id for r in router.replicas if r.alive])
            if not self._order_list:
                return self._halt(router, None, "no_replicas",
                                  "no live replica to deploy to")
            self._order0 = self._order_list[0]
            self._tracer.mark("deploy_start", trace="deploy",
                              replicas=len(self._order_list),
                              canary=self._order0, gate=self.gate,
                              step=self.status["target_step"])
            self._drain(router, self._order0)
            return False
        rid = self._order_list[self._i]
        replica = router.replicas[rid]
        if not replica.alive:
            # died mid-deploy: skip it (the router re-dispatched its work
            # already); the rollout goes on
            return self._advance(router, rid, swapped=False)
        if self._clock() - self._phase_t0 > self.phase_timeout:
            return self._halt(router, rid, "timeout",
                              "phase {0!r} exceeded {1:.0f}s".format(
                                  self._phase, self.phase_timeout))
        if self._phase == "drain":
            if router._assigned_count(rid):
                return False  # in-flight work still completing
            return self._issue_swap(router, rid, replica)
        if self._phase == "await_apply":
            return self._check_apply(router, rid, replica)
        if self._phase == "gate":
            return self._check_gate(router, rid, replica)
        raise RuntimeError("unknown deploy phase %r" % (self._phase,))

    def _issue_swap(self, router, rid, replica):
        eng = replica.engine
        # the baseline goes before the request: an idle replica can apply
        # the swap within one heartbeat, and a later snapshot would read
        # the applied swap as an install refusal
        self._base = {k: eng.stats[k]
                      for k in ("swaps", "rollbacks", "swap_commits")}
        if self.step_dir is not None:
            from tensorflowonspark_tpu_torch import checkpoint, hot_swap

            spec = getattr(eng.decoder, "param_spec", None)
            expect = spec() if callable(spec) else None
            step = self.step
            if step is None:
                manifest = checkpoint.read_manifest(self.step_dir) or {}
                step = manifest.get("step",
                                    eng.stats["weight_generation"] + 1)
            try:
                w = hot_swap.validate_checkpoint(self.step_dir, step,
                                                 expect=expect)
            except hot_swap.CheckpointRejected as e:
                return self._halt(router, rid, e.kind, e)
            eng.request_swap(w.params, step=w.step,
                             draft_params=w.draft_params)
        else:
            eng.request_swap(self.params, step=self.step)
        self._enter("await_apply", rid)
        return False

    def _check_apply(self, router, rid, replica):
        eng = replica.engine
        if eng.stats["rollbacks"] > self._base["rollbacks"]:
            return self._halt(
                router, rid, "canary_failed",
                "post-install canary rolled replica {0} back".format(rid))
        if eng.stats["swaps"] > self._base["swaps"]:
            # installed: routed to again, to prove itself under traffic
            router.replica_set.readmit(rid)
            self._tracer.mark("deploy_replica_swapped", trace="deploy",
                              replica=rid,
                              generation=eng.stats["weight_generation"])
            if self.gate == "applied":
                return self._advance(router, rid, swapped=True)
            self._enter("gate", rid)
            return False
        if eng._swap_request is None:
            # consumed without a swap or rollback: the engine refused the
            # install (a shape quarantine).  Grace-guarded: the scheduler
            # may be mid-transaction.
            now = self._clock()
            if self._refuse_t0 is None:
                self._refuse_t0 = now
            elif now - self._refuse_t0 > self.refuse_grace:
                return self._halt(
                    router, rid, "install_refused",
                    "replica {0} refused the install (no swap transition "
                    "within {1:.1f}s)".format(rid, self.refuse_grace))
        else:
            self._refuse_t0 = None
        return False

    def _check_gate(self, router, rid, replica):
        eng = replica.engine
        if eng.stats["rollbacks"] > self._base["rollbacks"]:
            return self._halt(
                router, rid, "probation_rollback",
                "replica {0} rolled back inside its probation "
                "window".format(rid))
        if eng.stats["swap_commits"] > self._base["swap_commits"]:
            return self._advance(router, rid, swapped=True)
        return False

    def _advance(self, router, rid, swapped):
        if swapped:
            self.status["replicas_done"].append(rid)
            self._tracer.mark("deploy_replica_done", trace="deploy",
                              replica=rid)
        self.status["generations"] = self._generations(router)
        self._i += 1
        if self._i >= len(self._order_list):
            return self._done(router)
        self._drain(router, self._order_list[self._i])
        return False

    def _drain(self, router, rid):
        """Drain ``rid``, journalling the requests the drain finds in
        flight there."""
        fids, traces = router.outstanding_of(rid)
        self._tracer.mark("deploy_drain", trace="deploy", replica=rid,
                          request_ids=fids, trace_ids=traces)
        self._enter("drain", rid)
        router.replica_set.drain(rid)
