"""Remediation policies: sensor snapshots in, typed intents out (port of
the JAX package's ``remediation/policy.py``).

A policy is a small stateful object that scores ONE failure signature
against each :class:`~tensorflowonspark_tpu_torch.remediation.engine.
SensorSnapshot` and emits :class:`Intent` records when it wants an
actuator driven.  Policies carry their own hysteresis (``sustain``
consecutive asserting rounds before the first intent; the engine's
cooldowns then bound how often an intent may execute), and every intent
names the evidence that justified it: the alert transition (with its
``seq`` cursor), the journal event ids ``(executor, pid, seq)``, the
straggler hint with its phase attribution, or the admission-pressure
excerpt.  ``forensics explain`` renders that evidence back, so "why did
the fleet do that?" has a literal answer in the journal.

Hysteresis state flips on EXECUTION feedback, not on emission: the
engine reports every journaled decision back through
:meth:`Policy.on_decision`, and only an executed (or dry-run rehearsed)
action moves a policy's latches (``held``, ``degraded``).  An intent
suppressed by the rate limit or budget, or failed by the actuator,
leaves the policy asserting, so the action is retried once the
guardrails allow.

The default set (:func:`default_policies`):

- :class:`StragglerPolicy`: straggler-flagged executor -> elastic shrink
  (hold and re-rendezvous at reduced width); N clean rounds -> elastic
  grow;
- :class:`AutoscalePolicy`: sustained admission pressure -> spawn a
  serving replica; sustained idle slots -> retire one;
- :class:`PageAlertPolicy`: page-severity SLO alert -> degrade
  admission; resolve -> restore;
- :class:`SloRollbackPolicy`: SLO burn while a weight generation is on
  post-swap probation -> roll the generation back;
- :class:`FaultResponsePolicy`: journal fault events the lower planes
  already handled: a dead or quarantined replica is re-spawned, a dead
  or wedged prefill worker restarted, and automatic recoveries get an
  explicit ``stand_down`` decision;
- :class:`CostPolicy`: the usage ledger's per-replica cost rows: probe,
  then evict, the replica burning the most chip-seconds per emitted
  token relative to the fleet median.

Nothing here imports ``torch``.
"""

import logging

logger = logging.getLogger(__name__)

#: the actuator verb vocabulary (attribute names on an Actuators
#: implementation); ``stand_down`` is virtual — it never reaches an
#: actuator, it IS the decision
ACTIONS = (
    "elastic_shrink", "elastic_grow", "spawn_replica",
    "retire_replica", "degrade_admission", "restore_admission",
    "rollback_generation", "probe_replica", "restart_prefill",
    "stand_down",
)


def _freeze(v):
    """Recursively turn ``v`` into a hashable canonical form."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(_freeze(x) for x in v))
    return v


class Intent(object):
    """One policy's wish: drive ``action`` against ``target`` because
    of ``evidence``.  Plain data; the engine turns it into an audited
    decision (or a suppression)."""

    __slots__ = ("action", "policy", "target", "evidence", "severity",
                 "reason")

    def __init__(self, action, policy, target=None, evidence=None,
                 severity="warn", reason=""):
        if action not in ACTIONS:
            raise ValueError(
                "unknown remediation action {0!r}; one of {1}".format(
                    action, ACTIONS
                )
            )
        self.action = action
        self.policy = policy
        self.target = dict(target or {})
        self.evidence = dict(evidence or {})
        self.severity = severity
        self.reason = reason

    def key(self):
        """Cooldown identity: the action plus its stable target.
        Target values are canonicalized (lists/dicts/sets frozen) so
        the key is always hashable — ``rollback_generation`` targets
        a replica LIST."""
        return (self.action, _freeze(self.target))

    def to_dict(self):
        return {
            "action": self.action, "policy": self.policy,
            "target": self.target, "evidence": self.evidence,
            "severity": self.severity, "reason": self.reason,
        }

    def __repr__(self):
        return "Intent({0} by {1} on {2})".format(
            self.action, self.policy, self.target
        )


class Policy(object):
    """Base policy: subclasses set ``name`` and implement
    :meth:`evaluate` returning a list of :class:`Intent`.  Policies
    are single-threaded — only the engine's loop calls them."""

    name = "policy"

    def evaluate(self, snap):
        raise NotImplementedError

    def on_decision(self, rec):
        """Execution feedback: the engine calls this with every
        decision record it journals for this policy (``executed``,
        ``dry_run``, ``error`` tell the outcome).  Suppressed intents
        get NO callback — stateful policies flip their hysteresis
        latches only here, so a suppressed or failed action is
        re-intended and retried once the guardrails allow."""

    @staticmethod
    def _acted(rec):
        """True when the decision took effect (a dry-run rehearsal
        counts — the preview must walk the same state sequence the
        armed engine would)."""
        return bool(rec.get("executed") or rec.get("dry_run"))

    def _intent(self, action, **kw):
        return Intent(action, self.name, **kw)


class StragglerPolicy(Policy):
    """Elastic shrink/grow from the health plane's straggler hints.

    An executor flagged for ``sustain`` consecutive rounds is shrunk
    out of the gang (``elastic_shrink`` — the cluster actuator holds
    its compute and re-rendezvouses the survivors at reduced width).
    A held executor absent from the hints for ``grow_after``
    consecutive rounds is grown back in (``elastic_grow``).  Evidence
    is the hint itself — it carries the detector's phase attribution
    (the measured dominant phase, feed/h2d/dispatch/wire/host), so
    the decision names WHY the executor was slow, not just that it
    was.

    ``held`` moves on execution feedback (:meth:`on_decision`), never
    on emission: a shrink suppressed by the rate limit or failed by
    the actuator leaves the executor un-held and the intent retried,
    and a grow is never emitted for an executor that was never
    actually held.
    """

    name = "straggler-elastic"

    def __init__(self, sustain=2, grow_after=3):
        self.sustain = max(1, int(sustain))
        self.grow_after = max(1, int(grow_after))
        self._rounds = {}        # executor -> consecutive flagged rounds
        self._clean = {}         # held executor -> consecutive clean rounds
        self.held = set()

    def evaluate(self, snap):
        out = []
        hints = snap.hints or {}
        for eid, hint in sorted(hints.items()):
            if eid in self.held:
                self._clean[eid] = 0
                continue
            self._rounds[eid] = self._rounds.get(eid, 0) + 1
            if self._rounds[eid] >= self.sustain:
                out.append(self._intent(
                    "elastic_shrink", target={"executor": eid},
                    evidence={"hint": dict(hint)},
                    reason="straggler flagged {0} consecutive rounds "
                           "(phase {1!r})".format(
                               self._rounds[eid], hint.get("phase")
                           ),
                ))
        for eid in list(self._rounds):
            if eid not in hints:
                self._rounds.pop(eid, None)
        for eid in sorted(self.held):
            if eid in hints:
                continue
            self._clean[eid] = self._clean.get(eid, 0) + 1
            if self._clean[eid] >= self.grow_after:
                out.append(self._intent(
                    "elastic_grow", target={"executor": eid},
                    evidence={"clean_rounds": self._clean[eid]},
                    severity="info",
                    reason="held executor clean for {0} rounds".format(
                        self._clean[eid]
                    ),
                ))
        return out

    def on_decision(self, rec):
        if not self._acted(rec):
            return
        eid = (rec.get("target") or {}).get("executor")
        if eid is None:
            return
        if rec.get("action") == "elastic_shrink":
            self.held.add(eid)
            self._rounds.pop(eid, None)
            self._clean[eid] = 0
        elif rec.get("action") == "elastic_grow":
            self.held.discard(eid)
            self._clean.pop(eid, None)


class AutoscalePolicy(Policy):
    """Serving autoscale from the router's windowed admission
    pressure (the router's lifecycle verbs as a closed loop): mean queue
    occupancy above ``high`` (or any shedding) for ``sustain``
    consecutive rounds spawns a replica; occupancy below ``low`` with
    idle slots for ``sustain_down`` rounds retires one.  Bounded by
    ``min_replicas``/``max_replicas`` so a runaway signal can never
    scale to zero or to infinity.  Evidence is the pressure excerpt
    itself — the SAME statistic ``/status`` shows an operator."""

    name = "fleet-autoscale"

    def __init__(self, high=0.75, low=0.10, sustain=3,
                 sustain_down=6, min_replicas=1, max_replicas=8):
        self.high = float(high)
        self.low = float(low)
        self.sustain = max(1, int(sustain))
        self.sustain_down = max(1, int(sustain_down))
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = int(max_replicas)
        self._hot = 0
        self._cold = 0

    def evaluate(self, snap):
        p = snap.pressure
        fleet = snap.fleet or {}
        if not p:
            return []
        live = int(fleet.get("live", fleet.get("replicas", 0)) or 0)
        hot = (p.get("occupancy_mean", 0.0) >= self.high
               or p.get("shed_per_sec", 0.0) > 0.0)
        cold = (p.get("occupancy_peak", 0.0) <= self.low
                and p.get("free_slots", 0) > 0
                and p.get("shed_per_sec", 0.0) == 0.0)
        self._hot = self._hot + 1 if hot else 0
        self._cold = self._cold + 1 if cold else 0
        excerpt = {k: p.get(k) for k in (
            "window_sec", "occupancy", "occupancy_mean",
            "occupancy_peak", "shed_per_sec", "spill_per_sec",
            "free_slots",
        )}
        if self._hot >= self.sustain and live < self.max_replicas:
            self._hot = 0
            return [self._intent(
                "spawn_replica", evidence={"pressure": excerpt},
                reason="admission pressure sustained {0} rounds "
                       "(occupancy_mean {1}, shed/s {2})".format(
                           self.sustain, excerpt["occupancy_mean"],
                           excerpt["shed_per_sec"],
                       ),
            )]
        if self._cold >= self.sustain_down and live > self.min_replicas:
            self._cold = 0
            return [self._intent(
                "retire_replica", evidence={"pressure": excerpt},
                severity="info",
                reason="idle slots sustained {0} rounds".format(
                    self.sustain_down
                ),
            )]
        return []


class PageAlertPolicy(Policy):
    """Degrade admission on any PAGE-severity alert firing; restore
    when the pages that caused the degrade have all resolved.
    Evidence is the alert transition (with its ``alerts_since``
    cursor seq) — the decision and the page that caused it share a
    journal-visible id.

    ``degraded`` flips on execution feedback (:meth:`on_decision`):
    a degrade suppressed or failed while the pages still fire is
    re-intended every round until it actually lands — the latch can
    never read "degraded" while admission was left untouched."""

    name = "page-degrade"

    def __init__(self):
        self._paging = {}   # rule -> firing alert dict
        self.degraded = False

    def evaluate(self, snap):
        out = []
        for a in snap.alerts:
            if a.get("severity") != "page":
                continue
            if a.get("state") == "firing":
                self._paging[a.get("rule")] = dict(a)
            elif a.get("state") == "resolved":
                self._paging.pop(a.get("rule"), None)
        if self._paging and not self.degraded:
            worst = sorted(self._paging.values(),
                           key=lambda d: d.get("seq", 0))[-1]
            out.append(self._intent(
                "degrade_admission",
                evidence={"alert": worst,
                          "paging_rules": sorted(self._paging)},
                severity="page",
                reason="page alert {0!r} firing".format(
                    worst.get("rule")
                ),
            ))
        elif not self._paging and self.degraded:
            out.append(self._intent(
                "restore_admission",
                evidence={"resolved": True}, severity="info",
                reason="all page alerts resolved",
            ))
        return out

    def on_decision(self, rec):
        if not self._acted(rec):
            return
        if rec.get("action") == "degrade_admission":
            self.degraded = True
        elif rec.get("action") == "restore_admission":
            self.degraded = False


class SloRollbackPolicy(Policy):
    """Roll a weight generation back when fleet-level SLO burn
    exceeds budget while the generation is still on post-swap
    probation — the engine's probation window, extended from request-level
    errors to the SLO plane.  Fires on ``burn:`` / ``burn_rate``
    alerts (any warn+ severity) only when ``snap.probation`` names
    replicas whose engines hold a rollback snapshot; the rollback
    itself is the engine's own (applied between decode chunks, via
    :func:`~tensorflowonspark_tpu_torch.hot_swap.flag_probation_fault`)."""

    name = "slo-rollback"

    def __init__(self, rules=None):
        #: None = any firing alert whose rule name contains "burn" or
        #: whose message names a burn_rate breach; else an explicit
        #: rule-name allowlist
        self.rules = set(rules) if rules else None

    def _matches(self, a):
        if self.rules is not None:
            return a.get("rule") in self.rules
        rule = a.get("rule") or ""
        return "burn" in rule or "burn_rate" in (a.get("message") or "")

    def evaluate(self, snap):
        if not snap.probation:
            return []
        for a in snap.alerts:
            if a.get("state") == "firing" and self._matches(a):
                return [self._intent(
                    "rollback_generation",
                    target={"replicas": sorted(snap.probation)},
                    evidence={"alert": dict(a),
                              "probation": sorted(snap.probation)},
                    severity="page",
                    reason="SLO burn {0!r} while generation on "
                           "probation".format(a.get("rule")),
                )]
        return []


class CostPolicy(Policy):
    """Cost-efficiency policy over the usage ledger's per-replica
    cost rows: probe — and, if it stays bad,
    evict — the replica with the worst **chip-seconds per emitted
    token**, not merely the slowest one.  A replica can be perfectly
    responsive yet burn 3x the chips per token (quantization fell
    back to float, a cold kernel path, thermal throttling): latency
    policies never see it, the ledger does.

    Reads the usage ledger's cost rows off ``snap.fleet["costs"]`` (the
    router's ``health_status()`` mirror of the usage ledger) — or an
    injected ``ledger_fn`` (the fake-ledger unit test's seam).  A
    replica whose ratio exceeds ``ratio_factor`` x the fleet median
    for ``sustain`` consecutive rounds gets a ``probe_replica``
    intent (the router routes around it and probes it for recovery —
    reversible); one that STAYS the outlier for ``evict_after``
    further rounds after the probe executed gets ``retire_replica``
    (permanent).  Every intent carries the ratio table it was judged
    on.  Replicas with fewer than ``min_tokens`` emitted are not
    judged — a cold replica's ratio is all prefill."""

    name = "cost-efficiency"

    def __init__(self, ratio_factor=2.0, min_tokens=256, sustain=3,
                 evict_after=3, ledger_fn=None):
        self.ratio_factor = float(ratio_factor)
        self.min_tokens = int(min_tokens)
        self.sustain = max(1, int(sustain))
        self.evict_after = max(1, int(evict_after))
        self.ledger_fn = ledger_fn
        self._worst_rounds = {}   # rid -> consecutive outlier rounds
        self._post_probe = {}     # probed rid -> outlier rounds since
        self.probed = set()

    def _rows(self, snap):
        if self.ledger_fn is not None:
            return self.ledger_fn() or {}
        return ((snap.fleet or {}).get("costs")
                if isinstance(snap.fleet, dict) else None) or {}

    def evaluate(self, snap):
        from tensorflowonspark_tpu_torch.telemetry.ledger import (
            chip_sec_per_token,
        )

        rows = self._rows(snap)
        judged = {
            rid: row for rid, row in rows.items()
            if row.get("state") in (None, "live", "routed_around")
        }
        ratios = chip_sec_per_token(judged, min_tokens=self.min_tokens)
        if len(ratios) < 2:
            self._worst_rounds.clear()
            return []
        med = sorted(ratios.values())[len(ratios) // 2]
        worst = max(sorted(ratios), key=lambda r: ratios[r])
        outlier = med > 0 and ratios[worst] >= self.ratio_factor * med
        for rid in list(self._worst_rounds):
            if rid != worst or not outlier:
                self._worst_rounds.pop(rid, None)
        for rid in list(self._post_probe):
            if rid != worst or not outlier:
                # recovered (or another replica became the problem):
                # the router's probe traffic readmits it; a later
                # regression starts a fresh probe cycle
                self._post_probe.pop(rid, None)
                self.probed.discard(rid)
        if not outlier:
            return []
        evidence = {
            "ratios_chip_sec_per_token": {
                r: round(v, 6) for r, v in sorted(ratios.items())
            },
            "worst": worst,
            "median": round(med, 6),
            "threshold_factor": self.ratio_factor,
            "row": dict(rows.get(worst) or {}),
        }
        if worst in self.probed:
            self._post_probe[worst] = self._post_probe.get(worst, 0) + 1
            evidence["post_probe_rounds"] = self._post_probe[worst]
            if self._post_probe[worst] >= self.evict_after:
                return [self._intent(
                    "retire_replica",
                    target={"replica_id": worst}, evidence=evidence,
                    reason="still {0:.1f}x the median chip_sec/token "
                           "{1} rounds after probe".format(
                               ratios[worst] / med,
                               self._post_probe[worst]),
                )]
            return []
        self._worst_rounds[worst] = self._worst_rounds.get(worst, 0) + 1
        evidence["sustained_rounds"] = self._worst_rounds[worst]
        if self._worst_rounds[worst] >= self.sustain:
            return [self._intent(
                "probe_replica",
                target={"replica_id": worst}, evidence=evidence,
                reason="worst chip_sec/token at {0:.1f}x the fleet "
                       "median for {1} rounds".format(
                           ratios[worst] / med,
                           self._worst_rounds[worst]),
            )]
        return []

    def on_decision(self, rec):
        if not self._acted(rec):
            return
        rid = (rec.get("target") or {}).get("replica_id")
        if rid is None:
            return
        if rec.get("action") == "probe_replica":
            self.probed.add(rid)
            self._worst_rounds.pop(rid, None)
            self._post_probe[rid] = 0
        elif rec.get("action") == "retire_replica":
            self.probed.discard(rid)
            self._post_probe.pop(rid, None)
            self._worst_rounds.pop(rid, None)


#: journal fault kinds → the policy's response action.  Faults whose
#: recovery is ALREADY owned by a lower plane get an explicit
#: ``stand_down`` decision — the audit trail must show remediation
#: saw the fault and chose not to fight the recovery in progress,
#: the same philosophy as the deploy-conflict guardrail.
FAULT_RESPONSES = {
    "replica_dead": "spawn_replica",
    "leader_failover": "stand_down",
    "swap_rollback": "stand_down",
    "checkpoint_quarantined": "stand_down",
    "deploy_halted": "stand_down",
    # disaggregated-serving containment: the engine's
    # in-line containment already rebuilt the worker it fell over
    # on — the remediation restart re-arms supervision fleet-wide
    # (idempotent); a quarantined replica keeps serving probe
    # traffic, so lost capacity is restored by spawning; a reaped
    # lease was fully recovered by the pool (stand down, audited)
    "prefill_worker_dead": "restart_prefill",
    "prefill_watchdog_fire": "restart_prefill",
    "replica_quarantined": "spawn_replica",
    "lease_reaped": "stand_down",
}


class FaultResponsePolicy(Policy):
    """Respond to journal FAULT events (:data:`FAULT_RESPONSES`):
    re-spawn capacity lost to a replica death, and stand down —
    explicitly, in the journal — where a lower plane's automatic
    recovery (leader re-election, probation rollback, checkpoint
    quarantine, deploy halt) already owns the fault.  Evidence is the
    triggering event's ``(kind, executor, pid, seq)`` id, the exact
    coordinates ``forensics explain`` aligns on its timeline."""

    name = "fault-response"

    def __init__(self, responses=None):
        self.responses = dict(
            FAULT_RESPONSES if responses is None else responses
        )

    def evaluate(self, snap):
        out = []
        for ev in snap.events:
            action = self.responses.get(ev.get("kind"))
            if action is None:
                continue
            evid = {"event": {
                k: ev.get(k)
                for k in ("kind", "executor", "pid", "seq", "t", "ts")
                if ev.get(k) is not None
            }}
            attrs = ev.get("attrs") or {}
            for k in ("replica_id", "replica", "rule", "step",
                      "request_ids"):
                if k in attrs:
                    evid["event"][k] = attrs[k]
            target = {}
            if action == "stand_down":
                # cooldowns key on (action, target): standing down for
                # a leader failover must not suppress the stand-down
                # for a checkpoint quarantine seconds later — each
                # fault kind is its own decision
                target = {"fault": ev.get("kind")}
            if action == "spawn_replica":
                # the router's live mark says ``replica``; shipped
                # exports may say ``replica_id``
                rid = attrs.get("replica_id", attrs.get("replica"))
                evid["lost_replica"] = rid
                # cooldowns key on (action, target): each lost
                # replica is its own respawn decision, so a
                # multi-death storm restores EVERY death instead of
                # collapsing into one cooldown-suppressed spawn
                target = {"lost_replica": rid}
            if action == "restart_prefill":
                # fault marks ride the faulted request's trace, not a
                # replica id — the actuator rebuilds every (or the
                # named) disaggregated worker; cooldown per fault kind
                # so a dead worker and a wedged one stay separate
                # decisions
                target = {"fault": ev.get("kind")}
            out.append(self._intent(
                action, target=target, evidence=evid,
                severity="info" if action == "stand_down" else "warn",
                reason="journal fault {0!r}".format(ev.get("kind")),
            ))
        return out


def default_policies(**overrides):
    """The standard policy set.  Keyword overrides replace the knobs
    of the matching policy, e.g. ``default_policies(
    autoscale={"high": 0.5}, straggler={"sustain": 3})``; pass
    ``<name>=None`` to drop one."""
    specs = {
        "straggler": (StragglerPolicy, overrides.pop("straggler", {})),
        "autoscale": (AutoscalePolicy, overrides.pop("autoscale", {})),
        "page": (PageAlertPolicy, overrides.pop("page", {})),
        "slo_rollback": (
            SloRollbackPolicy, overrides.pop("slo_rollback", {})
        ),
        "faults": (
            FaultResponsePolicy, overrides.pop("faults", {})
        ),
        "cost": (CostPolicy, overrides.pop("cost", {})),
    }
    if overrides:
        raise ValueError(
            "unknown policy overrides {0}".format(sorted(overrides))
        )
    out = []
    for _key, (cls, kw) in specs.items():
        if kw is None:
            continue
        out.append(cls(**kw))
    return out
