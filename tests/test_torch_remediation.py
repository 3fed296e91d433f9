"""The port's audited remediation (``remediation/``) against the JAX
package's, on the CPU.

Every case of the reference's ``tests/test_remediation.py`` that runs
without a cluster (``TestAlertsSince``, ``TestSensors``, ``TestPolicies``,
``TestPerFaultDecision`` with ``ChaosPlan.combined``'s four faults,
``TestGuardrails``, ``TestForensics``, ``TestRouterVerbs``, ``TestWire``,
``TestRestartPrefillVerb``, ``TestGatedElasticRelease``) is one scenario
here.  Each scenario drives the same synthetic sensor feeds, an injected
clock and recording actuators through one package; it runs once through
the port and once through the JAX package, each run is held to the
reference test's own assertions, and the two runs' results are compared
field by field: the decision records (``action``, ``policy``,
``target``, ``evidence``, ``executed``, ``dry_run``, ``severity``,
``reason``, ``error``), the engine's counters (decisions, executed,
suppressed, deferred, failed, budget spent), the actuator calls and the
policies' latches.

Excluded from the comparison, as ids and clocks that differ between two
runs: ``t`` and ``ts`` (wall-clock stamps), ``engine`` (a per-package
counter in the engine's name), and, for events of the live journal,
``seq``, ``pid`` and ``executor`` (each package keeps its own journal).

Beyond the reference's fast tests: the alert cursor through the port's
``HealthPlane``; over the fake-decoder fleet of ``torch_fleet_fakes``,
``FleetActuators`` verb by verb, the kill -> ``spawn_replica`` self-healing
loop (the reference's ``TestSelfHealingE2E``, in seconds), a deploy in
flight deferring every intent, and ``rollback_generation`` of an engine
on probation; ``ChaosPlan.combined`` / ``schedule`` against the
reference's plan.
"""

import json
import os
import time
import types

import pytest

jax = pytest.importorskip("jax")

import torch_fleet_fakes as ff  # noqa: E402
from tensorflowonspark_tpu import forensics as jforensics  # noqa: E402
from tensorflowonspark_tpu import remediation as jremediation  # noqa: E402
from tensorflowonspark_tpu import telemetry as jtelemetry  # noqa: E402
from tensorflowonspark_tpu.fleet import router as jrouter  # noqa: E402
from tensorflowonspark_tpu.telemetry import health as jhealth  # noqa: E402
from tensorflowonspark_tpu.telemetry import journal as jjournal  # noqa: E402
from tensorflowonspark_tpu.telemetry import registry as jregistry  # noqa: E402
from tensorflowonspark_tpu.testing import chaos as jchaos  # noqa: E402
from tensorflowonspark_tpu_torch import forensics  # noqa: E402
from tensorflowonspark_tpu_torch import remediation, telemetry  # noqa: E402
from tensorflowonspark_tpu_torch.fleet import router  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import health  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import journal  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import registry  # noqa: E402
from tensorflowonspark_tpu_torch.testing import chaos  # noqa: E402

PKGS = {
    "torch": types.SimpleNamespace(
        rem=remediation, tel=telemetry, health=health, journal=journal,
        Registry=registry.MetricsRegistry, chaos=chaos, router=router,
        forensics=forensics),
    "jax": types.SimpleNamespace(
        rem=jremediation, tel=jtelemetry, health=jhealth, journal=jjournal,
        Registry=jregistry.MetricsRegistry, chaos=jchaos, router=jrouter,
        forensics=jforensics),
}

#: keys dropped at any depth before two runs are compared
VOLATILE = ("t", "ts", "engine")
#: keys also dropped from events of a live journal
LIVE_IDS = VOLATILE + ("seq", "pid", "executor")
#: the decision record fields compared
RECORD = ("action", "policy", "target", "evidence", "executed", "dry_run",
          "severity", "reason", "error", "alert_gap")
STATS = ("rounds", "decisions", "executed", "suppressed", "deferred",
         "failed", "budget_spent")


def _strip(v, drop=VOLATILE):
    if isinstance(v, dict):
        return {k: _strip(x, drop) for k, x in v.items() if k not in drop}
    if isinstance(v, (list, tuple)):
        return [_strip(x, drop) for x in v]
    return v


def _records(recs, drop=VOLATILE):
    return [_strip({k: r.get(k) for k in RECORD}, drop) for r in recs]


def _stats(eng):
    return {k: eng.stats[k] for k in STATS}


class _Clock(object):
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt


def _recording(P):
    """The reference test's ``RecordingActuators`` over ``P``'s base."""

    class Recording(P.rem.Actuators):
        def __init__(self, fail=()):
            self.calls = []
            self.fail = set(fail)

        def _note(self, verb, kw):
            self.calls.append((verb, dict(kw)))
            if verb in self.fail:
                raise RuntimeError("%s rigged to fail" % verb)
            return verb

        def elastic_shrink(self, executor, **kw):
            return self._note("elastic_shrink", {"executor": executor})

        def elastic_grow(self, executor, **kw):
            return self._note("elastic_grow", {"executor": executor})

        def spawn_replica(self, **kw):
            return self._note("spawn_replica", kw)

        def retire_replica(self, replica_id=None, **kw):
            return self._note("retire_replica", {"replica_id": replica_id})

        def degrade_admission(self, **kw):
            return self._note("degrade_admission", kw)

        def restore_admission(self, **kw):
            return self._note("restore_admission", kw)

        def rollback_generation(self, replicas=None, **kw):
            return self._note("rollback_generation", {"replicas": replicas})

        def of(self, verb):
            return [c for c in self.calls if c[0] == verb]

    return Recording


class _Feed(object):
    """Mutable sensor planes the scenarios poke between engine steps."""

    def __init__(self):
        self.hints = {}
        self.events = []
        self.pressure = None
        self.fleet = None
        self.probation = []
        self.deploy = False
        self._seq = 0

    def event(self, kind, **attrs):
        self._seq += 1
        self.events.append({
            "kind": kind, "executor": attrs.pop("executor", 0),
            "pid": 1, "seq": self._seq, "ts": 100.0 + self._seq,
            "severity": attrs.pop("severity", "warn"), "attrs": attrs,
        })

    def sensors(self, P, clock, slo=None):
        return P.rem.Sensors(
            slo=slo, hints_fn=lambda: dict(self.hints),
            events_fn=lambda: list(self.events),
            pressure_fn=lambda: self.pressure,
            fleet_fn=lambda: self.fleet,
            probation_fn=lambda: list(self.probation),
            deploy_active_fn=lambda: self.deploy, clock=clock)


def _engine(P, feed, clock, policies, guardrails=None, acts=None, slo=None):
    acts = _recording(P)() if acts is None else acts
    eng = P.rem.RemediationEngine(feed.sensors(P, clock, slo=slo), acts,
                                  policies=policies, guardrails=guardrails,
                                  clock=clock)
    return eng, acts


def _always(P, action="spawn_replica", target=None, unique_targets=False):
    """The reference's ``_AlwaysPolicy``: the same intent every round."""

    class Always(P.rem.Policy):
        name = "always"

        def __init__(self):
            self.target = dict(target or {})
            self._n = 0

        def evaluate(self, snap):
            self._n += 1
            tgt = dict(self.target)
            if unique_targets:
                tgt["n"] = self._n
            return [P.rem.Intent(action, self.name, target=tgt,
                                 reason="round %d" % self._n)]

    return Always()


class _FakeSlo(object):
    """``alerts_since`` / ``last_alert_seq`` with scriptable eviction."""

    def __init__(self, P):
        self.P = P
        self.history = []
        self._seq = 0

    @property
    def last_alert_seq(self):
        return self._seq

    def fire(self, rule="lat-burn", state="firing", severity="warn",
             keep=True, message=""):
        self._seq += 1
        a = self.P.health.Alert(rule, state, 1.0, 0.5, 30, severity=severity,
                                message=message, seq=self._seq)
        if keep:
            self.history.append(a)
        return a

    def alerts_since(self, seq):
        return [a for a in self.history if a.seq > seq]


def _snap(P, **kw):
    return P.rem.SensorSnapshot(**kw)


def _ok(policy, intent):
    """The engine's execution feedback for ``intent``."""
    policy.on_decision(dict(intent.to_dict(), executed=True))


def _intents(intents):
    return [_strip(i.to_dict()) for i in intents]


# ----------------------------------------------------------------------
# the scenarios: each takes a package namespace, asserts what the
# reference test asserts, and returns what is compared across packages
# ----------------------------------------------------------------------

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# --- TestAlertsSince ----------------------------------------------------


@scenario
def alerts_since_cursor_returns_strictly_newer_transitions(P):
    clock = _Clock()
    st = P.health.TimeSeriesStore(window=5, clock=clock)
    reg = P.Registry(enabled=True)
    eng = P.health.SloEngine(st, [
        {"name": "lat-p99", "metric": "lat", "stat": "p99", "op": "<",
         "threshold": 0.1, "window": 5, "clear_after": 1}], registry=reg)
    for _ in range(10):
        reg.histogram("lat").observe(0.5)
    clock.tick()
    st.append(0, reg.snapshot())
    (fired,) = eng.evaluate()
    assert fired.seq == 1 and eng.last_alert_seq == 1
    assert [a.rule for a in eng.alerts_since(0)] == ["lat-p99"]
    assert eng.alerts_since(1) == []
    clock.tick(10)
    for _ in range(10):
        reg.histogram("lat").observe(0.01)
    st.append(0, reg.snapshot())
    (resolved,) = eng.evaluate()
    assert resolved.state == "resolved" and resolved.seq == 2
    assert [a.seq for a in eng.alerts_since(1)] == [2]
    assert eng.alerts_since(1)[0].to_dict()["seq"] == 2
    return [_strip(a.to_dict()) for a in eng.alerts_since(0)]


@scenario
def alerts_since_bounded_history_keeps_seq_monotonic(P):
    old = P.health.SloEngine.MAX_HISTORY
    P.health.SloEngine.MAX_HISTORY = 1
    try:
        clock = _Clock()
        st = P.health.TimeSeriesStore(window=5, clock=clock)
        reg = P.Registry(enabled=True)
        eng = P.health.SloEngine(st, [
            {"name": "a", "metric": "lat", "stat": "p99", "op": "<",
             "threshold": 0.1, "window": 5},
            {"name": "b", "metric": "lat", "stat": "p99", "op": "<",
             "threshold": 0.2, "window": 5}], registry=reg)
        for _ in range(10):
            reg.histogram("lat").observe(0.5)
        clock.tick()
        st.append(0, reg.snapshot())
        assert len(eng.evaluate()) == 2 and eng.last_alert_seq == 2
        got = eng.alerts_since(0)
        assert [a.seq for a in got] == [2]
        return [_strip(a.to_dict()) for a in got]
    finally:
        P.health.SloEngine.MAX_HISTORY = old


@scenario
def alerts_through_the_health_plane(P):
    """The plane's SLO engine behind ``wire(plane)``: two rules fire in one
    scrape; with a one-entry history the sensor sees the newer edge and
    flags the gap, and its cursor resyncs."""
    reg = P.Registry(enabled=True)
    for _ in range(10):
        reg.histogram("lat").observe(0.5)
    rules = [{"name": "a", "metric": "lat", "stat": "p99", "op": "<",
              "threshold": 0.1, "window": 30},
             {"name": "b", "metric": "lat", "stat": "p99", "op": "<",
              "threshold": 0.2, "window": 30, "severity": "page"}]
    out = {}
    for history in (None, 1):
        old = P.health.SloEngine.MAX_HISTORY
        if history:
            P.health.SloEngine.MAX_HISTORY = history
        try:
            plane = P.health.HealthPlane(
                lambda: {0: {"metrics": reg.snapshot()}}, interval=60,
                slo=rules, straggler=False, merge_own_registry=False,
                registry=P.Registry(enabled=True))
            eng = P.rem.wire(plane, policies=[],
                             guardrails=P.rem.Guardrails(cooldown_sec=0))
            assert len(plane.scrape_once()) == 2
            snap = eng.sensors.poll()
            again = eng.sensors.poll()
            assert again.alerts == [] and again.alert_gap is False
            out[history] = dict(alerts=_strip(snap.alerts),
                                gap=snap.alert_gap)
        finally:
            P.health.SloEngine.MAX_HISTORY = old
    assert [a["rule"] for a in out[None]["alerts"]] == ["a", "b"]
    assert out[None]["gap"] is False
    assert [a["seq"] for a in out[1]["alerts"]] == [2]
    assert out[1]["gap"] is True
    return out


# --- TestSensors ----------------------------------------------------------


@scenario
def sensors_alert_gap_flagged_when_history_evicts_unseen_edges(P):
    slo = _FakeSlo(P)
    sensors = _Feed().sensors(P, _Clock(), slo=slo)
    slo.fire(keep=False)
    slo.fire(keep=True)
    s1 = sensors.poll()
    assert [a["seq"] for a in s1.alerts] == [2] and s1.alert_gap is True
    slo.fire(keep=False)
    s2 = sensors.poll()
    assert s2.alerts == [] and s2.alert_gap is True
    s3 = sensors.poll()
    assert s3.alert_gap is False
    return [(_strip(s.alerts), s.alert_gap) for s in (s1, s2, s3)]


@scenario
def sensors_event_dedup_by_executor_pid_seq(P):
    feed = _Feed()
    sensors = feed.sensors(P, _Clock())
    feed.event("replica_dead", replica_id=1)
    s1 = sensors.poll()
    assert [e["kind"] for e in s1.events] == ["replica_dead"]
    assert sensors.poll().events == []
    feed.event("replica_dead", replica_id=2)
    s3 = sensors.poll()
    assert len(s3.events) == 1
    return [_strip(s1.events), _strip(s3.events)]


@scenario
def sensors_dead_sensor_does_not_kill_the_poll(P):
    sensors = P.rem.Sensors(hints_fn=lambda: 1 / 0,
                            pressure_fn=lambda: 1 / 0, clock=_Clock())
    snap = sensors.poll()
    assert snap.hints == {} and snap.pressure is None
    return [snap.hints, snap.pressure, snap.events, snap.deploy_active]


@scenario
def sensors_local_journal_cursor_skips_prior_events(P):
    j = P.journal.EventJournal(enabled=True)
    j.emit("old_event")
    sensors = P.rem.Sensors(journal=j, clock=_Clock())
    j.emit("replica_dead")
    snap = sensors.poll()
    assert [e["kind"] for e in snap.events] == ["replica_dead"]
    assert sensors.poll().events == []
    return _strip(snap.events, LIVE_IDS)


# --- TestPolicies ---------------------------------------------------------


@scenario
def policy_straggler_shrinks_then_grows_back(P):
    p = P.rem.StragglerPolicy(sustain=2, grow_after=2)
    hint = {"executor": 3, "phase": "feed", "ratio": 2.4}
    out = [p.evaluate(_snap(P, hints={3: hint}))]
    assert out[-1] == []
    out.append(p.evaluate(_snap(P, hints={3: hint})))
    (shrink,) = out[-1]
    assert shrink.action == "elastic_shrink"
    assert shrink.target == {"executor": 3}
    assert shrink.evidence["hint"]["phase"] == "feed"
    out.append(p.evaluate(_snap(P, hints={3: hint})))
    assert out[-1][0].action == "elastic_shrink" and p.held == set()
    _ok(p, shrink)
    assert p.held == {3}
    out.append(p.evaluate(_snap(P, hints={3: hint})))
    out.append(p.evaluate(_snap(P, hints={})))
    assert out[-2] == [] and out[-1] == []
    out.append(p.evaluate(_snap(P, hints={})))
    (grow,) = out[-1]
    assert grow.action == "elastic_grow" and grow.target == {"executor": 3}
    assert p.held == {3}
    _ok(p, grow)
    assert p.held == set()
    return [_intents(i) for i in out]


@scenario
def policy_autoscale_spawns_hot_retires_cold(P):
    p = P.rem.AutoscalePolicy(high=0.7, low=0.1, sustain=2, sustain_down=2,
                              max_replicas=3)
    hot = {"occupancy_mean": 0.9, "occupancy_peak": 1.0,
           "shed_per_sec": 0.0, "free_slots": 0}
    cold = {"occupancy_mean": 0.0, "occupancy_peak": 0.0,
            "shed_per_sec": 0.0, "free_slots": 4}

    def snap(pr, live):
        return _snap(P, pressure=pr, fleet={"live": live, "replicas": live})

    out = [p.evaluate(snap(hot, 2)), p.evaluate(snap(hot, 2))]
    assert out[0] == []
    (up,) = out[1]
    assert up.action == "spawn_replica"
    assert up.evidence["pressure"]["occupancy_mean"] == 0.9
    p2 = P.rem.AutoscalePolicy(sustain=1, max_replicas=2)
    out.append(p2.evaluate(snap(hot, 2)))
    assert out[-1] == []
    out.append(p.evaluate(snap(cold, 2)))
    out.append(p.evaluate(snap(cold, 2)))
    assert out[-2] == []
    assert out[-1][0].action == "retire_replica"
    p._cold = 5
    out.append(p.evaluate(snap(cold, 1)))
    assert out[-1] == []
    return [_intents(i) for i in out]


@scenario
def policy_page_degrade_and_restore(P):
    p = P.rem.PageAlertPolicy()
    fire = {"rule": "p99", "state": "firing", "severity": "page", "seq": 7}
    resolve = {"rule": "p99", "state": "resolved", "severity": "page",
               "seq": 8}
    out = [p.evaluate(_snap(P, alerts=[fire]))]
    (deg,) = out[0]
    assert deg.action == "degrade_admission" and deg.severity == "page"
    assert deg.evidence["alert"]["seq"] == 7
    out.append(p.evaluate(_snap(P)))
    assert out[-1][0].action == "degrade_admission"
    assert p.degraded is False
    _ok(p, deg)
    assert p.degraded is True
    out.append(p.evaluate(_snap(P)))
    assert out[-1] == []
    out.append(p.evaluate(_snap(P, alerts=[resolve])))
    (res,) = out[-1]
    assert res.action == "restore_admission"
    _ok(p, res)
    assert p.degraded is False
    return [_intents(i) for i in out]


@scenario
def policy_slo_rollback_requires_probation(P):
    p = P.rem.SloRollbackPolicy()
    burn = {"rule": "serving-burn", "state": "firing", "severity": "page",
            "seq": 3}
    none = p.evaluate(_snap(P, alerts=[burn]))
    assert none == []
    (rb,) = p.evaluate(_snap(P, alerts=[burn], probation=[0, 2]))
    assert rb.action == "rollback_generation"
    assert rb.target == {"replicas": [0, 2]}
    assert rb.evidence["alert"]["rule"] == "serving-burn"
    assert rb.severity == "page"
    return [_intents(none), _intents([rb])]


@scenario
def policy_fault_response_mapping_and_evidence(P):
    p = P.rem.FaultResponsePolicy()
    ev = {"kind": "replica_dead", "executor": 2, "pid": 9, "seq": 41,
          "ts": 5.0, "attrs": {"replica_id": 1, "request_ids": [3, 4]}}
    (spawn,) = p.evaluate(_snap(P, events=[ev]))
    assert spawn.action == "spawn_replica"
    assert spawn.evidence["lost_replica"] == 1
    assert spawn.target == {"lost_replica": 1}
    assert spawn.evidence["event"]["seq"] == 41
    assert spawn.evidence["event"]["request_ids"] == [3, 4]
    (sd,) = p.evaluate(_snap(P, events=[{"kind": "leader_failover",
                                         "seq": 42}]))
    assert sd.action == "stand_down"
    # every fault kind of the table, one event each
    evs = [{"kind": k, "executor": 0, "pid": 1, "seq": i,
            "attrs": {"replica": i}}
           for i, k in enumerate(sorted(P.rem.policy.FAULT_RESPONSES))]
    every = p.evaluate(_snap(P, events=evs))
    assert [i.action for i in every] == [
        P.rem.policy.FAULT_RESPONSES[k]
        for k in sorted(P.rem.policy.FAULT_RESPONSES)]
    return [_intents([spawn]), _intents([sd]), _intents(every),
            sorted(P.rem.policy.FAULT_RESPONSES.items())]


@scenario
def policy_intent_rejects_unknown_action(P):
    with pytest.raises(ValueError, match="unknown remediation") as e:
        P.rem.Intent("reboot_datacenter", "p")
    return [str(e.value), list(P.rem.ACTIONS)]


@scenario
def policy_intent_key_is_hashing_safe(P):
    a = P.rem.Intent("rollback_generation", "p",
                     target={"replicas": [0, 2], "meta": {"x": [1]}})
    b = P.rem.Intent("rollback_generation", "p",
                     target={"meta": {"x": [1]}, "replicas": [0, 2]})
    assert a.key() == b.key()
    assert {a.key(): "cooldown"}[b.key()] == "cooldown"
    k = P.rem.Intent("stand_down", "p", target={"s": {3, 1}}).key()
    assert k == ("stand_down", (("s", (1, 3)),))
    return [a.key(), k]


@scenario
def policy_default_policies_overrides(P):
    ps = P.rem.default_policies(straggler={"sustain": 5}, faults=None)
    names = [p.name for p in ps]
    assert "fault-response" not in names
    assert [p for p in ps if p.name == "straggler-elastic"][0].sustain == 5
    with pytest.raises(ValueError, match="unknown policy") as e:
        P.rem.default_policies(nonsense={})
    return [names, [p.name for p in P.rem.default_policies()], str(e.value)]


# --- TestPerFaultDecision -------------------------------------------------

#: chaos fault kind -> the decision it must produce
PER_FAULT = {"slow_executor": "elastic_shrink", "kill_leader": "stand_down",
             "kill_replica": "spawn_replica",
             "corrupt_checkpoint": "stand_down"}


def _signature(feed, fault):
    kind = fault["kind"]
    if kind == "slow_executor":
        feed.hints[fault["executor_id"]] = {
            "executor": fault["executor_id"], "phase": "feed", "ratio": 2.0}
    elif kind == "kill_leader":
        feed.event("leader_failover", dead_member=0)
    elif kind == "kill_replica":
        feed.event("replica_dead", replica_id=fault["replica_id"])
    elif kind == "corrupt_checkpoint":
        feed.event("checkpoint_quarantined", reason=fault["corrupt_kind"])
    else:  # pragma: no cover - plan drift guard
        raise AssertionError("unmapped fault %r" % kind)


@scenario
def per_fault_each_combined_fault_yields_one_decision(P):
    plan = P.chaos.ChaosPlan.combined(
        slow_executor={"executor_id": 1, "per_batch_sec": 0.4, "at_sec": 2},
        kill_leader={"at_window": 3, "at_sec": 5},
        kill_replica={"replica_id": 1, "at_chunk": 4, "at_sec": 8},
        corrupt_checkpoint={"corrupt_kind": "truncate_array", "at_sec": 11})
    sched = plan.schedule()
    assert [s for s, _f in sched] == [2.0, 5.0, 8.0, 11.0]
    clock = _Clock()
    out = []
    for _at, fault in sched:
        feed = _Feed()
        eng, acts = _engine(P, feed, clock, P.rem.default_policies(
            straggler={"sustain": 1}))
        _signature(feed, fault)
        decisions = []
        for _ in range(3):
            decisions.extend(eng.step())
            clock.tick(0.1)
        assert len(decisions) == 1, fault["kind"]
        (d,) = decisions
        assert d["action"] == PER_FAULT[fault["kind"]]
        if fault["kind"] == "slow_executor":
            assert d["target"] == {"executor": fault["executor_id"]}
            assert d["evidence"]["hint"]["phase"] == "feed"
            assert acts.of("elastic_shrink")
        elif fault["kind"] == "kill_replica":
            assert d["evidence"]["lost_replica"] == 1
            assert acts.of("spawn_replica")
        else:
            assert d["evidence"]["event"]["kind"] in (
                "leader_failover", "checkpoint_quarantined")
            assert acts.calls == []
        out.append(dict(fault=fault, records=_records(decisions),
                        stats=_stats(eng), calls=acts.calls))
    return out


@scenario
def per_fault_combined_plan_validates_corrupt_kind(P):
    with pytest.raises(ValueError, match="corrupt_kind") as e:
        P.chaos.ChaosPlan.combined(corrupt_checkpoint={"corrupt_kind": "nope"})
    with pytest.raises(ValueError, match="unknown corrupt_checkpoint") as e2:
        P.chaos.ChaosPlan.combined(corrupt_checkpoint={
            "corrupt_kind": "bad_manifest", "bogus": 1})
    return [str(e.value), str(e2.value)]


# --- TestGuardrails -------------------------------------------------------


@scenario
def guard_flapping_sensor_bounded_to_one_execution_per_window(P):
    clock = _Clock()
    feed = _Feed()
    eng, acts = _engine(P, feed, clock,
                        [P.rem.StragglerPolicy(sustain=1, grow_after=1)],
                        guardrails=P.rem.Guardrails(
                            cooldown_sec=30.0, rate_limit=100, budget=1000))
    hint = {"executor": 1, "phase": "feed", "ratio": 3.0}
    recs = []
    for i in range(60):
        feed.hints = {1: hint} if i % 2 == 0 else {}
        recs.extend(eng.step())
        clock.tick(1.0)
    assert len(acts.of("elastic_shrink")) <= 2
    assert len(acts.of("elastic_grow")) <= 2
    assert eng.stats["suppressed"] >= 20
    return [_records(recs), _stats(eng), acts.calls]


@scenario
def guard_cooldown_suppresses_identical_intent(P):
    clock = _Clock()
    eng, acts = _engine(P, _Feed(), clock, [_always(P)],
                        guardrails=P.rem.Guardrails(cooldown_sec=10.0,
                                                    budget=100))
    (d1,) = eng.step()
    assert d1["executed"] is True
    clock.tick(5.0)
    assert eng.step() == []
    assert eng.stats["suppressed"] == 1
    clock.tick(6.0)
    (d2,) = eng.step()
    assert d2["executed"] is True and len(acts.calls) == 2
    return [_records([d1, d2]), _stats(eng), acts.calls]


@scenario
def guard_rate_limit_across_actions(P):
    clock = _Clock()
    eng, acts = _engine(P, _Feed(), clock, [_always(P, unique_targets=True)],
                        guardrails=P.rem.Guardrails(
                            cooldown_sec=0.0, rate_limit=2,
                            rate_window_sec=60.0, budget=100))
    recs = []
    for _ in range(5):
        recs.extend(eng.step())
        clock.tick(1.0)
    assert len(acts.calls) == 2 and eng.stats["suppressed"] == 3
    clock.tick(60.0)
    recs.extend(eng.step())
    assert len(acts.calls) == 3
    return [_records(recs), _stats(eng), acts.calls]


@scenario
def guard_budget_exhaustion_pages_and_goes_hands_off(P):
    j = P.tel.get_journal()
    before = len(j.events(kind="remediation_budget_exhausted"))
    clock = _Clock()
    eng, acts = _engine(P, _Feed(), clock, [_always(P, unique_targets=True)],
                        guardrails=P.rem.Guardrails(
                            cooldown_sec=0.0, rate_limit=100, budget=2))
    recs = []
    for _ in range(4):
        recs.extend(eng.step())
        clock.tick(1.0)
    assert len(acts.calls) == 2 and eng.armed is False
    assert eng.budget_remaining() == 0
    assert eng.step() == []
    pages = j.events(kind="remediation_budget_exhausted")
    assert len(pages) == before + 1 and pages[-1].severity == "page"
    assert pages[-1].attrs["last_intent"]["action"] == "spawn_replica"
    page = _strip(pages[-1].attrs)
    eng.rearm(budget=5)
    assert eng.armed and eng.budget_remaining() == 5
    recs.extend(eng.step())
    assert len(acts.calls) == 3
    rearmed = j.events(kind="remediation_rearmed")
    assert rearmed
    return [_records(recs), _stats(eng), acts.calls, page,
            _strip(rearmed[-1].attrs)]


@scenario
def guard_dry_run_journals_but_does_not_act(P):
    j = P.tel.get_journal()
    before = len(j.events(kind="remediation_decision"))
    clock = _Clock()
    eng, acts = _engine(P, _Feed(), clock, [_always(P, unique_targets=True)],
                        guardrails=P.rem.Guardrails(
                            cooldown_sec=0.0, rate_limit=100, budget=3,
                            dry_run=True))
    for _ in range(5):
        eng.step()
        clock.tick(1.0)
    assert acts.calls == []
    decided = j.events(kind="remediation_decision")[before:]
    assert len(decided) == 5
    assert all(e.attrs["dry_run"] and not e.attrs["executed"]
               for e in decided)
    assert eng.budget_remaining() == 3 and eng.armed
    return [[_strip(e.attrs) for e in decided], _stats(eng)]


@scenario
def guard_dry_run_exempt_from_rate_limit_and_budget(P):
    clock = _Clock()
    eng, acts = _engine(P, _Feed(), clock, [_always(P, unique_targets=True)],
                        guardrails=P.rem.Guardrails(
                            cooldown_sec=0.0, rate_limit=1, budget=1,
                            dry_run=True))
    recs = []
    for _ in range(5):
        recs.extend(eng.step())
        clock.tick(1.0)
    assert len(recs) == 5 and acts.calls == []
    assert eng.stats["suppressed"] == 0
    assert eng.budget_remaining() == 1 and eng.armed
    return [_records(recs), _stats(eng)]


@scenario
def guard_deploy_conflict_defers_everything(P):
    j = P.tel.get_journal()
    before = len(j.events(kind="remediation_deferred"))
    clock = _Clock()
    feed = _Feed()
    feed.deploy = True
    eng, acts = _engine(P, feed, clock, [_always(P, unique_targets=True)],
                        guardrails=P.rem.Guardrails(cooldown_sec=0.0,
                                                    budget=100))
    for _ in range(3):
        assert eng.step() == []
        clock.tick(1.0)
    assert acts.calls == [] and eng.stats["deferred"] == 3
    deferred = j.events(kind="remediation_deferred")
    assert len(deferred) == before + 1
    feed.deploy = False
    (d,) = eng.step()
    assert d["executed"] and len(acts.calls) == 1
    feed.deploy = True
    clock.tick(1.0)
    eng.step()
    assert len(j.events(kind="remediation_deferred")) == before + 2
    return [_records([d]), _stats(eng), _strip(deferred[-1].attrs)]


@scenario
def guard_rollback_generation_executes_through_the_engine(P):
    clock = _Clock()
    slo = _FakeSlo(P)
    feed = _Feed()
    feed.probation = [0, 2]
    eng, acts = _engine(P, feed, clock, [P.rem.SloRollbackPolicy()],
                        guardrails=P.rem.Guardrails(cooldown_sec=30.0,
                                                    budget=10), slo=slo)
    slo.fire(rule="serving-burn", severity="page")
    (d,) = eng.step()
    assert d["action"] == "rollback_generation" and d["executed"] is True
    assert d["target"] == {"replicas": [0, 2]}
    assert acts.of("rollback_generation") == [
        ("rollback_generation", {"replicas": [0, 2]})]
    clock.tick(1.0)
    slo.fire(rule="serving-burn", severity="page")
    assert eng.step() == [] and eng.stats["suppressed"] == 1
    return [_records([d]), _stats(eng)]


@scenario
def guard_bad_intent_does_not_drop_the_rest_of_the_round(P):
    class BadKey(P.rem.Intent):
        def key(self):
            raise TypeError("rigged key")

    class Bad(P.rem.Policy):
        name = "bad"

        def evaluate(self, snap):
            return [BadKey("retire_replica", self.name)]

    eng, acts = _engine(P, _Feed(), _Clock(), [Bad(), _always(P)])
    (d,) = eng.step()
    assert d["policy"] == "always" and d["executed"]
    assert len(acts.of("spawn_replica")) == 1 and eng.stats["failed"] == 1
    return [_records([d]), _stats(eng)]


@scenario
def guard_multi_death_storm_respawns_each_replica(P):
    clock = _Clock()
    feed = _Feed()
    eng, acts = _engine(P, feed, clock, [P.rem.FaultResponsePolicy()],
                        guardrails=P.rem.Guardrails(cooldown_sec=30.0,
                                                    budget=10))
    feed.event("replica_dead", replica_id=1)
    feed.event("replica_dead", replica_id=2)
    decisions = eng.step()
    assert [d["target"] for d in decisions] == [
        {"lost_replica": 1}, {"lost_replica": 2}]
    assert all(d["executed"] for d in decisions)
    assert len(acts.of("spawn_replica")) == 2
    clock.tick(1.0)
    feed.event("replica_dead", replica_id=1)
    assert eng.step() == [] and eng.stats["suppressed"] == 1
    return [_records(decisions), _stats(eng)]


@scenario
def guard_degrade_retried_until_it_actually_lands(P):
    clock = _Clock()
    slo = _FakeSlo(P)
    acts = _recording(P)(fail={"degrade_admission"})
    eng, acts = _engine(P, _Feed(), clock, [P.rem.PageAlertPolicy()],
                        guardrails=P.rem.Guardrails(cooldown_sec=5.0,
                                                    budget=10),
                        acts=acts, slo=slo)
    slo.fire(rule="p99", severity="page")
    (d1,) = eng.step()
    assert d1["executed"] is False and "rigged" in d1["error"]
    clock.tick(1.0)
    assert eng.step() == [] and eng.stats["suppressed"] == 1
    acts.fail.clear()
    clock.tick(5.0)
    (d2,) = eng.step()
    assert d2["executed"] is True
    assert len(acts.of("degrade_admission")) == 2
    clock.tick(6.0)
    assert eng.step() == []
    slo.fire(rule="p99", state="resolved", severity="page")
    (d3,) = eng.step()
    assert d3["action"] == "restore_admission" and d3["executed"]
    return [_records([d1, d2, d3]), _stats(eng), acts.calls]


@scenario
def guard_straggler_held_only_after_shrink_executes(P):
    clock = _Clock()
    feed = _Feed()
    acts = _recording(P)(fail={"elastic_shrink"})
    policy = P.rem.StragglerPolicy(sustain=1, grow_after=1)
    eng, acts = _engine(P, feed, clock, [policy],
                        guardrails=P.rem.Guardrails(cooldown_sec=5.0,
                                                    budget=10), acts=acts)
    hint = {1: {"executor": 1, "phase": "feed", "ratio": 3.0}}
    feed.hints = dict(hint)
    (d1,) = eng.step()
    assert d1["executed"] is False and policy.held == set()
    feed.hints = {}
    clock.tick(6.0)
    assert eng.step() == [] and acts.of("elastic_grow") == []
    acts.fail.clear()
    feed.hints = dict(hint)
    (d2,) = eng.step()
    assert d2["executed"] is True and policy.held == {1}
    return [_records([d1, d2]), _stats(eng), sorted(policy.held)]


@scenario
def guard_failed_actuator_is_a_journaled_outcome(P):
    eng, acts = _engine(P, _Feed(), _Clock(), [_always(P)],
                        acts=_recording(P)(fail={"spawn_replica"}))
    (d,) = eng.step()
    assert d["executed"] is False and "rigged to fail" in d["error"]
    assert eng.stats["failed"] == 1
    return [_records([d]), _stats(eng)]


@scenario
def guard_unbound_verb_raises_unsupported(P):
    out = []
    base = P.rem.Actuators()
    for verb in P.rem.ACTIONS:
        if verb == "stand_down":
            continue
        args = {"executor": 0} if verb.startswith("elastic") else {}
        with pytest.raises(P.rem.UnsupportedAction) as e:
            getattr(base, verb)(**args)
        out.append(str(e.value))
    return out


@scenario
def guard_stand_down_skips_rate_limit_and_budget(P):
    clock = _Clock()
    eng, acts = _engine(P, _Feed(), clock,
                        [_always(P, action="stand_down", unique_targets=True)],
                        guardrails=P.rem.Guardrails(cooldown_sec=0.0,
                                                    rate_limit=1, budget=1))
    recs = []
    for _ in range(5):
        recs.extend(eng.step())
        clock.tick(1.0)
    assert acts.calls == [] and eng.stats["decisions"] == 5
    assert eng.armed and eng.budget_remaining() == 1
    return [_records(recs), _stats(eng)]


@scenario
def guard_broken_policy_does_not_kill_the_round(P):
    class Boom(P.rem.Policy):
        name = "boom"

        def evaluate(self, snap):
            raise RuntimeError("policy bug")

    eng, acts = _engine(P, _Feed(), _Clock(), [Boom(), _always(P)])
    (d,) = eng.step()
    assert d["policy"] == "always" and d["executed"]
    return [_records([d]), _stats(eng)]


@scenario
def guard_status_provider_reports_the_engine(P):
    eng, _acts = _engine(P, _Feed(), _Clock(), [_always(P)])
    eng.step()
    out = P.health.provider_statuses()["remediation"]
    assert out["armed"] is True and out["stats"]["decisions"] == 1
    assert out["decisions"][-1]["action"] == "spawn_replica"
    # the provider holds the engine weakly
    del eng
    import gc

    gc.collect()
    gone = P.health.provider_statuses()["remediation"]
    return [_strip(dict(out, decisions=_records(out["decisions"]))), gone]


# --- TestForensics ---------------------------------------------------------


@scenario
def forensics_explain_renders_remediation_decisions(P):
    import tempfile

    export = {"events": [
        P.journal.Event("replica_dead", ts=50.0, seq=1, pid=1, executor=0,
                        severity="page", attrs={"replica_id": 1}).to_dict(),
        P.journal.Event(
            "remediation_decision", ts=51.0, seq=2, pid=1, executor=0,
            severity="warn", attrs={
                "decision": 1, "engine": "remediation1",
                "action": "spawn_replica", "policy": "fault-response",
                "target": {}, "evidence": {"event": {"kind": "replica_dead",
                                                     "seq": 1}},
                "reason": "journal fault 'replica_dead'",
                "executed": True, "dry_run": False}).to_dict()]}
    d = tempfile.mkdtemp()
    p = os.path.join(d, "journal_export.json")
    with open(p, "w") as f:
        json.dump(export, f)
    report = P.forensics.explain([p])
    assert report["incident"]["fault_kind"] == "kill_replica"
    assert len(report["remediation"]) == 1
    assert report["remediation"][0]["attrs"]["action"] == "spawn_replica"
    text = P.forensics.render_report(report)
    assert "why did the fleet do that?" in text
    assert "spawn_replica" in text and "fault-response" in text
    return [_strip(report["remediation"]), report["incident"]["fault_kind"],
            [ln for ln in text.splitlines() if "spawn_replica" in ln]]


@scenario
def forensics_renders_the_engines_own_decisions(P):
    """The port's live decisions, exported from its journal, render
    through ``forensics explain`` (no change to ``forensics.py``)."""
    import tempfile

    j = P.tel.get_journal()
    before = len(j.events())
    feed = _Feed()
    eng, _acts = _engine(P, feed, _Clock(), [P.rem.FaultResponsePolicy()])
    feed.event("replica_dead", replica_id=1)
    feed.event("checkpoint_quarantined", reason="bad_manifest")
    eng.step()
    events = [e.to_dict() for e in j.events()[before:]]
    events.insert(0, P.journal.Event(
        "replica_dead", ts=events[0]["ts"] - 1.0, seq=0, pid=1, executor=0,
        severity="page", attrs={"replica_id": 1}).to_dict())
    d = tempfile.mkdtemp()
    p = os.path.join(d, "journal_export.json")
    with open(p, "w") as f:
        json.dump({"events": events}, f)
    report = P.forensics.explain([p])
    acted = [ev["attrs"]["action"] for ev in report["remediation"]
             if ev["kind"] == "remediation_decision"]
    assert acted == ["spawn_replica", "stand_down"]
    text = P.forensics.render_report(report)
    assert "why did the fleet do that?" in text
    return [acted, _strip(report["remediation"], LIVE_IDS)]


@scenario
def forensics_live_decision_lands_in_the_journal(P):
    j = P.tel.get_journal()
    before = len(j.events(kind="remediation_decision"))
    feed = _Feed()
    eng, _acts = _engine(P, feed, _Clock(), P.rem.default_policies())
    feed.event("replica_dead", replica_id=0)
    eng.step()
    evs = j.events(kind="remediation_decision")[before:]
    assert len(evs) == 1 and evs[0].attrs["action"] == "spawn_replica"
    assert evs[0].attrs["evidence"]["event"]["kind"] == "replica_dead"
    return [_strip(evs[0].attrs), evs[0].severity, evs[0].trace]


# --- TestRestartPrefillVerb / TestGatedElasticRelease ----------------------


class _StubDisaggEngine(object):
    def __init__(self):
        self._prefill_worker = object()
        self.restarts = 0
        self.reason = None

    def restart_prefill_worker(self, reason=None):
        self.restarts += 1
        self.reason = reason


class _StubReplica(object):
    def __init__(self, rid, engine, alive=True):
        self.replica_id = rid
        self.engine = engine
        self.alive = alive


class _StubFleet(object):
    def __init__(self, replicas):
        self.replicas = replicas


class _StubCluster(object):
    def __init__(self):
        self.held = []
        self.released = []

    def hold_executor(self, executor, reason=None):
        self.held.append((executor, reason))
        return executor

    def release_executor(self, executor):
        self.released.append(executor)
        return executor


class _HandGate(object):
    """The ``CleanRoundsSensor`` surface with a hand-operated valve."""

    def __init__(self, open=False, rounds=3):
        self.open = open
        self.rounds = rounds
        self.polls = 0

    @property
    def streak(self):
        return self.rounds if self.open else 1

    def poll(self):
        self.polls += 1

    def ready(self):
        return self.open


@scenario
def prefill_combined_falls_through_cluster_to_fleet(P):
    disagg = _StubDisaggEngine()
    fleet = _StubFleet([_StubReplica(0, _StubDisaggEngine(), alive=False),
                        _StubReplica(1, object()),
                        _StubReplica(2, disagg)])
    acts = P.rem.CombinedActuators(P.rem.ClusterActuators(_StubCluster()),
                                   P.rem.FleetActuators(fleet))
    got = acts.restart_prefill()
    assert got == [2] and disagg.restarts == 1
    assert disagg.reason == "remediation"
    assert fleet.replicas[0].engine.restarts == 0
    return [got, disagg.reason]


@scenario
def prefill_restart_refuses_without_a_disagg_engine(P):
    acts = P.rem.FleetActuators(_StubFleet([_StubReplica(0, object())]))
    with pytest.raises(P.rem.UnsupportedAction, match="disaggregated") as e:
        acts.restart_prefill()
    return str(e.value)


@scenario
def gated_grow_refuses_while_gate_is_closed(P):
    cluster = _StubCluster()
    acts = P.rem.ClusterActuators(cluster, release_gate=_HandGate())
    j = P.journal.get_journal()
    assert acts.elastic_shrink(3) == 3
    with pytest.raises(P.rem.UnsupportedAction, match="1/3 clean") as e:
        acts.elastic_grow(3)
    assert cluster.released == []
    ev = j.events(kind="readmit_gated")
    assert ev and ev[-1].trace == "remediation"
    assert ev[-1].attrs["required_rounds"] == 3
    n = len(j.events(kind="readmit_gated"))
    with pytest.raises(P.rem.UnsupportedAction):
        acts.elastic_grow(3)
    assert len(j.events(kind="readmit_gated")) == n
    return [cluster.held, str(e.value), _strip(ev[-1].attrs), ev[-1].severity]


@scenario
def gated_grow_releases_once_gate_opens(P):
    cluster = _StubCluster()
    gate = _HandGate()
    acts = P.rem.ClusterActuators(cluster, release_gate=gate)
    with pytest.raises(P.rem.UnsupportedAction):
        acts.elastic_grow(2)
    gate.open = True
    assert acts.elastic_grow(2) == 2 and cluster.released == [2]
    ev = P.journal.get_journal().events(kind="readmit_cleared")
    assert ev and ev[-1].trace == "remediation"
    assert ev[-1].attrs["executor"] == 2
    return [cluster.released, _strip(ev[-1].attrs), gate.polls]


@scenario
def gated_grow_behind_a_clean_rounds_sensor(P):
    """The real gate: ``CleanRoundsSensor`` over a plane whose hints the
    scenario sets; a grow goes through after ``rounds`` clean scrapes."""
    plane = types.SimpleNamespace(hints={1: {"phase": "feed"}}, slo=None,
                                  store=types.SimpleNamespace(scrapes=0))
    gate = P.health.CleanRoundsSensor(plane, rounds=2)
    cluster = _StubCluster()
    acts = P.rem.ClusterActuators(cluster, release_gate=gate)
    out = []
    for scrape, hints in enumerate([{1: {}}, {}, {}, {}]):
        plane.hints, plane.store.scrapes = hints, scrape
        try:
            out.append(acts.elastic_grow(1))
        except P.rem.UnsupportedAction as e:
            out.append(str(e))
    # dirty, then one clean round: gated; from the second clean round on,
    # every grow goes through
    assert ["gated" in str(o) for o in out] == [True, True, False, False]
    assert cluster.released == [1, 1]
    return out


# --- TestRouterVerbs / TestWire (over the fake-decoder fleet) -------------


def _fake_router(P, **kw):
    return ff.fake_router(P.router, **kw)


@scenario
def router_pressure_statistic_shape(P):
    rt = _fake_router(P, n=2, slots=2)
    try:
        out = list(rt.serve([dict(r) for r in ff.prompts([5, 6, 7, 8])]))
        assert len(out) == 4
        p = rt.pressure()
        keys = sorted(p)
        for key in ("window_sec", "occupancy", "occupancy_mean",
                    "occupancy_peak", "queued", "shed_per_sec",
                    "spill_per_sec", "free_slots"):
            assert key in p
        assert 0.0 <= p["occupancy_mean"] <= 1.0
        assert p["occupancy_peak"] >= p["occupancy_mean"]
        assert rt.health_status()["pressure"]["window_sec"] \
            == p["window_sec"]
    finally:
        rt.close()
    return keys


@scenario
def router_scale_up_adds_live_capacity(P):
    j = P.tel.get_journal()
    before = len(j.events(kind="replica_spawned"))
    rt = _fake_router(P, n=1, slots=2)
    try:
        rid = rt.scale_up()
        assert rid == 1 and len(rt.replicas) == 2
        assert rt.stats["scaled_up"] == 1
        rows = ff.prompts([5, 6, 7, 8])
        out = list(rt.serve([dict(r) for r in rows]))
        assert len(out) == 4 and all("error" not in r for r in out)
        assert len(j.events(kind="replica_spawned")) == before + 1
    finally:
        rt.close()
    return [rid, ff.tokens(out)]


@scenario
def router_scale_down_drains_and_refuses_the_last_replica(P):
    j = P.tel.get_journal()
    before = len(j.events(kind="replica_retired"))
    rt = _fake_router(P, n=3, slots=2)
    try:
        out = list(rt.serve([dict(r) for r in ff.prompts([5, 6, 7, 8])]))
        assert len(out) == 4
        rid = rt.scale_down()
        assert rid is not None and rt.replicas[rid].state == "draining"
        assert rt.stats["scaled_down"] == 1
        assert len(j.events(kind="replica_retired")) == before + 1
        second = rt.scale_down()
        assert second is not None
        assert rt.scale_down() is None
    finally:
        rt.close()
    return [rid, second]


@scenario
def router_set_policy_flips_admission_at_runtime(P):
    rt = _fake_router(P, n=1, slots=2)
    try:
        prior = rt.policy
        assert rt.set_policy("degrade") == prior
        assert rt.policy == "degrade"
        assert rt.set_policy(prior) == "degrade"
        with pytest.raises(ValueError, match="fleet policy"):
            rt.set_policy("yolo")
        assert rt.deploy_active() is False
    finally:
        rt.close()
    return prior


@scenario
def fleet_actuators_bind_the_router_verb_by_verb(P):
    rt = _fake_router(P, n=2, slots=2)
    out = {}
    try:
        acts = P.rem.FleetActuators(rt)
        out["spawn"] = acts.spawn_replica()
        assert out["spawn"] == 2 and len(rt.replicas) == 3
        prior = rt.policy
        out["degrade"] = acts.degrade_admission()
        assert rt.policy == "degrade"
        out["restore"] = acts.restore_admission()
        assert rt.policy == prior
        # probe: route around a live replica, refuse a dead id, the state
        # it is already in, and the last live replica
        out["probe"] = acts.probe_replica(replica_id=2)
        assert rt.replicas[2].state != "live"
        for rid in (None, 9, 2):
            with pytest.raises(P.rem.UnsupportedAction) as e:
                acts.probe_replica(replica_id=rid)
            out["probe_refused_%s" % rid] = str(e.value)
        out["retire"] = acts.retire_replica(replica_id=1)
        with pytest.raises(P.rem.UnsupportedAction) as e:
            acts.probe_replica(replica_id=0)
        out["probe_last"] = str(e.value)
        with pytest.raises(P.rem.UnsupportedAction) as e:
            acts.retire_replica()
        out["retire_last"] = str(e.value)
        # nothing on probation, no disaggregated engine
        for verb in ("rollback_generation", "restart_prefill"):
            with pytest.raises(P.rem.UnsupportedAction) as e:
                getattr(acts, verb)()
            out[verb] = str(e.value)
        # the cluster verbs stay unbound on a fleet actuator
        with pytest.raises(P.rem.UnsupportedAction):
            acts.elastic_shrink(0)
        rows = ff.prompts([5, 6, 7])
        out["tokens"] = ff.tokens(list(rt.serve([dict(r) for r in rows])))
    finally:
        rt.close()
    out["states"] = [r.state for r in rt.replicas]
    return out


@scenario
def wire_router_binds_pressure_and_verbs(P):
    rt = _fake_router(P, n=2, slots=2)
    try:
        eng = P.rem.wire(router=rt, interval=0.05)
        snap = eng.sensors.poll()
        assert snap.pressure is not None
        assert snap.fleet["live"] == 2 and snap.deploy_active is False
        assert isinstance(eng.actuators, P.rem.FleetActuators)
        out = dict(fleet={k: snap.fleet[k] for k in ("replicas", "live")},
                   costs=sorted(snap.fleet["costs"]),
                   probation=snap.probation,
                   policies=[p.name for p in eng.policies])
    finally:
        rt.close()
    return out


@scenario
def wire_without_planes_still_journals(P):
    eng = P.rem.wire(policies=[_always(P)],
                     guardrails=P.rem.Guardrails(cooldown_sec=0.0))
    (d,) = eng.step()
    assert d["executed"] is False and "UnsupportedAction" in d["error"]
    return _records([d])


@scenario
def wire_rejects_policies_plus_overrides(P):
    with pytest.raises(ValueError, match="not both") as e:
        P.rem.wire(policies=[], straggler=None)
    return str(e.value)


@scenario
def wire_cluster_and_router_combine_their_verbs(P):
    """``wire(cluster=, router=)``: cluster verbs first, then the fleet's;
    the journal sensor reads the cluster's shipped events."""
    cluster = _StubCluster()
    shipped = [{"kind": "replica_dead", "executor": 1, "pid": 5, "seq": 1,
                "attrs": {"replica": 0}}]
    cluster.journal = lambda: {"events": list(shipped)}
    rt = _fake_router(P, n=1, slots=2)
    try:
        eng = P.rem.wire(router=rt, cluster=cluster, policies=[
            P.rem.FaultResponsePolicy()])
        assert isinstance(eng.actuators, P.rem.CombinedActuators)
        assert eng.actuators.elastic_shrink(1) == 1
        recs = eng.step()
        assert [r["action"] for r in recs] == ["spawn_replica"]
        assert recs[0]["executed"] and len(rt.replicas) == 2
        assert eng.step() == []   # the shipped event is seen once
    finally:
        rt.close()
    return [cluster.held, _records(recs)]


# --- the fleet under the engine --------------------------------------------


@scenario
def self_healing_kill_replica_spawns_replacement(P):
    """The reference's ``TestSelfHealingE2E`` in seconds: a chaos
    ``kill_replica`` mid-serve; the death's journal event is the sensor;
    the fault-response policy spawns replacement capacity through the
    router verb with no human in the loop."""
    import tempfile

    j = P.tel.get_journal()
    before = len(j.events(kind="remediation_decision"))
    path = P.chaos.ChaosPlan().kill_replica(1, at_chunk=2).save(
        os.path.join(tempfile.mkdtemp(), "plan.json"))
    os.environ[P.chaos.TFOS_CHAOS_PLAN] = path
    eng = None
    try:
        rt = _fake_router(P, n=2, slots=2, max_new=12, chunk=2)
        eng = P.rem.wire(
            router=rt, interval=0.02,
            guardrails=P.rem.Guardrails(cooldown_sec=5.0, budget=5),
            straggler=None, autoscale=None, page=None,
            slo_rollback=None).start()
        rows = ff.prompts([6, 8, 5, 7, 9, 4, 6, 8])
        out = list(rt.serve([dict(r) for r in rows]))
        assert len(out) == len(rows) and all("error" not in r for r in out)
        assert rt.stats["replica_deaths"] == 1
        deadline = time.time() + 10.0
        decided = []
        while time.time() < deadline and not decided:
            decided = [d for d in eng.decisions
                       if d["action"] == "spawn_replica" and d["executed"]]
            time.sleep(0.02)
        assert decided, "no spawn_replica decision within 10 s"
        (d,) = decided
        assert d["policy"] == "fault-response"
        assert d["evidence"]["lost_replica"] == 1
        live = sum(1 for r in rt.replicas if r.alive and r.state == "live")
        assert live >= 2
        evs = j.events(kind="remediation_decision")[before:]
        assert any(e.attrs["action"] == "spawn_replica" for e in evs)
        eng.stop()
        eng = None
        # the spawned replica serves
        again = list(rt.serve([dict(r) for r in rows]))
        assert ff.tokens(again) == ff.tokens(out)
        spawned = rt.replicas[2].stats.get("completed", 0)
        assert spawned >= 1
        rt.close()
    finally:
        if eng is not None:
            eng.stop()
        os.environ.pop(P.chaos.TFOS_CHAOS_PLAN, None)
    return [ff.tokens(out), _records([d], LIVE_IDS + ("request_ids",)),
            live]


@scenario
def deploy_in_flight_defers_every_intent(P):
    """A rolling deploy mid-step: the live router's ``deploy_active`` is the
    conflict rule's sensor; every intent is deferred, no actuator moves,
    and one ``remediation_deferred`` event is journaled."""
    j = P.tel.get_journal()
    before = len(j.events(kind="remediation_deferred"))
    rt = _fake_router(P, n=2, slots=2)
    acts = _recording(P)()
    try:
        rt.start_rolling_deploy(params="v1")
        assert rt.deploy_active()
        eng = P.rem.wire(router=rt, policies=[
            _always(P, unique_targets=True),
            _always(P, action="degrade_admission", unique_targets=True)],
            guardrails=P.rem.Guardrails(cooldown_sec=0.0))
        eng.actuators = acts
        for _ in range(3):
            assert eng.step() == []
    finally:
        rt.close()
    assert acts.calls == [] and eng.stats["deferred"] == 6
    evs = j.events(kind="remediation_deferred")[before:]
    assert len(evs) == 1
    return [_stats(eng), _strip(evs[0].attrs)]


class _FakePlane(object):
    def __init__(self, slo):
        self.slo = slo
        self.hints = {}


@scenario
def rollback_generation_of_an_engine_on_probation(P):
    """A manual swap leaves replica 0 on post-swap probation; an SLO burn
    drives ``SloRollbackPolicy`` -> ``FleetActuators.rollback_generation``
    -> ``hot_swap.flag_probation_fault``, and the engine rolls itself
    back to the old weights on its next scheduling pass."""
    rt = _fake_router(P, n=2, slots=2, engine_opts={"rollback_window": 50})
    slo = _FakeSlo(P)
    try:
        rt.replicas[0].engine.request_swap("v1")
        rows = [dict(r) for r in ff.prompts([5, 6, 7, 8])]
        first = list(rt.serve(rows))
        assert rt.replicas[0].engine.decoder.params == "v1"
        eng = P.rem.wire(_FakePlane(slo), router=rt,
                         policies=[P.rem.SloRollbackPolicy()],
                         guardrails=P.rem.Guardrails(cooldown_sec=30.0))
        assert eng.sensors.poll().probation == [0]
        slo.fire(rule="serving-burn", severity="page")
        (d,) = eng.step()
        assert d["action"] == "rollback_generation" and d["executed"]
        assert d["target"] == {"replicas": [0]}
        second = list(rt.serve([dict(r) for r in ff.prompts([5, 6])]))
    finally:
        rt.close()
    e0 = rt.replicas[0].engine
    assert e0.decoder.params == "v0" and e0.stats["rollbacks"] == 1
    assert e0._prev_weights is None
    return [_records([d]), ff.tokens(first), ff.tokens(second),
            e0.stats["swaps"], e0.stats["rollbacks"]]


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_the_reference(name):
    fn = SCENARIOS[name]
    got = fn(PKGS["torch"])
    want = fn(PKGS["jax"])
    assert got == want


def test_chaos_combined_and_schedule_equal_the_reference(tmp_path):
    spec = dict(
        slow_executor={"executor_id": 1, "per_batch_sec": 0.4,
                       "batches": 3, "at_sec": 2},
        kill_leader={"at_window": 3, "at_sec": 5},
        kill_replica={"replica_id": 1, "at_chunk": 4},
        corrupt_checkpoint={"kind": "shape_mismatch", "at_sec": 1.5})
    ours = chaos.ChaosPlan.combined(**spec)
    theirs = jchaos.ChaosPlan.combined(**spec)
    assert ours.faults == theirs.faults
    assert ours.schedule() == theirs.schedule()
    assert [s for s, _ in ours.schedule()] == [0.0, 1.5, 2.0, 5.0]
    # the plan file round-trips across packages, and the port's hooks read
    # their faults out of a combined plan
    path = ours.save(tmp_path / "plan.json")
    assert jchaos.ChaosPlan.load(path).faults == theirs.faults
    assert chaos.ChaosPlan().kill_leader(7).faults == \
        jchaos.ChaosPlan().kill_leader(7).faults
    assert chaos.ChaosPlan.combined().faults == [] == \
        jchaos.ChaosPlan.combined().faults
    os.environ[chaos.TFOS_CHAOS_PLAN] = path
    try:
        assert chaos.replica_fault_fn(1) is not None
        assert chaos.replica_fault_fn(0) is None
        ctx = types.SimpleNamespace(executor_id=1)
        assert chaos.slow_feed_fn(ctx) is not None
    finally:
        os.environ.pop(chaos.TFOS_CHAOS_PLAN, None)


def test_catalog_rows_equal_the_reference():
    from tensorflowonspark_tpu.telemetry import catalog as jcatalog
    from tensorflowonspark_tpu_torch.telemetry import catalog

    ours = {m.name: m for m in catalog.METRICS
            if m.name.startswith("remediation.")}
    theirs = {m.name: m for m in jcatalog.METRICS
              if m.name.startswith("remediation.")}
    assert ours == theirs and len(ours) == 5
    assert catalog.duplicates() == []


def _cursor_run(mod):
    """Two emitters and a cursor reader over ``mod``'s ``EventJournal``:
    emitter A builds its event slowly (held in ``Event.__init__`` until
    the reader has polled once); emitter B emits meanwhile.  Returns the
    kinds the reader's two ``events_since`` polls saw."""
    import threading

    gate = threading.Event()

    class SlowEvent(mod.Event):
        def __init__(self, kind, *a, **kw):
            super(SlowEvent, self).__init__(kind, *a, **kw)
            if kind == "slow":
                gate.wait(1.0)

    j = mod.EventJournal(enabled=True)
    orig, mod.Event = mod.Event, SlowEvent
    try:
        a = threading.Thread(target=j.emit, args=("slow",))
        a.start()
        time.sleep(0.1)
        b = threading.Thread(target=j.emit, args=("fast",))
        b.start()
        time.sleep(0.1)
        first = []
        reader = threading.Thread(target=lambda: first.extend(
            j.events_since(0)))
        reader.start()
        reader.join(0.3)
        gate.set()
        for t in (a, b, reader):
            t.join(5)
    finally:
        mod.Event = orig
    cursor = max([e.seq for e in first] or [0])
    second = j.events_since(cursor)
    return sorted(e.kind for e in first + second)


def test_journal_cursor_never_passes_an_unappended_event():
    """An event whose seq was drawn before a later event's but appended
    after it must still reach a cursor reader (the remediation engine's
    journal sensor, the heartbeat's ``drain_unshipped``).  The port draws
    the seq under the append lock; the reference draws it before, and its
    reader skips the slow event for good."""
    assert _cursor_run(journal) == ["fast", "slow"]
    assert _cursor_run(jjournal) == ["fast"]
