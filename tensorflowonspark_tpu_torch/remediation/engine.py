"""The remediation engine: sensor snapshots -> policies -> guardrails ->
audited actuator calls (port of the JAX package's
``remediation/engine.py``).

One evaluation round (:meth:`RemediationEngine.step`):

1. :class:`Sensors` polls every plane through CURSORS: SLO alert
   transitions via ``SloEngine.alerts_since(seq)`` (the bounded history
   can age a fired->resolved edge out from under a slow poller; the
   cursor makes the gap detectable), journal events via
   ``events_since`` or an ``(executor, pid, seq)`` seen-set, straggler
   hints, the router's windowed admission pressure, the probation set,
   and the deploy-in-progress flag.
2. Each policy turns the snapshot into :class:`~tensorflowonspark_tpu_torch.
   remediation.policy.Intent` records (policies own hysteresis, and
   their latches move on the engine's EXECUTION feedback,
   ``Policy.on_decision``, never on emission, so a suppressed or failed
   action stays asserted and is retried).
3. Guardrails gate execution, in order: the **conflict rule** (an
   in-progress RollingDeploy or hot-swap transaction defers ALL
   remediation: one ``remediation_deferred`` journal event per conflict
   streak, zero actuator calls), **per-action cooldowns** (at most one
   execution per ``(action, target)`` per cooldown window), a **rate
   limit** (at most N executions per rolling window across all
   actions), and the **global action budget** (on exhaustion: one
   ``remediation_budget_exhausted`` PAGE event, then hands-off until
   :meth:`RemediationEngine.rearm`).
4. What survives executes through the pluggable
   :class:`~tensorflowonspark_tpu_torch.remediation.actuators.Actuators`
   (or is only journaled, in **dry-run** mode, which charges neither the
   rate limit nor the budget) and is journaled as a typed
   ``remediation_decision`` event carrying the policy name, the action,
   the target and the triggering evidence, so ``forensics explain``
   answers "why did the fleet do that?" from the journal alone.

The engine is a single thread (``remediation-engine``); every actuator
it drives is itself thread-safe or internally serialized.  Nothing here
imports ``torch``.
"""

import collections
import itertools
import logging
import threading
import time

from tensorflowonspark_tpu_torch.remediation.policy import default_policies

logger = logging.getLogger(__name__)

_ENGINE_SEQ = itertools.count(1)


class SensorSnapshot(object):
    """One round's view of every sensor plane (plain data)."""

    __slots__ = ("t", "alerts", "alert_gap", "hints", "events",
                 "pressure", "fleet", "probation", "deploy_active")

    def __init__(self, t=0.0, alerts=(), alert_gap=False, hints=None,
                 events=(), pressure=None, fleet=None, probation=(),
                 deploy_active=False):
        self.t = t
        self.alerts = list(alerts)
        self.alert_gap = bool(alert_gap)
        self.hints = dict(hints or {})
        self.events = list(events)
        self.pressure = pressure
        self.fleet = fleet
        self.probation = list(probation)
        self.deploy_active = bool(deploy_active)


class Sensors(object):
    """Cursor-tracking reader over the sensor planes.  Every source
    is an optional callable (or object) so tests inject synthetic
    planes and production wires the real ones
    (:func:`~tensorflowonspark_tpu_torch.remediation.wire`):

    Args:
      slo: a :class:`~tensorflowonspark_tpu_torch.telemetry.health.
        SloEngine` — read via ``alerts_since`` with a cursor, so a
        slow poll can MISS no edge silently (``alert_gap`` flips when
        transitions aged out of the bounded history unseen).
      hints_fn: zero-arg → the health plane's straggler ``hints``.
      journal: an :class:`~tensorflowonspark_tpu_torch.telemetry.journal.
        EventJournal` (local cursor via ``events_since``) — or pass
        ``events_fn`` returning event DICTS for fleet-shipped events;
        those dedup through a bounded ``(executor, pid, seq)``
        seen-set.
      pressure_fn: zero-arg → the router's windowed admission
        pressure dict.
      fleet_fn: zero-arg → ``{"live": n, "replicas": n}``.
      probation_fn: zero-arg → replica ids on post-swap probation.
      deploy_active_fn: zero-arg → True while a RollingDeploy or
        hot-swap transaction is mid-step (the conflict rule).
    """

    def __init__(self, slo=None, hints_fn=None, journal=None,
                 events_fn=None, pressure_fn=None, fleet_fn=None,
                 probation_fn=None, deploy_active_fn=None, clock=None):
        self.slo = slo
        self.hints_fn = hints_fn
        self.journal = journal
        self.events_fn = events_fn
        self.pressure_fn = pressure_fn
        self.fleet_fn = fleet_fn
        self.probation_fn = probation_fn
        self.deploy_active_fn = deploy_active_fn
        self._clock = clock or time.monotonic
        self._alert_cursor = (
            slo.last_alert_seq if slo is not None else 0
        )
        self._journal_cursor = 0
        if journal is not None:
            evs = journal.events()
            self._journal_cursor = evs[-1].seq if evs else 0
        self._seen = collections.deque(maxlen=4096)
        self._seen_set = set()

    def _call(self, fn, default=None):
        if fn is None:
            return default
        try:
            return fn()
        except Exception:  # noqa: BLE001 - a dead sensor must not
            logger.warning(  # kill the remediation loop
                "remediation sensor failed", exc_info=True
            )
            return default

    def _poll_alerts(self):
        if self.slo is None:
            return [], False
        new = self.slo.alerts_since(self._alert_cursor)
        gap = False
        if new:
            if new[0].seq > self._alert_cursor + 1:
                gap = True
            self._alert_cursor = new[-1].seq
        elif self.slo.last_alert_seq > self._alert_cursor:
            # everything since our cursor already aged out of the
            # bounded history — edges were missed; resync the cursor
            gap = True
            self._alert_cursor = self.slo.last_alert_seq
        return [a.to_dict() for a in new], gap

    def _poll_events(self):
        if self.journal is not None:
            evs = self.journal.events_since(self._journal_cursor)
            if evs:
                self._journal_cursor = evs[-1].seq
            return [e.to_dict() for e in evs]
        out = []
        for ev in self._call(self.events_fn, []) or []:
            key = (ev.get("executor"), ev.get("pid"), ev.get("seq"))
            if key in self._seen_set:
                continue
            if len(self._seen) == self._seen.maxlen:
                self._seen_set.discard(self._seen[0])
            self._seen.append(key)
            self._seen_set.add(key)
            out.append(ev)
        return out

    def poll(self):
        alerts, gap = self._poll_alerts()
        return SensorSnapshot(
            t=self._clock(),
            alerts=alerts, alert_gap=gap,
            hints=self._call(self.hints_fn, {}),
            events=self._poll_events(),
            pressure=self._call(self.pressure_fn),
            fleet=self._call(self.fleet_fn),
            probation=self._call(self.probation_fn, []) or [],
            deploy_active=bool(self._call(self.deploy_active_fn, False)),
        )


class Guardrails(object):
    """The engine's safety envelope (checked in this order):

    - ``cooldown_sec``: at most one EXECUTION per ``(action, target)``
      per window (``per_action`` overrides per action name) — a
      sensor flapping at any rate drives the actuator at most once
      per window;
    - ``rate_limit``/``rate_window_sec``: at most N executions per
      rolling window across ALL actions;
    - ``budget``: lifetime action budget; exhaustion journals
      ``remediation_budget_exhausted`` at PAGE severity and the
      engine goes hands-off (a self-driving loop that has acted this
      many times without converging is the incident);
    - ``dry_run``: journal every intended action, execute none, and
      charge neither the rate limit nor the budget — rehearsals are
      free, and the preview's audit trail is complete (a dry run
      that rate-limited intents away would journal a DIFFERENT
      sequence than the operator asked to preview).  Cooldown dedup
      still applies, bounding journal spam from a flapping sensor.

    ``stand_down`` decisions are exempt from rate limit and budget
    (they ARE the non-action), but still cooldown-deduped.
    """

    def __init__(self, cooldown_sec=30.0, per_action=None,
                 rate_limit=4, rate_window_sec=60.0, budget=25,
                 dry_run=False):
        self.cooldown_sec = float(cooldown_sec)
        self.per_action = dict(per_action or {})
        self.rate_limit = int(rate_limit)
        self.rate_window_sec = float(rate_window_sec)
        self.budget = int(budget)
        self.dry_run = bool(dry_run)

    def cooldown_for(self, action):
        return float(self.per_action.get(action, self.cooldown_sec))


class RemediationEngine(object):
    """See module docstring.  Drive it with :meth:`step` (tests, or
    any external loop) or :meth:`start` (own thread).

    Args:
      sensors: a :class:`Sensors`.
      actuators: an object exposing the :data:`~tensorflowonspark_tpu_torch.
        remediation.policy.ACTIONS` verbs (see actuators.py); tests
        pass a recording fake.
      policies: policy list (default :func:`default_policies`).
      guardrails: a :class:`Guardrails` (default: defaults).
      interval: thread loop cadence.
      clock: injectable monotonic clock (guardrail tests).
    """

    MAX_DECISIONS = 256

    def __init__(self, sensors, actuators, policies=None,
                 guardrails=None, interval=1.0, clock=None,
                 name=None):
        from tensorflowonspark_tpu_torch import telemetry

        self.sensors = sensors
        self.actuators = actuators
        self.policies = (
            default_policies() if policies is None else list(policies)
        )
        self.guardrails = guardrails or Guardrails()
        self.interval = float(interval)
        self._clock = clock or time.monotonic
        self.name = name or "remediation%d" % next(_ENGINE_SEQ)
        self.armed = True
        self.decisions = collections.deque(maxlen=self.MAX_DECISIONS)
        self.stats = {
            "rounds": 0, "decisions": 0, "executed": 0,
            "suppressed": 0, "deferred": 0, "failed": 0,
            "budget_spent": 0,
        }
        self._last_exec = {}       # intent.key() -> exec time
        self._exec_times = collections.deque()  # rolling rate window
        self._decision_seq = itertools.count(1)
        self._conflict_streak = False
        self._stop = threading.Event()
        self._thread = None
        self._tracer = telemetry.get_tracer()
        reg = telemetry.get_registry()
        self._m_decisions = reg.counter("remediation.decisions")
        self._m_executed = reg.counter("remediation.actions_executed")
        self._m_suppressed = reg.counter(
            "remediation.actions_suppressed"
        )
        self._m_deferred = reg.counter("remediation.actions_deferred")
        self._m_budget = reg.gauge("remediation.budget_remaining")
        self._m_budget.set(self.guardrails.budget)
        self._register_status()

    def _register_status(self):
        import weakref

        from tensorflowonspark_tpu_torch.telemetry import health as _health

        ref = weakref.ref(self)

        def _status():
            eng = ref()
            return (
                {"finished": True} if eng is None else eng.status()
            )

        _health.register_status_provider("remediation", _status)

    # -- public surface --------------------------------------------------

    def status(self):
        g = self.guardrails
        return {
            "armed": self.armed,
            "dry_run": g.dry_run,
            "budget": g.budget,
            "budget_remaining": self.budget_remaining(),
            "cooldown_sec": g.cooldown_sec,
            "policies": [p.name for p in self.policies],
            "stats": dict(self.stats),
            "decisions": [d for d in list(self.decisions)[-20:]],
        }

    def budget_remaining(self):
        return max(0, self.guardrails.budget
                   - self.stats["budget_spent"])

    def rearm(self, budget=None):
        """Operator override: restore a hands-off engine (optionally
        with a fresh budget).  Journaled — un-pausing the
        self-driving loop is itself an audited event."""
        if budget is not None:
            self.guardrails.budget = int(budget)
            self.stats["budget_spent"] = 0
        self.armed = True
        self._m_budget.set(self.budget_remaining())
        self._tracer.mark(
            "remediation_rearmed", trace="remediation",
            budget=self.guardrails.budget, engine=self.name,
        )

    # -- one evaluation round --------------------------------------------

    def step(self):
        """One sensor→policy→guardrail→actuator round; returns the
        list of decision records journaled this round."""
        if not self.armed:
            return []
        snap = self.sensors.poll()
        self.stats["rounds"] += 1
        intents = []
        for p in self.policies:
            try:
                intents.extend(p.evaluate(snap) or [])
            except Exception:  # noqa: BLE001 - one bad policy must
                logger.warning(  # not kill the loop
                    "remediation policy %r failed", p.name,
                    exc_info=True,
                )
        if not intents:
            self._conflict_streak = False
            return []
        if snap.deploy_active:
            # the conflict rule: never fight an in-progress
            # RollingDeploy / hot-swap transaction.  Zero actuator
            # calls, zero decisions; one deferred event per streak.
            self.stats["deferred"] += len(intents)
            self._m_deferred.inc(len(intents))
            if not self._conflict_streak:
                self._conflict_streak = True
                self._tracer.mark(
                    "remediation_deferred", trace="remediation",
                    intents=[i.action for i in intents],
                    engine=self.name, reason="deploy_in_progress",
                )
            return []
        self._conflict_streak = False
        out = []
        for intent in intents:
            try:
                rec = self._consider(intent, snap)
            except Exception:  # noqa: BLE001 - one bad intent must not
                rec = None     # drop the rest of the round
                self.stats["failed"] += 1
                logger.warning(
                    "remediation intent %r failed", intent,
                    exc_info=True,
                )
            if rec is not None:
                out.append(rec)
        return out

    def _consider(self, intent, snap):
        g = self.guardrails
        now = self._clock()
        # cooldown: one execution per (action, target) per window
        last = self._last_exec.get(intent.key())
        if last is not None and now - last < g.cooldown_for(
                intent.action):
            self.stats["suppressed"] += 1
            self._m_suppressed.inc()
            return None
        virtual = intent.action == "stand_down"
        if not virtual and not g.dry_run:
            # rolling rate limit across all actions.  Dry-run is
            # exempt (and charges nothing below): a rehearsal must
            # journal EVERY intended action — rate-limit/budget
            # suppression would silence part of the preview's audit
            # trail without any actuator having moved.
            horizon = now - g.rate_window_sec
            while self._exec_times and self._exec_times[0] < horizon:
                self._exec_times.popleft()
            if len(self._exec_times) >= g.rate_limit:
                self.stats["suppressed"] += 1
                self._m_suppressed.inc()
                return None
            if self.budget_remaining() <= 0:
                self._exhaust(intent)
                return None
        executed, error = False, None
        if not g.dry_run and not virtual:
            try:
                getattr(self.actuators, intent.action)(
                    **intent.target
                )
                executed = True
            except Exception as e:  # noqa: BLE001 - a failed actuator
                error = repr(e)     # is a journaled outcome, not a crash
                self.stats["failed"] += 1
                logger.warning(
                    "remediation action %r failed", intent.action,
                    exc_info=True,
                )
        self._last_exec[intent.key()] = now
        if executed:
            self._exec_times.append(now)
            self.stats["budget_spent"] += 1
            self._m_budget.set(self.budget_remaining())
        rec = self._journal_decision(
            intent, snap, executed=executed, error=error
        )
        self._notify(rec)
        return rec

    def _notify(self, rec):
        """Execution feedback: report the journaled decision back to
        the policy that emitted it, so hysteresis latches move on
        what actually HAPPENED (executed / dry-run / failed), not on
        what was wished for."""
        for p in self.policies:
            if p.name != rec["policy"]:
                continue
            try:
                p.on_decision(rec)
            except Exception:  # noqa: BLE001 - feedback must not
                logger.warning(  # kill the round
                    "remediation policy %r on_decision failed",
                    p.name, exc_info=True,
                )

    def _exhaust(self, intent):
        """Budget exhausted: one PAGE event, then hands-off."""
        self.armed = False
        self._m_budget.set(0)
        self._tracer.mark(
            "remediation_budget_exhausted", trace="remediation",
            severity="page", engine=self.name,
            budget=self.guardrails.budget,
            last_intent=intent.to_dict(),
        )
        logger.error(
            "remediation action budget (%d) exhausted; engine %s "
            "going hands-off (rearm() to restore)",
            self.guardrails.budget, self.name,
        )

    def _journal_decision(self, intent, snap, executed, error=None):
        rec = intent.to_dict()
        rec.update({
            "decision": next(self._decision_seq),
            "engine": self.name,
            "executed": executed,
            "dry_run": self.guardrails.dry_run,
        })
        if error is not None:
            rec["error"] = error
        if snap.alert_gap:
            rec["alert_gap"] = True
        self.decisions.append(rec)
        self.stats["decisions"] += 1
        self._m_decisions.inc()
        if executed:
            self.stats["executed"] += 1
            self._m_executed.inc()
        # the decision IS a typed journal event (the tracer mark
        # auto-bridges into the journal and ships driver-ward with
        # the heartbeat piggyback) — severity from the intent so a
        # page-grade action dumps the flight recorder
        self._tracer.mark(
            "remediation_decision", trace="remediation",
            severity=intent.severity
            if intent.severity in ("info", "warn", "page") else "warn",
            **{k: rec[k] for k in (
                "decision", "engine", "action", "policy", "target",
                "evidence", "reason", "executed", "dry_run",
            )}
        )
        return rec

    # -- the loop --------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="remediation-engine",
            )
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.step()
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.warning("remediation step failed", exc_info=True)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
