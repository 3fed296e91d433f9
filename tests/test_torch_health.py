"""The port's fleet health plane (``telemetry/health.py``) against the JAX
package's, on the CPU.

- Parity: the same recorded snapshot sequences (three executors, one of
  them slow in its feed, one restarted midway so its counters reset),
  under one injected clock, go through both packages'
  ``TimeSeriesStore``, ``SloEngine``, ``StragglerDetector`` and
  ``HealthPlane``.  Windowed sums, rates, p99s, means and series, the
  alerts (rule, state, value, threshold, window, executor, severity,
  message), the straggler hints, ``healthz`` and ``status`` are equal
  exactly (tolerance 0: the inputs are the same dicts, and both packages
  do the same float operations on them).  Only an alert's wall-clock
  ``t`` and the plane's uptime are left out.
- The reference's cases (``tests/test_health.py``): resets, the window
  edge, the ring bound, the rule grammar and its errors, hysteresis,
  ``for_count``, burn rates, per-executor rules, straggler phases, the
  plane's stale-snapshot rule, hooks that raise, hint expiry.  Each runs
  on both packages.
- A profile request end to end without a cluster: ``TPUCluster.
  _request_profile`` writes it into a node manager's kv, the compute
  side's ``NodePublisher.check_profile_request`` hands it to the
  training thread, whose next ``tensorboard.profile_step`` starts a CPU
  ``torch.profiler`` session, and the publisher's next pass acknowledges
  in ``profile_state``; a second request while that session lives
  acknowledges ``started: False`` at once.
- ``train_on_feed`` feeds the phase histograms the detector reads.
"""

import copy
import json
import os
import time
import types

import numpy as np
import pytest

from tensorflowonspark_tpu import telemetry as jtel
from tensorflowonspark_tpu.telemetry import health as jhealth
from tensorflowonspark_tpu.telemetry import registry as jreg
from tensorflowonspark_tpu_torch import telemetry as ttel
from tensorflowonspark_tpu_torch.telemetry import health as thealth
from tensorflowonspark_tpu_torch.telemetry import registry as treg

PKGS = {
    "jax": types.SimpleNamespace(health=jhealth, reg=jreg, tel=jtel),
    "torch": types.SimpleNamespace(health=thealth, reg=treg, tel=ttel),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class _Clock(object):
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt


def _snap(pkg, counters=None, hists=None, gauges=None):
    """A registry snapshot of ``pkg``; ``hists`` maps a name to values."""
    reg = pkg.reg.MetricsRegistry(enabled=True)
    for name, v in (counters or {}).items():
        reg.counter(name).inc(v)
    for name, v in (gauges or {}).items():
        reg.gauge(name).set(v)
    for name, values in (hists or {}).items():
        h = reg.histogram(name)
        for v in values:
            h.observe(v)
    return reg.snapshot()


# ----------------------------------------------------------------------
# parity on recorded sequences
# ----------------------------------------------------------------------

PHASES = ("train.step_sec", "train.feed_wait_sec", "train.h2d_sec",
          "train.dispatch_sec")
RULES = [
    {"name": "step-p99", "metric": "train.step_sec", "stat": "p99",
     "op": "<", "threshold": 0.05, "window": 20, "clear_after": 2},
    {"name": "feed-mean", "metric": "train.feed_wait_sec", "stat": "mean",
     "op": "<", "threshold": 0.02, "window": 10, "for_count": 2},
    {"name": "step-rate", "metric": "train.steps", "stat": "rate",
     "op": ">", "threshold": 5.0, "window": 10},
    {"name": "step-count", "metric": "train.steps", "stat": "count",
     "op": "<", "threshold": 150, "window": 30, "severity": "page"},
    {"name": "gauge", "metric": "queue.depth", "stat": "gauge", "op": "<",
     "threshold": 0.9},
    {"name": "errors", "kind": "burn_rate", "bad": "serving.errors",
     "total": "serving.completed", "objective": 0.99, "short_window": 6,
     "long_window": 20, "burn_threshold": 2.0, "severity": "page"},
    {"name": "per-exec", "metric": "train.dispatch_sec", "stat": "p90",
     "op": "<", "threshold": 0.004, "window": 12, "per_executor": True},
]


def _recorded(seed=0, scrapes=14):
    """Per scrape, ``{executor: cumulative snapshot}`` as plain JSON data:
    executor 1 turns slow in its feed at scrape 5, executor 2 restarts at
    scrape 7 (a fresh registry: its counters reset), errors burst in
    scrapes 8-10."""
    rng = np.random.default_rng(seed)
    regs = {e: treg.MetricsRegistry(enabled=True) for e in range(3)}
    seq = []
    for k in range(scrapes):
        if k == 7:
            regs[2] = treg.MetricsRegistry(enabled=True)
        frame = {}
        for e, reg in sorted(regs.items()):
            slow = e == 1 and k >= 5
            for _ in range(6):
                reg.histogram("train.step_sec").observe(
                    float(rng.gamma(2.0, 0.01)))
                reg.histogram("train.feed_wait_sec").observe(
                    float(rng.exponential(0.2 if slow else 0.002)))
                reg.histogram("train.h2d_sec").observe(
                    float(rng.exponential(0.001)))
                reg.histogram("train.dispatch_sec").observe(
                    float(rng.exponential(0.003 * (e + 1))))
            reg.counter("train.steps").inc(6)
            reg.counter("serving.completed").inc(50)
            reg.counter("serving.errors").inc(
                int(rng.integers(5, 9)) if 8 <= k <= 10 else
                int(rng.integers(0, 2)))
            reg.gauge("queue.depth").set(float(rng.random()))
            frame[e] = json.loads(json.dumps(reg.snapshot()))
        seq.append(frame)
    return seq


def _alert(a):
    d = a.to_dict() if hasattr(a, "to_dict") else dict(a)
    d.pop("t", None)
    return d


def _store_queries(store, executors):
    out = []
    for eid in [None] + executors:
        for window in (5, 20, 1000):
            row = {
                "sum": store.sum_over("train.steps", window, eid),
                "rate": store.rate("train.steps", window, eid),
                "hist": store.hist_over("train.step_sec", window, eid),
                "p99": store.p99_over("train.step_sec", window, eid),
                "p50": store.p99_over("train.feed_wait_sec", window, eid,
                                      q=50),
                "mean": store.mean_over("train.feed_wait_sec", window, eid),
                "gauge": store.gauge_last("queue.depth", eid),
            }
            if eid is not None:
                row["series"] = [
                    store.series("train.steps", eid, window),
                    store.series("queue.depth", eid, window, kind="gauge"),
                    store.series("train.step_sec", eid, window,
                                 kind="hist_count"),
                    store.series("train.step_sec", eid, window,
                                 kind="hist_mean"),
                ]
            out.append(row)
    return out


def _run_engine_and_detector(pkg, seq):
    clock = _Clock()
    store = pkg.health.TimeSeriesStore(window=30, clock=clock)
    reg = pkg.reg.MetricsRegistry(enabled=True)
    eng = pkg.health.SloEngine(store, copy.deepcopy(RULES), registry=reg)
    det = pkg.health.StragglerDetector(store, window=10, min_samples=3)
    per_scrape = []
    for frame in seq:
        clock.tick(2.0)
        for eid, snap in sorted(frame.items()):
            store.append(eid, copy.deepcopy(snap))
        per_scrape.append({
            "transitions": [_alert(a) for a in eng.evaluate()],
            "active": eng.active(),
            "stragglers": det.diagnose(),
            "queries": _store_queries(store, [0, 1, 2]),
        })
    return {
        "scrapes": per_scrape,
        "history": [_alert(a) for a in eng.alert_history()],
        "since": [_alert(a) for a in eng.alerts_since(2)],
        "last_seq": eng.last_alert_seq,
        "counters": reg.snapshot()["counters"],
        "gauges": reg.snapshot()["gauges"],
        "store_scrapes": store.scrapes,
    }


def test_store_engine_and_detector_equal_the_reference():
    seq = _recorded(scrapes=22)
    got = _run_engine_and_detector(PKGS["torch"], seq)
    want = _run_engine_and_detector(PKGS["jax"], seq)
    assert got == want
    # the sequence exercises what it is meant to: alerts fire and
    # resolve, the burn-rate page fires, executor 1 is flagged in feed
    states = {(a["rule"], a["state"]) for a in got["history"]}
    assert {("step-rate", "firing"), ("errors", "firing"),
            ("errors", "resolved")} <= states
    flagged = [h for s in got["scrapes"] for h in s["stragglers"]]
    assert flagged and {(h["executor"], h["phase"]) for h in flagged} \
        == {(1, "feed")}


def _plane_run(pkg, seq, liveness):
    clock = _Clock()
    hooked, cleared = [], []
    feed = iter(seq)
    frames = {}

    def metrics_fn():
        frames.clear()
        frames.update(next(feed))
        return {e: {"metrics": copy.deepcopy(s), "metrics_age": 0.1}
                for e, s in frames.items()}

    plane = pkg.health.HealthPlane(
        metrics_fn, interval=60, window=30, slo=copy.deepcopy(RULES),
        straggler_opts={"window": 10, "min_samples": 3},
        on_straggler=hooked.append, on_straggler_cleared=cleared.append,
        straggler_clear_rounds=2, liveness_fn=lambda: dict(liveness),
        registry=pkg.reg.MetricsRegistry(enabled=True))
    store = pkg.health.TimeSeriesStore(window=30, clock=clock)
    plane.store = plane.slo.store = plane.detector.store = store
    rounds = []
    for _ in seq:
        clock.tick(2.0)
        transitions = plane.scrape_once()
        status = plane.status()
        for key in ("uptime_sec", "providers"):
            status.pop(key)
        status["alert_history"] = [_alert(a)
                                   for a in status["alert_history"]]
        rounds.append({
            "transitions": [_alert(a) for a in transitions],
            "hints": copy.deepcopy(plane.hints),
            "healthz": plane.healthz(),
            "status": status,
            "merged": plane.merged_snapshot(),
        })
    return {"rounds": rounds, "hooked": hooked, "cleared": cleared}


@pytest.mark.parametrize("liveness", [
    {"healthy": True, "executors": 3, "dead": {}},
    {"healthy": False, "executors": 3,
     "dead": {"2": "no heartbeat for 3.1s (> 3 x 1.0s interval)"}},
], ids=["live", "one_dead"])
def test_health_plane_equals_the_reference(liveness):
    # executor 1 turns slow at scrape 5 and is sped up at scrape 11: the
    # hint fires once and expires after two clean rounds
    seq = _recorded(scrapes=11)
    fast = _recorded(seed=1, scrapes=14)[11:]
    for frame, quick in zip(fast, fast):
        frame[1] = quick[0]
    seq = seq + fast
    got = _plane_run(PKGS["torch"], seq, liveness)
    want = _plane_run(PKGS["jax"], seq, liveness)
    assert got == want
    assert [h["executor"] for h in got["hooked"]] == [1]
    assert got["rounds"][-1]["healthz"]["healthy"] is False  # a page fired
    if not liveness["healthy"]:
        assert any("executor 2 dead" in r
                   for r in got["rounds"][0]["healthz"]["reasons"])


# ----------------------------------------------------------------------
# the reference's cases, on both packages
# ----------------------------------------------------------------------


def test_delta_frames_and_windowed_sums(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=10, clock=clock)
    st.append(0, _snap(pkg, counters={"c": 5}))
    clock.tick(2)
    st.append(0, _snap(pkg, counters={"c": 9}))
    assert st.sum_over("c") == 9  # 5 + (9 - 5)
    assert st.rate("c", window=10) == 9 / 2.0
    assert st.executors() == [0]


def test_counter_reset_uses_post_reset_value(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=100, clock=clock)
    st.append(0, _snap(pkg, counters={"c": 100}))
    clock.tick()
    st.append(0, _snap(pkg, counters={"c": 3}))  # restarted, did 3 more
    assert st.sum_over("c") == 103


def test_histogram_reset_uses_post_reset_snapshot(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=100, clock=clock)
    st.append(0, _snap(pkg, hists={"h": [0.1] * 50}))
    clock.tick()
    st.append(0, _snap(pkg, hists={"h": [0.2, 0.2]}))
    assert st.hist_over("h")["count"] == 52


def test_histogram_reset_with_higher_post_restart_count(pkg):
    # more observations after the restart than before: only the
    # buckets going backwards show the reset
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=100, clock=clock)
    st.append(0, _snap(pkg, hists={"h": [0.001] * 5}))
    clock.tick()
    st.append(0, _snap(pkg, hists={"h": [5.0] * 6}))
    h = st.hist_over("h")
    assert h["count"] == 11
    assert all(c >= 0 for _lo, _hi, c in h["buckets"])
    assert h["sum"] == pytest.approx(5 * 0.001 + 6 * 5.0, rel=1e-15)


def test_out_of_window_frames_excluded(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=10, clock=clock)
    st.append(0, _snap(pkg, counters={"c": 5}))
    clock.tick(60)
    st.append(0, _snap(pkg, counters={"c": 8}))
    clock.tick(1)
    st.append(0, _snap(pkg, counters={"c": 9}))
    assert st.sum_over("c", window=10) == 4
    assert st.sum_over("c", window=1000) == 9


def test_ring_is_bounded(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=1e6, max_frames=5, clock=clock)
    for i in range(50):
        clock.tick()
        st.append(0, _snap(pkg, counters={"c": i + 1}))
    assert len(st.frames(0, window=1e6)) == 5
    assert st.scrapes == 50


def test_gauge_last_and_disjoint_executors(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=100, clock=clock)
    st.append(0, _snap(pkg, gauges={"g": 2.0}, counters={"a": 1}))
    st.append(1, _snap(pkg, gauges={"g": 7.0}, counters={"b": 2},
                       hists={"h": [0.1]}))
    st.append(2, {})
    st.append(3, None)
    clock.tick()
    st.append(0, _snap(pkg, gauges={"g": 3.0}, counters={"a": 4}))
    assert st.gauge_last("g") == 7.0  # the fleet keeps the largest
    assert st.gauge_last("g", executor=0) == 3.0
    assert [v for _t, v in st.series("a", executor=0)] == [1, 3]
    assert st.sum_over("a", executor=1) == 0
    assert st.hist_over("h")["count"] == 1
    assert st.executors() == [0, 1]
    with pytest.raises(ValueError, match="series kind"):
        st.series("h", executor=1, kind="nope")


def test_load_rules_from_list_dict_json_yaml(pkg, tmp_path):
    spec = [{"name": "r1", "metric": "m", "stat": "p99", "op": "<",
             "threshold": 0.5, "window": 30}]
    assert len(pkg.health.load_rules(spec)) == 1
    assert len(pkg.health.load_rules({"rules": spec})) == 1
    jpath = tmp_path / "slo.json"
    jpath.write_text(json.dumps({"rules": spec}))
    assert len(pkg.health.load_rules(str(jpath))) == 1
    ypath = tmp_path / "slo.yaml"
    ypath.write_text(
        "rules:\n"
        "  - name: serving-p99\n"
        "    metric: serving.request_latency_sec\n"
        "    stat: p99\n"
        "    op: \"<\"\n"
        "    threshold: 0.5\n"
        "    window: 30\n"
        "  - name: errors\n"
        "    kind: burn_rate\n"
        "    bad: serving.errors\n"
        "    total: serving.completed\n"
        "    objective: 0.999\n")
    rules = pkg.health.load_rules(str(ypath))
    assert [r.name for r in rules] == ["serving-p99", "errors"]
    assert rules[0].threshold == 0.5
    assert rules[1].kind == "burn_rate"
    assert rules[1].budget == pytest.approx(0.001, rel=1e-12)


def test_restricted_yaml_fallback_parser(pkg):
    text = ("# a comment\n"
            "rules:\n"
            "  - name: a\n"
            "    threshold: 1.5   # trailing comment\n"
            "    flag: true\n"
            "  - name: 'b'\n"
            "    window: 30\n")
    want = {"rules": [{"name": "a", "threshold": 1.5, "flag": True},
                      {"name": "b", "window": 30}]}
    assert pkg.health._parse_restricted_yaml_fallback(text) == want
    with pytest.raises(ValueError, match="cannot parse"):
        pkg.health._parse_restricted_yaml_fallback("rules:\n  bogus\n")


@pytest.mark.parametrize("spec,match", [
    ({"name": "x", "metric": "m", "op": "~", "threshold": 1}, "unknown op"),
    ({"name": "x", "metric": "m", "stat": "p95", "threshold": 1},
     "unknown stat"),
    ({"name": "x", "metric": "m", "threshold": 1, "bogus": 2},
     "unknown keys"),
    ({"name": "x", "kind": "burn_rate", "bad": "b", "total": "t",
      "objective": 1.5}, "objective"),
    ({"name": "x", "kind": "burn_rate", "total": "t", "objective": 0.99},
     "'bad' or 'good'"),
    ({"name": "x", "kind": "ratio"}, "unknown kind"),
], ids=["op", "stat", "keys", "objective", "bad_or_good", "kind"])
def test_bad_specs_raise(pkg, spec, match):
    with pytest.raises(ValueError, match=match):
        pkg.health.SloRule(spec)


def test_duplicate_rule_names_raise(pkg):
    with pytest.raises(ValueError, match="duplicate"):
        pkg.health.SloEngine(
            pkg.health.TimeSeriesStore(),
            [{"name": "d", "metric": "m", "threshold": 1},
             {"name": "d", "metric": "m", "threshold": 2}])


def test_threshold_fire_and_hysteresis_resolve(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=5, clock=clock)
    reg = pkg.reg.MetricsRegistry(enabled=True)
    lat = reg.histogram("lat")
    eng = pkg.health.SloEngine(st, [
        {"name": "lat-p99", "metric": "lat", "stat": "p99", "op": "<",
         "threshold": 0.1, "window": 5, "clear_after": 2}], registry=reg)
    for _ in range(10):
        lat.observe(0.5)
    clock.tick()
    st.append(0, reg.snapshot())
    (fired,) = eng.evaluate()
    assert fired.state == "firing" and fired.rule == "lat-p99"
    assert eng.active()[0]["rule"] == "lat-p99"
    assert reg.counter("health.alerts_fired").value == 1
    assert eng.evaluate() == []  # still firing: no second transition
    clock.tick(10)
    for _ in range(10):
        lat.observe(0.01)
    st.append(0, reg.snapshot())
    assert eng.evaluate() == []  # one clean round is not enough
    clock.tick()
    st.append(0, reg.snapshot())
    (resolved,) = eng.evaluate()
    assert resolved.state == "resolved"
    assert eng.active() == []
    assert reg.counter("health.alerts_resolved").value == 1
    assert [a.seq for a in eng.alerts_since(0)] == [1, 2]


def test_for_count_delays_firing(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=100, clock=clock)
    reg = pkg.reg.MetricsRegistry(enabled=True)
    reg.histogram("lat").observe(9.0)
    clock.tick()
    st.append(0, reg.snapshot())
    eng = pkg.health.SloEngine(st, [
        {"name": "r", "metric": "lat", "stat": "p99", "op": "<",
         "threshold": 0.1, "window": 100, "for_count": 3}], registry=reg)
    assert eng.evaluate() == []
    assert eng.evaluate() == []
    (fired,) = eng.evaluate()
    assert fired.state == "firing"


def test_burn_rate_needs_both_windows(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=1000, clock=clock)
    reg = pkg.reg.MetricsRegistry(enabled=True)
    bad, total = reg.counter("bad"), reg.counter("total")
    eng = pkg.health.SloEngine(st, [
        {"name": "burn", "kind": "burn_rate", "bad": "bad",
         "total": "total", "objective": 0.99, "short_window": 10,
         "long_window": 100, "burn_threshold": 2.0}], registry=reg)
    for _ in range(20):
        total.inc(100)
        clock.tick(5)
        st.append(0, reg.snapshot())
    bad.inc(20)  # a short blip: the long window stays healthy
    total.inc(100)
    clock.tick(1)
    st.append(0, reg.snapshot())
    assert eng.evaluate() == []
    for _ in range(20):  # sustained: both windows burn
        bad.inc(50)
        total.inc(100)
        clock.tick(5)
        st.append(0, reg.snapshot())
    (fired,) = eng.evaluate()
    assert fired.state == "firing" and fired.value > 2.0


def test_good_counter_form(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=1000, clock=clock)
    st.append(0, _snap(pkg, counters={"good": 50, "total": 100}))
    rule = pkg.health.SloRule(
        {"name": "g", "kind": "burn_rate", "good": "good", "total": "total",
         "objective": 0.9, "short_window": 100, "long_window": 100,
         "burn_threshold": 2.0})
    breaching, value, _th, _w = rule.breach(st)
    assert breaching and value == pytest.approx(5.0, rel=1e-12)


def test_per_executor_rule_names_the_offender(pkg):
    clock = _Clock()
    st = pkg.health.TimeSeriesStore(window=100, clock=clock)
    st.append(0, _snap(pkg, hists={"lat": [0.01] * 5}))
    st.append(3, _snap(pkg, hists={"lat": [2.0] * 5}))
    eng = pkg.health.SloEngine(st, [
        {"name": "r", "metric": "lat", "stat": "p99", "op": "<",
         "threshold": 0.1, "window": 100, "per_executor": True}],
        registry=pkg.reg.MetricsRegistry(enabled=True))
    (fired,) = eng.evaluate()
    assert fired.executor == 3


def _fleet_store(pkg, clock, per_executor):
    """``{eid: {phase: mean seconds}}`` as 5 scrapes of 10 observations."""
    st = pkg.health.TimeSeriesStore(window=1000, clock=clock)
    regs = {eid: pkg.reg.MetricsRegistry(enabled=True)
            for eid in per_executor}
    names = {"step": "train.step_sec", "feed": "train.feed_wait_sec",
             "h2d": "train.h2d_sec", "dispatch": "train.dispatch_sec",
             "wire": "ps.round_trip_sec"}
    for _scrape in range(5):
        for eid, phases in per_executor.items():
            for _ in range(10):
                for phase, mean in phases.items():
                    regs[eid].histogram(names[phase]).observe(mean)
            clock.tick(0.2)
            st.append(eid, regs[eid].snapshot())
    return st


@pytest.mark.parametrize("fleet,want", [
    ({e: {"step": 0.01, "feed": 0.002} for e in range(4)}, []),
    ({0: {"step": 0.01, "feed": 0.002}, 1: {"step": 0.01, "feed": 0.15},
      2: {"step": 0.01, "feed": 0.002}}, [(1, "feed")]),
    ({0: {"step": 0.02, "wire": 0.003, "feed": 0.001},
      1: {"step": 0.09, "wire": 0.07, "feed": 0.001},
      2: {"step": 0.02, "wire": 0.003, "feed": 0.001},
      3: {"step": 0.02, "wire": 0.003, "feed": 0.001}}, [(1, "wire")]),
    ({0: {"step": 0.01, "feed": 0.001, "h2d": 0.002, "dispatch": 0.004},
      1: {"step": 0.30, "feed": 0.001, "h2d": 0.002, "dispatch": 0.004},
      2: {"step": 0.01, "feed": 0.001, "h2d": 0.002, "dispatch": 0.004}},
     [(1, "host")]),
    ({0: {"step": 0.01, "feed": 0.001}, 1: {"step": 0.08, "feed": 0.001}},
     [(1, "host")]),
], ids=["even", "feed", "wire", "host", "two_nodes"])
def test_straggler_named_with_its_phase(pkg, fleet, want):
    st = _fleet_store(pkg, _Clock(), fleet)
    hints = pkg.health.StragglerDetector(st, window=1000).diagnose()
    assert [(h["executor"], h["phase"]) for h in hints] == want


def test_min_samples_guards_quiet_nodes(pkg):
    st = pkg.health.TimeSeriesStore(window=1000, clock=_Clock())
    st.append(0, _snap(pkg, hists={"train.step_sec": [0.01] * 20}))
    st.append(1, _snap(pkg, hists={"train.step_sec": [9.0]}))
    det = pkg.health.StragglerDetector(st, window=1000, min_samples=3)
    assert det.diagnose() == []


def test_plane_scrape_fires_and_skips_stale_snapshots(pkg):
    reg = pkg.reg.MetricsRegistry(enabled=True)
    reg.histogram("train.step_sec").observe(1.0)
    plane = pkg.health.HealthPlane.local(
        registry=reg, interval=60,
        slo=[{"name": "r", "metric": "train.step_sec", "stat": "p99",
              "op": "<", "threshold": 1e-6, "window": 300}])
    assert [a.rule for a in plane.scrape_once()] == ["r"]
    assert plane.status()["alerts"][0]["rule"] == "r"
    calls = {"n": 0}

    def metrics_fn():
        calls["n"] += 1
        return {0: {"metrics": _snap(pkg, counters={"c": calls["n"]}),
                    "metrics_age": 0.0},
                1: {"metrics": _snap(pkg, counters={"c": 100}),
                    "metrics_age": 999.0},  # stopped publishing
                2: {"heartbeat_age": 0.1}}  # no metrics at all

    plane = pkg.health.HealthPlane(metrics_fn, interval=1.0)
    plane.scrape_once()
    plane.scrape_once()
    assert plane.store.executors() == [0]


def test_straggler_hook_fires_once_and_survives_a_raising_hook(pkg):
    fleet = {0: {"step": 0.01, "feed": 0.001},
             1: {"step": 0.01, "feed": 0.2},
             2: {"step": 0.01, "feed": 0.001}}
    for hook in ("list", "boom"):
        hooked = []

        def boom(hint):
            raise RuntimeError("hook down")

        st = _fleet_store(pkg, _Clock(), fleet)
        plane = pkg.health.HealthPlane(
            lambda: {}, interval=60,
            on_straggler=hooked.append if hook == "list" else boom)
        plane.store = st
        plane.detector = pkg.health.StragglerDetector(st, window=1000)
        plane._diagnose()
        plane._diagnose()  # the same verdict: the hook does not re-fire
        assert plane.hints[1]["phase"] == "feed"
        assert plane.status()["stragglers"][0]["executor"] == 1
        if hook == "list":
            assert [h["executor"] for h in hooked] == [1]


def test_plane_survives_raising_sources(pkg):
    plane = pkg.health.HealthPlane(lambda: 1 / 0, interval=60)
    assert plane.scrape_once() == []
    reg = pkg.reg.MetricsRegistry(enabled=True)
    plane = pkg.health.HealthPlane.local(
        registry=reg, interval=60,
        slo=[{"name": "r", "metric": "m", "stat": "p99", "op": "<",
              "threshold": 1.0, "window": 30}])

    def boom():
        raise ValueError("bad rule")

    plane.slo.evaluate = boom
    assert plane.scrape_once() == []
    assert plane.store.scrapes >= 1
    plane = pkg.health.HealthPlane(lambda: {}, interval=60,
                                   liveness_fn=lambda: 1 / 0)
    hz = plane.healthz()
    assert hz["healthy"] is False and "liveness" in hz["liveness"]["dead"]


def test_background_loop_scrapes(pkg):
    reg = pkg.reg.MetricsRegistry(enabled=True)
    reg.counter("c").inc()
    plane = pkg.health.HealthPlane.local(registry=reg, interval=0.05)
    plane.start()
    try:
        deadline = time.monotonic() + 5
        while plane.store.scrapes < 3:
            assert time.monotonic() < deadline
            time.sleep(0.02)
    finally:
        plane.stop()


def test_merged_snapshot_local_and_fleet(pkg):
    reg = pkg.reg.MetricsRegistry(enabled=True)
    reg.counter("c").inc(10)
    reg.histogram("h").observe(0.25)
    plane = pkg.health.HealthPlane.local(registry=reg, interval=60)
    plane.scrape_once()
    plane.scrape_once()  # scraping again doubles nothing
    merged = plane.merged_snapshot()
    assert merged["counters"]["c"] == 10
    assert merged["histograms"]["h"]["count"] == 1
    # the last scrape read the registry before it counted itself
    assert merged["counters"]["health.scrapes"] == 1
    reg = pkg.reg.MetricsRegistry(enabled=True)
    plane = pkg.health.HealthPlane(
        lambda: {0: {"metrics": _snap(pkg, counters={"node.c": 3}),
                     "metrics_age": 0.0}}, interval=60, registry=reg)
    plane.scrape_once()
    merged = plane.merged_snapshot()
    assert merged["counters"]["node.c"] == 3
    assert merged["counters"]["health.scrapes"] == 1


def test_straggler_hint_expires_and_refires(pkg):
    hooked, cleared = [], []

    class _FakeDetector(object):
        out = []

        def diagnose(self):
            return list(self.out)

    hint = {"executor": 1, "phase": "feed", "step_sec": 0.2,
            "fleet_median_sec": 0.01, "excess_sec": 0.19,
            "phase_excess_sec": 0.19, "window": 60}
    reg = pkg.reg.MetricsRegistry(enabled=True)
    plane = pkg.health.HealthPlane(
        lambda: {}, interval=60, on_straggler=hooked.append,
        on_straggler_cleared=cleared.append, straggler_clear_rounds=2,
        registry=reg)
    det = plane.detector = _FakeDetector()
    det.out = [hint]
    plane._diagnose()
    assert len(hooked) == 1 and 1 in plane.hints
    det.out = []
    plane._diagnose()
    assert 1 in plane.hints  # one clean round: still shown
    plane._diagnose()
    assert plane.hints == {} and cleared == [1]
    assert reg.counter("health.stragglers_cleared").value == 1
    det.out = [hint]  # a recurrence fires the hook again
    plane._diagnose()
    assert len(hooked) == 2

    def boom(eid):
        raise RuntimeError("node gone")

    plane = pkg.health.HealthPlane(lambda: {}, interval=60,
                                   on_straggler_cleared=boom,
                                   straggler_clear_rounds=1)
    det = plane.detector = _FakeDetector()
    det.out = [hint]
    plane._diagnose()
    det.out = []
    plane._diagnose()  # the failing hook is survived
    assert plane.hints == {}


def test_cluster_monitor_notes_and_clears_stragglers():
    from tensorflowonspark_tpu.cluster.cluster import ClusterMonitor as JMon
    from tensorflowonspark_tpu_torch.cluster.cluster import ClusterMonitor

    class _Server(object):
        liveness = types.SimpleNamespace(interval=1.0)

    for cls in (ClusterMonitor, JMon):
        mon = cls(_Server(), [])
        mon.note_straggler({"executor": 2, "phase": "feed",
                            "excess_sec": 0.5})
        assert mon.health_hints[2]["phase"] == "feed"
        mon.clear_straggler(2)
        mon.clear_straggler(2)  # idempotent
        assert mon.health_hints == {}


# ----------------------------------------------------------------------
# the profile request, end to end without a cluster
# ----------------------------------------------------------------------


def test_profile_request_starts_a_capture_and_acks(tmp_path):
    from tensorflowonspark_tpu_torch import tensorboard
    from tensorflowonspark_tpu_torch.cluster import cluster, manager
    from tensorflowonspark_tpu_torch.telemetry.aggregate import NodePublisher

    key = os.urandom(16)
    mgr, addr = manager.start(key, ["input", "error"], mode="local")
    try:
        node = {"executor_id": 0, "job_name": "worker", "task_index": 0,
                "addr": list(addr), "authkey": key.hex()}
        handle = cluster.TPUCluster(
            None, {"id": "t", "elastic": False}, [node], None, None,
            cluster.InputMode.SPARK, [])
        reg = treg.MetricsRegistry(enabled=True)
        pub = NodePublisher(manager.connect(addr, key), interval=60,
                            registry=reg)
        assert pub.check_profile_request() is None  # nothing asked yet
        hint = {"executor": 0, "phase": "feed", "excess_sec": 0.3}
        req = handle._request_profile(0, steps=2, log_dir=str(tmp_path),
                                      hint=hint)
        assert req["seq"] == 1
        # handed to the training thread: it starts at a step boundary
        assert pub.check_profile_request() is None
        assert tensorboard._ACTIVE_SESSION is None
        tensorboard.profile_step(1)
        assert tensorboard._ACTIVE_SESSION is not None
        state = pub.check_profile_request()
        sub = os.path.join(str(tmp_path), str(os.getpid()))
        assert state == {"seq": 1, "started": True, "log_dir": sub,
                         "pid": os.getpid()}
        kv = manager.connect(addr, key)
        assert kv.get("profile_state")._getvalue() == state
        assert kv.get("health_hint")._getvalue() == hint
        assert pub.check_profile_request() is None  # each request once
        # a second request while the capture lives: acknowledged, not run
        handle._request_profile(0, steps=2, log_dir=str(tmp_path))
        assert pub.check_profile_request()["started"] is False
        tensorboard.profile_step(2)  # the live session's steps run out
        assert tensorboard._ACTIVE_SESSION is None
        files = os.listdir(sub)
        assert len(files) == 1 and files[0].endswith(".pt.trace.json")
        assert reg.counter("health.profile_captures").value == 2
        # a restarted publisher does not serve an acknowledged request
        fresh = NodePublisher(manager.connect(addr, key), interval=60,
                              registry=reg)
        assert fresh.check_profile_request() is None
        handle._clear_health_hint(0)
        assert kv.get("health_hint")._getvalue() is None
        assert handle._request_profile(5) is None  # no such executor
    finally:
        mgr.shutdown()


def test_publisher_failure_is_logged_once_and_never_raises(caplog):
    from tensorflowonspark_tpu_torch.telemetry.aggregate import NodePublisher

    class _Down(object):
        def set(self, key, value):
            raise EOFError("manager gone")

        def get(self, key):
            raise EOFError("manager gone")

    pub = NodePublisher(_Down(), interval=60,
                        registry=treg.MetricsRegistry(enabled=True))
    with caplog.at_level("WARNING"):
        assert pub.publish_once() is False
        assert pub.publish_once() is False
        assert pub.check_profile_request() is None
    assert sum("publication" in r.message for r in caplog.records) == 1


# ----------------------------------------------------------------------
# the training loop feeds the detector
# ----------------------------------------------------------------------


def test_train_on_feed_populates_phase_histograms():
    import torch

    from tensorflowonspark_tpu_torch import optim
    from tensorflowonspark_tpu_torch.parallel import dp

    reg = ttel.get_registry()
    base = reg.snapshot()

    def loss_fn(params, batch, rng):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()

    trainer = dp.SyncTrainer(loss_fn, optim.sgd(0.01))
    state = trainer.create_state({"w": torch.zeros(3, requires_grad=True)})

    class _Feed(object):
        def __init__(self, batches):
            self.batches = list(batches)

        def next_batch(self, n):
            return self.batches.pop(0) if self.batches else []

        def should_stop(self):
            return not self.batches

    rng = np.random.RandomState(0)
    rows = [(rng.randn(3).astype(np.float32), np.float32(rng.randn()))
            for _ in range(8)]
    ttel.get_tracer().clear()
    trainer.train_on_feed(state, _Feed([list(rows)] * 6), 8, max_steps=5,
                          log_every=0, terminate_on_max_steps=False,
                          steps_per_execution=2)
    delta = ttel.snapshot_delta(reg.snapshot(), base)
    assert delta["counters"]["train.steps"] == 5
    for name in PHASES:
        assert delta["histograms"][name]["count"] == 3, name  # 2 + 2 + 1
    spans = {sp["name"] for sp in ttel.get_tracer().spans(trace="step0")}
    assert spans == {"feed_wait", "h2d", "dispatch"}
    plane = thealth.HealthPlane.local(interval=60)
    plane.scrape_once()
    assert plane.store.hist_over("train.dispatch_sec")["count"] >= 3
