"""The port's fleet telemetry over the heartbeats (``cluster/reservation``,
``cluster/supervisor``, ``telemetry/aggregate``, ``telemetry/journal``)
against the JAX package's, on the CPU.

- ``MetricsStore``, ``ClockSync`` (the min-rtt pick), ``EventStore``
  (repeats dropped by (pid, seq), the bound, time order),
  ``estimate_offset``, the journal's shipping cursor and the
  supervisor's folding of its restart count, generation and straggler
  flag into the shipped snapshot equal the reference's on the same
  frames (exactly: plain data in, plain data out).
- The beats over real sockets: events and a clock sample ship (the
  sample on the second beat), events of a failed beat ride the next one,
  a raising ``metrics_fn`` leaves a bare beat, a NaN gauge or a numpy
  scalar never reaches the JSON wire, the driver's own journal feeds the
  fleet store.
- A ``LocalEngine(2)`` fed cluster on the CPU at a tiny width (the tiny
  Transformer of ``test_torch_feed.py``: 2 layers, width 64) with the
  health plane on: ``train.steps``, ``feed.wire_rows`` and
  ``feed.wire_records`` of ``cluster.metrics()["fleet"]`` equal those of
  the same rows through the JAX package's cluster; the journal has clock
  samples of both executors; ``collect_dumps`` finds the flight
  recorder's bundle after a ``watchdog_fire`` mark.
- Marked ``slow``, as the reference's: the two-executor straggler end to
  end (``ChaosPlan.slow_executor``; ``tests/test_chaos.py``).
"""

import copy
import json
import math
import os
import time
import urllib.request

import numpy as np
import pytest

import fleet_workers
from tensorflowonspark_tpu import telemetry as jtel
from tensorflowonspark_tpu.cluster import reservation as jres
from tensorflowonspark_tpu.telemetry.journal import EventJournal as JJournal
from tensorflowonspark_tpu_torch import telemetry as ttel
from tensorflowonspark_tpu_torch.cluster import reservation as tres
from tensorflowonspark_tpu_torch.telemetry.journal import Event
from tensorflowonspark_tpu_torch.telemetry.journal import EventJournal

BOUNDS = dict(reservation_timeout=60)
#: heartbeat intervals of the fed-cluster runs: the reference's
#: supervisor reads its node's kv on the heartbeat thread, so its beats
#: wait on the manager, which a loaded host (XLA compiling in the compute
#: processes, six test workers) slows past a 3 s deadline
HEARTBEAT = {"torch": 1.0, "jax": 4.0}


# ----------------------------------------------------------------------
# the stores, on the same frames
# ----------------------------------------------------------------------


def _event_frames():
    """Heartbeat event batches: two processes of executor 3 (a restart
    gave it a new pid), a repeated batch, and out-of-order times."""
    a = [Event("restart", seq=i, pid=10, ts=100.0 + i,
               attrs={"restart": i}).to_dict() for i in (1, 2, 3)]
    b = [Event("watchdog_fire", seq=1, pid=11, ts=99.5,
               severity="page").to_dict(),
         Event("tick", seq=2, pid=11, ts=104.0).to_dict()]
    c = [dict(Event("mark", seq=5, pid=12, ts=101.5).to_dict(),
              executor=7)]
    return [(3, a), (3, a[1:]), (3, b), (0, c), (0, []), (0, ["junk"]),
            (3, [Event("late", seq=1, pid=10, ts=90.0).to_dict()])]


@pytest.mark.parametrize("max_events", [None, 4])
def test_event_store_equals_the_reference(max_events):
    got, want = tres.EventStore(max_events), jres.EventStore(max_events)
    for eid, evs in _event_frames():
        assert got.extend(eid, json.loads(json.dumps(evs))) \
            == want.extend(eid, json.loads(json.dumps(evs)))
    assert got.snapshot() == want.snapshot()
    assert got.snapshot(limit=2) == want.snapshot(limit=2)
    out = got.snapshot()
    assert [e["ts"] for e in out] == sorted(e["ts"] for e in out)
    if max_events is None:
        # the repeat and the stale seq are dropped; the new pid is not
        assert len(out) == 6
        assert {e["executor"] for e in out} == {3, 7}


def test_clock_sync_and_metrics_store_equal_the_reference():
    rng = np.random.default_rng(0)
    samples = [(int(rng.integers(0, 3)), float(rng.normal(0, 0.01)),
                float(rng.exponential(0.001))) for _ in range(40)]
    samples += [(1, "x", 0.1), (1, 0.2, -1.0), (2, None, 0.0)]
    got, want = tres.ClockSync(), jres.ClockSync()
    for eid, off, rtt in samples:
        got.update(eid, off, rtt)
        want.update(eid, off, rtt)
    assert got.snapshot() == want.snapshot()
    for eid in range(4):
        assert got.offset(eid) == want.offset(eid)
    # the pick: the smallest rtt of the last CLOCK_WINDOW samples
    last = [s for s in samples[:40] if s[0] == 0][-tres.ClockSync
                                                   .CLOCK_WINDOW:]
    assert got.offset(0) == min(last, key=lambda s: s[2])[1]
    for t0, server, t1 in [(1.0, 5.25, 1.5), (10.0, 9.0, 10.002)]:
        assert tres.estimate_offset(t0, server, t1) \
            == jres.estimate_offset(t0, server, t1)
    ms_t, ms_j = tres.MetricsStore(), jres.MetricsStore()
    for ms in (ms_t, ms_j):
        ms.update(0, {"counters": {"a": 1}})
        ms.update("1", {"counters": {"b": 2}})
        ms.update(2, "not a snapshot")
        ms.update(0, {"counters": {"a": 3}})
        ms.forget(1)
    drop_age = [{k: {"metrics": v["metrics"]} for k, v in m.snapshot()
                 .items()} for m in (ms_t, ms_j)]
    assert drop_age[0] == drop_age[1] == {"0": {"metrics":
                                                {"counters": {"a": 3}}}}
    assert 0 <= ms_t.snapshot()["0"]["age"] < 5


def test_journal_shipping_cursor_equals_the_reference():
    got, want = [], []
    for cls, out in ((EventJournal, got), (JJournal, want)):
        j = cls(enabled=True, max_events=8)
        for i in range(5):
            j.emit("e%d" % i, severity="warn" if i % 2 else "info")
        out.append([e.kind for e in j.drain_unshipped(limit=2)])
        out.append([e.kind for e in j.drain_unshipped()])
        out.append([e.kind for e in j.drain_unshipped()])
        j.emit("after")
        out.append([e.kind for e in j.events_since(4)])
        out.append([e.kind for e in j.drain_unshipped()])
        j.set_identity(9)
        out.append(j.emit("who").executor)
        j.clear()
        out.append([e.kind for e in j.drain_unshipped()])
        j.emit("fresh")
        out.append([e.kind for e in j.drain_unshipped()])
        out.append(j.count("fresh"))
    assert got == want
    assert got[:3] == [["e0", "e1"], ["e2", "e3", "e4"], []]


class _FakeMgr(object):
    """A node manager's kv, answering as the manager's proxies do."""

    def __init__(self):
        self.kv = {}

    def set(self, key, value):
        self.kv[key] = value

    def get(self, key):
        # a proxy's value is a copy, as the manager pickles it across
        value = copy.deepcopy(self.kv.get(key))
        return type("Proxy", (), {"_getvalue": lambda _s: value})()


def _supervisor(cls, kv):
    sup = object.__new__(cls)
    sup.ctx = type("Ctx", (), {"executor_id": 4})()
    sup.mgr = _FakeMgr()
    sup.mgr.kv.update(kv)
    sup.restarts, sup.generation = 2, 3
    sup._hint_logged = False
    sup._journal_cursor = (0, 0)
    return sup


def test_supervisor_beat_payload_equals_the_reference():
    from tensorflowonspark_tpu.cluster.supervisor import Supervisor as JSup
    from tensorflowonspark_tpu_torch.cluster.supervisor import Supervisor

    snap = {"counters": {"train.steps": 12}, "gauges": {"g": 1.5},
            "histograms": {}}
    events = {"pid": 10, "events": [
        Event("restart", seq=1, pid=10).to_dict(),
        Event("restart", seq=2, pid=10).to_dict()]}
    respawned = {"pid": 11, "events": [
        Event("restart", seq=1, pid=11).to_dict()]}
    hint = {"executor": 4, "phase": "feed"}
    runs = []
    for cls, tel in ((Supervisor, ttel), (JSup, jtel)):
        tel.get_journal().drain_unshipped(limit=10 ** 6)
        sup = _supervisor(cls, {"metrics": json.loads(json.dumps(snap)),
                                "journal_events": events})
        out = [sup._node_metrics()]
        sup.mgr.kv["health_hint"] = hint
        out.append(sup._node_metrics())
        sup.mgr.kv["health_hint"] = None
        out.append(sup._node_metrics())
        out.append(sup._node_metrics())
        out.append([e for e in sup._node_events() or [] if e["pid"] == 10])
        out.append([e for e in sup._node_events() or [] if e["pid"] == 10])
        sup.mgr.kv["journal_events"] = respawned
        out.append([e for e in sup._node_events() or [] if e["pid"] == 11])
        sup.mgr.kv.clear()  # a compute process too dead to publish
        out.append(sup._node_metrics())
        runs.append(out)
    assert runs[0] == runs[1]
    got = runs[0]
    assert got[0]["counters"] == {"train.steps": 12, "cluster.restarts": 2}
    assert got[0]["gauges"] == {"g": 1.5, "cluster.generation": 3}
    assert [g["gauges"].get("health.straggler") for g in got[:4]] \
        == [None, 1.0, 0.0, None]
    assert len(got[4]) == 2 and all(e["executor"] == 4 for e in got[4])
    assert got[5] == [] and len(got[6]) == 1


def test_ring_counters_equal_the_reference():
    """The ring's push and pop counters count what the reference's count
    on the same records (``push``, ``pushv``, a zero-length record)."""
    from tensorflowonspark_tpu.data import shm_ring as jring
    from tensorflowonspark_tpu_torch.data import shm_ring as tring

    got = {}
    for name, ring_mod, tel in (("torch", tring, ttel), ("jax", jring, jtel)):
        if not ring_mod.available():
            pytest.skip("no native shm ring (no compiler)")
        base = tel.get_registry().snapshot()
        seg = "tfos_test_fleet_{0}_{1}".format(name, os.getpid())
        producer = ring_mod.ShmRing(seg, 1 << 16, create=True)
        consumer = ring_mod.ShmRing(seg)
        try:
            producer.push(b"x" * 100)
            producer.pushv([b"head", np.arange(8, dtype=np.int32)])
            producer.push(b"")
            popped = [consumer.pop(timeout=1.0) for _ in range(3)]
        finally:
            consumer.close()
            producer.close()
        assert [len(r) for r in popped] == [100, 36, 0]
        delta = tel.snapshot_delta(tel.get_registry().snapshot(), base)
        got[name] = {k: v for k, v in delta["counters"].items()
                     if k.startswith("ring.")}
    assert got["torch"] == got["jax"] == {
        "ring.push_records": 3, "ring.push_bytes": 136,
        "ring.pop_records": 3, "ring.pop_bytes": 136}


# ----------------------------------------------------------------------
# the beats, over real sockets
# ----------------------------------------------------------------------


def test_heartbeat_ships_events_and_a_clock_sample():
    server = tres.Server(1)
    addr = server.start()
    try:
        j = EventJournal(executor=0, enabled=True)
        j.emit("restart", severity="warn", restart=1)
        j.emit("leader_elected", leader=0)
        hb = tres.Heartbeater(
            addr, 0, interval=0.05,
            events_fn=lambda: [e.to_dict() for e in j.drain_unshipped()])
        hb.beat_once()  # ships the events, takes a clock sample
        assert tres.Client(addr).get_journal()[1] == {}
        hb.beat_once()  # reports the sample
        events, clocks = tres.Client(addr).get_journal()
        assert {"restart", "leader_elected"} <= {e["kind"] for e in events}
        assert all(e["executor"] == 0 for e in events)
        assert abs(clocks["0"]["offset"]) < 1.0
        assert clocks["0"]["rtt"] >= 0.0
        hb.beat_once()  # nothing is stored twice
        assert len(tres.Client(addr).get_journal()[0]) == len(events)
        hb.stop(farewell=False)
    finally:
        server.stop()


def test_events_of_a_failed_beat_ride_the_next_one():
    server = tres.Server(1)
    addr = server.start()
    try:
        shipped = [False]

        def events_fn():
            if shipped[0]:
                return None
            shipped[0] = True
            return [Event("restart", seq=7, pid=42).to_dict()]

        hb = tres.Heartbeater(("127.0.0.1", 1), 0, interval=0.05,
                              events_fn=events_fn)
        with pytest.raises(Exception):
            hb.beat_once()
        assert [e["seq"] for e in hb._event_backlog] == [7]
        hb.server_addr = tuple(addr)
        hb._client = None
        hb.beat_once()
        assert hb._event_backlog == []
        events, _ = tres.Client(addr).get_journal()
        assert [(e["kind"], e["seq"]) for e in events] == [("restart", 7)]
        hb.stop(farewell=False)
    finally:
        server.stop()


def test_beats_stay_json_and_live_whatever_the_payload():
    server = tres.Server(1)
    addr = server.start()
    try:
        hb = tres.Heartbeater(addr, 3, metrics_fn=lambda: 1 / 0)
        hb.beat_once()  # a raising metrics_fn: a bare beat
        assert server.liveness.last_seen(3) is not None
        assert server.metrics.snapshot() == {}
        reg = ttel.MetricsRegistry(enabled=True)
        reg.counter("c").inc(np.int64(4))
        reg.gauge("nan").set(float("nan"))
        reg.gauge("inf").set(float("inf"))
        reg.gauge("ok").set(np.float32(0.5))
        hb.metrics_fn = reg.snapshot
        hb.events_fn = lambda: [dict(
            Event("x", seq=1, pid=5).to_dict(),
            attrs={"v": np.float32(1.5), "bad": float("nan"),
                   "pair": (1, 2)})]
        hb.beat_once()
        snap = server.metrics.snapshot()["3"]["metrics"]
        assert snap["counters"] == {"c": 4}
        assert snap["gauges"] == {"ok": 0.5}
        (ev,) = server.events.snapshot()
        assert ev["attrs"] == {"v": 1.5, "bad": None, "pair": [1, 2]}
        json.dumps(snap, allow_nan=False)
        hb.stop()
        assert server.liveness.last_seen(3) is None  # farewell
    finally:
        server.stop()


def test_driver_journal_feeds_the_fleet_store():
    server = tres.Server(1)
    server.start()
    try:
        server.attach_local_journal()
        server.attach_local_journal()  # idempotent
        ttel.get_tracer().mark("executor_dead", severity="page",
                               executor_id=2, score=np.float64(0.5))
        evs = [e for e in server.events.snapshot()
               if e["kind"] == "executor_dead"]
        assert len(evs) == 1 and evs[0]["executor"] == -1
        assert evs[0]["attrs"] == {"executor_id": 2, "score": 0.5}
    finally:
        server.stop()
    n = len(server.events.snapshot())
    ttel.get_tracer().mark("executor_dead", severity="page")
    assert len(server.events.snapshot()) == n  # detached at stop


def test_monitor_metrics_carry_the_clock_and_liveness():
    from tensorflowonspark_tpu_torch.cluster.cluster import ClusterMonitor

    server = tres.Server(1)
    addr = server.start()
    try:
        hb = tres.Heartbeater(addr, 0, interval=0.05,
                              metrics_fn=lambda: {"counters": {"a": 1}})
        hb.beat_once()
        hb.beat_once()
        rec = ClusterMonitor(server, []).metrics()[0]
        assert abs(rec["clock_offset"]) < 1.0 and rec["clock_rtt"] >= 0
        assert rec["metrics"]["counters"] == {"a": 1}
        assert rec["compute_alive"] is True and rec["generation"] == 0
        executors, liveness = tres.Client(addr).get_metrics()
        assert executors["0"]["metrics"]["counters"] == {"a": 1}
        assert set(liveness) == {"0"}
        hb.stop(farewell=False)
    finally:
        server.stop()


# ----------------------------------------------------------------------
# a fed cluster of two executors, in both packages
# ----------------------------------------------------------------------


def _cluster_run(pkg, tmp_path, rows_per_part=8, parts=4):
    from test_torch_feed import TINY, tiny_tree, token_rows

    if pkg == "torch":
        from tensorflowonspark_tpu_torch.cluster import cluster
        from tensorflowonspark_tpu_torch.engine import LocalEngine
        fn = fleet_workers.port_train_fn
    else:
        from tensorflowonspark_tpu.cluster import cluster
        from tensorflowonspark_tpu.engine import LocalEngine
        fn = fleet_workers.jax_train_fn
    out = tmp_path / pkg
    out.mkdir()
    rows = token_rows(rows_per_part * parts)
    data = [rows[i::parts] for i in range(parts)]
    args = {"tree": tiny_tree(), "config": dict(TINY, attention_impl="dot"),
            "batch": 2, "out": str(out), "marks": [1]}
    env = {"TFOS_TELEMETRY_PUBLISH_INTERVAL": "0.2",
           "TFOS_BLACKBOX_DIR": str(out), "TFOS_BLACKBOX_MIN_INTERVAL": "0"}
    engine = LocalEngine(2, env=env, deterministic=True)
    want_steps = rows_per_part * parts // 2
    try:
        c = cluster.run(engine, fn, args, num_executors=2,
                        input_mode=cluster.InputMode.SPARK,
                        heartbeat_interval=HEARTBEAT[pkg], **BOUNDS)
        plane = c.start_health_plane(port=0, interval=0.25,
                                     straggler=False) \
            if pkg == "torch" else None
        c.train(data, feed_timeout=60)
        deadline = time.monotonic() + 60
        while True:
            view = c.metrics()
            journal = c.journal()
            counters = view["fleet"]["counters"]
            if (counters.get("train.steps") == want_steps
                    and set(journal["clocks"]) == {"0", "1"}):
                break
            assert time.monotonic() < deadline, (counters, journal["clocks"])
            time.sleep(0.2)
        res = {"fleet": {k: counters[k] for k in (
            "train.steps", "feed.wire_rows", "feed.wire_records")},
            "per_executor": {e: {k: r["metrics"]["counters"].get(k)
                                 for k in ("train.steps", "feed.wire_rows")}
                             for e, r in view["executors"].items()},
            "clocks": journal["clocks"], "events": journal["events"],
            "dumps": c.collect_dumps(dest=str(tmp_path / (pkg + "_dumps"))),
            "executors": view["executors"]}
        if plane is not None:
            with urllib.request.urlopen(plane.exposition.url + "/metrics",
                                        timeout=10) as r:
                res["om"] = ttel.parse_openmetrics(r.read().decode())
            res["healthz"] = plane.healthz()
        c.shutdown(timeout=60)
    finally:
        engine.stop()
    res["results"] = {e: json.load(open(out / ("%d.json" % e)))
                      for e in (0, 1)}
    return res


def test_two_executor_fleet_counters_equal_the_reference(tmp_path):
    got = _cluster_run("torch", tmp_path)
    want = _cluster_run("jax", tmp_path)
    assert got["fleet"] == want["fleet"] == {
        "train.steps": 16, "feed.wire_rows": 32, "feed.wire_records": 4}
    assert got["per_executor"] == want["per_executor"] == {
        0: {"train.steps": 8, "feed.wire_rows": 16},
        1: {"train.steps": 8, "feed.wire_rows": 16}}
    # the fleet view adds up the executors' own feed accounting
    assert sum(r["wire"]["rows"] for r in got["results"].values()) == 32
    assert sum(r["steps"] for r in got["results"].values()) == 16
    # clock samples of both executors, on one host
    for eid in ("0", "1"):
        assert abs(got["clocks"][eid]["offset"]) < 1.0
        assert got["clocks"][eid]["rtt"] > 0
    # the watchdog_fire of executor 1's compute process: journaled with
    # its pid, and dumped by its flight recorder into the kv's index
    fire = [e for e in got["events"] if e["kind"] == "watchdog_fire"]
    assert len(fire) == 1 and fire[0]["executor"] == 1
    assert fire[0]["pid"] == got["results"][1]["pid"]
    (rec,) = got["dumps"][1]
    assert rec["reason"] == "watchdog_fire" and rec["executor"] == 1
    assert 0 not in got["dumps"]
    copied = os.listdir(tmp_path / "torch_dumps")
    assert copied == [os.path.basename(rec["path"])]
    with open(rec["path"]) as f:
        assert json.load(f)["trigger"]["kind"] == "watchdog_fire"
    # the plane's /metrics agrees with the fleet view
    om = got["om"]
    assert om["train_steps"]["samples"][0][2] >= 16
    assert om["feed_wire_rows"]["samples"][0][2] >= 32
    assert got["healthz"]["healthy"] is True
    for rec in got["executors"].values():
        assert rec["metrics_age"] < 3 * HEARTBEAT["torch"] \
            and rec["ledger"] == {
            "committed": 0, "pending": 0}
        assert rec["metrics"]["counters"]["cluster.restarts"] == 0


# ----------------------------------------------------------------------
# the straggler, end to end (slow, as the reference's)
# ----------------------------------------------------------------------


@pytest.mark.slow
def test_straggler_flagged_attributed_and_profiled(tmp_path):
    from tensorflowonspark_tpu_torch.cluster import cluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.testing import chaos

    plan = chaos.ChaosPlan().slow_executor(1, 0.08)
    env = plan.env(plan.save(tmp_path / "plan.json"))
    env["TFOS_TELEMETRY_PUBLISH_INTERVAL"] = "0.2"
    prof_dir = str(tmp_path / "prof")
    out = tmp_path / "out"
    out.mkdir()
    engine = LocalEngine(2, env=env, deterministic=True)
    try:
        c = cluster.run(engine, fleet_workers.port_straggler_fn,
                        {"out": str(out)}, num_executors=2,
                        input_mode=cluster.InputMode.SPARK,
                        heartbeat_interval=0.5, **BOUNDS)
        window = 20.0
        plane = c.start_health_plane(
            interval=0.5, profile_steps=3, profile_dir=prof_dir,
            straggler_opts={"window": window, "min_samples": 5,
                            "ratio": 2.0})
        t_start = time.monotonic()
        parts = [[float(i) for i in range(120)] for _ in range(8)]
        c.train(parts, feed_timeout=120)
        deadline = time.monotonic() + 20
        state1 = None
        node = {n["executor_id"]: n for n in c.cluster_info}
        while time.monotonic() < deadline:
            if plane.hints and state1 is not None:
                break
            v = c._connect(node[1]).get("profile_state")._getvalue()
            state1 = v if isinstance(v, dict) else None
            time.sleep(0.3)
        assert set(plane.hints) == {1}, plane.hints
        assert plane.hints[1]["phase"] == "feed"
        assert c.monitor.health_hints[1]["phase"] == "feed"
        flagged = [e for e in ttel.get_journal().events(
            kind="straggler_flagged") if e.ts >= time.time() - 300]
        assert flagged and flagged[-1].attrs["executor"] == 1
        assert time.monotonic() - t_start <= 120
        # the capture ran on the flagged node only
        assert state1 is not None and state1["started"] is True
        assert c._connect(node[0]).get("profile_state")._getvalue() is None
        # the flag rides executor 1's beats
        rec = c.metrics()["executors"][1]
        assert rec["metrics"]["gauges"].get("health.straggler") == 1.0
        c.shutdown(grace_secs=1, timeout=60)
    finally:
        engine.stop()
    files = os.listdir(state1["log_dir"])
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert not math.isnan(plane.hints[1]["excess_sec"])
