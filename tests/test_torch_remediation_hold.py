"""The port's elastic holds on its ``LocalEngine`` and the CPU: the
remediation engine's cluster actuators end to end.

- Hold and release mid-training (the reference's
  ``tests/test_remediation.py`` ``TestElasticHoldE2E``, keyed on steps
  instead of wall time): ``cluster.run(LocalEngine(2), elastic=True)`` of
  a torch linear regression with ``Checkpointer`` auto-resume; the driver
  holds executor 1 once it trained a few steps and releases it once the
  survivor trained a few more at reduced width.  Gates: both verbs
  delivered, ``executor_held`` / ``executor_released`` in the fleet
  journal, at least two generation steps seen by the monitor, no restart
  charged, both executors at generation 2 or more, every partition
  committed, each executor's losses finite and falling, the survivor
  trained during the hold and executor 1 after its release, and the held
  node never marked ``executor_dead``.
- The straggler loop: ``start_health_plane`` + ``start_remediation(
  straggler={"sustain": 1})`` + ``ChaosPlan().slow_executor(1, ...)``: an
  executed ``elastic_shrink`` of executor 1, then an executed
  ``elastic_grow`` behind a ``CleanRoundsSensor`` release gate.
- The feeder: a partition fed on a held node goes to its live peer; a
  hold that lands during the drain wait fails the feed task fast.

The JAX package's counterparts are slow-marked there; every run here is
bounded (``reservation_timeout``, ``feed_timeout``, ``shutdown(timeout=)``
of 60 s) and the file takes well under 90 s.
"""

import json
import math
import os
import threading
import time
import uuid

import pytest

import torch_remediation_workers as workers
from tensorflowonspark_tpu_torch import remediation
from tensorflowonspark_tpu_torch.cluster import cluster, manager, node
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.telemetry import health
from tensorflowonspark_tpu_torch.testing import chaos

BOUNDS = dict(reservation_timeout=60)
TIMEOUT = 60
#: the hold lands once executor 1 trained this many steps; the release
#: once the survivor trained this many at the reduced width
HOLD_AT, RELEASE_AFTER = 4, 8
#: three epochs at a step of 0.2 leave executor 1 enough steps after its
#: release to converge, however late a loaded host lets the release land
EPOCHS, PARTS, ROWS, LR = 3, 4, 512, 0.2


def _kv(c, eid, key):
    n = next(n for n in c.cluster_info if n["executor_id"] == eid)
    val = c._connect(n).get(key)
    return val._getvalue() if hasattr(val, "_getvalue") else val


def _await(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError("timed out waiting for " + what)


@pytest.fixture(scope="module")
def hold_run(tmp_path_factory):
    """One hold-and-release run; what the gates read."""
    tmp = tmp_path_factory.mktemp("hold")
    log = tmp / "log"
    log.mkdir()
    args = {"ckpt_dir": str(tmp / "ckpt"), "log": str(log), "ckpt_every": 4,
            "lr": LR}
    engine = LocalEngine(2, deterministic=True)
    verbs = {}
    try:
        c = cluster.run(engine, workers.hold_train_fn, args,
                        num_executors=2, input_mode=cluster.InputMode.SPARK,
                        elastic=True, heartbeat_interval=0.5,
                        max_restarts=2, **BOUNDS)

        def progress(eid):
            return _kv(c, eid, "hold_progress") or {}

        def remediate():
            try:
                _await(lambda: progress(1).get("steps", 0) >= HOLD_AT,
                       TIMEOUT, "executor 1's first steps")
                verbs["held"] = c.hold_executor(1, reason="straggler")
                _await(lambda: progress(0).get("generation", 0) >= 1
                       and progress(0).get("steps", 0) >= RELEASE_AFTER,
                       TIMEOUT, "the survivor's steps at reduced width")
                verbs["released"] = c.release_executor(1)
                _await(lambda: progress(1).get("generation", 0) >= 2,
                       TIMEOUT, "executor 1's respawned process")
            except AssertionError as e:
                verbs["error"] = str(e)

        driver = threading.Thread(target=remediate, daemon=True)
        driver.start()
        rows = workers.make_rows(ROWS, seed=0)
        c.train([rows[i::PARTS] for i in range(PARTS)], num_epochs=EPOCHS,
                feed_timeout=TIMEOUT)
        driver.join(timeout=TIMEOUT)
        events = c.journal()["events"]
        c.shutdown(grace_secs=1, timeout=TIMEOUT)
        nodes = sorted(c.cluster_info, key=lambda n: n["executor_id"])
        kv = [manager.connect(tuple(n["addr"]), bytes.fromhex(n["authkey"]))
              for n in nodes]
        res = dict(
            verbs=verbs, events=events,
            restart_events=c.monitor.restart_events,
            restarts=[m.get("restarts")._getvalue() for m in kv],
            generations=[m.get("generation_seen")._getvalue() for m in kv],
            final_loss=[m.get("final_loss")._getvalue() for m in kv],
            ledgers=[m.ledger("snapshot")._getvalue() for m in kv])
    finally:
        engine.stop()
    losses = {}
    for name in sorted(os.listdir(log)):
        eid, gen = name[:-len(".jsonl")].split(".")
        with open(log / name) as f:
            losses[(int(eid[1:]), int(gen[1:]))] = [
                json.loads(ln)["loss"] for ln in f]
    res["losses"] = losses
    return res


def test_hold_and_release_are_delivered_and_journaled(hold_run):
    verbs = hold_run["verbs"]
    assert "error" not in verbs, verbs
    assert verbs["held"] is True and verbs["released"] is True
    kinds = [e["kind"] for e in hold_run["events"]]
    assert "executor_held" in kinds and "executor_released" in kinds
    held = [e for e in hold_run["events"] if e["kind"] == "executor_held"]
    assert {e["executor"] for e in held} == {1}
    assert held[0]["attrs"]["reason"] == "straggler"


def test_hold_charges_no_restart_and_regrows_the_gang(hold_run):
    # shrink and grow each moved both executors to a new generation ...
    assert hold_run["restart_events"] >= 2
    # ... and neither charged a supervisor's restart budget
    assert hold_run["restarts"] == [0, 0]
    assert all(g >= 2 for g in hold_run["generations"]), \
        hold_run["generations"]


def test_every_partition_is_committed(hold_run):
    want = {"e{0}p{1}".format(e, i) for e in range(EPOCHS)
            for i in range(PARTS)}
    committed = set()
    for ledger in hold_run["ledgers"]:
        committed |= {p for p, st in ledger.items() if st == "committed"}
    assert committed == want, sorted(want - committed)


def test_each_executor_trains_down_through_the_hold(hold_run):
    losses = hold_run["losses"]
    for eid in (0, 1):
        seq = [v for (e, _g), vals in sorted(losses.items()) if e == eid
               for v in vals]
        assert seq and all(math.isfinite(v) for v in seq), eid
        assert seq[-1] < seq[0], (eid, seq[0], seq[-1])
    # the survivor trained at the reduced width, and executor 1 after its
    # release, each in a process of a later generation
    assert any(e == 0 and g >= 1 and vals for (e, g), vals in losses.items())
    assert any(e == 1 and g >= 2 and vals for (e, g), vals in losses.items())
    assert all(v < 0.05 for v in hold_run["final_loss"]), \
        hold_run["final_loss"]


def test_a_held_node_is_never_marked_dead(hold_run):
    dead = [e for e in hold_run["events"] if e["kind"] == "executor_dead"
            and e["attrs"].get("executor_id") == 1]
    assert dead == []


# ----------------------------------------------------------------------
# the straggler loop: shrink, then grow behind the clean-rounds gate
# ----------------------------------------------------------------------


def test_straggler_loop_shrinks_then_grows_behind_clean_rounds(tmp_path):
    plan = chaos.ChaosPlan().slow_executor(1, per_batch_sec=0.2, batches=40)
    env = plan.env(plan.save(tmp_path / "plan.json"))
    env["TFOS_TELEMETRY_PUBLISH_INTERVAL"] = "0.2"
    # work stealing: the fast executor takes the partitions the slow one
    # does not, so it never starves at an epoch's end (a starved feed
    # reads as a feed-phase straggler too)
    engine = LocalEngine(2, env=env)
    try:
        c = cluster.run(engine, workers.straggler_fn, {"pace_sec": 0.01},
                        num_executors=2, input_mode=cluster.InputMode.SPARK,
                        elastic=True, heartbeat_interval=0.5,
                        max_restarts=2, **BOUNDS)
        plane = c.start_health_plane(
            interval=0.25, straggler_opts={"window": 2.5, "min_samples": 3,
                                           "ratio": 2.0})
        eng = c.start_remediation(
            interval=0.1,
            guardrails=remediation.Guardrails(
                cooldown_sec=30.0, per_action={"elastic_grow": 0.5},
                budget=5),
            straggler={"sustain": 1, "grow_after": 2}, autoscale=None,
            page=None, slo_rollback=None, cost=None)
        gate = health.CleanRoundsSensor(plane, rounds=2)
        eng.actuators.release_gate = gate
        assert isinstance(eng.actuators, remediation.ClusterActuators)

        def executed(action):
            return [d for d in eng.decisions if d["action"] == action
                    and d["executed"] and d["target"] == {"executor": 1}]

        stop = threading.Event()
        errors = []

        def feed():
            rows = [float(i) for i in range(16)]
            try:
                while not stop.is_set():
                    c.train([rows] * 16, num_epochs=1, feed_timeout=TIMEOUT)
            except Exception as e:  # noqa: BLE001 - the test reads it
                errors.append(repr(e))

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            _await(lambda: executed("elastic_shrink"), TIMEOUT,
                   "an executed elastic_shrink of executor 1")
            # the grow needs no traffic: a held executor's hint clears once
            # its samples leave the detector's window
            stop.set()
            _await(lambda: executed("elastic_grow"), TIMEOUT,
                   "an executed elastic_grow of executor 1")
            # the grow waited for the plane's clean rounds
            assert gate.ready()
        finally:
            eng.stop()
            stop.set()
            # release whatever the engine may still hold, so the feeder's
            # last epoch can finish
            for eid in (0, 1):
                c.release_executor(eid)
            feeder.join(timeout=TIMEOUT)
        shrink, grow = executed("elastic_shrink")[0], executed(
            "elastic_grow")[0]
        assert shrink["policy"] == grow["policy"] == "straggler-elastic"
        assert shrink["evidence"]["hint"]["phase"] == "feed"
        assert shrink["evidence"]["hint"]["executor"] == 1
        assert grow["decision"] > shrink["decision"]
        assert grow["evidence"]["clean_rounds"] >= 2
        assert errors == []
        kinds = [e["kind"] for e in c.journal()["events"]]
        assert "executor_held" in kinds and "executor_released" in kinds
        c.shutdown(grace_secs=1, timeout=TIMEOUT)
        assert c.remediation is None
    finally:
        engine.stop()


# ----------------------------------------------------------------------
# the feeder around a hold
# ----------------------------------------------------------------------


@pytest.fixture()
def two_nodes(tmp_path, monkeypatch):
    """Two node managers (executors 0 and 1) and this process posing as
    executor 1's feed task."""
    from tensorflowonspark_tpu_torch.engine import TFOS_EXECUTOR_WORKDIR
    from tensorflowonspark_tpu_torch.utils.env import write_executor_id

    mgrs, info = [], []
    for eid in (0, 1):
        key = uuid.uuid4().bytes
        mgr, addr = manager.start(key, ["input", "error"], mode="local")
        mgr.set("state", "running")
        mgrs.append(mgr)
        info.append({"executor_id": eid, "job_name": "worker",
                     "task_index": eid, "addr": list(addr),
                     "authkey": key.hex(), "host": "localhost"})
    write_executor_id(1, str(tmp_path))
    monkeypatch.setenv(TFOS_EXECUTOR_WORKDIR, str(tmp_path))
    try:
        yield mgrs, info
    finally:
        for m in mgrs:
            m.shutdown()


def _drain(q, n, out):
    for _ in range(n):
        out.append(q.get())
        q.task_done()


def test_feeder_routes_a_held_nodes_partition_to_its_peer(two_nodes):
    from tensorflowonspark_tpu_torch.cluster.marker import PartitionStart

    mgrs, info = two_nodes
    mgrs[1].set("compute_state", "held")
    # the peer advertises a shm ring: a routed partition must not attach
    # it (the ring has one producer, the peer's own feeder)
    mgrs[0].set("shm_ring", {"name": "tfos_test_no_such_ring"})
    got = []
    consumer = threading.Thread(
        target=_drain, args=(mgrs[0].get_queue("input"), 1, got),
        daemon=True)
    consumer.start()
    rows = [PartitionStart("e0p1")] + [[float(i)] for i in range(5)]
    assert node.feed_partition(info, {"server_addr": ("127.0.0.1", 1)},
                               30, "input", iter(rows)) == []
    consumer.join(timeout=10)
    # the rows went to executor 0's queue, and its ledger holds the
    # partition; the held node's holds nothing
    assert len(got) == 1 and got[0].count == 5
    assert mgrs[0].ledger("snapshot")._getvalue() == {"e0p1": "delivered"}
    assert mgrs[1].ledger("snapshot")._getvalue() == {}
    assert mgrs[1].get_queue("input").qsize() == 0


def test_a_hold_during_the_drain_wait_fails_the_feed_fast(two_nodes):
    mgrs, info = two_nodes
    threading.Timer(0.5, mgrs[1].set, ("compute_state", "held")).start()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="held by remediation"):
        node.feed_partition(info, {"server_addr": ("127.0.0.1", 1)}, 30,
                            "input", iter([[1.0], [2.0]]))
    assert time.monotonic() - t0 < 5.0


# ----------------------------------------------------------------------
# the driver's requeue budget around a hold (both packages' feed loop)
# ----------------------------------------------------------------------


class _Handle(object):
    def done(self):
        return True

    def wait(self, timeout=None):
        return None


class _Monitor(object):
    restart_events = 0
    interval = 0.05
    recovery_timeout = 5.0

    def check(self):
        return None


def _requeue_driver(mod, max_restarts, rounds):
    """A ``TPUCluster`` of ``mod`` over fakes whose feed rounds replay
    ``rounds``, one entry a round: what lands while it feeds (``"hold"``
    or ``"death"``: a generation step, the round's rows thrown away;
    ``"late"``: the second executor's restart event of the step before,
    the rows delivered but not yet checkpointed; ``"fed"``: the rows
    delivered but not yet checkpointed; ``None``: the rows reach a
    checkpoint).  Each executor's re-rendezvous counts one restart
    event.  Returns the cluster, the fed rounds (``(what, partition ids)``)
    and the committed partition ids."""
    c = mod.TPUCluster.__new__(mod.TPUCluster)
    c.server = type("Server", (), {"generation": 0})()
    c.monitor = _Monitor()
    c.cluster_meta = {"max_restarts": max_restarts}
    c._uncommitted, c._hold_steps, c._fed_gen = {}, 0, 0
    fed, committed = [], set()

    def run_job_async(fn, parts):
        what = rounds[len(fed)] if len(fed) < len(rounds) else None
        fed.append((what, sorted(p[0].pid for p in parts)))
        if what in ("hold", "death"):
            c.server.generation += 1
            c.monitor.restart_events += 1
            c._hold_steps += what == "hold"
        elif what == "late":
            c.monitor.restart_events += 1
        elif what is None:
            committed.update(p[0].pid for p in parts)
        return _Handle()

    c.engine = type("Engine", (), {"run_job_async": staticmethod(
        run_job_async)})()
    c._ledger_committed = lambda: set(committed)
    c._check_monitor = lambda: None
    c._await_respawn = lambda: c.server.generation
    return c, fed, committed


def _feed_epoch(pkg, c, epoch):
    if pkg == "torch":
        c._feed_epoch_elastic(None, [[1.0]], epoch)
    else:
        c._feed_epoch_elastic(None, [[1.0]], epoch, 30)


def _cluster_module(pkg):
    if pkg == "torch":
        return cluster
    from tensorflowonspark_tpu.cluster import cluster as ref_cluster

    return ref_cluster


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_hold_spends_no_round_of_the_requeue_budget(pkg):
    # max_restarts=0 leaves no requeue round for a death; a hold's step
    # still gets its round in the port (a hold charges no restart), while
    # the reference gives up with the partition uncommitted
    c, fed, committed = _requeue_driver(_cluster_module(pkg), 0,
                                        ["hold", None])
    _feed_epoch(pkg, c, 0)
    if pkg == "torch":
        assert [w for w, _ in fed] == ["hold", None]
        assert committed == {"e0p0"}
    else:
        assert [w for w, _ in fed] == ["hold"] and committed == set()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_one_requeue_round_a_generation_step(pkg):
    # one death re-rendezvouses both executors: two restart events, the
    # second while the requeue round feeds.  The port re-feeds once a
    # generation step and leaves the delivered rows to their checkpoint;
    # the reference reads the late event as a second restart and feeds
    # the partition a third time
    c, fed, _ = _requeue_driver(_cluster_module(pkg), 2,
                                ["death", "late", None])
    _feed_epoch(pkg, c, 0)
    want = ["death", "late"] + ([] if pkg == "torch" else [None])
    assert [w for w, _ in fed] == want


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_partition_thrown_away_between_epochs_is_fed_again(pkg):
    # epoch 0's rows are delivered, not yet checkpointed, when a release
    # re-rendezvouses the gang between two epochs: the port's next epoch
    # re-feeds the partition; the reference's forgets it
    c, fed, committed = _requeue_driver(_cluster_module(pkg), 2,
                                        ["fed", None, None])
    _feed_epoch(pkg, c, 0)
    c.server.generation += 1
    c.monitor.restart_events += 2
    _feed_epoch(pkg, c, 1)
    if pkg == "torch":
        assert fed[-1] == (None, ["e0p0"]) and committed == {"e0p0",
                                                             "e1p0"}
    else:
        assert committed == {"e1p0"}
