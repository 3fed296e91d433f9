"""Elastic supervision of the port on its ``LocalEngine`` and the CPU.

Held against the JAX package where the behaviour is deterministic: the
``PartitionLedger`` state machine and the generation rule of
``Server.next_generation`` give the same results on the same op
sequences (both modules import no JAX).  Then the port's own plane: the
queue reset that releases a blocked ``join()`` and discards every
partition no checkpoint committed, the generation on the
heartbeat reply and the LIVENESS snapshot, the driver's monitor in both
modes, the chaos hook's kill in a real subprocess, and three end-to-end
runs over ``cluster.run(elastic=True)``:

- one executor killed at step 6 (checkpoints every 4 steps; 4 and 12
  partitions an epoch) reaches
  generation 1, commits every partition, trains every batch (the
  repeats are exactly the uncommitted batches the dead incarnation had
  trained) and its reborn losses equal, to the bit, a replay in this
  process that restores the same checkpoint and takes the same logged
  batches;
- two gloo ranks, rank 1 killed: both respawn into a new process group
  at generation 1 and end with equal weights;
- two kills against ``max_restarts=1``: ``train`` raises naming the
  exhausted budget before the monitor's recovery window closes.

The user fns live in ``tests/torch_dist_workers.py`` (their processes
import no JAX).  Every run is bounded by ``reservation_timeout``,
``feed_timeout`` and ``shutdown(timeout=)`` of 60 s.
"""

import json
import logging
import os
import subprocess
import sys
import threading
import time
import uuid
from collections import Counter

import pytest
import torch

import torch_dist_workers as workers
from tensorflowonspark_tpu.cluster import manager as jmanager
from tensorflowonspark_tpu.cluster import reservation as jreservation
from tensorflowonspark_tpu.testing import chaos as jchaos
from tensorflowonspark_tpu_torch import checkpoint
from tensorflowonspark_tpu_torch.cluster import cluster, manager, reservation
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.testing import chaos

BOUNDS = dict(reservation_timeout=60)
TIMEOUT = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --- the ledger and the generation rule against the JAX package ---------

LEDGER_SEQUENCES = {
    "state_machine": [
        ("begin", "p0"), ("begin", "p1"), ("pending", None),
        ("deliver", "p0"), ("committed", None), ("commit", None),
        ("committed", None), ("pending", None), ("begin", "p1"),
        ("deliver", "p1"), ("commit", None), ("pending", None),
        ("snapshot", None)],
    "deliver_needs_begin": [
        ("deliver", "p9"), ("snapshot", None), ("commit", None),
        ("begin", "p9"), ("deliver", "p9"), ("deliver", "p9"),
        ("commit", None), ("commit", None), ("snapshot", None)],
    "requeue_after_commit": [
        ("begin", "e0p0"), ("deliver", "e0p0"), ("commit", None),
        ("begin", "e0p0"), ("pending", None), ("committed", None),
        ("deliver", "e0p0"), ("begin", "e0p1"), ("snapshot", None),
        ("commit", None), ("pending", None)],
}


@pytest.mark.parametrize("name", sorted(LEDGER_SEQUENCES))
def test_ledger_matches_the_reference(name):
    ours, theirs = manager.PartitionLedger(), jmanager.PartitionLedger()
    for op, arg in LEDGER_SEQUENCES[name]:
        assert ours.op(op, arg) == theirs.op(op, arg), (op, arg)
    for ledger in (ours, theirs):
        with pytest.raises(ValueError, match="unknown ledger op"):
            ledger.op("bogus")


GENERATION_SEQUENCES = {
    "simultaneous_deaths_join": [(0, 0), (1, 0), (0, 1), (2, 1), (1, 2)],
    "stale_claims": [(3, 2), (0, 0), (1, 5), (2, 0), (0, 6)],
    "one_node_restarts": [(0, 0), (0, 1), (0, 2), (0, 3)],
}


@pytest.mark.parametrize("name", sorted(GENERATION_SEQUENCES))
def test_next_generation_matches_the_reference(name):
    ours, theirs = reservation.Server(4), jreservation.Server(4)
    for eid, old in GENERATION_SEQUENCES[name]:
        assert ours.next_generation(eid, old) \
            == theirs.next_generation(eid, old)
        assert ours.generation == theirs.generation
        # the claim beats the registry at the claimed generation
        assert ours.liveness.generation(eid) \
            == theirs.liveness.generation(eid) == ours.generation
    assert {k: v["generation"] for k, v in ours.liveness.snapshot().items()} \
        == {k: v["generation"]
            for k, v in theirs.liveness.snapshot().items()}


def test_chaos_plan_file_matches_the_reference(tmp_path):
    ours = chaos.ChaosPlan().kill_worker(1, at_step=5).kill_worker(1, 9)
    theirs = jchaos.ChaosPlan().kill_worker(1, at_step=5).kill_worker(1, 9)
    path = ours.save(tmp_path / "plan.json")
    assert jchaos.ChaosPlan.load(path).faults == theirs.faults
    assert chaos.ChaosPlan.load(theirs.save(tmp_path / "j.json")).faults \
        == ours.faults
    assert ours.env(path) == theirs.env(path) \
        == {chaos.TFOS_CHAOS_PLAN: str(path)}


# --- the node's data plane ------------------------------------------------


def test_reset_queue_releases_a_blocked_join():
    mgr, _ = manager.start(uuid.uuid4().bytes, ["input", "error"])
    try:
        q = mgr.get_queue("input")
        for i in range(6):
            q.put(i)
        q.get(), q.get()  # a consumer pops two items and dies
        released = []
        t = threading.Thread(target=lambda: (q.join(), released.append(1)),
                             daemon=True)
        t.start()
        time.sleep(0.3)
        assert not released
        assert mgr.reset_queue("input")._getvalue() == 4
        t.join(timeout=5)
        assert released, "the reset did not release the blocked join()"
        q.put("fresh")  # the queue stays usable for the next incarnation
        assert q.get() == "fresh"
        q.task_done()
        assert mgr.ledger("pending")._getvalue() == []
    finally:
        mgr.shutdown()


def _reset_race(mgr_mod):
    """A rebirth's two queue resets with a feeder that began between
    them: what the ledger says of its partition after its ``join()``
    returns and it delivers, and after the next checkpoint's commit."""
    mgr, _ = mgr_mod.start(uuid.uuid4().bytes, ["input", "error"])
    try:
        q = mgr.get_queue("input")
        mgr.ledger("begin", "e0p0")
        q.put("row0")
        q.get()  # the consumer pops it and dies
        mgr.reset_queue("input")  # the first pass
        mgr.ledger("begin", "e0p1")  # a requeue round begins early
        q.put("row1")
        joined = threading.Thread(target=q.join, daemon=True)
        joined.start()
        mgr.reset_queue("input")  # the second pass throws row1 away
        joined.join(timeout=5)
        assert not joined.is_alive()
        mgr.ledger("deliver", "e0p0")
        mgr.ledger("deliver", "e0p1")
        mgr.ledger("commit")
        return mgr.ledger("snapshot")._getvalue()
    finally:
        mgr.shutdown()


def test_reset_rows_never_count_as_delivered():
    # the port keeps both partitions pending, so the driver requeues them
    assert _reset_race(manager) == {"e0p0": "discarded",
                                    "e0p1": "discarded"}
    # the reference commits rows that no process consumed (ROADMAP C3)
    assert _reset_race(jmanager) == {"e0p0": "committed",
                                     "e0p1": "committed"}


def _reset_after_a_checkpoint(mgr_mod):
    """A rebirth's reset with one partition committed by the last
    checkpoint, one delivered after it and one inflight: what the
    ledger says after the reborn process's first commit."""
    mgr, _ = mgr_mod.start(uuid.uuid4().bytes, ["input", "error"])
    try:
        for pid in ("e0p0", "e0p1", "e0p2"):
            mgr.ledger("begin", pid)
            if pid == "e0p1":
                mgr.ledger("commit")  # the last checkpoint
            if pid != "e0p2":
                mgr.ledger("deliver", pid)
        mgr.reset_queue("input")
        mgr.ledger("commit")  # the reborn process's first checkpoint
        return mgr.ledger("snapshot")._getvalue()
    finally:
        mgr.shutdown()


def test_reset_discards_what_no_checkpoint_committed():
    # the reborn process resumes from the last checkpoint: e0p1 was
    # trained only on the trajectory the restore threw away
    assert _reset_after_a_checkpoint(manager) == {
        "e0p0": "committed", "e0p1": "discarded", "e0p2": "discarded"}
    # the reference commits e0p1 at the reborn checkpoint (ROADMAP C5)
    assert _reset_after_a_checkpoint(jmanager) == {
        "e0p0": "committed", "e0p1": "committed", "e0p2": "inflight"}


# --- the rendezvous server -------------------------------------------------


@pytest.fixture()
def server():
    srv = reservation.Server(2, heartbeat_interval=0.1)
    srv.start()
    yield srv
    srv.stop()


def test_heartbeat_reply_carries_the_cluster_generation(server):
    client = reservation.Client(server.addr)
    hb = reservation.Heartbeater(server.addr, 7, interval=0.05,
                                 generation_fn=lambda: 0).start()
    try:
        assert client.heartbeat(3)["generation"] == 0
        assert client.rebirth(9, 0) == 1
        assert client.heartbeat(3, generation=1)["generation"] == 1
        deadline = time.monotonic() + 5
        while hb.cluster_generation < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert hb.cluster_generation == 1
    finally:
        hb.stop()
        client.close()


def test_liveness_frame_returns_the_snapshot(server):
    client = reservation.Client(server.addr)
    try:
        client.heartbeat(0, generation=0, host="h0")
        client.heartbeat(1, generation=2, compute_alive=False, host="h1")
        client.register({"executor_id": 4, "host": "h4", "generation": 3})
        executors, dead = client.get_liveness()
        assert sorted(executors) == ["0", "1", "4"]
        assert {k: (v["generation"], v["compute_alive"], v["host"])
                for k, v in executors.items()} == {
            "0": (0, True, "h0"), "1": (2, False, "h1"), "4": (3, True, "h4")}
        assert list(dead) == ["1"]
        assert dead["1"]["generation"] == 2
        assert "compute process dead" in dead["1"]["reason"]
    finally:
        client.close()


# --- the driver's monitor ---------------------------------------------------

NODES = [{"executor_id": 0, "host": "h0", "job_name": "worker",
          "task_index": 0}]


def test_monitor_counts_a_rebirth_and_sets_no_error():
    srv = reservation.Server(1, heartbeat_interval=0.1)
    mon = cluster.ClusterMonitor(srv, NODES, elastic=True,
                                 recovery_timeout=30)
    srv.liveness.beat(0)
    mon._poll()
    srv.liveness.beat(0, compute_alive=False)  # the compute process died
    mon._poll()
    mon.check()  # the recovery window is open: no failure yet
    assert srv.next_generation(0, 0) == 1  # REBIRTH
    srv.liveness.beat(0, generation=1)
    mon._poll()
    assert mon.restart_events == 1
    assert mon.error is None
    mon.check()


def test_monitor_fails_past_the_recovery_window():
    srv = reservation.Server(1, heartbeat_interval=0.1)
    mon = cluster.ClusterMonitor(srv, NODES, elastic=True,
                                 recovery_timeout=0.3)
    srv.liveness.beat(0, compute_alive=False)
    mon._poll()
    mon.check()
    time.sleep(0.4)
    mon._poll()
    with pytest.raises(cluster.DeadExecutorError,
                       match=r"executor 0 .*no recovery within the 0s "
                             r"elastic window") as err:
        mon.check()
    assert err.value.executor_id == 0


def test_monitor_without_elastic_fails_at_once():
    srv = reservation.Server(1, heartbeat_interval=0.1)
    mon = cluster.ClusterMonitor(srv, NODES)
    srv.liveness.beat(0, compute_alive=False)
    mon._poll()
    with pytest.raises(cluster.DeadExecutorError,
                       match="compute process dead"):
        mon.check()
    assert mon.restart_events == 0


# --- the chaos hook, killing a real process ---------------------------------

FAULT_SCRIPT = """
import sys
from tensorflowonspark_tpu_torch.testing import chaos

class Ctx(object):
    executor_id = 1
    generation = int(sys.argv[1])

fault = chaos.step_fault_fn(Ctx())
for step in range(8):
    print(step, flush=True)
    fault(step)
"""


@pytest.mark.parametrize("generation,code,steps", [
    (0, -9, 6),   # generation 0 arms the first kill: SIGKILL at step 5
    (1, -9, 8),   # the second kill belongs to generation 1 (step 7)
    (2, 0, 8),    # both spent: the third incarnation runs to its end
], ids=["generation0", "generation1", "generation2"])
def test_step_fault_fn_kills_its_incarnation(tmp_path, generation, code,
                                             steps):
    path = chaos.ChaosPlan().kill_worker(1, at_step=5).kill_worker(
        1, at_step=7).kill_worker(0, at_step=0).save(tmp_path / "p.json")
    proc = subprocess.run(
        [sys.executable, "-c", FAULT_SCRIPT, str(generation)], cwd=REPO,
        env=dict(os.environ, **chaos.ChaosPlan().env(path)),
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == code, proc.stderr
    assert proc.stdout.split() == [str(s) for s in range(steps)]


def test_no_plan_means_no_fault(monkeypatch):
    monkeypatch.delenv(chaos.TFOS_CHAOS_PLAN, raising=False)
    assert chaos.load_plan() is None
    chaos.step_fault_fn(type("Ctx", (), {"executor_id": 0}))(10 ** 6)


# --- end to end -------------------------------------------------------------

SEED, BATCH, EPOCHS = 3, 2, 3


class _Requeues(logging.Handler):
    """Collects the driver's requeue rounds (the partition ids each
    re-fed)."""

    def __init__(self):
        super(_Requeues, self).__init__(logging.WARNING)
        self.rounds = []

    def emit(self, record):
        if record.msg.startswith("elastic requeue round"):
            self.rounds.append(list(record.args[2]))


def run_elastic(tmp_path, executors, parts, kills, max_restarts=1,
                recovery_timeout=60.0, epochs=EPOCHS):
    """``cluster.run(elastic=True)`` of :func:`workers.elastic_train_fn`
    over ``parts`` for ``epochs`` epochs under a plan of ``kills``
    (``(executor, step)`` pairs).  Returns what the fns logged and the
    driver saw."""
    plan = chaos.ChaosPlan()
    for eid, step in kills:
        plan.kill_worker(eid, at_step=step)
    log, keep = tmp_path / "log", tmp_path / "keep"
    log.mkdir()
    keep.mkdir()
    args = {"ckpt": str(tmp_path / "ckpt"), "keep": str(keep),
            "log": str(log), "batch": BATCH}
    requeues = _Requeues()
    driver_log = logging.getLogger(cluster.__name__)
    driver_log.addHandler(requeues)
    engine = LocalEngine(executors, env=plan.env(plan.save(
        tmp_path / "plan.json")), deterministic=True)
    t0 = time.monotonic()
    try:
        c = cluster.run(engine, workers.elastic_train_fn, args,
                        num_executors=executors, elastic=True,
                        max_restarts=max_restarts, heartbeat_interval=0.5,
                        recovery_timeout=recovery_timeout, **BOUNDS)
        c.train(parts, num_epochs=epochs, feed_timeout=TIMEOUT)
        c.shutdown(timeout=TIMEOUT)
        ledgers = [manager.connect(tuple(n["addr"]), bytes.fromhex(
            n["authkey"])).ledger("snapshot")._getvalue()
            for n in sorted(c.cluster_info, key=lambda n: n["executor_id"])]
        generation = c.server.generation
    finally:
        driver_log.removeHandler(requeues)
        engine.stop()
    steps = {}
    for name in sorted(os.listdir(log)):
        if name.startswith("gen"):
            with open(log / name) as f:
                steps[name[:-len(".jsonl")]] = [json.loads(ln) for ln in f]
    finals = [json.loads((log / "final.rank{0}.json".format(r)).read_text())
              for r in range(executors)]
    return dict(steps=steps, finals=finals, ledgers=ledgers,
                generation=generation, requeues=requeues.rounds,
                keep=str(keep), seconds=time.monotonic() - t0)


def elastic_parts(batches):
    """One partition per batch; the odd ones made on the executor."""
    import functools

    tokens = workers.elastic_tokens(SEED, batches, BATCH)
    parts = [functools.partial(workers.elastic_rows, SEED, batches, BATCH, i)
             if i % 2 else [{"tokens": r} for r in tokens[i]]
             for i in range(batches)]
    return tokens, parts


def replay(keep, restored, batches):
    """The reborn incarnation's trajectory in this process: the tiny
    model restored from checkpoint ``restored`` and stepped through
    ``batches`` in order; returns the losses."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the fn: one thread, the same sums
    try:
        _, trainer, state = workers.elastic_model()
        state = checkpoint.Checkpointer(keep).restore(state, step=restored)
        losses = []
        for tokens in batches:
            state, metrics = trainer.step(state, {"tokens": tokens})
            losses.append(float(metrics["loss"]))
        return losses
    finally:
        torch.set_num_threads(threads)


# 4 partitions an epoch for 3 epochs: the kill falls in epoch 1 with
# fewer than checkpoint_every partitions left to feed; 12 in one epoch:
# the epoch still feeds the reborn process past its first checkpoint,
# whose commit must not promote the partitions the dead incarnation
# trained past the restored step
@pytest.mark.parametrize("batches,epochs", [(4, EPOCHS), (12, 1)])
def test_one_executor_is_reborn_and_resumes(tmp_path, batches, epochs):
    tokens, parts = elastic_parts(batches)
    by_fp = {workers.tokens_fingerprint(t): t for t in tokens}
    got = run_elastic(tmp_path, 1, parts, kills=[(0, 6)], epochs=epochs)
    gen0, gen1 = got["steps"]["gen0.rank0"], got["steps"]["gen1.rank0"]
    # 1. generation 1 after one restart, and the run completed
    assert got["generation"] == 1
    assert got["finals"][0]["generation"] == 1
    assert [r["step"] for r in gen0] == [1, 2, 3, 4, 5, 6]
    # 2. the reborn process restored step 4
    restored = gen1[0]["restored"]
    assert restored == workers.ELASTIC_CKPT_EVERY
    trained1 = gen1[1:]
    assert [r["step"] for r in trained1] \
        == list(range(restored + 1, restored + 1 + len(trained1)))
    # 3. every partition committed, none pending
    ids = {"e{0}p{1}".format(e, i) for e in range(epochs)
           for i in range(batches)}
    assert got["ledgers"] == [{pid: "committed" for pid in ids}]
    # 4. every batch of every epoch is on the surviving trajectory (the
    # dead incarnation's steps up to the checkpoint, then the reborn's);
    # the repeats are of requeued partitions, uncommitted at the kill,
    # and include every batch the dead incarnation trained past the
    # checkpoint
    effective = Counter(r["fp"] for r in gen0[:restored] + trained1)
    want = Counter({workers.tokens_fingerprint(t): epochs for t in tokens})
    assert not want - effective, "a batch was never trained"
    assert got["requeues"], "no partition was requeued"
    requeued = Counter(
        workers.tokens_fingerprint(tokens[int(pid.split("p")[1])])
        for pids in got["requeues"] for pid in pids)
    assert not (effective - want) - requeued
    assert not Counter(r["fp"] for r in gen0[restored:]) - requeued
    assert got["finals"][0]["steps"] == restored + len(trained1)
    # 5. the reborn losses equal, to the bit, a replay from the same
    # checkpoint over the same logged batches
    assert replay(got["keep"], restored,
                  [by_fp[r["fp"]] for r in trained1]) \
        == [r["loss"] for r in trained1]


def test_two_gloo_ranks_respawn_into_a_new_group(tmp_path):
    tokens, parts = elastic_parts(8)  # four batches per rank and epoch
    got = run_elastic(tmp_path, 2, parts, kills=[(1, 6)])
    assert got["generation"] == 1
    assert [f["generation"] for f in got["finals"]] == [1, 1]
    assert got["steps"]["gen1.rank0"][0] == got["steps"]["gen1.rank1"][0] \
        == {"restored": workers.ELASTIC_CKPT_EVERY}
    # one process group: equal weights at the end
    assert got["finals"][0]["weights"] == got["finals"][1]["weights"]
    assert got["finals"][0]["steps"] == got["finals"][1]["steps"]
    committed = set()
    for ledger in got["ledgers"]:
        committed |= {pid for pid, st in ledger.items() if st == "committed"}
    assert committed == {"e{0}p{1}".format(e, i)
                         for e in range(EPOCHS) for i in range(8)}


def test_exhausted_restart_budget_fails_the_run(tmp_path):
    _, parts = elastic_parts(4)
    plan = chaos.ChaosPlan().kill_worker(0, at_step=2).kill_worker(
        0, at_step=3)
    log = tmp_path / "log"
    log.mkdir()
    args = {"ckpt": str(tmp_path / "ckpt"), "keep": str(tmp_path),
            "log": str(log), "batch": BATCH}
    engine = LocalEngine(1, env=plan.env(plan.save(tmp_path / "plan.json")))
    try:
        c = cluster.run(engine, workers.elastic_train_fn, args,
                        num_executors=1, elastic=True, max_restarts=1,
                        heartbeat_interval=0.5, recovery_timeout=TIMEOUT,
                        **BOUNDS)
        with pytest.raises(RuntimeError,
                           match=r"died 2 times \(restart budget 1 "
                                 r"exhausted\)"):
            c.train(parts, num_epochs=EPOCHS, feed_timeout=TIMEOUT)
        # raised by the feed, before the monitor's window closed
        assert c.monitor.error is None
        assert c.server.generation == 1
        with pytest.raises(RuntimeError, match="restart budget 1 exhausted"):
            c.shutdown(timeout=TIMEOUT)
    finally:
        engine.stop()
