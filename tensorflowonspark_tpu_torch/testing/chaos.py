"""Deterministic chaos injection for fault-tolerance tests (port of the
JAX package's ``testing/chaos.py``, cut to the kill-worker and
slow-executor faults, the serving faults, the prefill faults and the
fleet replicas' faults).

A :class:`ChaosPlan` is written to a JSON file and advertised through
the ``TFOS_CHAOS_PLAN`` env var.  Training: the user fn under test
builds :func:`step_fault_fn` and calls the returned hook once per
training step (``SyncTrainer.train_on_feed(step_callback=...)``); the
kill is a SIGKILL to the compute process's own pid: no exit handlers,
no error-queue post, which is what a preemption or an OOM kill looks
like to the rest of the system.  A ``slow_executor`` fault stalls one
executor's feed pulls (:func:`slow_feed_fn` wrapped around its feed by
:class:`SlowFeed`): the straggler the health plane is to name.
Serving: the engine reads the plan's
``wedge_dispatch`` faults (:func:`serving_wedge_fn`), a disaggregated
engine's prefill worker its ``kill_prefill`` / ``wedge_prefill`` /
``leak_lease`` faults (:func:`prefill_fault_fn`), the checkpoint
watcher its ``slow_ingest`` (:func:`ingest_delay`), and a harness its
``swap_during_wedge`` chunk (:func:`swap_chunk_from_plan`);
:func:`corrupt_checkpoint`, :func:`shape_mismatched_params`,
:func:`poison_row` and :func:`slow_consumer` build the other serving
faults directly.  Every fault is reproducible: a chaos test that fails
fails the same way every run.

Nothing here imports ``torch``: executors load the plan too.  Nothing
runs unless a test opts in: with ``TFOS_CHAOS_PLAN`` unset every hook is
a no-op.

The fleet's replicas read their ``kill_replica`` / ``slow_replica`` /
``device_error`` faults (:func:`replica_fault_fn`).

:meth:`ChaosPlan.combined` builds the combined fault storm (slow
executor, leader kill, replica kill, corrupt checkpoint) as one plan,
and :meth:`ChaosPlan.schedule` gives a harness its wall-clock order.
A ``kill_leader`` entry is a plan record only: the hierarchical
parameter server that reads it is not ported.

Not ported (ROADMAP queue A, item 14): the other faults of the
reference's plan (heartbeat drops, the leader kill's in-band hook) and
``TcpGremlin``.
"""

import json
import logging
import os
import signal
import time

import numpy as np

logger = logging.getLogger(__name__)

#: Env var naming the JSON chaos-plan file executors should load.
TFOS_CHAOS_PLAN = "TFOS_CHAOS_PLAN"


class ChaosPlan(object):
    """A deterministic fault plan, serialisable to the plan file::

        plan = ChaosPlan().kill_worker(executor_id=1, at_step=5)
        engine = LocalEngine(2, env=plan.env(plan.save(path)))
    """

    def __init__(self, faults=None):
        self.faults = list(faults or [])

    def kill_worker(self, executor_id, at_step):
        """SIGKILL executor ``executor_id``'s compute process the first
        time its step counter reaches ``at_step``.  Several kills of one
        executor belong to its successive incarnations, in plan order
        (see :func:`step_fault_fn`)."""
        self.faults.append({"kind": "kill", "executor_id": int(executor_id),
                            "at_step": int(at_step)})
        return self

    def kill_leader(self, at_window):
        """Kill the hierarchical gradient plane's pod leader the first
        time its push window sequence reaches ``at_window``.  Each entry
        fires once, in plan order.  The port records the fault in the
        plan (for :meth:`combined` and :meth:`schedule`); no hook of the
        port reads it yet."""
        self.faults.append({"kind": "kill_leader",
                            "at_window": int(at_window)})
        return self

    def slow_executor(self, executor_id, per_batch_sec, batches=0):
        """Make executor ``executor_id`` a straggler: stall each of its
        feed pulls by ``per_batch_sec`` (a slow data pipeline, so the
        stall lands in the ``feed`` phase of the health plane's
        per-executor series).  ``batches=0`` stalls every pull, else only
        the first ``batches``.  Applied by :func:`slow_feed_fn` with
        :class:`SlowFeed` in the user fn under test."""
        self.faults.append(
            {"kind": "slow_executor", "executor_id": int(executor_id),
             "per_batch_sec": float(per_batch_sec),
             "batches": int(batches)})
        return self

    def kill_replica(self, replica_id, at_chunk):
        """Kill serving replica ``replica_id``'s engine the first time its
        decode-chunk count reaches ``at_chunk``: the fault raises
        ``fleet.replica.ReplicaKilled`` inside the engine's chunk
        dispatch, as a replica's death mid-decode would.  The fleet
        router is to re-dispatch the replica's in-flight requests from
        their committed tokens onto a sibling, dropping none.  Each entry
        fires once, in plan order."""
        self.faults.append({"kind": "kill_replica",
                            "replica_id": int(replica_id),
                            "at_chunk": int(at_chunk)})
        return self

    def slow_replica(self, replica_id, per_chunk_sec, chunks=0):
        """Make serving replica ``replica_id`` a straggler: stall each of
        its decode-chunk dispatches by ``per_chunk_sec`` (a throttled or
        shared card).  ``chunks=0`` stalls every chunk, else only the
        first ``chunks``; after them the replica runs at full speed, and
        the router is to route around it while slow, then re-admit it
        after clean probe rounds."""
        self.faults.append({"kind": "slow_replica",
                            "replica_id": int(replica_id),
                            "per_chunk_sec": float(per_chunk_sec),
                            "chunks": int(chunks)})
        return self

    def device_error(self, replica_id, at_chunk):
        """Raise a device error (``fleet.replica.ReplicaDeviceError``)
        inside replica ``replica_id``'s chunk dispatch at ``at_chunk``.
        Unlike ``kill_replica`` the replica quarantines: it posts its
        wreckage, rebuilds its engine and serves probe traffic while
        routed around; the router re-dispatches its work from the
        committed tokens onto a survivor.  Fires once per entry."""
        self.faults.append({"kind": "device_error",
                            "replica_id": int(replica_id),
                            "at_chunk": int(at_chunk)})
        return self

    def slow_ingest(self, sec):
        """Stall every checkpoint ingest of the hot-swap watcher for
        ``sec`` seconds (a slow store); with background ingest, serving
        keeps decoding on the old generation meanwhile."""
        self.faults.append({"kind": "slow_ingest", "sec": float(sec)})
        return self

    def swap_during_wedge(self, at_chunk, hang_sec=30.0):
        """A decode chunk wedges at ``at_chunk`` while a new checkpoint
        waits to swap: the wedge fault, and the chunk a harness reads
        (:func:`swap_chunk_from_plan`) to time its publish."""
        self.wedge_dispatch(at_chunk, hang_sec=hang_sec)
        self.faults.append({"kind": "swap_at_chunk",
                            "at_chunk": int(at_chunk)})
        return self

    def wedge_dispatch(self, at_chunk, hang_sec=30.0):
        """Wedge the serving engine's decode chunk: the first chunk whose
        index reaches ``at_chunk`` stalls ``hang_sec`` seconds before it
        touches the decoder.  Fires once per fault entry; the engine's
        watchdog is to abandon it and re-admit the in-flight requests."""
        self.faults.append({"kind": "wedge_dispatch",
                            "at_chunk": int(at_chunk),
                            "hang_sec": float(hang_sec)})
        return self

    def kill_prefill(self, at_admit):
        """Kill the disaggregated prefill worker the first time its
        prefill count reaches ``at_admit``: it raises
        ``serving_disagg.PrefillWorkerDead`` with its pool lease open,
        as a prefill-side device death would.  The engine is to reap the
        lease, re-prefill the request through the unified admit with the
        same tokens, and rebuild the worker.  Fires once per entry."""
        self.faults.append({"kind": "kill_prefill",
                            "at_admit": int(at_admit)})
        return self

    def wedge_prefill(self, at_admit, hang_sec=30.0):
        """Wedge the prefill whose count reaches ``at_admit`` for
        ``hang_sec`` with its pool lease open (a hung prefill).  The
        engine's prefill watchdog is to abandon it, reap the lease and
        recover through the unified admit; the wedged thread stops when
        it wakes (``PrefillAbandoned``).  Fires once per entry."""
        self.faults.append({"kind": "wedge_prefill",
                            "at_admit": int(at_admit),
                            "hang_sec": float(hang_sec)})
        return self

    def leak_lease(self, at_admit, deadline_sec=0.5):
        """At prefill ``at_admit`` the worker opens an extra one-page
        lease (owner ``chaos:leak_lease``, deadline ``deadline_sec``) and
        drops it: a worker that lost track of a handoff.  The engine's
        deadline reaper is to reclaim it (a ``lease_reaped`` mark) with
        the refcounts balanced."""
        self.faults.append({"kind": "leak_lease",
                            "at_admit": int(at_admit),
                            "deadline_sec": float(deadline_sec)})
        return self

    @classmethod
    def combined(cls, slow_executor=None, kill_leader=None,
                 kill_replica=None, corrupt_checkpoint=None):
        """The combined fault storm as one plan: ``slow_executor +
        kill_leader + kill_replica + corrupt_checkpoint``, each argument
        a dict of that builder's kwargs plus an optional ``at_sec``
        wall-clock offset (seconds from harness start) that the driving
        harness schedules by; the in-band triggers (``at_window``,
        ``at_chunk``, feed pulls) still gate when each fault lands inside
        its subsystem.

        ``corrupt_checkpoint`` has no in-band hook (it is the driver-side
        :func:`corrupt_checkpoint` applied to a published export), so its
        record carries only ``corrupt_kind`` and ``at_sec``; executors
        ignore it.  Example::

            plan = ChaosPlan.combined(
                slow_executor={"executor_id": 1,
                               "per_batch_sec": 0.4, "at_sec": 2},
                kill_leader={"at_window": 3, "at_sec": 5},
                kill_replica={"replica_id": 1, "at_chunk": 4,
                              "at_sec": 8},
                corrupt_checkpoint={"corrupt_kind": "truncate_array",
                                    "at_sec": 11},
            )
        """
        plan = cls()

        def _take(spec, builder):
            spec = dict(spec)
            at_sec = spec.pop("at_sec", None)
            builder(**spec)
            if at_sec is not None:
                plan.faults[-1]["at_sec"] = float(at_sec)

        if slow_executor is not None:
            _take(slow_executor, plan.slow_executor)
        if kill_leader is not None:
            _take(kill_leader, plan.kill_leader)
        if kill_replica is not None:
            _take(kill_replica, plan.kill_replica)
        if corrupt_checkpoint is not None:
            spec = dict(corrupt_checkpoint)
            kind = spec.pop("corrupt_kind", spec.pop("kind", None))
            if kind not in CORRUPT_KINDS:
                raise ValueError(
                    "corrupt_checkpoint needs corrupt_kind in {0}, "
                    "got {1!r}".format(CORRUPT_KINDS, kind))
            fault = {"kind": "corrupt_checkpoint", "corrupt_kind": kind}
            if "at_sec" in spec:
                fault["at_sec"] = float(spec.pop("at_sec"))
            if spec:
                raise ValueError("unknown corrupt_checkpoint keys "
                                 "{0}".format(sorted(spec)))
            plan.faults.append(fault)
        return plan

    def schedule(self):
        """``(at_sec, fault)`` pairs sorted by trigger time (faults with
        no ``at_sec`` sort first, at 0.0): the harness's view of a
        :meth:`combined` plan."""
        return sorted(((float(f.get("at_sec", 0.0)), f)
                       for f in self.faults), key=lambda p: p[0])

    def save(self, path):
        path = os.fspath(path)
        with open(path, "w") as f:
            json.dump({"faults": self.faults}, f)
        return path

    def env(self, path):
        """The env dict to hand a ``LocalEngine`` so executors see the
        plan."""
        return {TFOS_CHAOS_PLAN: os.fspath(path)}

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f).get("faults", []))


def load_plan():
    """The plan advertised through ``TFOS_CHAOS_PLAN``, or None."""
    path = os.environ.get(TFOS_CHAOS_PLAN)
    if not path:
        return None
    try:
        return ChaosPlan.load(path)
    except (OSError, ValueError):
        logger.warning("unreadable chaos plan at %r", path, exc_info=True)
        return None


def step_fault_fn(ctx):
    """The per-step fault hook of this compute process: ``fault(step)``
    SIGKILLs the process when a ``kill`` fault of its executor is due.

    Kill ``i`` of an executor belongs to its incarnation ``i``
    (``ctx.generation``): the process reborn after a kill does not
    re-trigger it when it replays the step from its checkpoint, and a
    second kill in the plan arms the first reborn process.  With no
    plan the hook does nothing.
    """
    plan = load_plan()
    if plan is None:
        return lambda step: None
    kills = [f for f in plan.faults
             if f["kind"] == "kill" and f["executor_id"] == ctx.executor_id]
    generation = getattr(ctx, "generation", 0)

    def fault(step):
        for i, f in enumerate(kills):
            if i == generation and step >= f["at_step"]:
                logger.warning(
                    "chaos: killing executor %d compute (pid %d) at step "
                    "%d per plan", ctx.executor_id, os.getpid(), step)
                os.kill(os.getpid(), signal.SIGKILL)

    return fault


def slow_feed_fn(ctx):
    """This executor's feed-stall hook from the plan, or None when no
    ``slow_executor`` fault names it.  Returns ``delay()``, to call once
    per feed pull: it sleeps ``per_batch_sec`` while the fault's batch
    budget lasts."""
    plan = load_plan()
    if plan is None:
        return None
    faults = [f for f in plan.faults
              if f["kind"] == "slow_executor"
              and f["executor_id"] == int(ctx.executor_id)]
    if not faults:
        return None
    state = {"pulled": 0}
    per_sec = max(f["per_batch_sec"] for f in faults)
    budget = max(f["batches"] for f in faults)

    def delay():
        state["pulled"] += 1
        if budget and state["pulled"] > budget:
            return
        time.sleep(per_sec)

    return delay


class SlowFeed(object):
    """A :class:`~..data.feed.DataFeed` whose every pull first stalls
    through ``delay_fn`` (the stall lands in the consumer's
    ``feed_wait``); everything else goes to the wrapped feed."""

    def __init__(self, feed, delay_fn):
        self._feed = feed
        self._delay = delay_fn

    def next_batch(self, *a, **kw):
        self._delay()
        return self._feed.next_batch(*a, **kw)

    def next_arrays(self, *a, **kw):
        self._delay()
        return self._feed.next_arrays(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._feed, name)


def serving_wedge_fn():
    """The serving engine's wedge hook from the plan, or None when the
    plan orders no ``wedge_dispatch`` fault.  ``maybe_wedge(chunk)``
    sleeps ``hang_sec`` in the engine's dispatch thread when an armed
    fault is due; each fault fires once, in plan order."""
    plan = load_plan()
    if plan is None:
        return None
    wedges = [f for f in plan.faults if f["kind"] == "wedge_dispatch"]
    if not wedges:
        return None
    spent = set()

    def maybe_wedge(chunk_index):
        for i, f in enumerate(wedges):
            if i not in spent and chunk_index >= f["at_chunk"]:
                spent.add(i)
                logger.warning("chaos: wedging decode dispatch at chunk %d "
                               "for %.1fs per plan", chunk_index,
                               f["hang_sec"])
                time.sleep(f["hang_sec"])
                return

    return maybe_wedge


def prefill_fault_fn():
    """The prefill worker's fault hook from the plan, or None when the
    plan orders no prefill fault.  ``fault(prefill_index, worker)`` runs
    once per prefill with the handoff lease open and the generator
    untouched: ``leak_lease`` opens an extra one-page lease (owner
    ``chaos:leak_lease``) and lets the prefill go on, ``wedge_prefill``
    sleeps ``hang_sec``, ``kill_prefill`` marks the worker dead and
    raises ``PrefillWorkerDead``.  Each entry fires once, in plan order;
    a leak runs before a wedge before a kill due at the same index."""
    plan = load_plan()
    if plan is None:
        return None
    kills = [f for f in plan.faults if f["kind"] == "kill_prefill"]
    wedges = [f for f in plan.faults if f["kind"] == "wedge_prefill"]
    leaks = [f for f in plan.faults if f["kind"] == "leak_lease"]
    if not kills and not wedges and not leaks:
        return None
    spent = set()

    def fault(prefill_index, worker):
        for i, f in enumerate(leaks):
            if ("leak", i) not in spent and prefill_index >= f["at_admit"]:
                spent.add(("leak", i))
                page = worker.decoder._alloc_pages(1)
                worker.decoder.page_pool.begin_handoff(
                    page, owner="chaos:leak_lease",
                    deadline_sec=f["deadline_sec"])
                logger.warning("chaos: leaked handoff lease (page %s, "
                               "deadline %.2fs) at prefill %d per plan",
                               page, f["deadline_sec"], prefill_index)
        for i, f in enumerate(wedges):
            if ("wedge", i) not in spent and prefill_index >= f["at_admit"]:
                spent.add(("wedge", i))
                logger.warning("chaos: wedging prefill dispatch at prefill "
                               "%d for %.1fs per plan", prefill_index,
                               f["hang_sec"])
                time.sleep(f["hang_sec"])
        for i, f in enumerate(kills):
            if ("kill", i) not in spent and prefill_index >= f["at_admit"]:
                spent.add(("kill", i))
                from tensorflowonspark_tpu_torch.serving_disagg import (
                    PrefillWorkerDead,
                )

                worker.dead = True
                logger.warning("chaos: killing prefill worker at prefill "
                               "%d per plan", prefill_index)
                raise PrefillWorkerDead(
                    "chaos kill_prefill at prefill {0}".format(
                        prefill_index))

    return fault


def replica_fault_fn(replica_id):
    """The fleet replica's chunk-dispatch fault hook from the plan, or
    None when no ``kill_replica`` / ``device_error`` / ``slow_replica``
    fault targets it.

    ``fault(chunk_index)`` is installed as the replica engine's
    ``wedge_fn`` (it runs right before every chunk dispatch): a due
    ``kill_replica`` raises ``fleet.replica.ReplicaKilled`` (each entry
    fires once, in plan order); a ``device_error`` raises
    ``fleet.replica.ReplicaDeviceError`` (the replica quarantines instead
    of dying); a ``slow_replica`` sleeps ``per_chunk_sec`` while its
    chunk budget lasts.  The hook outlives a quarantine's engine rebuild,
    so a fired fault stays spent."""
    plan = load_plan()
    if plan is None:
        return None
    rid = int(replica_id)
    kills = [f for f in plan.faults
             if f["kind"] == "kill_replica" and f["replica_id"] == rid]
    devs = [f for f in plan.faults
            if f["kind"] == "device_error" and f["replica_id"] == rid]
    slows = [f for f in plan.faults
             if f["kind"] == "slow_replica" and f["replica_id"] == rid]
    if not kills and not devs and not slows:
        return None
    spent = set()
    slowed = {"chunks": 0}

    def fault(chunk_index):
        for i, f in enumerate(kills):
            if i not in spent and chunk_index >= f["at_chunk"]:
                spent.add(i)
                from tensorflowonspark_tpu_torch.fleet.replica import (
                    ReplicaKilled,
                )

                logger.warning("chaos: killing serving replica %d at chunk "
                               "%d per plan", rid, chunk_index)
                raise ReplicaKilled("chaos kill_replica {0} at chunk "
                                    "{1}".format(rid, chunk_index))
        for i, f in enumerate(devs):
            if ("dev", i) not in spent and chunk_index >= f["at_chunk"]:
                spent.add(("dev", i))
                from tensorflowonspark_tpu_torch.fleet.replica import (
                    ReplicaDeviceError,
                )

                logger.warning("chaos: device error on serving replica %d "
                               "at chunk %d per plan", rid, chunk_index)
                raise ReplicaDeviceError(
                    "chaos device_error on replica {0} at chunk "
                    "{1}".format(rid, chunk_index))
        for f in slows:
            if f["chunks"] and slowed["chunks"] >= f["chunks"]:
                continue
            slowed["chunks"] += 1
            time.sleep(f["per_chunk_sec"])
            return

    return fault


def ingest_delay():
    """Seconds the plan stalls checkpoint ingests (``slow_ingest``), or
    None."""
    plan = load_plan()
    if plan is None:
        return None
    secs = [f["sec"] for f in plan.faults if f["kind"] == "slow_ingest"]
    return max(secs) if secs else None


def swap_chunk_from_plan():
    """The chunk a ``swap_during_wedge`` fault targets, or None: the
    harness's half of that fault (it publishes the new checkpoint so
    that it lands while the wedge holds the chunk)."""
    plan = load_plan()
    if plan is None:
        return None
    for f in plan.faults:
        if f["kind"] == "swap_at_chunk":
            return int(f["at_chunk"])
    return None


#: :func:`corrupt_checkpoint`'s kinds, one for each validation stage of
#: the hot swap: a truncated array file fails the load, a garbage
#: manifest the manifest stage, a mis-shaped leaf the tree stage
CORRUPT_KINDS = ("truncate_array", "bad_manifest", "shape_mismatch")


def corrupt_checkpoint(step_dir, kind):
    """Corrupt a published step export in place: ``truncate_array`` cuts
    the largest file under ``params/`` to a third (``load_failed``),
    ``bad_manifest`` makes the manifest garbage (``bad_manifest``),
    ``shape_mismatch`` republishes the export with its largest ``>=2``-D
    leaf one longer in its last axis (``shape_mismatch``).  Returns the
    path corrupted."""
    step_dir = os.fspath(step_dir)
    if kind == "truncate_array":
        biggest, size = None, -1
        for root, _dirs, files in os.walk(os.path.join(step_dir, "params")):
            for name in files:
                p = os.path.join(root, name)
                s = os.path.getsize(p)
                if s > size:
                    biggest, size = p, s
        if biggest is None:
            raise RuntimeError("no array files under %s" % step_dir)
        with open(biggest, "r+b") as f:
            f.truncate(max(1, size // 3))
        return biggest
    if kind == "bad_manifest":
        path = os.path.join(step_dir, "manifest.json")
        with open(path, "wb") as f:
            f.write(b"\x00garbage{{{not json")
        return path
    if kind == "shape_mismatch":
        from tensorflowonspark_tpu_torch import checkpoint as ckpt

        params, _meta = ckpt.load_for_serving(step_dir)
        manifest = ckpt.read_manifest(step_dir) or {}
        ckpt.save_for_serving(step_dir, shape_mismatched_params(params),
                              step=manifest.get("step"))
        return step_dir
    raise ValueError("unknown corrupt kind {0!r}; pick one of {1}".format(
        kind, CORRUPT_KINDS))


def _leaf_paths(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaf_paths(tree[key], prefix + (key,))
        else:
            yield prefix + (key,)


def shape_mismatched_params(params):
    """A copy of ``params`` (nested dicts) whose largest ``>=2``-D leaf
    grew by one along its last axis: it loads, and the tree stage must
    quarantine it."""
    target, target_size = None, -1
    for path in _leaf_paths(params):
        leaf = params
        for k in path:
            leaf = leaf[k]
        size = int(np.prod(leaf.shape))
        if len(leaf.shape) >= 2 and size > target_size:
            target, target_size = path, size
    if target is None:
        raise RuntimeError("params has no >=2-D leaf to mis-shape")

    def _copy(tree, path):
        out = dict(tree)
        if len(path) == 1:
            a = out[path[0]]
            if type(a).__module__.startswith("torch"):
                import torch

                out[path[0]] = torch.cat(
                    [a, a.new_zeros(tuple(a.shape[:-1]) + (1,))], dim=-1)
            else:
                a = np.asarray(a)
                out[path[0]] = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, 1)])
        else:
            out[path[0]] = _copy(tree[path[0]], path[1:])
        return out

    return _copy(params, target)


#: :func:`poison_row`'s kinds, one for each admission-validation failure
#: class of the serving engine
POISON_KINDS = ("missing_key", "bad_dtype", "bad_shape", "empty",
                "oversized", "bad_budget")


def poison_row(kind, prompt_col="prompt", length=8, vocab=64, seed=0):
    """A deterministic malformed serving request of ``kind`` (see
    :data:`POISON_KINDS`), to be isolated at admission
    (``on_error="record"``) instead of killing the batch."""
    rng = np.random.RandomState(seed)
    good = rng.randint(0, vocab, (length,)).astype(np.int32)
    if kind == "missing_key":
        return {prompt_col + "_typo": good}
    if kind == "bad_dtype":
        return {prompt_col: good.astype(np.float32) + 0.5}
    if kind == "bad_shape":
        return {prompt_col: np.stack([good, good])}
    if kind == "empty":
        return {prompt_col: np.zeros((0,), np.int32)}
    if kind == "oversized":
        return {prompt_col: rng.randint(0, vocab,
                                        (1 << 16,)).astype(np.int32)}
    if kind == "bad_budget":
        from tensorflowonspark_tpu_torch.serving_engine import BUDGET_INPUT

        return {prompt_col: good, BUDGET_INPUT: "not-a-number"}
    raise ValueError("unknown poison kind {0!r}; pick one of {1}".format(
        kind, POISON_KINDS))


def slow_consumer(outputs, stall_sec=0.01, every=1):
    """``outputs`` (a ``predict_rows`` generator) with a ``stall_sec``
    sleep before every ``every``-th pull: the engine advances only
    between pulls, so the stall delays chunk boundaries."""
    for i, row in enumerate(outputs):
        if i % max(1, int(every)) == 0:
            time.sleep(stall_sec)
        yield row
