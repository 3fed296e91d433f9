"""High-level cluster API: turn an executor fleet into a training
cluster (port of the JAX package's ``cluster/cluster.py``; original:
tensorflowonspark/TFCluster.py).

:func:`run` launches the user's ``main_fun(args, ctx)`` on every
executor, coordinates startup through the rendezvous server, and
returns a :class:`TPUCluster` handle with ``train``, ``train_stream``,
``train_dstream``, ``inference`` and ``shutdown``.
Shutdown is driver-direct: every node manager is reachable over TCP, so
the driver posts the end-of-feed sentinels and collects errors itself.
A :class:`ClusterMonitor` watches the heartbeat registry and fails the
feed within seconds of a worker's death, naming the executor.  With
``elastic=True`` a death opens a recovery window instead: the node's
supervisor respawns the compute process under a new generation, and
``train`` requeues every partition that no checkpoint committed.

Not ported (ROADMAP queue A): remediation holds (``hold_executor``,
``release_executor``), parameter-server and evaluator nodes (``num_ps``,
``driver_ps_nodes``, ``eval_node``), the planner (``plan``), profiling
and tensorboard, and the health, remediation and journal planes.
"""

import functools
import itertools
import logging
import pickle
import queue as _queue_mod
import threading
import time
import uuid

from . import manager, node, reservation
from .marker import PartitionStart
from ..utils import not_ported as _not_ported

logger = logging.getLogger(__name__)


class DeadExecutorError(RuntimeError):
    """A cluster node was declared dead by the heartbeat liveness plane;
    the message names the executor id, host and diagnosis, and
    ``executor_id`` carries the id."""

    def __init__(self, message, executor_id=None):
        super(DeadExecutorError, self).__init__(message)
        self.executor_id = executor_id


class ClusterMonitor(object):
    """Driver-side liveness watcher over the rendezvous server's
    heartbeat registry.

    Polls ``server.liveness`` every half heartbeat interval:

    - ``elastic=False``: the first dead executor is a permanent failure;
      :meth:`check` raises :class:`DeadExecutorError` naming the node,
      with the node's error-queue traceback when one is reachable.
    - ``elastic=True``: a death opens a recovery window of
      ``recovery_timeout`` seconds.  A raised generation or resumed
      beats close it (each generation step counts in
      ``restart_events``, the feed loop's cue to requeue uncommitted
      partitions); an executor still dead past the window is a
      permanent failure.
    """

    def __init__(self, server, cluster_info, elastic=False,
                 recovery_timeout=120.0, error_peek=None):
        self.server = server
        self.cluster_info = cluster_info
        self.elastic = bool(elastic)
        self.recovery_timeout = float(recovery_timeout)
        self.error = None
        self.dead_executor_id = None
        #: per-executor generation steps observed so far (monotonic)
        self.restart_events = 0
        self._by_id = {n["executor_id"]: n for n in cluster_info}
        self._first_dead = {}
        self._known_gen = {}
        self._error_peek = error_peek  # fn(node_meta) -> str | None
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cluster-monitor")
        self._thread.start()
        return self

    @property
    def interval(self):
        return self.server.liveness.interval

    def _run(self):
        while not self._stop.wait(self.interval / 2.0):
            try:
                self._poll()
            except Exception:  # noqa: BLE001 - monitor must not die quiet
                logger.warning("cluster monitor poll failed", exc_info=True)
            if self.error is not None:
                return

    def _poll(self):
        for eid_s, rec in self.server.liveness.snapshot().items():
            eid = int(eid_s)
            known = self._known_gen.get(eid, 0)
            if rec["generation"] > known:
                self.restart_events += rec["generation"] - known
                self._known_gen[eid] = rec["generation"]
                logger.info("monitor: executor %d reborn at generation %d",
                            eid, rec["generation"])
        dead = self.server.liveness.dead()
        now = time.monotonic()
        for eid in list(self._first_dead):
            if eid not in dead:
                logger.info("monitor: executor %d recovered", eid)
                self._first_dead.pop(eid)
        for eid, diag in sorted(dead.items()):
            if not self.elastic:
                self._fail(eid, diag)
                return
            first = self._first_dead.setdefault(eid, now)
            if now - first > self.recovery_timeout:
                self._fail(eid, dict(
                    diag, reason="{0}; no recovery within the {1:.0f}s "
                    "elastic window".format(diag["reason"],
                                            self.recovery_timeout)))
                return

    def _fail(self, eid, diag):
        node_meta = self._by_id.get(eid, {})
        msg = ("executor {0} (host {1}, {2}:{3}) declared dead: {4} "
               "[last heartbeat {5:.1f}s ago, generation {6}]".format(
                   eid, diag.get("host") or node_meta.get("host", "?"),
                   node_meta.get("job_name", "?"),
                   node_meta.get("task_index", "?"),
                   diag["reason"], diag["age"], diag.get("generation", 0)))
        # the user should see WHY it died, not just THAT it died
        if self._error_peek is not None and node_meta:
            try:
                err = self._error_peek(node_meta)
            except Exception:  # noqa: BLE001 - node likely unreachable
                err = None
            if err:
                msg += "\nlast error from executor {0}:\n{1}".format(eid, err)
        logger.error("cluster monitor: %s", msg)
        self.error = msg
        self.dead_executor_id = eid

    def check(self):
        """Raise :class:`DeadExecutorError` if a permanent failure was
        detected; feed loops call it every poll."""
        if self.error is not None:
            raise DeadExecutorError(self.error, self.dead_executor_id)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class InputMode(object):
    """Modes for feeding data to the compute processes."""

    #: The user fn reads its own data (name kept for API parity).
    TENSORFLOW = 0
    #: The engine pushes partitions of data to the nodes.
    SPARK = 1


class _HandleStatus(object):
    """A JobHandle's failure as the status-dict interface that
    ``Server.await_reservations`` polls."""

    def __init__(self, handle):
        self._handle = handle

    def get(self, key, default=None):
        return self._handle.error if key == "error" else default


class TPUCluster(object):
    """Handle to a running cluster (the reference's name, kept so user
    code moves across by changing its imports)."""

    def __init__(self, engine, cluster_meta, cluster_info, server,
                 job_handle, input_mode, queues, owns_engine=False,
                 monitor=None):
        self.engine = engine
        self.cluster_meta = cluster_meta
        self.cluster_info = cluster_info
        self.server = server
        self.job_handle = job_handle
        self.input_mode = input_mode
        self.queues = queues
        self._owns_engine = owns_engine
        self.cluster_id = cluster_meta["id"]
        self.elastic = bool(cluster_meta.get("elastic", False))
        #: liveness watcher (started by run())
        self.monitor = monitor
        #: elastic feeding: partitions fed (this epoch or an earlier one)
        #: that no checkpoint has committed yet, id -> partition
        self._uncommitted = {}

    # -- data plane ----------------------------------------------------

    def train(self, data, num_epochs=1, feed_timeout=600, qname="input"):
        """Feed a dataset to the cluster for training.

        Args:
          data: an engine-native dataset (a Spark RDD or DataFrame on a
            :class:`~..engine.SparkEngine`, fed in place by
            ``foreachPartition``: its rows never pass through the driver),
            or a list of partitions, each a row list or a zero-arg callable
            returning rows (generated on the executors).
          num_epochs: epochs are fed by re-running the feed job.
          feed_timeout: seconds a feed task waits for its rows to be
            consumed before it fails.

        On an elastic cluster every partition of a list leads with its
        :class:`~.marker.PartitionStart` (id ``"e<epoch>p<index>"``),
        and after a restart the partitions that no checkpoint committed
        are fed again (at-least-once).  A native dataset is not
        requeued: its recovery is the engine's task retries and the
        checkpoint resume.
        """
        assert self.input_mode == InputMode.SPARK, (
            "train() requires InputMode.SPARK")
        assert num_epochs >= 1
        feed_fn = node.train(self.cluster_info, self.cluster_meta,
                             feed_timeout, qname)
        if self.engine.is_native_dataset(data):
            logger.info("feeding native dataset x %d epochs", num_epochs)
            if self.elastic:
                logger.info("native dataset on an elastic cluster: no "
                            "partition requeue (the engine's task retries "
                            "and the checkpoint resume recover it)")
            for _ in range(num_epochs):
                self.engine.run_data_job(feed_fn, data)
                self._check_monitor()
            return
        # normalize once so generators of partitions survive re-feeding
        data = [p if callable(p) else list(p) for p in data]
        logger.info("feeding %d partitions x %d epochs", len(data),
                    num_epochs)
        for epoch in range(num_epochs):
            if self.elastic:
                self._feed_epoch_elastic(feed_fn, data, epoch)
            else:
                self._run_feed_monitored(feed_fn, data)

    def train_stream(self, batches, feed_timeout=600, qname="input"):
        """Feed a stream of micro-batches, each a list of partitions (or a
        native dataset) fed as one job (the DStream role).  Ends when ``batches`` is
        exhausted or someone posts STOP on the reservation server
        (``reservation.Client(addr).request_stop()``); returns the
        number of micro-batches fed."""
        assert self.input_mode == InputMode.SPARK, (
            "train_stream() requires InputMode.SPARK")
        feed_fn = node.train(self.cluster_info, self.cluster_meta,
                             feed_timeout, qname)
        fed = 0
        for partitions in batches:
            if self.server.stop_requested:
                logger.info("stop requested after %d stream batches; "
                            "ending feed", fed)
                break
            if self.engine.is_native_dataset(partitions):
                # a stream of RDDs: the foreachRDD contract
                self.engine.run_data_job(feed_fn, partitions)
            else:
                self._run_feed_monitored(
                    feed_fn,
                    [p if callable(p) else list(p) for p in partitions])
            fed += 1
        logger.info("stream feed complete after %d batches", fed)
        return fed

    def train_dstream(self, dstream, feed_timeout=600, qname="input"):
        """Hook a stream with ``foreachRDD``: each micro-batch RDD is fed
        in place (the engine's :meth:`~..engine.Engine.run_data_job`, or
        ``rdd.foreachPartition`` of the feeder) as it arrives;
        after a STOP on the reservation server, later micro-batches are
        skipped."""
        assert self.input_mode == InputMode.SPARK, (
            "train_dstream() requires InputMode.SPARK")
        feed_fn = node.train(self.cluster_info, self.cluster_meta,
                             feed_timeout, qname)
        server = self.server
        engine = self.engine

        def _each_rdd(rdd):
            if server.stop_requested:
                logger.info("stop requested; skipping stream micro-batch")
                return
            if engine.is_native_dataset(rdd):
                engine.run_data_job(feed_fn, rdd)
            else:  # a duck-typed RDD on an engine without native datasets
                rdd.foreachPartition(feed_fn)

        dstream.foreachRDD(_each_rdd)

    def inference(self, data, feed_timeout=600, qname="input", lazy=False):
        """Feed data for inference and return one result per row, in
        order.

        Args:
          data: an engine-native dataset or a list of partitions (see
            :meth:`train`).
          lazy: return the results without collecting them on the
            driver: a lazy result RDD for a native dataset, else a
            generator of per-partition result lists, each yielded as soon
            as it and its predecessors complete.
        """
        assert self.input_mode == InputMode.SPARK, (
            "inference() requires InputMode.SPARK")
        feed_fn = node.inference(self.cluster_info, self.cluster_meta,
                                 feed_timeout, qname)
        if self.engine.is_native_dataset(data):
            result = self.engine.map_partitions_native(feed_fn, data)
            return result if lazy else result.collect()
        data = [p if callable(p) else list(p) for p in data]
        if lazy:
            return self.engine.run_job_lazy(feed_fn, data)
        return self.engine.run_job(feed_fn, data, collect=True)

    def _check_monitor(self):
        if self.monitor is not None:
            self.monitor.check()

    def _feed_epoch_elastic(self, feed_fn, partitions, epoch):
        """Feed one epoch with partition requeue: every partition leads
        with a PartitionStart marker feeding the node's ledger; after a
        restart event, the partitions no checkpoint committed are fed
        again, for at most ``max_restarts`` rounds.  Those include
        partitions of earlier epochs: a feeder may deliver a partition
        just after the checkpoint that holds its rows was committed, and
        a rebirth discards every partition not committed."""
        pending = {"e{0}p{1}".format(epoch, i): p
                   for i, p in enumerate(partitions)}
        seen_restarts = (self.monitor.restart_events
                         if self.monitor is not None else 0)
        max_rounds = 1 + int(self.cluster_meta["max_restarts"])
        for round_no in range(max_rounds):
            if round_no:
                self._await_respawn()
                logger.warning("elastic requeue round %d: re-feeding %d "
                               "uncommitted partition(s): %s", round_no,
                               len(pending), sorted(pending))
            self._uncommitted.update(pending)
            wrapped = [_with_partition_marker(pid, p)
                       for pid, p in sorted(pending.items())]
            handle = self.engine.run_job_async(feed_fn, wrapped)
            while not handle.done():
                self._check_monitor()
                time.sleep(0.2)
            try:
                handle.wait(timeout=0)
            except RuntimeError:
                # a feed task failed mid-restart (it saw the dead
                # incarnation's error queue): the requeue below re-feeds
                # if a rebirth explains it, otherwise the failure is real
                if not self._await_restart_signal(seen_restarts):
                    raise
                logger.warning("feed job failed during an elastic restart; "
                               "requeuing uncommitted partitions",
                               exc_info=True)
            committed = self._ledger_committed()
            self._uncommitted = {pid: p for pid, p
                                 in self._uncommitted.items()
                                 if pid not in committed}
            pending = dict(self._uncommitted)
            if not pending:
                return
            # a rebirth releases blocked feeders before it re-registers
            # under the new generation, so a round can end a beat ahead
            # of the restart signal: settle before concluding that
            # nothing happened (which would skip the requeue)
            if not self._await_restart_signal(seen_restarts):
                logger.info("epoch %d: %d partition(s) fed but not yet "
                            "committed by a checkpoint (no restart "
                            "occurred)", epoch, len(pending))
                return
            seen_restarts = self.monitor.restart_events
        logger.warning("elastic requeue budget exhausted with %d "
                       "partition(s) still uncommitted: %s", len(pending),
                       sorted(pending))

    def _await_restart_signal(self, seen_restarts, window=None):
        """True if a restart event beyond ``seen_restarts`` surfaces
        within the settle window; raises through ``check()`` if the
        monitor declared a permanent failure meanwhile."""
        if self.monitor is None:
            return False
        window = (max(2.0, 4.0 * self.monitor.interval) if window is None
                  else window)
        deadline = time.monotonic() + window
        while True:
            self.monitor.check()
            if self.monitor.restart_events > seen_restarts:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.1)

    def _await_respawn(self):
        """Wait until every compute node has respawned its compute
        process at the cluster's generation.  A rebirth resets the
        node's queues twice and drains its error queue before it
        respawns: a requeue round fed earlier would have its rows thrown
        away by the second reset, or fail on the dead incarnation's
        error.  Bounded by the monitor's recovery window (the monitor
        raises for a node that stays dead)."""
        workers = [n for n in self.cluster_info
                   if n["job_name"] in node.COMPUTE_JOBS]
        deadline = time.monotonic() + self.monitor.recovery_timeout
        while True:
            self.monitor.check()
            want = self.server.generation
            behind = []
            for n in workers:
                try:
                    gen = self._connect(n).get("generation")._getvalue()
                except Exception:  # noqa: BLE001 - node mid-restart
                    gen = None
                if gen is None or gen < want:
                    behind.append(n["executor_id"])
            if not behind:
                return
            if time.monotonic() >= deadline:
                logger.warning("executors %s did not respawn at generation "
                               "%d within the recovery window; requeuing "
                               "anyway", behind, want)
                return
            time.sleep(0.1)

    def _ledger_committed(self):
        """The union of checkpoint-committed partition ids over the
        compute nodes."""
        committed = set()
        for n in self.cluster_info:
            if n["job_name"] not in node.COMPUTE_JOBS:
                continue
            try:
                committed.update(
                    self._connect(n).ledger("committed")._getvalue())
            except Exception:  # noqa: BLE001 - node mid-restart: its
                logger.warning(  # partitions simply stay pending
                    "unable to read the partition ledger of executor %d",
                    n["executor_id"], exc_info=True)
        return committed

    def _run_feed_monitored(self, feed_fn, partitions):
        """Run one feed job while watching the liveness plane: a dead
        executor fails the feed in seconds, naming the node."""
        if self.monitor is None:
            self.engine.run_job(feed_fn, partitions)
            return
        handle = self.engine.run_job_async(feed_fn, partitions)
        while not handle.done():
            self.monitor.check()
            time.sleep(min(0.2, self.monitor.interval / 2.0))
        handle.wait(timeout=0)

    # -- lifecycle -----------------------------------------------------

    def shutdown(self, grace_secs=0, timeout=259200):
        """Stop the cluster and propagate any compute errors.

        Args:
          grace_secs: seconds past end-of-feed that the compute processes
            may take to report completion (at least 60).
          timeout: overall watchdog, seconds.
        """
        deadline = time.monotonic() + timeout
        if self.monitor is not None:
            self.monitor.stop()
        workers = [n for n in self.cluster_info
                   if n["job_name"] in node.COMPUTE_JOBS]
        if self.input_mode == InputMode.TENSORFLOW:
            # foreground fns set their node 'stopped' on return
            self._await_worker_states(workers, deadline)
        else:
            # the end-of-feed sentinel on every feed queue of every worker
            # (never on the error queue: a None there would mask a late
            # failure from _peek_error)
            feed_queues = [q for q in self.queues
                           if q not in ("error", "output")]
            for w in workers:
                m = self._connect(w)
                for qname in feed_queues:
                    try:
                        m.get_queue(qname).put(None, block=True)
                    except Exception:  # noqa: BLE001 - role may lack queue
                        logger.warning(
                            "unable to post end-of-feed sentinel on queue "
                            "%r of executor %d", qname, w["executor_id"],
                            exc_info=True)
            # wait for each compute process to report completion
            self._await_compute_done(
                workers, min(deadline, time.monotonic() + max(grace_secs, 60)))

        # error check: peek-and-requeue per node
        errors = []
        for n in self.cluster_info:
            err = self._peek_error(n)
            if err:
                errors.append((n["executor_id"], err))

        # the start job completes once every foreground task returns
        if self.job_handle is not None:
            remaining = max(5.0, deadline - time.monotonic())
            try:
                self.job_handle.wait(timeout=remaining)
            except TimeoutError:
                logger.warning("cluster start job did not complete in time")
            except RuntimeError as e:
                errors.append(("start-job", str(e)))

        for w in workers:
            try:
                self._connect(w).set("state", "stopped")
            except Exception:  # noqa: BLE001 - node gone: state moot
                logger.warning("unable to mark executor %d stopped during "
                               "shutdown", w["executor_id"], exc_info=True)
        # the nodes' heartbeaters see 'stopped' within an interval and say
        # farewell; stopping the server first would leave them beating at
        # a closed port
        end = time.monotonic() + 3 * self.server.liveness.interval
        while self.server.liveness.tracked() and time.monotonic() < end:
            time.sleep(0.1)
        self.server.stop()
        if self._owns_engine:
            self.engine.stop()
        if errors:
            raise RuntimeError(
                "cluster shutdown detected failures:\n" + "\n".join(
                    "executor {0}: {1}".format(eid, err)
                    for eid, err in errors))
        logger.info("cluster shutdown complete")

    def _await_compute_done(self, workers, deadline):
        pending = {w["executor_id"]: w for w in workers}
        conns = {}
        while pending:
            for eid, w in list(pending.items()):
                try:
                    m = conns.get(eid)
                    if m is None:
                        m = conns[eid] = self._connect(w)
                    state = m.get("compute_state")._getvalue()
                except Exception:  # noqa: BLE001 - transient: retry
                    conns.pop(eid, None)
                    continue
                if state in ("finished", "failed"):
                    pending.pop(eid)
            if not pending:
                return
            if time.monotonic() > deadline:
                logger.warning(
                    "compute processes on executors %s did not report "
                    "completion within the grace window; proceeding with "
                    "shutdown", sorted(pending))
                return
            time.sleep(0.2)

    def _await_worker_states(self, workers, deadline):
        pending = {w["executor_id"]: w for w in workers}
        while pending:
            for eid, w in list(pending.items()):
                try:
                    if str(self._connect(w).get("state")._getvalue()) \
                            == "stopped":
                        pending.pop(eid)
                except Exception:  # noqa: BLE001 - node may be mid-start;
                    pass  # the deadline below bounds the loop
            if not pending:
                return
            if time.monotonic() > deadline:
                raise RuntimeError("timed out waiting for workers {0} to "
                                   "finish".format(sorted(pending)))
            time.sleep(1)

    def _connect(self, node_meta):
        return manager.connect(tuple(node_meta["addr"]),
                               bytes.fromhex(node_meta["authkey"]))

    def _peek_error(self, node_meta):
        try:
            q = self._connect(node_meta).get_queue("error")
            err = q.get(block=False)
            q.task_done()
            q.put(err)
            return err
        except _queue_mod.Empty:
            return None
        except Exception:  # noqa: BLE001 - unreachable node: say which
            logger.warning("unable to check error queue of executor %d "
                           "(%s:%d)", node_meta["executor_id"],
                           node_meta["job_name"], node_meta["task_index"],
                           exc_info=True)
            return None


def _with_partition_marker(pid, partition):
    """A partition led by its PartitionStart marker (lazily for a
    callable partition: its rows still never transit the driver)."""
    if callable(partition):
        return functools.partial(_marked_rows, pid, partition)
    return [PartitionStart(pid)] + list(partition)


def _marked_rows(pid, partition):
    return itertools.chain([PartitionStart(pid)], iter(partition()))


_UNPORTED_RUN_ARGS = {
    "num_ps": (0, "the rest: parameter-server nodes"),
    "driver_ps_nodes": (False, "the rest: parameter-server nodes"),
    "eval_node": (False, "the rest: evaluator nodes"),
    "tensorboard": (False, "the rest: tensorboard"),
    "log_dir": (None, "the rest: tensorboard"),
    "profile_dir": (None, "the rest: profiling"),
    "profile_steps": (None, "the rest: profiling"),
    "plan": (None, "the rest: the planner"),
    "plan_hint": (None, "the rest: the planner"),
}


def run(engine, map_fun, args=None, num_executors=None,
        input_mode=InputMode.SPARK, master_node=None,
        reservation_timeout=600, queues=("input", "output", "error"),
        num_chips_per_node=None, name="tpucluster", heartbeat_interval=None,
        elastic=False, max_restarts=3, recovery_timeout=120.0, **unported):
    """Start a cluster over an executor fleet.

    Args:
      engine: an :class:`~..engine.Engine`, a ``SparkContext`` (wrapped
        in a :class:`~..engine.SparkEngine`), or an int (the number of
        local executor processes to launch).
      map_fun: user function ``main_fun(args, ctx)``; module-level, since
        it travels by ``pickle`` (by reference).
      args: opaque user args handed through to ``map_fun``.
      num_executors: total nodes; defaults to ``engine.num_executors``.
      input_mode: :class:`InputMode`.
      master_node: job name for a dedicated chief (e.g. ``'chief'``).
      reservation_timeout: startup barrier timeout, seconds.
      queues: data queues created on each node.
      num_chips_per_node: GPUs visible per node (``CUDA_VISIBLE_DEVICES``
        set by host-local rank; raises when they cannot be found).
        ``None`` leaves visibility alone.
      heartbeat_interval: seconds between node heartbeats (a node is
        dead after 3 missed intervals).
      elastic: treat a worker's death as recoverable: its supervisor
        respawns the compute process under a new rendezvous generation,
        the survivors park and respawn at the re-rendezvous barrier,
        training resumes from the last checkpoint (the
        ``train_on_feed(checkpointer=...)`` hook), and uncommitted feed
        partitions are requeued.  Default False: a dead worker fails
        the feed at once, naming the node.
      max_restarts: per-node restart budget under ``elastic``.
      recovery_timeout: under ``elastic``, seconds a dead node may take
        to come back before the failure is permanent.

    The reference's other arguments (``num_ps``, ``driver_ps_nodes``,
    ``eval_node``, ``tensorboard``, ``log_dir``, ``profile_dir``,
    ``profile_steps``, ``plan``, ``plan_hint``) are accepted at their
    defaults and raise ``NotImplementedError`` otherwise.
    """
    from ..engine import Engine, LocalEngine, SparkEngine

    for key, val in unported.items():
        if key not in _UNPORTED_RUN_ARGS:
            raise TypeError("run() got an unexpected keyword argument "
                            "{0!r}".format(key))
        default, item = _UNPORTED_RUN_ARGS[key]
        if val != default:
            raise _not_ported("cluster.run {0}=".format(key), item)
    try:
        pickle.dumps(map_fun)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            "map_fun must be a module-level function (the engine ships it "
            "with pickle, by reference): {0}".format(e))

    owns_engine = False
    if isinstance(engine, int):
        if num_executors is not None and num_executors > engine:
            raise ValueError(
                "num_executors ({0}) exceeds the engine's executor count "
                "({1}); the startup barrier would wait forever".format(
                    num_executors, engine))
        engine = LocalEngine(engine)
        owns_engine = True
    elif not isinstance(engine, Engine) and hasattr(engine, "parallelize"):
        engine = SparkEngine(engine)
    if num_executors is None:
        num_executors = engine.num_executors
    if num_executors > engine.num_executors:
        msg = ("num_executors ({0}) exceeds the engine's reported executor "
               "count ({1}); the startup barrier would wait forever".format(
                   num_executors, engine.num_executors))
        if engine.num_executors_exact:
            raise ValueError(msg)
        logger.warning("%s; proceeding anyway", msg)
    num_workers = num_executors - (1 if master_node else 0)
    if num_workers < 0 or (num_workers == 0 and master_node is None):
        raise ValueError("num_executors ({0}) must cover the master node and "
                         "at least one worker".format(num_executors))

    template = node._cluster_template(num_executors, master_node=master_node)
    logger.info("cluster template: %s", template)
    server = reservation.Server(num_executors,
                                heartbeat_interval=heartbeat_interval)
    server_addr = server.start()
    cluster_meta = {
        "id": "{0}-{1}".format(name, uuid.uuid4().hex[:8]),
        "cluster_template": template,
        "num_executors": num_executors,
        "default_fs": engine.default_fs,
        "server_addr": list(server_addr),
        "reservation_timeout": reservation_timeout,
        "queues": list(queues),
        "num_chips_per_node": num_chips_per_node,
        "elastic": bool(elastic),
        "max_restarts": int(max_restarts),
        "heartbeat_interval": heartbeat_interval,
    }
    mapfn = node.run(map_fun, args, cluster_meta, input_mode)
    handle = engine.run_job_async(mapfn, [[i] for i in range(num_executors)])
    try:
        cluster_info = server.await_reservations(
            status=_HandleStatus(handle), timeout=reservation_timeout)
    except Exception:
        server.stop()
        if owns_engine:
            engine.stop()
        raise
    for n in sorted(cluster_info, key=lambda x: x["executor_id"]):
        logger.info("node: executor_id=%d %s:%d on %s", n["executor_id"],
                    n["job_name"], n["task_index"], n["host"])
    cluster = TPUCluster(engine, cluster_meta, cluster_info, server, handle,
                         input_mode, list(queues), owns_engine=owns_engine)
    cluster.monitor = ClusterMonitor(
        server, cluster_info, elastic=elastic,
        recovery_timeout=recovery_timeout,
        error_peek=cluster._peek_error).start()
    return cluster
