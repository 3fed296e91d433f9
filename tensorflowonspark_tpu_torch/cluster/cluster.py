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

The fleet's observability rides the heartbeats: ``metrics()`` merges
the executors' registry snapshots, ``journal()`` returns their typed
events with the clock offsets that align them (the driver's own events
included), ``collect_dumps()`` the flight recorders' dump indexes, and
``start_health_plane()`` runs the windowed time series, SLO rules and
straggler diagnosis over them, with its HTTP surface.
``run(profile_dir=, profile_steps=)`` captures a ``torch.profiler``
trace in each compute process of that cluster.

The source system's own roles: ``num_ps`` parameter-server nodes (or,
with ``driver_ps_nodes``, shards in the driver process), an
``eval_node``, and a managed TensorBoard (``tensorboard``, ``log_dir``)
whose URL ``tensorboard_url()`` gives.  ``shutdown`` stops TensorBoard
and releases the service nodes' control loops after its error check.

Not ported (ROADMAP queue A): remediation holds (``hold_executor``,
``release_executor``) and the planner (``plan``, ``plan_hint``).
"""

import functools
import itertools
import logging
import os
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

    Journal marks: ``executor_restart`` for each generation step (with
    the ``cluster.restart_events`` counter), ``executor_dead`` (page) for
    a permanent failure, and, under ``elastic``, ``executor_dead`` (warn,
    ``recoverable``) once per death: the driver's sight of it.  A death
    stays open until the executor has been seen alive for longer than
    the liveness deadline, so the rebirth's liveness prime (alive at the
    new generation while the node parks, then dead again until the
    respawn) reopens the recovery window, as the reference's does, but
    marks nothing new.
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
        #: the health plane's straggler hints, newest per executor
        self.health_hints = {}
        self._by_id = {n["executor_id"]: n for n in cluster_info}
        self._first_dead = {}
        #: executor -> when its open death was last seen alive (None
        #: while dead): one recoverable mark per death
        self._open_deaths = {}
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
        from .. import telemetry

        for eid_s, rec in self.server.liveness.snapshot().items():
            eid = int(eid_s)
            known = self._known_gen.get(eid, 0)
            if rec["generation"] > known:
                self.restart_events += rec["generation"] - known
                self._known_gen[eid] = rec["generation"]
                logger.info("monitor: executor %d reborn at generation %d",
                            eid, rec["generation"])
                telemetry.get_registry().counter(
                    "cluster.restart_events").inc(rec["generation"] - known)
                telemetry.get_tracer().mark(
                    "executor_restart", trace="executor%d" % eid,
                    severity="warn", executor_id=eid,
                    generation=rec["generation"])
        dead = self.server.liveness.dead()
        now = time.monotonic()
        for eid in list(self._first_dead):
            if eid not in dead:
                logger.info("monitor: executor %d recovered", eid)
                self._first_dead.pop(eid)
        for eid, alive_since in list(self._open_deaths.items()):
            if eid in dead:
                self._open_deaths[eid] = None
            elif alive_since is None:
                self._open_deaths[eid] = now
            elif now - alive_since > self.server.liveness.deadline:
                self._open_deaths.pop(eid)
        for eid, diag in sorted(dead.items()):
            if not self.elastic:
                self._fail(eid, diag)
                return
            if eid not in self._open_deaths:
                # a new death: the driver's sight of it
                self._open_deaths[eid] = None
                telemetry.get_tracer().mark(
                    "executor_dead", trace="executor%d" % eid,
                    severity="warn", executor_id=eid,
                    reason=diag["reason"], host=diag.get("host") or "?",
                    recoverable=True, window=self.recovery_timeout)
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
        from .. import telemetry

        telemetry.get_tracer().mark(
            "executor_dead", trace="executor%d" % eid, severity="page",
            executor_id=eid, reason=diag["reason"],
            host=diag.get("host") or node_meta.get("host", "?"))
        self.error = msg
        self.dead_executor_id = eid

    def check(self):
        """Raise :class:`DeadExecutorError` if a permanent failure was
        detected; feed loops call it every poll."""
        if self.error is not None:
            raise DeadExecutorError(self.error, self.dead_executor_id)

    def note_straggler(self, hint):
        """Record a health-plane straggler hint (advisory: nothing is
        killed while the flagged node is profiled)."""
        self.health_hints[hint["executor"]] = dict(hint)
        logger.warning(
            "monitor: health plane flagged executor %s as a straggler "
            "(dominant phase %r, +%.3fs/step vs the fleet)",
            hint.get("executor"), hint.get("phase"),
            hint.get("excess_sec", 0.0))

    def clear_straggler(self, executor_id):
        """Drop a recovered executor's straggler hint."""
        if self.health_hints.pop(int(executor_id), None) is not None:
            logger.info("monitor: health plane cleared the straggler flag "
                        "on executor %s", executor_id)

    def metrics(self):
        """Each executor's newest telemetry snapshot with its liveness
        and clock: ``{executor_id: {"metrics", "metrics_age",
        "heartbeat_age", "generation", "compute_alive", "host",
        "clock_offset", "clock_rtt"}}`` (the fields known so far)."""
        store = self.server.metrics.snapshot()
        liveness = self.server.liveness.snapshot()
        clocks = self.server.clocks.snapshot()
        per = {}
        for eid_s in set(store) | set(liveness):
            rec = {}
            s = store.get(eid_s)
            if s is not None:
                rec["metrics"] = s["metrics"]
                rec["metrics_age"] = s["age"]
            lv = liveness.get(eid_s)
            if lv is not None:
                rec["heartbeat_age"] = lv["age"]
                rec["generation"] = lv["generation"]
                rec["compute_alive"] = lv["compute_alive"]
                rec["host"] = lv["host"]
            clk = clocks.get(eid_s)
            if clk is not None:
                # seconds to add to this executor's wall timestamps to
                # put them on the driver's clock
                rec["clock_offset"] = clk["offset"]
                rec["clock_rtt"] = clk["rtt"]
            per[int(eid_s)] = rec
        return per

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
                 monitor=None, driver_ps=None):
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
        #: the health plane (:meth:`start_health_plane`)
        self.health = None
        self._profile_seq = itertools.count(1)
        #: parameter-server shards hosted in this process (driver_ps_nodes)
        self._driver_ps = list(driver_ps or [])

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
        if self.health is not None:
            from ..telemetry import health as _health

            self.health.stop()
            _health.unregister_status_provider("ledger")
            self.health = None
        if self.monitor is not None:
            self.monitor.stop()
        workers = [n for n in self.cluster_info
                   if n["job_name"] in node.COMPUTE_JOBS]
        services = [n for n in self.cluster_info
                    if n["job_name"] in node.SERVICE_JOBS]
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

        self._stop_tensorboard()
        # release the ps/evaluator control loops
        for n in services:
            try:
                self._connect(n).get_queue("control").put(None, block=True)
            except Exception:  # noqa: BLE001 - node may be gone already
                logger.warning("unable to post shutdown to %s:%d "
                               "(executor %d)", n["job_name"],
                               n["task_index"], n["executor_id"],
                               exc_info=True)

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
        for shard in self._driver_ps:
            shard.stop()
        self.server.stop()
        if self._owns_engine:
            self.engine.stop()
        if errors:
            raise RuntimeError(
                "cluster shutdown detected failures:\n" + "\n".join(
                    "executor {0}: {1}".format(eid, err)
                    for eid, err in errors))
        logger.info("cluster shutdown complete")

    def _stop_tensorboard(self):
        """SIGTERM the cluster's TensorBoard when it runs on this host
        (elsewhere it exits with its executor)."""
        import signal

        from ..utils.net import get_ip_address

        me = get_ip_address()
        for n in self.cluster_info:
            if not n.get("tb_pid"):
                continue
            if n["host"] == me:
                try:
                    os.kill(n["tb_pid"], signal.SIGTERM)
                except OSError:
                    pass
            else:
                logger.info("tensorboard on %s pid %d exits with its "
                            "executor", n["host"], n["tb_pid"])

    def tensorboard_url(self):
        """The URL of the cluster's TensorBoard, or None."""
        for n in self.cluster_info:
            if n.get("tb_port"):
                return "http://{0}:{1}".format(n["host"], n["tb_port"])
        return None

    # -- observability ---------------------------------------------------

    def metrics(self, include_ledger=True):
        """The fleet's telemetry: every executor's newest registry
        snapshot (shipped on its heartbeats) with its liveness and clock
        fields and, with ``include_ledger``, each worker's committed and
        pending partition counts, folded into one fleet snapshot.

        Returns ``{"executors": {executor_id: {...}}, "fleet": merged
        snapshot, "restart_events": int, "generation": int}``; the
        health plane's alert history rides ``fleet["alert_history"]``
        while a plane runs.  A remote observer gets the same snapshots
        through ``reservation.Client(addr).get_metrics()``.
        """
        from ..telemetry import aggregate

        monitor = self.monitor or ClusterMonitor(self.server,
                                                 self.cluster_info)
        per = monitor.metrics()
        if include_ledger:
            for eid, counts in self._ledger_counts().items():
                per.setdefault(eid, {})["ledger"] = counts
        view = aggregate.fleet_view(per)
        view["restart_events"] = (
            self.monitor.restart_events if self.monitor is not None else 0)
        view["generation"] = self.server.generation
        if self.health is not None and self.health.slo is not None:
            view["fleet"]["alert_history"] = self.health.slo.alert_history()
        return view

    def _ledger_counts(self):
        """``{executor_id: {"committed": n, "pending": n}}`` of the
        workers reachable now (a node mid-restart is left out)."""
        out = {}
        for n in self.cluster_info:
            if n["job_name"] not in node.COMPUTE_JOBS:
                continue
            try:
                m = self._connect(n)
                out[n["executor_id"]] = {
                    "committed": len(m.ledger("committed")._getvalue()),
                    "pending": len(m.ledger("pending")._getvalue()),
                }
            except Exception:  # noqa: BLE001 - node mid-restart or gone
                continue
        return out

    def journal(self, limit=None):
        """The fleet's typed-event record: every executor's journal
        events (shipped on the heartbeats) and the driver's own, time
        ordered, with the per-executor clock offsets that put them on the
        driver's clock: ``{"events": [event dicts], "clocks": {executor:
        {"offset", "rtt"}}}``."""
        return {
            "events": self.server.events.snapshot(limit=limit),
            "clocks": self.server.clocks.snapshot(),
        }

    def collect_dumps(self, dest=None):
        """Every node's flight-recorder dump index (its ``blackbox_dumps``
        kv): ``{executor_id: [dump records]}``.  With ``dest``, the bundle
        files reachable from this host are copied there too."""
        out = {}
        for n in self.cluster_info:
            try:
                recs = self._connect(n).get("blackbox_dumps")._getvalue()
            except Exception:  # noqa: BLE001 - node mid-restart or gone
                continue
            if isinstance(recs, list) and recs:
                out[n["executor_id"]] = recs
        if dest is not None:
            import shutil

            os.makedirs(dest, exist_ok=True)
            for recs in out.values():
                for rec in recs:
                    path = rec.get("path")
                    if path and os.path.exists(path):
                        try:
                            shutil.copy2(path, dest)
                        except OSError:
                            logger.warning("unable to copy dump %s", path,
                                           exc_info=True)
        return out

    def start_health_plane(self, port=None, slo=None, interval=None,
                           window=None, straggler=True,
                           straggler_opts=None, profile_steps=20,
                           profile_dir=None):
        """Start the standing health plane over this cluster.

        It scrapes the monitor's per-executor telemetry every
        ``interval`` seconds into windowed time series, evaluates the
        ``slo`` rules (anything ``telemetry.health.load_rules`` takes),
        diagnoses stragglers, and asks a flagged node (that one alone)
        for a ``profile_steps``-step capture into ``profile_dir`` (default
        ``<tmp>/tfos_health_profiles/<cluster id>``).  ``port`` (0: any
        free port) also starts the HTTP surface (``/metrics``,
        ``/healthz``, ``/status``, ``/usage``, ``/journal``).  Returns the
        :class:`~..telemetry.health.HealthPlane`; :meth:`shutdown` stops
        it.
        """
        from ..telemetry import health as _health

        if self.health is not None:
            return self.health
        monitor = self.monitor or ClusterMonitor(self.server,
                                                 self.cluster_info)
        if profile_dir is None:
            import tempfile

            profile_dir = os.path.join(tempfile.gettempdir(),
                                       "tfos_health_profiles",
                                       self.cluster_id)

        def on_straggler(hint):
            monitor.note_straggler(hint)
            self._request_profile(hint["executor"], steps=profile_steps,
                                  log_dir=profile_dir, hint=hint)

        def on_straggler_cleared(eid):
            monitor.clear_straggler(eid)
            self._clear_health_hint(eid)

        plane = _health.HealthPlane(
            monitor.metrics, interval=interval, window=window, slo=slo,
            straggler=straggler, straggler_opts=straggler_opts,
            on_straggler=on_straggler,
            on_straggler_cleared=on_straggler_cleared,
            liveness_fn=self.server.liveness.health,
            journal_fn=self.journal,
        )
        _health.register_status_provider("ledger", self._ledger_status)
        plane.start()
        if port is not None:
            plane.serve(port=port)
        self.health = plane
        return plane

    def _ledger_status(self):
        """Per-worker committed/pending partition counts for ``/status``
        (an unreachable worker reads ``{"unreachable": True}``)."""
        counts = self._ledger_counts()
        return {str(n["executor_id"]): counts.get(n["executor_id"],
                                                  {"unreachable": True})
                for n in self.cluster_info
                if n["job_name"] in node.COMPUTE_JOBS}

    def _node_meta(self, executor_id):
        return next((n for n in self.cluster_info
                     if n["executor_id"] == int(executor_id)), None)

    def _request_profile(self, executor_id, steps=20, log_dir=None,
                         hint=None):
        """Ask one node for a capture: a sequenced ``profile_request`` in
        its kv, which its compute process's ``NodePublisher`` serves and
        acknowledges in ``profile_state``; a straggler ``hint`` is written
        beside it (``health_hint``), which its beats then flag.  Returns
        the request, or None when it could not be delivered."""
        node_meta = self._node_meta(executor_id)
        if node_meta is None:
            logger.warning("profile request for unknown executor %s",
                           executor_id)
            return None
        req = {"seq": next(self._profile_seq), "log_dir": log_dir,
               "steps": int(steps) if steps else None}
        try:
            m = self._connect(node_meta)
            m.set("profile_request", req)
            if hint is not None:
                m.set("health_hint", dict(hint))
        except Exception:  # noqa: BLE001 - node mid-restart: the hint
            logger.warning(  # stands, the capture is lost
                "unable to deliver profile request to executor %s",
                executor_id, exc_info=True)
            return None
        logger.info("profile request %d delivered to executor %s (%s, %s "
                    "steps)", req["seq"], executor_id, log_dir, steps)
        return req

    def _clear_health_hint(self, executor_id):
        """Erase a recovered node's ``health_hint`` kv, so its beats stop
        flagging ``health.straggler``."""
        node_meta = self._node_meta(executor_id)
        if node_meta is None:
            return
        try:
            self._connect(node_meta).set("health_hint", None)
        except Exception:  # noqa: BLE001 - node mid-restart: the flag
            logger.warning(  # clears at its next rebirth
                "unable to clear health hint on executor %s", executor_id,
                exc_info=True)

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
    "plan": (None, "the rest: the planner"),
    "plan_hint": (None, "the rest: the planner"),
}


def run(engine, map_fun, args=None, num_executors=None, num_ps=0,
        tensorboard=False, input_mode=InputMode.SPARK, log_dir=None,
        driver_ps_nodes=False, master_node=None, reservation_timeout=600,
        queues=("input", "output", "error"), eval_node=False,
        num_chips_per_node=None, name="tpucluster", heartbeat_interval=None,
        elastic=False, max_restarts=3, recovery_timeout=120.0,
        profile_dir=None, profile_steps=None, **unported):
    """Start a cluster over an executor fleet.

    Args:
      engine: an :class:`~..engine.Engine`, a ``SparkContext`` (wrapped
        in a :class:`~..engine.SparkEngine`), or an int (the number of
        local executor processes to launch).
      map_fun: user function ``main_fun(args, ctx)``; module-level, since
        it travels by ``pickle`` (by reference).
      args: opaque user args handed through to ``map_fun``.
      num_executors: total nodes; defaults to ``engine.num_executors``.
      num_ps: parameter-server nodes (their fn runs
        ``parallel.ps.run_server(ctx)``).
      tensorboard: start TensorBoard on the chief, else on ``worker:0``
        (:meth:`TPUCluster.tensorboard_url`).
      input_mode: :class:`InputMode`.
      log_dir: TensorBoard's log directory.
      driver_ps_nodes: host the ``num_ps`` shards in this process
        instead of on executors; ``ctx.cluster_spec["ps"]`` names their
        addresses and every executor runs a worker.
      master_node: job name for a dedicated chief (e.g. ``'chief'``).
      reservation_timeout: startup barrier timeout, seconds.
      queues: data queues created on each compute node.
      eval_node: dedicate one node as ``'evaluator'`` (a service node,
        like a ps node).
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
      profile_dir: capture a ``torch.profiler`` trace (CUDA kernels
        included) in every compute process of this cluster into
        ``profile_dir/<pid>``.  The compute processes get
        ``TFOS_PROFILE_DIR``/``TFOS_PROFILE_STEPS`` in their own
        environment; the driver's and the executors' stay untouched, so
        a later cluster profiles nothing unless it asks too.  A capture
        that cannot start fails the compute process.
      profile_steps: stop each capture after this many train steps
        (None: when the compute process ends).

    The reference's ``plan`` and ``plan_hint`` are accepted at their
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
    # driver-hosted shards take no executor; they start only after the
    # checks, so a failed run() leaks no socket
    use_driver_ps = driver_ps_nodes and num_ps > 0
    num_ps_exec = 0 if use_driver_ps else num_ps
    num_special = (num_ps_exec + (1 if master_node else 0)
                   + (1 if eval_node else 0))
    num_workers = num_executors - num_special
    if num_workers < 0 or (num_workers == 0 and master_node is None):
        if owns_engine:
            engine.stop()
        raise ValueError(
            "num_executors ({0}) must cover {1} ps + {2} master + {3} "
            "evaluator nodes and at least one worker".format(
                num_executors, num_ps, 1 if master_node else 0,
                1 if eval_node else 0))

    template = node._cluster_template(num_executors, num_ps_exec,
                                      master_node=master_node,
                                      eval_node=eval_node)
    logger.info("cluster template: %s", template)
    driver_ps, driver_ps_addrs = [], []
    if use_driver_ps:
        from ..parallel.ps import ParamServerShard
        from ..utils.net import get_ip_address

        host = get_ip_address()
        for _ in range(num_ps):
            shard = ParamServerShard()
            _, port = shard.start("")
            driver_ps.append(shard)
            driver_ps_addrs.append("{0}:{1}".format(host, port))
        logger.info("driver-hosted ps shards at %s", driver_ps_addrs)
    server = reservation.Server(num_executors,
                                heartbeat_interval=heartbeat_interval)
    server_addr = server.start()
    # the driver's own fault events ride no heartbeat: its journal feeds
    # the fleet's EventStore directly (executor -1)
    server.attach_local_journal()
    cluster_meta = {
        "id": "{0}-{1}".format(name, uuid.uuid4().hex[:8]),
        "cluster_template": template,
        "num_executors": num_executors,
        "default_fs": engine.default_fs,
        "server_addr": list(server_addr),
        "reservation_timeout": reservation_timeout,
        "queues": list(queues),
        "num_chips_per_node": num_chips_per_node,
        "driver_ps_addrs": driver_ps_addrs,
        "elastic": bool(elastic),
        "max_restarts": int(max_restarts),
        "heartbeat_interval": heartbeat_interval,
        "profile": ({"dir": os.path.abspath(str(profile_dir)),
                     "steps": int(profile_steps) if profile_steps else None}
                    if profile_dir else None),
    }
    mapfn = node.run(map_fun, args, cluster_meta, input_mode,
                     log_dir=log_dir, tensorboard=tensorboard)
    handle = engine.run_job_async(mapfn, [[i] for i in range(num_executors)])
    try:
        cluster_info = server.await_reservations(
            status=_HandleStatus(handle), timeout=reservation_timeout)
    except Exception:
        for shard in driver_ps:
            shard.stop()
        server.stop()
        if owns_engine:
            engine.stop()
        raise
    for n in sorted(cluster_info, key=lambda x: x["executor_id"]):
        logger.info("node: executor_id=%d %s:%d on %s", n["executor_id"],
                    n["job_name"], n["task_index"], n["host"])
    cluster = TPUCluster(engine, cluster_meta, cluster_info, server, handle,
                         input_mode, list(queues), owns_engine=owns_engine,
                         driver_ps=driver_ps)
    cluster.monitor = ClusterMonitor(
        server, cluster_info, elastic=elastic,
        recovery_timeout=recovery_timeout,
        error_peek=cluster._peek_error).start()
    if tensorboard:
        url = cluster.tensorboard_url()
        if url:
            logger.info("TensorBoard running at: %s", url)
    return cluster
