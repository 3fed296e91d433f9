"""High-level cluster API: turn an executor fleet into a training
cluster (port of the JAX package's ``cluster/cluster.py``; original:
tensorflowonspark/TFCluster.py).

:func:`run` launches the user's ``main_fun(args, ctx)`` on every
executor, coordinates startup through the rendezvous server, and
returns a :class:`TPUCluster` handle with ``train`` and ``shutdown``.
Shutdown is driver-direct: every node manager is reachable over TCP, so
the driver posts the end-of-feed sentinels and collects errors itself.
A :class:`ClusterMonitor` watches the heartbeat registry and fails the
feed within seconds of a worker's death, naming the executor.

Not ported (ROADMAP queue A): ``elastic=True`` with partition requeue,
parameter-server and evaluator nodes (``num_ps``, ``driver_ps_nodes``,
``eval_node``), the planner (``plan``), profiling and tensorboard,
``train_stream``/``train_dstream``, ``inference``, and the health,
remediation and journal planes.
"""

import logging
import pickle
import queue as _queue_mod
import threading
import time
import uuid

from . import manager, node, reservation
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
    heartbeat registry (non-elastic: the first dead executor is a
    permanent failure).

    Polls ``server.liveness`` every half heartbeat interval; :meth:`check`
    then raises :class:`DeadExecutorError` naming the node, with the
    node's error-queue traceback when one is reachable.
    """

    def __init__(self, server, cluster_info, error_peek=None):
        self.server = server
        self.cluster_info = cluster_info
        self.error = None
        self.dead_executor_id = None
        self._by_id = {n["executor_id"]: n for n in cluster_info}
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
        for eid, diag in sorted(self.server.liveness.dead().items()):
            self._fail(eid, diag)
            return

    def _fail(self, eid, diag):
        node_meta = self._by_id.get(eid, {})
        msg = ("executor {0} (host {1}, {2}:{3}) declared dead: {4} "
               "[last heartbeat {5:.1f}s ago]".format(
                   eid, diag.get("host") or node_meta.get("host", "?"),
                   node_meta.get("job_name", "?"),
                   node_meta.get("task_index", "?"),
                   diag["reason"], diag["age"]))
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
        """Raise :class:`DeadExecutorError` if a failure was detected."""
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
        #: liveness watcher (started by run())
        self.monitor = monitor

    # -- data plane ----------------------------------------------------

    def train(self, data, num_epochs=1, feed_timeout=600, qname="input"):
        """Feed a dataset to the cluster for training.

        Args:
          data: a list of partitions, each a row list or a zero-arg
            callable returning rows (generated on the executors).
          num_epochs: epochs are fed by re-running the feed job.
          feed_timeout: seconds a feed task waits for its rows to be
            consumed before it fails.
        """
        assert self.input_mode == InputMode.SPARK, (
            "train() requires InputMode.SPARK")
        assert num_epochs >= 1
        feed_fn = node.train(self.cluster_info, self.cluster_meta,
                             feed_timeout, qname)
        # normalize once so generators of partitions survive re-feeding
        data = [p if callable(p) else list(p) for p in data]
        logger.info("feeding %d partitions x %d epochs", len(data),
                    num_epochs)
        for _ in range(num_epochs):
            self._run_feed_monitored(feed_fn, data)

    def train_stream(self, batches, feed_timeout=600, qname="input"):
        raise _not_ported("TPUCluster.train_stream",
                          "inference and train_stream")

    def train_dstream(self, dstream, feed_timeout=600, qname="input"):
        raise _not_ported("TPUCluster.train_dstream",
                          "inference and train_stream")

    def inference(self, data, feed_timeout=600, qname="input", lazy=False):
        raise _not_ported("TPUCluster.inference",
                          "inference and train_stream")

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


_ELASTIC = "elastic supervision with PartitionLedger"
_UNPORTED_RUN_ARGS = {
    "num_ps": (0, "the rest: parameter-server nodes"),
    "driver_ps_nodes": (False, "the rest: parameter-server nodes"),
    "eval_node": (False, "the rest: evaluator nodes"),
    "tensorboard": (False, "the rest: tensorboard"),
    "log_dir": (None, "the rest: tensorboard"),
    "elastic": (False, _ELASTIC),
    "max_restarts": (3, _ELASTIC),
    "recovery_timeout": (120.0, _ELASTIC),
    "profile_dir": (None, "the rest: profiling"),
    "profile_steps": (None, "the rest: profiling"),
    "plan": (None, "the rest: the planner"),
    "plan_hint": (None, "the rest: the planner"),
}


def run(engine, map_fun, args=None, num_executors=None,
        input_mode=InputMode.SPARK, master_node=None,
        reservation_timeout=600, queues=("input", "output", "error"),
        num_chips_per_node=None, name="tpucluster", heartbeat_interval=None,
        **unported):
    """Start a cluster over an executor fleet.

    Args:
      engine: an :class:`~..engine.Engine`, or an int (the number of
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

    The reference's other arguments (``num_ps``, ``driver_ps_nodes``,
    ``eval_node``, ``tensorboard``, ``log_dir``, ``elastic``,
    ``max_restarts``, ``recovery_timeout``, ``profile_dir``,
    ``profile_steps``, ``plan``, ``plan_hint``) are accepted at their
    defaults and raise ``NotImplementedError`` otherwise.
    """
    from ..engine import LocalEngine

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
    cluster.monitor = ClusterMonitor(server, cluster_info,
                                     error_peek=cluster._peek_error).start()
    return cluster
