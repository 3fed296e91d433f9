"""Per-node compute supervision: spawn, heartbeats, death detection
(port of the JAX package's ``cluster/supervisor.py``, without the
elastic restart loop).

Every compute node runs a :class:`Supervisor` in its executor process.
It spawns the compute process (spawn context: the process that touches
the GPU must not be a fork), and pumps HEARTBEAT frames to the
rendezvous server whose ``compute_alive`` flag turns false the moment
the compute process dies without reporting a clean finish, so the
driver's monitor names the dead executor within a heartbeat.

Not ported (ROADMAP queue A, elastic supervision): rebirth under a new
generation, park/respawn at the re-rendezvous barrier, remediation
holds and the pod-leader election.
"""

import logging
import multiprocessing
import multiprocessing.util
import threading
import time

from . import reservation

logger = logging.getLogger(__name__)

#: Module-level keepalive: supervisors must outlive the start task that
#: created them.
_LOCAL_SUPERVISORS = []


#: Seconds an exiting executor gives its compute processes to exit on
#: their own before ``multiprocessing`` terminates them (daemonic
#: children get SIGTERM at the parent's exit, which can cut a process
#: that is still flushing its output or tearing down CUDA and NCCL).
#: Below ``LocalEngine.stop``'s 5 s wait for the executor itself.
EXIT_GRACE = 4.0


def register_local_supervisor(sup):
    _LOCAL_SUPERVISORS.append(sup)


def _await_compute_exit():
    deadline = time.monotonic() + EXIT_GRACE
    for sup in _LOCAL_SUPERVISORS:
        if sup.proc is None:
            continue
        sup.proc.join(max(0.0, deadline - time.monotonic()))
        if sup.proc.is_alive():
            logger.warning(
                "compute process of executor %d is still running %.0f s "
                "after its executor began to exit; it will be terminated",
                sup.ctx.executor_id, EXIT_GRACE)


# A multiprocessing finalizer, not an atexit hook: an executor that is
# itself a multiprocessing child runs these finalizers, and then
# terminates its daemonic children, as soon as its target returns,
# before any atexit hook.  Priority 10 runs it before the node's queue
# manager shuts down (priority 0), which the exiting compute process may
# still be talking to.
multiprocessing.util.Finalize(None, _await_compute_exit, exitpriority=10)


class Supervisor(object):
    """Watches one node's compute process.

    Args:
      fn_bytes: the pickled user ``main_fun``.
      args: opaque user args.
      ctx: the node's :class:`~.node.NodeContext`.
      mgr: this node's queue-manager proxy.
      cluster_meta: driver metadata dict (``server_addr``,
        ``heartbeat_interval``).
      node_meta: this node's registration record.
    """

    def __init__(self, fn_bytes, args, ctx, mgr, cluster_meta, node_meta):
        self.fn_bytes = fn_bytes
        self.args = args
        self.ctx = ctx
        self.mgr = mgr
        self.node_meta = dict(node_meta)
        self.server_addr = tuple(cluster_meta["server_addr"])
        self.interval = float(cluster_meta.get("heartbeat_interval")
                              or reservation.HEARTBEAT_INTERVAL)
        self.proc = None
        self.heartbeater = None
        self._thread = None

    def start(self):
        """Spawn the compute process, prime the liveness registry, and
        start the watch thread.  Returns self."""
        self._spawn()
        self.heartbeater = reservation.Heartbeater(
            self.server_addr, self.ctx.executor_id, interval=self.interval,
            alive_fn=self._proc_alive, host=self.node_meta.get("host", ""),
        )
        try:
            self.heartbeater.beat_once()
        except Exception as e:  # noqa: BLE001 - periodic beats catch up
            logger.warning("priming heartbeat for executor %d failed: %s",
                           self.ctx.executor_id, e)
        self.heartbeater.start()
        self._thread = threading.Thread(
            target=self._watch, daemon=True,
            name="supervisor-%d" % self.ctx.executor_id)
        self._thread.start()
        return self

    def _proc_alive(self):
        """What the heartbeat's ``compute_alive`` flag reports.  A process
        that exited after marking itself 'finished' is a clean completion,
        not a death (it marks before it exits, so a clean finish never
        reads as dead)."""
        if self.proc is not None and self.proc.is_alive():
            return True
        try:
            return self.mgr.get("compute_state")._getvalue() == "finished"
        except Exception:  # noqa: BLE001 - manager gone = node dying
            return False

    def _spawn(self):
        from .node import _compute_process_main

        proc = multiprocessing.get_context("spawn").Process(
            target=_compute_process_main,
            args=(self.fn_bytes, self.args, self.ctx),
            daemon=True,
            name="compute-%s-%d" % (self.ctx.job_name, self.ctx.task_index),
        )
        proc.start()
        self.proc = proc
        try:
            self.mgr.set("compute_pid", proc.pid)
        except Exception:  # noqa: BLE001 - kv is observability, not control
            logger.warning("unable to record compute pid for executor %d",
                           self.ctx.executor_id, exc_info=True)
        logger.info("spawned compute process pid=%d for executor %d",
                    proc.pid, self.ctx.executor_id)

    def _node_state(self):
        try:
            return str(self.mgr.get("state")._getvalue())
        except Exception:  # noqa: BLE001 - manager down = executor dying
            return "unknown"

    def _watch(self):
        self.proc.join()
        # a node that is shutting down (or whose manager is gone) has
        # nothing left to report; silence speaks for a lost node
        if self._node_state() == "running" and not self._proc_alive():
            logger.error(
                "compute process of executor %d died (exitcode %s); the "
                "driver monitor will fail the run",
                self.ctx.executor_id, self.proc.exitcode)
            # one immediate compute_alive=False beat: the monitor learns
            # of the death now instead of after the miss threshold
            try:
                self.heartbeater.beat_once()
            except Exception:  # noqa: BLE001 - silence also signals death
                pass
        # heartbeats stay up until the node is told to stop, so the
        # driver can still tell 'compute done' from 'node gone'
        while self._node_state() not in ("stopped", "terminating", "unknown"):
            time.sleep(self.interval)
        self.heartbeater.stop()
