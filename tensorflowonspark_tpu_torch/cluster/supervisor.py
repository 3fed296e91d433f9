"""Per-node compute supervision: spawn, heartbeats, the elastic restart
loop (port of the JAX package's ``cluster/supervisor.py``).

Every compute node runs a :class:`Supervisor` in its executor process.
It spawns the compute process (spawn context: the process that touches
the GPU must not be a fork) and pumps HEARTBEAT frames to the rendezvous
server, whose ``compute_alive`` flag turns false the moment the compute
process dies without reporting a clean finish, so the driver's monitor
names the dead executor within a heartbeat.

With ``elastic=True`` a death is a recoverable event:

- the node's supervisor performs a **rebirth**: it claims the next
  *generation* from the rendezvous server, resets the node's queues
  (releasing feeders blocked on ``join()`` for rows the dead process
  popped), re-registers under the new generation, parks at the
  **re-rendezvous barrier** until every compute peer reports that
  generation, and respawns the compute process with
  ``ctx.generation = N+1``, whose ``train_on_feed(checkpointer=...)``
  restores the last checkpoint;
- the survivors see the raised generation on their heartbeat replies,
  stop their compute processes (a process inside a collective that waits
  for the dead rank never returns on its own) and take the same park,
  reset and respawn path, so the whole cluster resumes from one
  checkpoint step in a new process group;
- partitions the dead incarnation consumed past the last checkpoint
  stay uncommitted in the node's :class:`~.manager.PartitionLedger`,
  and the driver requeues them (at-least-once delivery).

State machine::

    RUNNING --proc dies, elastic, budget left--> REBIRTH
    RUNNING --peer generation raised-----------> PARK
    REBIRTH --new generation from server-------> PARK
    PARK    --all peers at generation G--------> RESPAWN --> RUNNING
    RUNNING --proc dies, budget exhausted------> FAILED (error queued)
    RUNNING --proc exits, state stopped--------> DONE

A respawn keeps the executor's ``CUDA_VISIBLE_DEVICES``: the card is
never looked up again (the dead process's memory may not be freed yet).

Not ported (ROADMAP queue A, item 14): remediation holds and the
pod-leader election of the hierarchical parameter server; the restart
telemetry marks (item 12).
"""

import logging
import multiprocessing
import multiprocessing.util
import os
import threading
import time

from . import manager, reservation

logger = logging.getLogger(__name__)

#: Seconds a supervisor waits at the re-rendezvous barrier before going
#: on alone (a permanently lost peer is the driver monitor's failure to
#: report, not a reason to wedge the survivors).
BARRIER_TIMEOUT = float(os.environ.get("TFOS_REBIRTH_BARRIER_TIMEOUT", "60"))

#: Seconds between the two queue-reset passes of a rebirth.  A consumer
#: that died inside a proxied ``get()`` leaves a thread in the manager
#: server that swallows one later item without acknowledging it;
#: ``DataFeed`` bounds its gets at 1 s, so that thread is gone once this
#: grace has passed, and the second pass zeroes what it swallowed.
ZOMBIE_GRACE = 1.2

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
    """Watches one node's compute process; restarts it when elastic.

    Args:
      fn_bytes: the pickled user ``main_fun`` (respawns need it again).
      args: opaque user args.
      ctx: the node's :class:`~.node.NodeContext`.
      mgr: this node's queue-manager proxy.
      cluster_meta: driver metadata dict (``server_addr``, ``elastic``,
        ``max_restarts``, ``heartbeat_interval``, ``queues``).
      compute_eids: executor ids of every compute node: the members of
        the re-rendezvous barrier.
      node_meta: this node's registration record (sent again on a
        rebirth, with ``generation`` added).
    """

    def __init__(self, fn_bytes, args, ctx, mgr, cluster_meta, compute_eids,
                 node_meta):
        self.fn_bytes = fn_bytes
        self.args = args
        self.ctx = ctx
        self.mgr = mgr
        self.cluster_meta = cluster_meta
        self.compute_eids = sorted(compute_eids)
        self.node_meta = dict(node_meta)
        self.server_addr = tuple(cluster_meta["server_addr"])
        self.elastic = bool(cluster_meta.get("elastic", False))
        self.max_restarts = int(cluster_meta["max_restarts"])
        self.interval = float(cluster_meta.get("heartbeat_interval")
                              or reservation.HEARTBEAT_INTERVAL)
        self.generation = 0
        self.restarts = 0
        self.proc = None
        self.heartbeater = None
        self._thread = None

    # -- lifecycle -----------------------------------------------------

    def start(self):
        """Spawn the compute process, prime the liveness registry, and
        start the watch thread.  Returns self."""
        self._spawn()
        self.heartbeater = reservation.Heartbeater(
            self.server_addr, self.ctx.executor_id, interval=self.interval,
            alive_fn=self._proc_alive, generation_fn=lambda: self.generation,
            host=self.node_meta.get("host", ""),
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

        self.ctx.generation = self.generation
        proc = multiprocessing.get_context("spawn").Process(
            target=_compute_process_main,
            args=(self.fn_bytes, self.args, self.ctx),
            daemon=True,
            name="compute-%s-%d-gen%d" % (self.ctx.job_name,
                                          self.ctx.task_index,
                                          self.generation),
        )
        proc.start()
        self.proc = proc
        try:
            self.mgr.set("compute_pid", proc.pid)
            self.mgr.set("generation", self.generation)
            self.mgr.set("restarts", self.restarts)
        except Exception:  # noqa: BLE001 - kv is observability, not control
            logger.warning("unable to record compute pid/generation for "
                           "executor %d", self.ctx.executor_id, exc_info=True)
        logger.info("spawned compute process pid=%d for executor %d "
                    "generation %d", proc.pid, self.ctx.executor_id,
                    self.generation)

    # -- watch loop ----------------------------------------------------

    def _node_state(self):
        try:
            return str(self.mgr.get("state")._getvalue())
        except Exception:  # noqa: BLE001 - manager down = executor dying
            return "unknown"

    def _watch(self):
        while True:
            self.proc.join(timeout=self.interval / 2.0)
            if not self.proc.is_alive():
                if self._node_state() in ("terminating", "stopped",
                                          "unknown"):
                    break  # orderly teardown, nothing to supervise
                try:
                    compute_state = self.mgr.get("compute_state")._getvalue()
                except Exception:  # noqa: BLE001 - manager going down:
                    compute_state = None  # take the abnormal-death path
                if compute_state == "finished":
                    break  # clean completion
                if not self.elastic:
                    logger.error(
                        "compute process of executor %d died (exitcode %s) "
                        "and elastic=False; the driver monitor will fail "
                        "the run", self.ctx.executor_id, self.proc.exitcode)
                    self._final_beat()
                    break
                if self.restarts >= self.max_restarts:
                    self._give_up()
                    break
                self._rebirth()
                continue
            # proc alive: did a peer's rebirth raise the generation?
            peer_gen = self.heartbeater.cluster_generation
            if self.elastic and peer_gen > self.generation:
                logger.info("executor %d parking: a peer's rebirth raised "
                            "the cluster generation to %d (own %d)",
                            self.ctx.executor_id, peer_gen, self.generation)
                self._park_and_respawn(peer_gen)
        # heartbeats stay up until the node is told to stop, so the
        # driver can still tell 'compute done' from 'node gone'
        self._await_stop_then_quiesce()

    def _final_beat(self):
        """One immediate compute_alive=False beat: the monitor learns of
        the death now instead of after the miss threshold."""
        try:
            self.heartbeater.beat_once()
        except Exception:  # noqa: BLE001 - silence also signals death
            pass

    def _give_up(self):
        msg = ("compute process of executor {0} died {1} times (restart "
               "budget {2} exhausted); last exitcode {3}".format(
                   self.ctx.executor_id, self.restarts + 1,
                   self.max_restarts, self.proc.exitcode))
        logger.error(msg)
        try:
            self.mgr.get_queue("error").put(msg)
            self.mgr.set("compute_state", "failed")
        except Exception:  # noqa: BLE001 - best effort error reporting
            logger.warning("unable to report restart-budget exhaustion for "
                           "executor %d", self.ctx.executor_id, exc_info=True)
        self._final_beat()

    # -- rebirth -------------------------------------------------------

    def _rebirth(self):
        """Own compute process died: claim the next generation and
        restart."""
        self.restarts += 1
        logger.warning("compute process of executor %d died (exitcode %s); "
                       "rebirth %d/%d", self.ctx.executor_id,
                       self.proc.exitcode, self.restarts, self.max_restarts)
        try:
            client = reservation.Client(self.server_addr)
            new_gen = client.rebirth(self.ctx.executor_id, self.generation)
            client.close()
        except Exception:  # noqa: BLE001 - server gone: no cluster left
            logger.error("executor %d could not reach the rendezvous server "
                         "for rebirth; giving up", self.ctx.executor_id,
                         exc_info=True)
            return
        self._park_and_respawn(new_gen)

    def _park_and_respawn(self, generation):
        """Park at the re-rendezvous barrier for ``generation``, reset the
        node's data plane, and respawn the compute process."""
        # a surviving process is stopped first, so every node resumes
        # from the same checkpoint step (SIGTERM, then SIGKILL for one
        # that a collective waiting on the dead rank keeps from exiting)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join(timeout=10)
        self.generation = int(generation)
        self._reset_data_plane()
        # re-register under the new generation (keeps cluster_info fresh
        # and primes the liveness registry for this incarnation)
        try:
            client = reservation.Client(self.server_addr)
            client.register(dict(self.node_meta, generation=self.generation))
            self._await_generation(client, self.generation)
            client.close()
        except Exception:  # noqa: BLE001 - the barrier is best effort; the
            logger.warning(  # monitor owns permanent-failure detection
                "executor %d re-rendezvous for generation %d was "
                "incomplete; respawning anyway", self.ctx.executor_id,
                self.generation, exc_info=True)
        self._spawn()

    def _reset_data_plane(self):
        """Release feeders and drop stale state: zero every feed queue's
        unfinished count, and clear the error queue of the dead
        incarnation's traceback (the restart is handling it).

        Two passes around a :data:`ZOMBIE_GRACE` sleep: the dead consumer
        may have left a get() thread in the manager server that swallows
        one more item after the first pass."""
        self._reset_queues_once()
        time.sleep(ZOMBIE_GRACE)
        self._reset_queues_once()
        try:
            errors = manager.drain(self.mgr.get_queue("error"), timeout=0)
            if errors:
                logger.info("rebirth of executor %d cleared %d queued "
                            "error(s) of the dead incarnation",
                            self.ctx.executor_id, errors)
        except Exception:  # noqa: BLE001 - best effort
            logger.warning("unable to drain the error queue of executor %d",
                           self.ctx.executor_id, exc_info=True)
        try:
            self.mgr.set("compute_state", None)
        except Exception:  # noqa: BLE001 - kv is best effort
            pass

    def _reset_queues_once(self):
        for qname in self.cluster_meta.get("queues", ["input"]):
            if qname == "error":
                continue
            try:
                discarded = self.mgr.reset_queue(qname)._getvalue()
                if discarded:
                    logger.info(
                        "rebirth of executor %d discarded %d stale items "
                        "from queue %r (their partitions stay uncommitted "
                        "and will be requeued)", self.ctx.executor_id,
                        discarded, qname)
            except Exception:  # noqa: BLE001 - queue may not exist for role
                logger.warning("unable to reset queue %r of executor %d",
                               qname, self.ctx.executor_id, exc_info=True)

    def _await_generation(self, client, generation):
        """Re-rendezvous barrier: block until every compute peer's
        liveness record reports ``generation`` (or
        :data:`BARRIER_TIMEOUT` passes: a permanently dead peer must not
        wedge the survivors)."""
        deadline = time.monotonic() + BARRIER_TIMEOUT
        behind = []
        while time.monotonic() < deadline:
            executors, _ = client.get_liveness()
            behind = [e for e in self.compute_eids
                      if executors.get(str(e), {}).get("generation", -1)
                      < generation]
            if not behind:
                logger.info("executor %d: re-rendezvous barrier for "
                            "generation %d complete", self.ctx.executor_id,
                            generation)
                return True
            time.sleep(min(0.2, self.interval / 2.0))
        logger.warning("executor %d: re-rendezvous barrier for generation "
                       "%d timed out waiting for %s", self.ctx.executor_id,
                       generation, behind)
        return False

    # -- teardown ------------------------------------------------------

    def _await_stop_then_quiesce(self):
        """After the compute story ends (done or failed), keep beating
        until the driver marks the node stopped, then stop the
        heartbeater."""
        while self._node_state() not in ("stopped", "terminating",
                                         "unknown"):
            time.sleep(self.interval)
        self.heartbeater.stop()
