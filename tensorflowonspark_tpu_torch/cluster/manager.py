"""Per-executor control/data plane: queues + shared state over IPC (port
of the JAX package's ``cluster/manager.py``; original:
tensorflowonspark/TFManager.py).

A ``multiprocessing.managers.BaseManager`` subclass exposing named
``JoinableQueue``s plus a small key/value dict, shared between the
executor's feeder tasks and the compute process that consumes them.
Two modes: ``'local'`` binds 127.0.0.1 and ``'remote'`` all interfaces,
so the driver can reach every node for shutdown and error checks.  Auth
is a per-node random authkey (``multiprocessing``'s HMAC handshake).

Every manager also serves the node's :class:`PartitionLedger` (the
``ledger`` call) and ``reset_queue``, which a rebirth uses to release
feeders blocked on rows its dead compute process had popped.
"""

import logging
import multiprocessing
import queue as _queue_mod
import threading
import time
from multiprocessing.managers import BaseManager

logger = logging.getLogger(__name__)


class _KVStore(object):
    """Thread-safe kv store for node state.

    Keys in use by the runtime: ``'state'`` (``'running'`` |
    ``'terminating'`` | ``'stopped'``), ``'compute_state'``
    (``'finished'`` | ``'failed'``), and the supervisor's
    ``'compute_pid'``, ``'generation'`` and ``'restarts'``.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._data = {}

    def get(self, key):
        with self._lock:
            return self._data.get(key)

    def set(self, key, value):
        with self._lock:
            self._data[key] = value


class PartitionLedger(object):
    """Per-node feed-partition ledger: the at-least-once delivery record
    of elastic feeding.

    States per partition id:

    - ``inflight``: a feeder called ``begin``; rows are entering the
      node's input queue;
    - ``delivered``: the feeder's ``queue.join()`` returned; every row
      reached the compute process, but is only as durable as it;
    - ``committed``: the compute process saved a checkpoint after
      consuming the partition (``commit`` promotes every delivered
      partition), so a restart that resumes from that checkpoint never
      needs it again;
    - ``discarded``: a rebirth's queue reset found the partition not
      committed.  Its rows were thrown away (``inflight``), or trained
      only on the trajectory that the restore from the last checkpoint
      throws away (``delivered``); a later ``deliver`` (its feeder's
      ``join()`` returns because of the reset) does not promote it, nor
      does the reborn process's ``commit``.

    After a worker's death the driver requeues every partition that is
    not committed: some rows may train twice, none are dropped.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._state = {}  # pid -> one of the states above

    def op(self, name, arg=None):
        """The one proxied entry point: ``begin``/``deliver`` take a
        partition id; ``commit`` returns how many partitions it
        promoted; ``discard`` marks every partition not committed;
        ``pending``/``committed`` return sorted ids; ``snapshot`` the
        whole state dict."""
        with self._lock:
            if name == "begin":
                self._state[arg] = "inflight"
                return None
            if name == "deliver":
                if self._state.get(arg) == "inflight":
                    self._state[arg] = "delivered"
                return None
            if name == "commit":
                promoted = [pid for pid, st in self._state.items()
                            if st == "delivered"]
                for pid in promoted:
                    self._state[pid] = "committed"
                return len(promoted)
            if name == "discard":
                for pid, st in self._state.items():
                    if st != "committed":
                        self._state[pid] = "discarded"
                return None
            if name == "pending":
                return sorted(pid for pid, st in self._state.items()
                              if st != "committed")
            if name == "committed":
                return sorted(pid for pid, st in self._state.items()
                              if st == "committed")
            if name == "snapshot":
                return dict(self._state)
            raise ValueError("unknown ledger op {0!r}".format(name))


def _reset_joinable_queue(q, ledger=None):
    """Drain a JoinableQueue and zero its unfinished-task count, so
    ``join()`` callers blocked on items a dead consumer popped (it can
    never call ``task_done`` again) are released.  Runs in the manager
    server process; returns the number of items discarded.

    Between the two, every partition of ``ledger`` that no checkpoint
    committed is marked ``discarded``: a feeder released here delivers
    nothing, one that began after the drain only gains a duplicate, and
    rows delivered after the last checkpoint are trained again, since
    every incarnation resumes from that checkpoint."""
    discarded = 0
    while True:
        try:
            q.get(block=False)
            discarded += 1
        except _queue_mod.Empty:
            break
    if ledger is not None:
        ledger.op("discard")
    # one task_done per get() above, plus one per item the dead consumer
    # removed without acknowledging it
    while True:
        try:
            q.task_done()
        except ValueError:
            break
    return discarded


class QueueManager(BaseManager):
    """Named JoinableQueues + kv state shared across processes."""


def start(authkey, queue_names, mode="local"):
    """Create and start a manager server process owning the named queues.

    Args:
      authkey: bytes; per-node random secret.
      queue_names: list of queue names, e.g. ``['input', 'output',
        'error']``.
      mode: ``'local'`` or ``'remote'`` (see module docstring).

    Returns ``(manager, address)`` where address is a ``(host, port)``
    tuple.
    """
    qdict = {name: multiprocessing.JoinableQueue() for name in queue_names}
    kv = _KVStore()
    ledger = PartitionLedger()

    # Closures capture the live objects; BaseManager proxies them.
    QueueManager.register("get_queue", callable=lambda qname: qdict[qname])
    QueueManager.register("get", callable=lambda key: kv.get(key))
    QueueManager.register("set",
                          callable=lambda key, value: kv.set(key, value))
    QueueManager.register("ledger",
                          callable=lambda op, arg=None: ledger.op(op, arg))
    QueueManager.register(
        "reset_queue",
        callable=lambda qname: _reset_joinable_queue(qdict[qname], ledger))

    addr = ("", 0) if mode == "remote" else ("127.0.0.1", 0)
    # The manager server must be forked, not spawned: its registry holds
    # closures over the live queue/kv objects, which cannot be pickled
    # into a spawn-context child.  Forking is safe because the executor
    # process never initialises CUDA: only the spawned compute process
    # touches the GPU (a CUDA context does not survive a fork).
    mgr = QueueManager(
        address=addr, authkey=authkey, ctx=multiprocessing.get_context("fork")
    )
    mgr.start()
    logger.info("started %s queue manager at %s", mode, mgr.address)
    return mgr, mgr.address


def connect(address, authkey):
    """Connect to an existing manager, e.g. from a feeder task or from
    the driver (original: TFManager.py:68-83)."""
    QueueManager.register("get_queue")
    QueueManager.register("get")
    QueueManager.register("set")
    QueueManager.register("ledger")
    QueueManager.register("reset_queue")
    m = QueueManager(address=tuple(address), authkey=authkey)
    m.connect()
    return m


def drain(q, timeout=0, quiet_gap=2.0):
    """Discard everything currently in a queue, marking each item done so
    ``join()`` callers are released.

    Args:
      timeout: overall budget to keep absorbing racing in-flight puts
        (``DataFeed.terminate`` uses 5; 0 = non-blocking sweep).
      quiet_gap: a queue that stays quiet this long is declared dry.
    """
    count = 0
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        grace = min(quiet_gap, max(0.0, remaining)) if timeout else 0.0
        try:
            q.get(block=grace > 0, timeout=grace or None)
            q.task_done()
            count += 1
        except _queue_mod.Empty:
            return count
