"""Per-executor control/data plane: queues + shared state over IPC (port
of the JAX package's ``cluster/manager.py``; original:
tensorflowonspark/TFManager.py).

A ``multiprocessing.managers.BaseManager`` subclass exposing named
``JoinableQueue``s plus a small key/value dict, shared between the
executor's feeder tasks and the compute process that consumes them.
Two modes: ``'local'`` binds 127.0.0.1 and ``'remote'`` all interfaces,
so the driver can reach every node for shutdown and error checks.  Auth
is a per-node random authkey (``multiprocessing``'s HMAC handshake).

The elastic feed's ``PartitionLedger`` is not ported (ROADMAP queue A:
elastic supervision).
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
    (``'finished'`` | ``'failed'``) and ``'compute_pid'``.
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

    # Closures capture the live objects; BaseManager proxies them.
    QueueManager.register("get_queue", callable=lambda qname: qdict[qname])
    QueueManager.register("get", callable=lambda key: kv.get(key))
    QueueManager.register("set",
                          callable=lambda key, value: kv.set(key, value))

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
