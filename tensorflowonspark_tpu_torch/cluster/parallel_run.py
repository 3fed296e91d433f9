"""Barrier-mode launcher for N independent single-node instances (port of
the JAX package's ``cluster/parallel_run.py``; original:
tensorflowonspark/TFParallel.py).

Each instance gets a bare :class:`~.node.NodeContext` with no
distributed plan and runs the user function in the foreground of its
executor: the parallel batch-inference pattern, one independent model
per executor.  The barrier is a rendezvous round: every instance
registers with a reservation server and blocks until all N are present,
so on one-task-slot executors (``LocalEngine`` always) the N instances
hold N distinct executors, and ``num_chips_per_node`` gives each its own
GPUs by host-local rank (:func:`~.node.allocate_gpus`).

The map function is a module-level function bound with
``functools.partial`` and ``map_fun`` travels by ``pickle``, by
reference, as in :func:`~.cluster.run`.  Nothing here imports ``torch``.
"""

import functools
import logging
import os
import pickle

from . import node, reservation
from ..utils.net import get_ip_address

logger = logging.getLogger(__name__)


def run(engine, map_fun, args=None, num_executors=None,
        num_chips_per_node=None, barrier_timeout=600):
    """Run ``map_fun(args, ctx)`` as ``num_executors`` independent
    single-node instances and return their results (each instance's
    non-``None`` return value, in executor order).

    Args:
      engine: an :class:`~..engine.Engine`, or an int (the number of
        local executor processes to launch, stopped on return).
      map_fun: module-level ``fn(args, ctx)``.
      num_executors: instances; defaults to ``engine.num_executors``.
      num_chips_per_node: GPUs visible to each instance (by host-local
        rank); ``None`` leaves visibility alone.
      barrier_timeout: seconds the instances wait for each other.
    """
    from ..engine import LocalEngine

    try:
        pickle.dumps(map_fun)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(
            "map_fun must be a module-level function (the engine ships it "
            "with pickle, by reference): {0}".format(e))
    owns_engine = False
    if isinstance(engine, int):
        # validate before starting processes that would then leak
        if num_executors is not None and num_executors > engine:
            raise ValueError(
                "num_executors ({0}) exceeds the engine's executor count "
                "({1}); the barrier would never release".format(
                    num_executors, engine))
        engine = LocalEngine(engine)
        owns_engine = True
    if num_executors is None:
        num_executors = engine.num_executors
    if num_executors > engine.num_executors:
        msg = ("num_executors ({0}) exceeds the engine's reported executor "
               "count ({1}); the barrier would never release".format(
                   num_executors, engine.num_executors))
        if engine.num_executors_exact:
            if owns_engine:
                engine.stop()
            raise ValueError(msg)
        logger.warning("%s; proceeding anyway", msg)

    server = reservation.Server(num_executors)
    server_addr = server.start()
    mapfn = functools.partial(
        _instance, map_fun, args, list(server_addr), num_executors,
        num_chips_per_node, barrier_timeout, engine.default_fs)
    try:
        return engine.run_job(mapfn, [[i] for i in range(num_executors)],
                              collect=True)
    finally:
        server.stop()
        if owns_engine:
            engine.stop()


def _instance(map_fun, args, server_addr, num_executors, num_chips_per_node,
              barrier_timeout, default_fs, iterator):
    """One instance: barrier, GPUs by host-local rank, then the user fn
    in the foreground."""
    from ..engine import TFOS_EXECUTOR_WORKDIR

    executor_id = None
    for item in iterator:
        executor_id = item
    if executor_id is None:
        raise ValueError("empty start partition")
    host = get_ip_address()
    client = reservation.Client(server_addr)
    client.register({"executor_id": executor_id, "host": host})
    cluster_info = client.await_reservations(timeout=barrier_timeout)
    client.close()
    node.allocate_gpus(num_chips_per_node, cluster_info, host, executor_id)
    ctx = node.NodeContext(
        executor_id=executor_id, job_name="worker", task_index=executor_id,
        cluster_spec={"worker": ["localhost"] * num_executors},
        default_fs=default_fs,
        working_dir=os.environ.get(TFOS_EXECUTOR_WORKDIR, os.getcwd()),
    )
    result = map_fun(args, ctx)
    return [result] if result is not None else []
