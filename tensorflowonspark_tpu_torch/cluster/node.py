"""Per-executor node runtime: role assignment, process launch, data plane
(port of the JAX package's ``cluster/node.py``; original:
tensorflowonspark/TFSparkNode.py).

Each executor runs :func:`start_node` exactly once at cluster startup.
It

1. claims its executor id (from the start-partition payload),
2. derives its role (job_name, task_index) from the cluster template,
3. starts the per-node :mod:`.manager` with the node's queues (a ps or
   evaluator node gets only ``control`` and ``error``),
4. starts TensorBoard when it is the cluster's TensorBoard node (the
   chief, else ``worker:0``), registers with the rendezvous server and
   blocks on the startup barrier,
5. assembles the cluster spec and the ``torch.distributed`` plan (a
   coordinator address and a dense rank per compute node),
6. allocates GPUs by host-local rank and sets ``CUDA_VISIBLE_DEVICES``
   (``num_chips_per_node``), and
7. launches the user's ``main_fun(args, ctx)``: in a spawned compute
   process under a :class:`~.supervisor.Supervisor` for
   ``InputMode.SPARK`` (with ``elastic=True`` the supervisor respawns it
   under a new generation after a death), or in the foreground for
   ``InputMode.TENSORFLOW``.  A ps or evaluator node runs it in a
   spawned process with no supervisor in either mode, and its start
   task blocks on the ``control`` queue until the driver posts ``None``
   (pinning the executor, so no feed task lands there), then checks the
   error queue and terminates the process.

The feed map function (:func:`feed_partition`) reconnects to the node's
manager from whatever executor the feed task landed on, ships the rows
as :class:`~.marker.ColumnarBlock`s (or row :class:`~.marker.Block`s)
through the node's queue or, with ``TFOS_SHM_FEED=1``, as columnar wire
records through the node's shared-memory ring, and polls the node's
error queue while it waits for consumption.  An elastic partition leads
with a :class:`~.marker.PartitionStart`: the feeder strips it, records
the partition ``inflight`` in the node's ledger, and ``delivered`` once
its rows were consumed.  The inference map function
(:func:`inference_partition`) feeds a partition and drains exactly as
many results.  Teardown is driver-direct (``TPUCluster.shutdown``).

Every map function here is a module-level function, bound with
``functools.partial``: the engine ships them with the standard
``pickle``, which refuses closures.  Nothing here imports ``torch`` at
module level and nothing on the executor side initialises CUDA (the
executor forks its queue manager, and a CUDA context does not survive a
fork); only the spawned compute process touches the GPU.

The compute process publishes its telemetry into the node's kv
(``telemetry.aggregate.NodePublisher``), stamps its journal with the
executor id, arms the flight recorder with its dump index in the kv, and
starts the profile capture ``cluster.run(profile_dir=)`` asked for: the
cluster's ``profile_dir``/``profile_steps`` reach only that cluster's
compute processes, as ``TFOS_PROFILE_DIR``/``TFOS_PROFILE_STEPS`` set in
their own environment.

A feed task whose node is held by remediation (its ``compute_state`` is
``held``: the supervisor parked the compute on purpose) ships the
partition to a live, un-held compute peer instead
(:func:`_route_around_hold`), and a drain wait whose node becomes held
fails fast, so the elastic requeue re-feeds the partition.

Not ported (ROADMAP queue A): the heartbeat chaos hook.
"""

import collections
import functools
import itertools
import json
import logging
import multiprocessing
import multiprocessing.util
import os
import pickle
import queue as _queue_mod
import socket
import threading
import time
import uuid

from . import gpu_info, manager, reservation
from .marker import (Block, ColumnarBlock, EndPartition, PartitionStart,
                     encode_columnar_parts, encode_rows_parts, pack_columnar)
from ..utils import not_ported
from ..utils import paths as path_utils
from ..utils.net import get_ip_address

logger = logging.getLogger(__name__)

#: Rows per feed Block: one manager RPC ships this many rows.
FEED_BLOCK_SIZE = 256

#: the feeder's encode pool: worker threads, blocks in flight
FEED_PIPELINE_WORKERS, FEED_PIPELINE_DEPTH = 2, 4

#: job names whose nodes run the training loop
COMPUTE_JOBS = ("chief", "master", "worker")

#: job names of the service nodes (no feed queues, no supervisor)
SERVICE_JOBS = ("ps", "evaluator")


class NodeContext(object):
    """Cluster metadata for the user's ``main_fun(args, ctx)``.

    Attributes: ``executor_id``, ``job_name``, ``task_index``,
    ``cluster_spec``, ``num_workers``, ``default_fs``, ``working_dir``,
    ``mgr`` (the node's manager proxy), ``coordinator`` (``host:port``
    of rank 0's ``torch.distributed`` store), ``process_id`` /
    ``num_processes`` (this node's rank among the compute nodes),
    ``device_info`` and ``generation``.
    """

    def __init__(self, executor_id=0, job_name="", task_index=0,
                 cluster_spec=None, default_fs="file://", working_dir=".",
                 mgr=None, coordinator=None, process_id=0, num_processes=1,
                 device_info=None, manager_addr=None, manager_authkey=None,
                 generation=0):
        self.executor_id = executor_id
        self.job_name = job_name
        self.task_index = task_index
        self.cluster_spec = cluster_spec or {}
        self.default_fs = default_fs
        self.working_dir = working_dir
        self.mgr = mgr
        self.coordinator = coordinator
        self.process_id = process_id
        self.num_processes = num_processes
        self.device_info = device_info or {}
        #: (addr, authkey hex) so the spawned compute process can rebind
        #: its manager proxy (proxies do not survive pickling)
        self.manager_addr = manager_addr
        self.manager_authkey = manager_authkey
        #: elastic re-rendezvous generation: 0 at the first launch, N
        #: after the Nth supervised restart (``train_on_feed(
        #: checkpointer=...)`` restores whenever a checkpoint exists, so
        #: resuming needs no branch on it)
        self.generation = generation
        self.num_workers = sum(
            len(v) for k, v in self.cluster_spec.items() if k in COMPUTE_JOBS
        )

    def absolute_path(self, path):
        """``path`` made absolute on the default filesystem."""
        return path_utils.resolve_path(path, self.default_fs,
                                       self.working_dir)

    def get_data_feed(self, train_mode=True, qname_in="input",
                      qname_out="output", input_mapping=None):
        """A :class:`~..data.feed.DataFeed` bound to this node's queues."""
        from ..data.feed import DataFeed

        return DataFeed(self.mgr, train_mode, qname_in, qname_out,
                        input_mapping)

    def initialize_distributed(self, backend=None):
        """Join this cluster's ``torch.distributed`` process group.

        ``backend`` defaults to ``nccl`` when CUDA is available, else
        ``gloo``; rank 0 hosts the TCP store at :attr:`coordinator`,
        with every key scoped by :attr:`generation`, so the processes an
        elastic rebirth respawns meet in a rendezvous of their own.
        Beside an NCCL group it makes a ``gloo`` group on the CPU for
        the trainer's global-stop flag (``dp.all_hosts_ready``), so the
        per-batch flag never waits for the device.  A no-op for
        single-process clusters; returns ``torch.distributed`` either
        way.
        """
        import torch
        import torch.distributed as dist

        from ..parallel import dp

        if (self.num_processes > 1 and self.coordinator
                and not dist.is_initialized()):
            if backend is None:
                backend = "nccl" if torch.cuda.is_available() else "gloo"
            from torch.distributed.constants import default_pg_timeout

            host, port = self.coordinator.rsplit(":", 1)
            store = dist.TCPStore(host, int(port), self.num_processes,
                                  self.process_id == 0,
                                  timeout=default_pg_timeout)
            dist.init_process_group(
                backend, store=dist.PrefixStore(
                    "generation{0}/".format(self.generation), store),
                world_size=self.num_processes, rank=self.process_id)
            dp.set_host_group(
                None if backend == "gloo" else dist.new_group(backend="gloo"))
        return dist

    def mesh(self, axes=None):
        raise not_ported("NodeContext.mesh",
                         "multi-GPU DP over torch.distributed")


def _cluster_template(num_executors, num_ps, master_node=None,
                      eval_node=False):
    """Map job names to executor-id lists: ps nodes first, then an
    optional master/chief, then an optional evaluator, then workers."""
    template = {}
    idx = 0
    if num_ps > 0:
        template["ps"] = list(range(idx, idx + num_ps))
        idx += num_ps
    if master_node:
        template[master_node] = [idx]
        idx += 1
    if eval_node:
        template["evaluator"] = [idx]
        idx += 1
    if idx < num_executors:
        template["worker"] = list(range(idx, num_executors))
    return template


def _role_for(template, executor_id):
    for job_name, ids in template.items():
        if executor_id in ids:
            return job_name, ids.index(executor_id)
    raise ValueError("executor_id {0} not present in cluster template "
                     "{1}".format(executor_id, template))


#: Module-level keepalive for this executor's queue managers: BaseManager
#: shuts its server down when the last reference is collected.
_LOCAL_MANAGERS = []

#: Keepalive for the shm feed rings this executor created, as
#: ``(cluster_id, ring)`` pairs.  Rings of earlier cluster runs are
#: unlinked when a new run starts, and the last run's at executor exit.
_LOCAL_RINGS = []
_RING_FINALIZER = []


def _evict_stale_rings(current_cluster_id):
    kept = []
    for cluster_id, ring in _LOCAL_RINGS:
        if cluster_id == current_cluster_id:
            kept.append((cluster_id, ring))
            continue
        try:
            ring.close(unlink=True)
            logger.info("unlinked stale shm ring from run %s", cluster_id)
        except Exception:  # noqa: BLE001 - cleanup is best effort
            logger.warning("failed to unlink stale shm ring", exc_info=True)
    _LOCAL_RINGS[:] = kept


def _unlink_local_rings():
    """The final run's ring has no successor run to evict it: unlink it
    at executor exit, or the resource tracker reports a leaked
    segment."""
    _evict_stale_rings(current_cluster_id=object())  # matches nothing


def _create_feed_ring(mgr, cluster_id, executor_id):
    """Create this executor's shm feed ring, tag it with the columnar
    wire format and advertise it in the manager kv under ``"shm_ring"``;
    without the native library the feed stays on the queue."""
    from ..data import shm_ring

    if not shm_ring.available():
        logger.warning("TFOS_SHM_FEED is set but the native ring is "
                       "unavailable; falling back to queue feeding")
        return None
    name = "tfos_{0}_{1}".format(cluster_id[-8:], executor_id)
    capacity = int(os.environ.get("TFOS_SHM_FEED_BYTES",
                                  shm_ring.DEFAULT_CAPACITY))
    _evict_stale_rings(cluster_id)
    ring = shm_ring.ShmRing(name, capacity, create=True)
    ring.set_format(shm_ring.FORMAT_COLUMNAR_V1)
    if not _RING_FINALIZER:
        # a multiprocessing finalizer, not atexit: an executor is a
        # multiprocessing child, which runs these as its target returns
        # (priority 5: after the compute process's exit grace, before
        # the queue manager's shutdown)
        _RING_FINALIZER.append(multiprocessing.util.Finalize(
            None, _unlink_local_rings, exitpriority=5))
    _LOCAL_RINGS.append((cluster_id, ring))
    mgr.set("shm_ring", {"name": name, "capacity": capacity})
    logger.info("shm feed ring %s (%d MB) enabled", name, capacity >> 20)
    return ring


_MANAGER_FILE = "tfos_manager.json"


def _write_manager_info(workdir, info):
    with open(os.path.join(workdir, _MANAGER_FILE), "w") as f:
        json.dump(info, f)


def _read_manager_info(workdir):
    p = os.path.join(workdir, _MANAGER_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


#: Cached manager connections, keyed by (addr, authkey): executor
#: processes persist across feed tasks and a fresh connect costs ~100 ms.
_MANAGER_CONNS = collections.OrderedDict()
_MANAGER_CONNS_MAX = 8


def _get_manager(cluster_info, executor_id):
    """Connect (cached) to the manager of the node hosting
    ``executor_id``."""
    for node in cluster_info:
        if node["executor_id"] != executor_id:
            continue
        addr = tuple(node["addr"])
        key = (addr, node["authkey"])
        m = _MANAGER_CONNS.get(key)
        if m is not None:
            # bounded liveness probe: a short TCP connect to the server
            try:
                socket.create_connection(addr, timeout=2.0).close()
                _MANAGER_CONNS.move_to_end(key)
                return m
            except OSError:
                _MANAGER_CONNS.pop(key, None)
        m = manager.connect(addr, bytes.fromhex(node["authkey"]))
        _MANAGER_CONNS[key] = m
        while len(_MANAGER_CONNS) > _MANAGER_CONNS_MAX:
            _MANAGER_CONNS.popitem(last=False)
        return m
    raise RuntimeError(
        "no node with executor_id {0} in cluster_info".format(executor_id))


def _manager_first_call(cluster_info, executor_id, call):
    """First manager RPC with one evict+reconnect retry (the cached
    connection's TCP probe passes a wedged manager or a reused port; the
    first registered-method call is the authoritative check)."""
    from multiprocessing import AuthenticationError

    mgr = _get_manager(cluster_info, executor_id)
    try:
        return mgr, call(mgr)
    except (OSError, EOFError, AuthenticationError) as e:
        logger.warning("cached manager connection failed first RPC (%s); "
                       "reconnecting", e)
        for node in cluster_info:
            if node["executor_id"] == executor_id:
                _MANAGER_CONNS.pop((tuple(node["addr"]), node["authkey"]),
                                   None)
        mgr = _get_manager(cluster_info, executor_id)
        return mgr, call(mgr)


def _route_around_hold(cluster_info, executor_id, mgr, state, probe):
    """``(manager, state, executor_id)`` of a live, un-held compute peer
    for a feed task whose own node is held by remediation: a held node
    keeps its heartbeats and registrations but drains nothing, so its share
    of the feed flows to the survivors of the elastic shrink.  Falls back
    to the local manager when every peer is held, terminating or
    unreachable (the feed timeout and the elastic requeue then apply)."""
    for peer_node in sorted(cluster_info, key=lambda n: n["executor_id"]):
        peer = peer_node["executor_id"]
        if peer == executor_id or peer_node.get("job_name") not in \
                COMPUTE_JOBS:
            continue
        try:
            m2, (st2, cs2) = _manager_first_call(cluster_info, peer, probe)
        except Exception:  # noqa: BLE001 - peer mid-restart: the next one
            continue
        if cs2 != "held" and st2 != "terminating":
            logger.info("executor %d is held by remediation; forwarding "
                        "this partition to executor %d", executor_id, peer)
            return m2, st2, peer
    logger.warning("executor %d is held and no live peer accepts its feed; "
                   "feeding locally (the elastic requeue will recover it)",
                   executor_id)
    return mgr, state, executor_id


def _local_executor_workdir():
    from ..engine import TFOS_EXECUTOR_WORKDIR

    return os.environ.get(TFOS_EXECUTOR_WORKDIR, os.getcwd())


def _local_executor_id():
    """The executor id claimed by this executor's start task."""
    from ..utils.env import read_executor_id

    return read_executor_id(_local_executor_workdir())


def _compute_process_main(fn_bytes, args, ctx, profile=None):
    """Entry point of the spawned compute process: rebind the manager
    proxy, start the telemetry publisher, the flight recorder and the
    profile capture ``profile`` (``{"dir", "steps"}``, the cluster's
    ``profile_dir``) asks for, run the user fn, ship any traceback home
    via the node's error queue, and mark ``compute_state`` 'finished' or
    'failed'."""
    import traceback

    from .. import telemetry
    from .. import tensorboard as _tb
    from ..telemetry import blackbox as _blackbox
    from ..utils.retry import retry_call

    authkey = bytes.fromhex(ctx.manager_authkey)
    multiprocessing.current_process().authkey = authkey
    ctx.mgr = retry_call(
        lambda: manager.connect(tuple(ctx.manager_addr), authkey),
        "connect to node manager at {0}".format(tuple(ctx.manager_addr)),
        exceptions=(OSError, EOFError), deadline=30.0, base=0.1,
    )
    publisher = telemetry.start_node_publisher(ctx.mgr)
    telemetry.get_journal().set_identity(ctx.executor_id)
    recorder = _blackbox.install()
    if recorder is not None:
        recorder.attach_kv(ctx.mgr)
    session = None
    try:
        if profile:
            # this process's own environment: nothing else inherits it
            os.environ[_tb.PROFILE_DIR_ENV] = str(profile["dir"])
            if profile.get("steps"):
                os.environ[_tb.PROFILE_STEPS_ENV] = str(int(profile["steps"]))
        session = _tb.maybe_start_profile_from_env()
        fn = pickle.loads(fn_bytes)
        fn(args, ctx)
    except Exception:  # noqa: BLE001 - process boundary, traceback shipped
        tb = traceback.format_exc()
        logger.error("compute process failed:\n%s", tb)
        try:
            ctx.mgr.get_queue("error").put(tb)
            ctx.mgr.set("compute_state", "failed")
        except Exception:  # noqa: BLE001 - best effort error reporting
            logger.exception("unable to report error to manager")
        raise
    finally:
        if session is not None:
            session.stop()
        if publisher is not None:
            publisher.stop()
    # outside the user-fn try: a failure to *signal* is not a compute
    # failure; shutdown() polls this instead of sleeping blindly
    try:
        ctx.mgr.set("compute_state", "finished")
    except Exception:  # noqa: BLE001 - shutdown falls back to its window
        logger.exception("unable to report completion to manager")


def run(fn, args, cluster_meta, input_mode, log_dir=None,
        tensorboard=False):
    """The start-job map function executed once per executor: a
    ``functools.partial`` of :func:`start_node` (picklable by reference).

    Args:
      fn: user ``main_fun(args, ctx)``, module-level.
      args: opaque user args.
      cluster_meta: dict from the driver: ``id``, ``cluster_template``,
        ``num_executors``, ``default_fs``, ``server_addr``,
        ``reservation_timeout``, ``queues``, ``num_chips_per_node``,
        ``heartbeat_interval``, ``driver_ps_addrs``.
      input_mode: ``InputMode.SPARK`` feeds data through the engine and
        runs ``fn`` in a spawned compute process; ``InputMode.TENSORFLOW``
        runs it in the foreground, reading its own data.
      log_dir: TensorBoard's log directory.
      tensorboard: start TensorBoard on the chief, else on ``worker:0``.
    """
    return functools.partial(start_node, pickle.dumps(fn), args,
                             cluster_meta, input_mode, log_dir, tensorboard)


def _start_tensorboard_here(log_dir):
    """Start TensorBoard from this executor; returns ``(pid, port)``, or
    ``(0, 0)`` when there is none.  A thread reaps the process once the
    driver's shutdown has stopped it, so its pid is gone then."""
    from ..tensorboard import start_tensorboard

    proc, port = start_tensorboard(log_dir)
    if proc is None:
        return 0, 0
    threading.Thread(target=proc.wait, daemon=True,
                     name="tensorboard-reaper").start()
    return proc.pid, port


def start_node(fn_bytes, args, cluster_meta, input_mode, log_dir,
               tensorboard, iterator):
    """Body of :func:`run` (see the module docstring's steps)."""
    from ..utils.env import write_executor_id
    from .cluster import InputMode

    # 1. claim executor id from the start partition payload
    executor_id = None
    for item in iterator:
        executor_id = item
    assert executor_id is not None, "empty start partition"
    workdir = _local_executor_workdir()
    write_executor_id(executor_id, workdir)
    template = cluster_meta["cluster_template"]
    job_name, task_index = _role_for(template, executor_id)
    logger.info("executor_id=%d assigned role %s:%d", executor_id, job_name,
                task_index)

    # 2. duplicate detection: a running manager of this cluster on this
    # executor means the engine re-ran the start task
    existing = _read_manager_info(workdir)
    if (existing is not None
            and existing.get("cluster_id") == cluster_meta["id"]):
        try:
            m = manager.connect(tuple(existing["addr"]),
                                bytes.fromhex(existing["authkey"]))
            state = str(m.get("state")._getvalue())
        except (ConnectionError, OSError):
            state = "dead"
        if state == "running":
            # a true duplicate: a retry after the node died finds a dead
            # manager and starts fresh (above), and under elastic an
            # in-place compute death never fails the start task at all
            # (the supervisor respawns the compute process locally)
            raise RuntimeError("TFOS node already running on executor {0}; "
                               "duplicate start task".format(executor_id))

    # 3. the per-node queue manager, reachable by the driver ('remote');
    # a service node gets only its control and error queues
    authkey = uuid.uuid4().bytes
    is_service_node = job_name in SERVICE_JOBS
    if is_service_node:
        queues = ["control", "error"]
    else:
        queues = list(cluster_meta.get("queues",
                                       ["input", "output", "error"]))
        if "error" not in queues:
            queues.append("error")
    mgr, addr = manager.start(authkey, queues, mode="remote")
    _LOCAL_MANAGERS.append(mgr)  # keepalive for the executor lifetime
    mgr.set("state", "running")
    # the shared-memory feed ring: created here so it lives as long as
    # the executor; feeders and the compute process attach by name
    if (not is_service_node and input_mode == InputMode.SPARK
            and os.environ.get("TFOS_SHM_FEED") in ("1", "force")):
        _create_feed_ring(mgr, cluster_meta["id"], executor_id)
    host = get_ip_address()
    adv_addr = (host, addr[1])
    _write_manager_info(workdir, {"cluster_id": cluster_meta["id"],
                                  "addr": list(adv_addr),
                                  "authkey": authkey.hex()})

    # 4. reserve the port of this node's torch.distributed store now, so
    # no co-located node takes it between registration and init
    coord_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    coord_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    coord_sock.bind(("", 0))
    coord_port = coord_sock.getsockname()[1]

    # TensorBoard on exactly one node: the chief when the cluster has
    # one, else worker:0
    tb_pid, tb_port = 0, 0
    has_chief = any(j in template for j in ("chief", "master"))
    is_tb_node = (job_name in ("chief", "master") if has_chief
                  else (job_name == "worker" and task_index == 0))
    if tensorboard and is_tb_node:
        tb_pid, tb_port = _start_tensorboard_here(log_dir)

    # rendezvous registration + startup barrier
    node_meta = {
        "executor_id": executor_id,
        "host": host,
        "job_name": job_name,
        "task_index": task_index,
        "addr": list(adv_addr),
        "authkey": authkey.hex(),
        "port": coord_port,
        "tb_pid": tb_pid,
        "tb_port": tb_port,
        "device_info": _safe_device_info(),
    }
    client = reservation.Client(cluster_meta["server_addr"])
    client.register(node_meta)
    cluster_info = client.await_reservations(
        timeout=cluster_meta.get("reservation_timeout", 600))
    client.close()

    # 5. cluster spec sorted by executor id
    spec, coordinator, process_ranks = build_cluster_spec(cluster_info)
    # shards hosted by the driver join the spec by address
    if cluster_meta.get("driver_ps_addrs"):
        spec = dict(spec, ps=list(cluster_meta["driver_ps_addrs"]))

    # 6. GPUs, set visible before the compute process spawns
    allocate_gpus(cluster_meta.get("num_chips_per_node"), cluster_info,
                  host, executor_id)
    coord_sock.close()

    ctx = NodeContext(
        executor_id=executor_id, job_name=job_name, task_index=task_index,
        cluster_spec=spec,
        default_fs=cluster_meta.get("default_fs", "file://"),
        working_dir=workdir, mgr=None, coordinator=coordinator,
        process_id=process_ranks.get(executor_id, 0),
        num_processes=len(process_ranks) or 1,
        device_info=node_meta["device_info"],
        manager_addr=list(adv_addr), manager_authkey=authkey.hex(),
    )

    # 7. launch the user fn
    if is_service_node:
        _run_service_node(fn_bytes, args, ctx, mgr, cluster_meta)
    elif input_mode == InputMode.SPARK:
        from . import supervisor as _supervisor

        compute_eids = [n["executor_id"] for n in cluster_info
                        if n["job_name"] in COMPUTE_JOBS]
        sup = _supervisor.Supervisor(fn_bytes, args, ctx, mgr, cluster_meta,
                                     compute_eids, node_meta)
        sup.start()
        _supervisor.register_local_supervisor(sup)
        # the executor returns at once, free for feed tasks; the compute
        # process keeps running
    else:
        # TENSORFLOW input mode: the fn reads its own data in this
        # process, pinning the executor; a heartbeater keeps the driver's
        # monitor informed
        ctx.mgr = mgr
        from .. import telemetry

        events_fn = metrics_fn = None
        if telemetry.enabled():
            # the fn runs in this process: its registry and journal ship
            # on this heartbeater's beats directly
            from ..telemetry import blackbox

            telemetry.get_journal().set_identity(executor_id)
            recorder = blackbox.install()
            if recorder is not None:
                recorder.attach_kv(mgr)
            metrics_fn = telemetry.get_registry().snapshot

            def events_fn():
                return [e.to_dict()
                        for e in telemetry.get_journal().drain_unshipped(64)]

        hb = reservation.Heartbeater(
            cluster_meta["server_addr"], executor_id,
            interval=cluster_meta.get("heartbeat_interval"), host=host,
            metrics_fn=metrics_fn, events_fn=events_fn,
        ).start()
        try:
            pickle.loads(fn_bytes)(args, ctx)
        except Exception:
            import traceback

            mgr.get_queue("error").put(traceback.format_exc())
            mgr.set("state", "stopped")
            raise
        finally:
            hb.stop()
        mgr.set("state", "stopped")
    return []


def _run_service_node(fn_bytes, args, ctx, mgr, cluster_meta):
    """A ps or evaluator node: its fn in a spawned process with no
    supervisor (a lost shard is not recovered by a checkpoint resume),
    while this start task blocks on the ``control`` queue until the
    driver posts ``None``; then the error check, and the process is
    terminated."""
    proc = multiprocessing.get_context("spawn").Process(
        target=_compute_process_main,
        args=(fn_bytes, args, ctx, cluster_meta.get("profile")),
        daemon=True, name="compute-%s-%d" % (ctx.job_name, ctx.task_index))
    proc.start()
    mgr.set("compute_pid", proc.pid)
    control = mgr.get_queue("control")
    try:
        while True:
            msg = control.get(block=True)
            control.task_done()
            if msg is None:
                break
        _check_error_queue(mgr, executor_id=ctx.executor_id)
    finally:
        proc.terminate()
        proc.join(timeout=10)
        mgr.set("state", "stopped")


def allocate_gpus(num_gpus, cluster_info, host, executor_id):
    """Allocate ``num_gpus`` GPUs by this node's HOST-LOCAL rank (its
    position among the nodes on ``host``), so co-located nodes land on
    disjoint cards, and set them visible for processes spawned from here
    on.  ``None`` or 0 allocates nothing and sets nothing; otherwise a
    missing ``nvidia-smi`` or too few free GPUs raise: the compute
    process never falls back to the CPU.  Returns the GPU indices."""
    if not num_gpus:
        return None
    cohosted = sorted(n["executor_id"] for n in cluster_info
                      if n["host"] == host)
    gpus = gpu_info.get_gpus(num_gpus,
                             worker_index=cohosted.index(executor_id))
    gpu_info.set_visible_gpus(gpus)
    return gpus


def _safe_device_info():
    """Device info from ``nvidia-smi`` (no CUDA initialisation); a host
    without it reports no devices."""
    try:
        return gpu_info.get_device_info()
    except Exception:  # noqa: BLE001 - absent GPUs are fine here
        return {"platform": "unknown", "num_devices": 0}


def build_cluster_spec(cluster_info):
    """``({job: ["host:port", ...]}, coordinator, process_ranks)``,
    sorted by executor id; ``process_ranks`` maps executor_id to a dense
    ``torch.distributed`` rank over the compute nodes, and the
    coordinator is rank 0's reserved port."""
    ordered = sorted(cluster_info, key=lambda n: n["executor_id"])
    spec = {}
    for node in ordered:
        spec.setdefault(node["job_name"], []).append(
            "{0}:{1}".format(node["host"], node["port"]))
    compute = [n for n in ordered if n["job_name"] in COMPUTE_JOBS]
    process_ranks = {n["executor_id"]: i for i, n in enumerate(compute)}
    coordinator = ("{0}:{1}".format(compute[0]["host"], compute[0]["port"])
                   if compute else None)
    return spec, coordinator, process_ranks


# ----------------------------------------------------------------------
# The feed map function
# ----------------------------------------------------------------------


def _queue_put_retry(queue, obj):
    """``queue.put`` with one reconnect-retry: a GC pass can close the
    shared proxy connection mid-send, and the next proxy call opens a
    fresh one (the request never completed, so no duplicate put)."""
    try:
        queue.put(obj, block=True)
    except (OSError, TypeError):
        logger.warning("feed queue put hit a closed manager connection; "
                       "retrying once on a fresh connection", exc_info=True)
        queue.put(obj, block=True)


class _PipelinedShipper(object):
    """Feeder-side encode pipeline: a small worker pool encodes block N+1
    (columnar pack, ring wire encode, pickle) while the caller's iterator
    produces block N+2 and this thread ships block N.  Submission order
    is preserved and every push stays on the submitting thread, so the
    ring's single-producer contract holds; worker errors re-raise there
    at the next ``ship``/``close``.
    """

    def __init__(self, encode, push, workers=2, depth=4):
        from concurrent.futures import ThreadPoolExecutor

        self._encode = encode
        self._push = push
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                        thread_name_prefix="feed-encode")
        self._depth = max(1, depth)
        self._pending = collections.deque()

    def ship(self, rows, use_ring):
        while len(self._pending) >= self._depth:
            self._drain_one()
        self._pending.append(self._pool.submit(self._encode, rows, use_ring))
        while self._pending and self._pending[0].done():
            self._drain_one()

    def _drain_one(self):
        for action in self._pending.popleft().result():
            self._push(action)

    def close(self):
        """Flush every queued block in order, then stop the pool."""
        try:
            while self._pending:
                self._drain_one()
        finally:
            self._pool.shutdown(wait=True)

    def abort(self):
        """Error-path teardown: drop queued work, stop the pool."""
        self._pending.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)


def _pack(rows):
    """One feed block: stacked numpy columns when the rows are
    fixed-shape numerics (``TFOS_COLUMNAR_FEED`` not 0), else a row
    Block."""
    if os.environ.get("TFOS_COLUMNAR_FEED", "1") != "0":
        packed = pack_columnar(rows)
        if packed is not None:
            return packed
    return Block(rows)


#: feeder-side ring attachments, one per (process, ring name)
_ATTACHED_RINGS = {}


def _attach_feed_ring(mgr):
    """Attach to this node's shm feed ring if one was advertised, and
    announce this process as its producer (a consumer waiting on the
    ring then detects a feeder's death instead of hanging)."""
    try:
        info = mgr.get("shm_ring")._getvalue()
    except Exception:  # noqa: BLE001 - kv read is best effort
        info = None
    if not info:
        return None
    name = info["name"]
    if name not in _ATTACHED_RINGS:
        from ..data import shm_ring

        # an unlinked segment stays resident while mapped: drop the
        # attachments of finished cluster runs
        for stale in list(_ATTACHED_RINGS):
            _ATTACHED_RINGS.pop(stale).close(unlink=False)
        _ATTACHED_RINGS[name] = shm_ring.ShmRing(name)
    _ATTACHED_RINGS[name].announce_producer()
    return _ATTACHED_RINGS[name]


def _row_vals(row):
    return (row.values() if isinstance(row, dict)
            else row if isinstance(row, (tuple, list)) else (row,))


def _row_is_large(row):
    """The per-row scatter-gather encode pays off only when a row
    carries an array of at least 64 KB (images); smaller rows ship
    faster as one stacked-column copy."""
    try:
        return any(getattr(v, "nbytes", 0) >= 65536 for v in _row_vals(row))
    except TypeError:
        return False


def _row_bytes(row):
    total = 0
    try:
        for v in _row_vals(row):
            n = getattr(v, "nbytes", None)
            if n is None:
                n = len(v) if isinstance(v, (bytes, str)) else 8
            total += n
    except TypeError:
        return 0
    return total


def _encode_into(rows, use_ring, wire_cap, actions):
    """Encode one block into ordered ship actions: ``('pushv', parts,
    nbytes)``, ``('push', payload, nbytes)`` or ``('queue', obj)``,
    splitting blocks that exceed one ring frame (``wire_cap`` bytes).
    Pure CPU work, safe on the shipper's pool: no manager or ring
    calls."""
    if not use_ring:
        actions.append(("queue", _pack(rows)))
        return

    def split():
        if len(rows) == 1:
            # a single row larger than a ring frame: the queue has no cap
            actions.append(("queue", Block(rows)))
            return
        mid = len(rows) // 2
        _encode_into(rows[:mid], use_ring, wire_cap, actions)
        _encode_into(rows[mid:], use_ring, wire_cap, actions)

    columnar_ok = os.environ.get("TFOS_COLUMNAR_FEED", "1") != "0"
    if columnar_ok and _row_is_large(rows[0]):
        # per-row buffers scatter-gather straight into the ring: the
        # contiguous record write is the column stack
        enc = encode_rows_parts(rows)
        if enc is not None:
            header, bufs, total = enc
            if total + 8 < wire_cap:
                actions.append(("pushv", [header] + bufs, total))
            else:
                split()
            return
    packed = _pack(rows)
    if isinstance(packed, ColumnarBlock):
        enc = encode_columnar_parts(packed)
        if enc is not None:  # None: non-string dict keys, pickled below
            header, bufs = enc
            total = len(header) + sum(b.nbytes for b in bufs)
            if total + 8 < wire_cap:
                actions.append(("pushv", [header] + bufs, total))
                return
            if len(rows) > 1:
                split()
                return
    payload = pickle.dumps(packed, protocol=5)
    if len(payload) + 8 >= wire_cap:
        split()
        return
    actions.append(("push", payload, len(payload)))


def train(cluster_info, cluster_meta, feed_timeout=600, qname="input"):
    """The feeder map function for training data: a ``functools.partial``
    of :func:`feed_partition`."""
    return functools.partial(feed_partition, cluster_info, cluster_meta,
                             feed_timeout, qname)


def feed_partition(cluster_info, cluster_meta, feed_timeout, qname,
                   iterator):
    """Ship one partition to the local node (its shm ring when one is
    advertised and the rows are large enough, else its input queue),
    then wait until the compute process has taken every block, raising
    if it reported an error or ``feed_timeout`` passes.

    A partition that leads with a :class:`~.marker.PartitionStart` (the
    elastic feed) is recorded in the node's ledger: ``begin`` before
    its rows ship, ``deliver`` once they were all consumed.

    Ring policy: the first block decides for the whole task, ring when
    its first row carries at least ``TFOS_SHM_RING_MIN_ROW_BYTES``
    (default 4096) payload bytes, queue otherwise; ``TFOS_SHM_FEED=force``
    takes the ring for every block."""

    def _probe(m):
        try:
            cstate = m.get("compute_state")._getvalue()
        except Exception:  # noqa: BLE001 - the kv is best effort
            cstate = None
        return str(m.get("state")._getvalue()), cstate

    iterator = iter(iterator)
    first = next(iterator, None)
    pid = None
    if isinstance(first, PartitionStart):
        pid = first.pid
    elif first is not None:
        iterator = itertools.chain([first], iterator)
    local_eid = _local_executor_id()
    mgr, (state, cstate) = _manager_first_call(cluster_info, local_eid,
                                               _probe)
    routed = False
    if cstate == "held" and state != "terminating":
        # the node's compute is parked by a remediation hold: nothing
        # will drain its queue, so the partition goes to a live peer
        own_eid = local_eid
        mgr, state, local_eid = _route_around_hold(
            cluster_info, local_eid, mgr, state, _probe)
        routed = local_eid != own_eid
    if pid is not None and state != "terminating":
        mgr.ledger("begin", pid)
    queue = mgr.get_queue(qname)
    if state == "terminating":
        # compute is done: discard the partition and ask the driver to
        # stop scheduling feed jobs
        logger.info("node terminating; skipping partition")
        sum(1 for _ in iterator)
        try:
            client = reservation.Client(cluster_meta["server_addr"])
            client.request_stop()
            client.close()
        except (ConnectionError, OSError) as e:
            logger.debug("unable to reach reservation server: %s", e)
        return []
    err_q = mgr.get_queue("error")
    # a partition routed to a peer takes the peer's queue only: the
    # peer's ring has a single producer (its own feeder), and it may lie
    # on another host
    ring = None if routed else _attach_feed_ring(mgr)
    # the largest record one ring frame can carry (u32 frame length)
    wire_cap = min(ring.capacity, (1 << 32) - 4) if ring else 0
    ring_min_row = int(os.environ.get("TFOS_SHM_RING_MIN_ROW_BYTES", "4096"))
    ring_forced = os.environ.get("TFOS_SHM_FEED") == "force"
    ring_choice = []  # decided at the first block, sticky per task
    wire_sent = [0]

    def _use_ring(rows):
        if ring is None:
            return False
        if ring_forced:
            return True
        if not ring_choice:
            ring_choice.append(_row_bytes(rows[0]) >= ring_min_row)
            if not ring_choice[0]:
                logger.info("rows ~%dB < TFOS_SHM_RING_MIN_ROW_BYTES=%d: "
                            "shipping via queue", _row_bytes(rows[0]),
                            ring_min_row)
        return ring_choice[0]

    def _encode(rows, use_ring):
        actions = []
        _encode_into(rows, use_ring, wire_cap, actions)
        return actions

    def _push_action(action):
        # always on this thread: the ring has a single producer
        if action[0] == "queue":
            _queue_put_retry(queue, action[1])
            return
        push = ring.pushv if action[0] == "pushv" else ring.push
        push(action[1], timeout=feed_timeout,
             error_check=lambda: _check_error_queue(mgr, err_q, local_eid))
        wire_sent[0] += action[2]

    count = 0
    block = []
    shipper = _PipelinedShipper(_encode, _push_action,
                                workers=FEED_PIPELINE_WORKERS,
                                depth=FEED_PIPELINE_DEPTH)
    try:
        for item in iterator:
            count += 1
            block.append(item)
            if len(block) >= FEED_BLOCK_SIZE:
                shipper.ship(block, _use_ring(block))
                block = []
        if block:
            shipper.ship(block, _use_ring(block))
        shipper.close()
    except BaseException:
        shipper.abort()
        raise
    # wait for consumption, surfacing compute errors promptly (the error
    # queue is polled about once a second; the wake-up stays at 0.1 s)
    deadline = time.monotonic() + feed_timeout
    next_err_poll = 0.0

    def _check_held():
        # a hold that lands while rows are in flight parks the compute
        # process that was to drain them: fail fast, so the elastic
        # requeue re-feeds this partition to a live peer
        try:
            cstate = mgr.get("compute_state")._getvalue()
        except Exception:  # noqa: BLE001 - the kv is best effort
            return
        if cstate == "held":
            raise RuntimeError("executor {0} held by remediation while "
                               "batches were in flight; failing fast so "
                               "the partition requeues".format(local_eid))

    def _poll():
        nonlocal next_err_poll
        if time.monotonic() >= next_err_poll:
            _check_error_queue(mgr, err_q, local_eid)
            _check_held()
            next_err_poll = time.monotonic() + 1.0
        if time.monotonic() >= deadline:
            raise RuntimeError("timed out waiting for consumption of all "
                               "batches (feed_timeout exceeded)")

    if ring is not None:
        while True:
            size = ring.size()
            if size < 0:
                raise RuntimeError("feed ring segment corrupt during the "
                                   "drain wait")
            if size == 0:
                break
            _poll()
            time.sleep(0.05)
    joiner = _JoinWatcher(queue)
    while not joiner.wait(0.1):
        _poll()
    _check_error_queue(mgr, err_q, local_eid)
    if pid is not None:
        # every row was consumed: the partition is delivered, and becomes
        # committed when the compute process checkpoints past it
        mgr.ledger("deliver", pid)
    logger.info("fed %d items (%d ring wire bytes)", count, wire_sent[0])
    return []


def inference(cluster_info, cluster_meta, feed_timeout=600, qname="input"):
    """The inference map function: a ``functools.partial`` of
    :func:`inference_partition`."""
    return functools.partial(inference_partition, cluster_info,
                             cluster_meta, feed_timeout, qname)


def inference_partition(cluster_info, cluster_meta, feed_timeout, qname,
                        iterator):
    """Feed one partition through the node's queue as row Blocks closed
    by an ``EndPartition``, wait until it is consumed, then drain
    exactly as many results from the node's output queue (one result
    per row, in order)."""
    local_eid = _local_executor_id()
    mgr, queue_in = _manager_first_call(cluster_info, local_eid,
                                        lambda m: m.get_queue(qname))
    count = 0
    block = []
    for item in iterator:
        count += 1
        block.append(item)
        if len(block) >= FEED_BLOCK_SIZE:
            _queue_put_retry(queue_in, Block(block))
            block = []
    if block:
        _queue_put_retry(queue_in, Block(block))
    _queue_put_retry(queue_in, EndPartition())
    if count == 0:
        return []
    err_q = mgr.get_queue("error")
    deadline = time.monotonic() + feed_timeout
    joiner = _JoinWatcher(queue_in)
    while not joiner.wait(0.1):
        _check_error_queue(mgr, err_q, local_eid)
        if time.monotonic() >= deadline:
            raise RuntimeError("timed out waiting for inference "
                               "consumption (feed_timeout exceeded)")
    _check_error_queue(mgr, err_q, local_eid)
    queue_out = mgr.get_queue("output")
    results = []
    while count > 0:
        item = queue_out.get(block=True)
        queue_out.task_done()
        if isinstance(item, Block):
            results.extend(item.items)
            count -= len(item.items)
        else:
            results.append(item)
            count -= 1
    logger.info("returning %d inference results", len(results))
    return results


def _check_error_queue(mgr, err_queue=None, executor_id=None):
    """Raise if the node's compute process posted an error, naming the
    executor; the error is re-queued first so later tasks (and shutdown)
    see it too."""
    q = err_queue if err_queue is not None else mgr.get_queue("error")
    try:
        try:
            error = q.get(block=False)
        except (OSError, TypeError):
            # the GC closing the shared proxy connection mid-send, as in
            # _queue_put_retry: the request never reached the server
            logger.warning("error-queue poll hit a closed manager "
                           "connection; retrying once on a fresh "
                           "connection", exc_info=True)
            error = q.get(block=False)
    except _queue_mod.Empty:
        return
    q.task_done()
    q.put(error)
    raise RuntimeError("compute process of executor {0} failed:\n{1}".format(
        "?" if executor_id is None else executor_id, error))


class _JoinWatcher(object):
    """Runs ``queue.join()`` on a daemon thread so the caller can poll
    with a timeout and error checks."""

    def __init__(self, queue):
        self._t = threading.Thread(target=self._join, args=(queue,),
                                   daemon=True)
        self._t.start()

    @staticmethod
    def _join(queue):
        try:
            queue.join()
        except (EOFError, OSError):
            pass  # the manager went away; the caller's checks report it

    def wait(self, timeout):
        """True once the queue fully drained (within ``timeout``)."""
        self._t.join(timeout)
        return not self._t.is_alive()
