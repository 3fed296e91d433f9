"""Per-executor node runtime: role assignment, process launch, data plane
(port of the JAX package's ``cluster/node.py``; original:
tensorflowonspark/TFSparkNode.py).

Each executor runs :func:`start_node` exactly once at cluster startup.
It

1. claims its executor id (from the start-partition payload),
2. derives its role (job_name, task_index) from the cluster template,
3. starts the per-node :mod:`.manager` with the node's queues,
4. registers with the rendezvous server and blocks on the startup
   barrier,
5. assembles the cluster spec and the ``torch.distributed`` plan (a
   coordinator address and a dense rank per compute node),
6. allocates GPUs by host-local rank and sets ``CUDA_VISIBLE_DEVICES``
   (``num_chips_per_node``), and
7. launches the user's ``main_fun(args, ctx)``: in a spawned compute
   process under a :class:`~.supervisor.Supervisor` for
   ``InputMode.SPARK``, or in the foreground for
   ``InputMode.TENSORFLOW``.

The feed map function (:func:`feed_partition`) reconnects to the node's
manager from whatever executor the feed task landed on, ships the rows
as :class:`~.marker.ColumnarBlock`s (or row :class:`~.marker.Block`s)
and polls the node's error queue while it waits for consumption.
Teardown is driver-direct (``TPUCluster.shutdown``).

Every map function here is a module-level function, bound with
``functools.partial``: the engine ships them with the standard
``pickle``, which refuses closures.  Nothing here imports ``torch`` at
module level and nothing on the executor side initialises CUDA (the
executor forks its queue manager, and a CUDA context does not survive a
fork); only the spawned compute process touches the GPU.

Not ported (ROADMAP queue A): the shared-memory feed ring
(``TFOS_SHM_FEED``), ``inference``, ps/evaluator service nodes,
tensorboard, the telemetry publishers, the flight recorder, chaos hooks
and elastic partition ledgers.
"""

import collections
import functools
import json
import logging
import multiprocessing
import os
import pickle
import queue as _queue_mod
import socket
import threading
import time
import uuid

from . import gpu_info, manager, reservation
from .marker import Block, pack_columnar
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


class NodeContext(object):
    """Cluster metadata for the user's ``main_fun(args, ctx)``.

    Attributes: ``executor_id``, ``job_name``, ``task_index``,
    ``cluster_spec``, ``num_workers``, ``default_fs``, ``working_dir``,
    ``mgr`` (the node's manager proxy), ``coordinator`` (``host:port``
    of rank 0's ``torch.distributed`` store), ``process_id`` /
    ``num_processes`` (this node's rank among the compute nodes) and
    ``device_info``.
    """

    def __init__(self, executor_id=0, job_name="", task_index=0,
                 cluster_spec=None, default_fs="file://", working_dir=".",
                 mgr=None, coordinator=None, process_id=0, num_processes=1,
                 device_info=None, manager_addr=None, manager_authkey=None):
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
        ``gloo``; rank 0 hosts the TCP store at :attr:`coordinator`.
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
            dist.init_process_group(
                backend, init_method="tcp://" + self.coordinator,
                world_size=self.num_processes, rank=self.process_id)
            dp.set_host_group(
                None if backend == "gloo" else dist.new_group(backend="gloo"))
        return dist

    def mesh(self, axes=None):
        raise not_ported("NodeContext.mesh",
                         "multi-GPU DP over torch.distributed")


def _cluster_template(num_executors, master_node=None):
    """Map job names to executor-id lists: an optional master/chief
    first, then workers."""
    template = {}
    idx = 0
    if master_node:
        template[master_node] = [idx]
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


def _local_executor_workdir():
    from ..engine import TFOS_EXECUTOR_WORKDIR

    return os.environ.get(TFOS_EXECUTOR_WORKDIR, os.getcwd())


def _local_executor_id():
    """The executor id claimed by this executor's start task."""
    from ..utils.env import read_executor_id

    return read_executor_id(_local_executor_workdir())


def _compute_process_main(fn_bytes, args, ctx):
    """Entry point of the spawned compute process: rebind the manager
    proxy, run the user fn, ship any traceback home via the node's error
    queue, and mark ``compute_state`` 'finished' or 'failed'."""
    import traceback

    from ..utils.retry import retry_call

    authkey = bytes.fromhex(ctx.manager_authkey)
    multiprocessing.current_process().authkey = authkey
    ctx.mgr = retry_call(
        lambda: manager.connect(tuple(ctx.manager_addr), authkey),
        "connect to node manager at {0}".format(tuple(ctx.manager_addr)),
        exceptions=(OSError, EOFError), deadline=30.0, base=0.1,
    )
    try:
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
    # outside the user-fn try: a failure to *signal* is not a compute
    # failure; shutdown() polls this instead of sleeping blindly
    try:
        ctx.mgr.set("compute_state", "finished")
    except Exception:  # noqa: BLE001 - shutdown falls back to its window
        logger.exception("unable to report completion to manager")


def run(fn, args, cluster_meta, input_mode):
    """The start-job map function executed once per executor: a
    ``functools.partial`` of :func:`start_node` (picklable by reference).

    Args:
      fn: user ``main_fun(args, ctx)``, module-level.
      args: opaque user args.
      cluster_meta: dict from the driver: ``id``, ``cluster_template``,
        ``num_executors``, ``default_fs``, ``server_addr``,
        ``reservation_timeout``, ``queues``, ``num_chips_per_node``,
        ``heartbeat_interval``.
      input_mode: ``InputMode.SPARK`` feeds data through the engine and
        runs ``fn`` in a spawned compute process; ``InputMode.TENSORFLOW``
        runs it in the foreground, reading its own data.
    """
    return functools.partial(start_node, pickle.dumps(fn), args,
                             cluster_meta, input_mode)


def start_node(fn_bytes, args, cluster_meta, input_mode, iterator):
    """Body of :func:`run` (see the module docstring's steps)."""
    from ..utils.env import write_executor_id
    from .cluster import InputMode

    if (input_mode == InputMode.SPARK
            and os.environ.get("TFOS_SHM_FEED") in ("1", "force")):
        raise not_ported("TFOS_SHM_FEED", "device_preprocess and the shm ring")

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
            raise RuntimeError("TFOS node already running on executor {0}; "
                               "duplicate start task".format(executor_id))

    # 3. the per-node queue manager, reachable by the driver ('remote')
    authkey = uuid.uuid4().bytes
    queues = list(cluster_meta.get("queues", ["input", "output", "error"]))
    if "error" not in queues:
        queues.append("error")
    mgr, addr = manager.start(authkey, queues, mode="remote")
    _LOCAL_MANAGERS.append(mgr)  # keepalive for the executor lifetime
    mgr.set("state", "running")
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

    # rendezvous registration + startup barrier
    node_meta = {
        "executor_id": executor_id,
        "host": host,
        "job_name": job_name,
        "task_index": task_index,
        "addr": list(adv_addr),
        "authkey": authkey.hex(),
        "port": coord_port,
        "device_info": _safe_device_info(),
    }
    client = reservation.Client(cluster_meta["server_addr"])
    client.register(node_meta)
    cluster_info = client.await_reservations(
        timeout=cluster_meta.get("reservation_timeout", 600))
    client.close()

    # 5. cluster spec sorted by executor id
    spec, coordinator, process_ranks = build_cluster_spec(cluster_info)

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
    if input_mode == InputMode.SPARK:
        from . import supervisor as _supervisor

        sup = _supervisor.Supervisor(fn_bytes, args, ctx, mgr, cluster_meta,
                                     node_meta)
        sup.start()
        _supervisor.register_local_supervisor(sup)
        # the executor returns at once, free for feed tasks; the compute
        # process keeps running
    else:
        # TENSORFLOW input mode: the fn reads its own data in this
        # process, pinning the executor; a heartbeater keeps the driver's
        # monitor informed
        ctx.mgr = mgr
        hb = reservation.Heartbeater(
            cluster_meta["server_addr"], executor_id,
            interval=cluster_meta.get("heartbeat_interval"), host=host,
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
    """Feeder-side encode pipeline: a small worker pool packs block N+1
    into columns while the caller's iterator produces block N+2 and this
    thread puts block N (the put pickles it).
    Submission order is preserved and all puts stay on the submitting
    thread; worker errors re-raise there at the next ``ship``/``close``.
    """

    def __init__(self, encode, push, workers=2, depth=4):
        from concurrent.futures import ThreadPoolExecutor

        self._encode = encode
        self._push = push
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                        thread_name_prefix="feed-encode")
        self._depth = max(1, depth)
        self._pending = collections.deque()

    def ship(self, rows):
        while len(self._pending) >= self._depth:
            self._drain_one()
        self._pending.append(self._pool.submit(self._encode, rows))
        while self._pending and self._pending[0].done():
            self._drain_one()

    def _drain_one(self):
        self._push(self._pending.popleft().result())

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


def train(cluster_info, cluster_meta, feed_timeout=600, qname="input"):
    """The feeder map function for training data: a ``functools.partial``
    of :func:`feed_partition`."""
    return functools.partial(feed_partition, cluster_info, cluster_meta,
                             feed_timeout, qname)


def feed_partition(cluster_info, cluster_meta, feed_timeout, qname,
                   iterator):
    """Ship one partition into the local node's input queue, then wait
    until the compute process has taken every block, raising if it
    reported an error or ``feed_timeout`` passes."""

    def _probe(m):
        return str(m.get("state")._getvalue())

    local_eid = _local_executor_id()
    mgr, state = _manager_first_call(cluster_info, local_eid, _probe)
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
    count = 0
    block = []
    shipper = _PipelinedShipper(
        _pack, functools.partial(_queue_put_retry, queue),
        workers=FEED_PIPELINE_WORKERS, depth=FEED_PIPELINE_DEPTH)
    try:
        for item in iterator:
            count += 1
            block.append(item)
            if len(block) >= FEED_BLOCK_SIZE:
                shipper.ship(block)
                block = []
        if block:
            shipper.ship(block)
        shipper.close()
    except BaseException:
        shipper.abort()
        raise
    # wait for consumption, surfacing compute errors promptly (the error
    # queue is polled about once a second; the wake-up stays at 0.1 s)
    deadline = time.monotonic() + feed_timeout
    next_err_poll = 0.0
    joiner = _JoinWatcher(queue)
    while not joiner.wait(0.1):
        if time.monotonic() >= next_err_poll:
            _check_error_queue(mgr, err_q, local_eid)
            next_err_poll = time.monotonic() + 1.0
        if time.monotonic() >= deadline:
            raise RuntimeError("timed out waiting for consumption of all "
                               "batches (feed_timeout exceeded)")
    _check_error_queue(mgr, err_q, local_eid)
    logger.info("fed %d items", count)
    return []


def _check_error_queue(mgr, err_queue=None, executor_id=None):
    """Raise if the node's compute process posted an error, naming the
    executor; the error is re-queued first so later tasks (and shutdown)
    see it too."""
    q = err_queue if err_queue is not None else mgr.get_queue("error")
    try:
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
