"""Replica set: N serving engines with per-replica lifecycle (port of the
JAX package's ``fleet/replica.py``).

A :class:`Replica` is one continuous-batching engine
(:class:`~tensorflowonspark_tpu_torch.serving_engine.ServingEngine`) and
what makes it routable: a feed queue, a worker thread that drives the
engine's scheduling loop, the bookkeeping that pairs fleet request ids
with the engine's input-order outputs, and the post-mortem wreckage from
which the router re-dispatches a dead replica's work from its committed
tokens.

A :class:`ReplicaSet` owns N of them.  The replicas are in-process
engines, each with its own
:class:`~tensorflowonspark_tpu_torch.models.transformer.SlotDecoder`, KV
pool and radix prefix cache (``serving_builder`` predictors expose
``make_replica()`` for this); the router touches only ``dispatch`` /
``load`` / the completion queue, so an engine behind another transport
fits the same seam (``engine_factory``).

On the card each replica keeps all of its work on one thread and one
CUDA stream of its own: a host readback of one
replica's chunk then waits for that replica's kernels only, not for its
siblings' on a shared stream.  The stream first waits for the work that
built the replica's weights.

The replica feed uses the engine's source heartbeat protocol
(:meth:`ServingEngine._pull_one`): between arrivals the feed yields
``None``, so an idle engine still runs its lifecycle pass (a rolling
deploy's swap lands on a drained replica) and a busy engine never blocks
a decode chunk waiting on the queue.
"""

import contextlib
import logging
import queue as queue_mod
import threading

from tensorflowonspark_tpu_torch import serving_engine

logger = logging.getLogger(__name__)

#: feed-queue sentinel: the replica finishes in-flight work and exits
_STOP = object()

#: replica lifecycle states (the router manages them): ``live`` takes
#: traffic, ``routed_around`` only probe traffic (a slow or quarantined
#: replica working off its backlog), ``draining`` none (a rolling deploy
#: quiescing it), ``dead`` is terminal
STATES = ("live", "routed_around", "draining", "dead")


class ReplicaKilled(RuntimeError):
    """A chaos ``kill_replica`` fault fired inside this replica's decode
    dispatch: the in-process stand-in for a replica's death mid-decode
    (:mod:`..testing.chaos`)."""


class ReplicaDeviceError(RuntimeError):
    """A device error inside this replica's engine (a CUDA runtime error,
    or the chaos ``device_error`` stand-in).  Unlike
    :class:`ReplicaKilled` it is not terminal: the host-side scheduler
    survived, so the replica posts its wreckage for re-dispatch,
    quarantines (routed around), rebuilds its engine and serves probe
    traffic until clean rounds re-admit it.  A sticky CUDA error leaves
    the process's context unusable, which no in-process rebuild recovers
    from; the chaos fault is what the tests and the card drive."""


#: exception type names treated as device errors when they surface inside
#: a replica's serve loop (torch's runtime error classes, matched by name)
_DEVICE_ERROR_NAMES = ("AcceleratorError", "OutOfMemoryError")

#: engine stats keys that stay cumulative across a quarantine rebuild (a
#: fresh engine resets the shared stats dict in place; the ledger's rows
#: summing to the fleet's decode wall needs the earlier spend kept)
_CUMULATIVE_STATS = (
    "admitted", "completed", "chunks", "errors", "shed", "expired",
    "degraded", "watchdog_fires", "recovered", "request_wire_bytes",
    "prefix_hits", "prefix_tokens_saved", "evictions",
    "pressure_evictions", "swaps", "swap_requeued", "drained",
    "decode_wall_sec", "tokens_out", "prefill_wall_sec",
    "prefill_watchdog_fires", "prefill_worker_deaths",
    "prefill_restarts", "leases_reaped",
)


def _is_device_error(exc):
    """Does ``exc`` look like a device fault (quarantinable) rather than
    a scheduler bug or a chaos kill (terminal)?"""
    if isinstance(exc, ReplicaDeviceError):
        return True
    return type(exc).__name__ in _DEVICE_ERROR_NAMES


def _cuda_device(device):
    """``device`` as a CUDA :class:`torch.device`, or None off the card
    (or when ``device`` is None)."""
    if device is None:
        return None
    import torch

    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


class Replica(object):
    """One routable serving engine (see the module docstring).

    Args:
      replica_id: stable int id (chaos plans and journal events name
        replicas by it).
      predict: this replica's own generation predictor.
      input_mapping: the engine-level mapping (the router's: the user
        mapping plus its internal budget and trace columns).
      completions: the router's shared completion queue; the worker posts
        ``("done", rid, fid, row)``, ``("dead", rid, wreck)``,
        ``("quarantine", rid, wreck)`` and ``("stopped", rid)``.
      num_slots / chunk / queue_depth / engine_opts: forwarded to
        :class:`ServingEngine` (policy always ``block``: fleet admission
        sheds before any one engine would).
      engine_factory: builds the engine (default an in-process
        ``ServingEngine``).
      fault_fn: chunk-dispatch fault hook (chaos ``kill_replica`` /
        ``device_error`` / ``slow_replica``); defaults to the plan's
        :func:`~..testing.chaos.replica_fault_fn`.
      device: ``"cuda:i"`` to pin the replica to card ``i`` (entered in
        its own thread, and around its engine's construction), or None
        (the predictor's own device).
      poll_sec: idle feed-poll interval (the heartbeat cadence: also how
        often an idle replica runs its lifecycle pass).
    """

    def __init__(self, replica_id, predict, input_mapping, completions,
                 *, num_slots=4, chunk=None, queue_depth=None,
                 engine_opts=None, engine_factory=None, fault_fn=None,
                 device=None, poll_sec=0.02):
        self.replica_id = int(replica_id)
        self.predict = predict
        self.state = "live"
        self.error = None
        self.device = _cuda_device(device)
        self._poll_sec = float(poll_sec)
        self._completions = completions
        self._q = queue_mod.Queue()
        self._submitted = []   # fleet id per engine input index
        self._emitted = 0
        self.stats = {}
        if fault_fn is None:
            from tensorflowonspark_tpu_torch.testing import chaos

            fault_fn = chaos.replica_fault_fn(self.replica_id)
        opts = dict(engine_opts or {})
        if fault_fn is not None:
            opts["wedge_fn"] = fault_fn
        if engine_factory is None:
            engine_factory = serving_engine.ServingEngine
        # construction knobs kept so that a quarantined replica rebuilds
        # its engine in place (_rebuild_engine)
        self._engine_factory = engine_factory
        self._input_mapping = input_mapping
        self._num_slots = num_slots
        self._chunk = chunk
        self._queue_depth = queue_depth
        self._opts = opts
        self.stream = None
        dev = self.device or _cuda_device(getattr(predict, "device", None))
        if dev is not None:
            import torch

            self.stream = torch.cuda.Stream(dev)
            # the weights were built on this thread's stream
            self.stream.wait_stream(torch.cuda.current_stream(dev))
        self.engine = self._build_engine()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="fleet-replica-%d" % self.replica_id,
        )

    def _scope(self):
        """The replica's device and stream, entered by each thread that
        works for it (both are per thread in torch)."""
        if self.stream is not None:
            import torch

            return torch.cuda.stream(self.stream)
        if self.device is not None:
            import torch

            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _build_engine(self):
        """Build this replica's engine inside :meth:`_scope`: its decoder
        state lives on the replica's card, and its watchdog thread takes
        the replica's stream."""
        with self._scope():
            return self._engine_factory(
                self.predict, self._input_mapping, None, self._num_slots,
                chunk=self._chunk, queue_depth=self._queue_depth,
                policy="block", on_error="record", stats=self.stats,
                **self._opts
            )

    def _rebuild_engine(self):
        """Rebuild the engine after a quarantined device error.  The
        predictor memoizes its SlotDecoder, so the rebuilt engine reuses
        it; the decoder's slots reset (freeing the quarantined
        incarnation's pages), the submit/emit pairing restarts with the
        fresh engine's input numbering, and the counters a fresh engine
        zeroes in the shared stats dict are restored cumulatively."""
        prior = {
            k: v for k, v in self.stats.items()
            if k in _CUMULATIVE_STATS
            and isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        reset = getattr(getattr(self.engine, "decoder", None), "reset",
                        None)
        if reset is not None:
            try:
                reset()
            except Exception:  # noqa: BLE001 - a broken decoder must not
                logger.warning(  # stop the quarantine rebuild
                    "replica %d: decoder reset failed during quarantine "
                    "rebuild", self.replica_id, exc_info=True)
        self._submitted = []
        self._emitted = 0
        self.engine = self._build_engine()
        for k, v in prior.items():
            cur = self.stats.get(k)
            if isinstance(cur, (int, float)) and not isinstance(cur, bool):
                self.stats[k] = cur + v

    # -- lifecycle ------------------------------------------------------

    def start(self):
        if self._thread.ident is None:  # idempotent
            self._thread.start()
        return self

    def close(self):
        """Ask the worker to finish in-flight work and exit (the engine
        drains its slots, then the feed's STOP ends it)."""
        self._q.put(_STOP)

    def join(self, timeout=30.0):
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    @property
    def alive(self):
        return self.state != "dead"

    # -- routing surface ------------------------------------------------

    def dispatch(self, fid, row):
        """Hand one prepared engine row to this replica's feed."""
        self._q.put((int(fid), row))

    def load(self):
        """The router's placement signal: the engine's
        :meth:`~ServingEngine.load` snapshot plus the rows parked in the
        replica feed that the engine has not pulled yet."""
        snap = self.engine.load()
        snap["queued"] += self._q.qsize()
        snap["replica"] = self.replica_id
        snap["state"] = self.state
        return snap

    def capacity(self):
        """Requests this replica can hold (slots + engine queue bound):
        the router never assigns beyond it (spill before shed)."""
        return int(self.engine.num_slots) + int(self.engine.queue_depth)

    # -- the worker -----------------------------------------------------

    def _source(self):
        """The engine feed: rows as they arrive, ``None`` heartbeats
        between arrivals (never blocking a busy engine), blocking
        ``poll_sec`` at a time when the engine is idle so that an idle
        replica still runs its lifecycle pass."""
        while True:
            try:
                # the source runs inside serve(), on the engine's own
                # thread: reading _slot_req here is safe
                if self.engine._slot_req:
                    item = self._q.get_nowait()
                else:
                    item = self._q.get(timeout=self._poll_sec)
            except queue_mod.Empty:
                yield None
                continue
            if item is _STOP:
                return
            fid, row = item
            self._submitted.append(fid)
            yield row

    def _run(self):
        with self._scope():
            while self._drive(self.engine.serve(self._source())) \
                    == "quarantine":
                # a contained device error: rebuild the engine in place
                # and go on serving (probe traffic while routed around,
                # full traffic once clean rounds re-admit the replica)
                try:
                    self._rebuild_engine()
                except BaseException as e:  # noqa: BLE001 - a failed
                    self.state = "dead"     # rebuild is a death
                    self.error = e
                    logger.warning("fleet replica %d: quarantine rebuild "
                                   "failed, replica is dead: %s",
                                   self.replica_id, e)
                    self._completions.put((
                        "dead", self.replica_id,
                        {"finished": {}, "committed": {}, "queued": []},
                    ))
                    return

    def _drive(self, serve):
        try:
            for out in serve:
                fid = self._submitted[self._emitted]
                self._emitted += 1
                self._completions.put(("done", self.replica_id, fid, out))
        except BaseException as e:  # noqa: BLE001 - death is a message
            self.error = e
            if _is_device_error(e):
                # the host-side scheduler survived a device fault:
                # quarantine instead of dying; the wreckage still posts
                # (the router re-dispatches it on a survivor)
                self.state = "routed_around"
                logger.warning("fleet replica %d quarantined on device "
                               "error: %s", self.replica_id, e)
                self._completions.put(
                    ("quarantine", self.replica_id, self._wreckage()))
                return "quarantine"
            self.state = "dead"
            logger.warning("fleet replica %d died: %s", self.replica_id, e)
            self._completions.put(
                ("dead", self.replica_id, self._wreckage()))
            return "dead"
        self._completions.put(("stopped", self.replica_id))
        return "stopped"

    def _wreckage(self):
        """What a dead replica owes the router (its host-side scheduler
        state outlives the decode dispatch):

        - ``finished``: fleet id -> output row, requests the engine
          completed but had not emitted yet (behind an earlier request in
          its reorder buffer); delivered as they are;
        - ``committed``: fleet id -> committed token list, requests in
          flight (or queued again after a requeue) at the death; the
          router re-dispatches each from these tokens (greedy
          continuations are token-identical);
        - ``queued``: fleet ids never pulled from the feed (and any the
          engine took but finished nowhere), re-dispatched from scratch.
        """
        eng = self.engine
        finished, committed, queued, accounted = {}, {}, [], set()
        for idx, row in eng._finished.items():
            if idx < len(self._submitted):
                finished[self._submitted[idx]] = row
                accounted.add(idx)
        for req in list(eng._slot_req.values()) + list(eng._pending):
            idx = req["idx"]
            if idx < len(self._submitted):
                committed[self._submitted[idx]] = [
                    t for t in (req["out"] or []) if isinstance(t, int)
                ]
                accounted.add(idx)
            # the spend this request accrued here settles on its ledger
            # row now (a dead replica's terminal points never run); the
            # surviving replica's row goes on from it
            try:
                eng._ledger_settle(req, close=False)
            except Exception as e:  # noqa: BLE001 - accounting never
                logger.debug(  # breaks the wreckage
                    "wreckage ledger flush failed for %r: %s",
                    req.get("rid"), e)
        saw_stop = False
        while True:
            try:
                item = self._q.get_nowait()
            except queue_mod.Empty:
                break
            if item is _STOP:
                saw_stop = True
            else:
                queued.append(item[0])
        if saw_stop:
            # a close() raced the fault: a quarantined replica's rebuilt
            # loop still honours it
            self._q.put(_STOP)
        for idx in range(self._emitted, len(self._submitted)):
            if idx not in accounted:
                queued.append(self._submitted[idx])
        return {"finished": finished, "committed": committed,
                "queued": queued}


class ReplicaSet(object):
    """N replicas of one generation predictor (see the module docstring).

    Args:
      predict: a generation predictor (``serving_builder(mode=
        "generate")``).  Replica 0 serves it; replicas 1..N-1 are built
        by ``predict.make_replica()``.  ``predict_factory`` builds each
        one instead (tests with fake decoders).
      n: replica count.
      input_mapping: engine-level mapping (see :class:`Replica`).
      completions: the router's completion queue (built here when the set
        stands alone).
      devices: ``"spread"`` pins replica ``i`` to
        ``cuda:{i % device_count()}`` (its predictor is built there too),
        None leaves placement to each predictor.
      num_slots / chunk / queue_depth / engine_opts / poll_sec:
        per-replica engine knobs, forwarded to :class:`Replica`.
    """

    def __init__(self, predict, n, input_mapping, *, completions=None,
                 predict_factory=None, num_slots=4, chunk=None,
                 queue_depth=None, engine_opts=None, devices=None,
                 poll_sec=0.02):
        n = int(n)
        if n < 1:
            raise ValueError("need at least one replica, got %d" % n)
        self.completions = (completions if completions is not None
                            else queue_mod.Queue())
        devs = None
        if devices == "spread":
            import torch

            count = torch.cuda.device_count() if \
                torch.cuda.is_available() else 0
            devs = ["cuda:%d" % i for i in range(count)] or None
        # construction knobs kept for spawn(), which builds a late
        # replica exactly like the first ones
        self._predict = predict
        self._predict_factory = predict_factory
        self._input_mapping = input_mapping
        self._num_slots = num_slots
        self._chunk = chunk
        self._queue_depth = queue_depth
        self._engine_opts = engine_opts
        self._devs = devs
        self._poll_sec = poll_sec
        self.replicas = []
        for i in range(n):
            predict_i = predict if (i == 0 and predict_factory is None) \
                else self._new_predict(i, n)
            self.replicas.append(self._build(i, predict_i))

    def _device_of(self, rid):
        return self._devs[rid % len(self._devs)] if self._devs else None

    def _new_predict(self, rid, n):
        """Replica ``rid``'s predictor, built on its card."""
        if self._predict_factory is not None:
            factory = self._predict_factory
        else:
            factory = getattr(self._predict, "make_replica", None)
            if factory is None:
                raise ValueError(
                    "fleet serving with {0} replicas needs a predictor "
                    "exposing make_replica() (transformer.serving_builder "
                    "generation predictors do): each replica must own its "
                    "decoder; this predictor has none".format(n))
        dev = self._device_of(rid)
        if dev is None:
            return factory()
        import torch

        with torch.cuda.device(dev):
            return factory()

    def _build(self, rid, predict):
        return Replica(
            rid, predict, self._input_mapping, self.completions,
            num_slots=self._num_slots, chunk=self._chunk,
            queue_depth=self._queue_depth, engine_opts=self._engine_opts,
            device=self._device_of(rid), poll_sec=self._poll_sec,
        )

    def spawn(self):
        """Build, append and start one more replica (its id is the next
        list index; the router shares this list, so it is routable once
        this returns): the autoscaling verb."""
        rid = len(self.replicas)
        r = self._build(rid, self._new_predict(rid, rid + 1))
        self.replicas.append(r)
        return r.start()

    def __len__(self):
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def __getitem__(self, rid):
        return self.replicas[rid]

    def start(self):
        for r in self.replicas:
            r.start()
        return self

    def live(self):
        """Replicas currently taking routed traffic."""
        return [r for r in self.replicas if r.state == "live"]

    def load(self):
        """Per-replica load snapshots (the ``/status`` fleet view)."""
        return [r.load() for r in self.replicas]

    # per-replica lifecycle verbs (the router drives them; they are also
    # the operator's surface)
    def drain(self, rid):
        """Stop routing to ``rid`` (a rolling deploy quiesces through
        this); its in-flight work finishes normally."""
        if self.replicas[rid].state != "dead":
            self.replicas[rid].state = "draining"

    def evict(self, rid):
        """Route around ``rid`` (a straggler still completes what it
        holds, and receives probe traffic)."""
        if self.replicas[rid].state != "dead":
            self.replicas[rid].state = "routed_around"

    def readmit(self, rid):
        """Return ``rid`` to full routing."""
        if self.replicas[rid].state != "dead":
            self.replicas[rid].state = "live"

    def close(self, join=True, timeout=30.0):
        for r in self.replicas:
            if r.alive:
                r.close()
        if join:
            for r in self.replicas:
                r.join(timeout=timeout)
