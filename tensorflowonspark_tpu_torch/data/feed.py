"""DataFeed: the compute-process side of the executor data plane (port
of the JAX package's ``data/feed.py``; original:
tensorflowonspark/TFNode.py:221-329).

- ``next_batch(batch_size)`` blocks on the input queue and returns up to
  ``batch_size`` items; a ``None`` sentinel means end-of-feed, an
  ``EndPartition`` marker truncates the batch at a partition boundary.
- With ``input_mapping``, batches come back as a dict of named columns.
- ``next_arrays(batch_size)`` is the columnar fast path: batches are
  sliced out of :class:`~..cluster.marker.ColumnarBlock`s with zero
  per-row Python.
- ``batch_results`` pushes results to the output queue.
- ``terminate`` sets the node state to ``'terminating'`` and drains the
  input queue so blocked feeders are released.
- ``batches(...)`` yields stacked (and optionally padded) numpy batches.
- With ``TFOS_SHM_FEED=1`` the node advertises a shared-memory ring
  (:mod:`.shm_ring`); the feed drains it before the queue, decoding
  columnar wire records as zero-copy views.
- :func:`prefetch_to_device` keeps ``size`` batches in flight to the GPU
  through pinned memory on a side copy stream, optionally widening
  narrow wire dtypes there (:mod:`.preprocess`); :func:`place_tree` is
  the copy it shares with ``SyncTrainer``.

:meth:`DataFeed.wire_stats` has telemetry twins, the
``feed.wire_bytes``, ``feed.wire_records`` and ``feed.wire_rows``
counters of the process registry, which the node's heartbeats carry to
the driver's fleet view.  Nothing here imports ``torch`` at module
level: the driver and executor sides import this module.
"""

import logging
import queue as queue_mod

import numpy as np

from ..cluster.marker import (Block, ColumnarBlock, EndPartition,
                              decode_columnar_record, pack_columnar)
from ..utils.tree import tree_map

logger = logging.getLogger(__name__)


def _decode_ring_record(rec):
    """One ring record as a pending element: a :class:`ColumnarBlock`
    (the columnar wire format, zero-copy views over ``rec``) or a row
    list (a pickled Block or row list; a zero-length record is an empty
    row list)."""
    if not rec:
        return []
    block = decode_columnar_record(rec)
    if block is not None:
        return block
    import pickle

    obj = pickle.loads(rec)
    return obj.items if isinstance(obj, Block) else obj


class DataFeed(object):
    """Consumes feed items from the executor's queue manager inside the
    compute process."""

    def __init__(self, mgr, train_mode=True, qname_in="input",
                 qname_out="output", input_mapping=None):
        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.done_feeding = False
        # sorted column order, as the reference's
        self.input_tensors = (
            sorted(input_mapping.keys()) if input_mapping is not None else None
        )
        #: rows unwrapped from a Block (or a ColumnarBlock) not yet consumed
        self._pending = []
        self._pending_pos = 0
        #: queue proxies are cached: creating one is a manager round trip
        self._qin = None
        self._qout = None
        #: shm feed ring, attached lazily from the manager kv (None:
        #: queue-only feeding)
        self._ring = None
        self._ring_checked = False
        self._ring_producer_warned = False  # one log line per death
        #: the source that produced the last item ("ring" or "queue"):
        #: the fetch blocks on it and polls the other
        self._hot_source = "ring"
        #: wire accounting: payload bytes, records and rows received
        self.wire_bytes = 0
        self.wire_records = 0
        self.wire_rows = 0
        # their registry twins (null metrics when TFOS_TELEMETRY=0)
        from ..telemetry import registry as _registry

        reg = _registry.get_registry()
        self._m_bytes = reg.counter("feed.wire_bytes")
        self._m_records = reg.counter("feed.wire_records")
        self._m_rows = reg.counter("feed.wire_rows")

    def _account(self, nbytes, nrows):
        self.wire_bytes += int(nbytes)
        self.wire_records += 1
        self.wire_rows += int(nrows)
        self._m_bytes.inc(int(nbytes))
        self._m_records.inc()
        self._m_rows.inc(int(nrows))

    def _account_item(self, item):
        if isinstance(item, ColumnarBlock):
            self._account(_columns_nbytes(item.columns), item.count)
        elif isinstance(item, Block):
            self._account(sum(_row_nbytes(r) for r in item.items),
                          len(item.items))
        else:
            self._account(_row_nbytes(item), 1)

    def wire_stats(self):
        """Cumulative feed-plane accounting: ``wire_bytes`` (ring records
        at their exact wire length, queue blocks at payload bytes,
        pickle framing excluded), ``records``, ``rows`` and
        ``bytes_per_row``."""
        return {
            "wire_bytes": self.wire_bytes,
            "records": self.wire_records,
            "rows": self.wire_rows,
            "bytes_per_row": (self.wire_bytes / self.wire_rows
                              if self.wire_rows else 0.0),
        }

    _RING_SENTINEL = object()  # internal: the ring produced a block

    def _fetch(self):
        """Block until the next feed element arrives.  A ring record is
        installed as pending and signalled with ``_RING_SENTINEL``; a
        queue element is returned raw (``task_done`` is left to the
        caller).

        With a ring, both sources are polled, blocking on whichever
        produced last, so either runs at full rate (a switch costs one
        50 ms miss).  Without one, each proxied get is bounded at 1 s and
        retried: an unbounded get parks a thread in the manager server,
        which would outlive a dead consumer and swallow the next item.
        """
        if self._qin is None:
            self._qin = self.mgr.get_queue(self.qname_in)
        if not self._ring_checked:
            self._attach_ring()
        while True:
            if self._ring is None:
                try:
                    return self._qin.get(block=True, timeout=1.0)
                except queue_mod.Empty:
                    continue
            if self._hot_source == "queue":
                try:
                    return self._qin.get(block=True, timeout=0.05)
                except queue_mod.Empty:
                    rec = self._ring_pop(0)
                    if rec is None:
                        continue
                    self._hot_source = "ring"
                    self._install_ring_record(rec)
                    return self._RING_SENTINEL
            rec = self._ring_pop(0.05)
            if rec is not None:
                self._install_ring_record(rec)
                return self._RING_SENTINEL
            try:
                item = self._qin.get(block=False)
            except queue_mod.Empty:
                continue
            self._hot_source = "queue"
            return item

    def _install_ring_record(self, rec):
        """Install one decoded ring record as pending and account its
        exact wire length."""
        self._set_pending(_decode_ring_record(rec))
        self._account(len(rec), self._pending_left())

    def _ring_pop(self, timeout):
        """A ring pop that turns a dead feeder (its pid is announced in
        the ring header) into a logged miss: the feed goes on from the
        queue, where the control sentinels and the cluster's liveness
        checks own the failure.  A new feeder re-announces itself."""
        from . import shm_ring

        try:
            return self._ring.pop(timeout=timeout)
        except shm_ring.ProducerDiedError as e:
            if not self._ring_producer_warned:
                self._ring_producer_warned = True
                logger.warning("%s; falling back to the queue path", e)
            return None

    def _attach_ring(self):
        """Attach the node's shm feed ring if the runtime advertised one,
        unless its wire-format tag is one this package does not know
        (then the feed stays on the queue)."""
        self._ring_checked = True
        try:
            info = self.mgr.get("shm_ring")._getvalue()
        except Exception:  # noqa: BLE001 - kv read is best effort
            info = None
        if not info:
            return
        from . import shm_ring

        ring = shm_ring.ShmRing(info["name"])
        tag = ring.format_tag()
        if tag not in shm_ring.KNOWN_FORMATS:
            logger.warning("shm ring %s carries unknown wire-format tag %d "
                           "(this package knows %s); staying on the queue "
                           "path", info["name"], tag, shm_ring.KNOWN_FORMATS)
            ring.close(unlink=False)
            return
        self._ring = ring
        logger.info("consuming from shm feed ring %s (wire format %d)",
                    info["name"], tag)

    def _set_pending(self, obj):
        self._pending = obj
        self._pending_pos = 0

    def _pending_left(self):
        n = (self._pending.count if isinstance(self._pending, ColumnarBlock)
             else len(self._pending))
        return n - self._pending_pos

    def _pending_rows(self):
        """Row-objects view of the pending element (a columnar block is
        converted once: the row-mode compat path)."""
        if isinstance(self._pending, ColumnarBlock):
            self._pending = self._pending.rows()
        return self._pending

    def next_batch(self, batch_size):
        """Up to ``batch_size`` items from the input queue: a list, or a
        dict of named column lists with ``input_mapping``.  Blocks until
        items arrive or the end-of-feed sentinel is seen."""
        tensors = [] if self.input_tensors is None else {
            tensor: [] for tensor in self.input_tensors}
        count = 0

        def _consume(item):
            if self.input_tensors is None:
                tensors.append(item)
            else:
                for i, tensor in enumerate(self.input_tensors):
                    tensors[tensor].append(item[i])

        while count < batch_size:
            if self._pending_left() > 0:
                _consume(self._pending_rows()[self._pending_pos])
                self._pending_pos += 1
                count += 1
                continue
            if self.done_feeding:
                break  # calls after end-of-feed return what is left
            item = self._fetch()
            if item is self._RING_SENTINEL:
                continue  # _fetch installed the pending block
            if item is None:
                self._qin.task_done()
                self.done_feeding = True
                break
            if isinstance(item, (Block, ColumnarBlock)):
                self._set_pending(item.items if isinstance(item, Block)
                                  else item)
                self._account_item(item)
            elif isinstance(item, EndPartition):
                if count > 0:
                    self._qin.task_done()
                    break
            else:
                _consume(item)
                self._account_item(item)
                count += 1
            self._qin.task_done()
        return tensors

    def next_arrays(self, batch_size):
        """Columnar fast path: a batch as stacked numpy columns.

        Returns ``(columns, count)``: ``columns`` is a tuple of arrays
        (tuple/list rows), a dict of arrays (dict rows or
        ``input_mapping``) or a single array (scalar rows); ``count`` is
        the number of rows (< ``batch_size`` at a partition boundary; 0
        with ``columns=None`` at end-of-feed).  Row Blocks interleaved in
        the stream are stacked as a fallback.
        """
        pieces = []
        count = 0
        scalar = False
        while count < batch_size:
            left = self._pending_left()
            if left == 0 and self.done_feeding:
                break
            if left > 0:
                take = min(batch_size - count, left)
                pos = self._pending_pos
                if isinstance(self._pending, ColumnarBlock):
                    cols = self._pending.columns
                    pieces.append(
                        {k: v[pos:pos + take] for k, v in cols.items()}
                        if isinstance(cols, dict)
                        else tuple(c[pos:pos + take] for c in cols))
                    scalar = scalar or self._pending._scalar
                else:
                    blk = pack_columnar(self._pending[pos:pos + take])
                    if blk is None:
                        raise TypeError(
                            "next_arrays() requires fixed-shape numeric "
                            "rows; use next_batch() for object rows")
                    scalar = scalar or blk._scalar
                    pieces.append(blk.columns)
                self._pending_pos += take
                count += take
                continue
            item = self._fetch()
            if item is self._RING_SENTINEL:
                continue
            if item is None:
                self._qin.task_done()
                self.done_feeding = True
                break
            if isinstance(item, ColumnarBlock):
                self._set_pending(item)
                self._account_item(item)
            elif isinstance(item, Block):
                self._set_pending(item.items)
                self._account_item(item)
            elif isinstance(item, EndPartition):
                if count > 0:
                    self._qin.task_done()
                    break
            else:
                self._set_pending([item])
                self._account_item(item)
            self._qin.task_done()
        if count == 0:
            return None, 0
        cols = _concat_pieces(pieces)
        if self.input_tensors is not None:
            if isinstance(cols, dict):
                cols = {k: cols[k] for k in self.input_tensors}
            else:
                seq = (cols,) if not isinstance(cols, tuple) else cols
                cols = dict(zip(self.input_tensors, seq))
        elif scalar and isinstance(cols, tuple) and len(cols) == 1:
            cols = cols[0]
        return cols, count

    def should_stop(self):
        """True once the end-of-feed sentinel was seen."""
        return self.done_feeding

    def commit_partitions(self):
        """Promote every *delivered* feed partition to *committed* in
        this node's :class:`~..cluster.manager.PartitionLedger`.

        Call it right after a checkpoint save was made durable
        (``Checkpointer.save(..., wait=True)``): a committed partition
        is one the elastic restart path never requeues, so committing
        before durability would turn a crash into silent data loss.
        ``train_on_feed(checkpointer=...)`` does it in that order.
        Returns the number of partitions promoted (0 when feeding is
        not elastic: the ledger is empty)."""
        try:
            return int(self.mgr.ledger("commit")._getvalue())
        except Exception:  # noqa: BLE001 - the requeue stays conservative
            logger.warning("partition-ledger commit failed; partitions stay "
                           "requeue-eligible", exc_info=True)
            return 0

    def batch_results(self, results):
        """Push a batch of results to the output queue as one Block (one
        manager RPC)."""
        if self._qout is None:
            self._qout = self.mgr.get_queue(self.qname_out)
        self._qout.put(Block(results), block=True)

    def terminate(self):
        """Terminate feeding early: set the node state to 'terminating'
        and drain the ring, then the input queue, so blocked feeders are
        released."""
        import time

        from ..cluster import manager

        logger.info("terminate() invoked")
        self.mgr.set("state", "terminating")
        if not self._ring_checked:
            self._attach_ring()
        if self._ring is not None:
            # release feeders blocked on a full ring: discard until it
            # stays empty for 2 s (an in-flight feeder refills it)
            hard_end = time.monotonic() + 30
            idle_end = time.monotonic() + 2
            ring_count = 0
            while time.monotonic() < min(hard_end, idle_end):
                if self._ring_pop(0.05) is None:
                    continue
                ring_count += 1
                idle_end = time.monotonic() + 2
            logger.info("terminate() drained %d ring blocks", ring_count)
            # a feed outliving its cluster run must not pin the segment
            self._ring.close(unlink=False)
            self._ring = None
        if self._qin is None:
            self._qin = self.mgr.get_queue(self.qname_in)
        count = manager.drain(self._qin, timeout=5)
        logger.info("terminate() drained %d items from input queue", count)

    def batches(self, batch_size, stack=True, pad_to_batch=False):
        """Generator of batches until end-of-feed.

        Args:
          batch_size: items per batch.
          stack: stack each column into a single ``np.ndarray``.
          pad_to_batch: zero-pad the final short batch to ``batch_size``
            and yield ``(batch, n_valid)`` tuples.
        """
        while not self.should_stop():
            batch = self.next_batch(batch_size)
            n = _batch_len(batch)
            if n == 0:
                continue
            if stack:
                batch = _stack_batch(batch)
            if pad_to_batch:
                if n < batch_size:
                    batch = _pad_batch(batch, batch_size)
                yield batch, n
            else:
                yield batch


def _columns_nbytes(cols):
    vals = cols.values() if isinstance(cols, dict) else cols
    return sum(getattr(np.asarray(v), "nbytes", 0) for v in vals)


def _row_nbytes(row):
    """Payload-byte estimate of one row (arrays exact, bytes/str by
    length, everything else 8)."""
    vals = (row.values() if isinstance(row, dict)
            else row if isinstance(row, (tuple, list)) else (row,))
    total = 0
    try:
        for v in vals:
            n = getattr(v, "nbytes", None)
            if n is None:
                n = len(v) if isinstance(v, (bytes, str)) else 8
            total += n
    except TypeError:
        return 0
    return total


def _concat_pieces(pieces):
    """Join per-fragment column sets (single fragment: no copy)."""
    first = pieces[0]
    if len(pieces) == 1:
        return first
    if isinstance(first, dict):
        return {k: np.concatenate([p[k] for p in pieces]) for k in first}
    return tuple(np.concatenate([p[i] for p in pieces])
                 for i in range(len(first)))


def _batch_len(batch):
    if isinstance(batch, dict):
        return len(next(iter(batch.values()))) if batch else 0
    return len(batch)


def _stack_batch(batch):
    """Rows to columnar numpy arrays: homogeneous rows stack in one
    ``np.asarray``; ragged or object rows take the per-row path, whose
    ``np.stack`` raises on ragged shapes."""
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    try:
        arr = np.asarray(batch)
    except ValueError:
        arr = None
    if arr is not None and arr.dtype != object:
        return arr
    return np.stack([np.asarray(r) for r in batch])


def _pad_batch(batch, batch_size):
    def pad(a):
        n = batch_size - a.shape[0]
        if n <= 0:
            return a
        return np.pad(a, [(0, n)] + [(0, 0)] * (a.ndim - 1))

    if isinstance(batch, dict):
        return {k: pad(v) for k, v in batch.items()}
    return pad(batch)


def _resolve_target(sharding):
    """The device ``prefetch_to_device`` places on: ``None`` is the
    current CUDA device (raising without one), a ``torch.device`` or a
    device string is taken as given; anything else (a sharding over
    several devices) is not ported."""
    import torch

    from ..compat import resolve_device
    from ..utils import not_ported

    if sharding is not None and not isinstance(sharding, (torch.device, str)):
        raise not_ported("prefetch_to_device sharding={0!r}".format(
            sharding), "multi-GPU DP over torch.distributed")
    dev = resolve_device(sharding)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def place_tree(tree, device):
    """A host pytree of arrays (dicts, tuples, lists; numpy arrays or CPU
    tensors at the leaves) as tensors on ``device``.

    On a CUDA device each leaf goes through pinned host memory and is
    copied with ``non_blocking=True`` on the current stream, so the host
    does not wait for the device's queue; the caching host allocator
    keeps a pinned block until the copy that reads it has completed.
    On the CPU the leaves are the arrays' own memory."""
    import torch

    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if device.type != "cuda":
            return t.to(device)
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    return tree_map(put, tree)


def prefetch_to_device(iterator, size=2, sharding=None, preprocess=None,
                       host_prefetch=False):
    """Keep ``size`` batches in flight from the host to the device.

    Batch N+1's copy overlaps the compute on batch N: each leaf goes to
    pinned memory and then to the device with ``non_blocking=True`` on a
    side copy stream; the consumer's stream waits on the copy's event
    before it uses the batch (``record_stream`` tells the allocator the
    tensors are used there).

    Args:
      iterator: yields pytrees of numpy arrays, or ``(batch, n)`` tuples
        from ``DataFeed.batches(pad_to_batch=True)``; the batch is
        placed and ``n`` stays a host int.
      size: batches in flight (>= 1).
      sharding: where to place: ``None`` (the current CUDA device,
        raising without one), a ``torch.device`` or a device string
        (``"cpu"`` runs the same pipeline on the CPU).  Several devices
        are not ported (multi-GPU DP).
      preprocess: a callable or a
        :func:`~.preprocess.make_preprocess` kwargs dict, applied on the
        device after the copy, so narrow wire dtypes cross the link
        narrow and widen there.  Deterministic only (no generator); use
        ``SyncTrainer(device_preprocess=...)`` for augmentation.
      host_prefetch: run the iterator (host decode and stacking) and the
        copy dispatch on a daemon thread with a bounded ``size``-deep
        buffer.  Order is preserved, iterator errors re-raise in the
        consumer, and abandoning the generator stops the thread.
    """
    import collections

    import torch

    if size < 1:
        raise ValueError(
            "prefetch_to_device size must be >= 1, got {0}".format(size))
    dev = _resolve_target(sharding)
    pre = None
    if preprocess is not None:
        from . import preprocess as pp_mod

        pre = pp_mod.resolve_preprocess(preprocess)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item):
        """Dispatch one item's copy: ``(tree, n, event)``, the event
        recorded on the copy stream after the copy (``None`` on the
        CPU)."""
        n = None
        if (isinstance(item, tuple) and len(item) == 2
                and isinstance(item[1], (int, np.integer))):
            item, n = item[0], int(item[1])
        if copy_stream is None:
            return place_tree(item, dev), n, None
        with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
            tree = place_tree(item, dev)
            event = torch.cuda.Event()
            event.record(copy_stream)
        return tree, n, event

    def take(entry):
        """On the consumer's thread: wait for the copy, then widen."""
        tree, n, event = entry
        if event is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(event)
            tree_map(lambda t: t.record_stream(stream), tree)
        if pre is not None:
            tree = pre(tree)
        return tree if n is None else (tree, n)

    if host_prefetch:
        return _host_prefetch_gen(iterator, put, take, size, dev)

    def _sync_gen():
        q = collections.deque()
        for item in iterator:
            q.append(put(item))
            if len(q) >= size:
                yield take(q.popleft())
        while q:
            yield take(q.popleft())

    return _sync_gen()


def _host_prefetch_gen(iterator, put, take, size, dev):
    """The ``host_prefetch`` variant: a daemon worker drains the iterator
    and dispatches the copies into a bounded queue (with the target
    device current on its thread); the consumer generator yields in
    order.  The worker honours a stop flag, so abandoning the generator
    (or the consumer failing) cannot deadlock on a full buffer."""
    import contextlib
    import queue as _q
    import threading

    import torch

    out_q = _q.Queue(maxsize=size)
    stop = threading.Event()

    def offer(msg):
        while not stop.is_set():
            try:
                out_q.put(msg, timeout=0.1)
                return True
            except _q.Full:
                continue
        return False

    def worker():
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        try:
            with ctx:
                for item in iterator:
                    if not offer(("ok", put(item))):
                        return
            msg = ("end", None)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            msg = ("err", e)
        offer(msg)

    t = threading.Thread(target=worker, daemon=True, name="prefetch-host")
    t.start()

    def gen():
        try:
            while True:
                kind, payload = out_q.get()
                if kind == "end":
                    return
                if kind == "err":
                    raise payload
                yield take(payload)
        finally:
            stop.set()

    return gen()
