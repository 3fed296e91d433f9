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

Not ported (ROADMAP queue A): the shared-memory ring source (the
reference's ``_attach_ring`` / ``_ring_pop``), ``prefetch_to_device``,
and the telemetry counters mirroring :meth:`DataFeed.wire_stats`.
"""

import logging
import queue as queue_mod

import numpy as np

from ..cluster.marker import Block, ColumnarBlock, EndPartition, pack_columnar
from ..utils import not_ported

logger = logging.getLogger(__name__)


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
        #: wire accounting: payload bytes, records and rows received
        self.wire_bytes = 0
        self.wire_records = 0
        self.wire_rows = 0

    def _account(self, nbytes, nrows):
        self.wire_bytes += int(nbytes)
        self.wire_records += 1
        self.wire_rows += int(nrows)

    def _account_item(self, item):
        if isinstance(item, ColumnarBlock):
            self._account(_columns_nbytes(item.columns), item.count)
        elif isinstance(item, Block):
            self._account(sum(_row_nbytes(r) for r in item.items),
                          len(item.items))
        else:
            self._account(_row_nbytes(item), 1)

    def wire_stats(self):
        """Cumulative feed-plane accounting: ``wire_bytes`` (payload
        bytes, pickle framing excluded), ``records``, ``rows`` and
        ``bytes_per_row``."""
        return {
            "wire_bytes": self.wire_bytes,
            "records": self.wire_records,
            "rows": self.wire_rows,
            "bytes_per_row": (self.wire_bytes / self.wire_rows
                              if self.wire_rows else 0.0),
        }

    def _fetch(self):
        """Block until the next feed element arrives; returns it raw
        (``task_done`` is left to the caller).

        Each proxied get is bounded at 1 s and retried: an unbounded
        get parks a thread in the manager server, which would outlive a
        dead consumer and swallow the next item.
        """
        if self._qin is None:
            self._qin = self.mgr.get_queue(self.qname_in)
        while True:
            try:
                return self._qin.get(block=True, timeout=1.0)
            except queue_mod.Empty:
                continue

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
        """Elastic feeding is not ported: there is no partition ledger,
        so nothing is promoted (the reference returns 0 when feeding is
        not elastic)."""
        return 0

    def batch_results(self, results):
        """Push a batch of results to the output queue as one Block (one
        manager RPC)."""
        if self._qout is None:
            self._qout = self.mgr.get_queue(self.qname_out)
        self._qout.put(Block(results), block=True)

    def terminate(self):
        """Terminate feeding early: set the node state to 'terminating'
        and drain the input queue so blocked feeders are released."""
        from ..cluster import manager

        logger.info("terminate() invoked")
        self.mgr.set("state", "terminating")
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


def prefetch_to_device(iterator, size=2, sharding=None, preprocess=None,
                       host_prefetch=False):
    raise not_ported("prefetch_to_device", "prefetch_to_device")
