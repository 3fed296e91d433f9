"""In-band queue sentinels and the columnar feed block (port of the JAX
package's ``cluster/marker.py``; original: tensorflowonspark/marker.py).

``None`` remains the end-of-feed sentinel by convention; ``EndPartition``
marks partition boundaries.  The shared-memory ring's wire codecs
(``encode_columnar_parts``, ``encode_rows_parts``,
``decode_columnar_record``) are not ported: the ring is the next slice
of the data plane (ROADMAP queue A).
"""


class Marker(object):
    """Base class for in-band control markers."""


class EndPartition(Marker):
    """Marks the end of one input partition within the feed stream."""


class PartitionStart(Marker):
    """First element of an elastic feed partition, carrying the driver's
    partition id.  Elastic feeding is not ported; the class is kept so a
    feed stream's vocabulary matches the reference's."""

    __slots__ = ("pid",)

    def __init__(self, pid):
        self.pid = pid


class Block(Marker):
    """A batch of feed items shipped as ONE queue element (one manager
    RPC per block instead of per row); :class:`~..data.feed.DataFeed`
    unwraps them transparently."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = list(items)

    def __len__(self):
        return len(self.items)


class ColumnarBlock(Marker):
    """A batch of feed rows shipped as stacked numpy COLUMNS.

    Serialization is a few buffer copies, and the consumer slices
    batches out with zero per-row Python (``DataFeed.next_arrays``).
    ``columns`` is a tuple of arrays (tuple/list rows, in field order)
    or a dict of arrays (dict rows); every array shares the leading row
    dimension ``count``.

    Values delivered through the row-compat path (:meth:`rows` /
    ``DataFeed.next_batch``) are numpy-typed (``np.int64(3)`` where the
    feeder saw ``3``); ``TFOS_COLUMNAR_FEED=0`` disables packing.
    :func:`pack_columnar` refuses blocks whose columns mix Python
    element types, so an int is never silently promoted to float.
    """

    __slots__ = ("columns", "count", "_scalar", "_list_rows")

    def __init__(self, columns, count, _scalar=False, _list_rows=False):
        self.columns = columns
        self.count = count
        #: True when the block packs *scalar* rows into one column
        self._scalar = _scalar
        #: True when the source rows were lists (rows() preserves that)
        self._list_rows = _list_rows

    def __len__(self):
        return self.count

    def rows(self):
        """Row-objects view (compat path for row-mode consumers)."""
        if isinstance(self.columns, dict):
            keys = sorted(self.columns)
            cols = [self.columns[k] for k in keys]
            return [dict(zip(keys, vals)) for vals in zip(*cols)]
        if len(self.columns) == 1 and self._scalar:
            return list(self.columns[0])
        if self._list_rows:
            return [list(vals) for vals in zip(*self.columns)]
        return list(zip(*self.columns))


def _column_array(values):
    """Stack one column; ``None`` unless all elements share one Python
    type (and, for array elements, one dtype) and the result is a
    non-object array: mixed int/float rows must NOT silently promote."""
    import numpy as np

    t0 = type(values[0])
    for v in values:
        if type(v) is not t0:
            return None
    if isinstance(values[0], (list, tuple)):
        values = [np.asarray(v) for v in values]
    if isinstance(values[0], np.ndarray):
        d0 = values[0].dtype
        for v in values:
            if v.dtype != d0:
                return None
    arr = np.asarray(values)
    if arr.dtype == object:
        return None
    return arr


def pack_columnar(rows):
    """Try to pack a list of rows into a :class:`ColumnarBlock`;
    ``None`` when the rows are not fixed-shape homogeneous numerics
    (ragged, mixed element types, arbitrary objects), and callers fall
    back to :class:`Block`."""
    if not rows:
        return None
    first = rows[0]
    # exact-type checks: tuple/dict SUBCLASSES (namedtuples, OrderedDicts)
    # carry identity that columnar stacking would flatten away
    try:
        if type(first) is dict:
            cols = {}
            for k in list(first):
                arr = _column_array([r[k] for r in rows])
                if arr is None:
                    return None
                cols[k] = arr
            return ColumnarBlock(cols, len(rows))
        if type(first) in (tuple, list):
            out = []
            for i in range(len(first)):
                arr = _column_array([r[i] for r in rows])
                if arr is None:
                    return None
                out.append(arr)
            return ColumnarBlock(
                tuple(out), len(rows), _list_rows=type(first) is list
            )
        if isinstance(first, (dict, tuple, list)):
            return None  # subclass of a container type: keep row identity
        arr = _column_array(rows)
        if arr is None:
            return None
        return ColumnarBlock((arr,), len(rows), _scalar=True)
    except (ValueError, TypeError, KeyError, IndexError):
        return None
