"""In-band queue sentinels and the columnar feed block (port of the JAX
package's ``cluster/marker.py``; original: tensorflowonspark/marker.py).

``None`` remains the end-of-feed sentinel by convention; ``EndPartition``
marks partition boundaries.  The shared-memory ring's wire codecs
(``encode_columnar_parts``, ``encode_rows_parts``,
``decode_columnar_record``) write the reference's format byte for byte,
so a record pushed by one package decodes in the other.
"""


class Marker(object):
    """Base class for in-band control markers."""


class EndPartition(Marker):
    """Marks the end of one input partition within the feed stream."""


class PartitionStart(Marker):
    """First element of an elastic feed partition, carrying the driver's
    partition id (``"e<epoch>p<index>"``).  The feeder strips it and
    opens the partition's record in the node's
    :class:`~.manager.PartitionLedger`; it never reaches the compute
    process."""

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


# ----------------------------------------------------------------------
# Zero-pickle wire format for ColumnarBlock (the shm-ring fast path):
# [8B magic][u32 header len][json header][raw column buffers...].
# pickle of a ColumnarBlock copies every column into the pickle stream
# and back out at loads; this format writes the numpy buffers straight
# into the ring (ShmRing.pushv) and reconstructs them as zero-copy
# np.frombuffer views over the popped record.
# ----------------------------------------------------------------------

COLUMNAR_MAGIC = b"TFOSCB1\x00"


def _wire_header(kind, keys, count, dtypes, shapes):
    """The shared wire-format header for both encoders: magic, u32
    JSON length, JSON meta — space-padded so the data region starts
    64-byte aligned (JSON tolerates trailing whitespace), keeping every
    ``np.frombuffer`` column view aligned on the zero-copy decode path.
    """
    import json as _json
    import struct

    meta = {
        "kind": kind,
        "keys": keys,
        "count": int(count),
        "dtypes": dtypes,
        "shapes": shapes,
    }
    hdr = _json.dumps(meta).encode("utf-8")
    hdr += b" " * ((-(len(COLUMNAR_MAGIC) + 4 + len(hdr))) % 64)
    return COLUMNAR_MAGIC + struct.pack("<I", len(hdr)) + hdr


def encode_columnar_parts(block):
    """``(header_bytes, [column buffers])`` for ``ShmRing.pushv``, or
    ``None`` when the block is not wire-encodable (dict columns with
    non-string keys — the JSON header only round-trips str keys).

    Buffers are the blocks' own contiguous column arrays (no copy
    here); total record size is ``len(header) + sum(buffer sizes)``.
    """
    import numpy as np

    cols = block.columns
    if isinstance(cols, dict):
        keys = list(cols)
        if not all(isinstance(k, str) for k in keys):
            # the JSON header can only round-trip string keys (bytes
            # keys fail json.dumps; tuple keys decode as unhashable
            # lists) — such blocks ship via pickle
            return None
        arrs = [cols[k] for k in keys]
        kind = "dict"
    else:
        keys = None
        arrs = list(cols)
        kind = (
            "scalar" if block._scalar else
            ("list" if block._list_rows else "tuple")
        )
    arrs = [np.ascontiguousarray(a) for a in arrs]
    return _wire_header(
        kind, keys, block.count,
        [a.dtype.str for a in arrs], [list(a.shape) for a in arrs],
    ), arrs


def encode_rows_parts(rows):
    """Encode a block of rows for ``ShmRing.pushv`` WITHOUT stacking
    them first: each fixed-shape ndarray column contributes its per-row
    buffers as separate scatter-gather parts, and the ring's contiguous
    record write IS the stack — the feeder's only data copy.  The
    record decodes with :func:`decode_columnar_record` (identical wire
    format: parts of one column laid out back-to-back equal the stacked
    column buffer).

    Returns ``(header, parts, total_bytes)`` or ``None`` when rows are
    not fixed-shape homogeneous (callers fall back to
    :func:`pack_columnar` / pickle).  Eligibility mirrors
    ``pack_columnar``: exact-type tuple/list/dict rows, per-column
    uniform dtype+shape; scalar numeric columns are stacked here (one
    tiny array), big ndarray columns are the win.
    """
    import numpy as np

    if not rows:
        return None
    first = rows[0]
    if type(first) is dict:
        keys = list(first)
        if not all(isinstance(k, str) for k in keys):
            return None  # JSON header: string keys only (see above)
        get = lambda r, i: r[keys[i]]  # noqa: E731
        width = len(keys)
        kind = "dict"
    elif type(first) in (tuple, list):
        keys = None
        get = lambda r, i: r[i]  # noqa: E731
        width = len(first)
        kind = "list" if type(first) is list else "tuple"
    else:
        return None  # scalar rows: the pack path handles them
    if any(type(r) is not type(first) or len(r) != width for r in rows):
        return None

    n = len(rows)
    parts = []
    dtypes = []
    shapes = []
    try:
        for i in range(width):
            v0 = get(first, i)
            if isinstance(v0, np.ndarray):
                dt, shape = v0.dtype, v0.shape
                if dt == object or dt.hasobject:
                    return None
                col_parts = []
                for r in rows:
                    v = get(r, i)
                    if (
                        not isinstance(v, np.ndarray)
                        or v.dtype != dt
                        or v.shape != shape
                    ):
                        return None
                    col_parts.append(np.ascontiguousarray(v))
                parts.append(col_parts)
                dtypes.append(dt.str)
                shapes.append([n] + list(shape))
            else:
                arr = _column_array([get(r, i) for r in rows])
                if arr is None or arr.shape[0] != n:
                    return None
                parts.append([np.ascontiguousarray(arr)])
                dtypes.append(arr.dtype.str)
                shapes.append(list(arr.shape))
    except (TypeError, ValueError, KeyError, IndexError):
        # KeyError/IndexError: rows with mismatched key sets / widths —
        # same fallback contract as pack_columnar
        return None

    header = _wire_header(kind, keys, n, dtypes, shapes)
    flat = [p for col in parts for p in col]
    total = len(header) + sum(p.nbytes for p in flat)
    return header, flat, total


def decode_columnar_record(buf):
    """Rebuild a :class:`ColumnarBlock` from one wire record, or return
    ``None`` when ``buf`` is not in the columnar wire format (callers
    fall back to pickle).  Column arrays are zero-copy views over
    ``buf`` — the caller must hand in a buffer it will not reuse."""
    import json as _json
    import struct

    import numpy as np

    if len(buf) < 12 or bytes(buf[:8]) != COLUMNAR_MAGIC:
        return None
    (hlen,) = struct.unpack("<I", buf[8:12])
    # a truncated or corrupt magic-prefixed record must take the pickle
    # fallback like every other malformed input, not crash the feed:
    # bound the declared header and every column against len(buf)
    if 12 + hlen > len(buf):
        return None
    try:
        meta = _json.loads(bytes(buf[12:12 + hlen]))
        dtypes, shapes = meta["dtypes"], meta["shapes"]
        kind, count = meta["kind"], meta["count"]
        keys = meta.get("keys")
    except (ValueError, KeyError, TypeError):
        return None
    if kind not in ("dict", "tuple", "list", "scalar"):
        return None
    if kind == "dict" and (
        not isinstance(keys, list) or len(keys) != len(dtypes)
    ):
        return None
    off = 12 + hlen
    arrs = []
    try:
        for dt, shape in zip(dtypes, shapes):
            dtype = np.dtype(dt)
            n = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if n < 0 or off + n * dtype.itemsize > len(buf):
                return None
            a = np.frombuffer(buf, dtype=dtype, count=n, offset=off)
            arrs.append(a.reshape(shape))
            off += n * dtype.itemsize
    except (TypeError, ValueError):
        return None
    if kind == "dict":
        cols = dict(zip(keys, arrs))
    else:
        cols = tuple(arrs)
    return ColumnarBlock(
        cols,
        count,
        _scalar=kind == "scalar",
        _list_rows=kind == "list",
    )


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
