"""Batch Example -> columnar numpy: the native feed fast path (a copy of
the JAX package's ``data/columnar.py``).

A batch of serialized ``tf.train.Example`` protos is parsed in C++
(``native/example_codec.cc``, built by :mod:`._native`) straight into
contiguous columnar arrays, one pass per requested column, with no
per-value Python objects.  The pure-Python fallback
(:mod:`.example`) keeps the package working without a compiler.

Fixed-width numeric columns only (the training fast path); string and
ragged features go through the row decoder.

Narrow-dtype wire plane: ``tf.train.Example`` stores only
float32/int64, so the proto layer promotes (a uint8 pixel costs 8
bytes as an int64 value).  :class:`WireSpec` and the narrow dtypes of
:func:`decode_batch` undo that at ingest: columns declared narrow
(uint8/int8/uint16/int16/uint32/int32/float16) are value-checked and
stored in their wire dtype right after the proto decode, so every later
hop (``ColumnarBlock``, the shm ring, ``DataFeed.next_arrays``, the
host-to-device copy) carries the narrow bytes.  Widening back to the
compute dtype happens on the device (:mod:`.preprocess`).
"""

import ctypes
import logging

import numpy as np

from . import _native

logger = logging.getLogger(__name__)

#: wire dtypes decode_batch can narrow an int64-kind feature to (value
#: checked — out-of-range raises, never silently wraps)
NARROW_INT_DTYPES = ("uint8", "int8", "uint16", "int16", "uint32", "int32")
#: wire dtypes a float32-kind feature can narrow to (precision-lossy by
#: declaration — the caller chose the storage dtype)
NARROW_FLOAT_DTYPES = ("float16",)


def narrow_cast(arr, dtype):
    """Cast ``arr`` to a narrower integer ``dtype`` with a VALUE check:
    a label of 300 declared uint8 must raise, not silently wrap to 44
    (corrupted training data).  Float narrowing (float16) is allowed
    without the check — precision loss is the declared storage
    contract, wrap-around is not."""
    dtype = np.dtype(dtype)
    if arr.dtype == dtype:
        return arr
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        if arr.size and (arr.min() < info.min or arr.max() > info.max):
            raise ValueError(
                "values outside {0} range [{1}, {2}] (min={3}, max={4})"
                ": refusing the silent wrap-around".format(
                    dtype.name, info.min, info.max,
                    arr.min(), arr.max(),
                )
            )
    return arr.astype(dtype)


class WireSpec(object):
    """Per-column wire (storage) dtypes for the narrow-dtype plane.

    ``WireSpec({"image": "uint8", "label": "int32"})`` declares the
    dtype each column ships in end-to-end (feeder → ring → consumer);
    columns not named pass through unchanged.  Use :meth:`narrow` at
    ingest (after a promoting decode) and
    :func:`~.preprocess.make_preprocess` on
    device to widen back to the compute dtype.
    """

    def __init__(self, dtypes):
        self.dtypes = {k: np.dtype(v) for k, v in dict(dtypes).items()}

    def narrow(self, columns):
        """Cast named columns of a dict/tuple column set to their wire
        dtypes (value-checked via :func:`narrow_cast`).  Tuple column
        sets are addressed by integer keys in the spec."""
        if isinstance(columns, dict):
            return {
                k: narrow_cast(np.asarray(v), self.dtypes[k])
                if k in self.dtypes else v
                for k, v in columns.items()
            }
        return tuple(
            narrow_cast(np.asarray(v), self.dtypes[i])
            if i in self.dtypes else v
            for i, v in enumerate(columns)
        )

    def narrow_rows(self, rows):
        """Narrow dict rows one by one (the feeder-side map for row
        streams that are not yet columnar)."""
        out = []
        for row in rows:
            out.append({
                k: narrow_cast(np.asarray(v), self.dtypes[k])
                if k in self.dtypes else v
                for k, v in row.items()
            })
        return out

    @staticmethod
    def wire_bytes(columns):
        """Total wire bytes of a dict/tuple column set (what one batch
        costs on the wire) — the accounting half of the narrowing
        claim (``feed.wire_stats()`` aggregates the same number on the
        consumer side)."""
        vals = columns.values() if isinstance(columns, dict) else columns
        return int(sum(np.asarray(v).nbytes for v in vals))

_LIB_NAME = "libexample_codec.so"

_ERRORS = {
    -1: "feature missing from a record",
    -2: "feature has a different kind than requested",
    -3: "feature width differs from the requested width",
    -4: "malformed Example proto",
}


def _configure(lib):
    pp = ctypes.POINTER(ctypes.c_char_p)
    for fname, ctype in (
        ("ex_extract_float", ctypes.POINTER(ctypes.c_float)),
        ("ex_extract_int64", ctypes.POINTER(ctypes.c_int64)),
    ):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            pp,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64,
            ctypes.c_char_p,
            ctype,
            ctypes.c_int64,
        ]


def _load_native():
    return _native.load_library(_LIB_NAME, _configure)


def _extract_native(lib, records, name, width, dtype, recs=None, lens=None):
    n = len(records)
    if recs is None:
        recs = (ctypes.c_char_p * n)(*records)
        lens = (ctypes.c_uint64 * n)(*[len(r) for r in records])
    out = np.empty((n, width), dtype)
    if dtype == np.float32:
        rc = lib.ex_extract_float(
            recs, lens, n, name.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), width,
        )
    else:
        rc = lib.ex_extract_int64(
            recs, lens, n, name.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), width,
        )
    if rc != 0:
        raise ValueError(
            "column {0!r}: {1}".format(name, _ERRORS.get(rc, "error %d" % rc))
        )
    return out


def _extract_python(records, name, width, dtype):
    from . import example as ex

    out = np.empty((len(records), width), dtype)
    kind_wanted = ex.KIND_FLOAT if dtype == np.float32 else ex.KIND_INT64
    for i, rec in enumerate(records):
        feats = ex.decode_example(rec)
        if name not in feats:
            raise ValueError("column {0!r}: {1}".format(name, _ERRORS[-1]))
        kind, values = feats[name]
        if values and kind != kind_wanted:
            raise ValueError("column {0!r}: {1}".format(name, _ERRORS[-2]))
        if len(values) != width:
            raise ValueError("column {0!r}: {1}".format(name, _ERRORS[-3]))
        out[i] = values
    return out


def decode_batch(records, columns):
    """Decode serialized Examples into columnar arrays.

    Args:
      records: list of ``bytes`` (serialized ``tf.train.Example``).
      columns: ``{name: (dtype, width)}``; every record must carry
        exactly ``width`` values (missing/ragged features raise —
        silent zero-fill would corrupt training data).  ``dtype`` is
        ``"float32"`` / ``"int64"`` (the proto's native kinds) or a
        NARROW wire dtype: int64-kind features narrow to any of
        ``NARROW_INT_DTYPES`` (value-checked — an out-of-range value
        raises instead of wrapping) and float32-kind features to
        ``NARROW_FLOAT_DTYPES``.  Narrowing happens immediately after
        the proto decode, so everything downstream (ColumnarBlock, shm
        ring, the host-to-device copy) ships the narrow bytes.

    Returns:
      ``{name: np.ndarray[n, width]}`` (width-1 columns keep the
      trailing axis; squeeze at the call site if needed).
    """
    records = [bytes(r) for r in records]
    lib = _load_native()
    recs = lens = None
    if lib is not None and records:
        # build the ctypes views once, shared across all columns
        recs = (ctypes.c_char_p * len(records))(*records)
        lens = (ctypes.c_uint64 * len(records))(*[len(r) for r in records])
    out = {}
    for name, (dtype, width) in columns.items():
        wire_dtype = np.dtype(dtype)
        if wire_dtype.name in NARROW_INT_DTYPES:
            extract_dtype = np.int64
        elif wire_dtype.name in NARROW_FLOAT_DTYPES:
            extract_dtype = np.float32
        elif wire_dtype.type in (np.float32, np.int64):
            extract_dtype = wire_dtype.type
        else:
            raise ValueError(
                "column {0!r}: columnar decode supports float32/int64 "
                "and the narrow wire dtypes {1} (got {2})".format(
                    name,
                    NARROW_INT_DTYPES + NARROW_FLOAT_DTYPES,
                    wire_dtype,
                )
            )
        if lib is not None:
            arr = _extract_native(
                lib, records, name, width, extract_dtype,
                recs=recs, lens=lens,
            )
        else:
            arr = _extract_python(records, name, width, extract_dtype)
        try:
            out[name] = narrow_cast(arr, wire_dtype)
        except ValueError as e:
            raise ValueError("column {0!r}: {1}".format(name, e))
    return out


def load_tfrecords_columnar(path, columns):
    """TFRecord file/dir -> columnar arrays in one pass (see
    :func:`decode_batch` for ``columns``)."""
    from . import tfrecord as tfr
    from .interchange import _record_files

    records = []
    for f in _record_files(path):
        records.extend(tfr.read_records(f))
    return decode_batch(records, columns)
