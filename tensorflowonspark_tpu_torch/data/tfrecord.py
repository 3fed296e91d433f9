"""TFRecord file I/O over the native C++ codec (a copy of the JAX
package's ``data/tfrecord.py``).

The C++ library (``native/tfrecord_codec.cc``, built by
:mod:`._native`) does the framing and slice-by-8 CRC32C; a pure-Python
fallback keeps the package working where no compiler exists (CRC via a
generated table: the same numbers, about 100x slower).  Files are byte
for byte the reference's.

Remote URIs (``gs://``, ``hdfs://``, ``s3://``, ``memory://``, ...) go
through ``fsspec`` (:mod:`..utils.fs`) with the pure-Python framing;
local paths and ``file://`` URIs keep the native codec.
"""

import ctypes
import logging
import os
import struct

from . import _native
from ..utils import fs as fs_utils

logger = logging.getLogger(__name__)

_LIB_NAME = "libtfrecord_codec.so"


def _load_native():
    """Load (building if needed) the codec library; None on failure."""
    return _native.load_library(_LIB_NAME, _configure)


def _configure(lib):
    lib.tfr_crc32c.restype = ctypes.c_uint32
    lib.tfr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.tfr_masked_crc.restype = ctypes.c_uint32
    lib.tfr_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.tfr_writer_open.restype = ctypes.c_void_p
    lib.tfr_writer_open.argtypes = [ctypes.c_char_p]
    lib.tfr_writer_write.restype = ctypes.c_int
    lib.tfr_writer_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.tfr_writer_flush.argtypes = [ctypes.c_void_p]
    lib.tfr_writer_close.argtypes = [ctypes.c_void_p]
    lib.tfr_reader_open.restype = ctypes.c_void_p
    lib.tfr_reader_open.argtypes = [ctypes.c_char_p]
    lib.tfr_reader_next.restype = ctypes.c_int64
    lib.tfr_reader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
    ]
    lib.tfr_reader_error.restype = ctypes.c_char_p
    lib.tfr_reader_error.argtypes = [ctypes.c_void_p]
    lib.tfr_reader_close.argtypes = [ctypes.c_void_p]


def native_available():
    return _load_native() is not None


# ----------------------------------------------------------------------
# Pure-python fallback CRC32C (identical numbers, for no-compiler envs)
# ----------------------------------------------------------------------

_PY_TABLE = None


def _py_table():
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _PY_TABLE = table
    return _PY_TABLE


def crc32c(data):
    lib = _load_native()
    if lib is not None:
        return lib.tfr_crc32c(bytes(data), len(data))
    table = _py_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data):
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class CorruptRecordError(IOError):
    pass


class TFRecordWriter(object):
    """Append-only TFRecord writer (context manager)."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._lib = None if fs_utils.is_remote(self.path) else _load_native()
        if self._lib is not None:
            local = fs_utils.local_path(self.path)
            self._h = self._lib.tfr_writer_open(local.encode())
            if not self._h:
                raise IOError("cannot open {0} for writing".format(path))
            self._f = None
        else:
            self._h = None
            self._f = fs_utils.open_file(self.path, "wb")

    def write(self, record):
        record = bytes(record)
        if self._h is not None:
            if self._lib.tfr_writer_write(self._h, record, len(record)):
                raise IOError("write failed on {0}".format(self.path))
        else:
            length = struct.pack("<Q", len(record))
            self._f.write(length)
            self._f.write(struct.pack("<I", masked_crc(length)))
            self._f.write(record)
            self._f.write(struct.pack("<I", masked_crc(record)))

    def flush(self):
        if self._h is not None:
            self._lib.tfr_writer_flush(self._h)
        else:
            self._f.flush()

    def close(self):
        if self._h is not None:
            self._lib.tfr_writer_close(self._h)
            self._h = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordReader(object):
    """Iterates records of one TFRecord file (context manager)."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._lib = None if fs_utils.is_remote(self.path) else _load_native()
        if self._lib is not None:
            local = fs_utils.local_path(self.path)
            if not os.path.exists(local):
                # builtin open()'s error class
                raise FileNotFoundError(local)
            self._h = self._lib.tfr_reader_open(local.encode())
            if not self._h:
                raise IOError("cannot open {0}".format(path))
            self._f = None
        else:
            self._h = None
            self._f = fs_utils.open_file(self.path, "rb")

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is not None:
            out = ctypes.POINTER(ctypes.c_uint8)()
            n = self._lib.tfr_reader_next(self._h, ctypes.byref(out))
            if n == -1:
                raise StopIteration
            if n == -2:
                raise CorruptRecordError(
                    "{0}: {1}".format(
                        self.path,
                        self._lib.tfr_reader_error(self._h).decode(),
                    )
                )
            return ctypes.string_at(out, n)
        return self._py_next()

    def _py_next(self):
        header = self._f.read(8)
        if not header:
            raise StopIteration
        if len(header) != 8:
            raise CorruptRecordError("truncated length")
        (length,) = struct.unpack("<Q", header)
        len_crc_bytes = self._f.read(4)
        if len(len_crc_bytes) != 4:
            raise CorruptRecordError("truncated length crc")
        (len_crc,) = struct.unpack("<I", len_crc_bytes)
        if len_crc != masked_crc(header):
            raise CorruptRecordError("length crc mismatch")
        data = self._f.read(length)
        if len(data) != length:
            raise CorruptRecordError("truncated data")
        data_crc_bytes = self._f.read(4)
        if len(data_crc_bytes) != 4:
            raise CorruptRecordError("truncated data crc")
        (data_crc,) = struct.unpack("<I", data_crc_bytes)
        if data_crc != masked_crc(data):
            raise CorruptRecordError("data crc mismatch")
        return data

    def close(self):
        if self._h is not None:
            self._lib.tfr_reader_close(self._h)
            self._h = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path, records):
    """Write an iterable of byte records to one TFRecord file."""
    count = 0
    with TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
            count += 1
    return count


def read_records(path):
    """Yield all byte records of one TFRecord file."""
    with TFRecordReader(path) as r:
        for rec in r:
            yield rec
