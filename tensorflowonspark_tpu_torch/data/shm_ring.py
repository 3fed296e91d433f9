"""Shared-memory ring: zero-RPC staging between feeder and compute (port
of the JAX package's ``data/shm_ring.py``).

The manager-queue data plane costs one proxy RPC (connect, pickle,
third-process hop) per block; this ring (``native/shm_ring.cc``, a
lock-free SPSC byte ring in a ``multiprocessing.shared_memory`` segment)
moves a record with two memcpys and no intermediary.

The feed fast path (``TFOS_SHM_FEED=1``): the node runtime creates a
ring per executor, advertises its name through the manager kv, feeders
push columnar wire records, and ``DataFeed`` drains the ring before
consulting the queue (control sentinels, ``None`` and ``EndPartition``,
always travel via the queue).  The segment layout (64-byte header, the
producer pid at offset 32, the format tag) is the reference's, so a
segment written by one package reads in the other.

No pure-Python fallback: callers check :func:`available` and stay on
the queue path when the native library is missing.  The reference's
ring telemetry counters are not ported (ROADMAP queue A).
"""

import atexit
import ctypes
import gc
import logging
import os
import struct
import time
import weakref
from multiprocessing import shared_memory

from . import _native

logger = logging.getLogger(__name__)

_LIB_NAME = "libshm_ring.so"

DEFAULT_CAPACITY = 64 * 1024 * 1024

#: byte offset of the producer-pid slot inside the 64-byte native
#: header: magic(8) + capacity(8) + head(8) + tail(8) = 32, then the
#: header's reserved pad region — the native code never reads it, so
#: the python layer owns it.  A zero pid means "no producer announced"
#: (SharedMemory segments are created zero-filled).
_PRODUCER_PID_OFFSET = 32

#: seconds between producer-liveness probes while a pop waits on an
#: empty ring (one os.kill(pid, 0) per interval — negligible)
_LIVENESS_INTERVAL = 0.2

#: record wire-format tags (the native header's format_tag field):
#: producers tag the segment with the encoding their records use;
#: consumers verify at attach and refuse tags they don't understand
#: instead of mis-decoding frames.  0 = legacy (pickled blocks only);
#: 1 = dtype-tagged columnar wire records (cluster/marker.py
#: COLUMNAR_MAGIC format — self-describing per-column dtypes, the
#: narrow-dtype plane) with pickle fallback.
FORMAT_LEGACY = 0
FORMAT_COLUMNAR_V1 = 1
#: tags this build knows how to decode
KNOWN_FORMATS = (FORMAT_LEGACY, FORMAT_COLUMNAR_V1)


class ProducerDiedError(RuntimeError):
    """The ring's announced producer process died with the ring empty:
    no more records are coming and a blocking consumer would otherwise
    wait out its full feed timeout (or forever, in a retry loop).
    Names the segment and the dead pid."""

#: live rings; at interpreter exit their ctypes buffer pins are dropped
#: BEFORE SharedMemory.__del__ runs, so its close() doesn't raise
#: BufferError into stderr
_INSTANCES = weakref.WeakSet()


@atexit.register
def _release_pins():
    for ring in list(_INSTANCES):
        ring._cbase = None
    gc.collect()


def _configure(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.shmring_init.restype = ctypes.c_int64
    lib.shmring_init.argtypes = [u8p, ctypes.c_uint64]
    lib.shmring_push.restype = ctypes.c_int
    lib.shmring_push.argtypes = [u8p, ctypes.c_char_p, ctypes.c_uint64]
    lib.shmring_pushv.restype = ctypes.c_int
    lib.shmring_pushv.argtypes = [
        u8p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
    ]
    lib.shmring_pop.restype = ctypes.c_int64
    lib.shmring_pop.argtypes = [
        u8p, u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.shmring_size.restype = ctypes.c_int64
    lib.shmring_size.argtypes = [u8p]
    lib.shmring_set_format.restype = ctypes.c_int
    lib.shmring_set_format.argtypes = [u8p, ctypes.c_uint32]
    lib.shmring_format.restype = ctypes.c_int64
    lib.shmring_format.argtypes = [u8p]


def _load():
    return _native.load_library(_LIB_NAME, _configure)


def available():
    return _load() is not None


class ShmRing(object):
    """SPSC byte ring over a named shared-memory segment.

    Args:
      name: segment name (``create=True`` makes it, else attaches).
      capacity: total segment bytes when creating.
    """

    def __init__(self, name, capacity=DEFAULT_CAPACITY, create=False):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native shm ring unavailable (no compiler?)")
        if create:
            self.shm = shared_memory.SharedMemory(
                name=name, create=True, size=capacity
            )
            # reserve the pages now: on a full /dev/shm the create fails
            # here with ENOSPC, where a later push would die of SIGBUS
            try:
                os.posix_fallocate(self.shm._fd, 0, self.shm.size)
            except OSError as e:
                self.shm.close()
                self.shm.unlink()
                raise OSError(
                    e.errno, "cannot reserve {0} bytes for shm ring {1!r} "
                    "({2}); set TFOS_SHM_FEED_BYTES lower".format(
                        capacity, name, e.strerror))
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self.name = name
        self._owner = create
        #: usable data-region bytes (segment minus the 64B header)
        self.capacity = self.shm.size - 64
        self._out = ctypes.create_string_buffer(8)  # length-probe target
        # one ctypes view for the segment's lifetime: from_buffer pins
        # the exported buffer, so it must be dropped before close()
        self._cbase = (ctypes.c_uint8 * self.shm.size).from_buffer(
            self.shm.buf
        )
        if create:
            rc = self._lib.shmring_init(self._cbase, self.shm.size)
            if rc < 0:
                self.close()
                raise ValueError("segment too small: {0}".format(capacity))
        _INSTANCES.add(self)
        self._next_liveness = 0.0  # next producer probe (monotonic)

    def _base(self):
        return self._cbase

    # -- wire-format negotiation ---------------------------------------

    def set_format(self, tag):
        """Tag the segment with the record wire format its producer
        writes (``FORMAT_*``); the creating side calls this once."""
        rc = self._lib.shmring_set_format(self._base(), int(tag))
        if rc == -3:
            raise RuntimeError("corrupt ring segment")

    def format_tag(self):
        """The segment's record wire-format tag (``FORMAT_LEGACY`` on
        segments from builds predating the tag — the header region is
        zero-filled at creation)."""
        tag = int(self._lib.shmring_format(self._base()))
        if tag == -3:
            raise RuntimeError("corrupt ring segment")
        return tag

    # -- producer liveness ---------------------------------------------

    def announce_producer(self, pid=None):
        """Record the producer's pid in the ring header (the native
        header's reserved pad bytes — the C++ side never reads them).
        The pushing process calls this once after attaching; a new
        producer for a later stream simply overwrites it (SPSC — one
        live producer at a time)."""
        struct.pack_into(
            "<Q", self.shm.buf, _PRODUCER_PID_OFFSET,
            int(os.getpid() if pid is None else pid),
        )

    def producer_pid(self):
        """The announced producer pid, or 0 when none announced."""
        return struct.unpack_from(
            "<Q", self.shm.buf, _PRODUCER_PID_OFFSET
        )[0]

    @staticmethod
    def _pid_alive(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return True  # exists, owned by someone else
        return True

    def _producer_dead(self):
        """The announced producer's pid when that process is dead,
        else None.  Called from pop's empty-wait path, rate-limited to
        one probe per ``_LIVENESS_INTERVAL`` ACROSS calls (feed loops
        issue many short-timeout pops; per-call probe state would
        never reach the interval and miss the death)."""
        now = time.monotonic()
        if now < self._next_liveness:
            return None
        self._next_liveness = now + _LIVENESS_INTERVAL
        pid = self.producer_pid()
        if pid and not self._pid_alive(pid):
            return pid
        return None

    def push(self, record, timeout=None, error_check=None):
        """Append one byte record; blocks (spin+sleep) while full.

        ``error_check``: optional callable invoked during waits so
        feeders can keep surfacing compute errors.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        base = self._base()
        while True:
            rc = self._lib.shmring_push(base, record, len(record))
            if rc == 0:
                return
            if rc == -2:
                raise ValueError(
                    "record of {0} bytes exceeds {1}".format(
                        len(record),
                        "the 4GiB u32 frame limit"
                        if len(record) > (1 << 32) - 5
                        else "ring capacity",
                    )
                )
            if rc == -3:
                raise RuntimeError("corrupt ring segment")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("ring full for {0}s".format(timeout))
            if error_check is not None:
                error_check()
            time.sleep(0.001)

    def pushv(self, parts, timeout=None, error_check=None):
        """Scatter-gather push: one record from multiple buffer-protocol
        segments (header + raw numpy column buffers), copied into the
        ring WITHOUT first concatenating into an intermediate bytes —
        the zero-pickle columnar path's single feeder-side copy.
        """
        views = [memoryview(p).cast("B") for p in parts]
        n = len(views)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_uint64 * n)()
        # keep ctypes casts alive for the duration of the call
        holders = []
        for i, v in enumerate(views):
            c = (ctypes.c_uint8 * len(v)).from_buffer_copy(v) if v.readonly \
                else (ctypes.c_uint8 * len(v)).from_buffer(v)
            holders.append(c)
            ptrs[i] = ctypes.cast(c, ctypes.c_void_p)
            lens[i] = len(v)
        total = sum(len(v) for v in views)
        deadline = None if timeout is None else time.monotonic() + timeout
        base = self._base()
        try:
            while True:
                rc = self._lib.shmring_pushv(
                    base,
                    ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
                    lens,
                    n,
                )
                if rc == 0:
                    return
                if rc == -2:
                    raise ValueError(
                        "record of {0} bytes exceeds {1}".format(
                            total,
                            "the 4GiB u32 frame limit"
                            if total > (1 << 32) - 5
                            else "ring capacity",
                        )
                    )
                if rc == -3:
                    raise RuntimeError("corrupt ring segment")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("ring full for {0}s".format(timeout))
                if error_check is not None:
                    error_check()
                time.sleep(0.001)
        finally:
            del holders

    def pop(self, timeout=0):
        """Pop one record into an exactly-sized buffer; returns ``None``
        when empty past ``timeout``.

        Two C calls per record — a zero-capacity probe for the length,
        then the copy straight into a fresh ``bytearray`` — so the data
        crosses ring→consumer with exactly ONE memcpy and no shared
        scratch (a scratch would need a second copy before handing the
        record out, since the next pop overwrites it)."""
        deadline = time.monotonic() + timeout
        base = self._base()
        need = ctypes.c_uint64(0)
        dead_pid = None
        while True:
            n = self._lib.shmring_pop(
                base,
                ctypes.cast(self._out, ctypes.POINTER(ctypes.c_uint8)),
                0,
                ctypes.byref(need),
            )
            if n == 0:
                return b""  # zero-length record
            if n == -2:
                buf = bytearray(int(need.value))
                carr = (ctypes.c_uint8 * len(buf)).from_buffer(buf)
                n2 = self._lib.shmring_pop(
                    base,
                    ctypes.cast(carr, ctypes.POINTER(ctypes.c_uint8)),
                    len(buf),
                    ctypes.byref(need),
                )
                del carr
                if n2 < 0:  # cannot happen for SPSC (sole consumer)
                    raise RuntimeError(
                        "ring record vanished between probe and pop"
                    )
                return buf
            if n == -3:
                raise RuntimeError("corrupt ring segment")
            if dead_pid is not None:
                # the producer was dead on the PREVIOUS iteration and
                # this re-probe still found the ring empty: nothing
                # raced in between its last push and its death
                raise ProducerDiedError(
                    "shm ring {0!r}: producer pid {1} died with the "
                    "ring empty — no more records are coming".format(
                        self.name, dead_pid
                    )
                )
            dead_pid = self._producer_dead()
            if dead_pid is not None:
                continue  # one confirming empty re-probe, then raise
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.0005)

    def size(self):
        return int(self._lib.shmring_size(self._base()))

    def close(self, unlink=None):
        # dropping the last reference releases the from_buffer export
        # synchronously (refcount); a cycle-trapped array needs a
        # collection pass first, so retry once behind gc.collect()
        self._cbase = None
        for attempt in range(2):
            try:
                self.shm.close()
                break
            except BufferError:
                if attempt == 0:
                    gc.collect()
                    continue
                # a stray export (e.g. an in-flight ctypes call) still
                # pins the mapping; it unmaps at process exit
                logger.debug(
                    "segment %s still pinned; deferring unmap", self.name
                )
            except FileNotFoundError:
                break
        if unlink if unlink is not None else self._owner:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass

    def __del__(self):
        # a dropped ring must not reach SharedMemory.__del__ with the
        # ctypes pin alive (member finalization order is arbitrary, so
        # shm.close() could raise BufferError into stderr) nor leak the
        # owner's segment registration; close() is idempotent
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter may be tearing down
            pass
