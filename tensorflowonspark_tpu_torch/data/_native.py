"""Build and load the C++ libraries of the repository's ``native/``
(port of the JAX package's ``data/_native.py``).

Each library compiles with ``g++`` from its unchanged
``native/<name>.cc``, with the flags of ``native/Makefile``, into the
port's build directory (``_build/native/`` inside the package, listed in
``.gitignore``), named by a hash of the source and the flags, and loads
with :mod:`ctypes`.  Nothing is built at import, and nothing is written
beside the sources.

Concurrent first users (spawned compute processes, feed tasks) serialise
the compile through an ``flock`` and each library lands by an atomic
rename, so no process ever loads a half-written ``.so``.  A missing
compiler or a failed compile returns ``None`` with a logged warning:
the callers keep the reference's fallbacks (the queue feed, the
pure-Python example decoder and TFRecord framing).
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build", "native")

#: ``CXXFLAGS`` and ``LDFLAGS`` of ``native/Makefile``
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_loaded = {}
_failed = set()
_lock = threading.Lock()


def source_path(lib_name):
    """``native/<name>.cc`` for a library named ``lib<name>.so``."""
    return os.path.join(NATIVE_DIR, lib_name[3:-3] + ".cc")


def library_path(lib_name):
    """Where ``lib_name`` is (or will be) built: keyed by a hash of its
    source and the compiler flags."""
    h = hashlib.sha256()
    with open(source_path(lib_name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, "{0}-{1}.so".format(
        lib_name[:-3], h.hexdigest()[:16]))


def _build(lib_name, path):
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                return  # another process built it while this one waited
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                     source_path(lib_name)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def load_library(lib_name, configure):
    """Load (building if needed) ``lib_name`` from ``native/``.

    Args:
      lib_name: shared-object name, e.g. ``"libtfrecord_codec.so"``.
      configure: ``fn(lib)`` that sets restype/argtypes; called once.

    Returns the configured ``ctypes.CDLL``, or ``None`` when the build
    or the load failed (callers fall back to their Python paths).
    """
    with _lock:
        if lib_name in _loaded:
            return _loaded[lib_name]
        if lib_name in _failed:
            return None
        try:
            path = library_path(lib_name)
            if not os.path.exists(path):
                _build(lib_name, path)
            lib = ctypes.CDLL(path)
            configure(lib)
        except (OSError, AttributeError, ImportError,
                subprocess.SubprocessError) as e:
            logger.warning("native build or load of %s failed (%s); using "
                           "the Python fallback", lib_name, e)
            _failed.add(lib_name)
            return None
        _loaded[lib_name] = lib
        return lib


def loaded():
    """``{lib_name: path}`` of the libraries this process has loaded."""
    with _lock:
        return {name: lib._name for name, lib in _loaded.items()}
