"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes` (pointers
as ``c_void_p``, launched on PyTorch's current stream).  Libraries are
built at first use into ``_build/`` inside the package (listed in
``.gitignore``), named by a hash of the source, the ``csrc/`` headers it
includes (``hopper.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads at once.  Nothing is
compiled when this module is imported.

A missing ``nvcc`` or a failed compile raises; there is no fallback.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

from tensorflowonspark_tpu_torch.compat import is_hopper

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: the tail the flash backward entries share: B, S, H, Hkv, D, scale,
#: causal, window, q_offset, is_bf16, stream (the forward's has out_f32
#: before is_bf16)
_FLASH_TAIL = [_I] * 5 + [_F] + [_I] * 4 + [_P]

#: library name -> (source file under csrc/, {C function: (argtypes, restype)})
KERNELS = {
    "paged_attention": (
        "paged_attention.cu",
        {
            # q, k, v, k_scale, v_scale, tables, lengths, out, ws_acc,
            # ws_ml, B, H, Hkv, D, P, T, NB, scale, window, splits,
            # q_bf16, kv_int8, stream
            "tfos_paged_attention": (
                [_P] * 10 + [_I] * 7 + [_F] + [_I] * 4 + [_P],
                _I,
            ),
        },
    ),
    "flash_attention": (
        "flash_attention.cu",
        {
            "tfos_flash_fwd": (
                [_P] * 5 + [_L] * 9 + _FLASH_TAIL[:-2] + [_I]
                + _FLASH_TAIL[-2:],
                _I,
            ),
            "tfos_flash_dq": ([_P] * 7 + [_L] * 12 + _FLASH_TAIL, _I),
            "tfos_flash_dkv": ([_P] * 8 + [_L] * 12 + _FLASH_TAIL, _I),
        },
    ),
    # a, b, tile_expert, [group_sizes,] out, N, D, F, E, bm, is_bf16,
    # stream (group_sizes: K5 and K6)
    "gmm": (
        "gmm.cu",
        {
            "tfos_gmm": ([_P] * 5 + [_I] * 6 + [_P], _I),
            "tfos_gmm_dxt": ([_P] * 5 + [_I] * 6 + [_P], _I),
            "tfos_tgmm": ([_P] * 4 + [_I] * 6 + [_P], _I),
        },
    ),
}

#: ``#include "file"`` lines: headers of ``csrc/`` (system headers use <>)
_LOCAL_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_lock = threading.Lock()
_loaded = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def nvcc_path():
    """The ``nvcc`` executable: ``PATH``, then ``$CUDA_HOME/bin``
    (``CUDA_HOME`` defaults to ``/usr/local/cuda``).  Raises
    :class:`KernelBuildError` when neither has one."""
    found = shutil.which("nvcc")
    if found:
        return found
    root = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(root, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise KernelBuildError(
        "nvcc not found on PATH or in {0}; the port's CUDA kernels are "
        "compiled at first use and need the CUDA toolkit".format(
            os.path.dirname(cand)
        )
    )


def sources(name):
    """The files under ``csrc/`` that library ``name`` compiles from: its
    source, then every header reached through ``#include "..."``, in the
    order first reached."""
    found, todo = [], [KERNELS[name][0]]
    while todo:
        src = todo.pop(0)
        if src in found:
            continue
        found.append(src)
        with open(os.path.join(CSRC_DIR, src)) as f:
            todo.extend(_LOCAL_INCLUDE.findall(f.read()))
    return found


def library_path(name):
    """Where library ``name`` is (or will be) built: keyed by a hash of
    its source, the headers it includes (:func:`sources`) and the
    compiler flags."""
    h = hashlib.sha256()
    for src in sources(name):
        h.update(src.encode())
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(
        BUILD_DIR, "lib{0}-{1}.so".format(name, h.hexdigest()[:16])
    )


def build(names=None):
    """Compile every library in ``names`` (default: all) that is not
    built yet, one ``nvcc`` per source, all started together.  Returns
    ``{name: seconds}`` (0.0 for a library already on disk).  The
    compiler's report (``-Xptxas=-v``: registers, shared memory,
    spills) is kept beside each library as ``<library>.log``."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    out = {}
    for name in names:
        path = library_path(name)
        if os.path.isfile(path):
            out[name] = 0.0
            continue
        nvcc = nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, KERNELS[name][0])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        started[name] = (proc, tmp, path, time.perf_counter(), cmd)
    failures = []
    for name, (proc, tmp, path, t0, cmd) in started.items():
        report, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        report = report.decode("utf-8", "replace")
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append("{0}: {1}\n{2}".format(name, " ".join(cmd), report))
            continue
        with open(path + ".log", "w") as f:
            f.write(report)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise KernelBuildError(
            "nvcc failed for {0} kernel source(s):\n{1}".format(
                len(failures), "\n".join(failures)
            )
        )
    return out


def build_report(name):
    """The compiler's ``-Xptxas=-v`` report for a built library."""
    with open(library_path(name) + ".log") as f:
        return f.read()


def load(name):
    """The :class:`ctypes.CDLL` of library ``name``, built on first use,
    with ``argtypes``/``restype`` declared for each C entry point.
    Raises :class:`KernelBuildError` unless the current CUDA device is a
    Hopper card (the only target the libraries are built for)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if not is_hopper():
            raise KernelBuildError(
                "the port's kernels are built for sm_90a (Hopper, "
                "capability 9.0); the current CUDA device is not one"
            )
        build([name])
        lib = ctypes.CDLL(library_path(name))
        for fn, (argtypes, restype) in KERNELS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
        return lib
