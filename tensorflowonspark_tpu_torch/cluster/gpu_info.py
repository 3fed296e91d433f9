"""GPU discovery and per-process GPU allocation (the port's counterpart
of the JAX package's ``cluster/tpu_info.py``, written after the
original's ``gpu_info.py``, which ``cluster/node.py:678`` cites).

Discovery shells out to ``nvidia-smi``; nothing here initialises CUDA.
The executor process forks its queue manager, and a CUDA context does
not survive a fork, so only the spawned compute process may touch the
GPU.  Visibility is set in the executor with ``CUDA_VISIBLE_DEVICES``
before the compute process is spawned (``CUDA_DEVICE_ORDER=PCI_BUS_ID``
makes CUDA number the cards as ``nvidia-smi`` does), and the compute
process's ``cuda:0`` is then the first card chosen here.

A process that inherited ``CUDA_VISIBLE_DEVICES`` allocates only among
the cards it lists, and names the cards it chooses by those same
entries: an index is read in ``nvidia-smi``'s order (the order that
``PCI_BUS_ID`` gives CUDA too), a ``GPU-`` entry as a UUID prefix.
Placement is deterministic by host-local worker index, so co-located
workers land on disjoint cards, and oversubscription raises instead of
wrapping onto another worker's card.
"""

import logging
import os
import shutil
import subprocess

logger = logging.getLogger(__name__)

#: the query the allocation reads, one line per GPU
SMI_QUERY = ["--query-gpu=index,uuid,memory.used,memory.total",
             "--format=csv,noheader,nounits"]

#: a GPU counts as free when at least this fraction of its memory is
#: unused: a card another process has filled is not handed to a new
#: worker
MIN_FREE_FRACTION = 0.5

#: ``CUDA_VISIBLE_DEVICES`` as this process inherited it (under
#: ``"value"``, ``None`` when unset), kept by the first
#: :func:`set_visible_gpus`: an executor that allocates again, for a
#: later cluster on the same engine, chooses among the cards it was
#: given, not among the ones it chose the last time
_inherited = {}


class GPUDiscoveryError(RuntimeError):
    """``nvidia-smi`` is missing or failed, or no free GPU matches."""


def _nvidia_smi_output():
    """The raw ``nvidia-smi`` answer to :data:`SMI_QUERY`."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise GPUDiscoveryError("nvidia-smi is not on PATH")
    try:
        return subprocess.run([smi] + SMI_QUERY, check=True,
                              capture_output=True, text=True,
                              timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise GPUDiscoveryError("nvidia-smi failed: {0}".format(e))


def list_gpus():
    """``[{"index", "uuid", "memory_used_mib", "memory_total_mib"}]``,
    one per GPU of this host, in ``nvidia-smi`` order."""
    gpus = []
    for line in _nvidia_smi_output().splitlines():
        if not line.strip():
            continue
        index, uuid, used, total = (f.strip() for f in line.split(","))
        gpus.append({"index": int(index), "uuid": uuid,
                     "memory_used_mib": int(used),
                     "memory_total_mib": int(total)})
    return gpus


def get_device_info():
    """The reservation payload's description of this host's GPUs
    (``platform`` "gpu", or "none" when ``nvidia-smi`` finds none)."""
    gpus = list_gpus()
    return {"platform": "gpu" if gpus else "none",
            "num_devices": len(gpus), "devices": gpus}


def _match(entry, gpus):
    """The GPU that one ``CUDA_VISIBLE_DEVICES`` entry names."""
    if entry.isdigit():
        found = [g for g in gpus if g["index"] == int(entry)]
    elif entry.startswith("GPU-"):
        found = [g for g in gpus if g["uuid"].startswith(entry)]
    else:
        raise GPUDiscoveryError(
            "CUDA_VISIBLE_DEVICES entry {0!r} is neither an index nor a "
            "GPU- UUID".format(entry))
    if len(found) != 1:
        raise GPUDiscoveryError(
            "CUDA_VISIBLE_DEVICES entry {0!r} names {1} of this host's "
            "GPUs {2}".format(entry, len(found), gpus))
    return found[0]


def allocatable_gpus():
    """The GPUs this process may allocate, each with ``"id"``, the
    ``CUDA_VISIBLE_DEVICES`` entry that names it: every GPU of the host
    under its index, or, when the process inherited
    ``CUDA_VISIBLE_DEVICES``, the cards it lists, in its order and under
    its entries (an empty value lists none)."""
    gpus = list_gpus()
    given = (_inherited["value"] if "value" in _inherited
             else os.environ.get("CUDA_VISIBLE_DEVICES"))
    if given is None:
        return [dict(g, id=g["index"]) for g in gpus]
    entries = [e.strip() for e in given.split(",") if e.strip()]
    return [dict(_match(e, gpus), id=int(e) if e.isdigit() else e)
            for e in entries]


def _is_free(gpu):
    total = gpu["memory_total_mib"]
    return total > 0 and (total - gpu["memory_used_mib"]) >= \
        MIN_FREE_FRACTION * total


def get_gpus(num_gpus, worker_index=-1):
    """Allocate ``num_gpus`` free GPUs for this worker; returns their
    ``CUDA_VISIBLE_DEVICES`` entries (see :func:`allocatable_gpus`).

    The window is ``[worker_index * num_gpus, (worker_index + 1) *
    num_gpus)`` of the free allocatable GPUs in order (the first window
    when ``worker_index`` is negative).  Raises :class:`GPUDiscoveryError`
    without ``nvidia-smi``, and ``RuntimeError`` when the free GPUs do
    not cover the window.
    """
    gpus = allocatable_gpus()
    free = [g["id"] for g in gpus if _is_free(g)]
    start = 0 if worker_index < 0 else worker_index * num_gpus
    if start + num_gpus > len(free):
        raise RuntimeError(
            "worker {0} needs {1} free GPU(s) at positions [{2},{3}) but "
            "this process may use {4} free of {5}: {6}".format(
                worker_index, num_gpus, start, start + num_gpus, len(free),
                len(gpus), gpus)
        )
    return free[start:start + num_gpus]


def set_visible_gpus(gpu_ids):
    """Restrict processes spawned from here on to ``gpu_ids`` (entries
    from :func:`get_gpus`); call it before the compute process starts."""
    _inherited.setdefault("value", os.environ.get("CUDA_VISIBLE_DEVICES"))
    value = ",".join(str(g) for g in gpu_ids)
    os.environ["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    os.environ["CUDA_VISIBLE_DEVICES"] = value
    logger.info("CUDA_VISIBLE_DEVICES=%s", value)
