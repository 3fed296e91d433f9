"""Train-state checkpoints and serving exports (port of the JAX package's
``checkpoint.py``).

The reference writes its arrays with orbax, which imports JAX.  This
module writes the layout orbax reads without OCDBT, with nothing but
``json`` and ``numpy``, so an export written here loads unchanged in the
JAX package's ``load_for_serving``:

- ``<arrays>/_METADATA``: the tree's key paths, as orbax writes it, with
  ``"use_ocdbt": false``;
- one directory per leaf, named by its dotted key path
  (``params/block_0.attn.q.kernel/``), holding a zarr-v2 ``.zarray``
  with ``"compressor": null`` and one chunk file (``0.0`` for a 2-D
  leaf, ``0`` for 1-D and 0-d) of raw C-order little-endian bytes;
- a bf16 leaf is zarr dtype ``"bfloat16"``, stored as its raw bits.

The reference's default exports use OCDBT, whose files are
zstd-compressed; numpy cannot read them.  :func:`load_for_serving`
refuses them with a ``ValueError`` naming ``convert_jax_export.py``,
the root tool that rewrites such an export in this layout where JAX is
installed.

- :func:`save_for_serving` / :func:`publish_for_serving` /
  :func:`list_serving_steps` / :func:`load_for_serving`: the params-only
  serving export, atomic as the reference's: everything is staged in
  ``<dir>.tmp-<pid>``, the :data:`MANIFEST_NAME` census is written last,
  an old export moves aside and ``os.replace`` publishes the new one.
- :class:`Checkpointer`: train-state checkpoints with orbax's retention
  and save-interval rules, one ``<directory>/<step>/`` per step in the
  same layout (the arrays under ``state/``), committed the same way.
  ``save`` copies every tensor to the host before it returns; only the
  file writes run in the background, since the trainer updates its
  parameters and moments in place.

Local paths only: a remote URI raises ``NotImplementedError``.  A train
state written by the reference's ``Checkpointer`` (an optax state tree)
is not read here; the serving export is the format that crosses between
the two packages.
"""

import json
import logging
import os
import shutil
import sys
import threading
from collections.abc import Mapping

import numpy as np

from .utils import not_ported as _not_ported

logger = logging.getLogger(__name__)

#: Completion marker + shape/dtype census of an export or a checkpoint
#: step; written LAST inside the staging directory.
MANIFEST_NAME = "manifest.json"

#: the root tool that rewrites a reference export in this layout
CONVERT_TOOL = "convert_jax_export.py"

_METADATA = "_METADATA"
_ZARRAY = ".zarray"
#: orbax's ``KeyType`` of a dict key
_DICT_KEY = 2


def _local_path(directory):
    path = os.fspath(directory)
    if "://" in str(path):
        raise _not_ported("remote checkpoint URI {0!r}".format(path),
                          "remote checkpoint URIs")
    return os.path.abspath(path)


# ----------------------------------------------------------------------
# leaves, trees and the on-disk layout
# ----------------------------------------------------------------------


def _items(tree, prefix=()):
    """``(key path, leaf)`` of every leaf of a nested dict, keys sorted as
    ``jax.tree_util`` flattens them."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _items(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _keystr(path):
    """``jax.tree_util.keystr`` of a path of dict keys: ``['a']['b']``."""
    return "".join("[{0!r}]".format(k) for k in path)


def _dtype_name(leaf):
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        return type(leaf).__name__
    return str(dtype).replace("torch.", "")


def _census_items(params):
    """``(key string, array)`` of every leaf, quantized leaves as the
    reference's pytree flattening sees them: a ``QTensor`` as its codes
    (the leaf's own shape), a ``QTensor4`` as its two children."""
    qz = sys.modules.get(__package__ + ".quantize")
    for path, leaf in _items(params):
        if qz is not None and isinstance(leaf, qz.QTensor):
            yield _keystr(path), leaf.q
        elif qz is not None and isinstance(leaf, qz.QTensor4):
            yield _keystr(path) + "[<flat index 0>]", leaf.packed
            yield _keystr(path) + "[<flat index 1>]", leaf.scale
        else:
            yield _keystr(path), leaf


def param_manifest(params):
    """Per-leaf ``{path: {"shape": [...], "dtype": str}}`` census of a
    parameter tree, with the reference's key strings
    (``"['block_0']['attn']['q']['kernel']"``) and dtype names
    (``"float32"``, ``"bfloat16"``); torch tensors are named as numpy
    would name their dtype.  Quantized leaves are censused as the
    reference censuses them (:func:`_census_items`)."""
    return {
        key: {
            "shape": [int(s) for s in getattr(leaf, "shape", ())],
            "dtype": _dtype_name(leaf),
        }
        for key, leaf in _census_items(params)
    }


def _host_array(leaf, copy):
    """``(array, dtype name)``: ``leaf`` as a host numpy array (a bf16
    leaf as its raw ``uint16`` bits).  Tensors are always copied to the
    host; numpy leaves are copied when ``copy`` is set."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _dtype_name(t)
    if not isinstance(leaf, (np.ndarray, np.generic)) \
            and not hasattr(leaf, "__array__"):
        raise TypeError("a checkpoint leaf must be an array or a tensor, "
                        "got {0!r}".format(type(leaf).__name__))
    arr = np.array(leaf, copy=True) if copy else np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes, as JAX hands it over
        return arr.view(np.uint16), "bfloat16"
    return arr, arr.dtype.name


def _zarr_dtype(arr, name):
    if name == "bfloat16":
        return "bfloat16"
    if arr.dtype.kind not in "biuf":
        raise TypeError("leaf dtype {0} cannot be written".format(name))
    return arr.dtype.newbyteorder("<").str


def _snapshot(tree, copy):
    """``[(key path, host array, zarr dtype)]`` of every leaf."""
    out = []
    for path, leaf in _items(tree):
        arr, name = _host_array(leaf, copy)
        out.append((path, arr, _zarr_dtype(arr, name)))
    return out


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_tree(directory, leaves):
    """Write :func:`_snapshot`'s leaves under ``directory`` (created) in
    orbax's non-OCDBT layout, each chunk file synced to disk."""
    os.makedirs(directory)
    tree_metadata = {}
    for path, arr, zdtype in leaves:
        if any(not isinstance(k, str) or "/" in k for k in path):
            raise ValueError("checkpoint keys must be strings without '/', "
                             "got {0!r}".format(path))
        if arr.size == 0:
            raise ValueError("zero-size leaf {0} cannot be written".format(
                _keystr(path)))
        name = ".".join(path)
        leaf_dir = os.path.join(directory, name)
        os.mkdir(leaf_dir)  # a second leaf of the same dotted name fails
        shape = [int(s) for s in arr.shape]
        with open(os.path.join(leaf_dir, _ZARRAY), "w") as f:
            json.dump({"chunks": shape, "compressor": None,
                       "dimension_separator": ".", "dtype": zdtype,
                       "fill_value": None, "filters": None, "order": "C",
                       "shape": shape, "zarr_format": 2}, f)
        chunk = ".".join("0" for _ in shape) or "0"
        with open(os.path.join(leaf_dir, chunk), "wb") as f:
            data = np.ascontiguousarray(arr)
            if data.dtype.byteorder == ">":
                data = data.astype(data.dtype.newbyteorder("<"))
            data.tofile(f)
            f.flush()
            os.fsync(f.fileno())
        tree_metadata[str(path)] = {
            "key_metadata": [{"key": k, "key_type": _DICT_KEY}
                             for k in path],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False},
        }
    with open(os.path.join(directory, _METADATA), "w") as f:
        json.dump({"tree_metadata": tree_metadata, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
        f.flush()
        os.fsync(f.fileno())


def _unreadable(directory, why):
    return ValueError(
        "{0} is not in the layout this package reads ({1}); rewrite the "
        "export with `python {2} SRC DST` where JAX is installed".format(
            directory, why, CONVERT_TOOL))


def _read_leaf(leaf_dir):
    try:
        with open(os.path.join(leaf_dir, _ZARRAY)) as f:
            zarray = json.load(f)
    except (OSError, ValueError):
        raise _unreadable(leaf_dir, "no readable .zarray") from None
    if zarray.get("zarr_format") != 2:
        raise _unreadable(leaf_dir, "not zarr v2")
    if zarray.get("compressor") is not None or zarray.get("filters"):
        raise _unreadable(leaf_dir, "compressed chunks")
    shape = tuple(int(s) for s in zarray["shape"])
    if list(zarray["chunks"]) != list(shape) or zarray.get("order") != "C":
        raise _unreadable(leaf_dir, "more than one chunk or Fortran order")
    bf16 = zarray["dtype"] == "bfloat16"
    try:
        dtype = np.dtype("<u2" if bf16 else zarray["dtype"])
    except TypeError:
        dtype = np.dtype("V")
    if dtype.kind not in "biuf":
        raise _unreadable(leaf_dir, "dtype {0}".format(zarray["dtype"]))
    sep = zarray.get("dimension_separator", ".")
    chunk = sep.join("0" for _ in shape) or "0"
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.fromfile(os.path.join(leaf_dir, chunk), dtype=dtype)
    if arr.size != count:
        raise ValueError("{0}: chunk holds {1} values, shape {2} needs "
                         "{3}".format(leaf_dir, arr.size, shape, count))
    arr = arr.reshape(shape).astype(dtype.newbyteorder("="), copy=False)
    if bf16:
        import torch

        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def _read_tree(directory):
    """The nested dict written by :func:`_write_tree` (or by orbax without
    OCDBT and compression): numpy leaves, bf16 leaves as CPU
    ``torch.bfloat16`` tensors."""
    if os.path.exists(os.path.join(directory, "manifest.ocdbt")):
        raise _unreadable(directory, "OCDBT")
    try:
        with open(os.path.join(directory, _METADATA)) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        raise _unreadable(directory, "no readable _METADATA") from None
    if meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise _unreadable(directory, "OCDBT" if meta.get("use_ocdbt")
                          else "zarr v3")
    tree = {}
    for entry in meta.get("tree_metadata", {}).values():
        keys = entry["key_metadata"]
        if any(k.get("key_type") != _DICT_KEY for k in keys):
            raise _unreadable(directory, "a key that is not a dict key")
        path = [str(k["key"]) for k in keys]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _read_leaf(os.path.join(directory, ".".join(path)))
    return tree


# ----------------------------------------------------------------------
# processes
# ----------------------------------------------------------------------


def _world():
    """``(rank, barrier)``: this process's rank and a barrier over every
    rank (``None`` with one process)."""
    if "torch" not in sys.modules:  # no process group without torch
        return 0, None
    import torch.distributed as dist

    if (not dist.is_available() or not dist.is_initialized()
            or dist.get_world_size() == 1):
        return 0, None
    from .parallel.dp import host_group

    group = host_group()
    return dist.get_rank(), lambda: dist.barrier(group=group)


# ----------------------------------------------------------------------
# atomic publish, shared by exports and checkpoint steps
# ----------------------------------------------------------------------


def write_manifest(directory, step=None, params=None, extra=None):
    """Write the completion manifest (see :data:`MANIFEST_NAME`).  Call
    LAST: its presence says every other file finished writing."""
    manifest = {"complete": True}
    if step is not None:
        manifest["step"] = int(step)
    if params is not None:
        manifest["params"] = param_manifest(params)
    if extra:
        manifest.update(extra)
    path = os.path.join(os.fspath(directory), MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return manifest


def read_manifest(directory):
    """The manifest dict, or ``None`` when absent or unparseable (the
    directory is not, or not yet, complete)."""
    path = os.path.join(os.fspath(directory), MANIFEST_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _publish(directory, arrays, leaves, census, step=None, metadata=None):
    """Stage ``leaves`` under ``<directory>.tmp-<pid>/<arrays>`` (and
    ``metadata.json``), write the manifest last, and publish by rename;
    an existing ``directory`` moves aside first."""
    parent = os.path.dirname(directory)
    os.makedirs(parent, exist_ok=True)
    staging = "{0}.tmp-{1}".format(directory, os.getpid())
    if os.path.isdir(staging):
        shutil.rmtree(staging)
    try:
        _write_tree(os.path.join(staging, arrays), leaves)
        if metadata is not None:
            with open(os.path.join(staging, "metadata.json"), "w") as f:
                json.dump(metadata, f)
        write_manifest(staging, step=step, extra={"params": census})
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    # os.replace refuses a non-empty target: a complete old export moves
    # aside, so the one non-atomic window swaps two complete exports
    old = None
    if os.path.isdir(directory):
        old = "{0}.old-{1}".format(directory, os.getpid())
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.replace(directory, old)
    os.replace(staging, directory)
    _fsync_dir(parent)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


# ----------------------------------------------------------------------
# serving exports
# ----------------------------------------------------------------------


def save_for_serving(directory, params, extra_metadata=None,
                     output_schema=None, step=None):
    """Export inference params (+ JSON metadata) atomically.

    ``params`` is a nested dict of numpy arrays or tensors in the Flax
    layout (e.g. ``convert.tree_from_model(model)``); tensors are copied
    to the host first.  Under a process group of more than one rank,
    rank 0 writes and every rank waits for it.  Returns the directory.
    """
    directory = _local_path(directory)
    rank, barrier = _world()
    if rank == 0:
        meta = dict(extra_metadata or {})
        if output_schema is not None:
            meta["output_schema"] = (
                output_schema if isinstance(output_schema, str)
                else [list(f) for f in output_schema]
            )
        _publish(directory, "params", _snapshot(params, copy=False),
                 param_manifest(params), step=step, metadata=meta)
        logger.info("serving export written to %s", directory)
    if barrier is not None:
        barrier()
    return directory


def publish_for_serving(root, step, params, extra_metadata=None,
                        output_schema=None):
    """Publish a step-numbered export ``root/<step>/`` whose manifest
    carries the step; returns the step directory."""
    root = _local_path(root)
    os.makedirs(root, exist_ok=True)
    return save_for_serving(
        os.path.join(root, str(int(step))), params,
        extra_metadata=extra_metadata, output_schema=output_schema,
        step=int(step),
    )


def list_serving_steps(root):
    """Sorted step numbers of the complete exports (or checkpoint steps)
    under ``root``: directories named by an integer whose manifest
    parses and says ``complete: true``.  Staging, torn and foreign
    directories are skipped."""
    root = _local_path(root)
    try:
        names = os.listdir(root)
    except OSError:
        return []
    steps = []
    for name in names:
        try:
            step = int(name)
        except ValueError:
            continue
        manifest = read_manifest(os.path.join(root, name))
        if manifest and manifest.get("complete"):
            steps.append(step)
    return sorted(steps)


def load_for_serving(directory):
    """Load a serving export; returns ``(params, metadata dict)``.

    Leaves come back as numpy arrays, bf16 leaves as CPU
    ``torch.bfloat16`` tensors.  An OCDBT export (the reference's
    default) or compressed chunks raise ``ValueError`` naming
    ``convert_jax_export.py``."""
    directory = _local_path(directory)
    params = _read_tree(os.path.join(directory, "params"))
    meta = {}
    meta_path = os.path.join(directory, "metadata.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return params, meta


# ----------------------------------------------------------------------
# train-state checkpoints
# ----------------------------------------------------------------------


def _state_tree(state):
    """A train state as a tree: a ``TrainState`` as ``step``, ``params``
    (under the port's own names), ``opt_state`` and ``model_state``; a
    nested dict as it is."""
    from . import optim
    from .parallel.dp import TrainState

    if isinstance(state, TrainState):
        return {"step": state.step, "params": dict(state.params),
                "opt_state": optim.state_tree(state.opt_state, state.params),
                "model_state": state.model_state}
    if isinstance(state, Mapping):
        return state
    raise TypeError("a checkpoint holds a TrainState or a nested dict, got "
                    "{0!r}".format(type(state).__name__))


def _as_tensor(leaf):
    import torch

    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))


def _copy_into(target, loaded, where):
    """``loaded`` copied into ``target``'s tensors in place (numpy leaves
    replaced); returns the restored tree."""
    import torch

    if isinstance(target, Mapping):
        if set(target) != set(loaded):
            raise ValueError("{0}: checkpoint keys {1} != the state's "
                             "{2}".format(where, sorted(loaded),
                                          sorted(target)))
        return {k: _copy_into(target[k], loaded[k], where + _keystr((k,)))
                for k in target}
    if isinstance(target, torch.Tensor):
        src = _as_tensor(loaded)
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError("{0}: checkpoint shape {1} != the state's "
                             "{2}".format(where, tuple(src.shape),
                                          tuple(target.shape)))
        with torch.no_grad():
            target.copy_(src)
        return target
    return loaded


def _restore_state(state, tree):
    import torch

    from . import optim
    from .parallel.dp import TrainState

    if not isinstance(state, TrainState):
        return _copy_into(_state_tree(state), tree, "state")
    _copy_into(state.params, tree.get("params", {}), "['params']")
    model_state = _copy_into(state.model_state, tree.get("model_state", {}),
                             "['model_state']")
    optim.load_state_tree(state.opt_state, state.params,
                          tree.get("opt_state", {}))
    step = torch.tensor(int(tree["step"]), dtype=torch.int64,
                        device=state.step.device)
    return state.replace(step=step, model_state=model_state)


class Checkpointer(object):
    """Train-state checkpointing with retention (the reference's
    orbax-backed ``Checkpointer``, same rules).

    Args:
      directory: checkpoint root (created if missing); one ``<step>/``
        directory per kept step.
      max_to_keep: retention window (``None`` keeps all).
      save_interval_steps: a step is saved when it is a multiple of this,
        or when there is no checkpoint yet, and never at or below the
        latest step (orbax's ``CheckpointManager`` rules).

    Under a process group of more than one rank, every rank calls
    ``save`` and ``restore``: rank 0 writes, and every rank waits for
    the write on a barrier in :meth:`wait_until_finished`.
    """

    def __init__(self, directory, max_to_keep=3, save_interval_steps=1):
        directory = _local_path(directory)
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.save_interval_steps = int(save_interval_steps or 1)
        self._steps = list_serving_steps(directory)
        self._thread = None
        self._error = None
        self._pending = False  # a save not yet waited for (every rank)

    # -- train-state ---------------------------------------------------

    def save(self, step, state, wait=False):
        """Save a ``TrainState`` (or a nested dict of tensors and arrays)
        at ``step``; returns whether the step was saved.

        Every tensor is copied to the host before this returns; the file
        writes run in a background thread unless ``wait=True``.
        """
        step = int(step)
        self.wait_until_finished()
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        if self._steps and step % self.save_interval_steps:
            return False
        rank, _ = _world()
        doomed = []
        self._steps.append(step)
        if self.max_to_keep is not None and \
                len(self._steps) > self.max_to_keep:
            doomed = self._steps[:-self.max_to_keep]
            self._steps = self._steps[-self.max_to_keep:]
        self._pending = True
        if rank == 0:
            tree = _state_tree(state)
            leaves = _snapshot(tree, copy=True)
            census = param_manifest(tree)
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, census, doomed),
                name="checkpoint-{0}".format(step), daemon=True)
            self._thread.start()
        if wait:
            self.wait_until_finished()
        return True

    def _write(self, step, leaves, census, doomed):
        try:
            _publish(os.path.join(self.directory, str(step)), "state",
                     leaves, census, step=step)
            for old in doomed:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
            logger.info("checkpoint step %d written to %s", step,
                        self.directory)
        except Exception as e:  # noqa: BLE001 - re-raised by the waiter
            self._error = e

    def restore(self, state_like, step=None):
        """Restore ``step`` (default: the latest) into ``state_like``: its
        tensors are overwritten in place on their devices, and the state
        is returned (a ``TrainState`` with its step set)."""
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    "no checkpoint found under {0}".format(self.directory))
        tree = _read_tree(os.path.join(self.directory, str(int(step)),
                                       "state"))
        return _restore_state(state_like, tree)

    def latest_step(self):
        return self._steps[-1] if self._steps else None

    def all_steps(self):
        return list(self._steps)

    def wait_until_finished(self):
        """Wait for the save in flight (re-raising its error), then, under
        several ranks, for every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            self._pending = False
            self._steps = list_serving_steps(self.directory)
            raise error
        if self._pending:
            self._pending = False
            _, barrier = _world()
            if barrier is not None:
                barrier()

    def close(self):
        self.wait_until_finished()
