"""In-memory dataset pipeline: the ``tf.data`` role for self-read input
(a copy of the JAX package's ``data/dataset.py``).

Columnar numpy arrays with a lazy transformation chain, ending in
batches on the device through
:func:`~.feed.prefetch_to_device`::

    ds = (Dataset.from_tfrecords(path, {"image": ("float32", 784),
                                        "label": ("int64", 1)})
            .shard(ctx.num_workers, ctx.task_index)
            .shuffle(seed=0)
            .repeat(3)
            .batch(64)
            .map(normalize))
    for device_batch in ds.prefetch(sharding=trainer.batch_sharding()):
        state, metrics = trainer.step_on_device(state, device_batch)

Each transformation returns a new Dataset (arrays are shared, not
copied).  Shuffling reshuffles every epoch with a per-epoch seed
(``seed + epoch``), as ``tf.data``'s
``shuffle(reshuffle_each_iteration=True)`` does, and gives the same rows
in the same order as the JAX package's for the same seed.
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)


class Dataset(object):
    """Columnar in-memory dataset with a lazy op chain."""

    def __init__(self, columns, ops=()):
        """``columns``: dict of equal-length numpy arrays."""
        lengths = {k: len(v) for k, v in columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(
                "columns must have equal lengths, got {0}".format(lengths)
            )
        self._columns = {k: np.asarray(v) for k, v in columns.items()}
        self._ops = tuple(ops)

    # -- sources -------------------------------------------------------

    @classmethod
    def from_arrays(cls, **columns):
        return cls(columns)

    @classmethod
    def from_tfrecords(cls, path, columns, shard=None):
        """Load a TFRecord file/dir through the native columnar decoder.

        Args:
          columns: ``{name: (dtype, width)}``; width-1 columns are
            squeezed to rank-1 like tf.data scalar features.
          shard: optional ``(num_shards, index)`` applied to the *file
            list* BEFORE decoding (each worker reads 1/N of the I/O —
            the reference's file-sharding pattern,
            examples/mnist/keras/mnist_tf_ds.py:42-47).  File shards
            may be uneven; prefer row-level :meth:`shard` when the data
            is small enough that decoding it all is cheap and uniform
            shard sizes matter more.
        """
        from . import columnar, tfrecord as tfr
        from .interchange import _record_files

        files = _record_files(path)
        if shard is not None:
            num, idx = shard
            if not 0 <= idx < num:
                raise ValueError("shard index must be in [0, num_shards)")
            files = files[idx::num]
        records = []
        for f in files:
            records.extend(tfr.read_records(f))
        data = columnar.decode_batch(records, columns)
        out = {}
        for name, arr in data.items():
            out[name] = arr[:, 0] if arr.shape[1] == 1 else arr
        return cls(out)

    # -- transformations (lazy) ----------------------------------------

    def _with(self, op):
        return Dataset(self._columns, self._ops + (op,))

    def shard(self, num_shards, index):
        """Keep every ``num_shards``-th row starting at ``index`` (the
        per-worker split, tf.data ``shard`` role)."""
        if not 0 <= index < num_shards:
            raise ValueError("index must be in [0, num_shards)")
        cols = {k: v[index::num_shards] for k, v in self._columns.items()}
        return Dataset(cols, self._ops)

    def shuffle(self, seed=0):
        return self._with(("shuffle", seed))

    def repeat(self, epochs=1):
        """Iterate the data ``epochs`` times (``None`` = forever)."""
        return self._with(("repeat", epochs))

    def batch(self, batch_size, drop_remainder=True):
        """Emit ``{name: array[batch, ...]}`` batches.  Dropping the
        remainder (the default) keeps every batch the same shape."""
        return self._with(("batch", (batch_size, drop_remainder)))

    def map(self, fn):
        """Apply ``fn(batch_dict) -> batch_dict`` to each batch (after
        ``batch``) or ``fn(row_dict_of_scalars)`` is NOT supported —
        map operates on batches, where vectorized numpy work belongs."""
        return self._with(("map", fn))

    # -- execution -----------------------------------------------------

    @property
    def num_rows(self):
        return len(next(iter(self._columns.values()))) if self._columns else 0

    def __iter__(self):
        shuffle_seed = None
        epochs = 1
        batch_spec = None
        maps = []
        for op, arg in self._ops:
            if op == "shuffle":
                shuffle_seed = arg
            elif op == "repeat":
                epochs = arg
            elif op == "batch":
                batch_spec = arg
            elif op == "map":
                maps.append(arg)
        if batch_spec is None:
            raise ValueError("call .batch(n) before iterating")
        batch_size, drop_remainder = batch_spec
        n = self.num_rows
        if n == 0 or (drop_remainder and n < batch_size):
            # zero batches per epoch: with repeat(None) the epoch loop
            # would spin forever yielding nothing
            raise ValueError(
                "dataset has {0} rows — fewer than one batch of {1}; {2}".format(
                    n,
                    batch_size,
                    "add data"
                    if n == 0
                    else "reduce batch_size or disable drop_remainder",
                )
            )
        epoch = 0
        while epochs is None or epoch < epochs:
            if shuffle_seed is not None:
                perm = np.random.RandomState(
                    (shuffle_seed + epoch) & 0x7FFFFFFF
                ).permutation(n)
            else:
                perm = None
            end = (n // batch_size) * batch_size if drop_remainder else n
            for lo in range(0, end, batch_size):
                idx = (
                    perm[lo : lo + batch_size]
                    if perm is not None
                    else slice(lo, lo + batch_size)
                )
                batch = {k: v[idx] for k, v in self._columns.items()}
                for fn in maps:
                    batch = fn(batch)
                yield batch
            epoch += 1

    def prefetch(self, size=2, sharding=None):
        """Iterate with device placement pipelined ``size`` batches deep
        (see :func:`~.feed.prefetch_to_device`): ``sharding`` is a
        device (``None``: the current CUDA device; ``"cpu"`` runs the
        same pipeline on the CPU)."""
        from .feed import prefetch_to_device

        return prefetch_to_device(iter(self), size=size, sharding=sharding)

    def steps_per_epoch(self, batch_size=None):
        """Full batches per epoch (uses the chained batch size when
        ``batch_size`` is None)."""
        if batch_size is None:
            for op, arg in self._ops:
                if op == "batch":
                    batch_size = arg[0]
        if not batch_size:
            raise ValueError("no batch size chained or given")
        return self.num_rows // batch_size
