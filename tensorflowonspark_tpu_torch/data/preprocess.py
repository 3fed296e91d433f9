"""On-device input preprocessing: the compute half of the narrow-dtype
data plane (port of the JAX package's ``data/preprocess.py``).

The wire half (:class:`~.columnar.WireSpec`, the columnar feed, the shm
ring) keeps image and token columns in their storage dtype, so uint8
pixels or uint16 token ids cross the host-to-device link narrow.  This
module builds the small graph (cast, scale, offset, mean subtraction,
std division, optional center crop and random flip) that widens them
on the device in front of the train or predict step:

- ``prefetch_to_device(..., preprocess=...)`` (``data/feed.py``), after
  the copy;
- ``SyncTrainer(device_preprocess=...)`` (``parallel/dp.py``), at the
  top of every step.

The functions take and return tensors (a numpy array is taken as a CPU
tensor); ``torch`` is imported inside :func:`make_preprocess`, as the
reference imports ``jax`` there, so the host side never loads it.  The
random flip draws from a ``torch.Generator`` on the batch's device,
where the reference splits a JAX key.
"""

import inspect

#: dtypes the default column selection treats as narrow wire inputs that
#: need widening (labels and indices are typically int32/int64 and are
#: left alone)
NARROW_DTYPES = ("uint8", "int8", "uint16", "int16")


def _dtype_name(a):
    """``"uint8"`` for a numpy array or a tensor of that dtype, ``None``
    for a value without one."""
    dt = getattr(a, "dtype", None)
    return None if dt is None else str(dt).rsplit(".", 1)[-1]


def _is_narrow(a):
    return _dtype_name(a) in NARROW_DTYPES


def make_preprocess(columns=None, dtype="float32", scale=None, offset=None,
                    mean=None, std=None, crop=None, flip=False):
    """Build a batch preprocess ``fn(batch[, rng])``.

    ``batch`` may be a single tensor, a tuple of columns, or a dict of
    named columns; the transform applies to the selected columns and
    passes the rest through untouched.

    Args:
      columns: which entries to transform, a list of names (dict
        batches) or indices (tuple batches).  Default ``None`` selects
        every column with a narrow wire dtype (uint8/int8/uint16/int16).
      dtype: compute dtype the selected columns are cast to (a name such
        as ``"float32"``, ``"int32"``, ``"bfloat16"``, or a
        ``torch.dtype``).
      scale / offset: ``x * scale + offset`` after the cast.
      mean / std: ``(x - mean) / std`` after scale/offset (arrays
        broadcast, e.g. per-channel statistics).
      crop: ``(h, w)`` center crop of axes 1 and 2 (NHWC batches).
      flip: random horizontal flip (axis 2) per row; needs a
        ``torch.Generator`` on the batch's device as ``rng`` at call
        time, and is skipped with ``rng=None`` (the deterministic eval
        path).

    Returns ``fn(batch, rng=None)`` when ``flip`` is set, else the
    one-argument ``fn(batch)``, so a caller that probes for an rng
    argument (:func:`takes_rng`) hands none to a preprocess that cannot
    use it.
    """
    import numpy as np
    import torch

    if isinstance(dtype, torch.dtype):
        out_dtype = dtype
    elif isinstance(dtype, str) and dtype == "bfloat16":  # not in numpy
        out_dtype = torch.bfloat16
    else:
        out_dtype = getattr(torch, np.dtype(dtype).name)

    def const(v, x):
        return torch.as_tensor(np.asarray(v), device=x.device).to(out_dtype)

    def _one(x, rng):
        x = torch.as_tensor(x).to(out_dtype)
        if scale is not None:
            x = x * const(scale, x)
        if offset is not None:
            x = x + const(offset, x)
        if mean is not None:
            x = x - const(mean, x)
        if std is not None:
            x = x / const(std, x)
        if crop is not None:
            ch, cw = crop
            if x.ndim < 3:
                raise ValueError("crop needs [N, H, W, ...] batches; got "
                                 "shape %s" % (tuple(x.shape),))
            h0 = (x.shape[1] - ch) // 2
            w0 = (x.shape[2] - cw) // 2
            if h0 < 0 or w0 < 0:
                raise ValueError("crop %s larger than input %s"
                                 % (crop, tuple(x.shape)))
            x = x[:, h0:h0 + ch, w0:w0 + cw]
        if flip and rng is not None:
            if x.ndim < 3:
                raise ValueError("flip needs [N, H, W, ...] batches; got "
                                 "shape %s" % (tuple(x.shape),))
            coin = torch.rand(x.shape[0], generator=rng,
                              device=x.device) < 0.5
            shape = (x.shape[0],) + (1,) * (x.ndim - 1)
            x = torch.where(coin.reshape(shape), x.flip(2), x)
        return x

    def _selected(key, value):
        if columns is not None:
            return key in columns
        return _is_narrow(value)

    def preprocess(batch, rng=None):
        if isinstance(batch, dict):
            return {k: _one(v, rng) if _selected(k, v) else v
                    for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return tuple(_one(v, rng) if _selected(i, v) else v
                         for i, v in enumerate(batch))
        return _one(batch, rng)

    if flip:
        return preprocess

    def deterministic(batch):
        return preprocess(batch, None)

    return deterministic


def resolve_preprocess(spec):
    """Normalize a preprocess argument: a callable passes through, a dict
    becomes ``make_preprocess(**spec)`` (the JSON-serializable form),
    ``None`` stays ``None``."""
    if spec is None or callable(spec):
        return spec
    if isinstance(spec, dict):
        return make_preprocess(**spec)
    raise TypeError("preprocess must be a callable or a make_preprocess "
                    "kwargs dict, got {0!r}".format(type(spec)))


def takes_rng(fn):
    """True when ``fn`` accepts a second (rng) argument: the probe the
    train step uses to decide whether to hand its generator over."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = [p for p in sig.parameters.values()
              if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if any(p.kind == p.VAR_POSITIONAL for p in sig.parameters.values()):
        return True
    return len(params) >= 2 or "rng" in sig.parameters
