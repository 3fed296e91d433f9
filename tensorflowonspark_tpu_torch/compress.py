"""Gradient compression codecs for the parameter-server wire (port of the
JAX package's ``compress.py``; numpy on the host, as there).

- :class:`Int8Codec`: per-tensor symmetric int8 quantization (4x fewer
  wire bytes than float32), lossy; pair it with :class:`ErrorFeedback`,
  which keeps what the codec dropped and adds it to the next gradient,
  so the running sum of what crossed the wire tracks the running sum of
  the true gradients.
- :class:`TopKCodec`: magnitude top-k sparsification, shipped as
  (indices, values); always under error feedback.
- :class:`NoneCodec`: the identity.

The codecs run on host arrays after the device-to-host readback, with
the reference's arithmetic, so their bytes equal the reference's to the
bit.  The server decodes with the arithmetic the client used to compute
its residual, so both sides agree on what crossed the wire.

bfloat16 without ``ml_dtypes``: a bf16 array is its ``uint16`` bits in
the dtype :data:`BFLOAT16` (``uint16`` tagged with dtype metadata), which
:func:`dtype_str` spells ``"bfloat16"``, the reference's wire name.
:func:`widen` makes float32 of it before a codec does arithmetic, and
:func:`narrow` rounds float32 back to its bits (round to nearest even,
``ml_dtypes``' rule).  :func:`to_numpy` / :func:`to_torch` move between
these arrays and ``torch`` tensors (``.view(torch.bfloat16)``).

``encode`` returns ``(parts, meta)``: ``parts`` are C-contiguous arrays
laid on the socket as they are, ``meta`` a small JSON-able dict;
``decode(parts, meta)`` rebuilds the dense array.
"""

import numpy as np

__all__ = [
    "BFLOAT16",
    "CODECS",
    "Codec",
    "ErrorFeedback",
    "Int8Codec",
    "NoneCodec",
    "TopKCodec",
    "contiguous",
    "dtype_str",
    "encoded_nbytes",
    "get_codec",
    "is_bf16",
    "narrow",
    "resolve_dtype",
    "to_numpy",
    "to_torch",
    "widen",
]

_BF16_NAME = "bfloat16"

#: bfloat16 as its bits: ``uint16`` with dtype metadata naming it.
#: Reshapes, slices, copies and ``np.frombuffer`` keep the tag;
#: ``np.concatenate`` drops it (view the result again).
BFLOAT16 = np.dtype(np.uint16, metadata={"tfos_dtype": _BF16_NAME})


def is_bf16(dt):
    """True for :data:`BFLOAT16` (a plain ``uint16`` is not)."""
    md = np.dtype(dt).metadata
    return bool(md) and md.get("tfos_dtype") == _BF16_NAME


def dtype_str(dt):
    """Wire-safe dtype spelling: ``dtype.str`` for builtin numpy dtypes,
    ``"bfloat16"`` for :data:`BFLOAT16` (the reference's name for its
    ``ml_dtypes`` bf16, whose ``.str`` is an opaque ``'<V2'``)."""
    dt = np.dtype(dt)
    if is_bf16(dt):
        return _BF16_NAME
    s = dt.str
    try:
        if np.dtype(s) == dt:
            return s
    except TypeError:
        pass
    return dt.name


def resolve_dtype(s):
    """Inverse of :func:`dtype_str`: ``"bfloat16"`` is :data:`BFLOAT16`."""
    s = str(s)
    if s == _BF16_NAME:
        return BFLOAT16
    return np.dtype(s)


def widen(arr, copy=False):
    """``arr`` as float32: bf16 bits shifted into the high half of a
    float32, anything else by ``astype``."""
    arr = np.asarray(arr)
    if is_bf16(arr.dtype):
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float32, copy=copy)


def narrow(f32, dtype):
    """float32 ``f32`` in ``dtype``: round to nearest even into
    :data:`BFLOAT16` bits (NaN stays a quiet NaN of its sign), anything
    else by ``astype``."""
    dtype = np.dtype(dtype)
    if not is_bf16(dtype):
        return np.asarray(f32).astype(dtype, copy=False)
    f = np.ascontiguousarray(f32, dtype=np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    bits = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    bits = np.where(np.isnan(f), ((u >> 16) | 0x40).astype(np.uint16), bits)
    return bits.view(BFLOAT16)


def contiguous(arr):
    """``np.ascontiguousarray(arr)``, keeping the bf16 tag (numpy drops
    dtype metadata on some of its copies, a 0-d input's for one)."""
    arr = np.asarray(arr)
    out = np.ascontiguousarray(arr)
    if out.dtype.metadata != arr.dtype.metadata:
        out = out.view(arr.dtype)
    return out


def to_numpy(t):
    """A CPU ``torch`` tensor as a numpy array sharing its memory
    (bfloat16 as :data:`BFLOAT16` bits)."""
    import torch

    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BFLOAT16)
    return t.numpy()


def to_torch(arr):
    """A numpy array as a CPU ``torch`` tensor sharing its memory
    (:data:`BFLOAT16` bits as ``torch.bfloat16``)."""
    import torch

    arr = np.asarray(arr)
    if is_bf16(arr.dtype):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Codec(object):
    """Base codec: ``encode(arr) -> (parts, meta)``, ``decode`` inverts.

    ``parts`` arrays must be C-contiguous (they go onto the socket as
    memoryviews); ``meta`` must be JSON-able.
    """

    name = None

    def encode(self, arr):
        raise NotImplementedError

    def decode(self, parts, meta):
        raise NotImplementedError

    def spec(self):
        """JSON-able constructor spec, ``[name, kwargs]``: what the client
        advertises when it negotiates a reply codec."""
        return [self.name, {}]


class NoneCodec(Codec):
    """Identity codec: one part, the array itself."""

    name = "none"

    def encode(self, arr):
        arr = contiguous(arr)
        return [arr], {"dtype": dtype_str(arr.dtype), "shape": list(arr.shape)}

    def decode(self, parts, meta):
        return parts[0]


class Int8Codec(Codec):
    """Per-tensor symmetric int8 quantization: ``q = round(x / scale)``
    with ``scale = max|x| / 127``; zero maps to zero exactly, and the
    scale rides in the JSON meta.  The reference's arithmetic, with its
    temporaries reused in place (one allocation a pass fewer: a tensor is
    hundreds of megabytes at the flagship's width)."""

    name = "int8"

    def encode(self, arr):
        arr = contiguous(arr)
        dtype = arr.dtype
        f = widen(arr)
        # max|x| without the |x| copy (NaN propagates as through abs)
        amax = float(np.maximum(f.max(), -f.min())) if f.size else 0.0
        scale = amax / 127.0 if amax > 0 else 1.0
        q = f / scale
        np.rint(q, out=q)
        np.clip(q, -127, 127, out=q)
        q = q.astype(np.int8)
        return [q], {
            "dtype": dtype_str(dtype),
            "shape": list(arr.shape),
            "scale": scale,
        }

    def decode(self, parts, meta):
        q = parts[0].reshape(meta["shape"])
        out = q.astype(np.float32)
        out *= np.float32(meta["scale"])
        return narrow(out, resolve_dtype(meta["dtype"]))


class TopKCodec(Codec):
    """Magnitude top-k sparsification: the k largest-|x| entries as
    (flat indices, values); the receiver scatters them into zeros.

    Args:
      ratio: fraction of entries kept (``k = ceil(ratio * n)``, min 1).
      min_size: tensors of at most this many elements ship dense.
    """

    name = "topk"

    def __init__(self, ratio=0.01, min_size=1024):
        if not 0.0 < ratio <= 1.0:
            raise ValueError("topk ratio must be in (0, 1], got %r" % ratio)
        self.ratio = float(ratio)
        self.min_size = int(min_size)

    def spec(self):
        return [self.name, {"ratio": self.ratio, "min_size": self.min_size}]

    def encode(self, arr):
        arr = contiguous(arr)
        dtype = arr.dtype
        flat = widen(arr.reshape(-1))
        n = flat.size
        if n <= self.min_size:
            return [arr], {
                "dtype": dtype_str(dtype),
                "shape": list(arr.shape),
                "dense": True,
            }
        k = max(1, int(np.ceil(self.ratio * n)))
        # argpartition is O(n); the indices are sorted so the wire format
        # is canonical (equal inputs give equal bytes)
        idx = np.argpartition(np.abs(flat), n - k)[n - k:]
        idx = np.sort(idx).astype(np.int64 if n > np.iinfo(np.int32).max
                                  else np.int32)
        vals = np.ascontiguousarray(flat[idx])
        idx = np.ascontiguousarray(idx)
        return [idx, vals], {
            "dtype": dtype_str(dtype),
            "shape": list(arr.shape),
            "k": int(k),
        }

    def decode(self, parts, meta):
        shape = meta["shape"]
        dtype = resolve_dtype(meta["dtype"])
        if meta.get("dense"):
            return parts[0].reshape(shape)
        idx, vals = parts
        out = np.zeros(int(np.prod(shape)) if shape else 1, np.float32)
        out[idx] = vals
        return narrow(out.reshape(shape), dtype)


CODECS = {c.name: c for c in (NoneCodec, Int8Codec, TopKCodec)}


def get_codec(spec):
    """Resolve a codec spec: an instance passes through; a name or a
    ``(name, kwargs)`` pair constructs from :data:`CODECS` (named specs
    only, never deserialized code)."""
    if spec is None:
        return None
    if isinstance(spec, Codec):
        return spec
    if isinstance(spec, str):
        name, kwargs = spec, {}
    else:
        name, kwargs = spec[0], (spec[1] if len(spec) > 1 else None) or {}
    if name not in CODECS:
        raise ValueError(
            "unknown codec {0!r}; supported: {1}".format(name, sorted(CODECS))
        )
    return CODECS[name](**kwargs)


def encoded_nbytes(parts):
    """Payload bytes a parts list lays on the wire (headers excluded)."""
    return sum(int(p.nbytes) for p in parts)


class ErrorFeedback(object):
    """Client-side error feedback around a lossy codec.

    Per tensor name, the residual ``r`` accumulates what compression
    dropped; each step encodes ``g + r`` and keeps the new remainder:

        e = encode(g + r);  r' = (g + r) - decode(e)

    so the sum of decoded messages telescopes to the sum of the true
    gradients.  The residual stays float32 for a bf16 gradient too: bf16
    would round away the small corrections it exists to carry.

    Each name's residual is read and written by one caller at a time
    (the PS client's shard workers partition the name space).
    """

    def __init__(self, codec):
        self.codec = get_codec(codec)
        if self.codec is None or isinstance(self.codec, NoneCodec):
            raise ValueError("error feedback requires a lossy codec")
        self._residual = {}

    @property
    def name(self):
        return self.codec.name

    def spec(self):
        return self.codec.spec()

    def encode_named(self, name, arr):
        """Encode ``arr`` under the accumulated residual for ``name``."""
        arr = np.asarray(arr)
        f = widen(arr, copy=True)
        r = self._residual.get(name)
        if r is not None and r.shape == f.shape:
            f += r
        parts, meta = self.codec.encode(f)
        # the decode of copied parts is a fresh array: f - approx in place
        approx = widen(self.codec.decode([p.copy() for p in parts], meta))
        self._residual[name] = np.subtract(f, approx, out=approx)
        # the receiver reconstructs in the original dtype
        meta = dict(meta, dtype=dtype_str(arr.dtype))
        return parts, meta

    def decode(self, parts, meta):
        return self.codec.decode(parts, meta)

    def reset(self):
        self._residual.clear()
