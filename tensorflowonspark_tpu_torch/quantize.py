"""Weight-only int8 / int4 quantization for serving and decode (port of
the JAX package's ``quantize.py``).

The functions work on a **Flax-layout tree**: nested dicts whose leaves
are numpy arrays or tensors, named as the JAX model's
``LOGICAL_AXES_RULES`` name them (see :mod:`.convert`).  Codes and
scales are bit for bit the reference's on the same tree: the quantizer
runs in f32, ``torch.round`` is round-half-to-even like ``jnp.round``,
and the int4 groups run over the *flattened leading axes* of each leaf
in its Flax layout (a q kernel ``[E, H, D]`` groups 64 consecutive rows
of ``E·H``), never over the port's ``[out, in]`` layout.

- int8 (:class:`QTensor`): symmetric, one scale per output channel
  (reduced over every axis but the last); embedding tables per row;
  expert-stacked MoE leaves ``[X, E, F]`` per expert (reduced over axis
  1 only).
- int4 (:class:`QTensor4`): symmetric over ``[-7, 7]`` with one f32 scale
  per ``group_size`` contraction rows per output channel, two codes
  packed per byte along the contraction (row ``2i`` in the low nibble).
  :func:`quantize_tree_int4` keeps the int8 scheme for embeddings and
  expert stacks, as the reference does.

Leaves come back as tensors on the leaf's device (numpy leaves on the
CPU); a model built from such a tree keeps the codes on its device and
dequantizes at use (:mod:`.convert`, ``QuantizedWeights``).
"""

from collections.abc import Mapping

import numpy as np
import torch


class QTensor(object):
    """Symmetric per-channel int8 weight: ``w ≈ q * scale``."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale):
        self.q = q  # int8, the leaf's shape
        self.scale = scale  # f32, keepdims-reduced over the quantized axes

    @property
    def shape(self):
        return tuple(self.q.shape)

    def __iter__(self):
        return iter((self.q, self.scale))

    def __repr__(self):
        return "QTensor(shape={0})".format(self.shape)


class QTensor4(object):
    """Symmetric group-wise int4 weight, packed two codes per byte.

    ``packed`` is ``uint8 [Kp // 2, N]`` where ``Kp`` is the flattened
    contraction length padded up to ``group_size``; ``scale`` is ``f32
    [Kp // group_size, N]``; ``shape`` is the leaf's own shape.
    """

    __slots__ = ("packed", "scale", "shape", "group_size")

    def __init__(self, packed, scale, shape, group_size):
        self.packed = packed
        self.scale = scale
        self.shape = tuple(shape)
        self.group_size = int(group_size)

    def __repr__(self):
        return "QTensor4(shape={0}, group_size={1})".format(
            self.shape, self.group_size
        )


def _is_q(x):
    return isinstance(x, QTensor)


def _is_q4(x):
    return isinstance(x, QTensor4)


def _is_any_q(x):
    return isinstance(x, (QTensor, QTensor4))


def as_tensor(w, device=None):
    """A leaf as a tensor (numpy ``bfloat16`` leaves through their
    bits), on ``device`` when given."""
    if not isinstance(w, torch.Tensor):
        a = np.asarray(w)
        if a.dtype.name == "bfloat16":
            w = torch.from_numpy(
                np.ascontiguousarray(a).view(np.uint16)
            ).view(torch.bfloat16)
        else:
            a = np.ascontiguousarray(a)
            w = torch.from_numpy(a if a.flags.writeable else a.copy())
    return w if device is None else w.to(device)


def _is_float(w):
    if isinstance(w, torch.Tensor):
        return w.is_floating_point()
    dt = np.asarray(w).dtype
    return np.issubdtype(dt, np.floating) or dt.name == "bfloat16"


def quantize_leaf(w, reduce_axes):
    """Quantize one float array to int8 over ``reduce_axes``."""
    wf = as_tensor(w).to(torch.float32)
    amax = torch.amax(torch.abs(wf), dim=tuple(reduce_axes), keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize_leaf(qt, dtype=torch.bfloat16):
    return qt.q.to(dtype) * qt.scale.to(dtype)


# ----------------------------------------------------------------------
# int4: group-wise scales, two codes per byte
# ----------------------------------------------------------------------


def pack_int4(q):
    """Pack signed int4 codes (int8 values in ``[-8, 7]``) along axis 0
    into ``uint8`` nibbles: row ``2i`` low, row ``2i + 1`` high.  Axis 0
    must be even."""
    q = as_tensor(q)
    if q.shape[0] % 2:
        raise ValueError(
            "pack_int4 needs an even leading dim, got {0}".format(
                tuple(q.shape))
        )
    # two's-complement nibble
    u = (q.to(torch.int16) & 0xF).to(torch.uint8)
    return u[0::2] | (u[1::2] << 4)


def unpack_int4(packed):
    """Inverse of :func:`pack_int4`: ``uint8 [K/2, ...]`` -> signed int8
    codes ``[K, ...]`` in ``[-8, 7]``."""
    p = as_tensor(packed)
    lo = (p & 0xF).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    pair = torch.stack(
        [torch.where(n >= 8, n - 16, n) for n in (lo, hi)], dim=1
    )  # [K/2, 2, ...]
    return pair.reshape((p.shape[0] * 2,) + tuple(p.shape[1:]))


def _contraction_rows(shape):
    k = 1
    for s in shape[:-1]:
        k *= s
    return k


def quantize_leaf_int4(w, group_size=64):
    """Quantize one float array to packed int4 with group-wise scales.

    The array is viewed as ``[K, N]`` (``N`` its last axis, ``K`` the
    flattened leading axes) and split into groups of ``group_size`` rows
    of ``K``; each (group, output channel) gets its own scale.  ``K``
    pads with zero rows up to a whole group (sliced off at dequant)."""
    g = int(group_size)
    if g < 2 or g % 2:
        raise ValueError(
            "group_size must be an even int >= 2, got {0}".format(group_size)
        )
    wf = as_tensor(w).to(torch.float32)
    shape = tuple(wf.shape)
    n = shape[-1]
    k = _contraction_rows(shape)
    w2 = wf.reshape(k, n)
    kp = ((k + g - 1) // g) * g
    if kp != k:
        w2 = torch.cat([w2, w2.new_zeros((kp - k, n))], dim=0)
    wg = w2.reshape(kp // g, g, n)
    amax = torch.amax(torch.abs(wg), dim=1, keepdim=True)  # [G, 1, N]
    scale = torch.clamp_min(amax, 1e-12) / 7.0
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    return QTensor4(pack_int4(q.reshape(kp, n)), scale[:, 0, :], shape, g)


def dequantize_leaf_int4(qt, dtype=torch.bfloat16):
    """Unpack and group-scale a :class:`QTensor4` in f32, then cast to
    ``dtype``, at its original shape."""
    g = qt.group_size
    q = unpack_int4(qt.packed)  # [Kp, N] int8
    kp, n = q.shape
    w = q.reshape(kp // g, g, n).to(torch.float32) * qt.scale[:, None, :]
    k = _contraction_rows(qt.shape)
    return w.reshape(kp, n)[:k].reshape(qt.shape).to(dtype)


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def _leaves_with_path(tree, path=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (k,))
    else:
        yield path, tree


def _selector(min_size, embed_key, expert_keys, dense):
    def _one(path, w):
        if _is_any_q(w):
            # already quantized: pass through (double application is a
            # no-op, as in the reference)
            return w
        if not hasattr(w, "shape") or len(w.shape) < 2:
            return w
        size = int(np.prod(w.shape))
        if size < min_size or not _is_float(w):
            return w
        names = [str(k) for k in path]
        if any(embed_key in n for n in names):
            return quantize_leaf(w, reduce_axes=(len(w.shape) - 1,))
        if len(w.shape) == 3 and names and names[-1] in expert_keys:
            return quantize_leaf(w, reduce_axes=(1,))
        return dense(w)

    return _one


def quantize_tree(params, min_size=16384, embed_key="embedding",
                  expert_keys=("wi", "wg", "wo")):
    """Quantize every matmul-sized weight of a Flax-layout tree to int8.

    Leaves with ``ndim >= 2`` and ``size >= min_size`` become
    :class:`QTensor`; everything else passes through unchanged.  Leaves
    whose path contains ``embed_key`` get per-row scales, 3-D leaves
    named in ``expert_keys`` per-expert scales (reduced over axis 1),
    all others per-output-channel scales (reduced over every axis but
    the last)."""
    return _map_with_path(
        _selector(min_size, embed_key, expert_keys,
                  lambda w: quantize_leaf(
                      w, reduce_axes=tuple(range(len(w.shape) - 1)))),
        params,
    )


def quantize_tree_int4(params, group_size=64, min_size=16384,
                       embed_key="embedding", expert_keys=("wi", "wg", "wo")):
    """int4 twin of :func:`quantize_tree`: dense matmul kernels become
    :class:`QTensor4`; embeddings and expert stacks keep int8."""
    return _map_with_path(
        _selector(min_size, embed_key, expert_keys,
                  lambda w: quantize_leaf_int4(w, group_size=group_size)),
        params,
    )


def is_quantized(params):
    """True if any leaf of ``params`` is a :class:`QTensor` /
    :class:`QTensor4`."""
    return any(_is_any_q(x) for _, x in _leaves_with_path(params))


def quantization_of(params):
    """``"int4"`` when any packed leaf is present, ``"int8"`` for pure
    :class:`QTensor` trees, else ``None``."""
    leaves = [x for _, x in _leaves_with_path(params)]
    if any(_is_q4(x) for x in leaves):
        return "int4"
    if any(_is_q(x) for x in leaves):
        return "int8"
    return None


def dequantize_leaf_any(x, dtype=torch.bfloat16):
    """A quantized leaf of either scheme back to ``dtype``; any other
    leaf unchanged."""
    if _is_q4(x):
        return dequantize_leaf_int4(x, dtype)
    if _is_q(x):
        return dequantize_leaf(x, dtype)
    return x


def dequantize_tree(params, dtype=torch.bfloat16, barrier=True):
    """A float tree from a (partly) quantized one.

    ``barrier`` keeps the reference's signature.  There it pins the
    dequant inside the decode step so XLA cannot hoist it; eager
    PyTorch hoists nothing, so here it changes nothing: each call
    dequantizes where it is made."""
    del barrier
    return _map_with_path(
        lambda _, x: dequantize_leaf_any(x, dtype), params
    )


def _keystr(path):
    return "".join("[{0!r}]".format(str(k)) for k in path)


def quantization_error(params, qparams):
    """Max relative error per quantized leaf, keyed like the reference's
    ``jax.tree_util.keystr`` (``['block_0']['attn']['q']['kernel']``)."""
    orig = dict(_leaves_with_path(params))
    out = {}
    for path, leaf in _leaves_with_path(qparams):
        if _is_any_q(leaf):
            w = as_tensor(orig[path]).to(torch.float32)
            deq = dequantize_leaf_any(leaf, torch.float32).to(w.device)
            err = torch.max(torch.abs(deq - w))
            out[_keystr(path)] = float(err / torch.max(torch.abs(w)))
    return out
