"""Flax's layers as ``nn.Module``s, for the vision and MNIST models
(:mod:`.mlp`, :mod:`.resnet`, :mod:`.unet`), and the weight carrier
between their Flax trees and the port's modules.

Each layer computes what its Flax namesake computes, in the same types:
parameters are f32 (Flax's default ``param_dtype``) and are cast to the
layer's compute ``dtype`` at use.  Activations inside the models are
``[B, C, H, W]`` tensors (a view of the ``[B, H, W, C]`` input, so
``channels_last`` in memory); the models take and return Flax's NHWC
at their API.  Where Flax and PyTorch differ:

- ``"SAME"`` padding is Flax's: ``total = max((ceil(n / s) - 1) * s + k
  - n, 0)`` split ``(total // 2, total - total // 2)``, so a 3x3 stride-2
  conv over an even size pads ``(0, 1)``, which ``F.conv2d(padding=1)``
  cannot express; an uneven split pads explicitly (:func:`same_pads`).
  :func:`max_pool` pads with ``-inf`` the same way.
- :class:`ConvTranspose` is ``lax.conv_transpose`` without a transposed
  kernel: PyTorch's transposed convolution over the Flax kernel flipped
  on both spatial axes (the carrier flips it), its padding mapped from
  ``lax``'s ``"SAME"`` rule.
- :class:`BatchNorm` keeps Flax's rule: statistics in f32 with the
  biased variance ``max(0, E[x^2] - E[x]^2)``, running averages
  ``momentum * ra + (1 - momentum) * batch`` (``torch.nn.BatchNorm2d``
  folds in the unbiased variance).  In training the layer does not
  touch its buffers: it writes the new averages into the ``updates``
  dict its model passes down, which the model returns (the reference's
  ``mutable=["batch_stats"]``).  Inside :func:`batch_stats_group` the
  sums are all-reduced over that process group with the differentiable
  ``torch.distributed.nn.functional.all_reduce``, so the statistics are
  the global batch's, as in the reference's one program over the
  sharded batch.
- :class:`GroupNorm`'s epsilon defaults to Flax's 1e-6 (PyTorch's is
  1e-5).

The carrier (:func:`load_flax`, :func:`flax_variables`) maps each
layer's leaves by the module path, which the models name as Flax does:

==================  =================  =====================================
Flax leaf           shape              port
==================  =================  =====================================
``Dense/kernel``    ``[in, out]``      ``weight [out, in]``
``Conv/kernel``     ``[kh, kw, I, O]`` ``weight [O, I, kh, kw]`` (depthwise
                                       ``[3, 3, 1, C]`` -> ``[C, 1, 3, 3]``)
``ConvTranspose``   ``[kh, kw, I, O]`` ``weight [I, O, kh, kw]``, flipped
``/kernel``                            on both spatial axes
``*/bias``,         as is              as is
``*Norm*/scale``
``BatchNorm``       ``[C]``            buffers ``mean`` / ``var``
``batch_stats``
==================  =================  =====================================
"""

import contextlib
import threading
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.compat import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(dtype):
    """A model's ``dtype`` (a name, as the reference's, or a torch
    type) as a torch type."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError("dtype must be one of {0}, got {1!r}".format(
            sorted(_DTYPES), dtype)) from None


def model_device(device):
    """The device a model is built on: ``"meta"`` as is, else
    :func:`~..compat.resolve_device`'s (``cuda`` unless the caller asks
    for the CPU)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def same_pads(size, kernel, stride):
    """Flax's ``"SAME"`` padding ``(lo, hi)`` of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_args(x, pads):
    """``(x, padding)`` for a PyTorch conv or pool: symmetric ``pads``
    become its ``padding``; uneven ones pad ``x`` here."""
    (h0, h1), (w0, w1) = pads
    if h0 == h1 and w0 == w1:
        return x, (h0, w0)
    return F.pad(x, (w0, w1, h0, h1)), (0, 0)


def max_pool(x, window, stride):
    """``nn.max_pool(x, (window, window), (stride, stride), "SAME")`` of
    a ``[B, C, H, W]`` tensor: ``-inf`` padding split as Flax splits it."""
    (h0, h1), (w0, w1) = (same_pads(n, window, stride) for n in x.shape[2:])
    x = F.pad(x, (w0, w1, h0, h1), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def _normal_(t, fan_in):
    """``N(0, 1/fan_in)`` (the scale of Flax's ``lecun_normal``,
    untruncated) unless ``t`` is a shell on the meta device."""
    if t.device.type != "meta":
        with torch.no_grad():
            t.normal_(0.0, fan_in ** -0.5)
    return t


def _param(shape, device, fill=None):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None and t.device.type != "meta":
        t.fill_(fill)
    return nn.Parameter(t)


class Dense(nn.Module):
    """``nn.Dense``: ``x @ kernel + bias`` in ``dtype``."""

    FLAX = {"kernel": ("params", "weight", "dense"),
            "bias": ("params", "bias", None)}

    def __init__(self, in_features, features, use_bias=True,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = model_device(device)
        self.dtype = torch_dtype(dtype)
        self.weight = _normal_(_param((features, in_features), device),
                               in_features)
        self.bias = _param((features,), device, 0.0) if use_bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Conv(nn.Module):
    """``nn.Conv`` over ``[B, C, H, W]``: ``padding`` is ``"SAME"`` or
    Flax's explicit ``[(lo, hi), (lo, hi)]``; ``groups`` is Flax's
    ``feature_group_count``."""

    FLAX = {"kernel": ("params", "weight", "conv"),
            "bias": ("params", "bias", None)}

    def __init__(self, in_features, features, kernel, strides=1,
                 padding="SAME", groups=1, use_bias=True,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = model_device(device)
        self.dtype = torch_dtype(dtype)
        self.kernel, self.strides, self.groups = kernel, strides, groups
        self.padding = padding
        fan_in = kernel * kernel * in_features // groups
        self.weight = _normal_(_param(
            (features, in_features // groups, kernel, kernel), device),
            fan_in)
        self.bias = _param((features,), device, 0.0) if use_bias else None

    def forward(self, x):
        pads = self.padding
        if pads == "SAME":
            pads = [same_pads(n, self.kernel, self.strides)
                    for n in x.shape[2:]]
        x, padding = _pad_args(x.to(self.dtype), pads)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.strides,
                        padding, groups=self.groups)


def _transpose_pads(kernel, stride):
    """``lax.conv_transpose``'s ``"SAME"`` padding of the dilated input,
    as PyTorch's ``(padding, output_padding)``."""
    total = kernel + stride - 2
    lo = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    hi = total - lo
    if hi < lo or hi - lo >= stride:
        raise ValueError("no PyTorch padding for kernel {0}, stride "
                         "{1}".format(kernel, stride))
    return kernel - 1 - lo, hi - lo


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose(padding="SAME")`` over ``[B, C, H, W]``; its
    weight is the Flax kernel flipped on both spatial axes, in
    PyTorch's ``[in, out, kh, kw]`` layout."""

    FLAX = {"kernel": ("params", "weight", "conv_transpose"),
            "bias": ("params", "bias", None)}

    def __init__(self, in_features, features, kernel, strides,
                 use_bias=True, dtype=torch.float32, device=None):
        super().__init__()
        device = model_device(device)
        self.dtype = torch_dtype(dtype)
        self.strides = strides
        self.pads = _transpose_pads(kernel, strides)
        self.weight = _normal_(_param(
            (in_features, features, kernel, kernel), device),
            kernel * kernel * in_features)
        self.bias = _param((features,), device, 0.0) if use_bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype), bias, self.strides,
            self.pads[0], output_padding=self.pads[1])


class _StatsGroup(threading.local):
    group = None


_STATS = _StatsGroup()


@contextlib.contextmanager
def batch_stats_group(group):
    """Within this block (in this thread), :class:`BatchNorm` layers in
    training reduce their statistics over ``group`` (a process group;
    ``None``: this process's batch alone).  The trainer enters it around
    the loss."""
    prev, _STATS.group = _STATS.group, group
    try:
        yield
    finally:
        _STATS.group = prev


def _stats_dtype(x):
    """Flax's statistics type: at least f32."""
    return torch.promote_types(x.dtype, torch.float32)


def moments(x, dims, group=None):
    """``(mean, var)`` of ``x`` over ``dims``, at least in f32, with
    Flax's fast variance ``max(0, E[x^2] - E[x]^2)``; over every rank of
    ``group`` when one is given (one differentiable all-reduce of the
    sums and the count)."""
    x = x.to(_stats_dtype(x))
    count = 1
    for d in dims:
        count *= x.shape[d]
    s, s2 = x.sum(dims), x.square().sum(dims)
    if group is None:
        n = float(count)
    else:
        from torch.distributed.nn.functional import all_reduce

        flat = all_reduce(torch.cat([
            s.reshape(-1), s2.reshape(-1),
            torch.full((1,), float(count), dtype=x.dtype, device=x.device)]),
            group=group)
        k = s.numel()
        s, s2, n = flat[:k].view(s.shape), flat[k:2 * k].view(s.shape), \
            flat[2 * k]
    mean = s / n
    return mean, torch.clamp(s2 / n - mean.square(), min=0.0)


def _normalize(x, mean, var, scale, bias, epsilon, dtype):
    """Flax's ``_normalize`` of ``[B, C, H, W]`` by statistics of shape
    ``[C]`` or ``[B, C, 1, 1]``: ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in the statistics' type, returned in ``dtype``."""
    shape = (1, -1, 1, 1)
    mean, var = mean.view(-1, x.shape[1], 1, 1), var.view(-1, x.shape[1],
                                                          1, 1)
    mul = torch.rsqrt(var + epsilon) * scale.view(shape)
    y = (x.to(torch.promote_types(x.dtype, mean.dtype)) - mean) * mul
    return (y + bias.view(shape)).to(dtype)


class BatchNorm(nn.Module):
    """``nn.BatchNorm`` over the channels of ``[B, C, H, W]`` (see the
    module docstring); ``forward(x, train, updates)``."""

    FLAX = {"scale": ("params", "scale", None),
            "bias": ("params", "bias", None),
            "mean": ("batch_stats", "mean", None),
            "var": ("batch_stats", "var", None)}

    def __init__(self, features, momentum=0.9, epsilon=1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = model_device(device)
        self.dtype = torch_dtype(dtype)
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = _param((features,), device, 1.0)
        self.bias = _param((features,), device, 0.0)
        self.register_buffer("mean", torch.zeros(
            features, dtype=torch.float32, device=device))
        self.register_buffer("var", torch.ones(
            features, dtype=torch.float32, device=device))
        #: this layer's path in its model (set by :func:`name_batch_norms`)
        self.path = None

    def forward(self, x, train=False, updates=None):
        if not train:
            mean, var = self.mean, self.var
        else:
            mean, var = moments(x, (0, 2, 3), _STATS.group)
            if updates is not None:
                m = self.momentum
                updates[self.path + "mean"] = (
                    m * self.mean + (1 - m) * mean.detach())
                updates[self.path + "var"] = (
                    m * self.var + (1 - m) * var.detach())
        return _normalize(x, mean, var, self.scale, self.bias, self.epsilon,
                          self.dtype)


def name_batch_norms(model):
    """Tell every :class:`BatchNorm` of ``model`` its buffer prefix
    (``"stem.bn."``), under which it reports its new statistics."""
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            module.path = name + "."


class GroupNorm(nn.Module):
    """``nn.GroupNorm(num_groups, dtype=dtype)`` over ``[B, C, H, W]``:
    f32 statistics per sample and group, Flax's epsilon (1e-6)."""

    FLAX = {"scale": ("params", "scale", None),
            "bias": ("params", "bias", None)}

    def __init__(self, num_groups, features, epsilon=1e-6,
                 dtype=torch.float32, device=None):
        super().__init__()
        if features % num_groups:
            raise ValueError("{0} groups do not divide {1} channels".format(
                num_groups, features))
        device = model_device(device)
        self.num_groups, self.epsilon = num_groups, epsilon
        self.dtype = torch_dtype(dtype)
        self.scale = _param((features,), device, 1.0)
        self.bias = _param((features,), device, 0.0)

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.num_groups
        mean, var = moments(x.reshape(b, g, c // g, h, w), (2, 3, 4))
        return _normalize(x, mean.repeat_interleave(c // g, dim=1),
                          var.repeat_interleave(c // g, dim=1), self.scale,
                          self.bias, self.epsilon, self.dtype)


def cross_entropy(logits, labels):
    """``(mean nll, {"accuracy"})`` of ``[..., K]`` logits against
    integer ``[...]`` labels, as the reference's losses compute them
    (log-softmax in f32)."""
    labels = labels.to(torch.int64)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.unsqueeze(-1)).squeeze(-1)
    acc = (torch.argmax(logits, dim=-1) == labels).to(torch.float32).mean()
    return nll.mean(), {"accuracy": acc}


# ----------------------------------------------------------------------
# the weight carrier
# ----------------------------------------------------------------------

_TO_PORT = {
    None: lambda t: t,
    "dense": lambda t: t.t(),
    "conv": lambda t: t.permute(3, 2, 0, 1),
    "conv_transpose": lambda t: t.permute(2, 3, 0, 1).flip(2, 3),
}
_TO_FLAX = {
    None: lambda t: t,
    "dense": lambda t: t.t(),
    "conv": lambda t: t.permute(2, 3, 1, 0),
    "conv_transpose": lambda t: t.flip(2, 3).permute(2, 3, 0, 1),
}


def flax_layout(model):
    """``{(collection, "a/b/leaf"): (module, attribute, layout)}`` of
    every Flax leaf ``model``'s layers hold."""
    out = {}
    for name, module in model.named_modules():
        spec = getattr(type(module), "FLAX", None)
        if spec is None:
            continue
        prefix = name.replace(".", "/") + "/" if name else ""
        for leaf, (collection, attr, layout) in spec.items():
            if getattr(module, attr) is not None:
                out[(collection, prefix + leaf)] = (module, attr, layout)
    return out


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = "{0}/{1}".format(prefix, key) if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def as_f32(leaf):
    """A tree leaf (an array or a tensor) as an f32 tensor (a copy)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(torch.float32, copy=True)
    return torch.tensor(np.asarray(leaf, dtype=np.float32))


def load_flax(variables, model):
    """``model`` holding the weights of a Flax variables dict
    (``{"params": ..., "batch_stats": ...}``, or bare params for a model
    without BatchNorm): every leaf copied into the model's tensors in
    place, in the port's layout, as f32.  A missing, extra or misshapen
    leaf raises ``ValueError``.  Returns ``model``."""
    if not (isinstance(variables, Mapping) and "params" in variables):
        variables = {"params": variables}
    have = {(coll, path): leaf for coll, tree in variables.items()
            for path, leaf in _flatten(tree).items()}
    want = flax_layout(model)
    missing = sorted("/".join(k) for k in set(want) - set(have))
    extra = sorted("/".join(k) for k in set(have) - set(want))
    if missing or extra:
        raise ValueError("variables do not match the model: missing {0}, "
                         "extra {1}".format(missing, extra))
    for key, (module, attr, layout) in want.items():
        target = getattr(module, attr)
        leaf = as_f32(have[key])
        flax_shape = tuple(_TO_FLAX[layout](
            torch.empty(target.shape, device="meta")).shape)
        if tuple(leaf.shape) != flax_shape:
            raise ValueError("leaf {0} has shape {1}, the model needs "
                             "{2}".format("/".join(key), tuple(leaf.shape),
                                          flax_shape))
        with torch.no_grad():
            target.copy_(_TO_PORT[layout](leaf))
    return model


def flax_variables(model):
    """``model``'s weights as a Flax variables dict of f32 numpy arrays
    (``{"params": ...}``, with ``"batch_stats"`` when the model has
    BatchNorm layers): the inverse of :func:`load_flax`, what the JAX
    model's ``init`` would return, e.g. for ``save_for_serving``."""
    out = {}
    for (collection, path), (module, attr, layout) in sorted(
            flax_layout(model).items()):
        t = _TO_FLAX[layout](getattr(module, attr).detach().to(
            torch.float32))
        node = out.setdefault(collection, {})
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        # a copy: the tree never aliases the model's storage
        node[name] = np.array(t.cpu().numpy())
    return out

