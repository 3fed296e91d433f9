"""The weight carrier: Flax-layout parameter trees into the port's
:class:`~tensorflowonspark_tpu_torch.models.transformer.Transformer`.

A tree is nested dicts of numpy arrays (``jax.tree.map(np.asarray,
variables["params"])`` of the JAX model, or :func:`init_params_tree`) or
of tensors (bf16 leaves as :func:`..checkpoint.load_for_serving` returns
them), named as the JAX model's ``LOGICAL_AXES_RULES`` name them:

=============================  ============  =============================
Flax leaf                      shape         port
=============================  ============  =============================
``embedding``                  ``[V, E]``    as is
``block_i/attn/{q,k,v}/kernel`` ``[E, H, D]`` ``[E, H*D]``, transposed
``block_i/attn/out/kernel``    ``[H, D, E]`` ``[H*D, E]``, transposed
``block_i/mlp/{wi,wg}/kernel`` ``[E, F]``    transposed
``block_i/mlp/wo/kernel``      ``[F, E]``    transposed
``block_i/moe/router``         ``[E, X]``    as is (f32)
``block_i/moe/{wi,wg}``        ``[X, E, F]`` as is
``block_i/moe/wo``             ``[X, F, E]`` as is
``*/ln1|ln2|ln_f/scale``       ``[E]``       as is (f32)
``lm_head/kernel``             ``[E, V]``    transposed
=============================  ============  =============================

(``H`` is ``num_kv_heads`` for ``k``/``v``; ``X`` is ``num_experts``,
and a MoE block has ``moe/`` leaves in place of ``mlp/``.)  Transposes
land in ``nn.Linear``'s ``[out, in]`` layout; the expert stacks keep
the layout the grouped-matmul kernels read.  Any missing, extra or
misshapen leaf raises ``ValueError``; fused-QKV leaves raise
``NotImplementedError``.  :func:`tree_from_model` is the inverse: a
model's weights as a tree of f32 numpy arrays in the Flax layout.

A tree from :func:`..quantize.quantize_tree` or ``quantize_tree_int4``
(``QTensor``/``QTensor4`` leaves) loads too: the model's weights are the
tree dequantized once to ``cfg.dtype`` (the reference's
``dequantize_tree(qparams, cfg.dtype)``, which its prefill and logits
path use), and the model keeps the codes on its device as
:class:`QuantizedWeights` (``model.qweights``) for the decode steps,
which dequantize again at each step.
"""

from collections.abc import Mapping

import numpy as np
import torch

from tensorflowonspark_tpu_torch import quantize as qz
from tensorflowonspark_tpu_torch.utils import not_ported as _not_ported


def _check_ported(cfg):
    if cfg.fused_qkv:
        raise _not_ported("fused_qkv projections", "fused_qkv")


def tree_shapes(cfg):
    """``{tree path: shape}`` of every leaf the model has."""
    _check_ported(cfg)
    e, f, v = cfg.embed_dim, cfg.mlp_dim, cfg.vocab_size
    h, d = cfg.num_heads, cfg.head_dim
    hkv = cfg.num_kv_heads or h
    x = cfg.num_experts
    out = {"embedding": (v, e), "ln_f/scale": (e,), "lm_head/kernel": (e, v)}
    for i in range(cfg.num_layers):
        blk = "block_%d/" % i
        out.update({
            blk + "ln1/scale": (e,),
            blk + "ln2/scale": (e,),
            blk + "attn/q/kernel": (e, h, d),
            blk + "attn/k/kernel": (e, hkv, d),
            blk + "attn/v/kernel": (e, hkv, d),
            blk + "attn/out/kernel": (h, d, e),
        })
        if x > 0:
            out.update({
                blk + "moe/router": (e, x),
                blk + "moe/wi": (x, e, f),
                blk + "moe/wg": (x, e, f),
                blk + "moe/wo": (x, f, e),
            })
        else:
            out.update({
                blk + "mlp/wi/kernel": (e, f),
                blk + "mlp/wg/kernel": (e, f),
                blk + "mlp/wo/kernel": (f, e),
            })
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


def _port_name(path):
    """Flax path -> state_dict key (``block_0/attn/q/kernel`` ->
    ``block_0.attn.q.weight``)."""
    if path.endswith("/kernel"):
        path = path[:-len("/kernel")] + "/weight"
    return path.replace("/", ".")


def _port_layout(path, t, shape):
    """A leaf of Flax shape ``shape`` in the port's layout (a transposed
    view for dense kernels)."""
    if path.endswith("/kernel"):
        t = t.reshape(-1, shape[-1]) if path.endswith("out/kernel") \
            else t.reshape(shape[0], -1)
        t = t.t()
    return t


def _leaf_to(qt, device):
    if isinstance(qt, qz.QTensor4):
        return qz.QTensor4(qt.packed.to(device), qt.scale.to(device),
                           qt.shape, qt.group_size)
    return qz.QTensor(qt.q.to(device), qt.scale.to(device))


class QuantizedWeights(object):
    """The quantized leaves of a tree, kept as codes and scales on the
    model's device for the decode steps' dequantization.

    :meth:`dequantize` returns ``{state_dict name: weight}`` in the
    port's layout, for ``torch.func.functional_call``: int8 as ``q.to(
    dtype) * scale.to(dtype)`` elementwise (which commutes with the
    transpose), int4 unpacked and group-scaled in f32 and then cast, in
    the Flax layout, then viewed transposed; equal to the bit to the
    reference's ``dequantize_tree(qparams, dtype)`` permuted into the
    port's layout.  The embedding is not among them: a step gathers only
    its ``B`` rows, and gathers them from the table the model holds
    (the same tree dequantized once: the same values).  A decode step
    therefore reads the codes and scales of :attr:`nbytes` and writes
    and reads one ``dtype`` copy of each dequantized weight (eager
    PyTorch fuses nothing)."""

    def __init__(self, leaves, device):
        self.scheme = ("int4" if any(isinstance(x, qz.QTensor4)
                                     for x in leaves.values()) else "int8")
        self._leaves = {
            _port_name(path): (path, _leaf_to(qt, device))
            for path, qt in sorted(leaves.items()) if path != "embedding"
        }

    def names(self):
        return sorted(self._leaves)

    @property
    def nbytes(self):
        """Bytes of the codes and scales a decode step reads."""
        total = 0
        for _, qt in self._leaves.values():
            for t in ((qt.packed, qt.scale) if isinstance(qt, qz.QTensor4)
                      else (qt.q, qt.scale)):
                total += t.numel() * t.element_size()
        return total

    def dequantize(self, dtype):
        return {
            name: _port_layout(path, qz.dequantize_leaf_any(qt, dtype),
                               qt.shape)
            for name, (path, qt) in self._leaves.items()
        }


def params_from_flax(tree, cfg, device=None, param_dtype=None):
    """A :class:`Transformer` over ``cfg`` holding ``tree``'s weights on
    ``device`` (default ``cuda``; raises without a GPU).  The embedding
    and dense weights are stored in ``param_dtype`` (default
    ``cfg.dtype``, the serving layout; ``torch.float32`` keeps f32
    master weights for training); norm scales and MoE routers stay
    f32.  Quantized leaves load as described in the module docstring."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        Transformer, model_device,
    )

    _check_ported(cfg)
    leaves = _flatten(tree)
    for path in leaves:
        if "/attn/qkv/" in path:
            raise _not_ported(
                "fused_qkv leaf {0!r}".format(path), "fused_qkv"
            )
    want = tree_shapes(cfg)
    missing = sorted(set(want) - set(leaves))
    extra = sorted(set(leaves) - set(want))
    if missing or extra:
        raise ValueError(
            "parameter tree does not match the config: missing {0}, "
            "extra {1}".format(missing, extra)
        )
    # shell on the meta device, then assign the loaded tensors (no
    # second copy of the weights is ever allocated)
    model = Transformer(cfg, device="meta")
    dev = model_device(cfg, device)
    state = {}
    qleaves = {}
    for path, shape in want.items():
        leaf = leaves[path]
        if qz._is_any_q(leaf):
            qleaves[path] = leaf
            # dequantized once, on the device, in cfg.dtype
            leaf = qz.dequantize_leaf_any(_leaf_to(leaf, dev),
                                          cfg.torch_dtype)
        elif not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        if tuple(leaf.shape) != shape:
            raise ValueError(
                "leaf {0!r} has shape {1}, the config needs {2}".format(
                    path, tuple(leaf.shape), shape
                )
            )
        dtype = torch.float32 if path.endswith(("/scale", "/router")) \
            else (param_dtype or cfg.torch_dtype)
        # a copy: the model never aliases the caller's arrays or tensors
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to(device=dev, dtype=dtype, copy=True)
        else:
            t = torch.tensor(leaf, dtype=dtype, device=dev)
        if path.endswith("/kernel"):
            t = t.reshape(-1, shape[-1]) if path.endswith("out/kernel") \
                else t.reshape(shape[0], -1)
            t = t.t().contiguous()
        state[_port_name(path)] = t
    model.load_state_dict(state, strict=True, assign=True)
    model.qweights = QuantizedWeights(qleaves, dev) if qleaves else None
    return model


def tree_from_model(model):
    """``model``'s parameters as a Flax-layout tree of f32 numpy arrays
    (the inverse of :func:`params_from_flax`): what the JAX model's
    ``params`` would hold, e.g. to compare trained weights or to hand
    them to ``serving_builder``."""
    state = model.state_dict()
    tree = {}
    for path, shape in tree_shapes(model.cfg).items():
        t = state[_port_name(path)].detach().to(torch.float32)
        if path.endswith("/kernel"):
            t = t.t()
        # a copy: the tree never aliases the model's storage
        leaf = np.array(t.cpu().numpy()).reshape(shape)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def init_params_tree(cfg, seed=0):
    """Random weights in the Flax layout, drawn with numpy from
    ``seed``: embedding and MoE routers ``N(0, 0.02)``, dense kernels
    ``N(0, 1/fan_in)`` and expert stacks ``N(0, 1/(E * fan_in))`` (the
    scales of the JAX model's initialisers, untruncated: its
    ``variance_scaling`` counts the expert axis in a 3-D leaf's fan-in),
    norm scales 1.  f32 leaves."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, shape in tree_shapes(cfg).items():
        if path.endswith("/scale"):
            leaf = np.ones(shape, np.float32)
        else:
            if path == "embedding" or path.endswith("/router"):
                std = 0.02
            elif path.endswith("out/kernel") or "/moe/" in path:
                std = (shape[0] * shape[1]) ** -0.5
            else:
                std = shape[0] ** -0.5
            leaf = rng.standard_normal(shape, dtype=np.float32)
            leaf *= np.float32(std)
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree
