"""The weight carrier: Flax-layout parameter trees into the port's
:class:`~tensorflowonspark_tpu_torch.models.transformer.Transformer`.

A tree is nested dicts of numpy arrays (``jax.tree.map(np.asarray,
variables["params"])`` of the JAX model, or :func:`init_params_tree`),
named as the JAX model's ``LOGICAL_AXES_RULES`` name them:

=============================  ============  =============================
Flax leaf                      shape         port
=============================  ============  =============================
``embedding``                  ``[V, E]``    as is
``block_i/attn/{q,k,v}/kernel`` ``[E, H, D]`` ``[E, H*D]``, transposed
``block_i/attn/out/kernel``    ``[H, D, E]`` ``[H*D, E]``, transposed
``block_i/mlp/{wi,wg}/kernel`` ``[E, F]``    transposed
``block_i/mlp/wo/kernel``      ``[F, E]``    transposed
``*/ln1|ln2|ln_f/scale``       ``[E]``       as is (f32)
``lm_head/kernel``             ``[E, V]``    transposed
=============================  ============  =============================

(``H`` is ``num_kv_heads`` for ``k``/``v``.)  Transposes land in
``nn.Linear``'s ``[out, in]`` layout.  Any missing, extra or misshapen
leaf raises ``ValueError``; fused-QKV and MoE leaves raise
``NotImplementedError``.  :func:`tree_from_model` is the inverse: a
model's weights as a tree of f32 numpy arrays in the Flax layout.
"""

from collections.abc import Mapping

import numpy as np
import torch


def _not_ported(what, item):
    return NotImplementedError(
        "{0} is not ported to the PyTorch package yet (ROADMAP queue A: "
        "{1})".format(what, item)
    )


def _check_ported(cfg):
    if cfg.fused_qkv:
        raise _not_ported("fused_qkv projections", "fused_qkv")
    if cfg.num_experts > 0:
        raise _not_ported("MoE (num_experts > 0)", "MoE with K5-K7")


def tree_shapes(cfg):
    """``{tree path: shape}`` of every leaf the dense model has."""
    _check_ported(cfg)
    e, f, v = cfg.embed_dim, cfg.mlp_dim, cfg.vocab_size
    h, d = cfg.num_heads, cfg.head_dim
    hkv = cfg.num_kv_heads or h
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


def params_from_flax(tree, cfg, device=None, param_dtype=None):
    """A :class:`Transformer` over ``cfg`` holding ``tree``'s weights on
    ``device`` (default ``cuda``; raises without a GPU).  The embedding
    and dense weights are stored in ``param_dtype`` (default
    ``cfg.dtype``, the serving layout; ``torch.float32`` keeps f32
    master weights for training); norm scales stay f32."""
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
        if "/moe/" in path:
            raise _not_ported(
                "MoE leaf {0!r}".format(path), "MoE with K5-K7"
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
    for path, shape in want.items():
        arr = np.asarray(leaves[path])
        if tuple(arr.shape) != shape:
            raise ValueError(
                "leaf {0!r} has shape {1}, the config needs {2}".format(
                    path, tuple(arr.shape), shape
                )
            )
        dtype = torch.float32 if path.endswith("/scale") else \
            (param_dtype or cfg.torch_dtype)
        # a copy: the model never aliases the caller's arrays
        t = torch.tensor(arr, dtype=dtype, device=dev)
        if path.endswith("/kernel"):
            t = t.reshape(-1, shape[-1]) if path.endswith("out/kernel") \
                else t.reshape(shape[0], -1)
            t = t.t().contiguous()
        state[_port_name(path)] = t
    model.load_state_dict(state, strict=True, assign=True)
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
    ``seed``: embedding ``N(0, 0.02)`` and dense kernels
    ``N(0, 1/fan_in)`` (the scales of the JAX model's initialisers,
    untruncated), norm scales 1.  f32 leaves."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, shape in tree_shapes(cfg).items():
        if path.endswith("/scale"):
            leaf = np.ones(shape, np.float32)
        else:
            if path == "embedding":
                std = 0.02
            elif path.endswith("out/kernel"):
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
