"""Decoder-only Transformer LM (port of
the JAX package's ``models/transformer.py``).

Ported: the forward (``TransformerConfig``, ``rope``, ``RMSNorm``,
``Attention`` with the ``dot``, ``flash``, ``ring`` and ``ulysses``
paths and both decode layouts, ``MLP``, MoE blocks
(:class:`..models.moe.MoEMLP`), ``Block``, ``Transformer`` with remat),
``loss_fn``, ``init_cache``, ``sample_logits``, ``generate`` (the static
schedule), the ``SlotDecoder`` in both KV layouts with the radix prefix
cache and live weight swaps, fused QKV projections (``fused_qkv``: one
``[3*H*D, E]`` projection whose output splits as ``[.., 3, H, D]``) and
``serving_builder`` (logits serving, static generate, the continuous
schedule's slot decoders, int8/int4 weights, the int8 KV cache and the
prefix cache).  Speculative decoding, TP meshes and disaggregation raise
``NotImplementedError`` naming their ROADMAP item.

Sequence parallelism (``attention_impl="ring"`` or ``"ulysses"`` with
``cfg.mesh``, a :class:`..parallel.mesh.Mesh`): each rank runs its
slice of the sequence.  The model takes this rank's ``[B, S/P]`` slice
of the tokens (the ``seq_axis`` coordinate's), places it at positions
``index * S/P`` on, and returns the logits of that slice; attention
spans the whole sequence through the ring or the all-to-alls.
:func:`loss_fn` takes the full ``[B, S]`` rows and slices them.

Remat (``cfg.remat``) checkpoints each block in training
(``torch.utils.checkpoint``, non-reentrant): ``remat_policy="block"``
recomputes the whole block in the backward; ``"dots"`` saves the
outputs of matrix products without batch dimensions (``mm``/``addmm``:
the dense projections and the router, what JAX's
``dots_with_no_batch_dims_saveable`` keeps) and recomputes the rest,
the kernels' outputs included, as ``pallas_call`` outputs are
recomputed under that policy.  Decode never checkpoints.

Parameters and compute types: the Flax model keeps f32 parameters and
casts them to ``cfg.dtype`` at each use.  ``Transformer(cfg,
param_dtype=torch.float32)`` does the same (the training layout: f32
master weights, compute in ``cfg.dtype``); the default
``param_dtype=None`` stores the weights in ``cfg.dtype`` already (the
serving layout, no cast at use).  Norm scales are always f32 and logits
are returned in f32.

Layouts follow the reference: activations ``[B, S, H, D]`` inside
attention, weights loaded from the Flax tree by :mod:`..convert`.  Decode
KV (:func:`init_cache`, a :class:`KVCache`) is updated in place, which
replaces the reference's donated buffers: ``kv_layout="contiguous"``
keeps banks ``[B, L, Hkv, D]`` per layer and a shared write counter on
the device; ``"paged"`` keeps one page pool per layer.  Contiguous decode
attention is plain PyTorch (:func:`..ops.attention.dot_attention`, as
the reference computes it outside any Pallas kernel); paged single-token
steps run the K1 kernel.  ``cache_dtype="int8"`` stores int8 codes with
``[.., Hkv, 1]`` f32 scales per position and head in either layout.

Quantized weights (``weights="int8"|"int4"``): a model loaded from a
quantized tree holds the tree dequantized once (prefill and logits) and
its codes as ``model.qweights`` (:class:`..convert.QuantizedWeights`);
every decode step of :func:`generate` and of the ``SlotDecoder``'s chunk
dequantizes the codes again and runs the model over them
(``torch.func.functional_call``).  A decode step so reads the codes and
scales (``QuantizedWeights.nbytes``: about one byte a weight for int8,
0.56 for int4 at groups of 64) where bf16 weights take two, and writes
and reads back a ``cfg.dtype`` copy of each dequantized weight besides
(eager PyTorch fuses nothing; ``chip_smoke.py`` prints the bytes).
"""

import dataclasses
import functools
import math
import time
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from tensorflowonspark_tpu_torch import quantize as qz
from tensorflowonspark_tpu_torch.compat import resolve_device
from tensorflowonspark_tpu_torch.models import base
from tensorflowonspark_tpu_torch.models.moe import MoEMLP
from tensorflowonspark_tpu_torch.ops.attention import attention, dot_attention
from tensorflowonspark_tpu_torch.ops.flash_attention import (
    check_flash_shapes,
)
from tensorflowonspark_tpu_torch.ops.paged_attention import (
    check_tiles,
    paged_attention,
    paged_gather_attention,
)
from tensorflowonspark_tpu_torch.planner import knobs as knob_registry
from tensorflowonspark_tpu_torch.prefix_cache import PagePool, PrefixCache
from tensorflowonspark_tpu_torch.utils import not_ported as _not_ported

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, field for field (see its docstrings)."""

    vocab_size: int = 32000
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 0
    head_dim: int = 64
    embed_dim: int = 512
    mlp_dim: int = 2048
    max_seq_len: int = 2048
    dtype: str = "bfloat16"
    attention_impl: str = "dot"
    mesh: object = None
    seq_axis: str = "seq"
    remat: bool = False
    remat_policy: str = "block"
    fused_qkv: bool = False
    block_q: int = 1024
    block_k: int = 1024
    attention_window: int = 0
    cache_dtype: str = "bfloat16"
    kv_layout: str = "contiguous"
    kv_pages: int = 0
    kv_page_tokens: int = 16
    kv_slot_blocks: int = 0
    kv_span: int = 0
    paged_decode_impl: str = "kernel"
    num_experts: int = 0
    expert_k: int = 2
    capacity_factor: float = 1.25
    expert_dispatch: str = "gather"

    @property
    def torch_dtype(self):
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(
                "dtype must be one of {0}, got {1!r}".format(
                    sorted(_DTYPES), self.dtype
                )
            )


def rope(x, positions, max_wavelength=10000.0):
    """Rotary position embedding on ``[B, S, H, D]`` (D even), in f32."""
    d = x.shape[-1]
    freq = max_wavelength ** (
        -torch.arange(0, d // 2, dtype=torch.float32, device=x.device)
        / (d // 2)
    )
    angles = positions[..., None].to(torch.float32) * freq  # [B, S, D/2]
    angles = angles[:, :, None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-6, device=None):
        super().__init__()
        self.eps = eps
        # f32 like the reference's param; the product runs in f32
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device)
        )

    def forward(self, x):
        x32 = x.to(torch.float32)
        normed = x32 * torch.rsqrt(
            torch.mean(torch.square(x32), dim=-1, keepdim=True) + self.eps
        )
        return (normed * self.scale).to(x.dtype)


class _Linear(nn.Linear):
    """Bias-free dense layer whose weight (stored in ``param_dtype``) is
    cast to ``cfg.dtype`` at use, as Flax's ``Dense(dtype=...)`` casts
    its f32 kernel; a no-op cast when the two types agree."""

    def __init__(self, fan_in, fan_out, cfg, device, param_dtype):
        super().__init__(fan_in, fan_out, bias=False, device=device,
                         dtype=param_dtype or cfg.torch_dtype)
        self.compute_dtype = cfg.torch_dtype

    def forward(self, x):
        return F.linear(x, self.weight.to(self.compute_dtype))


class Attention(nn.Module):
    def __init__(self, cfg, device=None, param_dtype=None):
        super().__init__()
        h, d = cfg.num_heads, cfg.head_dim
        hkv = cfg.num_kv_heads or h
        if h % hkv != 0:
            raise ValueError(
                "num_kv_heads ({0}) must divide num_heads ({1})".format(
                    hkv, h
                )
            )
        self.cfg = cfg
        dense = dict(cfg=cfg, device=device, param_dtype=param_dtype)
        if cfg.fused_qkv:
            if hkv != h:
                raise ValueError(
                    "fused_qkv requires equal q/kv head counts; use "
                    "separate projections with num_kv_heads"
                )
            # the Flax leaf [E, 3, H, D] as one [3*H*D, E] projection
            self.qkv = _Linear(cfg.embed_dim, 3 * h * d, **dense)
        else:
            self.q = _Linear(cfg.embed_dim, h * d, **dense)
            self.k = _Linear(cfg.embed_dim, hkv * d, **dense)
            self.v = _Linear(cfg.embed_dim, hkv * d, **dense)
        self.out = _Linear(h * d, cfg.embed_dim, **dense)

    def forward(self, x, positions, decode=False, block_tables=None,
                cache=None, mask=None, per_slot=False):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        h, d = cfg.num_heads, cfg.head_dim
        hkv = cfg.num_kv_heads or h
        if cfg.fused_qkv:
            q, k, v = self.qkv(x).view(b, s, 3, h, d).unbind(2)
        else:
            q = self.q(x).view(b, s, h, d)
            k = self.k(x).view(b, s, hkv, d)
            v = self.v(x).view(b, s, hkv, d)
        q, k = rope(q, positions), rope(k, positions)
        if decode and cfg.kv_layout == "paged":
            out = self._paged_decode(q, k, v, positions, block_tables, cache)
        elif decode:
            out = self._contiguous_decode(q, k, v, positions, cache, mask,
                                          per_slot)
        else:
            out = attention(
                q, k, v, impl=cfg.attention_impl, causal=True,
                mesh=cfg.mesh, seq_axis=cfg.seq_axis, block_q=cfg.block_q,
                block_k=cfg.block_k, window=cfg.attention_window,
            )
        return self.out(out.reshape(b, s, h * d))

    def _paged_decode(self, q, k, v, positions, block_tables, cache):
        """Paged-KV decode: the layer's cache is one page pool
        ``[kv_pages, kv_page_tokens, Hkv, D]`` shared by every slot,
        addressed through ``block_tables [B, kv_slot_blocks]``.  New K/V
        scatter into the pool at ``page * T + pos % T`` IN PLACE (slots
        own their writable pages exclusively; idle lanes' tables point
        at the trash page 0).  Single-token steps run
        :func:`paged_attention` (the CUDA kernel on the GPU) when
        ``paged_decode_impl == "kernel"``; multi-token spans and the
        ``"gather"`` impl run :func:`paged_gather_attention`."""
        cfg = self.cfg
        p, t = cfg.kv_pages, cfg.kv_page_tokens
        if p < 1 or cfg.kv_slot_blocks < 1:
            raise ValueError(
                "kv_layout='paged' needs kv_pages/kv_slot_blocks set "
                "(the SlotDecoder computes them; got pages={0}, "
                "slot_blocks={1})".format(p, cfg.kv_slot_blocks)
            )
        if cache is None or block_tables is None:
            raise ValueError(
                "paged decode needs the layer's page pools (init_cache) "
                "and the slots' block tables"
            )
        b, s = k.shape[:2]
        page = torch.gather(block_tables, 1, positions // t)
        flat = (page.to(torch.int64) * t + positions % t).reshape(-1)
        # in place: the pools are the decoder's long-lived state
        for pool, val in _kv_writes(cfg, k, v, cache):
            pool.view((p * t,) + pool.shape[2:]).index_copy_(
                0, flat, val.reshape((b * s,) + val.shape[2:]).to(pool.dtype)
            )
        scales = dict(k_scale_pool=cache.get("k_scale"),
                      v_scale_pool=cache.get("v_scale"))
        if s == 1 and cfg.paged_decode_impl == "kernel":
            return paged_attention(
                q[:, 0], cache["k"], cache["v"], block_tables,
                positions[:, 0] + 1, window=cfg.attention_window, **scales
            )[:, None]
        return paged_gather_attention(
            q, cache["k"], cache["v"], block_tables, positions,
            span=cfg.kv_span or None, window=cfg.attention_window, **scales
        )

    def _contiguous_decode(self, q, k, v, positions, cache, mask,
                           per_slot):
        """Contiguous-KV decode: the layer's banks ``[B, L, Hkv, D]``
        take the new K/V (post-rope) at ``positions``, then every query
        attends over the whole bank under ``mask``, the forward's
        additive mask (:func:`_contiguous_mask`; dot attention, as the
        reference).  Shared-counter mode writes the batch at
        ``positions[0]`` (rows are identical); slot mode (``per_slot``)
        writes each row at its own positions."""
        if cache is None:
            raise ValueError(
                "contiguous decode needs the layer's banks (init_cache)"
            )
        b, s = k.shape[:2]
        length = cache["k"].shape[1]
        writes = _kv_writes(self.cfg, k, v, cache)
        if per_slot:
            rows = torch.arange(b, device=positions.device)[:, None]
            flat = (rows * length + positions).reshape(-1)
            for bank, val in writes:
                bank.view((b * length,) + bank.shape[2:]).index_copy_(
                    0, flat,
                    val.reshape((b * s,) + val.shape[2:]).to(bank.dtype),
                )
        else:
            for bank, val in writes:
                bank.index_copy_(1, positions[0], val.to(bank.dtype))
        return dot_attention(
            q, cache["k"], cache["v"], causal=False, mask=mask,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
        )


def _contiguous_mask(cfg, positions, length, pad_start, per_slot):
    """The additive f32 mask ``[B or 1, 1, S, length]`` of one
    contiguous decode forward, shared by every layer.

    Shared-counter mode masks causally from ``positions[0]``; ``pad_start
    [B]`` (ragged left-padded rows) hides each row's pad slots, keeping
    each query's own slot visible so a pad row's softmax stays finite.
    Slot mode (``per_slot``) masks each row by its own horizon, window
    and pad region, with the same self-visibility."""
    b = positions.shape[0]
    qpos = (positions if per_slot else positions[:1])[:, :, None]
    kpos = torch.arange(length, device=positions.device)[None, None, :]
    visible = kpos <= qpos
    if cfg.attention_window:
        visible = visible & (kpos > qpos - cfg.attention_window)
    if per_slot and pad_start is None:
        pad_start = torch.zeros((b,), dtype=torch.int64,
                                device=positions.device)
    if pad_start is not None:
        visible = (visible & (kpos >= pad_start[:, None, None])) \
            | (kpos == qpos)
    return torch.zeros(visible.shape, dtype=torch.float32,
                       device=visible.device).masked_fill_(
                           ~visible, float("-inf"))[:, None]


def _kv_writes(cfg, k, v, cache):
    """``(bank, value)`` pairs of one decode write: K and V, or with
    ``cache_dtype="int8"`` their int8 codes and the ``[B, S, Hkv, 1]``
    f32 scales (per position and head, over ``head_dim``)."""
    if cfg.cache_dtype != "int8":
        return [(cache["k"], k), (cache["v"], v)]
    kq = qz.quantize_leaf(k, reduce_axes=(3,))
    vq = qz.quantize_leaf(v, reduce_axes=(3,))
    return [(cache["k"], kq.q), (cache["v"], vq.q),
            (cache["k_scale"], kq.scale), (cache["v_scale"], vq.scale)]


class MLP(nn.Module):
    def __init__(self, cfg, device=None, param_dtype=None):
        super().__init__()
        dense = dict(cfg=cfg, device=device, param_dtype=param_dtype)
        self.wi = _Linear(cfg.embed_dim, cfg.mlp_dim, **dense)
        self.wg = _Linear(cfg.embed_dim, cfg.mlp_dim, **dense)
        self.wo = _Linear(cfg.mlp_dim, cfg.embed_dim, **dense)

    def forward(self, x):
        return self.wo(F.silu(self.wg(x)) * self.wi(x))


class Block(nn.Module):
    """Attention + feed-forward (``mlp``, or ``moe`` when
    ``cfg.num_experts > 0``); ``forward`` returns ``(x, aux)`` with
    ``aux`` the MoE load-balancing loss, ``None`` for a dense block."""

    def __init__(self, cfg, device=None, param_dtype=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.embed_dim, device=device)
        self.attn = Attention(cfg, device=device, param_dtype=param_dtype)
        self.ln2 = RMSNorm(cfg.embed_dim, device=device)
        if cfg.num_experts > 0:
            axes = set(getattr(cfg.mesh, "axis_names", ()) or ())
            if cfg.expert_dispatch == "dropless" and axes & {"expert",
                                                             "model"}:
                raise ValueError(
                    "expert_dispatch='dropless' does not compose with an "
                    "expert- or model-sharded mesh; use 'gather'"
                )
            self.moe = MoEMLP(
                cfg.num_experts, cfg.mlp_dim, cfg.embed_dim,
                k=cfg.expert_k, capacity_factor=cfg.capacity_factor,
                dtype=cfg.torch_dtype, dispatch=cfg.expert_dispatch,
                device=device, param_dtype=param_dtype,
            )
        else:
            self.mlp = MLP(cfg, device=device, param_dtype=param_dtype)

    def forward(self, x, positions, decode=False, block_tables=None,
                cache=None, mask=None, per_slot=False):
        x = x + self.attn(
            self.ln1(x), positions, decode=decode,
            block_tables=block_tables, cache=cache, mask=mask,
            per_slot=per_slot,
        )
        h = self.ln2(x)
        if hasattr(self, "moe"):
            ff, aux, _ = self.moe(h)
            return x + ff, aux
        return x + self.mlp(h), None


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of matrix products without batch dimensions."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _call_block(block, params, x, positions):
    # the block over the weights it was given when the step ran, so the
    # recompute in the backward sees them too (a functional_call around
    # the model has restored the module's own by then)
    return torch.func.functional_call(block, params, (x, positions))


def _checkpointed_block(block, x, positions, policy):
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(_call_block, block, dict(block.named_parameters()),
                           x, positions, use_reentrant=False, **kw)


def model_device(cfg, device):
    """The device a model over ``cfg`` is built on (``"meta"`` kept as
    is); a ``flash`` model on the GPU checks its head dim and type
    against the kernels here, once, before any weight is allocated."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    device = resolve_device(device)
    if cfg.attention_impl in ("flash", "ring", "ulysses") \
            and device.type == "cuda":
        check_flash_shapes(cfg.head_dim, cfg.torch_dtype)
    return device


def seq_shard(cfg):
    """``(size, index)`` of this rank on the model's sequence-parallel
    axis: ``(1, 0)`` unless ``cfg`` runs ring or Ulysses attention."""
    if cfg.attention_impl not in ("ring", "ulysses") or cfg.mesh is None:
        return 1, 0
    return cfg.mesh.axis_size(cfg.seq_axis), cfg.mesh.axis_index(
        cfg.seq_axis)


class Transformer(nn.Module):
    """LM forward: ``tokens [B, S] int -> logits [B, S, vocab]`` (f32).

    Submodules are named like the Flax tree (``block_0`` ...
    ``ln_f``, ``lm_head``) so :mod:`..convert` maps one to the other
    leaf by leaf.  ``device`` defaults to ``cuda`` (raises without a
    GPU); ``"meta"`` builds a shell for :meth:`with_config`.
    ``param_dtype`` is the storage type of the embedding and the dense
    weights (default ``cfg.dtype``; ``torch.float32`` for f32 master
    weights, see the module docstring).  A ``flash`` model built on the
    GPU checks its head dim and type against the kernels
    (:func:`~..ops.flash_attention.check_flash_shapes`).
    """

    def __init__(self, cfg, device=None, param_dtype=None):
        super().__init__()
        cfg.torch_dtype  # validates the dtype name
        if cfg.attention_impl in ("ring", "ulysses") and cfg.mesh is None:
            raise ValueError(
                "attention_impl={0!r} needs cfg.mesh, a parallel.mesh.Mesh "
                "with a {1!r} axis".format(cfg.attention_impl,
                                           cfg.seq_axis)
            )
        device = model_device(cfg, device)
        self.cfg = cfg
        self.embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.embed_dim, device=device,
                        dtype=param_dtype or cfg.torch_dtype)
        )
        if device.type != "meta":
            nn.init.normal_(self.embedding, std=0.02)
        for i in range(cfg.num_layers):
            self.add_module("block_%d" % i, Block(cfg, device=device,
                                                  param_dtype=param_dtype))
        self.ln_f = RMSNorm(cfg.embed_dim, device=device)
        self.lm_head = _Linear(cfg.embed_dim, cfg.vocab_size, cfg, device,
                               param_dtype)
        #: the quantized weights' codes (convert.QuantizedWeights) when the
        #: model was loaded from a quantized tree, else None
        self.qweights = None

    @property
    def blocks(self):
        return [getattr(self, "block_%d" % i)
                for i in range(self.cfg.num_layers)]

    @property
    def device(self):
        return self.embedding.device

    def with_config(self, cfg):
        """A Transformer over ``cfg`` (same parameter shapes) that
        shares this one's parameter tensors — no copy."""
        twin = Transformer(cfg, device="meta")
        twin.load_state_dict(self.state_dict(), assign=True)
        twin.qweights = self.qweights
        return twin

    def forward(self, tokens, decode=False, slot_positions=None,
                block_tables=None, cache=None, return_aux=False,
                pad_start=None):
        """``decode=True`` writes the new K/V into ``cache`` (a
        :class:`KVCache` from :func:`init_cache`, updated in place) and
        attends over it.  Without ``slot_positions`` the positions
        continue from the cache's shared counter, which advances by the
        token count (a device scalar: no host sync); ``pad_start [B]``
        masks each row's left padding (contiguous layout).  With
        ``slot_positions [B]`` (slot mode) each row starts at its own
        write pointer and the counter is left alone; ``block_tables [B,
        NB]`` address the paged layout's pools.

        ``return_aux=True`` returns ``(logits, aux_losses)``, the list of
        the MoE blocks' load-balancing losses (the reference's
        ``"losses"`` collection; empty for a dense model).

        Under sequence parallelism ``tokens`` is this rank's slice of the
        sequence (see the module docstring)."""
        cfg = self.cfg
        if not decode and (slot_positions is not None
                           or block_tables is not None
                           or cache is not None or pad_start is not None):
            raise ValueError(
                "slot_positions/block_tables/cache/pad_start are "
                "decode-path arguments"
            )
        # gathered in the storage type, then cast (the reference's
        # emb[tokens].astype(dtype))
        x = self.embedding[tokens].to(cfg.torch_dtype)
        s = tokens.shape[1]
        steps = torch.arange(s, device=tokens.device)
        if not decode:
            steps = steps + seq_shard(cfg)[1] * s
        if decode and slot_positions is None:
            if cache is None:
                raise ValueError("decode needs a cache (init_cache)")
            positions = (cache.position + steps)[None, :].expand(
                tokens.shape)
            cache.position.add_(s)
        elif decode:
            positions = slot_positions[:, None].to(torch.int64) + steps
        else:
            positions = steps[None, :].expand(tokens.shape)
        if cfg.remat and cfg.remat_policy not in ("block", "dots"):
            raise ValueError(
                "remat_policy must be 'block' or 'dots', got {0!r}".format(
                    cfg.remat_policy)
            )
        per_slot = slot_positions is not None
        mask = None
        if decode and cfg.kv_layout != "paged" and cache is not None:
            mask = _contiguous_mask(cfg, positions, cache[0]["k"].shape[1],
                                    pad_start, per_slot)
        # remat is a training trade (recompute in the backward)
        remat = cfg.remat and not decode and torch.is_grad_enabled()
        aux_losses = []
        for i, block in enumerate(self.blocks):
            if remat:
                x, aux = _checkpointed_block(block, x, positions,
                                             cfg.remat_policy)
            else:
                x, aux = block(
                    x, positions, decode=decode, block_tables=block_tables,
                    cache=None if cache is None else cache[i],
                    mask=mask, per_slot=per_slot,
                )
            if aux is not None:
                aux_losses.append(aux)
        logits = self.lm_head(self.ln_f(x)).to(torch.float32)
        return (logits, aux_losses) if return_aux else logits


def loss_fn(model):
    """Next-token cross-entropy; batch = ``dict(tokens=[B, S] int)``.

    Returns ``loss(params, batch, rng)`` (the reference's signature):
    ``params`` maps ``model``'s parameter names to tensors (its own,
    ``dict(model.named_parameters())``, or others of the same shapes),
    the log-softmax runs in f32 and the loss is the mean over
    ``B * (S - 1)`` targets.  ``rng`` is accepted and unused, as in the
    reference.

    Under sequence parallelism (P ranks on the model's ``seq_axis``) the
    batch is the full rows on every rank of a ``seq`` line; the model
    runs this rank's slice, whose targets come from the full row (the
    slice's last position predicts the next slice's first token; the
    last rank has one target fewer), and the loss is this rank's share:
    its summed cross-entropy over the global ``B * (S - 1)``.  Summed
    over the ``seq`` line (``SyncTrainer(mesh=...)`` does) it is the
    reference's mean."""

    def _loss(params, batch, rng):
        tokens = batch["tokens"].to(torch.int64)
        p, index = seq_shard(model.cfg)
        if p == 1:
            logits = torch.func.functional_call(model, params, (tokens,))
            targets = tokens[:, 1:]
            logits = logits[:, :-1].to(torch.float32)
            return F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)
            )
        b, s = tokens.shape
        if s % p:
            raise ValueError("sequence length {0} does not split over {1} "
                             "ranks".format(s, p))
        lo = index * (s // p)
        logits = torch.func.functional_call(
            model, params, (tokens[:, lo:lo + s // p],))
        targets = tokens[:, lo + 1:lo + s // p + 1]
        logits = logits[:, :targets.shape[1]].to(torch.float32)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              targets.reshape(-1), reduction="sum")
        return nll / (b * (s - 1))

    return _loss


class KVCache(list):
    """A decode cache: one dict of banks (contiguous) or pools (paged)
    per layer, ``"k"``/``"v"`` and, for ``cache_dtype="int8"``,
    ``"k_scale"``/``"v_scale"``; and ``position``, the shared write
    counter (an int64 device scalar) that shared-counter decode reads and
    advances in place."""

    def __init__(self, layers, position):
        super().__init__(layers)
        self.position = position

    def lane(self, slot):
        """Lane ``slot`` of every contiguous bank, as views (writes land
        in this cache), under a fresh counter at 0."""
        return KVCache(
            [{name: bank[slot:slot + 1] for name, bank in layer.items()}
             for layer in self],
            torch.zeros((), dtype=torch.int64, device=self.position.device),
        )


def init_cache(model, batch_size, cache_len=None):
    """A zeroed KV cache for ``batch_size`` sequences on the model's
    device (the reference's signature).

    Contiguous: banks ``[batch_size, cache_len, Hkv, D]`` per layer
    (``cache_len`` defaults to ``cfg.max_seq_len``; decode reads and
    masks the whole bank every step, so size it to the generation).
    Paged: pools ``[kv_pages, kv_page_tokens, Hkv, D]`` whose geometry
    comes from the config (the SlotDecoder sized it); ``batch_size`` and
    ``cache_len`` do not apply.  Banks are int8 with ``[..., Hkv, 1]``
    f32 scale banks when ``cfg.cache_dtype == "int8"``, else
    ``cfg.dtype``."""
    cfg = model.cfg
    hkv = cfg.num_kv_heads or cfg.num_heads
    if cfg.kv_layout == "paged":
        lead = (cfg.kv_pages, cfg.kv_page_tokens)
    else:
        length = cfg.max_seq_len if cache_len is None else int(cache_len)
        lead = (int(batch_size), length)
    int8 = cfg.cache_dtype == "int8"
    bank = torch.int8 if int8 else cfg.torch_dtype
    dev = model.device

    def layer():
        out = {name: torch.zeros(lead + (hkv, cfg.head_dim), dtype=bank,
                                 device=dev) for name in ("k", "v")}
        if int8:
            out.update({name: torch.zeros(lead + (hkv, 1),
                                          dtype=torch.float32, device=dev)
                        for name in ("k_scale", "v_scale")})
        return out

    return KVCache([layer() for _ in range(cfg.num_layers)],
                   torch.zeros((), dtype=torch.int64, device=dev))


def decode_call(model, *args, **kwargs):
    """One decode forward of ``model``: over its own weights, or, when it
    holds quantized codes (``model.qweights``), over the codes
    dequantized for this step (the reference's per-step
    ``dequantize_tree`` under its barrier)."""
    if model.qweights is None:
        return model(*args, **kwargs)
    return torch.func.functional_call(
        model, model.qweights.dequantize(model.cfg.torch_dtype), args,
        kwargs,
    )


def sample_logits(logits, generator=None, temperature=0.0, top_k=0,
                  top_p=0.0):
    """One sampling step on ``[B, V]`` logits.

    ``temperature=0`` is greedy argmax (first index on ties, as the
    reference).  Otherwise categorical after the optional ``top_k`` /
    ``top_p`` filters, drawn by Gumbel-max from ``generator`` — a
    different stream than the reference's keys, so sampled outputs
    match it only in distribution."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    neg = torch.tensor(-1e30, dtype=torch.float32, device=logits.device)
    vocab = logits.shape[-1]
    use_k = bool(top_k) and 0 < top_k < vocab
    use_p = bool(top_p) and 0.0 < top_p < 1.0
    if use_k or use_p:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    if use_k:
        kth = sorted_logits[:, top_k - 1:top_k]
        logits = torch.where(logits >= kth, logits, neg)
        rank = torch.arange(vocab, device=logits.device)[None, :]
        sorted_logits = torch.where(rank < top_k, sorted_logits, neg)
    if use_p:
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep ranks whose PRECEDING mass is < p (top rank always kept)
        keep = torch.cat(
            [torch.ones_like(cum[:, :1], dtype=torch.bool),
             cum[:, :-1] < top_p], dim=-1,
        )
        cutoff = torch.where(
            keep, sorted_logits, torch.full_like(sorted_logits, math.inf)
        ).min(dim=-1, keepdim=True).values
        logits = torch.where(logits >= cutoff, logits, neg)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


class _Clock(object):
    """Marks on the device's stream (CUDA events: nothing waits for them
    until :meth:`spans` is read after a sync) or on the host's clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def spans(self):
        """Seconds between consecutive marks (call after a sync)."""
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


@torch.no_grad()
def generate(model, params, prompt, max_new_tokens, temperature=0.0,
             generator=None, top_k=0, top_p=0.0, pad_start=None,
             eos_id=None, timing=None):
    """Autoregressive sampling with a contiguous KV cache (the
    reference's ``generate``).

    Phase 1 prefills the cache with the whole prompt in one forward;
    phase 2 runs ``max_new_tokens - 1`` single-token decode steps as an
    eager loop with no host sync inside (the cache, the counter and the
    eos flags stay on the device).

    Args:
      model: a :class:`Transformer` with ``kv_layout="contiguous"``
        (decode always runs dot attention over the cache).
      params: ``None`` (the model's weights) or a Flax-layout tree,
        float or quantized, loaded into a model over ``model.cfg``.  A
        quantized model prefills with the weights dequantized once and
        dequantizes its codes again at each decode step.
      prompt: ``[B, P]`` int tokens; ``P + max_new_tokens`` must fit
        ``cfg.max_seq_len``.
      temperature: 0 is greedy; otherwise sampling (needs
        ``generator``, a ``torch.Generator`` on the model's device),
        filtered by ``top_k``/``top_p`` (:func:`sample_logits`).
      pad_start: optional ``[B]`` pad counts of left-padded ragged rows;
        their pad slots are masked out of every attention.
      eos_id: optional stop token: once a row samples it, every later
        position emits ``eos_id`` again (rows stay ``[B,
        max_new_tokens]``).
      timing: optional list; ``(prefill_sec, decode_sec)`` is appended,
        measured on the device's stream (read after the result's copy).
    Returns ``[B, max_new_tokens]`` int32 tokens on the model's device.
    """
    if params is not None:
        from tensorflowonspark_tpu_torch import convert

        model = convert.params_from_flax(params, model.cfg,
                                         device=model.device)
    cfg = model.cfg
    if cfg.kv_layout == "paged":
        raise ValueError(
            "generate runs the contiguous KV cache; kv_layout='paged' is "
            "the SlotDecoder's layout"
        )
    dev = model.device
    prompt = torch.as_tensor(prompt).to(device=dev, dtype=torch.int64)
    b, p = prompt.shape
    if p + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            "prompt ({0}) + max_new_tokens ({1}) exceeds the cache "
            "capacity max_seq_len={2}".format(
                p, max_new_tokens, cfg.max_seq_len
            )
        )
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    if temperature > 0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    if pad_start is not None:
        pad_start = torch.as_tensor(pad_start).to(device=dev,
                                                  dtype=torch.int64)

    def sample(logits):
        return sample_logits(logits, generator, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    clock = _Clock(dev)
    clock.mark()
    # sized to the live positions: every decode step reads the whole bank
    cache = init_cache(model, b, cache_len=p + max_new_tokens)
    logits = model(prompt, decode=True, cache=cache, pad_start=pad_start)
    tok = sample(logits[:, -1])
    clock.mark()
    out = torch.empty((b, max_new_tokens), dtype=torch.int64, device=dev)
    out[:, 0] = tok
    done = tok == eos_id if eos_id is not None else None
    for i in range(1, max_new_tokens):
        logits = decode_call(model, tok[:, None], decode=True, cache=cache,
                             pad_start=pad_start)
        nxt = sample(logits[:, 0])
        if eos_id is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        out[:, i] = nxt
        tok = nxt
    clock.mark()
    out = out.to(torch.int32)
    if timing is not None:
        if clock.cuda:
            torch.cuda.current_stream(dev).synchronize()
        timing.append(tuple(clock.spans()))
    return out


class _BlockRef(object):
    """A contiguous-layout prefix-cache payload: block ``index`` of a
    donor ``segment``, the tuple of per-bank copies one commit extracted
    (:meth:`SlotDecoder._extract_segment`).  Payloads are only ever read:
    an install copies them into a lane."""

    __slots__ = ("segment", "index")

    def __init__(self, segment, index):
        self.segment = segment
        self.index = index


class SlotDecoder:
    """Slot-level KV-cache engine for continuous in-flight batching, in
    the contiguous or the paged layout (port of the reference's
    ``SlotDecoder``).

    Each batch lane is a slot: an independent request with its own
    cache region, write pointer, pad region and eos flag, so the serving
    engine can evict a finished request and admit a queued prompt into
    the freed lane between decode chunks.

    - :meth:`admit` prefills the prompt and returns the first token as a
      device scalar, without synchronising.  Contiguous: the prompt is
      left-padded to its bucket (:meth:`bucket_len`) and prefilled into
      views of the slot's lane of every bank (the reference's
      ``_lane_of``/``_merge_lane``), with ``pad_start`` masking.  Paged:
      at canonical positions (token ``i`` at position ``i``) straight
      into the slot's freshly allocated pool pages.
    - :meth:`dispatch_chunk` runs ``chunk_size`` single-token decode
      steps over every slot as an eager loop (per-row writes and masks);
      :meth:`resolve_chunk` pulls the token block to the host — the one
      host sync per chunk.

    With a ``prefix_cache`` (a :class:`..prefix_cache.PrefixCache`)
    admits are canonical on both layouts: the longest cached whole-block
    prefix of the prompt (at most ``n - 1`` tokens) is reused and only
    the suffix prefills, at positions ``kpref..``; the prompt's new full
    blocks are then committed to the cache.  Contiguous: the cached
    blocks are copied into the lane (their payloads are copies the
    commit extracted, never views of a lane, which the lane's next admit
    would overwrite).  Paged: the cached pages go into the slot's table
    row, retained by the slot, with no copy; the suffix writes only the
    slot's private pages, and the commit hands the radix one reference
    to each new full page.  Outputs are token-identical to a cold admit.

    Weight swaps (:meth:`swap_weights`, :meth:`snapshot_weights`,
    :meth:`restore_weights`, :meth:`canary_check`) install a new model
    built from the ingested tree; the previous one stays resident,
    untouched, for a rollback.

    Per-slot state (``positions``, ``pad_start``, ``last_tok``,
    ``done``) lives on the device; the host keeps the ``active`` mask
    and the paged block tables.  ``model`` is a port
    :class:`Transformer`; ``params`` is ``None`` (use the model's
    weights) or a Flax-layout tree (float or quantized) to load into it.
    With quantized weights (:attr:`_quantized`, scheme :attr:`_wq`, the
    codes :attr:`_qparams`) the prefill runs the weights dequantized
    once and every decode step of a chunk dequantizes the codes again.
    """

    def __init__(self, model, params, num_slots, max_new_tokens, *,
                 cache_len=None, chunk_size=16, pad_multiple=64,
                 temperature=0.0, top_k=0, top_p=0.0, eos_id=None,
                 seed=0, prefix_cache=None, draft_model=None,
                 draft_params=None, draft_len=4,
                 kv_layout="contiguous", kv_pages=None, page_tokens=None,
                 paged_impl="kernel", mesh=None):
        self.kv_layout = str(kv_layout)
        if self.kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                "kv_layout must be 'contiguous' or 'paged', got "
                "{0!r}".format(kv_layout)
            )
        if model.cfg.kv_layout == "paged" and self.kv_layout != "paged":
            raise ValueError(
                "model is configured kv_layout='paged' but the decoder "
                "was asked for 'contiguous'; pass kv_layout='paged'"
            )
        if draft_model is not None or draft_params is not None:
            raise _not_ported("draft-model speculation", "speculation")
        if mesh is not None:
            raise _not_ported("TP meshes", "TP")
        self._paged = self.kv_layout == "paged"
        if self._paged and paged_impl not in ("kernel", "gather"):
            raise ValueError(
                "paged_impl must be 'kernel' or 'gather', got "
                "{0!r}".format(paged_impl)
            )
        if params is not None:
            from tensorflowonspark_tpu_torch import convert

            model = convert.params_from_flax(params, model.cfg,
                                             device=model.device)
        self.device = model.device
        self.num_slots = int(num_slots)
        self.max_new_tokens = int(max_new_tokens)
        self.chunk_size = max(1, min(int(chunk_size), self.max_new_tokens))
        self.pad_multiple = max(1, int(pad_multiple))
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = None if eos_id is None else int(eos_id)
        cap = model.cfg.max_seq_len if cache_len is None else int(cache_len)
        self.cache_len = min(cap, model.cfg.max_seq_len)
        if self.cache_len <= self.max_new_tokens:
            raise ValueError(
                "cache_len ({0}) must exceed max_new_tokens ({1}) to "
                "hold any prompt at all".format(
                    self.cache_len, self.max_new_tokens
                )
            )
        self.prefix_cache = prefix_cache
        self._use_prefix = prefix_cache is not None
        if self._paged:
            self.paged_impl = str(paged_impl)
            self._setup_paged(model, kv_pages, page_tokens)
        else:
            self.model = model
            self.page_pool = None
            self.tables = None
        #: the weight scheme ("int8" | "int4" | None) and the codes the
        #: decode steps dequantize (None for float weights); a swap
        #: re-quantizes with the same scheme
        self._qparams = self.model.qweights
        self._quantized = self._qparams is not None
        self._wq = self._qparams.scheme if self._quantized else None
        #: bumped by every installed weight generation
        self.weight_generation = 0
        self.last_admit_cached_tokens = 0
        self.last_admit_dispatches = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.cache = init_cache(self.model, self.num_slots,
                                cache_len=self.cache_len)
        self.state = self._idle_state()
        self.active = np.zeros((self.num_slots,), bool)

    def _setup_paged(self, model, kv_pages, page_tokens):
        """Pick the page geometry, size the :class:`PagePool` (every slot
        holds its full table span, plus the reserved trash page 0, plus
        the radix cache's headroom), bind the radix cache to the pool,
        and rebuild the model with the pool geometry in its config (same
        parameter tensors)."""
        cfg = model.cfg
        pc = self.prefix_cache
        t = int(page_tokens) if page_tokens else (
            pc.block_tokens if pc is not None else 16)
        if pc is not None and pc.block_tokens != t:
            raise ValueError(
                "paged layout needs page_tokens == the prefix cache's "
                "block_tokens; got {0} vs {1}".format(t, pc.block_tokens)
            )
        self._page_tokens = t
        span = -(-self.cache_len // t)  # blocks per slot table
        self._blocks_per_slot = span
        hkv = cfg.num_kv_heads or cfg.num_heads
        int8_cache = cfg.cache_dtype == "int8"
        itemsize = 1 if int8_cache else torch.empty(
            (), dtype=cfg.torch_dtype).element_size()
        per_layer = 2 * t * hkv * cfg.head_dim * itemsize
        if int8_cache:
            per_layer += 2 * t * hkv * 4  # the f32 scale pages
        #: device bytes of one page across every layer's pools: what the
        #: radix cache's byte budget counts per block
        self._page_nbytes = max(1, cfg.num_layers * per_layer)
        if kv_pages:
            num_pages = int(kv_pages)
        else:
            # shared (radix-committed) pages ride in headroom capped by
            # the cache's byte budget
            extra = 0
            if pc is not None:
                budget_pages = pc.mem_budget_bytes // self._page_nbytes
                extra = int(min(budget_pages,
                                max(2 * self.num_slots * span, 64)))
            num_pages = self.num_slots * span + extra + 1
        min_pages = self.num_slots * span + 1
        if num_pages < min_pages:
            raise ValueError(
                "kv_pages={0} cannot hold {1} slots x {2} blocks (+1 "
                "reserved trash page); need >= {3}".format(
                    num_pages, self.num_slots, span, min_pages
                )
            )
        self.page_pool = PagePool(num_pages, reserved=1)
        if pc is not None:
            # page-index payloads mean something only against the pool
            # that allocated them: one pool per radix cache
            owner = getattr(pc, "_paged_pool", None)
            if owner is not None and owner is not self.page_pool:
                raise ValueError(
                    "this PrefixCache is already bound to another "
                    "decoder's page pool; paged decoders need their "
                    "own radix cache (serving_builder builds one per "
                    "slot geometry)"
                )
            if len(pc):
                raise ValueError(
                    "paged layout needs an EMPTY PrefixCache at attach "
                    "(its payloads become page indices); got {0} "
                    "node(s)".format(len(pc))
                )
            pc._paged_pool = self.page_pool
            pool = self.page_pool
            pc._release_fn = lambda page: pool.release([page])
        # per-slot block tables (host mirror, shipped with each dispatch)
        # and the pages each slot holds; all rows start at the trash page
        self.tables = np.zeros((self.num_slots, span), np.int32)
        self._slot_pages = [[] for _ in range(self.num_slots)]
        self.model = model.with_config(dataclasses.replace(
            cfg, kv_layout="paged", kv_pages=num_pages, kv_page_tokens=t,
            kv_slot_blocks=span, kv_span=self.cache_len,
            paged_decode_impl=self.paged_impl,
        ))

    def _idle_state(self):
        b, dev = self.num_slots, self.device
        return {
            "positions": torch.zeros((b,), dtype=torch.int64, device=dev),
            # idle slots mask everything but self: pad_start=cache_len
            "pad_start": torch.full((b,), self.cache_len,
                                    dtype=torch.int64, device=dev),
            "last_tok": torch.zeros((b,), dtype=torch.int64, device=dev),
            "done": torch.ones((b,), dtype=torch.bool, device=dev),
        }

    def _to_device(self, arr):
        """Host array -> device tensor without a host sync (pinned
        staging, non-blocking copy) on the GPU; a private copy on the
        CPU (the host array is mutated by later admits/evicts)."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _sample(self, logits):
        return sample_logits(
            logits, self._gen, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p,
        )

    def bucket_len(self, prompt_len):
        """Prompt-length bucket: round up to ``pad_multiple``, capped so
        the bucket + max_new_tokens still fits the cache."""
        m = self.pad_multiple
        b = ((int(prompt_len) + m - 1) // m) * m
        return max(int(prompt_len), min(b, self.cache_len
                                        - self.max_new_tokens))

    def _suffix_bucket(self, suffix_len, kpref):
        """Suffix-prefill bucket: the uncached tail rounded up to
        ``pad_multiple``, capped so the write ``[kpref, kpref + bucket)``
        stays inside the slot's span (the scratch tail past the real
        tokens is causally masked and overwritten by decode)."""
        m = self.pad_multiple
        b = ((int(suffix_len) + m - 1) // m) * m
        return max(int(suffix_len), min(b, self.cache_len - int(kpref)))

    def free_slots(self):
        return [i for i in range(self.num_slots) if not self.active[i]]

    def admit(self, slot, prompt, new_tokens=None):
        """Prefill ``prompt`` (1-D int tokens) into lane ``slot`` and
        activate it.  Returns the first generated token as a device
        scalar, unsynchronised.  Raises when the prompt and the tokens
        still to generate (``new_tokens``, default ``max_new_tokens``)
        cannot fit ``cache_len``: a request re-admitted with its
        committed tokens appended needs room only for the rest of its
        budget.  With a prefix cache the admit is canonical (see the
        class docstring); :attr:`last_admit_cached_tokens` is the prompt
        tokens it served from the cache."""
        prompt = np.asarray(prompt, np.int32).ravel()
        n = prompt.shape[0]
        if n == 0:
            raise ValueError("cannot admit an empty prompt")
        need = self.max_new_tokens if new_tokens is None else int(new_tokens)
        if n + need > self.cache_len:
            raise ValueError(
                "prompt ({0}) + max_new_tokens ({1}) exceeds the "
                "engine cache_len={2}".format(n, need, self.cache_len)
            )
        if self.active[slot]:
            raise ValueError("slot {0} is still active".format(slot))
        if self._paged:
            first = self._admit_paged(slot, prompt, n)
        elif self._use_prefix:
            first = self._admit_canonical(slot, prompt, n)
        else:
            self.last_admit_cached_tokens = 0
            self.last_admit_dispatches = 1
            b = self.bucket_len(n)
            padded = np.zeros((1, b), np.int64)
            padded[0, b - n:] = prompt
            first = self._prefill_lane(slot, padded, b - n)
        self.active[slot] = True
        return first

    @torch.no_grad()
    def _prefill_lane(self, slot, tokens, pad):
        """Contiguous prefill of the left-padded ``tokens [1, bucket]``
        into lane ``slot`` (views of every bank, a counter at 0), with
        ``pad`` pad slots masked; scatters the slot's state entries."""
        dev = self.device
        logits = self.model(
            self._to_device(tokens), decode=True,
            cache=self.cache.lane(slot),
            pad_start=torch.full((1,), pad, dtype=torch.int64, device=dev),
        )
        first = self._sample(logits[:, -1])[0]
        self._set_slot(slot, tokens.shape[1], pad, first)
        return first

    def _set_slot(self, slot, position, pad, first):
        self.state["positions"][slot] = position
        self.state["pad_start"][slot] = pad
        self.state["last_tok"][slot] = first
        if self.eos_id is not None:
            self.state["done"][slot] = first == self.eos_id
        else:
            self.state["done"][slot] = False

    def _suffix(self, prompt, n, kpref):
        sb = self._suffix_bucket(n - kpref, kpref)
        suffix = np.zeros((1, sb), np.int64)
        suffix[0, :n - kpref] = prompt[kpref:]
        return suffix

    def _alloc_pages(self, need):
        """``need`` free pages, evicting the radix cache's cold leaf
        blocks under pool pressure (an eviction releases the block's pool
        reference; the page frees once no slot's table holds it)."""
        pool, pc = self.page_pool, self.prefix_cache
        while pool.available() < need:
            if pc is None or not pc.evict_blocks(1):
                raise RuntimeError(
                    "page pool exhausted: need {0} pages, {1} free and "
                    "nothing left to evict (pool {2})".format(
                        need, pool.available(), pool.stats()
                    )
                )
        return pool.alloc(need)

    def _admit_paged(self, slot, prompt, n):
        """The paged admit: the cached prefix goes into the slot's table
        row as page indices (no KV copy), the slot retains each shared
        page before the lease is released, and the suffix prefill writes
        through the row into the slot's private pages, which commits the
        prompt's new full blocks in place.  One prefill per admit."""
        pc, pool = self.prefix_cache, self.page_pool
        blk = self._page_tokens
        if pc is not None:
            # at least one real token must prefill (first-token logits)
            lease = pc.acquire(prompt, limit_tokens=n - 1)
            kpref = lease.n_tokens
            cached_pages = [int(p) for p in lease.payloads()]
        else:
            lease, kpref, cached_pages = None, 0, []
        self.last_admit_cached_tokens = int(kpref)
        self.last_admit_dispatches = 1
        # the slot's own reference to every shared page: the radix may
        # evict the block while this slot still decodes on it
        pool.retain(cached_pages)
        if lease is not None:
            pc.release(lease)
        private = self._alloc_pages(self._blocks_per_slot
                                    - len(cached_pages))
        row = cached_pages + private
        self.tables[slot] = np.asarray(row, np.int32)
        self._slot_pages[slot] = row
        first = self._prefill_canonical(slot, self._suffix(prompt, n, kpref),
                                        n, kpref)
        # commit the prompt's new full blocks: their pages hold the KV
        # already, and the radix takes one pool reference per block it
        # accepts (a budget drop keeps the page slot-private)
        if pc is not None:
            total_blocks = n // blk
            first_new = len(cached_pages)
            if total_blocks > first_new:
                committed = []
                pc.insert(prompt, row[first_new:total_blocks], first_new,
                          self._page_nbytes, on_insert=committed.append)
                pool.retain(committed)
        return first

    @torch.no_grad()
    def _prefill_canonical(self, slot, suffix, n, kpref):
        """Canonical-position prefill of ``suffix`` from position
        ``kpref``: through the slot's table row (paged), or into views of
        its lane with nothing masked below ``kpref`` (contiguous).
        Samples the first token from the last real row ``n - kpref - 1``
        and scatters the slot's state entries."""
        dev = self.device
        start = torch.full((1,), kpref, dtype=torch.int64, device=dev)
        if self._paged:
            kw = dict(block_tables=self._to_device(self.tables[slot:slot + 1]),
                      cache=self.cache)
        else:
            kw = dict(cache=self.cache.lane(slot),
                      pad_start=torch.zeros((1,), dtype=torch.int64,
                                            device=dev))
        logits = self.model(self._to_device(suffix), decode=True,
                            slot_positions=start, **kw)
        first = self._sample(logits[:, n - kpref - 1])[0]
        self._set_slot(slot, n, 0, first)
        return first

    def _banks(self):
        """Every contiguous bank in a fixed order (layer, then name)."""
        return [layer[name] for layer in self.cache for name in sorted(layer)]

    def _extract_segment(self, slot, start, length):
        """Copies of ``[start, start + length)`` of lane ``slot`` of every
        bank: the KV a prefill commits to the prefix cache.  Copies,
        because the lane is overwritten by the slot's next admit."""
        return tuple(bank[slot, start:start + length].clone()
                     for bank in self._banks())

    def _install_segment(self, slot, payloads, blk):
        """Copy the cached blocks ``payloads`` into lane ``slot`` at
        positions ``[0, len * blk)``, one copy per run of consecutive
        blocks of one donor; the payloads are only read."""
        runs = []
        for p in payloads:
            if (runs and p.segment is runs[-1][-1].segment
                    and p.index == runs[-1][-1].index + 1):
                runs[-1].append(p)
            else:
                runs.append([p])
        banks = self._banks()
        at = 0
        for run in runs:
            lo, hi = run[0].index * blk, (run[-1].index + 1) * blk
            for bank, leaf in zip(banks, run[0].segment):
                bank[slot, at:at + hi - lo].copy_(leaf[lo:hi])
            at += hi - lo

    def _admit_canonical(self, slot, prompt, n):
        """The contiguous layout's cached-prefix admit: install the
        cached blocks into the lane, prefill the suffix at ``kpref``,
        commit the prompt's new full blocks (one extract of copies)."""
        pc = self.prefix_cache
        blk = pc.block_tokens
        # at least one real token must prefill (first-token logits)
        lease = pc.acquire(prompt, limit_tokens=n - 1)
        kpref = lease.n_tokens
        self.last_admit_cached_tokens = int(kpref)
        self.last_admit_dispatches = 1
        if kpref:
            self._install_segment(slot, lease.payloads(), blk)
            self.last_admit_dispatches += 1
        pc.release(lease)
        first = self._prefill_canonical(slot, self._suffix(prompt, n, kpref),
                                        n, kpref)
        total_blocks = n // blk
        first_new = kpref // blk
        if total_blocks > first_new:
            n_new = total_blocks - first_new
            seg = self._extract_segment(slot, first_new * blk, n_new * blk)
            self.last_admit_dispatches += 1
            nbytes = sum(leaf.numel() * leaf.element_size()
                         for leaf in seg) // n_new
            pc.insert(prompt, [_BlockRef(seg, i) for i in range(n_new)],
                      first_new, nbytes)
        return first

    @torch.no_grad()
    def dispatch_chunk(self):
        """Enqueue ``chunk_size`` single-token decode steps over every
        slot without synchronising; returns the ``[B, chunk]`` token
        block as an unresolved device tensor.  Done rows keep emitting
        ``eos_id``; active rows advance their pointer (clamped so a
        completed-but-not-evicted row stays inside the cache), idle
        rows hold still.  Quantized weights are dequantized at every
        step (:func:`decode_call`)."""
        tables = self._to_device(self.tables) if self._paged else None
        active = self._to_device(self.active)
        pos = self.state["positions"]
        pad = self.state["pad_start"]
        tok = self.state["last_tok"]
        done = self.state["done"]
        toks = torch.empty((self.num_slots, self.chunk_size),
                           dtype=torch.int64, device=self.device)
        for i in range(self.chunk_size):
            logits = decode_call(
                self.model, tok[:, None], decode=True, slot_positions=pos,
                block_tables=tables, cache=self.cache, pad_start=pad,
            )
            nxt = self._sample(logits[:, 0])
            if self.eos_id is not None:
                nxt = torch.where(done, self.eos_id, nxt)
                done = done | (nxt == self.eos_id)
            pos = torch.where(
                active, torch.clamp(pos + 1, max=self.cache_len - 1), pos
            )
            toks[:, i] = nxt
            tok = nxt
        self.state = dict(self.state, positions=pos, last_tok=tok, done=done)
        return toks

    def resolve_chunk(self, pending):
        """Pull a :meth:`dispatch_chunk` block to host int32 as
        ``(tokens [B, T], valid [B])`` — the one synchronising call per
        chunk, and so the call a wedged dispatch hangs.  Idle lanes hold
        garbage."""
        toks = pending.cpu().numpy().astype(np.int32)
        return toks, np.full((toks.shape[0],), toks.shape[1], np.int32)

    def step_chunk(self):
        return self.resolve_chunk(self.dispatch_chunk())

    def evict(self, slot):
        """Free lane ``slot`` between chunks — host bookkeeping only.  A
        contiguous lane's stale KV needs no scrubbing (a later request's
        masks only reach positions its own prefill and decode wrote);
        a paged slot's page references release (shared pages the radix
        still holds stay) and its table row parks on the trash page so
        the lane's dead decode writes never land in a live page."""
        self.active[slot] = False
        if self._paged and self._slot_pages[slot]:
            self.page_pool.release(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self.tables[slot, :] = 0

    def cancel(self, slot):
        """Cancel an in-flight lane between chunks (deadline expiry, a
        drain): the same as :meth:`evict`; its neighbours are
        untouched."""
        self.evict(slot)

    def reset(self):
        """Return every slot to idle (between serving jobs); the banks and
        pools stay allocated, their stale KV is unreachable, and the
        radix cache's committed pages stay."""
        if self._paged:
            for slot in range(self.num_slots):
                if self._slot_pages[slot]:
                    self.page_pool.release(self._slot_pages[slot])
                    self._slot_pages[slot] = []
            self.tables[:, :] = 0
        self.state = self._idle_state()
        self.active[:] = False

    # -- live weight swap (hot_swap.py) --------------------------------

    def param_spec(self):
        """Per-leaf ``{path: {"shape", "dtype"}}`` census (the
        reference's key strings) of what a checkpoint must hold to swap
        into this decoder: the Flax layout at the model's float shapes
        and storage types (a quantized decoder censuses its dequantized
        weights).  Validation compares dtype kinds only."""
        from tensorflowonspark_tpu_torch import checkpoint, convert

        state = self.model.state_dict()
        tree = {}
        for path, shape in convert.tree_shapes(self.model.cfg).items():
            node = tree
            *parents, name = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = torch.empty(
                shape, dtype=state[convert._port_name(path)].dtype,
                device="meta")
        return checkpoint.param_manifest(tree)

    def _check_swap_tree(self, raw_params):
        """Raise ``ValueError`` naming the first structural or shape
        difference of ``raw_params`` from the live weights."""
        from tensorflowonspark_tpu_torch.checkpoint import param_manifest

        live = self.param_spec()
        new = param_manifest(raw_params)
        missing = sorted(set(live) - set(new))
        extra = sorted(set(new) - set(live))
        if missing or extra:
            raise ValueError(
                "swap params tree mismatch: missing leaves {0}, "
                "unexpected leaves {1}".format(missing[:4], extra[:4])
            )
        for path in sorted(live):
            if new[path]["shape"] != live[path]["shape"]:
                raise ValueError(
                    "swap params shape mismatch at {0}: live {1} vs "
                    "ingested {2}".format(
                        path, live[path]["shape"], new[path]["shape"]
                    )
                )

    def _ingest_params(self, raw_params):
        """A new model over the live config holding ``raw_params`` (a raw
        float tree): cast to the live types, or re-quantized with the
        live scheme for a quantized decoder (int4 at the default groups,
        as the reference).  New tensors: the live model is never
        written."""
        from tensorflowonspark_tpu_torch import convert

        tree = raw_params
        if self._quantized:
            tree = _tree_to(raw_params, self.device)
            tree = (qz.quantize_tree_int4(tree) if self._wq == "int4"
                    else qz.quantize_tree(tree))
        model = convert.params_from_flax(tree, self.model.cfg,
                                         device=self.device)
        model.requires_grad_(False)
        return model

    def snapshot_weights(self):
        """Opaque handle to the current weight generation: the live
        model object, whose tensors a swap never writes.  Hand it back
        to :meth:`restore_weights` to roll back without re-ingesting."""
        return (self.model, self.weight_generation)

    def swap_weights(self, raw_params, draft_params=None, ready=None):
        """Install a new weight generation between decode chunks.

        ``raw_params`` is a raw float tree matching :meth:`param_spec`
        (numpy arrays or tensors on any device); ``ready``, when given,
        is waited on before it is read (the CUDA event a background
        ingest recorded after its copy onto the card).  The slot table
        is not touched: the engine quiesces in-flight requests first.
        The prefix cache is flushed (its KV came from the old
        weights)."""
        if draft_params is not None:
            raise _not_ported("draft weights in a swap", "speculation")
        self._check_swap_tree(raw_params)
        if ready is not None:
            ready.wait()
        self._install(self._ingest_params(raw_params))
        self.weight_generation += 1
        return self.weight_generation

    def _install(self, model):
        self.model = model
        self._qparams = model.qweights
        if self._use_prefix:
            self.prefix_cache.clear()

    def restore_weights(self, snapshot):
        """Roll back to a :meth:`snapshot_weights` generation (no
        re-ingest); flushes the prefix cache like a forward swap."""
        model, gen = snapshot
        self._install(model)
        self.weight_generation = int(gen)
        return self.weight_generation

    @torch.no_grad()
    def canary_check(self, raw_params=None):
        """One forward of a fixed 8-token prompt through the live model,
        or through ``raw_params`` ingested as a swap would ingest them;
        True when every logit is finite."""
        model = self.model
        if raw_params is not None:
            self._check_swap_tree(raw_params)
            model = self._ingest_params(raw_params)
        tokens = (torch.arange(8, device=self.device)[None]
                  % model.cfg.vocab_size)
        return bool(torch.isfinite(model(tokens)).all())

    def reuse_stats(self):
        """Cross-request reuse counters: the prefix cache's cumulative
        stats (when attached) and the page pool's occupancy gauges
        (paged layout).  The engine reports per-job deltas."""
        out = {}
        if self._use_prefix:
            out.update(self.prefix_cache.stats())
        if self._paged:
            out.update(self.page_pool.stats())
        return out


#: serving_builder keys that select a plane this package has not ported
#: yet, with the ROADMAP item that brings it; a truthy value raises
_UNPORTED_KNOBS = {
    "auto": "the cost-model planner (engine planes)",
    "speculative": "speculation",
    "ngram": "speculation",
    "draft_config": "speculation",
    "draft_params": "speculation",
    "draft_len": "speculation",
    "tp": "TP",
    "mesh_shape": "TP",
    "disaggregate": "disaggregation",
    "profile_dir": "the engine's telemetry plane",
    "profile_steps": "the engine's telemetry plane",
}


def _check_unported(config):
    for key, item in _UNPORTED_KNOBS.items():
        val = config.get(key)
        if val:
            raise _not_ported(
                "serving_builder config {0}={1!r}".format(key, val), item
            )


def _unwrap_params(params):
    """Unwrap a ``{"params": tree}`` variables dict; reject exports that
    carry draft weights."""
    if isinstance(params, Mapping) and "params" in params:
        if "draft" in params:
            raise _not_ported("draft weights in the export", "speculation")
        params = params["params"]
    if isinstance(params, Mapping) and "draft" in params:
        raise _not_ported("draft weights in the export", "speculation")
    return params


def _tree_to(tree, device):
    """Every float leaf of ``tree`` as a tensor on ``device`` (where the
    quantizer then runs); quantized leaves as they are."""
    if isinstance(tree, Mapping):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree if qz._is_any_q(tree) else qz.as_tensor(tree, device)


def _quantized_tree(tree, config, cfg, device):
    """The ``weights``/``quantize`` knob (``int4_group`` sizes the int4
    groups): the tree quantized on ``device``, or as it was."""
    weights = config.get("weights") or config.get("quantize")
    if weights in ("int8", "int4"):
        tree = _tree_to(tree, device)
        if weights == "int8":
            return qz.quantize_tree(tree)
        return qz.quantize_tree_int4(
            tree, group_size=int(config.get("int4_group", 64)))
    if weights not in (None, "float", "none"):
        raise ValueError(
            "weights/quantize must be 'int8', 'int4', 'float' or "
            "unset; got {0!r}".format(weights)
        )
    return tree


def serving_builder(params, config):
    """Predictor over a Flax-layout parameter tree (port of the
    reference's ``serving_builder``).

    ``config`` takes the reference's keys (TransformerConfig fields and
    the serving knobs) plus ``device`` (default ``cuda``).  Unknown keys
    raise :class:`~..planner.knobs.UnknownKnobError`; knobs of planes
    not ported yet raise ``NotImplementedError``.  Attention is coerced
    to ``dot`` (the decode paths read their caches).

    - Without ``mode``: logits serving.  ``predict({"tokens": [B, S]})``
      returns ``{"logits": f32 [B, S, V], "next_token": [B]}`` (through
      :func:`..models.base.make_serving_predict`); quantized weights are
      dequantized once.
    - ``mode="generate"``: calling ``predict`` is the static schedule
      (:func:`generate` over a left-padded batch with its ``<input>_pad``
      counts; ``{"generated"}``, plus ``"generated_len"`` under
      ``eos_id``), on the contiguous cache even when ``kv_layout`` is
      ``"paged"`` (the pools are the slot decoders' layout); the last
      call's ``(prefill_sec, decode_sec)`` is ``predict.last_timing``.  ``predict.make_slot_decoder`` builds
      the continuous schedule's :class:`SlotDecoder` in ``kv_layout``,
      its cache sized from ``max_prompt_len``.
    - ``weights``/``quantize`` ``"int8"|"int4"`` (``int4_group``)
      quantize the tree on the device (:mod:`..quantize`); decode steps
      dequantize the codes at each step.  ``cache_dtype="int8"`` stores
      the KV cache as int8 with scales, in either layout.
    - ``prefix_cache=True`` gives the slot decoders a radix prefix cache
      (:class:`..prefix_cache.PrefixCache`, ``prefix_block`` tokens a
      block, ``prefix_mem_mb`` its budget, which on the paged layout
      also sizes the pool's headroom): one cache shared by every
      contiguous decoder of the predictor, one per slot geometry on the
      paged layout (page indices mean something only in their pool).
      The memoized decoders keep it warm across jobs.
    """
    cfg_fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    knob_registry.validate_keys(config, cfg_fields | {"device"})
    _check_unported(config)
    device = resolve_device(config.get("device"))
    overrides = dict(config, attention_impl="dot", mesh=None)
    cfg = TransformerConfig(
        **{k: v for k, v in overrides.items() if k in cfg_fields}
    )
    from tensorflowonspark_tpu_torch import convert

    variables = base.as_variables(_unwrap_params(params))
    tree = _quantized_tree(variables["params"], config, cfg, device)
    if config.get("mode") != "generate":
        # batch logits are compute-bound: dequantize once, up front
        return _logits_predictor(
            qz.dequantize_tree(tree, cfg.torch_dtype, barrier=False), cfg,
            device, config.get("input_name", "tokens"))
    model = convert.params_from_flax(tree, cfg, device=device)
    model.requires_grad_(False)

    max_new = int(config["max_new_tokens"])
    temperature = float(config.get("temperature", 0.0))
    top_k = int(config.get("top_k", 0))
    top_p = float(config.get("top_p", 0.0))
    seed = int(config.get("seed", 0))
    pad_id = int(config.get("pad_id", 0))
    eos_id = config.get("eos_id")
    eos_id = None if eos_id is None else int(eos_id)
    input_name = config.get("input_name", "tokens")
    kv_layout = str(config.get("kv_layout", "contiguous"))
    chunk_size = int(config.get("chunk_size", 16))
    max_prompt = config.get("max_prompt_len")
    paged_impl = str(config.get("paged_impl") or "kernel")
    page_tokens = config.get("kv_page_tokens", config.get("prefix_block"))
    if kv_layout == "paged":
        enforce = config.get("check_tiles")
        if enforce is None:
            # the kernel only runs on the GPU; the CPU path takes any
            # geometry
            enforce = paged_impl == "kernel" and device.type == "cuda"
        if enforce:
            check_tiles(
                int(page_tokens or 16), cfg.head_dim,
                torch.int8 if cfg.cache_dtype == "int8" else cfg.torch_dtype,
                group=cfg.num_heads // (cfg.num_kv_heads or cfg.num_heads),
            )
    # the static schedule runs the contiguous cache in every layout
    static_model = model if cfg.kv_layout != "paged" else model.with_config(
        dataclasses.replace(cfg, kv_layout="contiguous"))

    def predict(batch):
        tokens = np.asarray(batch[input_name])
        pads = batch.get(input_name + "_pad")
        if pads is None:
            pads = np.zeros((tokens.shape[0],), np.int64)
        gen, timing = None, []
        if temperature > 0:
            # the reference samples every call from the same key
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
        out = generate(
            static_model, None, torch.from_numpy(tokens.astype(np.int64)),
            max_new, temperature=temperature, generator=gen, top_k=top_k,
            top_p=top_p, pad_start=torch.from_numpy(
                np.asarray(pads, np.int64)),
            eos_id=eos_id, timing=timing,
        ).cpu().numpy()
        predict.last_timing = timing[0]
        res = {"generated": out}
        if eos_id is not None:
            hit = out == eos_id
            res["generated_len"] = np.where(
                hit.any(axis=1), hit.argmax(axis=1), out.shape[1]
            ).astype(np.int32)
        return res

    predict.last_timing = None
    predict.column_padding = {input_name: pad_id}
    predict.pad_multiple = int(config.get("pad_multiple", 64))
    # bucketing must never push a fitting prompt past the cache
    predict.pad_cap = max(1, cfg.max_seq_len - max_new)
    slot_decoders = {}
    prefix_caches = {}

    def _prefix_cache(key):
        if not config.get("prefix_cache", False):
            return None
        key = key if kv_layout == "paged" else None
        if key not in prefix_caches:
            prefix_caches[key] = PrefixCache(
                block_tokens=int(config.get("prefix_block", 16)),
                mem_budget_bytes=int(float(config.get("prefix_mem_mb",
                                                      256.0)) * (1 << 20)),
            )
        return prefix_caches[key]

    def make_slot_decoder(num_slots, chunk=None):
        # memoized per (slots, chunk); a reused decoder only resets its
        # host-side slot table and keeps its banks or pools
        key = (int(num_slots),
               int(chunk) if chunk is not None else chunk_size)
        dec = slot_decoders.get(key)
        if dec is not None:
            dec.reset()
            return dec
        cache_len = cfg.max_seq_len
        if max_prompt is not None:
            m = predict.pad_multiple
            b = ((int(max_prompt) + m - 1) // m) * m
            cache_len = min(cfg.max_seq_len, b + max_new)
        dec = SlotDecoder(
            model, None, key[0], max_new, cache_len=cache_len,
            chunk_size=key[1], pad_multiple=predict.pad_multiple,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_id=eos_id, seed=seed, prefix_cache=_prefix_cache(key),
            kv_layout=kv_layout, kv_pages=config.get("kv_pages"),
            page_tokens=page_tokens, paged_impl=paged_impl,
        )
        slot_decoders[key] = dec
        return dec

    predict.make_slot_decoder = make_slot_decoder
    predict.max_new_tokens = max_new
    predict.eos_id = eos_id
    return predict


def _logits_predictor(tree, cfg, device, input_name):
    from tensorflowonspark_tpu_torch import convert

    model = convert.params_from_flax(tree, cfg, device=device)
    model.requires_grad_(False)

    def outputs(logits):
        return {
            "logits": logits.to(torch.float32).cpu().numpy(),
            "next_token": torch.argmax(logits[:, -1], dim=-1).to(
                torch.int32).cpu().numpy(),
        }

    return base.make_serving_predict(model, input_name, outputs)
