"""Decoder-only Transformer LM (port of
the JAX package's ``models/transformer.py``).

Ported so far: the forward (``TransformerConfig``, ``rope``,
``RMSNorm``, ``Attention`` with the ``dot`` and ``flash`` paths and the
paged decode path, ``MLP``, MoE blocks (:class:`..models.moe.MoEMLP`),
``Block``, ``Transformer`` with remat), ``loss_fn``, ``sample_logits``,
the paged-layout ``SlotDecoder`` and ``serving_builder`` for
``mode="generate"`` with ``kv_layout="paged"``.  Contiguous-cache
decode, static ``generate``, speculative decoding, fused QKV, weight
quantization, the prefix cache, TP meshes and disaggregation raise
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
attention, weights loaded from the Flax tree by :mod:`..convert`.
Decode KV lives in one page pool per layer, updated in place (this
replaces the reference's donated buffers).
"""

import dataclasses
import functools
import math
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from tensorflowonspark_tpu_torch.compat import resolve_device
from tensorflowonspark_tpu_torch.models.moe import MoEMLP
from tensorflowonspark_tpu_torch.ops.attention import attention
from tensorflowonspark_tpu_torch.ops.flash_attention import (
    check_flash_shapes,
)
from tensorflowonspark_tpu_torch.ops.paged_attention import (
    check_tiles,
    paged_attention,
    paged_gather_attention,
)
from tensorflowonspark_tpu_torch.planner import knobs as knob_registry
from tensorflowonspark_tpu_torch.prefix_cache import PagePool
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
        if cfg.fused_qkv:
            raise _not_ported("fused_qkv", "fused_qkv")
        self.cfg = cfg
        dense = dict(cfg=cfg, device=device, param_dtype=param_dtype)
        self.q = _Linear(cfg.embed_dim, h * d, **dense)
        self.k = _Linear(cfg.embed_dim, hkv * d, **dense)
        self.v = _Linear(cfg.embed_dim, hkv * d, **dense)
        self.out = _Linear(h * d, cfg.embed_dim, **dense)

    def forward(self, x, positions, decode=False, block_tables=None,
                cache=None):
        cfg = self.cfg
        b, s = x.shape[0], x.shape[1]
        h, d = cfg.num_heads, cfg.head_dim
        hkv = cfg.num_kv_heads or h
        q = rope(self.q(x).view(b, s, h, d), positions)
        k = rope(self.k(x).view(b, s, hkv, d), positions)
        v = self.v(x).view(b, s, hkv, d)
        if decode:
            if cfg.kv_layout != "paged":
                raise _not_ported(
                    "contiguous-cache decode", "contiguous KV and static "
                    "generate"
                )
            out = self._paged_decode(q, k, v, positions, block_tables, cache)
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
        b, s, hkv, d = k.shape
        k_pool, v_pool = cache["k"], cache["v"]
        page = torch.gather(block_tables, 1, positions // t)
        flat = (page.to(torch.int64) * t + positions % t).reshape(-1)
        # in place: the pools are the decoder's long-lived state
        k_pool.view(p * t, hkv, d).index_copy_(
            0, flat, k.reshape(b * s, hkv, d).to(k_pool.dtype)
        )
        v_pool.view(p * t, hkv, d).index_copy_(
            0, flat, v.reshape(b * s, hkv, d).to(v_pool.dtype)
        )
        if s == 1 and cfg.paged_decode_impl == "kernel":
            return paged_attention(
                q[:, 0], k_pool, v_pool, block_tables, positions[:, 0] + 1,
                window=cfg.attention_window,
            )[:, None]
        return paged_gather_attention(
            q, k_pool, v_pool, block_tables, positions,
            span=cfg.kv_span or None, window=cfg.attention_window,
        )


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
                cache=None):
        x = x + self.attn(
            self.ln1(x), positions, decode=decode,
            block_tables=block_tables, cache=cache,
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
        if cfg.cache_dtype == "int8":
            raise _not_ported(
                "the int8 KV cache write path", "int8/int4 weights, int8 "
                "KV cache and quantize"
            )
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
        return twin

    def forward(self, tokens, decode=False, slot_positions=None,
                block_tables=None, cache=None, return_aux=False):
        """``decode=True`` is slot mode: ``slot_positions [B]`` are the
        per-slot write pointers, ``block_tables [B, NB]`` address the
        per-layer page pools in ``cache`` (a list of ``{"k", "v"}``
        dicts, :func:`init_cache`), which are updated in place.

        ``return_aux=True`` returns ``(logits, aux_losses)``, the list of
        the MoE blocks' load-balancing losses (the reference's
        ``"losses"`` collection; empty for a dense model).

        Under sequence parallelism ``tokens`` is this rank's slice of the
        sequence (see the module docstring)."""
        cfg = self.cfg
        if not decode and (slot_positions is not None
                           or block_tables is not None
                           or cache is not None):
            raise ValueError(
                "slot_positions/block_tables/cache are decode-path "
                "arguments"
            )
        # gathered in the storage type, then cast (the reference's
        # emb[tokens].astype(dtype))
        x = self.embedding[tokens].to(cfg.torch_dtype)
        s = tokens.shape[1]
        steps = torch.arange(s, device=tokens.device)
        if not decode:
            steps = steps + seq_shard(cfg)[1] * s
        if decode:
            if slot_positions is None:
                raise _not_ported(
                    "shared-counter decode (generate)", "contiguous KV "
                    "and static generate"
                )
            positions = slot_positions[:, None].to(torch.int64) + steps
        else:
            positions = steps[None, :].expand(tokens.shape)
        if cfg.remat and cfg.remat_policy not in ("block", "dots"):
            raise ValueError(
                "remat_policy must be 'block' or 'dots', got {0!r}".format(
                    cfg.remat_policy)
            )
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


def init_cache(model):
    """Zeroed paged KV pools, one ``{"k", "v"}`` pair per layer, of
    shape ``[kv_pages, kv_page_tokens, Hkv, D]`` on the model's device.
    The geometry comes from the config (the SlotDecoder sized it)."""
    cfg = model.cfg
    if cfg.kv_layout != "paged":
        raise _not_ported(
            "contiguous KV caches", "contiguous KV and static generate"
        )
    hkv = cfg.num_kv_heads or cfg.num_heads
    shape = (cfg.kv_pages, cfg.kv_page_tokens, hkv, cfg.head_dim)
    return [
        {name: torch.zeros(shape, dtype=cfg.torch_dtype, device=model.device)
         for name in ("k", "v")}
        for _ in range(cfg.num_layers)
    ]


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


class SlotDecoder:
    """Slot-level KV-cache engine for continuous in-flight batching,
    paged layout only (port of the reference's ``SlotDecoder``).

    Each batch lane is a slot: an independent request with its own
    block-table row, write pointer and eos flag, so the serving engine
    can evict a finished request and admit a queued prompt into the
    freed lane between decode chunks.

    - :meth:`admit` prefills the prompt at canonical positions (token
      ``i`` at cache position ``i``) straight into the slot's freshly
      allocated pool pages and returns the first token as a device
      scalar, without synchronising.
    - :meth:`dispatch_chunk` runs ``chunk_size`` single-token decode
      steps over every slot as an eager loop; :meth:`resolve_chunk`
      pulls the token block to the host — the one host sync per chunk.

    Per-slot state (``positions``, ``last_tok``, ``done``) lives on the
    device; the host keeps the ``active`` mask and the block tables.
    ``model`` is a port :class:`Transformer`; ``params`` is ``None``
    (use the model's weights) or a Flax-layout tree to load into it.
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
        if self.kv_layout != "paged":
            raise _not_ported(
                "the contiguous-layout SlotDecoder", "contiguous KV and "
                "static generate"
            )
        if prefix_cache is not None:
            raise _not_ported("the prefix cache", "prefix cache and "
                              "PrefixCache")
        if draft_model is not None or draft_params is not None:
            raise _not_ported("draft-model speculation", "speculation")
        if mesh is not None:
            raise _not_ported("TP meshes", "TP")
        if paged_impl not in ("kernel", "gather"):
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
        self.paged_impl = str(paged_impl)
        self._setup_paged(model, kv_pages, page_tokens)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.cache = init_cache(self.model)
        self.state = self._idle_state()
        self.active = np.zeros((self.num_slots,), bool)

    def _setup_paged(self, model, kv_pages, page_tokens):
        """Pick the page geometry, size the :class:`PagePool` (every slot
        holds its full table span, plus the reserved trash page 0), and
        rebuild the model with the pool geometry in its config (same
        parameter tensors)."""
        cfg = model.cfg
        t = int(page_tokens) if page_tokens else 16
        span = -(-self.cache_len // t)  # blocks per slot table
        self._blocks_per_slot = span
        min_pages = self.num_slots * span + 1
        num_pages = int(kv_pages) if kv_pages else min_pages
        if num_pages < min_pages:
            raise ValueError(
                "kv_pages={0} cannot hold {1} slots x {2} blocks (+1 "
                "reserved trash page); need >= {3}".format(
                    num_pages, self.num_slots, span, min_pages
                )
            )
        self.page_pool = PagePool(num_pages, reserved=1)
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

    def admit(self, slot, prompt):
        """Prefill ``prompt`` (1-D int tokens) into lane ``slot`` and
        activate it.  Returns the first generated token as a device
        scalar, unsynchronised.  Raises when the prompt cannot fit
        ``cache_len - max_new_tokens``."""
        prompt = np.asarray(prompt, np.int32).ravel()
        n = prompt.shape[0]
        if n == 0:
            raise ValueError("cannot admit an empty prompt")
        if n + self.max_new_tokens > self.cache_len:
            raise ValueError(
                "prompt ({0}) + max_new_tokens ({1}) exceeds the "
                "engine cache_len={2}".format(
                    n, self.max_new_tokens, self.cache_len
                )
            )
        if self.active[slot]:
            raise ValueError("slot {0} is still active".format(slot))
        first = self._admit_paged(slot, prompt, n)
        self.active[slot] = True
        return first

    def _admit_paged(self, slot, prompt, n):
        """Allocate the slot's pages, point its table row at them, and
        prefill the prompt through that row (the prefill writes straight
        into the pool).  One dispatch sequence per admit."""
        kpref = 0
        row = self.page_pool.alloc(self._blocks_per_slot)
        self.tables[slot] = np.asarray(row, np.int32)
        self._slot_pages[slot] = row
        sb = self._suffix_bucket(n - kpref, kpref)
        suffix = np.zeros((1, sb), np.int64)
        suffix[0, :n - kpref] = prompt[kpref:]
        return self._prefill_paged(slot, suffix, n, kpref)

    @torch.no_grad()
    def _prefill_paged(self, slot, suffix, n, kpref):
        """Canonical-position prefill of ``suffix`` through slot
        ``slot``'s table row; samples the first token from the last real
        row ``n - kpref - 1`` and scatters the slot's state entries."""
        dev = self.device
        logits = self.model(
            self._to_device(suffix), decode=True,
            slot_positions=torch.full((1,), kpref, dtype=torch.int64,
                                      device=dev),
            block_tables=self._to_device(self.tables[slot:slot + 1]),
            cache=self.cache,
        )
        first = self._sample(logits[:, n - kpref - 1])[0]
        self.state["positions"][slot] = n
        self.state["last_tok"][slot] = first
        if self.eos_id is not None:
            self.state["done"][slot] = first == self.eos_id
        else:
            self.state["done"][slot] = False
        return first

    @torch.no_grad()
    def dispatch_chunk(self):
        """Enqueue ``chunk_size`` single-token decode steps over every
        slot without synchronising; returns the ``[B, chunk]`` token
        block as an unresolved device tensor.  Done rows keep emitting
        ``eos_id``; active rows advance their pointer (clamped so a
        completed-but-not-evicted row stays inside the cache), idle
        rows hold still."""
        tables = self._to_device(self.tables)
        active = self._to_device(self.active)
        pos = self.state["positions"]
        tok = self.state["last_tok"]
        done = self.state["done"]
        toks = torch.empty((self.num_slots, self.chunk_size),
                           dtype=torch.int64, device=self.device)
        for i in range(self.chunk_size):
            logits = self.model(
                tok[:, None], decode=True, slot_positions=pos,
                block_tables=tables, cache=self.cache,
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
        self.state = {"positions": pos, "last_tok": tok, "done": done}
        return toks

    def resolve_chunk(self, pending):
        """Pull a :meth:`dispatch_chunk` block to host int32 as
        ``(tokens [B, T], valid [B])`` — the one synchronising call per
        chunk.  Idle lanes hold garbage."""
        toks = pending.cpu().numpy().astype(np.int32)
        return toks, np.full((toks.shape[0],), toks.shape[1], np.int32)

    def step_chunk(self):
        return self.resolve_chunk(self.dispatch_chunk())

    def evict(self, slot):
        """Free lane ``slot`` between chunks — host bookkeeping only: the
        slot's pages return to the pool and its table row parks on the
        trash page so the lane's dead decode writes never land in a
        live page."""
        self.active[slot] = False
        if self._slot_pages[slot]:
            self.page_pool.release(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self.tables[slot, :] = 0

    def cancel(self, slot):
        """Cancel an in-flight lane between chunks (same as :meth:`evict`)."""
        self.evict(slot)

    def reset(self):
        """Return every slot to idle (between serving jobs); the pools
        stay allocated, their stale KV is unreachable."""
        for slot in range(self.num_slots):
            if self._slot_pages[slot]:
                self.page_pool.release(self._slot_pages[slot])
                self._slot_pages[slot] = []
        self.tables[:, :] = 0
        self.state = self._idle_state()
        self.active[:] = False

    def reuse_stats(self):
        """Page-pool occupancy gauges."""
        return self.page_pool.stats()


#: serving_builder keys that select a plane this package has not ported
#: yet, with the ROADMAP item that brings it; a truthy value raises
_UNPORTED_KNOBS = {
    "auto": "the cost-model planner (engine planes)",
    "weights": "int8/int4 weights, int8 KV cache and quantize",
    "quantize": "int8/int4 weights, int8 KV cache and quantize",
    "int4_group": "int8/int4 weights, int8 KV cache and quantize",
    "prefix_cache": "prefix cache and PrefixCache",
    "prefix_mem_mb": "prefix cache and PrefixCache",
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
        if key in ("weights", "quantize") and val in ("float", "none"):
            continue
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


def serving_builder(params, config):
    """Generation predictor over a Flax-layout parameter tree (port of
    the reference's ``serving_builder``, ``mode="generate"`` with
    ``kv_layout="paged"``).

    ``config`` takes the reference's keys (TransformerConfig fields and
    the serving knobs) plus ``device`` (default ``cuda``).  Unknown keys
    raise :class:`~..planner.knobs.UnknownKnobError`; knobs of planes
    not ported yet raise ``NotImplementedError``.  The returned
    ``predict`` carries ``make_slot_decoder`` for
    ``serving.predict_rows(..., schedule="continuous")``; calling it
    directly (the static schedule) is not ported.
    """
    cfg_fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    knob_registry.validate_keys(config, cfg_fields | {"device"})
    _check_unported(config)
    if config.get("mode") != "generate":
        raise _not_ported(
            "logits serving (mode != 'generate')", "contiguous KV and "
            "static generate"
        )
    kv_layout = str(config.get("kv_layout", "contiguous"))
    if kv_layout != "paged":
        raise _not_ported(
            "kv_layout={0!r}".format(kv_layout), "contiguous KV and static "
            "generate"
        )
    device = resolve_device(config.get("device"))
    overrides = dict(config, attention_impl="dot", mesh=None)
    cfg = TransformerConfig(
        **{k: v for k, v in overrides.items() if k in cfg_fields}
    )
    from tensorflowonspark_tpu_torch import convert

    model = convert.params_from_flax(_unwrap_params(params), cfg, device=device)
    model.requires_grad_(False)

    max_new = int(config["max_new_tokens"])
    temperature = float(config.get("temperature", 0.0))
    top_k = int(config.get("top_k", 0))
    top_p = float(config.get("top_p", 0.0))
    pad_id = int(config.get("pad_id", 0))
    eos_id = config.get("eos_id")
    eos_id = None if eos_id is None else int(eos_id)
    input_name = config.get("input_name", "tokens")
    chunk_size = int(config.get("chunk_size", 16))
    max_prompt = config.get("max_prompt_len")
    paged_impl = str(config.get("paged_impl") or "kernel")
    page_tokens = config.get("kv_page_tokens", config.get("prefix_block"))
    enforce = config.get("check_tiles")
    if enforce is None:
        # the kernel only runs on the GPU; the CPU path takes any geometry
        enforce = paged_impl == "kernel" and device.type == "cuda"
    if enforce:
        check_tiles(
            int(page_tokens or 16), cfg.head_dim, cfg.torch_dtype,
            group=cfg.num_heads // (cfg.num_kv_heads or cfg.num_heads),
        )

    def predict(batch):
        raise _not_ported(
            "the static generate schedule (calling the predictor "
            "directly)", "contiguous KV and static generate"
        )

    predict.column_padding = {input_name: pad_id}
    predict.pad_multiple = int(config.get("pad_multiple", 64))
    predict.pad_cap = max(1, cfg.max_seq_len - max_new)
    slot_decoders = {}

    def make_slot_decoder(num_slots, chunk=None):
        # memoized per (slots, chunk); a reused decoder only resets its
        # host-side slot table and keeps its pools
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
            eos_id=eos_id, seed=int(config.get("seed", 0)),
            kv_layout="paged", kv_pages=config.get("kv_pages"),
            page_tokens=page_tokens, paged_impl=paged_impl,
        )
        slot_decoders[key] = dec
        return dec

    predict.make_slot_decoder = make_slot_decoder
    predict.max_new_tokens = max_new
    predict.eos_id = eos_id
    return predict
