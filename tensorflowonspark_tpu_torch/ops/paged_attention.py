"""Paged decode attention over a physical KV page pool (port of
the JAX package's ``ops/paged_attention.py``).

K/V live in one pool per layer, ``[num_pages, page_tokens, kv_heads,
head_dim]``, and each slot addresses it through a block table
``[slots, blocks_per_slot]`` of page indices (see
:class:`~tensorflowonspark_tpu_torch.prefix_cache.PagePool`).

Two entry points, as in the reference:

- :func:`paged_attention` — single-token decode steps (``q [B, H, D]``),
  the bandwidth-bound hot loop.  On a CUDA tensor it launches the
  hand-written Hopper kernel ``csrc/paged_attention.cu`` (which replaces
  the TPU kernel ``_paged_kernel``); on a CPU tensor it runs
  :func:`paged_attention_reference`, the plain PyTorch version of the
  same function.  There is no fallback from one to the other.
- :func:`paged_gather_attention` — multi-token query spans (suffix
  prefill): gathers the slot's pages into a transient contiguous view
  and reuses :func:`.attention.dot_attention`.
"""

import torch

from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.ops.attention import dot_attention

NEG_INF = -1e30  # finite mask sentinel: exp() underflows to 0, no NaNs

#: largest page the kernel stages: the K and V tiles of a page are held
#: in shared memory as f32, 2 * T * D * 4 bytes (128 KiB at 64 x 256)
MAX_PAGE_TOKENS = 64
MAX_HEAD_DIM = 256
#: shared memory one block may use on Hopper (227 KiB)
MAX_SMEM_BYTES = 232448
#: pool types the kernel is instantiated for (q is f32 or bf16; the
#: pools have q's type or int8)
KERNEL_POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
KERNEL_Q_DTYPES = (torch.float32, torch.bfloat16)


class TileLegalityError(ValueError):
    """A paged-KV geometry the CUDA kernel does not take.

    Raised by :func:`check_tiles` when ``serving_builder`` builds a
    kernel-path decoder on the GPU, so an unsupported ``page_tokens`` /
    ``head_dim`` / type fails with a named error at build time instead
    of at the first decode step.
    """


def _smem_bytes(group, head_dim, page_tokens):
    """Dynamic shared memory of one block (mirrors ``smem_floats`` in
    the CUDA source): q and acc ``[G, D]``, K and V tiles ``[T, D]``,
    probabilities ``[G, T]``, scales ``[T]`` x2, softmax state ``[G]``
    x3, all f32."""
    g, d, t = int(group), int(head_dim), int(page_tokens)
    return 4 * (2 * g * d + 2 * t * d + g * t + 2 * t + 3 * g)


def check_tiles(page_tokens, head_dim, dtype, group=1):
    """Validate a paged-KV geometry against what the Hopper kernel takes.

    Stands in for the reference's Mosaic (sublane, lane) rule, which
    does not apply on the GPU.  The kernel takes ``1 <= page_tokens <=
    64``, ``1 <= head_dim <= 256``, pools of f32, bf16 or int8, and a
    block's shared memory (which grows with the GQA ``group``) within
    227 KiB.  ``dtype`` is the pool's type (a torch dtype or its name).

    Returns ``{"page_tokens", "head_dim", "smem_bytes"}`` when legal;
    raises :class:`TileLegalityError` otherwise.
    """
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None) or dtype
    page_tokens, head_dim = int(page_tokens), int(head_dim)
    problems = []
    if not 1 <= page_tokens <= MAX_PAGE_TOKENS:
        problems.append(
            "page_tokens={0} must be in [1, {1}]".format(
                page_tokens, MAX_PAGE_TOKENS
            )
        )
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        problems.append(
            "head_dim={0} must be in [1, {1}]".format(head_dim, MAX_HEAD_DIM)
        )
    if dtype not in KERNEL_POOL_DTYPES:
        problems.append(
            "pool dtype {0} is not one of {1}".format(
                dtype, [str(d) for d in KERNEL_POOL_DTYPES]
            )
        )
    smem = _smem_bytes(group, head_dim, page_tokens)
    if smem > MAX_SMEM_BYTES:
        problems.append(
            "a block needs {0} bytes of shared memory at group={1}; the "
            "limit is {2}".format(smem, group, MAX_SMEM_BYTES)
        )
    if problems:
        raise TileLegalityError(
            "paged-KV geometry not supported by the CUDA kernel: "
            + "; ".join(problems)
        )
    return {"page_tokens": page_tokens, "head_dim": head_dim,
            "smem_bytes": smem}


def _check_args(q, k_pool, v_pool, block_tables, lengths, k_scale_pool,
                v_scale_pool):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(
            "q must be [B, H, D] and the pools [P, T, Hkv, D]; got {0} "
            "and {1}".format(tuple(q.shape), tuple(k_pool.shape))
        )
    b, h, d = q.shape
    hkv, dk = k_pool.shape[2], k_pool.shape[3]
    if dk != d:
        raise ValueError(
            "head_dim mismatch: q {0} vs pool {1}".format(
                tuple(q.shape), tuple(k_pool.shape)
            )
        )
    if v_pool.shape != k_pool.shape:
        raise ValueError(
            "k/v pool shapes differ: {0} vs {1}".format(
                tuple(k_pool.shape), tuple(v_pool.shape)
            )
        )
    if h % hkv != 0:
        raise ValueError(
            "query heads ({0}) must be a multiple of kv heads "
            "({1})".format(h, hkv)
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(
            "block_tables must be [B={0}, NB]; got {1}".format(
                b, tuple(block_tables.shape)
            )
        )
    if tuple(lengths.shape) != (b,):
        raise ValueError(
            "lengths must be [B={0}]; got {1}".format(b, tuple(lengths.shape))
        )
    if (k_scale_pool is None) != (v_scale_pool is None):
        raise ValueError("k_scale_pool needs v_scale_pool (and vice versa)")


def paged_attention(q, k_pool, v_pool, block_tables, lengths, *,
                    scale=None, window=0, k_scale_pool=None,
                    v_scale_pool=None):
    """Single-token decode attention over a paged KV pool.

    Args:
      q: ``[B, H, D]`` — one query per slot (its K/V already written at
        position ``lengths[b] - 1`` of slot ``b``'s table span).
      k_pool, v_pool: ``[P, T, Hkv, D]`` page pools; ``Hkv`` divides
        ``H`` (GQA, k/v never repeated).  int8 pools take the scale pools.
      block_tables: ``[B, NB]`` int page indices; entries past the live
        length must still be valid indices (idle/unused entries point
        at the trash page 0) — they are masked, never read as live data.
      lengths: ``[B]`` int — tokens visible to slot ``b``'s query
        (``>= 1``; it attends positions ``[0, lengths[b])``).
      scale: logit scale (default ``D ** -0.5``).
      window: sliding-window width (0 = full causal); pages wholly
        behind the horizon are skipped, partial pages masked.
      k_scale_pool, v_scale_pool: ``[P, T, Hkv, 1]`` f32 dequant scales.
    Returns ``[B, H, D]`` in ``q.dtype``.

    A CUDA ``q`` launches the kernel (and counts one launch in
    ``paged_attention.launches``); a CPU ``q`` runs
    :func:`paged_attention_reference`.
    """
    _check_args(q, k_pool, v_pool, block_tables, lengths, k_scale_pool,
                v_scale_pool)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, lengths, scale=scale,
            window=window, k_scale_pool=k_scale_pool,
            v_scale_pool=v_scale_pool,
        )
    if q.device.type != "cuda":
        raise ValueError(
            "paged_attention runs on cuda or cpu tensors, got "
            "{0}".format(q.device)
        )
    return _launch(q, k_pool, v_pool, block_tables, lengths, float(scale),
                   int(window), k_scale_pool, v_scale_pool)


#: kernel launches since the count was last reset (the CPU path and the
#: plain version never touch it)
paged_attention.launches = 0


def _launch(q, k_pool, v_pool, block_tables, lengths, scale, window,
            k_scale_pool, v_scale_pool):
    b, h, d = q.shape
    p, t, hkv, _ = k_pool.shape
    nb = block_tables.shape[1]
    if q.dtype not in KERNEL_Q_DTYPES:
        raise TypeError(
            "the CUDA kernel takes f32 or bf16 queries, got {0}".format(
                q.dtype
            )
        )
    kv_int8 = k_pool.dtype == torch.int8
    if not kv_int8 and k_pool.dtype != q.dtype:
        raise TypeError(
            "pools must have q's type ({0}) or int8, got {1}".format(
                q.dtype, k_pool.dtype
            )
        )
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("k/v pools must share a type")
    check_tiles(t, d, k_pool.dtype, group=h // hkv)
    scales = k_scale_pool is not None
    tensors = [q, k_pool, v_pool]
    if scales:
        for s in (k_scale_pool, v_scale_pool):
            if s.dtype != torch.float32 or tuple(s.shape) != (p, t, hkv, 1):
                raise TypeError(
                    "scale pools must be f32 [P, T, Hkv, 1] = {0}; got {1} "
                    "{2}".format((p, t, hkv, 1), s.dtype, tuple(s.shape))
                )
        tensors += [k_scale_pool, v_scale_pool]
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    for x in tensors + [tables, lens]:
        if x.device != q.device:
            raise ValueError(
                "all paged_attention operands must be on {0}; got one on "
                "{1}".format(q.device, x.device)
            )
        if not x.is_contiguous():
            raise ValueError(
                "paged_attention operands must be contiguous; got shape "
                "{0} strides {1}".format(tuple(x.shape), x.stride())
            )
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _build.load("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.tfos_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale_pool.data_ptr() if scales else None,
        v_scale_pool.data_ptr() if scales else None,
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, h, hkv, d, p, t, nb, scale, window,
        int(q.dtype == torch.bfloat16), int(kv_int8), stream,
    )
    if err != 0:
        raise RuntimeError(
            "paged_attention kernel launch failed with CUDA error "
            "{0}".format(err)
        )
    paged_attention.launches += 1
    return out


def paged_attention_reference(q, k_pool, v_pool, block_tables, lengths, *,
                              scale=None, window=0, k_scale_pool=None,
                              v_scale_pool=None):
    """Plain PyTorch version of :func:`paged_attention`: gather the
    slot's pages, mask one query at position ``lengths - 1``, and run
    :func:`.attention.dot_attention`."""
    _check_args(q, k_pool, v_pool, block_tables, lengths, k_scale_pool,
                v_scale_pool)
    positions = (lengths.to(torch.int64) - 1)[:, None]
    return paged_gather_attention(
        q[:, None], k_pool, v_pool, block_tables, positions, scale=scale,
        window=window, k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
    )[:, 0]


def gather_pool(pool, block_tables, span=None):
    """Per-slot contiguous banks from a paged pool: ``[P, T, Hkv, Dx]``
    gathered through ``[B, NB]`` tables -> ``[B, NB*T, Hkv, Dx]``,
    sliced to ``span`` positions when given."""
    b, nb = block_tables.shape
    t = pool.shape[1]
    g = pool.index_select(0, block_tables.reshape(-1).to(torch.int64))
    g = g.reshape((b, nb * t) + tuple(pool.shape[2:]))
    return g[:, :span] if span is not None else g


def paged_gather_attention(q, k_pool, v_pool, block_tables, positions, *,
                           span=None, scale=None, window=0,
                           k_scale_pool=None, v_scale_pool=None):
    """Multi-token-query paged attention via gather + masked attention.

    ``q`` is ``[B, S, H, D]``; ``positions`` ``[B, S]`` gives each query
    row's absolute cache position (its causal horizon)."""
    k = gather_pool(k_pool, block_tables, span)
    v = gather_pool(v_pool, block_tables, span)
    ks = (
        gather_pool(k_scale_pool, block_tables, span)
        if k_scale_pool is not None else None
    )
    vs = (
        gather_pool(v_scale_pool, block_tables, span)
        if v_scale_pool is not None else None
    )
    kpos = torch.arange(k.shape[1], device=q.device)
    qpos = positions.to(q.device)
    vis = kpos[None, None, :] <= qpos[:, :, None]
    if window:
        vis = vis & (kpos[None, None, :] > qpos[:, :, None] - window)
    mask = torch.zeros(vis.shape, dtype=torch.float32, device=q.device)
    mask = mask.masked_fill(~vis, float("-inf"))[:, None]
    return dot_attention(
        q, k, v, causal=False, scale=scale, mask=mask,
        k_scale=ks, v_scale=vs,
    )
