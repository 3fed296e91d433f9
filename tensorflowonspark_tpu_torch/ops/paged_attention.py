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
  the TPU kernel ``_paged_kernel``): each slot's live pages split over
  several blocks (:func:`num_splits`, :func:`split_page_ranges`), whose
  partial softmax states a second kernel combines.  On a CPU tensor it
  runs :func:`paged_attention_reference`, the plain PyTorch version of
  the same function.  There is no fallback from one to the other.
  :func:`paged_attention_split_reference` is the plain version of the
  kernel's split-and-combine arithmetic.
- :func:`paged_gather_attention` — multi-token query spans (suffix
  prefill): gathers the slot's pages into a transient contiguous view
  and reuses :func:`.attention.dot_attention`.
"""

import functools
import threading

import torch

from tensorflowonspark_tpu_torch.ops import _build
from tensorflowonspark_tpu_torch.ops.attention import dot_attention

NEG_INF = -1e30  # finite mask sentinel: exp() underflows to 0, no NaNs

#: largest page and head_dim the kernel takes
MAX_PAGE_TOKENS = 64
MAX_HEAD_DIM = 256
#: shared memory one block may use on Hopper (227 KiB)
MAX_SMEM_BYTES = 232448
#: pool types the kernel is instantiated for (q is f32 or bf16; the
#: pools have q's type or int8)
KERNEL_POOL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
KERNEL_Q_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's ring of page stages: at most this many, within this
#: many bytes (at least one stage, whatever its size)
MAX_STAGES = 4
RING_BUDGET_BYTES = 64 * 1024
#: most splits of a slot's pages (the combine kernel's weight buffer)
MAX_SPLITS = 256
#: the host's split rule: at least this many blocks per SM, and at
#: most this many pages per split (blocks of a few pages balance
#: ragged lengths across the SMs)
SPLIT_WAVES = 4
MAX_PAGES_PER_SPLIT = 8


class TileLegalityError(ValueError):
    """A paged-KV geometry the CUDA kernel does not take.

    Raised by :func:`check_tiles` when ``serving_builder`` builds a
    kernel-path decoder on the GPU, so an unsupported ``page_tokens`` /
    ``head_dim`` / type fails with a named error at build time instead
    of at the first decode step.
    """


def _round_up(x, m):
    return -(-x // m) * m


def _kernel_geometry(group, head_dim, page_tokens, itemsize):
    """The kernel's shared memory (mirrors ``geometry`` in the CUDA
    source): a ring of page stages, each ``round128(2 * T * row + 8 *
    T)`` bytes (K and V rows in the pool's type, ``row`` = ``D *
    itemsize`` rounded up to ``max(16, EPL * itemsize)``, EPL = 4 for
    ``D <= 128`` else 8; then the two f32 scale rows), then q and the
    merged accumulator ``[G, D]`` f32 and m, l ``[G]`` f32.  The ring
    holds up to :data:`MAX_STAGES` stages within
    :data:`RING_BUDGET_BYTES` and what is left of
    :data:`MAX_SMEM_BYTES`, at least one."""
    g, d, t = int(group), int(head_dim), int(page_tokens)
    epl = 4 if d <= 128 else 8
    row = _round_up(d * itemsize, max(16, epl * itemsize))
    stage = _round_up(2 * t * row + 8 * t, 128)
    fixed = 8 * g * d + 8 * g
    stages = max(1, min(MAX_STAGES, RING_BUDGET_BYTES // stage,
                        (MAX_SMEM_BYTES - fixed) // stage))
    return {"row_bytes": row, "stage_bytes": stage, "stages": stages,
            "smem_bytes": stages * stage + fixed}


def check_tiles(page_tokens, head_dim, dtype, group=1):
    """Validate a paged-KV geometry against what the Hopper kernel takes.

    Stands in for the reference's Mosaic (sublane, lane) rule, which
    does not apply on the GPU.  The kernel takes ``1 <= page_tokens <=
    64``, ``1 <= head_dim <= 256``, pools of f32, bf16 or int8, and a
    block's shared memory (one page stage, and q and the accumulator of
    the GQA ``group``, :func:`_kernel_geometry`) within 227 KiB.
    ``dtype`` is the pool's type (a torch dtype or its name).

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
    itemsize = (torch.empty((), dtype=dtype).element_size()
                if dtype in KERNEL_POOL_DTYPES else 4)
    smem = _kernel_geometry(group, max(head_dim, 1), max(page_tokens, 1),
                            itemsize)["smem_bytes"]
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
#: plain version never touch it); the fleet's replicas launch from
#: threads of their own, so the count is taken under a lock
paged_attention.launches = 0
_LAUNCHES_LOCK = threading.Lock()


def _count_launch():
    with _LAUNCHES_LOCK:
        paged_attention.launches += 1


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    """The SM count of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    splits = num_splits(b, hkv, nb, _sm_count(q.device.index), t, window)
    ws_acc = ws_ml = None
    if splits > 1:
        ws_acc = torch.empty((b, h, splits, d), dtype=torch.float32,
                             device=q.device)
        ws_ml = torch.empty((b, h, splits, 2), dtype=torch.float32,
                            device=q.device)
    lib = _build.load("paged_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.tfos_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale_pool.data_ptr() if scales else None,
        v_scale_pool.data_ptr() if scales else None,
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        ws_acc.data_ptr() if splits > 1 else None,
        ws_ml.data_ptr() if splits > 1 else None,
        b, h, hkv, d, p, t, nb, scale, window, splits,
        int(q.dtype == torch.bfloat16), int(kv_int8), stream,
    )
    if err != 0:
        raise RuntimeError(
            "paged_attention kernel launch failed with CUDA error "
            "{0}".format(err)
        )
    _count_launch()
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


def num_splits(batch, kv_heads, blocks_per_slot, sm_count, page_tokens,
               window=0):
    """How many blocks share each (slot, kv head)'s pages: enough for
    :data:`SPLIT_WAVES` blocks per SM and for a full table to give each
    split at most :data:`MAX_PAGES_PER_SPLIT` pages; at most
    ``blocks_per_slot`` (a split of at least one page), at most the
    pages a ``window`` can touch, at most :data:`MAX_SPLITS`.  The host
    side of the kernel; it never reads the lengths (no host sync)."""
    nb = int(blocks_per_slot)
    want = max(
        -(-SPLIT_WAVES * int(sm_count) // (int(batch) * int(kv_heads))),
        -(-nb // MAX_PAGES_PER_SPLIT))
    cap = min(nb, MAX_SPLITS)
    if window and window > 0:
        cap = min(cap, 1 + -(-(int(window) - 1) // int(page_tokens)))
    return max(1, min(want, cap))


def split_page_ranges(lengths, page_tokens, blocks_per_slot, window,
                      splits):
    """``(lo, hi)``, int64 ``[B, splits]``: the pages ``[lo, hi)`` of each
    slot that each split of the kernel reads.  Mirrors the kernel's
    device side: a slot's live pages are ``[first, min(ceil(len / T),
    NB))``, ``first`` the window's first page (0 without a window), and
    split ``s`` of ``S`` takes ``[first + s * live // S, first + (s + 1)
    * live // S)``, which may be empty."""
    t, nb = int(page_tokens), int(blocks_per_slot)
    lens = torch.as_tensor(lengths).to(torch.int64).clamp_min(0)
    n_pages = torch.clamp(-(-lens // t), max=nb)
    first = torch.zeros_like(lens)
    if window and window > 0:
        first = torch.where(lens - window > 0, (lens - window) // t, first)
    live = (n_pages - first).clamp_min(0)
    s = torch.arange(splits + 1, dtype=torch.int64)
    edges = first[:, None] + s[None, :] * live[:, None] // splits
    return edges[:, :-1], edges[:, 1:]


def split_partials(q, k_pool, v_pool, block_tables, lengths, *, splits,
                   scale=None, window=0, k_scale_pool=None,
                   v_scale_pool=None):
    """Plain version of the kernel's first pass: for each split of
    :func:`split_page_ranges`, the online-softmax state over the
    visible positions of its pages, ``m`` and ``l`` ``[B, H, S]`` and
    ``acc`` ``[B, H, S, D]``, all f32.  An empty split has ``m =
    NEG_INF``, ``l = 0`` and a zero ``acc``; ``p`` (times the v scale)
    is rounded to q's type before P.V, as in the kernel."""
    _check_args(q, k_pool, v_pool, block_tables, lengths, k_scale_pool,
                v_scale_pool)
    b, h, d = q.shape
    t, hkv = k_pool.shape[1], k_pool.shape[2]
    nb = block_tables.shape[1]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    lo, hi = split_page_ranges(lengths.cpu(), t, nb, window, splits)
    lo, hi = lo.to(q.device), hi.to(q.device)
    k = gather_pool(k_pool, block_tables).to(q.dtype).float()
    v = gather_pool(v_pool, block_tables).to(q.dtype).float()
    logits = torch.einsum("bkgd,blkd->bkgl",
                          q.float().reshape(b, hkv, g, d), k)
    if k_scale_pool is not None:
        ks = gather_pool(k_scale_pool, block_tables)[..., 0]  # [B, L, Hkv]
        logits = logits * ks.transpose(1, 2)[:, :, None, :]
    logits = logits * scale
    pos = torch.arange(nb * t, device=q.device)
    lens = lengths.to(q.device, torch.int64)[:, None]
    vis = pos[None, :] < lens
    if window:
        vis = vis & (pos[None, :] >= lens - window)
    page = (pos // t)[None, None, :]
    mask = (vis[:, None, :] & (page >= lo[:, :, None])
            & (page < hi[:, :, None]))  # [B, S, L]
    mask = mask[:, :, None, None, :]  # [B, S, 1, 1, L]
    lg = torch.where(mask, logits[:, None], NEG_INF)  # [B, S, Hkv, G, L]
    m = lg.amax(dim=-1)
    p = torch.where(mask, torch.exp(lg - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if v_scale_pool is not None:
        vs = gather_pool(v_scale_pool, block_tables)[..., 0]  # [B, L, Hkv]
        p = p * vs.transpose(1, 2)[:, None, :, None, :]
    p = p.to(q.dtype).float()
    acc = torch.einsum("bskgl,blkd->bskgd", p, v)

    def heads(x):  # [B, S, Hkv, G, ...] -> [B, H, S, ...]
        x = x.reshape((b, splits, h) + tuple(x.shape[4:]))
        return x.transpose(1, 2).contiguous()

    return heads(m), heads(l), heads(acc)


def combine_splits(m, l, acc, dtype):
    """Plain version of the combine kernel: ``sum_s e^(m_s - M) acc_s /
    sum_s e^(m_s - M) l_s`` with ``M = max_s m_s``, in ``dtype``."""
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    out = (w[..., None] * acc).sum(dim=-2) / (w * l).sum(dim=-1)[..., None]
    return out.to(dtype)


def paged_attention_split_reference(q, k_pool, v_pool, block_tables,
                                    lengths, *, splits, scale=None,
                                    window=0, k_scale_pool=None,
                                    v_scale_pool=None):
    """Plain PyTorch version of the kernel's split-and-combine
    arithmetic: :func:`split_partials`, then :func:`combine_splits`.
    The same function as :func:`paged_attention_reference` for every
    ``splits >= 1``."""
    m, l, acc = split_partials(
        q, k_pool, v_pool, block_tables, lengths, splits=splits,
        scale=scale, window=window, k_scale_pool=k_scale_pool,
        v_scale_pool=v_scale_pool,
    )
    return combine_splits(m, l, acc, q.dtype)


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
