"""Attention dispatcher (port of the JAX package's ``ops/attention.py``).

Shapes follow the reference's ``[batch, seq, heads, head_dim]``
convention so the port's public functions compare like with like.
``dot`` is the plain implementation; ``flash`` dispatches to
:func:`.flash_attention.flash_attention` (the hand-written kernels
K2-K4 on the GPU); ``ring`` and ``ulysses`` (sequence parallelism) to
:mod:`.ring_attention` and :mod:`.ulysses` on this rank's shards.
"""

import torch

from tensorflowonspark_tpu_torch.ops.flash_attention import flash_attention

_IMPLS = ("dot", "flash", "ring", "ulysses")


def dot_attention(q, k, v, causal=True, scale=None, mask=None, window=0,
                  k_scale=None, v_scale=None):
    """Plain softmax attention.

    Args:
      q: ``[B, Sq, H, D]``; k, v: ``[B, Sk, Hkv, D]`` where ``Hkv``
        divides ``H`` (grouped-query attention; k/v are never repeated).
      causal: apply a causal mask (queries aligned at the end).
      mask: optional additive mask broadcastable to ``[B, H, Sq, Sk]``.
      window: ``> 0`` restricts each query to the last ``window``
        positions (requires ``causal``).
      k_scale, v_scale: optional ``[B, Sk, Hkv, 1]`` dequant scales for
        int8 ``k``/``v``.  The factored identities scale the logits
        (``q·(k*ks) == (q·k)*ks``) and the probabilities
        (``Σ p·(v*vs) == Σ (p*vs)·v``); the int8 banks only convert.
    Logits and softmax are f32; returns ``[B, Sq, H, D]`` in ``q.dtype``.
    """
    if window:
        if window < 0:
            raise ValueError(
                "window must be positive, got {0}".format(window)
            )
        if not causal:
            raise ValueError("window attention requires causal=True")
    orig_dtype = q.dtype
    if k.dtype != orig_dtype:
        k = k.to(orig_dtype)
    if v.dtype != orig_dtype:
        v = v.to(orig_dtype)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if h % hkv != 0:
        raise ValueError(
            "query heads ({0}) must be a multiple of kv heads "
            "({1})".format(h, hkv)
        )
    g = h // hkv
    # products of the working type are exact in f32, so upcasting the
    # operands is the reference's f32-accumulated einsum
    qg = q.reshape(b, sq, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if k_scale is not None:
        # [B, Sk, Hkv, 1] -> [B, Hkv, 1, 1, Sk]
        logits = logits * k_scale.permute(0, 2, 3, 1)[:, :, None]
    logits = logits.reshape(b, h, sq, sk) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        visible = qpos >= kpos
        if window:
            visible = visible & (kpos > qpos - window)
        logits = logits.masked_fill(~visible, float("-inf"))
    if mask is not None:
        logits = logits + mask
    weights = torch.softmax(logits, dim=-1)
    wg = weights.reshape(b, hkv, g, sq, sk)
    if v_scale is not None:
        wg = wg * v_scale.permute(0, 2, 3, 1)[:, :, None]
    # the reference rounds the probabilities to v's type before the
    # f32-accumulated product
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", wg.to(v.dtype).float(), v.float()
    ).reshape(b, sq, h, d)
    return out.to(orig_dtype)


def attention(q, k, v, impl="dot", causal=True, scale=None, mesh=None,
              seq_axis="seq", block_q=1024, block_k=1024,
              ring_impl="flash", window=0):
    """Dispatch to an attention implementation: ``dot``, ``flash``,
    ``ring`` or ``ulysses`` (``block_q``/``block_k`` keep the reference's
    flash tiling rule, for ``flash`` and the flash steps of the others).

    ``ring``/``ulysses`` take this rank's ``[B, S_local, ...]`` shards:
    with a ``mesh`` (a :class:`..parallel.mesh.Mesh`) they run over its
    ``seq_axis`` line; without one over the default process group (the
    reference's call inside ``shard_map`` with ``seq_axis`` bound).
    ``ring_impl`` is ring's inner step (``"flash"`` or ``"dense"``).
    """
    if impl not in _IMPLS:
        raise ValueError(
            "unknown attention impl {0!r}; one of {1}".format(impl, _IMPLS)
        )
    if impl == "ring":
        from tensorflowonspark_tpu_torch.ops import ring_attention as ra

        kw = dict(causal=causal, scale=scale, impl=ring_impl,
                  block_q=block_q, block_k=block_k, window=window)
        if mesh is not None:
            return ra.ring_attention_sharded(q, k, v, mesh,
                                             axis_name=seq_axis, **kw)
        return ra.ring_attention(q, k, v, **kw)
    if impl == "ulysses":
        from tensorflowonspark_tpu_torch.ops import ulysses as ul

        kw = dict(causal=causal, scale=scale, block_q=block_q,
                  block_k=block_k, window=window)
        if mesh is not None:
            return ul.ulysses_attention_sharded(q, k, v, mesh,
                                                axis_name=seq_axis, **kw)
        return ul.ulysses_attention(q, k, v, **kw)
    if impl == "flash":
        return flash_attention(
            q, k, v, causal=causal, scale=scale, block_q=block_q,
            block_k=block_k, window=window,
        )
    return dot_attention(q, k, v, causal=causal, scale=scale, window=window)
