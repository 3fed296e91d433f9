"""Ulysses (DeepSpeed-style) sequence parallelism by all-to-all (port
of the JAX package's ``ops/ulysses.py``).

Attention is independent across heads and global across the sequence,
so the sharding flips around the attention op:

    [B, S/P, H, D]  --all_to_all-->  [B, S, H/P, D]   (heads split)
          attend over the full sequence locally
    [B, S, H/P, D]  --all_to_all-->  [B, S/P, H, D]   (sequence split)

Each all-to-all is one ``dist.all_to_all_single`` over the ``seq``
group; its gradient is the opposite all-to-all.  The local attention is
the windowed flash kernels (K2-K4 at ``q_offset = 0``), or the plain
``dot`` path when asked for; where the flash tiling rule refuses the
sequence length, ``flash`` raises on CUDA tensors and takes ``dot`` on
CPU ones (the reference's shape rule).
Query and kv head counts must divide by the group's size; otherwise use
:mod:`.ring_attention`.
"""

import torch

from tensorflowonspark_tpu_torch.ops.attention import dot_attention
from tensorflowonspark_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_supported,
)
from tensorflowonspark_tpu_torch.ops.ring_attention import SeqAxis


def _all_to_all(x, axis):
    """``x [P, ...]``: part ``j`` to rank ``j`` of the axis; returns the
    parts received, part ``j`` from rank ``j``."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


def _seq_to_heads(x, axis):
    """``[B, S/P, H, D]`` -> ``[B, S, H/P, D]``: this rank's head group
    over the whole sequence."""
    b, sl, h, d = x.shape
    p = axis.size
    parts = x.reshape(b, sl, p, h // p, d).permute(2, 0, 1, 3, 4)
    got = _all_to_all(parts, axis)  # [P (seq slice), B, S/P, H/P, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, p * sl, h // p, d)


def _heads_to_seq(y, axis):
    """``[B, S, H/P, D]`` -> ``[B, S/P, H, D]``: every head over this
    rank's slice of the sequence."""
    b, s, hp, d = y.shape
    p = axis.size
    parts = y.reshape(b, p, s // p, hp, d).permute(1, 0, 2, 3, 4)
    got = _all_to_all(parts, axis)  # [P (head group), B, S/P, H/P, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // p, p * hp, d)


class _Reshard(torch.autograd.Function):
    """Sequence-split to head-split (``to_heads``) or back; the gradient
    takes the opposite all-to-all."""

    @staticmethod
    def forward(ctx, x, axis, to_heads):
        ctx.axis, ctx.to_heads = axis, to_heads
        return (_seq_to_heads if to_heads else _heads_to_seq)(x, axis)

    @staticmethod
    def backward(ctx, g):
        back = _heads_to_seq if ctx.to_heads else _seq_to_heads
        return back(g, ctx.axis), None, None


def _ulysses(q, k, v, axis, causal, scale, local_impl, block_q, block_k,
             window):
    p = axis.size
    h, hkv = q.shape[2], k.shape[2]
    if h % p != 0 or hkv % p != 0:
        raise ValueError(
            "ulysses needs query heads ({0}) and kv heads ({1}) "
            "divisible by the seq axis size ({2}); use ring attention "
            "instead".format(h, hkv, p)
        )
    if local_impl == "flash":
        s_val = scale if scale is not None else q.shape[-1] ** -0.5
        if not flash_supported(s_val, q.shape[1] * p, block_q, block_k):
            if q.device.type == "cuda":
                raise ValueError(
                    "flash attention refuses sequence length {0} with scale "
                    "{1!r} (block_q={2}, block_k={3}); pad the sequence, "
                    "pass block sizes that tile it, or ask for "
                    "local_impl=\"dot\"".format(q.shape[1] * p, s_val,
                                                 block_q, block_k)
                )
            # CPU tensors: the plain step, as the reference's shape rule
            local_impl = "dot"
    if p > 1:
        q, k, v = (_Reshard.apply(x, axis, True) for x in (q, k, v))
    # after the all-to-all the local sequence is global, so the window
    # mask applies directly
    if local_impl == "flash":
        out = flash_attention(q, k, v, causal=causal, scale=scale,
                              block_q=block_q, block_k=block_k,
                              window=window)
    elif local_impl == "dot":
        out = dot_attention(q, k, v, causal=causal, scale=scale,
                            window=window)
    else:
        raise ValueError("unknown ulysses local_impl {0!r}; options: "
                         "flash, dot".format(local_impl))
    return _Reshard.apply(out, axis, False) if p > 1 else out


def ulysses_attention(q, k, v, causal=True, scale=None, group=None,
                      local_impl="flash", block_q=1024, block_k=1024,
                      window=0):
    """Attention over sequence shards by all-to-all over ``group``.

    Args:
      q, k, v: this rank's ``[B, S_local, H, D]`` shards (k/v with
        ``Hkv`` heads), the sequence split over the group's ranks in rank
        order.
      group: the ``seq`` process group (the reference's ``axis_name``);
        ``None`` is the default group, or one rank without a process
        group.
      local_impl: ``"flash"`` (K2-K4 over the full sequence) or
        ``"dot"`` (plain); where its tiling rule refuses the sequence
        length, ``flash`` raises on CUDA tensors and takes ``dot`` on CPU
        ones.
    Returns this rank's ``[B, S_local, H, D]`` output shard.
    """
    return _ulysses(q, k, v, SeqAxis.of_group(group), causal, scale,
                    local_impl, block_q, block_k, window)


def ulysses_attention_sharded(q, k, v, mesh, causal=True, scale=None,
                              axis_name="seq", local_impl="flash",
                              block_q=1024, block_k=1024, window=0):
    """:func:`ulysses_attention` over ``mesh``'s ``axis_name`` line, each
    rank passing its shard."""
    return _ulysses(q, k, v, SeqAxis.of_mesh(mesh, axis_name), causal,
                    scale, local_impl, block_q, block_k, window)
