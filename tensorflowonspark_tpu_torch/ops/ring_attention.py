"""Ring attention: sequence parallelism over a process group (port of
the JAX package's ``ops/ring_attention.py``).

Each rank holds a ``[B, S_local, H, D]`` shard of q/k/v, the ranks of
its ``seq`` line in sequence order.  The kv shard rotates around the
ring while every rank folds attention of its resident queries against
each visiting chunk into a running output.  A hop is one
``dist.batch_isend_irecv`` pair (send to the next rank, receive from the
previous one) that every rank issues in the same order; the next hop is
in flight while the current chunk computes.

Two inner steps, as in the reference:

- ``impl="flash"`` (default): each visiting chunk runs the flash kernels
  through :func:`.flash_attention._fwd_core` (K2, its partial output in
  f32 straight from the accumulator, and its lse) and, in the
  hand-written backward ring, :func:`.flash_attention._bwd_core` (K3 and
  K4, driven by the ring-global lse and delta).  The dK/dV accumulators
  travel with their kv chunks and are home after P hops.  A chunk's
  branch is static per ring distance (:func:`hop_branch`): a future chunk
  is skipped, the resident one is causal, a past one full; under a
  window the chunk at distance ``m`` is causal at ``q_offset = m *
  S_local`` and chunks behind the horizon are skipped.
- ``impl="dense"``: the online-softmax einsum step over global
  positions, differentiated by autograd through a rotation whose
  backward counter-rotates (the plain version of the flash ring).

:func:`chunk_forward`, :func:`chunk_grads`, :func:`merge_partial` and
:func:`hop_branch` are the per-hop pieces, callable on their own.
"""

import torch

from tensorflowonspark_tpu_torch.ops.flash_attention import (
    _bwd_core,
    _delta,
    _fwd_core,
    flash_supported,
)

NEG_INF = -1e30


class SeqAxis(object):
    """A ring of ranks: ``size``, this rank's ``index`` on it, the global
    ranks of its ``next`` and ``prev`` neighbours and the process
    ``group`` (``None``: the default group)."""

    def __init__(self, size, index, group=None, ranks=None):
        self.size, self.index, self.group = size, index, group
        ranks = list(range(size)) if ranks is None else list(ranks)
        self.ranks = ranks
        self.next = ranks[(index + 1) % size]
        self.prev = ranks[(index - 1) % size]

    @classmethod
    def of_group(cls, group=None):
        """The ring of ``group``'s ranks (``None``: the default group, or a
        ring of one when no process group is initialised)."""
        import torch.distributed as dist

        if group is None and not (dist.is_available()
                                  and dist.is_initialized()):
            return cls(1, 0)
        size = dist.get_world_size(group)
        ranks = [dist.get_global_rank(group or dist.group.WORLD, i)
                 for i in range(size)]
        return cls(size, dist.get_rank(group), group, ranks)

    @classmethod
    def of_mesh(cls, mesh, axis_name):
        """This rank's line of ``mesh`` along ``axis_name``."""
        if mesh.axis_size(axis_name) == 1:
            return cls(1, 0)
        return cls(mesh.axis_size(axis_name), mesh.axis_index(axis_name),
                   mesh.group(axis_name), mesh.line(axis_name))

    def start_hop(self, tensors, reverse=False, tag=0):
        """Send each tensor to the next rank and receive its like from the
        previous one (``reverse``: the other way round); returns the
        pending ``(requests, buffers)``.  Tensor ``i`` travels under tag
        ``tag + i``, so hops in flight together never match each other's
        messages."""
        import torch.distributed as dist

        dst, src = (self.prev, self.next) if reverse else (self.next,
                                                            self.prev)
        tensors = [x.contiguous() for x in tensors]
        bufs = [torch.empty_like(x) for x in tensors]
        ops = []
        for i, (x, buf) in enumerate(zip(tensors, bufs)):
            ops.append(dist.P2POp(dist.isend, x, dst, self.group, tag + i))
            ops.append(dist.P2POp(dist.irecv, buf, src, self.group,
                                  tag + i))
        return dist.batch_isend_irecv(ops), bufs

    @staticmethod
    def finish_hop(pending):
        reqs, bufs = pending
        for req in reqs:
            req.wait()
        return tuple(bufs)

    def hop(self, tensors, reverse=False, tag=0):
        if self.size == 1:
            return tuple(tensors)
        return self.finish_hop(self.start_hop(tensors, reverse, tag))


def _window_reach(window, s_local, p):
    """Largest ring distance with any visibility under the horizon: the
    chunk at distance m spans offsets [m*S_l - S_l + 1, m*S_l + S_l - 1]
    behind the query; entirely out once m*S_l >= window + S_l - 1."""
    return min(p - 1, (window + s_local - 2) // s_local)


def hop_branch(my_idx, t, p, causal, window, s_local):
    """What rank ``my_idx`` of ``p`` computes at hop ``t`` (the chunk of
    rank ``(my_idx - t) % p``): ``None`` to skip it, else ``(causal,
    q_offset)`` of its chunk (the reference's ``_causal_branch`` and
    ``_window_branch``)."""
    src = (my_idx - t) % p
    if causal and window:
        if src > my_idx or t > _window_reach(window, s_local, p):
            return None  # a future chunk, or behind the horizon
        return True, t * s_local
    if causal:
        if src > my_idx:
            return None
        return (True, 0) if src == my_idx else (False, 0)
    return False, 0


def _per_row(x):
    """``[B, H, S]`` -> ``[B, S, H, 1]``, to scale ``[B, S, H, D]`` rows."""
    return x.transpose(1, 2)[..., None]


def merge_partial(o, lse, o_c, lse_c):
    """Fold a chunk's normalized partial ``(o_c, lse_c)`` into the running
    ``(o, lse)``: o ``[B, S, H, D]`` f32, lse ``[B, H, S]`` f32."""
    m = torch.maximum(lse, lse_c)
    w = torch.exp(lse - m)
    w_c = torch.exp(lse_c - m)
    tot = w + w_c
    return (o * _per_row(w / tot) + o_c * _per_row(w_c / tot),
            m + torch.log(tot))


def chunk_forward(q, k, v, scale, branch, window=0):
    """One hop of the forward ring: ``(o_c f32, lse_c)`` of the resident
    queries against the visiting chunk ``k, v`` on ``branch`` (from
    :func:`hop_branch`)."""
    causal, q_offset = branch
    return _fwd_core(q, k, v, scale, causal, out_dtype=torch.float32,
                     window=window if causal else 0, q_offset=q_offset)


def chunk_grads(q, k, v, dout, lse, delta, scale, branch, window=0):
    """One hop of the backward ring: the f32 ``(dq, dk, dv)`` of the
    visiting chunk from the ring-global ``lse`` and ``delta``."""
    causal, q_offset = branch
    dq, dk, dv = _bwd_core(q, k, v, dout, lse, delta, scale, causal,
                           window=window if causal else 0,
                           q_offset=q_offset)
    return dq.float(), dk.float(), dv.float()


class _RingFlash(torch.autograd.Function):
    """The reference's ``_ring_flash`` custom VJP: a forward ring of
    :func:`chunk_forward` and a backward ring of :func:`chunk_grads`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, axis):
        b, s_local, h, d = q.shape
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                         device=q.device)
        kv = (k, v)
        for t in range(axis.size):
            pending = axis.start_hop(kv) if t + 1 < axis.size else None
            branch = hop_branch(axis.index, t, axis.size, causal, window,
                                s_local)
            if branch is not None:
                o_c, lse_c = chunk_forward(q, *kv, scale, branch, window)
                o, lse = merge_partial(o, lse, o_c, lse_c)
            if pending is not None:
                kv = axis.finish_hop(pending)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, axis)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window, axis = ctx.args
        s_local = q.shape[1]
        # loop-invariant softmax-jacobian correction, computed once
        delta = _delta(out, dout)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kv = (k, v)
        for t in range(axis.size):
            pending = axis.start_hop(kv) if t + 1 < axis.size else None
            branch = hop_branch(axis.index, t, axis.size, causal, window,
                                s_local)
            if branch is not None:
                dq_c, dk_c, dv_c = chunk_grads(q, *kv, dout, lse, delta,
                                               scale, branch, window)
                dq += dq_c
                dk += dk_c
                dv += dv_c
            # the accumulators travel with their chunk: home after P hops
            # (tags 2, 3: the kv hop may still be in flight)
            dk, dv = axis.hop((dk, dv), tag=2)
            if pending is not None:
                kv = axis.finish_hop(pending)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


class _Rotate(torch.autograd.Function):
    """One hop of tensors to the next rank; the gradient hops back."""

    @staticmethod
    def forward(ctx, axis, *tensors):
        ctx.axis = axis
        return axis.hop(tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None,) + ctx.axis.hop(grads, reverse=True)


def _ring_dense(q, k, v, causal=True, scale=None, axis=None, window=0):
    """Plain version of the ring: the online-softmax einsum step over
    global positions (``rank * S_local + local``), materialising the
    ``[B, S_local, H, S_local]`` logits per chunk; autograd
    differentiates it, the rotation's gradient counter-rotating."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    axis = axis or SeqAxis(1, 0)
    p, my_idx = axis.size, axis.index
    b, s_local, h, d = q.shape
    if k.shape[2] != h:
        # grouped kv: the dense einsums want matching head counts
        k = k.repeat_interleave(h // k.shape[2], dim=2)
        v = v.repeat_interleave(h // v.shape[2], dim=2)
    qf = q.float()
    m = torch.full((b, s_local, h), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, s_local, h, d), dtype=torch.float32,
                      device=q.device)
    local = torch.arange(s_local, device=q.device)
    qpos = my_idx * s_local + local
    k_cur, v_cur = k, v
    for t in range(p):
        kpos = ((my_idx - t) % p) * s_local + local
        logits = torch.einsum("bqhd,bkhd->bqhk", qf, k_cur.float()) * scale
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            logits = torch.where(mask[None, :, None, :], logits,
                                 torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        prob = torch.exp(logits - m_new[..., None])
        l = l * alpha + prob.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", prob, v_cur.float())
        m = m_new
        if t + 1 < p:
            k_cur, v_cur = _Rotate.apply(axis, k_cur, v_cur)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _check(q, k, causal, window):
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(
            "query heads ({0}) must be a multiple of kv heads "
            "({1})".format(q.shape[2], k.shape[2])
        )
    if window:
        if window < 0:
            raise ValueError(
                "window must be positive, got {0}".format(window)
            )
        if not causal:
            raise ValueError("window attention requires causal=True")


def _ring(q, k, v, axis, causal, scale, impl, block_q, block_k, window):
    _check(q, k, causal, window)
    if impl == "flash":
        s_val = scale if scale is not None else q.shape[-1] ** -0.5
        if flash_supported(s_val, q.shape[1], block_q, block_k):
            return _RingFlash.apply(q, k, v, float(s_val), bool(causal),
                                    int(window), axis)
        if q.device.type == "cuda":
            raise ValueError(
                "flash ring attention refuses shard length {0} with scale "
                "{1!r} (block_q={2}, block_k={3}); pad the sequence, pass "
                "block sizes that tile it, or ask for impl=\"dense\"".format(
                    q.shape[1], s_val, block_q, block_k)
            )
        # CPU tensors: the dense step, as the reference's shape rule does
        impl = "dense"
    if impl == "dense":
        return _ring_dense(q, k, v, causal=causal, scale=scale, axis=axis,
                           window=window)
    raise ValueError(
        "unknown ring attention impl {0!r}; options: flash, dense".format(
            impl)
    )


def ring_attention(q, k, v, causal=True, scale=None, group=None,
                   impl="flash", block_q=1024, block_k=1024, window=0):
    """Attention over sequence shards around the ranks of ``group``.

    Args:
      q, k, v: this rank's ``[B, S_local, H, D]`` shards (k/v may carry
        ``Hkv`` heads) of a global ``[B, S, H, D]`` sequence split over
        the group's ranks in rank order.
      group: the ``seq`` process group (the reference's ``axis_name``);
        ``None`` is the default group, or a ring of one when no process
        group is initialised.
      impl: ``"flash"`` (K2-K4 per hop) or ``"dense"`` (plain einsums).
        Where the flash tiling rule refuses the shard length (or
        ``scale`` is a tensor), ``"flash"`` raises on CUDA tensors and
        takes the dense step on CPU ones (the reference's shape rule).
      window: sliding-window horizon (requires ``causal``); hops entirely
        behind it are skipped.
    Returns this rank's ``[B, S_local, H, D]`` output shard.
    """
    return _ring(q, k, v, SeqAxis.of_group(group), causal, scale, impl,
                 block_q, block_k, window)


def ring_attention_sharded(q, k, v, mesh, causal=True, scale=None,
                           axis_name="seq", impl="flash", block_q=1024,
                           block_k=1024, window=0):
    """:func:`ring_attention` over ``mesh``'s ``axis_name`` line.  Each
    rank passes its shard: the batch rows of its data coordinate, the
    sequence slice of its ``axis_name`` coordinate."""
    return _ring(q, k, v, SeqAxis.of_mesh(mesh, axis_name), causal, scale,
                 impl, block_q, block_k, window)
