"""Mixture-of-Experts routing (port of the JAX package's ``ops/moe.py``).

Top-k routing with capacity (``top_k_gating``: dense one-hot
``[G, E, C]`` dispatch/combine tensors; ``top_k_routing`` +
``dispatch_gather``/``combine_gather``: the same slot assignment as
indices), and the dropless layout (``dropless_topk`` +
``dropless_layout`` + ``dispatch_sorted``/``combine_sorted``): tokens
sorted by expert into runs that start at multiples of the row tile
``bm``, the layout the grouped-matmul kernels of :mod:`.gmm` read.

Plain PyTorch, no kernel.  Signatures and return tuples are the
reference's.  Ties break as the reference breaks them: ``argmax`` takes
the first maximum, the top-k of :func:`dropless_topk` is a stable
descending sort (ties to the lower expert index), the layout's sort is
stable.  Nothing here synchronises with the host: counts are
``scatter_add_`` sums (CUDA's ``bincount`` reads its maximum back to the
host), one-hot tensors are comparisons, and every shape is static.
"""

from typing import NamedTuple

import torch


def _one_hot(idx, n):
    """``[..., n]`` f32 one-hot of ``idx`` (no host synchronisation)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _router_probs_and_aux(router_logits, rng, jitter_eps):
    """Shared routing head: optional multiplicative logit jitter
    (uniform in ``[1 - eps, 1 + eps]`` from the ``torch.Generator``
    ``rng``), f32 softmax, and the Switch load-balance aux loss
    ``E * sum_e f_e * p_e`` (f_e the top-1 fraction, p_e the mean
    probability; differentiable through p)."""
    g, e = router_logits.shape
    if rng is not None and jitter_eps > 0:
        noise = torch.empty(
            router_logits.shape, dtype=router_logits.dtype,
            device=router_logits.device,
        ).uniform_(1.0 - jitter_eps, 1.0 + jitter_eps, generator=rng)
        router_logits = router_logits * noise
    probs = torch.softmax(router_logits.float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    f = _one_hot(top1, e).mean(dim=0)
    p = probs.mean(dim=0)
    aux_loss = e * torch.sum(f * p)
    return probs, aux_loss


def _choice_positions(onehot, choice, used):
    """Each token's position in its chosen expert's queue: tokens ahead
    of it with the same choice, after the slots earlier rounds used."""
    pos_within = torch.cumsum(onehot, dim=0) - onehot
    return (pos_within * onehot).sum(dim=-1).to(torch.int32) + used[choice]


def top_k_gating(router_logits, num_experts, capacity, k=2, rng=None,
                 jitter_eps=0.0):
    """Dense dispatch/combine tensors for top-k routing.

    Returns ``(dispatch [G, E, C] f32, combine [G, E, C] f32, aux_loss)``;
    experts fill in priority order (k-th choices take only the slots
    earlier choices left), tokens over capacity are dropped, and
    ``combine`` is renormalised over the gates a token landed.
    """
    g, e = router_logits.shape
    probs, aux_loss = _router_probs_and_aux(router_logits, rng, jitter_eps)
    dev = router_logits.device
    dispatch = torch.zeros((g, e, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros((g, e, capacity), dtype=torch.float32, device=dev)
    remaining = probs
    used = torch.zeros((e,), dtype=torch.int32, device=dev)
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)
        gate = torch.gather(remaining, 1, choice[:, None])[:, 0]
        onehot = _one_hot(choice, e)
        pos = _choice_positions(onehot, choice, used)
        fits = pos < capacity
        slot = pos.clamp(0, capacity - 1)
        mask = (fits[:, None, None].float() * onehot[..., None]
                * _one_hot(slot, capacity)[:, None, :])
        dispatch = dispatch + mask
        combine = combine + mask * gate[:, None, None]
        used = used + (onehot * fits[:, None].float()).sum(dim=0).to(
            torch.int32)
        remaining = remaining * (1.0 - onehot)
    denom = combine.sum(dim=(1, 2), keepdim=True)
    combine = combine / denom.clamp_min(1e-9)
    return dispatch, combine, aux_loss


def top_k_routing(router_logits, num_experts, capacity, k=2, rng=None,
                  jitter_eps=0.0):
    """:func:`top_k_gating`'s slot assignment as per-token indices.

    Returns ``(experts [G,k] i32, slots [G,k] i32, gates [G,k] f32 (0
    where dropped; renormalised over landed choices), aux_loss)``.
    """
    g, e = router_logits.shape
    probs, aux_loss = _router_probs_and_aux(router_logits, rng, jitter_eps)
    remaining = probs
    used = torch.zeros((e,), dtype=torch.int32, device=router_logits.device)
    experts, slots, gates = [], [], []
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)
        gate = torch.gather(remaining, 1, choice[:, None])[:, 0]
        onehot = _one_hot(choice, e)
        pos = _choice_positions(onehot, choice, used)
        fits = pos < capacity
        experts.append(choice.to(torch.int32))
        slots.append(pos.clamp(0, capacity - 1))
        gates.append(gate * fits.float())
        used = used + (onehot * fits[:, None].float()).sum(dim=0).to(
            torch.int32)
        remaining = remaining * (1.0 - onehot)
    experts = torch.stack(experts, dim=1)
    slots = torch.stack(slots, dim=1)
    gates = torch.stack(gates, dim=1)
    gates = gates / gates.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return experts, slots, gates, aux_loss


def dispatch_gather(x, experts, slots, gates, num_experts, capacity):
    """Expert batches ``[E, C, D]`` from ``x [G, D]`` with one row gather
    through the inverse slot -> token map; dropped and unfilled slots
    read a zero row."""
    g, d = x.shape
    k = experts.shape[1]
    flat = (experts.long() * capacity + slots.long()).reshape(-1)
    valid = (gates > 0.0).reshape(-1)
    # invalid entries park on a dummy slot that is trimmed; valid
    # (expert, slot) pairs are unique by construction
    flat = torch.where(valid, flat, torch.full_like(flat,
                                                    num_experts * capacity))
    token_ids = torch.arange(g, device=x.device)[:, None].expand(g, k)
    slot_token = torch.full((num_experts * capacity + 1,), g,
                            dtype=torch.int64, device=x.device)
    slot_token[flat] = token_ids.reshape(-1)
    xpad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    return xpad[slot_token[:-1]].reshape(num_experts, capacity, d)


def combine_gather(ye, experts, slots, gates, out_dtype=None):
    """Expert outputs back to token order: ``y[g] = sum_k gate *
    ye[expert, slot]``."""
    e, c, d = ye.shape
    flat = experts.long() * c + slots.long()
    rows = ye.reshape(e * c, d)[flat]
    y = (rows * gates[..., None].to(ye.dtype)).sum(dim=1)
    return y if out_dtype is None else y.to(out_dtype)


class DroplessLayout(NamedTuple):
    """Group-aligned sorted token layout for the grouped matmul
    (:mod:`.gmm`): ``NP`` rows, tokens sorted by expert, each expert's
    run padded to a multiple of the row tile ``bm``."""

    #: [NP] i32: slot -> source token row (sentinel G = the zero row)
    slot_token: torch.Tensor
    #: [G, k] i32: (token, choice) -> slot in the sorted layout
    dest: torch.Tensor
    #: [T] i32: row tile -> owning expert (non-decreasing)
    tile_expert: torch.Tensor


def dropless_topk(router_logits, k=2, rng=None, jitter_eps=0.0):
    """Top-k expert choice without capacity: nothing is dropped.

    Returns ``(experts [G,k] i32, gates [G,k] f32 renormalised over the
    k choices, aux_loss)``.  The k largest probabilities come from a
    stable descending sort, so equal probabilities go to the lower
    expert index first (``jax.lax.top_k``'s order).
    """
    probs, aux_loss = _router_probs_and_aux(router_logits, rng, jitter_eps)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[:, :k], idx[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return experts.to(torch.int32), gates, aux_loss


def _exclusive_cumsum(v):
    return torch.cat([v.new_zeros(1), torch.cumsum(v, 0)[:-1]])


def expert_counts(experts, num_experts):
    """``[E]`` int64: the (token, choice) pairs routed to each expert of
    ``experts [G, k]``, which are the live rows of the expert's run in
    :func:`dropless_layout` (the grouped matmul's ``group_sizes``)."""
    ef = experts.reshape(-1).long()
    return torch.zeros((num_experts,), dtype=torch.int64,
                       device=experts.device).scatter_add_(
                           0, ef, torch.ones_like(ef))


def dropless_layout(experts, num_experts, bm=256):
    """The sorted, tile-aligned layout for ``experts [G, k]``.

    Each expert's tokens occupy a contiguous run starting at a multiple
    of ``bm``; runs are ordered by expert id.  The static size ``NP =
    round_up(G*k, bm) + num_experts*bm`` bounds any split; pad slots
    point at the sentinel zero row and tail tiles are clamped to the
    last expert (their rows are zero).
    """
    g, k = experts.shape
    n = g * k
    dev = experts.device
    ef = experts.reshape(-1).long()
    counts = expert_counts(experts, num_experts)
    padded = (counts + bm - 1) // bm * bm
    starts = _exclusive_cumsum(padded)
    unaligned = _exclusive_cumsum(counts)
    order = torch.argsort(ef, stable=True)
    sorted_e = ef[order]
    rank_sorted = torch.arange(n, device=dev) - unaligned[sorted_e]
    dest_flat = torch.empty((n,), dtype=torch.int64, device=dev)
    dest_flat[order] = starts[sorted_e] + rank_sorted
    np_rows = (n + bm - 1) // bm * bm + num_experts * bm
    t = np_rows // bm
    ends = starts + padded
    tile_expert = torch.searchsorted(
        ends, torch.arange(t, device=dev) * bm, right=True,
    ).clamp(0, num_experts - 1)
    token_ids = torch.arange(g, device=dev)[:, None].expand(g, k).reshape(-1)
    slot_token = torch.full((np_rows,), g, dtype=torch.int64, device=dev)
    slot_token[dest_flat] = token_ids
    return DroplessLayout(
        slot_token=slot_token.to(torch.int32),
        dest=dest_flat.reshape(g, k).to(torch.int32),
        tile_expert=tile_expert.to(torch.int32),
    )


def dispatch_sorted(x, layout):
    """``x [G, D]`` gathered into the sorted layout ``[NP, D]`` (pad
    slots read a zero row).  Its backward is a scatter-add, whose order
    of addition on CUDA varies from run to run."""
    g, d = x.shape
    xpad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    return xpad[layout.slot_token.long()]


def combine_sorted(ys, layout, gates, out_dtype=None):
    """Sorted expert outputs back to token order:
    ``y[g] = sum_k gates[g,k] * ys[dest[g,k]]``."""
    rows = ys[layout.dest.long()]
    y = (rows * gates[..., None].to(ys.dtype)).sum(dim=1)
    return y if out_dtype is None else y.to(out_dtype)


def expert_capacity(num_tokens, num_experts, capacity_factor=1.25, k=2):
    """``ceil(k * G / E * factor)``, rounded up to a multiple of 8 (the
    reference's formula, kept so capacities match)."""
    cap = int(num_tokens * k * capacity_factor / num_experts) + 1
    return ((cap + 7) // 8) * 8
