"""Mixture-of-Experts feed-forward layer (port of the JAX package's
``models/moe.py``).

Expert weights are stacked ``[E, ...]``: ``router [D, E]`` (f32, the
router runs in f32), ``wi``/``wg [E, D, M]`` and ``wo [E, M, D]``, the
Flax tree's layouts as they are.  ``dispatch="dropless"`` sorts the
tokens by expert into the tile-aligned layout and multiplies with
:func:`~..ops.gmm.grouped_matmul` (the K5-K7 kernels on the GPU);
``"gather"`` and ``"einsum"`` route with capacity and multiply with
``einsum`` (plain PyTorch).

The reference sows the load-balancing aux loss into a ``"losses"``
collection; here :meth:`MoEMLP.forward` returns it beside the output
(and the drop rate), the block passes it up, and :func:`moe_loss_fn`
sums what the model returns.  Returning it, rather than recording it on
the module, keeps it counted once when a checkpointed block re-runs its
forward in the backward.
"""

import logging

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_tpu_torch.ops import gmm
from tensorflowonspark_tpu_torch.ops import moe as moe_ops

logger = logging.getLogger(__name__)

#: drop-rate honesty threshold: above this fraction of dropped (token,
#: choice) assignments a throughput number is buying speed with model
#: quality and must say so wherever it is reported
DROP_RATE_WARN = 0.02

DISPATCH_MODES = ("gather", "einsum", "dropless")


def check_drop_rate(drop_rate, capacity_factor=None, where="MoE"):
    """Honesty guard on router capacity overflow: returns a warning
    string (and logs it) when ``drop_rate`` exceeds
    :data:`DROP_RATE_WARN`, else ``None``.  Callers that publish a
    throughput number attach the string to the same record."""
    rate = float(drop_rate)
    if rate <= DROP_RATE_WARN:
        return None
    msg = (
        "%s drop_rate %.1f%% exceeds %.0f%% (capacity_factor=%s): "
        "throughput at this setting silently drops token updates — "
        "raise capacity_factor (e.g. 1.25) or use dispatch='dropless'"
        % (
            where, 100.0 * rate, 100.0 * DROP_RATE_WARN,
            capacity_factor if capacity_factor is not None else "?",
        )
    )
    logger.warning(msg)
    return msg


class MoEMLP(nn.Module):
    """Gated-SiLU expert FFN with top-k routing on ``[B, S, D]``.

    ``forward`` returns ``(y [B, S, D] in x's type, aux_loss, drop_rate)``;
    the aux loss is the Switch load-balancing loss (differentiable), the
    drop rate the fraction of (token, choice) assignments over capacity
    (0 for ``"dropless"``).  Weights are stored in ``param_dtype``
    (default ``dtype``) and cast to ``dtype`` at use; the router is
    always f32.  ``gmm_block_rows`` is the dropless layout's row tile.
    """

    def __init__(self, num_experts, mlp_dim, embed_dim, k=2,
                 capacity_factor=1.25, dtype=torch.bfloat16,
                 dispatch="gather", gmm_block_rows=256, device=None,
                 param_dtype=None):
        super().__init__()
        if dispatch not in DISPATCH_MODES:
            raise ValueError(
                "dispatch must be 'gather', 'einsum', or 'dropless', got "
                "{0!r}".format(dispatch)
            )
        e, m, d = num_experts, mlp_dim, embed_dim
        self.num_experts, self.k = e, k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.dispatch = dispatch
        self.gmm_block_rows = gmm_block_rows
        store = param_dtype or dtype

        def param(*shape, dtype=store):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))

        self.router = param(d, e, dtype=torch.float32)
        self.wi = param(e, d, m)
        self.wg = param(e, d, m)
        self.wo = param(e, m, d)
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters()

    def reset_parameters(self):
        """The reference's initialisers: router ``N(0, 0.02)``, experts
        ``variance_scaling(1.0, "fan_in", "normal")``, whose fan-in on a
        3-D leaf counts the expert axis (std ``(E * D)^-1/2`` for
        ``wi``/``wg``, ``(E * M)^-1/2`` for ``wo``), untruncated."""
        with torch.no_grad():
            nn.init.normal_(self.router, std=0.02)
            for w in (self.wi, self.wg, self.wo):
                nn.init.normal_(w, std=(w.shape[0] * w.shape[1]) ** -0.5)

    def forward(self, x):
        e = self.num_experts
        dtype = self.dtype
        b, s, d = x.shape
        g = b * s
        xf = x.reshape(g, d)
        # router in f32: routing decisions are sensitive to logit precision
        logits = xf.float() @ self.router.float()
        wi, wg, wo = (w.to(dtype) for w in (self.wi, self.wg, self.wo))

        if self.dispatch == "dropless":
            bm = self.gmm_block_rows
            experts, gates, aux = moe_ops.dropless_topk(logits, k=self.k)
            layout = moe_ops.dropless_layout(experts, e, bm=bm)
            xs = moe_ops.dispatch_sorted(xf.to(dtype), layout)
            te = layout.tile_expert
            h = gmm.grouped_matmul(xs, wi, te, bm)
            hg = gmm.grouped_matmul(xs, wg, te, bm)
            ys = gmm.grouped_matmul(F.silu(hg) * h, wo, te, bm)
            y = moe_ops.combine_sorted(ys, layout, gates)
            drop_rate = torch.zeros((), dtype=torch.float32, device=x.device)
            return y.reshape(b, s, d).to(x.dtype), aux, drop_rate

        cap = moe_ops.expert_capacity(
            g, e, capacity_factor=self.capacity_factor, k=self.k
        )
        if self.dispatch == "gather":
            experts, slots, gates, aux = moe_ops.top_k_routing(
                logits, e, cap, k=self.k
            )
            # router probabilities are strictly positive after the
            # softmax, so gate == 0 <=> dropped
            drop_rate = (gates == 0.0).float().mean()
            xe = moe_ops.dispatch_gather(
                xf.to(dtype), experts, slots, gates, e, cap
            )
        else:
            dispatch, combine, aux = moe_ops.top_k_gating(
                logits, e, cap, k=self.k
            )
            drop_rate = 1.0 - dispatch.sum() / (g * self.k)
            xe = torch.einsum("gec,gd->ecd", dispatch.to(dtype),
                              xf.to(dtype))
        h = torch.einsum("ecd,edm->ecm", xe, wi)
        hg = torch.einsum("ecd,edm->ecm", xe, wg)
        ye = torch.einsum("ecm,emd->ecd", F.silu(hg) * h, wo)
        if self.dispatch == "gather":
            y = moe_ops.combine_gather(ye, experts, slots, gates)
        else:
            y = torch.einsum("gec,ecd->gd", combine.to(dtype), ye)
        return y.reshape(b, s, d).to(x.dtype), aux, drop_rate


def moe_loss_fn(model, aux_weight=0.01):
    """Next-token CE + weighted MoE load-balance aux losses.

    Same contract as :func:`~.transformer.loss_fn` (``batch =
    dict(tokens=[B, S])``, ``loss(params, batch, rng)``), returning
    ``(ce + aux_weight * aux, {"ce": ce, "moe_aux": aux})`` with ``aux``
    the sum of every MoE block's aux loss (0 for a dense model).  Use
    with ``SyncTrainer(..., has_aux=True)``.
    """

    def _loss(params, batch, rng):
        tokens = batch["tokens"].to(torch.int64)
        logits, aux_losses = torch.func.functional_call(
            model, params, (tokens,), {"return_aux": True}
        )
        targets = tokens[:, 1:]
        logits = logits[:, :-1].to(torch.float32)
        ce = F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)
        )
        aux = (torch.stack(aux_losses).sum() if aux_losses
               else torch.zeros((), dtype=torch.float32,
                                device=logits.device))
        return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}

    return _loss
