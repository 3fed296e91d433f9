"""The port's MoE training path against the JAX package's, on the CPU in
f32: routing (``ops/moe``), the grouped matmul (``ops/gmm``: the plain
versions of K5-K7 here, the Pallas kernels in interpret mode there),
``MoEMLP`` in its three dispatch modes, a dropless MoE ``Transformer``
with and without remat, ``moe_loss_fn`` and an AdamW trajectory, all
from the same seeded numpy inputs and weights.

The JAX side is initialised from the port's ``init_params_tree`` (the
Flax ``init`` of a dropless model runs the kernels in interpret mode),
and every JAX call that reaches the grouped matmul is jitted once per
module.

Tolerances: routing indices and layouts identical, gates and aux losses
1e-6 (f32 softmax and sums in another order); grouped-matmul outputs and
gradients 1e-5 (f32 products of 16-32 terms); the model's logits 1e-4
(two layers of f32 arithmetic, as the dense model's tests); the AdamW
trajectory rtol/atol 1e-5 over three steps.  An absent expert's dw is 0
exactly, and so are the rows past each expert's count when the grouped
matmul is given the counts (``group_sizes``).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu.models import moe as jmoe  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu.ops import gmm as jgmm  # noqa: E402
from tensorflowonspark_tpu.ops import moe as jops  # noqa: E402
from tensorflowonspark_tpu.parallel import dp as jdp  # noqa: E402
from tensorflowonspark_tpu.parallel.mesh import build_mesh  # noqa: E402
from tensorflowonspark_tpu_torch import convert, optim  # noqa: E402
from tensorflowonspark_tpu_torch.models import moe as tmoe  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.ops import gmm as tgmm  # noqa: E402
from tensorflowonspark_tpu_torch.ops import moe as tops  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import dp  # noqa: E402

G, E, K = 64, 4, 2
MOE = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
           embed_dim=32, mlp_dim=64, max_seq_len=64, dtype="float32",
           num_experts=E, expert_k=K, expert_dispatch="dropless")
B, S, STEPS = 2, 16, 3


def _np(x):
    return np.asarray(x)


def _logits(seed=0, g=G, e=E):
    """Router logits whose top-k choices are separated by more than
    1e-4 (so no comparison can turn on a near-tie)."""
    logits = np.random.default_rng(seed).standard_normal((g, e)).astype(
        np.float32)
    top = np.sort(logits, axis=-1)[:, ::-1]
    assert np.min(top[:, :K] - top[:, 1:K + 1]) > 1e-4
    return logits


# -- routing -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_dropless_topk(k):
    return jax.jit(functools.partial(jops.dropless_topk, k=k))


@pytest.mark.parametrize("name", ["top_k_gating", "top_k_routing"])
@pytest.mark.parametrize("capacity", [8, 40])
def test_capacity_routing_matches_jax(name, capacity):
    logits = _logits(1)
    want = jax.jit(functools.partial(getattr(jops, name), num_experts=E,
                                     capacity=capacity, k=K))(logits)
    got = getattr(tops, name)(torch.tensor(logits), E, capacity, k=K)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        w, g = _np(w), g.numpy()
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    if name == "top_k_routing" and capacity == 8:
        assert (got[2] == 0).any()  # tokens dropped at this capacity


@pytest.mark.parametrize("bm", [8, 16])
def test_dropless_topk_and_layout_match_jax(bm):
    logits = _logits(2)
    want = _jax_dropless_topk(K)(logits)
    got = tops.dropless_topk(torch.tensor(logits), k=K)
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_allclose(got[1].numpy(), _np(want[1]), atol=1e-6)
    np.testing.assert_allclose(got[2].item(), float(want[2]), atol=1e-6)
    lay_j = jax.jit(functools.partial(jops.dropless_layout, num_experts=E,
                                      bm=bm))(want[0])
    lay_t = tops.dropless_layout(got[0], E, bm=bm)
    for name in ("slot_token", "dest", "tile_expert"):
        np.testing.assert_array_equal(getattr(lay_t, name).numpy(),
                                      _np(getattr(lay_j, name)))
        assert getattr(lay_t, name).dtype == torch.int32
    n_rows = (G * K + bm - 1) // bm * bm + E * bm
    assert lay_t.slot_token.shape == (n_rows,)


def test_dropless_topk_breaks_ties_to_the_lower_index():
    # three experts tie at logit 0 behind expert 0 (the rigged router of
    # the JAX package's dropless tests)
    logits = np.zeros((6, E), np.float32)
    logits[:, 0] = np.arange(1, 7)
    want = _jax_dropless_topk(3)(logits)[0]
    got = tops.dropless_topk(torch.tensor(logits), k=3)[0]
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got[:, 1:].tolist() == [[1, 2]] * 6


def _jax_dispatch_combine(x, logits, cap):
    """The reference's gather and sorted dispatch/combine round trips."""
    ex, sl, ga, _ = jops.top_k_routing(logits, E, cap, k=K)
    xe = jops.dispatch_gather(x, ex, sl, ga, E, cap)
    dex, dga, _ = jops.dropless_topk(logits, k=K)
    lay = jops.dropless_layout(dex, E, bm=8)
    xs = jops.dispatch_sorted(x, lay)
    return (xe, jops.combine_gather(xe, ex, sl, ga), xs,
            jops.combine_sorted(xs, lay, dga))


def test_gather_and_sorted_dispatch_combine_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((G, 8)).astype(np.float32)
    logits = _logits(4)
    cap = jops.expert_capacity(G, E, capacity_factor=1.0, k=K)
    assert cap == tops.expert_capacity(G, E, capacity_factor=1.0, k=K)
    want = jax.jit(functools.partial(_jax_dispatch_combine, cap=cap))(
        x, logits)
    tex, tsl, tga, _ = tops.top_k_routing(torch.tensor(logits), E, cap, k=K)
    xe_t = tops.dispatch_gather(torch.tensor(x), tex, tsl, tga, E, cap)
    tdex, tdga, _ = tops.dropless_topk(torch.tensor(logits), k=K)
    lay_t = tops.dropless_layout(tdex, E, bm=8)
    xs_t = tops.dispatch_sorted(torch.tensor(x), lay_t)
    got = (xe_t, tops.combine_gather(xe_t, tex, tsl, tga), xs_t,
           tops.combine_sorted(xs_t, lay_t, tdga))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-6, rtol=0)


# -- grouped matmul ----------------------------------------------------


def _gmm_case(t=6, bm=8, e=3, d=16, f=32, seed=0, absent=1):
    """The JAX package's ``_case`` sizes; expert ``absent`` owns no
    tile."""
    rng = np.random.RandomState(seed)
    x = rng.randn(t * bm, d).astype(np.float32)
    w = (rng.randn(e, d, f) * 0.1).astype(np.float32)
    te = np.sort(rng.randint(0, e, t)).astype(np.int32)
    te[te == absent] = absent - 1 if absent else absent + 1
    te = np.sort(te)
    dy = rng.randn(t * bm, f).astype(np.float32)
    return x, w, te, dy


@functools.lru_cache(maxsize=None)
def _jax_kernels(bm, e):
    return (
        jax.jit(lambda x, w, te: jgmm.gmm_call(x, w, te, bm=bm, bf=16)),
        jax.jit(lambda dy, w, te: jgmm.gmm_dxt_call(dy, w, te, bm=bm)),
        jax.jit(lambda x, dy, te: jgmm.tgmm_call(x, dy, te, e, bm=bm)),
    )


def test_gmm_kernels_match_jax_interpret():
    x, w, te, dy = _gmm_case()
    fwd, dxt, tg = _jax_kernels(8, 3)
    tx, tw, tte, tdy = map(torch.tensor, (x, w, te, dy))
    np.testing.assert_allclose(tgmm.gmm_call(tx, tw, tte, bm=8).numpy(),
                               _np(fwd(x, w, te)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tgmm.gmm_dxt_call(tdy, tw, tte, bm=8).numpy(),
                               _np(dxt(dy, w, te)), atol=1e-5, rtol=0)
    dw = tgmm.tgmm_call(tx, tdy, tte, 3, bm=8)
    np.testing.assert_allclose(dw.numpy(), _np(tg(x, dy, te)), atol=1e-5,
                               rtol=0)
    assert 1 not in te and torch.count_nonzero(dw[1]) == 0
    np.testing.assert_array_equal(
        tgmm.gmm_reference(tx, tw, tte, bm=8).numpy(),
        tgmm.gmm_call(tx, tw, tte, bm=8).numpy())


def test_grouped_matmul_gradients_match_jax():
    x, w, te, dy = _gmm_case(seed=1, absent=2)

    def loss_j(x, w):
        return jnp.sum(jgmm.grouped_matmul(x, w, jnp.asarray(te), 8, 16)
                       * dy)

    want = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(x, w)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y = tgmm.grouped_matmul(tx, tw, torch.tensor(te), 8, 16)
    got = torch.autograd.grad((y * torch.tensor(dy)).sum(), (tx, tw))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w_), atol=1e-5, rtol=0)
    assert torch.count_nonzero(got[1][2]) == 0


def test_tgmm_rounds_once_to_bf16():
    """bf16 operands: dw is the f32 sum over the whole run rounded once
    to bf16 (within half a bf16 ulp of the exact sum, which rounding
    each tile's part first would not keep), and within one bf16 ulp of
    the JAX kernel's."""
    x, w, te, dy = _gmm_case(seed=2, absent=0)
    xb = torch.tensor(x).to(torch.bfloat16)
    dyb = torch.tensor(dy).to(torch.bfloat16)
    dw = tgmm.tgmm_call(xb, dyb, torch.tensor(te), 3, bm=8)
    assert dw.dtype == torch.bfloat16
    exact = torch.zeros((3, 16, 32), dtype=torch.float64)
    parts = torch.einsum("tbd,tbf->tdf", xb.double().reshape(6, 8, 16),
                         dyb.double().reshape(6, 8, 32))
    exact.index_add_(0, torch.tensor(te).long(), parts)
    ulp = torch.tensor(np.spacing(exact.abs().to(torch.bfloat16).float()
                                  .numpy().astype(np.float32)) * 2 ** 16)
    err = (dw.double() - exact).abs()
    assert bool((err <= 0.5 * ulp.double() + 1e-6 * exact.abs()).all())
    per_tile = torch.zeros((3, 16, 32), dtype=torch.bfloat16)
    per_tile.index_add_(0, torch.tensor(te).long(), parts.to(torch.bfloat16))
    assert not torch.equal(per_tile, dw)
    want = jax.jit(lambda a, b, t: jgmm.tgmm_call(a, b, t, 3, bm=8))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16),
        jnp.asarray(te))
    want = torch.tensor(_np(want.astype(jnp.float32)))
    assert bool(((dw.float() - want).abs() <= ulp).all())
    assert torch.count_nonzero(dw[0]) == 0


def test_gmm_call_validates_layout_and_keeps_the_signature():
    x, w, te, dy = _gmm_case()
    tx, tw, tte = map(torch.tensor, (x, w, te))
    with pytest.raises(ValueError, match="bm"):
        tgmm.gmm_call(tx[:-1], tw, tte, bm=8)
    with pytest.raises(ValueError, match="tile_expert"):
        tgmm.gmm_call(tx, tw, tte[:-1], bm=8)
    with pytest.raises(ValueError, match="disagree"):
        tgmm.gmm_call(tx, tw[:, :8], tte, bm=8)
    # bf/bd are TPU stripe widths: accepted, no effect; dxt never None
    a = tgmm.gmm_dxt_call(torch.tensor(dy), tw, tte, bm=8, bd=128)
    assert a is not None and torch.equal(
        a, tgmm.gmm_dxt_call(torch.tensor(dy), tw, tte, bm=8))
    assert torch.equal(tgmm.gmm_call(tx, tw, tte, bm=8, bf=16),
                       tgmm.gmm_call(tx, tw, tte, bm=8))
    assert tgmm.grouped_matmul.launches == {"gmm": 0, "gmm_dxt": 0,
                                            "tgmm": 0}


# -- the live rows of each expert's run (group_sizes) ------------------

G_C = 200


def _counts_case(bm, seed=20, d=16, f=32):
    """A dropless layout at row tile ``bm`` from a router that favours
    expert 0 and never picks expert 2, the experts' routed rows as
    ``group_sizes``, and operands whose pad rows are random, so the zeros
    past the counts can only come from the counts."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((G_C, E)).astype(np.float32)
    logits[:, 0] += 2.0
    logits[:, 2] = -1e4
    experts, _, _ = tops.dropless_topk(torch.tensor(logits), k=K)
    layout = tops.dropless_layout(experts, E, bm=bm)
    sizes = tops.expert_counts(experts, E).to(torch.int32)
    n = layout.slot_token.shape[0]
    x = rng.standard_normal((n, d)).astype(np.float32)
    dy = rng.standard_normal((n, f)).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) * 0.1).astype(np.float32)
    live = (layout.slot_token < G_C).numpy()
    return x, w, dy, layout.tile_expert, sizes, live


@pytest.mark.parametrize("bm", [128, 256])
def test_plain_gmm_with_group_sizes_matches_jax_on_live_rows(bm):
    """With ``group_sizes``, K5's and K6's plain versions equal the JAX
    kernels (interpret mode, every row computed) on the live rows and
    are exactly 0 on every other row, on a layout with a heavy and an
    absent expert."""
    x, w, dy, te, sizes, live = _counts_case(bm)
    assert sizes[2] == 0 and sizes[0] == sizes.max()
    assert int(sizes.sum()) == G_C * K
    assert torch.equal(tgmm.live_row_mask(te, sizes, bm)[:, 0],
                       torch.from_numpy(live))
    fwd, dxt, _ = _jax_kernels(bm, E)
    te_np = te.numpy()
    got = (tgmm.gmm_call(torch.tensor(x), torch.tensor(w), te, bm=bm,
                         group_sizes=sizes),
           tgmm.gmm_dxt_call(torch.tensor(dy), torch.tensor(w), te, bm=bm,
                             group_sizes=sizes))
    for g, want in zip(got, (fwd(x, w, te_np), dxt(dy, w, te_np))):
        g, want = g.numpy(), _np(want)
        np.testing.assert_allclose(g[live], want[live], atol=1e-5, rtol=0)
        assert not g[~live].any()
        assert want[~live].any()  # the reference multiplies the pad rows


def test_grouped_matmul_gradients_with_group_sizes_match_jax():
    """On the layout's own terms (zero pad rows in x, and a cotangent that
    is 0 on them, as ``combine_sorted``'s backward gives) the gradients
    with ``group_sizes`` are the reference VJP's; y and dx are exactly 0
    past the counts, even under a cotangent that is not."""
    bm = 128
    x, w, dy, te, sizes, live = _counts_case(bm, seed=21)
    x = x * live[:, None]
    dy = dy * live[:, None]
    te_j = jnp.asarray(te.numpy())

    def loss_j(x, w):
        return jnp.sum(jgmm.grouped_matmul(x, w, te_j, bm, 16) * dy)

    want = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(x, w)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y = tgmm.grouped_matmul(tx, tw, te, bm, 16, group_sizes=sizes)
    got = torch.autograd.grad((y * torch.tensor(dy)).sum(), (tx, tw))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w_), atol=1e-5, rtol=0)
    assert torch.count_nonzero(got[1][2]) == 0
    y = tgmm.grouped_matmul(tx, tw, te, bm, group_sizes=sizes)
    dx = torch.autograd.grad(y.sum(), tx)[0].numpy()
    assert not y.detach().numpy()[~live].any()
    assert not dx[~live].any() and dx[live].all()


def test_group_sizes_are_validated():
    x, w, dy, te, sizes, _ = _counts_case(128)
    tx, tw = torch.tensor(x), torch.tensor(w)
    for bad in (sizes.long(), sizes[:-1]):
        with pytest.raises(ValueError, match="group_sizes"):
            tgmm.gmm_call(tx, tw, te, bm=128, group_sizes=bad)
        with pytest.raises(ValueError, match="group_sizes"):
            tgmm.gmm_dxt_call(torch.tensor(dy), tw, te, bm=128,
                              group_sizes=bad)
    assert torch.equal(
        tgmm.gmm_plain(tx, tw, te, bm=128),
        tgmm.gmm_call(tx, tw, te, bm=128, group_sizes=None))


def test_moe_mlp_passes_the_layout_live_rows_as_group_sizes(monkeypatch):
    """The dropless ``MoEMLP`` gives each of its three grouped matmuls
    the routed rows of every expert, and those name exactly the rows of
    the layout that hold a token."""
    params = _mlp_params()
    x = torch.tensor(np.random.default_rng(22).standard_normal(
        (2, 16, 16)).astype(np.float32))
    seen = []
    grouped_matmul = tgmm.grouped_matmul

    def spy(xs, w, te, bm, bf=None, group_sizes=None):
        seen.append((te, group_sizes))
        return grouped_matmul(xs, w, te, bm, bf, group_sizes=group_sizes)

    monkeypatch.setattr(tmoe.gmm, "grouped_matmul", spy)
    mine = tmoe.MoEMLP(E, 32, 16, k=K, dtype=torch.float32,
                       dispatch="dropless", gmm_block_rows=8, device="cpu")
    mine.load_state_dict({n: torch.tensor(v) for n, v in params.items()})
    mine(x)
    experts, _, _ = tops.dropless_topk(x.reshape(-1, 16) @ mine.router,
                                       k=K)
    layout = tops.dropless_layout(experts, E, bm=8)
    live = layout.slot_token < x.shape[0] * x.shape[1]
    assert len(seen) == 3
    for te, sizes in seen:
        assert sizes.dtype == torch.int32
        assert torch.equal(te, layout.tile_expert)
        assert torch.equal(sizes.long(), torch.bincount(
            experts.reshape(-1).long(), minlength=E))
        assert torch.equal(tgmm.live_row_mask(te, sizes, 8)[:, 0], live)


# -- MoEMLP ------------------------------------------------------------


def _mlp_params(d=16, m=32, e=E, seed=5):
    rng = np.random.default_rng(seed)
    return {
        "router": (rng.standard_normal((d, e)) * 0.5).astype(np.float32),
        "wi": (rng.standard_normal((e, d, m)) * 0.2).astype(np.float32),
        "wg": (rng.standard_normal((e, d, m)) * 0.2).astype(np.float32),
        "wo": (rng.standard_normal((e, m, d)) * 0.2).astype(np.float32),
    }


@pytest.mark.parametrize("dispatch", ["gather", "einsum", "dropless"])
def test_moe_mlp_matches_jax(dispatch):
    params = _mlp_params()
    x = np.random.default_rng(6).standard_normal((2, 16, 16)).astype(
        np.float32)
    kw = dict(num_experts=E, mlp_dim=32, embed_dim=16, k=K,
              capacity_factor=0.5, dtype="float32", dispatch=dispatch,
              gmm_block_rows=8)
    layer = jmoe.MoEMLP(**kw)
    apply = jax.jit(functools.partial(layer.apply,
                                      mutable=["losses", "moe_stats"]))
    want, col = apply({"params": jax.tree.map(jnp.asarray, params)}, x)
    mine = tmoe.MoEMLP(E, 32, 16, k=K, capacity_factor=0.5,
                       dtype=torch.float32, dispatch=dispatch,
                       gmm_block_rows=8, device="cpu")
    mine.load_state_dict({n: torch.tensor(v) for n, v in params.items()})
    y, aux, drop = mine(torch.tensor(x))
    np.testing.assert_allclose(y.detach().numpy(), _np(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(aux.item(),
                               float(col["losses"]["moe_aux"][0]), atol=1e-6)
    np.testing.assert_allclose(drop.item(),
                               float(col["moe_stats"]["drop_rate"][0]),
                               atol=1e-6)
    assert aux.requires_grad
    if dispatch != "dropless":
        assert drop.item() > 0  # capacity 0.5 drops some assignments


def test_moe_mlp_rejects_unknown_dispatch_and_checks_drop_rate():
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.MoEMLP(E, 8, 8, dispatch="dense", device="cpu")
    assert tmoe.check_drop_rate(0.01) is None
    assert tmoe.check_drop_rate(torch.tensor(0.05),
                                capacity_factor=1.0) is not None
    assert tmoe.DROP_RATE_WARN == jmoe.DROP_RATE_WARN


# -- the model, its loss and a training trajectory ---------------------


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """The JAX dropless model over the port's tree and one jitted
    function of its logits and its moe_loss_fn value-and-grad."""
    cfg = ttr.TransformerConfig(**MOE)
    tree = convert.init_params_tree(cfg, seed=7)
    model = jtr.Transformer(jtr.TransformerConfig(**MOE))
    params = jax.tree.map(jnp.asarray, tree)
    loss = jmoe.moe_loss_fn(model)
    vg = jax.value_and_grad(lambda p, t: loss(p, {"tokens": t}, None),
                            has_aux=True)
    run = jax.jit(lambda p, t: (model.apply({"params": p}, t), vg(p, t)))
    return tree, model, params, run


@functools.lru_cache(maxsize=None)
def _jax_run(seed):
    _, _, params, run = _jax_setup()
    return run(params, _tokens(seed))


def _tokens(seed=8, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, MOE["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("remat", [None, "block", "dots"])
def test_moe_transformer_logits_loss_and_grads_match_jax(remat):
    tree = _jax_setup()[0]
    tokens = _tokens()
    want_logits, ((want_loss, want_aux), want_grads) = _jax_run(8)
    cfg = dict(MOE, remat=remat is not None, remat_policy=remat or "block")
    model = convert.params_from_flax(tree, ttr.TransformerConfig(**cfg),
                                     device="cpu", param_dtype=torch.float32)
    assert model.block_0.moe.wi.shape == (E, 32, 64)
    got = model(torch.tensor(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), _np(want_logits),
                               atol=1e-4, rtol=1e-4)
    loss, aux = tmoe.moe_loss_fn(model)(dict(model.named_parameters()),
                                        {"tokens": torch.tensor(tokens)},
                                        None)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    for name in ("ce", "moe_aux"):
        np.testing.assert_allclose(aux[name].item(), float(want_aux[name]),
                                   rtol=1e-6)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    named = dict(zip((n for n, _ in model.named_parameters()), grads))
    want = convert._flatten(jax.tree.map(np.asarray, want_grads))
    for path, leaf in want.items():
        g = named[convert._port_name(path)]
        if path.endswith("/kernel"):
            g = g.t().reshape(leaf.shape)
        np.testing.assert_allclose(g.numpy(), leaf, atol=1e-5, rtol=1e-4,
                                   err_msg=path)


def test_remat_recomputes_with_the_weights_it_was_given():
    """A loss over weights other than the module's own (functional_call)
    differentiates those weights under remat, as without it."""
    tree = _jax_setup()[0]
    tokens = torch.tensor(_tokens(seed=9)).long()
    grads = []
    for remat in (False, True):
        model = convert.params_from_flax(
            tree, ttr.TransformerConfig(**dict(MOE, remat=remat)),
            device="cpu", param_dtype=torch.float32)
        other = {n: (p.detach() * 1.5).requires_grad_(True)
                 for n, p in model.named_parameters()}
        loss, _ = tmoe.moe_loss_fn(model)(other, {"tokens": tokens}, None)
        grads.append(torch.autograd.grad(loss, list(other.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_moe_aux_counts_each_block_once_under_remat():
    tree = _jax_setup()[0]
    model = convert.params_from_flax(
        tree, ttr.TransformerConfig(**dict(MOE, remat=True)), device="cpu",
        param_dtype=torch.float32)
    logits, aux = model(torch.tensor(_tokens()).long(), return_aux=True)
    assert len(aux) == MOE["num_layers"]
    logits.sum().backward()  # the recompute appends nothing
    assert len(aux) == MOE["num_layers"]
    dense = convert.params_from_flax(
        convert.init_params_tree(ttr.TransformerConfig(
            **dict(MOE, num_experts=0)), seed=1),
        ttr.TransformerConfig(**dict(MOE, num_experts=0)), device="cpu")
    loss, metrics = tmoe.moe_loss_fn(dense)(
        dict(dense.named_parameters()), {"tokens": torch.tensor(_tokens())},
        None)
    assert metrics["moe_aux"].item() == 0.0
    np.testing.assert_allclose(loss.item(), metrics["ce"].item())


def test_adamw_trajectory_matches_jax_trainer():
    tree, model_j, params, _ = _jax_setup()
    tokens = _tokens(seed=10, shape=(STEPS, B, S))
    trainer_j = jdp.SyncTrainer(jmoe.moe_loss_fn(model_j), optax.adamw(1e-3),
                                mesh=build_mesh(devices=jax.devices()[:1]),
                                has_aux=True)
    state_j = trainer_j.create_state(params)
    want = []
    for t in tokens:
        state_j, m = trainer_j.step(state_j, {"tokens": t})
        want.append([float(m[k]) for k in ("loss", "ce", "moe_aux")])
    model = convert.params_from_flax(
        tree, ttr.TransformerConfig(**dict(MOE, remat=True)), device="cpu",
        param_dtype=torch.float32)
    trainer = dp.SyncTrainer(tmoe.moe_loss_fn(model), optim.adamw(1e-3),
                             has_aux=True)
    state = trainer.create_state(dict(model.named_parameters()))
    state, metrics = trainer.multi_step(state, {"tokens": tokens})
    assert set(metrics) == {"loss", "ce", "moe_aux"}
    assert all(m.shape == (STEPS,) and not m.requires_grad
               for m in metrics.values())
    got = np.stack([metrics[k].numpy() for k in ("loss", "ce", "moe_aux")],
                   axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    want_p = convert._flatten(jax.tree.map(np.asarray, state_j.params))
    got_p = convert._flatten(convert.tree_from_model(model))
    for path, leaf in want_p.items():
        np.testing.assert_allclose(got_p[path], leaf, rtol=1e-5, atol=1e-5,
                                   err_msg=path)


# -- the weight carrier ------------------------------------------------


def test_convert_round_trips_moe_leaves_and_keeps_layouts():
    cfg = ttr.TransformerConfig(**dict(MOE, dtype="bfloat16"))
    tree = convert.init_params_tree(cfg, seed=11)
    shapes = convert.tree_shapes(cfg)
    assert shapes["block_1/moe/router"] == (32, E)
    assert shapes["block_1/moe/wi"] == shapes["block_1/moe/wg"] == (E, 32, 64)
    assert shapes["block_1/moe/wo"] == (E, 64, 32)
    assert not any("/mlp/" in p for p in shapes)
    master = convert.params_from_flax(tree, cfg, device="cpu",
                                      param_dtype=torch.float32)
    back = convert._flatten(convert.tree_from_model(master))
    for path, leaf in convert._flatten(tree).items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)
    serving = convert.params_from_flax(tree, cfg, device="cpu")
    assert serving.block_0.moe.wi.dtype == torch.bfloat16
    assert serving.block_0.moe.router.dtype == torch.float32
    twin = serving.with_config(cfg)
    assert twin.block_0.moe.wo.data_ptr() == serving.block_0.moe.wo.data_ptr()


def test_init_scales_match_the_jax_initialisers():
    cfg = ttr.TransformerConfig(**dict(MOE, num_experts=8, embed_dim=256,
                                       mlp_dim=512, num_layers=1,
                                       vocab_size=32))
    tree = convert.init_params_tree(cfg, seed=12)["block_0"]["moe"]
    init = jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal")
    for name, fan in (("wi", 8 * 256), ("wo", 8 * 512)):
        ref = np.asarray(init(jax.random.PRNGKey(0), tree[name].shape))
        assert abs(tree[name].std() / fan ** -0.5 - 1) < 0.01, name
        assert abs(ref.std() / fan ** -0.5 - 1) < 0.03, name
    assert abs(tree["router"].std() / 0.02 - 1) < 0.05
    layer = tmoe.MoEMLP(8, 512, 256, device="cpu")
    assert abs(layer.wg.detach().float().std().item() * (8 * 256) ** 0.5
               - 1) < 0.01


def test_dropless_rejects_an_expert_sharded_mesh():
    class Mesh:
        axis_names = ("data", "expert")

    with pytest.raises(ValueError, match="dropless"):
        ttr.Transformer(ttr.TransformerConfig(**dict(MOE, mesh=Mesh())),
                        device="cpu")
    bad = ttr.Transformer(ttr.TransformerConfig(**dict(
        MOE, remat=True, remat_policy="everything")), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        bad(torch.zeros((1, 4), dtype=torch.long))


def test_planted_k7_fault_still_applies_to_the_kernel_source():
    """``chip_mutants.py``'s K7 fault finds its line in ``csrc/gmm.cu``
    exactly once, and names a check that exists."""
    import importlib.util
    import os

    from tensorflowonspark_tpu_torch.ops import _build

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_mutants", os.path.join(root, "chip_mutants.py"))
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    _, subs, check = mutants.MUTANTS["tgmm_last_tile"]
    assert check in mutants.CHECKS
    assert mutants.SOURCES["tgmm_last_tile"].endswith("csrc/gmm.cu")
    with open(os.path.join(_build.CSRC_DIR, "gmm.cu")) as f:
        text = f.read()
    mutated = mutants.mutate(text, subs)
    assert mutated != text
    with pytest.raises(ValueError, match="found 0 times"):
        mutants.mutate(mutated, subs)


@pytest.mark.parametrize("name", [
    "tgmm_wgmma_last_tile", "rows_wgmma_fwd_shift",
    "rows_wgmma_dxt_last_stage", "skip_last_live_tile"])
def test_planted_hopper_gmm_faults_still_apply_to_the_kernel_source(name):
    """Each ``chip_mutants.py`` fault of the wgmma grouped-matmul kernels
    finds its line in ``csrc/gmm.cu`` exactly once, and names a check
    that exists."""
    import importlib.util
    import os

    from tensorflowonspark_tpu_torch.ops import _build

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_mutants", os.path.join(root, "chip_mutants.py"))
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    _, subs, check = mutants.MUTANTS[name]
    assert check in mutants.CHECKS
    assert mutants.SOURCES[name].endswith("csrc/gmm.cu")
    with open(os.path.join(_build.CSRC_DIR, "gmm.cu")) as f:
        text = f.read()
    mutated = mutants.mutate(text, subs)
    assert mutated != text
    with pytest.raises(ValueError, match="found 0 times"):
        mutants.mutate(mutated, subs)


def test_kernel_operands_start_on_16_byte_boundaries():
    """A grouped-matmul operand that starts inside another tensor is
    copied to a 16-byte boundary (the kernels' 16-byte loads and TMA
    tensor maps need one); an aligned one is passed as it is."""
    from tensorflowonspark_tpu_torch.ops import gmm

    base = torch.arange(65, dtype=torch.float32).to(torch.bfloat16)
    view = base[1:].reshape(8, 8)
    assert view.data_ptr() % 16 != 0
    moved = gmm._aligned(view)
    assert moved.data_ptr() % 16 == 0
    assert torch.equal(moved, view)
    aligned = torch.zeros((8, 8), dtype=torch.bfloat16)
    assert aligned.data_ptr() % 16 == 0
    assert gmm._aligned(aligned).data_ptr() == aligned.data_ptr()
