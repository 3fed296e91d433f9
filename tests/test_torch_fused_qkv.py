"""``fused_qkv``: the port's one ``[3*H*D, E]`` projection against the
JAX package's ``attn/qkv/kernel [E, 3, H, D]`` leaf, on the CPU in f32.

Tolerances: the fused forward equals the unfused one on the same weights
to 1e-6 (one product over the stacked kernel against three); logits, the
loss and its gradients against the JAX model and ``jax.grad`` to 1e-5
(f32 in another summation order); three SGD steps to rtol 1e-5 (losses)
and atol 1e-5 (weights), as the unfused trainer test; generated tokens
exactly; int8 and int4 codes and scales of the 4-D leaf bit-exact (the
quantizer's generic rule: int8 reduces over axes (0, 1, 2), per-``D``
scales shared by q, k, v and the heads; int4 groups run over the
flattened ``E*3*H`` rows).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu import quantize as jqz  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu.parallel import dp as jdp  # noqa: E402
from tensorflowonspark_tpu.parallel.mesh import build_mesh  # noqa: E402
from tensorflowonspark_tpu_torch import convert, optim  # noqa: E402
from tensorflowonspark_tpu_torch import quantize as qz  # noqa: E402
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.parallel import dp  # noqa: E402

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16,
            embed_dim=64, mlp_dim=128, max_seq_len=64, dtype="float32")
FUSED = dict(TINY, fused_qkv=True)
B, S, STEPS = 2, 32, 3


def _fuse(tree):
    """The unfused tree with each block's q, k, v kernels stacked into
    the fused ``[E, 3, H, D]`` leaf."""
    out = {k: v for k, v in tree.items()}
    for name, blk in tree.items():
        if not name.startswith("block_"):
            continue
        attn = dict(blk["attn"])
        attn["qkv"] = {"kernel": np.stack(
            [attn.pop(n)["kernel"] for n in ("q", "k", "v")], axis=1)}
        out[name] = dict(blk, attn=attn)
    return out


@pytest.fixture(scope="module")
def trees():
    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    tree = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return tree, _fuse(tree)


def _tokens(seed=3, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_fused_forward_equals_unfused(trees):
    tree, fused = trees
    tokens = torch.from_numpy(_tokens().astype(np.int64))
    a = convert.params_from_flax(tree, ttr.TransformerConfig(**TINY),
                                 device="cpu")
    f = convert.params_from_flax(fused, ttr.TransformerConfig(**FUSED),
                                 device="cpu")
    assert tuple(f.block_0.attn.qkv.weight.shape) == (3 * 4 * 16, 64)
    assert not hasattr(f.block_0.attn, "q")
    with torch.no_grad():
        torch.testing.assert_close(f(tokens), a(tokens), atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_logits_loss_and_grads_match_jax(trees, impl):
    _, fused = trees
    cfg = dict(FUSED, attention_impl=impl)
    jmodel = jtr.Transformer(jtr.TransformerConfig(**cfg))
    tokens = _tokens()
    jp = jax.tree.map(jnp.asarray, fused)
    want_logits = np.asarray(jmodel.apply({"params": jp},
                                          jnp.asarray(tokens)))
    loss = jtr.loss_fn(jmodel)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: loss(p, {"tokens": jnp.asarray(tokens)}, None))(jp)
    model = convert.params_from_flax(fused, ttr.TransformerConfig(**cfg),
                                     device="cpu", param_dtype=torch.float32)
    params = dict(model.named_parameters())
    got_loss = ttr.loss_fn(model)(params, {
        "tokens": torch.from_numpy(tokens.astype(np.int64))}, None)
    got_loss.backward()
    with torch.no_grad():
        got_logits = model(torch.from_numpy(tokens.astype(np.int64)))
    np.testing.assert_allclose(got_logits.numpy(), want_logits, atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=1e-5)
    grads = convert._flatten(jax.tree.map(np.asarray, want_grads))
    for path, want in grads.items():
        name = convert._port_name(path)
        got = params[name].grad
        if path.endswith("/kernel"):
            got = got.t()
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                   atol=1e-5, rtol=0, err_msg=path)


def test_sgd_trajectory_matches_jax(trees):
    _, fused = trees
    cfg = dict(FUSED, attention_impl="flash")
    tokens = _tokens(4, (STEPS, B, S))
    jmodel = jtr.Transformer(jtr.TransformerConfig(**cfg))
    jt = jdp.SyncTrainer(jtr.loss_fn(jmodel), optax.sgd(0.05, momentum=0.9),
                         mesh=build_mesh(devices=jax.devices()[:1]))
    jstate = jt.create_state(jax.tree.map(jnp.asarray, fused))
    want = []
    for t in tokens:
        jstate, m = jt.step(jstate, {"tokens": t})
        want.append(float(m["loss"]))
    model = convert.params_from_flax(fused, ttr.TransformerConfig(**cfg),
                                     device="cpu", param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model),
                             optim.sgd(0.05, momentum=0.9))
    state = trainer.create_state(dict(model.named_parameters()))
    got = []
    for t in tokens:
        state, m = trainer.step(state, {"tokens": t})
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    wp = convert._flatten(jax.tree.map(np.asarray, jstate.params))
    gp = convert._flatten(convert.tree_from_model(model))
    assert set(gp) == set(wp) and "block_0/attn/qkv/kernel" in gp
    for path in wp:
        np.testing.assert_allclose(gp[path], wp[path], atol=1e-5, rtol=0,
                                   err_msg=path)


def test_ring_model_over_one_rank_is_the_flash_model(trees):
    from tensorflowonspark_tpu_torch.parallel.mesh import build_mesh as tbm

    _, fused = trees
    tokens = torch.from_numpy(_tokens().astype(np.int64))
    logits = []
    for extra in ({"attention_impl": "flash"},
                  {"attention_impl": "ring", "mesh": tbm()},
                  {"attention_impl": "ulysses", "mesh": tbm()}):
        model = convert.params_from_flax(
            fused, ttr.TransformerConfig(**dict(FUSED, **extra)),
            device="cpu")
        with torch.no_grad():
            logits.append(model(tokens))
    torch.testing.assert_close(logits[1], logits[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(logits[2], logits[0], atol=1e-5, rtol=0)


def test_tree_round_trip_and_shapes(trees):
    _, fused = trees
    cfg = ttr.TransformerConfig(**FUSED)
    shapes = convert.tree_shapes(cfg)
    assert shapes["block_1/attn/qkv/kernel"] == (64, 3, 4, 16)
    assert not any(p.endswith(("attn/q/kernel", "attn/k/kernel"))
                   for p in shapes)
    back = convert._flatten(convert.tree_from_model(
        convert.params_from_flax(fused, cfg, device="cpu")))
    for path, leaf in convert._flatten(fused).items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)
    init = convert.init_params_tree(cfg, seed=1)
    assert init["block_0"]["attn"]["qkv"]["kernel"].shape == (64, 3, 4, 16)
    with pytest.raises(ValueError, match="missing.*qkv"):
        convert.params_from_flax(trees[0], cfg, device="cpu")


def test_gqa_refused_like_jax():
    cfg = dict(FUSED, num_kv_heads=2)
    with pytest.raises(ValueError, match="fused_qkv requires equal"):
        jtr.Transformer(jtr.TransformerConfig(**cfg)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    with pytest.raises(ValueError, match="fused_qkv requires equal"):
        ttr.Transformer(ttr.TransformerConfig(**cfg), device="cpu")


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quantized_codes_bit_exact(trees, scheme):
    """The generic rule covers the 4-D leaf: nothing re-derives its
    axes, and the codes and scales equal the reference's."""
    _, fused = trees
    leaf = fused["block_0"]["attn"]["qkv"]["kernel"]
    big = {"w": np.tile(leaf, (4, 1, 1, 1))}  # past min_size 16384
    if scheme == "int8":
        got = qz.quantize_tree({"w": torch.from_numpy(big["w"])})["w"]
        want = jqz.quantize_tree(jax.tree.map(jnp.asarray, big))["w"]
        assert tuple(got.scale.shape) == (1, 1, 1, 16)
        pairs = [(got.q, want.q), (got.scale, want.scale)]
    else:
        got = qz.quantize_tree_int4({"w": torch.from_numpy(big["w"])},
                                    group_size=32)["w"]
        want = jqz.quantize_tree_int4(jax.tree.map(jnp.asarray, big),
                                      group_size=32)["w"]
        assert tuple(got.scale.shape) == (256 * 3 * 4 // 32, 16)
        pairs = [(got.packed, want.packed), (got.scale, want.scale)]
    for g, w in pairs:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _serve(mod, predict, rows, schedule):
    return list(mod.predict_rows(predict, [dict(r) for r in rows],
                                 {"prompt": "tokens"}, batch_size=3,
                                 schedule=schedule))


@pytest.mark.parametrize("schedule,extra", [
    ("static", {}), ("continuous", {"kv_layout": "contiguous"}),
    ("continuous", {"kv_layout": "paged", "kv_page_tokens": 8}),
    ("continuous", {"kv_layout": "paged", "kv_page_tokens": 8,
                    "prefix_cache": True, "prefix_block": 8}),
    ("continuous", {"kv_layout": "paged", "kv_page_tokens": 8,
                    "quantize": "int8"}),
], ids=["static", "contiguous", "paged", "paged_prefix", "paged_int8"])
def test_serving_schedules_match_jax(trees, schedule, extra):
    _, fused = trees
    rng = np.random.RandomState(4)
    shared = rng.randint(0, 256, (16,))
    rows = [{"prompt": np.concatenate(
        [shared, rng.randint(0, 256, (int(n),))]).astype(np.int32)}
        for n in rng.randint(1, 20, (5,))]
    cfg = dict(FUSED, mode="generate", max_new_tokens=6, chunk_size=2,
               pad_multiple=16, max_prompt_len=40, **extra)
    jcfg = dict(cfg, paged_impl="gather") \
        if cfg.get("kv_layout") == "paged" else cfg
    got = _serve(serving, ttr.serving_builder(fused, dict(cfg, device="cpu")),
                 rows, schedule)
    want = _serve(jserving, jtr.serving_builder(fused, jcfg), rows, schedule)
    assert [r["generated"].tolist() for r in got] == \
        [np.asarray(r["generated"]).tolist() for r in want]


def test_logits_serving_matches_jax(trees):
    _, fused = trees
    tokens = _tokens(5)
    got = ttr.serving_builder(fused, dict(FUSED, device="cpu"))(
        {"tokens": tokens})
    want = jtr.serving_builder(fused, dict(FUSED))({"tokens": tokens})
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got["next_token"], want["next_token"])
