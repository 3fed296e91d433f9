"""The weight carrier: a JAX ``Transformer`` parameter tree, converted,
gives the same full-sequence logits in the port (f32, CPU, atol 1e-4)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu_torch import convert  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)

TINY = dict(vocab_size=96, num_layers=2, num_heads=4, head_dim=8,
            embed_dim=32, mlp_dim=64, max_seq_len=64, dtype="float32")


def _jax_tree(cfg_kw, seed=0):
    model = jtr.Transformer(jtr.TransformerConfig(**cfg_kw))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params, jax.tree.map(np.asarray, params)


def _leaf_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = prefix + "/" + k if prefix else k
        if isinstance(v, dict):
            out.update(_leaf_paths(v, path))
        else:
            out[path] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize("extra", [
    {},
    {"num_kv_heads": 2},
    {"num_kv_heads": 1, "attention_window": 5},
], ids=["mha", "gqa", "mqa_window"])
def test_converted_logits_match_jax(extra):
    cfg_kw = dict(TINY, **extra)
    model, params, tree = _jax_tree(cfg_kw)
    tokens = np.random.RandomState(1).randint(
        0, cfg_kw["vocab_size"], (2, 11)).astype(np.int32)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(tokens)))
    port = convert.params_from_flax(
        tree, ttr.TransformerConfig(**cfg_kw), device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(tokens).long()).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_tree_shapes_match_the_jax_model():
    cfg_kw = dict(TINY, num_kv_heads=2)
    _, _, tree = _jax_tree(cfg_kw)
    want = convert.tree_shapes(ttr.TransformerConfig(**cfg_kw))
    assert _leaf_paths(tree) == want
    rand = convert.init_params_tree(ttr.TransformerConfig(**cfg_kw), seed=4)
    assert _leaf_paths(rand) == want


def test_random_tree_is_seeded():
    cfg = ttr.TransformerConfig(**TINY)
    a = convert.init_params_tree(cfg, seed=5)
    b = convert.init_params_tree(cfg, seed=5)
    np.testing.assert_array_equal(a["block_1"]["mlp"]["wo"]["kernel"],
                                  b["block_1"]["mlp"]["wo"]["kernel"])


def _tree():
    return convert.init_params_tree(ttr.TransformerConfig(**TINY), seed=0)


def test_missing_leaf_raises():
    tree = _tree()
    del tree["block_1"]["mlp"]["wg"]
    with pytest.raises(ValueError, match="missing.*block_1/mlp/wg/kernel"):
        convert.params_from_flax(tree, ttr.TransformerConfig(**TINY),
                                 device="cpu")


def test_extra_leaf_raises():
    tree = _tree()
    tree["block_0"]["attn"]["bias"] = np.zeros((4,), np.float32)
    with pytest.raises(ValueError, match="extra.*block_0/attn/bias"):
        convert.params_from_flax(tree, ttr.TransformerConfig(**TINY),
                                 device="cpu")


def test_misshapen_leaf_raises():
    tree = _tree()
    tree["block_0"]["attn"]["k"]["kernel"] = np.zeros((32, 2, 8),
                                                      np.float32)
    with pytest.raises(ValueError, match="block_0/attn/k/kernel"):
        convert.params_from_flax(tree, ttr.TransformerConfig(**TINY),
                                 device="cpu")


@pytest.mark.parametrize("block,item", [
    ({"qkv": {"kernel": np.zeros((32, 3, 4, 8), np.float32)}},
     "queue A: fused_qkv"),
    ({"moe": {"router": np.zeros((32, 4), np.float32)}}, "MoE"),
], ids=["fused_qkv", "moe"])
def test_unported_leaves_raise(block, item):
    tree = _tree()
    if "qkv" in block:
        tree["block_0"]["attn"].update(block)
    else:
        tree["block_0"].update(block)
    with pytest.raises(NotImplementedError, match=item):
        convert.params_from_flax(tree, ttr.TransformerConfig(**TINY),
                                 device="cpu")


@pytest.mark.parametrize("field,item", [
    ({"fused_qkv": True}, "queue A: fused_qkv"),
    ({"num_experts": 4}, "MoE"),
])
def test_unported_configs_raise(field, item):
    with pytest.raises(NotImplementedError, match=item):
        convert.params_from_flax(_tree(),
                                 ttr.TransformerConfig(**dict(TINY, **field)),
                                 device="cpu")


def test_tree_from_model_round_trips_exactly():
    cfg = ttr.TransformerConfig(**dict(TINY, num_kv_heads=2))
    tree = convert.init_params_tree(cfg, seed=7)
    model = convert.params_from_flax(tree, cfg, device="cpu",
                                     param_dtype=torch.float32)
    back = convert.tree_from_model(model)
    assert _leaf_paths(back) == _leaf_paths(tree)
    for path, leaf in convert._flatten(tree).items():
        got = convert._flatten(back)[path]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, leaf, err_msg=path)
    # a copy: training the model later does not change the tree
    with torch.no_grad():
        model.embedding.add_(1.0)
    np.testing.assert_array_equal(back["embedding"], tree["embedding"])


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_bf16_f32_master_logits_match_jax_bf16_model(impl):
    """A bf16 config over f32 master weights (cast at use, as Flax's
    ``Dense(dtype=bfloat16)`` casts its f32 kernel) against the JAX bf16
    model's logits.  Tolerance 3% of the largest logit: a few bf16 ulps
    (2^-8 relative) where XLA and PyTorch round two layers' bf16
    intermediates on other sides of a boundary.  The f32-master forward
    equals the bf16-stored serving forward exactly."""
    cfg_kw = dict(TINY, head_dim=16, embed_dim=64, mlp_dim=128,
                  num_kv_heads=2, dtype="bfloat16", attention_impl=impl)
    model, params, tree = _jax_tree(cfg_kw)
    assert {str(x.dtype) for x in jax.tree.leaves(params)} == {"float32"}
    tokens = np.random.RandomState(2).randint(
        0, cfg_kw["vocab_size"], (2, 32)).astype(np.int32)
    ref = np.asarray(jax.jit(model.apply)({"params": params},
                                          jnp.asarray(tokens)))
    cfg = ttr.TransformerConfig(**cfg_kw)
    master = convert.params_from_flax(tree, cfg, device="cpu",
                                      param_dtype=torch.float32)
    stored = convert.params_from_flax(tree, cfg, device="cpu")
    assert master.lm_head.weight.dtype == torch.float32
    assert stored.lm_head.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = master(torch.from_numpy(tokens).long())
        same = stored(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got, same)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=3e-2 * np.abs(ref).max())
