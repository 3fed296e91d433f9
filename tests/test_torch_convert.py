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
     "training slice"),
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
    ({"fused_qkv": True}, "training slice"),
    ({"num_experts": 4}, "MoE"),
])
def test_unported_configs_raise(field, item):
    with pytest.raises(NotImplementedError, match=item):
        convert.params_from_flax(_tree(),
                                 ttr.TransformerConfig(**dict(TINY, **field)),
                                 device="cpu")
