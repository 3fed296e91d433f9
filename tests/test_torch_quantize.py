"""The port's ``quantize`` against the JAX package's, on the CPU: on the
same Flax-layout tree (numpy, made from a seed) the int8 codes and
scales, the packed int4 nibbles and group scales, and the dequantized
weights in f32 and bf16 must be equal to the bit, for dense kernels,
embeddings (per-row scales) and expert stacks (per-expert scales).  A
model loaded from a quantized tree must hold those dequantized weights
in its own layout, and its per-step dequantization
(``QuantizedWeights``) must give them again.  Tolerance: none (bit
equality) everywhere but ``quantization_error``'s floats (1e-7).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import quantize as jq  # noqa: E402
from tensorflowonspark_tpu_torch import convert  # noqa: E402
from tensorflowonspark_tpu_torch import quantize as tq  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)

#: every dense kernel but k/v reaches the quantizer's 16384-element floor
TINY = dict(vocab_size=300, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=32, embed_dim=128, mlp_dim=192, max_seq_len=64,
            dtype="float32")
MOE = dict(TINY, num_experts=4, expert_k=2)
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _tree(cfg_kw, seed=0):
    tree = convert.init_params_tree(ttr.TransformerConfig(**cfg_kw), seed)
    # an all-zero output channel and an all-zero int4 group (the 1e-12
    # floor of the scale)
    tree["block_0"]["attn"]["q"]["kernel"][:, 1, 3] = 0.0
    tree["lm_head"]["kernel"][:, 5] = 0.0
    return tree


def _jax_leaves(jtree):
    flat = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, (jq.QTensor, jq.QTensor4)))[0]
    return {tuple(p.key for p in path): leaf for path, leaf in flat}


def _port_leaves(ttree):
    return dict(tq._leaves_with_path(ttree))


def _equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _deq(leaf, jdt, tdt):
    if isinstance(leaf, jq.QTensor4):
        return np.asarray(jq.dequantize_leaf_int4(leaf, jdt).astype(
            jnp.float32))
    return np.asarray(jq.dequantize_leaf(leaf, jdt).astype(jnp.float32))


CASES = {
    "int8": (jq.quantize_tree, tq.quantize_tree, {}),
    "int8_min_size": (jq.quantize_tree, tq.quantize_tree,
                      {"min_size": 1 << 20}),
    "int4_g64": (jq.quantize_tree_int4, tq.quantize_tree_int4, {}),
    "int4_g6_padded": (jq.quantize_tree_int4, tq.quantize_tree_int4,
                       {"group_size": 6}),
}


@pytest.mark.parametrize("model", ["dense", "moe"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_codes_scales_and_dequant_equal_the_reference(case, model):
    jfn, tfn, kw = CASES[case]
    tree = _tree(TINY if model == "dense" else MOE)
    want = _jax_leaves(jfn(jax.tree.map(jnp.asarray, tree), **kw))
    got = _port_leaves(tfn(tree, **kw))
    assert sorted(want) == sorted(got)
    kinds = set()
    for path, w in want.items():
        g = got[path]
        if isinstance(w, jq.QTensor):
            assert isinstance(g, tq.QTensor), path
            assert _equal(w.q, g.q) and _equal(w.scale, g.scale), path
            kinds.add(("int8", np.asarray(w.scale).shape[0] ==
                       np.asarray(w.q).shape[0]))
        elif isinstance(w, jq.QTensor4):
            assert isinstance(g, tq.QTensor4), path
            assert _equal(w.packed, g.packed), path
            assert _equal(w.scale, g.scale), path
            assert (w.shape, w.group_size) == (g.shape, g.group_size)
            kinds.add(("int4", True))
        else:
            assert not tq._is_any_q(g), path
            assert np.array_equal(np.asarray(w), np.asarray(g)), path
            continue
        for jdt, tdt in DTYPES:
            d = tq.dequantize_leaf_any(g, tdt)
            assert d.dtype == tdt
            assert np.array_equal(_deq(w, jdt, tdt),
                                  d.to(torch.float32).numpy()), path
    if case.startswith("int4"):
        assert ("int4", True) in kinds
    if case != "int8_min_size":
        # embedding rows carry per-row scales ([V, 1]), kernels per-
        # channel ([1, ...]) or per-expert
        assert any(k[0] == "int8" for k in kinds)
    jt = jfn(jax.tree.map(jnp.asarray, tree), **kw)
    tt = tfn(tree, **kw)
    assert tq.quantization_of(tt) == jq.quantization_of(jt)
    assert tq.is_quantized(tt) == jq.is_quantized(jt)
    errs_t = tq.quantization_error(tree, tt)
    errs_j = jq.quantization_error(jax.tree.map(jnp.asarray, tree), jt)
    assert sorted(errs_t) == sorted(errs_j)
    for key in errs_j:
        assert errs_t[key] == pytest.approx(errs_j[key], abs=1e-7)


def test_embedding_and_expert_leaves_keep_int8_under_int4():
    tree = _tree(MOE)
    q = tq.quantize_tree_int4(tree)
    assert isinstance(q["embedding"], tq.QTensor)
    assert tuple(q["embedding"].scale.shape) == (300, 1)
    wi = q["block_0"]["moe"]["wi"]
    assert isinstance(wi, tq.QTensor)
    assert tuple(wi.scale.shape) == (4, 1, 192)
    assert isinstance(q["block_0"]["attn"]["q"]["kernel"], tq.QTensor4)
    # norm scales, the small router and the k/v kernels stay float
    assert isinstance(q["block_0"]["attn"]["k"]["kernel"], np.ndarray)
    assert isinstance(q["block_0"]["ln1"]["scale"], np.ndarray)
    assert isinstance(q["block_0"]["moe"]["router"], np.ndarray)
    # applying it twice changes nothing
    again = tq.quantize_tree_int4(q)
    assert again["embedding"] is q["embedding"]
    assert tq.quantization_of(tq.quantize_tree(tree)) == "int8"


@pytest.mark.parametrize("codes", [
    np.arange(-8, 8, dtype=np.int8).reshape(16, 1).repeat(3, 1),
    np.random.default_rng(2).integers(-8, 8, (10, 4, 6)).astype(np.int8),
], ids=["sign_boundary", "random_3d"])
def test_pack_unpack_match_the_reference(codes):
    packed = tq.pack_int4(codes)
    assert _equal(jq.pack_int4(jnp.asarray(codes)), packed)
    assert _equal(codes, tq.unpack_int4(packed))
    assert _equal(jq.unpack_int4(jnp.asarray(packed.numpy())),
                  tq.unpack_int4(packed))
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(codes[:3])
    with pytest.raises(ValueError, match="group_size"):
        tq.quantize_leaf_int4(np.ones((4, 4), np.float32), group_size=3)


def test_dequantize_tree_keeps_float_leaves_and_ignores_barrier():
    tree = _tree(TINY)
    q = tq.quantize_tree(tree)
    a = tq.dequantize_tree(q, torch.float32, barrier=True)
    b = tq.dequantize_tree(q, torch.float32, barrier=False)
    for (path, x), (_, y) in zip(tq._leaves_with_path(a),
                                 tq._leaves_with_path(b)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path
    assert a["block_0"]["ln1"]["scale"] is tree["block_0"]["ln1"]["scale"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("model_kw", [TINY, MOE], ids=["dense", "moe"])
def test_model_weights_are_the_reference_dequant(scheme, dtype, model_kw):
    """A model loaded from a quantized tree holds the reference's
    ``dequantize_tree(q, cfg.dtype)`` in the port's layout, and its
    ``qweights.dequantize`` (the decode steps' weights) equals them to the
    bit, leaf by leaf."""
    cfg_kw = dict(model_kw, dtype=dtype)
    cfg = ttr.TransformerConfig(**cfg_kw)
    tree = _tree(cfg_kw)
    jfn = jq.quantize_tree if scheme == "int8" else jq.quantize_tree_int4
    tfn = tq.quantize_tree if scheme == "int8" else tq.quantize_tree_int4
    jdeq = jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
        jq.dequantize_tree(jfn(jax.tree.map(jnp.asarray, tree)),
                           jnp.dtype(dtype), barrier=False))
    ref = convert.params_from_flax(jdeq, cfg, device="cpu")
    model = convert.params_from_flax(tfn(tree), cfg, device="cpu")
    state, want = model.state_dict(), ref.state_dict()
    for name in want:
        assert torch.equal(state[name], want[name]), name
    qw = model.qweights
    assert qw.scheme == scheme and qw.nbytes > 0
    assert "embedding" not in qw.names()
    per_step = qw.dequantize(cfg.torch_dtype)
    assert sorted(per_step) == qw.names()
    for name, w in per_step.items():
        assert w.dtype == cfg.torch_dtype
        assert torch.equal(w, want[name].to(cfg.torch_dtype)), name
    # the twin a decoder builds keeps the codes
    assert model.with_config(cfg).qweights is qw
    assert convert.params_from_flax(tree, cfg, device="cpu").qweights is None


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_param_manifest_censuses_quantized_leaves_like_jax(scheme):
    from tensorflowonspark_tpu import checkpoint as jck
    from tensorflowonspark_tpu_torch import checkpoint as tck

    tree = _tree(TINY)
    jfn = jq.quantize_tree if scheme == "int8" else jq.quantize_tree_int4
    tfn = tq.quantize_tree if scheme == "int8" else tq.quantize_tree_int4
    assert tck.param_manifest(tfn(tree)) == jck.param_manifest(
        jfn(jax.tree.map(jnp.asarray, tree)))
