"""The port's static ``generate`` against the JAX package's, on the CPU in
f32: the same weights (a JAX ``init`` tree, or the port's seeded tree for
MoE) and the same left-padded prompt batch must give the same greedy
tokens, exactly, under GQA, a sliding window, the int8 KV cache, int8 and
int4 weights (each decode step dequantizing the codes again) and MoE.
Each row of a ragged batch also equals its unpadded run on its own (bf16
KV; the int8 cache quantizes post-rope keys, whose codes depend on the
absolute position).  Sampled draws come from a ``torch.Generator``, not
the JAX key stream: they are held by distribution only (every draw in
the top-k set).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import quantize as jq  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu_torch import convert  # noqa: E402
from tensorflowonspark_tpu_torch import quantize as tq  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=32, embed_dim=128, mlp_dim=192, max_seq_len=96,
            dtype="float32")
MAX_NEW = 10
PADS = np.asarray([0, 7, 19], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tree(extra=()):
    cfg = jtr.TransformerConfig(**dict(TINY, **dict(extra)))
    params = jtr.Transformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _prompt(seed=0, length=24):
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 256, (len(PADS), length)).astype(np.int32)
    for r, n in enumerate(PADS):
        p[r, :n] = 0
    return p


def _jax_generate(cfg_kw, params, prompt, pads=None, **kw):
    model = jtr.Transformer(jtr.TransformerConfig(**cfg_kw))
    return np.asarray(jtr.generate(
        model, jax.tree.map(jnp.asarray, params), jnp.asarray(prompt),
        MAX_NEW, pad_start=None if pads is None else jnp.asarray(pads),
        **kw))


def _port_model(cfg_kw, tree):
    return convert.params_from_flax(tree, ttr.TransformerConfig(**cfg_kw),
                                    device="cpu")


CONFIGS = {
    "mha": {"num_kv_heads": 0},
    "gqa": {},
    "gqa_window": {"attention_window": 9},
    "int8_cache": {"cache_dtype": "int8"},
    "int8_cache_window": {"cache_dtype": "int8", "attention_window": 9},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ragged_greedy_matches_jax(name):
    extra = CONFIGS[name]
    cfg_kw = dict(TINY, **extra)
    tree = _jax_tree(tuple(sorted(extra.items())))
    prompt = _prompt()
    want = _jax_generate(cfg_kw, tree, prompt, PADS)
    model = _port_model(cfg_kw, tree)
    got = ttr.generate(model, None, torch.from_numpy(prompt), MAX_NEW,
                       pad_start=torch.from_numpy(PADS))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if extra.get("cache_dtype") == "int8":
        return
    for r, n in enumerate(PADS):
        alone = ttr.generate(model, None, prompt[r:r + 1, n:], MAX_NEW)
        np.testing.assert_array_equal(alone.numpy()[0], want[r], str(r))


def test_params_tree_loads_through_generate():
    tree = _jax_tree()
    prompt = _prompt(seed=3)[:, 19:]
    want = _jax_generate(TINY, tree, prompt)
    shell = ttr.Transformer(ttr.TransformerConfig(**TINY), device="cpu")
    np.testing.assert_array_equal(
        ttr.generate(shell, tree, prompt, MAX_NEW).numpy(), want)


def test_eos_rows_repeat_eos_like_jax():
    tree = _jax_tree()
    prompt = _prompt(seed=5)
    plain = _jax_generate(TINY, tree, prompt, PADS)
    eos = int(plain[1, 3])
    want = _jax_generate(TINY, tree, prompt, PADS, eos_id=eos)
    got = ttr.generate(_port_model(TINY, tree), None, prompt, MAX_NEW,
                       pad_start=PADS, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1, 3:] == eos).all()


@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_quantized_weights_match_jax(scheme, cache_dtype):
    """int8/int4 weights: the reference prefills with the tree
    dequantized once and dequantizes again under a barrier at each step;
    the port prefills with the model's dequantized weights and runs each
    step over ``qweights.dequantize``.  Tokens equal."""
    cfg_kw = dict(TINY, cache_dtype=cache_dtype)
    tree = _jax_tree()
    jfn = jq.quantize_tree if scheme == "int8" else jq.quantize_tree_int4
    tfn = tq.quantize_tree if scheme == "int8" else tq.quantize_tree_int4
    prompt = _prompt(seed=7)
    want = np.asarray(jtr.generate(
        jtr.Transformer(jtr.TransformerConfig(**cfg_kw)),
        jfn(jax.tree.map(jnp.asarray, tree)), jnp.asarray(prompt), MAX_NEW,
        pad_start=jnp.asarray(PADS)))
    model = _port_model(cfg_kw, tfn(tree))
    assert model.qweights.scheme == scheme
    got = ttr.generate(model, None, prompt, MAX_NEW, pad_start=PADS)
    np.testing.assert_array_equal(got.numpy(), want)
    # the quantized tree passed as params loads the same way
    shell = ttr.Transformer(ttr.TransformerConfig(**cfg_kw), device="cpu")
    np.testing.assert_array_equal(
        ttr.generate(shell, tfn(tree), prompt, MAX_NEW,
                     pad_start=PADS).numpy(), want)


@pytest.mark.parametrize("dispatch", ["dropless", "gather"])
def test_moe_generate_matches_jax(dispatch):
    """MoE static generate (4 experts, top-2): dropless runs the plain
    grouped matmul here and the Pallas kernels in interpret mode there."""
    cfg_kw = dict(TINY, num_experts=4, expert_k=2, expert_dispatch=dispatch)
    tree = convert.init_params_tree(ttr.TransformerConfig(**cfg_kw), seed=3)
    prompt = _prompt(seed=9)
    model = jtr.Transformer(jtr.TransformerConfig(**cfg_kw))
    want = np.asarray(jax.jit(
        lambda p, t, s: jtr.generate(model, p, t, MAX_NEW, pad_start=s)
    )(jax.tree.map(jnp.asarray, tree), jnp.asarray(prompt),
      jnp.asarray(PADS)))
    got = ttr.generate(_port_model(cfg_kw, tree), None, prompt, MAX_NEW,
                       pad_start=PADS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_guards_match_jax():
    tree = _jax_tree()
    model = _port_model(TINY, tree)
    jmodel = jtr.Transformer(jtr.TransformerConfig(**TINY))
    long = np.zeros((1, TINY["max_seq_len"] - MAX_NEW + 1), np.int32)
    for fn in (lambda: ttr.generate(model, None, long, MAX_NEW),
               lambda: jtr.generate(jmodel, tree, jnp.asarray(long),
                                    MAX_NEW)):
        with pytest.raises(ValueError, match="exceeds the cache"):
            fn()
    with pytest.raises(ValueError, match="needs a generator"):
        ttr.generate(model, None, long[:, :4], 3, temperature=1.0)
    empty = ttr.generate(model, None, long[:, :4], 0)
    assert tuple(empty.shape) == (1, 0)
    paged = model.with_config(ttr.TransformerConfig(**dict(
        TINY, kv_layout="paged")))
    with pytest.raises(ValueError, match="contiguous"):
        ttr.generate(paged, None, long[:, :4], 3)


def test_sampling_draws_from_the_filtered_set():
    """Sampled draws are held by distribution: with ``top_k=3`` every
    token is among the 3 best of its step's logits, and the same
    generator seed gives the same draws."""
    model = _port_model(TINY, _jax_tree())
    prompt = _prompt(seed=11)[:, 19:]

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return ttr.generate(model, None, prompt, MAX_NEW, temperature=1.0,
                            generator=gen, top_k=3)

    a = draw(0)
    assert torch.equal(a, draw(0))
    seq = torch.cat([torch.from_numpy(prompt).long(), a.long()], dim=1)
    with torch.no_grad():
        logits = model(seq)
    p = prompt.shape[1]
    top3 = torch.topk(logits[:, p - 1:-1], 3, dim=-1).indices
    assert bool((top3 == a.long()[..., None]).any(-1).all())
