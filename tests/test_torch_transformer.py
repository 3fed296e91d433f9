"""The port's paged ``SlotDecoder`` against the JAX package's, on the CPU
in f32: the same weights (a JAX ``init`` tree through the converter)
and the same admit / chunk / evict script must give identical greedy
tokens, including the first token of every admit.  The JAX side runs
``paged_impl="gather"``; the port runs both of its paths, ``"kernel"``
(the plain version of the kernel on a CPU tensor) and ``"gather"``.  A
tiny MoE model is held the same way in each of its dispatch modes.
"""

import functools

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

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=128,
            dtype="float32")
DEC = dict(cache_len=64, chunk_size=4, pad_multiple=16, page_tokens=8,
           kv_layout="paged")
MAX_NEW = 16


def _jax_params(cfg_kw, seed=0):
    model = jtr.Transformer(jtr.TransformerConfig(**cfg_kw))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _prompts(vocab, lens, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


# admit / chunk / evict script over three slots: ("admit", slot, prompt
# index), ("evict", slot) and ("chunk",)
SCRIPT = [
    ("admit", 0, 0), ("admit", 1, 1), ("admit", 2, 2), ("chunk",),
    ("evict", 1), ("admit", 1, 3), ("chunk",),
    ("evict", 0), ("evict", 2), ("admit", 0, 4), ("chunk",),
    ("admit", 2, 5), ("chunk",), ("chunk",),
]


def _drive(dec, prompts):
    """Run SCRIPT; returns the first tokens of every admit and, per
    chunk, the token rows of the active slots."""
    log = []
    for step in SCRIPT:
        if step[0] == "admit":
            log.append(("first", step[1],
                        int(np.asarray(dec.admit(step[1],
                                                 prompts[step[2]])))))
        elif step[0] == "evict":
            dec.evict(step[1])
        else:
            toks, valid = dec.step_chunk()
            assert (np.asarray(valid) == toks.shape[1]).all()
            active = np.nonzero(dec.active)[0]
            log.append(("chunk", active.tolist(),
                        np.asarray(toks)[active].tolist()))
    return log


@pytest.mark.parametrize("extra", [{}, {"attention_window": 12}],
                         ids=["causal", "window"])
def test_slot_decoder_matches_jax(extra):
    cfg_kw = dict(TINY, **extra)
    jmodel, tree = _jax_params(cfg_kw)
    prompts = _prompts(cfg_kw["vocab_size"], [5, 17, 9, 30, 2, 12])
    jdec = jtr.SlotDecoder(jmodel, tree, 3, MAX_NEW, paged_impl="gather",
                           **DEC)
    ref = _drive(jdec, prompts)
    cfg = ttr.TransformerConfig(**cfg_kw)
    for impl in ("kernel", "gather"):
        model = convert.params_from_flax(tree, cfg, device="cpu")
        dec = ttr.SlotDecoder(model, None, 3, MAX_NEW, paged_impl=impl,
                              **DEC)
        assert dec.model.cfg.paged_decode_impl == impl
        assert _drive(dec, prompts) == ref, impl


@functools.lru_cache(maxsize=None)
def _moe_reference(dispatch):
    """A tiny MoE (4 experts, top-2, f32) in dispatch mode ``dispatch``:
    its config, the port's seeded weight tree (a Flax ``init`` of a
    dropless model would run the Pallas kernels in interpret mode), its
    prompts and the JAX ``SlotDecoder``'s log of SCRIPT."""
    cfg_kw = dict(TINY, num_experts=4, expert_k=2, expert_dispatch=dispatch)
    tree = convert.init_params_tree(ttr.TransformerConfig(**cfg_kw), seed=3)
    prompts = _prompts(cfg_kw["vocab_size"], [5, 17, 9, 30, 2, 12])
    jdec = jtr.SlotDecoder(jtr.Transformer(jtr.TransformerConfig(**cfg_kw)),
                           jax.tree.map(jnp.asarray, tree), 3, MAX_NEW,
                           paged_impl="gather", **DEC)
    return cfg_kw, tree, prompts, _drive(jdec, prompts)


@pytest.mark.parametrize("impl", ["kernel", "gather"])
@pytest.mark.parametrize("dispatch", ["dropless", "gather", "einsum"])
def test_moe_slot_decoder_matches_jax(dispatch, impl):
    """MoE paged serving: every admit's first token and every chunk's
    greedy tokens equal the JAX package's (dropless: the plain grouped
    matmul with the layout's counts on this side, the Pallas kernels in
    interpret mode on that one)."""
    cfg_kw, tree, prompts, ref = _moe_reference(dispatch)
    model = convert.params_from_flax(tree, ttr.TransformerConfig(**cfg_kw),
                                     device="cpu")
    assert model.block_0.moe.dispatch == dispatch
    dec = ttr.SlotDecoder(model, None, 3, MAX_NEW, paged_impl=impl, **DEC)
    assert dec.model.cfg.paged_decode_impl == impl
    assert _drive(dec, prompts) == ref


def test_params_tree_loads_through_the_decoder():
    jmodel, tree = _jax_params(TINY, seed=1)
    prompts = _prompts(TINY["vocab_size"], [7, 3, 20, 11, 4, 9], seed=5)
    ref = _drive(jtr.SlotDecoder(jmodel, tree, 3, MAX_NEW,
                                 paged_impl="gather", **DEC), prompts)
    shell = ttr.Transformer(ttr.TransformerConfig(**TINY), device="cpu")
    got = _drive(ttr.SlotDecoder(shell, tree, 3, MAX_NEW, **DEC), prompts)
    assert got == ref


def _port_decoder(**kw):
    model = ttr.Transformer(ttr.TransformerConfig(**TINY), device="cpu")
    return ttr.SlotDecoder(model, None, 3, MAX_NEW, **dict(DEC, **kw))


class TestSlotBookkeeping:
    def test_pool_sizing_and_geometry(self):
        dec = _port_decoder()
        span = -(-DEC["cache_len"] // DEC["page_tokens"])
        assert dec.page_pool.num_pages == 3 * span + 1
        assert dec.model.cfg.kv_pages == 3 * span + 1
        assert dec.model.cfg.kv_slot_blocks == span
        pool = dec.cache[0]["k"]
        assert tuple(pool.shape) == (3 * span + 1, 8, 2, 16)
        # the rebuilt model shares the caller's weights, no copy
        assert dec.model.embedding.data_ptr() != 0

    def test_evict_releases_and_parks_on_trash_page(self):
        dec = _port_decoder()
        free0 = dec.page_pool.available()
        dec.admit(1, np.arange(5, dtype=np.int32))
        assert dec.free_slots() == [0, 2]
        assert (dec.tables[1] > 0).all()
        assert dec.page_pool.available() == free0 - dec.tables.shape[1]
        with pytest.raises(ValueError, match="still active"):
            dec.admit(1, np.arange(3, dtype=np.int32))
        dec.evict(1)
        assert dec.free_slots() == [0, 1, 2]
        assert (dec.tables[1] == 0).all()
        assert dec.page_pool.available() == free0
        assert dec.reuse_stats()["pool_pages_used"] == 0

    def test_reset_returns_every_slot(self):
        dec = _port_decoder()
        dec.admit(0, np.arange(4, dtype=np.int32))
        dec.admit(2, np.arange(9, dtype=np.int32))
        dec.step_chunk()
        dec.reset()
        assert dec.free_slots() == [0, 1, 2]
        assert (dec.tables == 0).all()
        assert bool(dec.state["done"].all())

    def test_admit_rejects_oversized_and_empty_prompts(self):
        dec = _port_decoder()
        with pytest.raises(ValueError, match="exceeds"):
            dec.admit(0, np.zeros((DEC["cache_len"],), np.int32))
        with pytest.raises(ValueError, match="empty"):
            dec.admit(0, np.zeros((0,), np.int32))

    @pytest.mark.parametrize("n", [1, 15, 16, 17, 47, 48])
    def test_buckets_match_jax(self, n):
        jmodel, tree = _jax_params(TINY)
        jdec = jtr.SlotDecoder(jmodel, tree, 2, MAX_NEW,
                               paged_impl="gather", **DEC)
        dec = _port_decoder()
        assert dec.bucket_len(n) == jdec.bucket_len(n)
        assert dec._suffix_bucket(n, 0) == jdec._suffix_bucket(n, 0)

    def test_kv_pages_floor_enforced(self):
        with pytest.raises(ValueError, match="cannot hold"):
            _port_decoder(kv_pages=4)

    @pytest.mark.parametrize("kw,item", [
        ({"kv_layout": "contiguous"}, "contiguous KV"),
        ({"prefix_cache": object()}, "prefix cache"),
        ({"draft_model": object()}, "speculation"),
        ({"mesh": object()}, "TP"),
    ])
    def test_unported_decoder_planes_raise(self, kw, item):
        with pytest.raises(NotImplementedError, match=item):
            _port_decoder(**kw)


class TestForwardPieces:
    def test_rope_and_rmsnorm_match_jax(self):
        rng = np.random.RandomState(0)
        x = rng.randn(2, 5, 3, 8).astype(np.float32)
        pos = np.tile(np.arange(5)[None] + np.asarray([[0], [7]]), 1)
        np.testing.assert_allclose(
            ttr.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
            np.asarray(jtr.rope(jnp.asarray(x), jnp.asarray(pos))),
            atol=1e-5,
        )
        y = rng.randn(4, 16).astype(np.float32)
        jnorm = jtr.RMSNorm()
        jout = jnorm.apply(jnorm.init(jax.random.PRNGKey(0),
                                      jnp.asarray(y)), jnp.asarray(y))
        tnorm = ttr.RMSNorm(16, device="cpu")
        np.testing.assert_allclose(
            tnorm(torch.from_numpy(y)).detach().numpy(), np.asarray(jout),
            atol=1e-6,
        )

    def test_greedy_and_degenerate_sampling(self):
        logits = torch.from_numpy(
            np.random.RandomState(1).randn(4, 50).astype(np.float32))
        best = torch.argmax(logits, dim=-1)
        gen = torch.Generator().manual_seed(0)
        assert torch.equal(ttr.sample_logits(logits), best)
        np.testing.assert_array_equal(
            best.numpy(),
            np.asarray(jtr.sample_logits(jnp.asarray(logits.numpy()),
                                         None)),
        )
        # top_k=1 and a tiny nucleus leave only the argmax to draw
        assert torch.equal(ttr.sample_logits(logits, gen, temperature=1.0,
                                             top_k=1), best)
        assert torch.equal(ttr.sample_logits(logits, gen, temperature=1.0,
                                             top_p=1e-6), best)
        draws = ttr.sample_logits(logits, gen, temperature=1.0, top_k=5)
        top5 = torch.topk(logits, 5, dim=-1).indices
        assert bool((top5 == draws[:, None]).any(dim=-1).all())

    @pytest.mark.parametrize("field,item", [
        ({"fused_qkv": True}, "queue A: fused_qkv"),
        ({"cache_dtype": "int8"}, "int8"),
        ({"attention_impl": "ring"}, "ring/Ulysses"),
    ], ids=["fused_qkv", "int8_cache", "ring"])
    def test_unported_model_options_raise(self, field, item):
        with pytest.raises(NotImplementedError, match=item):
            model = ttr.Transformer(
                ttr.TransformerConfig(**dict(TINY, **field)), device="cpu")
            model(torch.zeros((1, 8), dtype=torch.long))

    def test_shared_counter_decode_is_not_ported(self):
        model = ttr.Transformer(ttr.TransformerConfig(**TINY), device="cpu")
        with pytest.raises(NotImplementedError, match="contiguous KV"):
            model(torch.zeros((1, 3), dtype=torch.long), decode=True)
