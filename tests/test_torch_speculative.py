"""Speculative decoding in the port against the JAX package, on the CPU
in f32 with the same weights (a JAX ``init`` tree through the
converter): the static ``generate_speculative`` by prompt lookup and by
draft model (tokens, rounds and accept counters equal), the
``SlotDecoder``'s per-slot draft rounds on both KV layouts through the
continuous schedule (tokens and ``spec_*`` counters equal), the static
speculative predictor, the draft weights across swaps and exports, and
the input checks with their error types.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import convert_jax_export  # noqa: E402
from tensorflowonspark_tpu import checkpoint as jckpt  # noqa: E402
from tensorflowonspark_tpu import quantize as jqz  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu_torch import checkpoint as ckpt  # noqa: E402
from tensorflowonspark_tpu_torch import convert, serving  # noqa: E402
from tensorflowonspark_tpu_torch import quantize as tqz  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=128,
            dtype="float32")
#: the paged flagship stack at test size: GQA, a window, the int8 KV
#: cache, pages of 4 tokens
STACK = dict(TINY, attention_window=24, cache_dtype="int8")
GEN = dict(mode="generate", max_new_tokens=6, pad_multiple=16,
           chunk_size=2)
PAGED = dict(kv_layout="paged", kv_page_tokens=4)


def _tree(cfg_kw=TINY, seed=0):
    model = jtr.Transformer(jtr.TransformerConfig(**cfg_kw))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(cfg_kw, tree):
    return convert.params_from_flax(tree, ttr.TransformerConfig(**cfg_kw),
                                    device="cpu")


def _shell(cfg_kw):
    return ttr.Transformer(ttr.TransformerConfig(**cfg_kw), device="meta")


def _prompts(lens, vocab=64, seed=13):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _first_block(tree):
    """The flagship's embedding, first block, final norm and head: a
    one-layer draft cut from the model it drafts for."""
    return {k: tree[k] for k in ("embedding", "block_0", "ln_f", "lm_head")}


def _spec_both(cfg_kw, tree, prompt, max_new, **kw):
    """``(tokens, rounds, stats)`` of both packages' generate_speculative
    on one prompt; ``draft`` in ``kw`` is ``(cfg_kw, tree)``."""
    draft = kw.pop("draft", None)
    jkw, tkw = dict(kw), dict(kw)
    if draft is not None:
        jkw.update(draft_model=jtr.Transformer(jtr.TransformerConfig(
            **draft[0])), draft_params=_jnp(draft[1]))
        tkw.update(draft_model=_shell(draft[0]), draft_params=draft[1])
    jst, tst = {}, {}
    jt, jr = jtr.generate_speculative(
        jtr.Transformer(jtr.TransformerConfig(**cfg_kw)), _jnp(tree),
        jnp.asarray(prompt), max_new, return_stats=True, stats=jst, **jkw)
    tt, tr_ = ttr.generate_speculative(
        _port(cfg_kw, tree), None, torch.from_numpy(prompt), max_new,
        return_stats=True, stats=tst, **tkw)
    return (np.asarray(jt), tt.numpy()), (int(jr), tr_), (jst, tst)


# ----------------------------------------------------------------------
# the static generate_speculative
# ----------------------------------------------------------------------


@pytest.mark.parametrize("b,seed", [(1, 4), (2, 5)])
def test_prompt_lookup_is_lossless_like_jax(b, seed):
    _, tree = _tree()
    prompt = np.random.RandomState(seed).randint(0, 64, (b, 10)).astype(
        np.int32)
    toks, rounds, stats = _spec_both(TINY, tree, prompt, 16, draft_len=4,
                                     ngram=2)
    np.testing.assert_array_equal(toks[1], toks[0])
    plain = ttr.generate(_port(TINY, tree), None, torch.from_numpy(prompt),
                         16)
    np.testing.assert_array_equal(toks[1], plain.numpy())
    assert rounds[1] == rounds[0] and 1 <= rounds[1] <= 16
    assert stats[1] == stats[0]


@pytest.mark.parametrize("ngram,draft_len", [(1, 2), (2, 4), (3, 5)])
def test_repetitive_input_accepts_like_jax(ngram, draft_len):
    """A periodic prompt keeps the n-gram drafts matching: fewer verify
    forwards than tokens, and the same rounds and accepts as the JAX
    package (the lockstep minimum over two rows, one of them with a
    broken head)."""
    _, tree = _tree(seed=2)
    prompt = np.tile(np.arange(6), 6)[None].repeat(2, 0).astype(np.int32)
    prompt[1, :4] = 9
    toks, rounds, stats = _spec_both(TINY, tree, prompt, 24, ngram=ngram,
                                     draft_len=draft_len)
    np.testing.assert_array_equal(toks[1], toks[0])
    assert rounds[1] == rounds[0]
    assert stats[1] == stats[0]


def test_find_drafts_rules():
    """The lookup's rules on hand-made histories: the latest match that
    starts strictly before the suffix wins, a continuation running past
    the valid history falls back to repeating the last token, and no
    match repeats it too."""
    last = torch.tensor([7, 7, 7])
    hist = torch.tensor([
        [1, 2, 3, 1, 2, 4, 1, 2, 0, 0, 0, 0],   # latest [1, 2] at 3
        [5, 6, 8, 8, 8, 5, 6, 0, 0, 0, 0, 0],   # [5, 6] at 0, cont 8 8 8
        [1, 2, 3, 4, 5, 6, 7, 9, 0, 0, 0, 0],   # [7, 9] never seen before
    ])
    got = ttr._find_drafts(hist, 8, last, 3, 2)
    assert got[0].tolist() == [4, 1, 2]
    # row 1 has 7 valid tokens; with 8 counted valid its suffix is
    # [6, 0], unmatched
    assert got[2].tolist() == [7, 7, 7]
    got = ttr._find_drafts(hist[1:2], 7, last[:1], 3, 2)
    assert got[0].tolist() == [8, 8, 8]
    # the continuation of the only match runs past the valid history:
    # positions 6.. are beyond 7 valid tokens only from index 7 on
    got = ttr._find_drafts(torch.tensor([[4, 4, 4, 0, 0, 0]]), 3,
                           torch.tensor([4]), 3, 2)
    assert got[0].tolist() == [4, 4, 4]


def test_draft_model_is_lossless_with_stats_like_jax():
    _, tree = _tree()
    dcfg = dict(TINY, num_layers=1)
    _, dtree = _tree(dcfg, seed=9)
    prompt = np.random.RandomState(8).randint(0, 64, (2, 10)).astype(
        np.int32)
    toks, rounds, stats = _spec_both(TINY, tree, prompt, 12, draft_len=4,
                                     draft=(dcfg, dtree))
    np.testing.assert_array_equal(toks[1], toks[0])
    assert rounds[1] == rounds[0] == stats[1]["rounds"]
    assert stats[1] == stats[0]
    assert stats[1]["proposed"] == 4 * stats[1]["rounds"]
    # self-draft: every proposal verifies
    toks, rounds, stats = _spec_both(TINY, tree, prompt, 12, draft_len=4,
                                     draft=(TINY, tree))
    np.testing.assert_array_equal(toks[1], toks[0])
    assert stats[1] == stats[0] and stats[1]["accept_rate"] == 1.0
    assert stats[1]["rounds"] < 12


def test_quantized_model_and_draft_like_jax():
    """int8 weights dequantize at every verify, a quantized draft once:
    the tokens are the JAX package's over the same codes."""
    cfg_kw = dict(TINY, max_seq_len=64)
    _, tree = _tree(cfg_kw)
    tree = jax.tree.map(lambda x: x * 3.0, tree)
    prompt = np.random.RandomState(6).randint(0, 64, (1, 8)).astype(
        np.int32)
    jq = jqz.quantize_tree(_jnp(tree), min_size=512)
    jdraft = jqz.quantize_tree(_jnp(_first_block(tree)), min_size=512)
    dcfg = dict(cfg_kw, num_layers=1)
    want = jtr.generate_speculative(
        jtr.Transformer(jtr.TransformerConfig(**cfg_kw)), jq,
        jnp.asarray(prompt), 8, draft_model=jtr.Transformer(
            jtr.TransformerConfig(**dcfg)), draft_params=jdraft)
    tq = tqz.quantize_tree(tree, min_size=512)
    tdraft = tqz.quantize_tree(_first_block(tree), min_size=512)
    got = ttr.generate_speculative(
        ttr.Transformer(ttr.TransformerConfig(**cfg_kw), device="cpu"), tq,
        torch.from_numpy(prompt), 8,
        draft_model=_shell(dcfg), draft_params=tdraft)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = ttr.generate_speculative(_port(cfg_kw, tree), None,
                                     torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy()[:, 0], plain.numpy()[:, 0])


@pytest.mark.parametrize("kw,err", [
    ({"ngram": 0}, "ngram"),
    ({"draft_len": 0}, "draft_len"),
    ({"draft": "vocab"}, "vocab"),
    ({"draft": "no_params"}, "draft_params"),
])
def test_input_checks_raise_like_jax(kw, err):
    jmodel, tree = _tree(dict(TINY, max_seq_len=64))
    prompt = np.zeros((1, 8), np.int32)
    bad = dict(TINY, vocab_size=32, num_layers=1)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("draft") == "vocab":
        _, btree = _tree(bad, seed=1)
        jkw = dict(draft_model=jtr.Transformer(jtr.TransformerConfig(**bad)),
                   draft_params=_jnp(btree))
        tkw = dict(draft_model=_shell(bad), draft_params=btree)
    elif kw.get("draft") == "no_params":
        jkw = dict(draft_model=jtr.Transformer(jtr.TransformerConfig(**bad)))
        tkw = dict(draft_model=_shell(bad))
    with pytest.raises(ValueError, match=err):
        jtr.generate_speculative(jmodel, _jnp(tree), jnp.asarray(prompt), 8,
                                 **jkw)
    with pytest.raises(ValueError, match=err):
        ttr.generate_speculative(_port(dict(TINY, max_seq_len=64), tree),
                                 None, torch.from_numpy(prompt), 8, **tkw)


@pytest.mark.parametrize("max_new", [0, -3])
def test_nothing_to_generate_like_jax(max_new):
    jmodel, tree = _tree()
    prompt = np.zeros((2, 8), np.int32)
    jst, tst = {}, {}
    jout, jr = jtr.generate_speculative(jmodel, _jnp(tree),
                                        jnp.asarray(prompt), max_new,
                                        return_stats=True, stats=jst)
    out, r = ttr.generate_speculative(_port(TINY, tree), None,
                                      torch.from_numpy(prompt), max_new,
                                      return_stats=True, stats=tst)
    assert tuple(out.shape) == tuple(jout.shape) == (2, 0)
    assert r == jr == 0 and tst == jst


# ----------------------------------------------------------------------
# per-slot speculation on the continuous schedule
# ----------------------------------------------------------------------


def _serve(mod, predict, rows, slots=2, **kw):
    stats = {}
    out = list(mod.predict_rows(
        predict, [dict(r) for r in rows], {"prompt": "tokens"},
        batch_size=slots, schedule="continuous", stats=stats, **kw))
    return [np.asarray(r["generated"]).tolist() for r in out], stats


def _builders(cfg_kw, tree, **extra):
    cfg = dict(cfg_kw, **GEN, **extra)
    jcfg = dict(cfg, paged_impl="gather") if \
        cfg.get("kv_layout") == "paged" else cfg
    return (jtr.serving_builder(tree, jcfg),
            ttr.serving_builder(tree, dict(cfg, device="cpu")))


SPEC_COUNTERS = ("spec_accepted", "spec_proposed", "spec_accept_rate")


@pytest.mark.parametrize("layout", [{}, PAGED], ids=["contiguous", "paged"])
@pytest.mark.parametrize("draft", ["random", "self", "first_block"])
def test_continuous_speculation_matches_jax(layout, draft):
    """A random draft (nothing accepted), the model itself (everything
    accepted) and its own first block: the same tokens as plain greedy
    decode and the same accept counters as the JAX package."""
    _, tree = _tree()
    rows = [{"prompt": p} for p in _prompts([4, 7, 11, 2, 9])]
    if draft == "random":
        dcfg, dtree = dict(TINY, num_layers=1), _tree(
            dict(TINY, num_layers=1), seed=1)[1]
    elif draft == "self":
        dcfg, dtree = dict(TINY), tree
    else:
        dcfg, dtree = dict(TINY, num_layers=1), _first_block(tree)
    spec = dict(layout, draft_config=dcfg, draft_params=dtree, draft_len=3)
    jspec, tspec = _builders(TINY, tree, **spec)
    _, tplain = _builders(TINY, tree, **layout)
    ref, jst = _serve(jserving, jspec, rows)
    got, st = _serve(serving, tspec, rows)
    plain, _ = _serve(serving, tplain, rows)
    assert got == ref == plain
    assert {k: st[k] for k in SPEC_COUNTERS} == \
        {k: jst[k] for k in SPEC_COUNTERS}
    assert st["spec_proposed"] > 0
    if draft == "self":
        assert st["spec_accept_rate"] == 1.0
    if layout:
        assert st["pool_pages_used"] == 0


def test_paged_draft_on_the_flagship_stack_matches_jax():
    """GQA, a window and the int8 KV cache on the paged layout with a
    radix prefix cache: the draft keeps contiguous int8 banks and
    re-prefills whole prompts; tokens and counters equal the JAX
    package's and the contiguous run's."""
    _, tree = _tree(STACK)
    rng = np.random.RandomState(3)
    shared = rng.randint(0, 64, (12,)).astype(np.int32)
    rows = [{"prompt": np.concatenate([shared, rng.randint(
        0, 64, (int(n),)).astype(np.int32)])} for n in (3, 5, 2, 7)]
    spec = dict(draft_config=dict(STACK, num_layers=1),
                draft_params=_first_block(tree), draft_len=3)
    jpaged, tpaged = _builders(STACK, tree, **PAGED, prefix_cache=True,
                               prefix_block=4, **spec)
    _, tcontig = _builders(STACK, tree, **spec)
    ref, jst = _serve(jserving, jpaged, rows, slots=3)
    got, st = _serve(serving, tpaged, rows, slots=3)
    contig, cst = _serve(serving, tcontig, rows, slots=3)
    assert got == ref == contig
    assert st["spec_accepted"] == jst["spec_accepted"] == \
        cst["spec_accepted"]
    assert st["prefix_hits"] == jst["prefix_hits"] > 0


def test_eos_stops_speculative_rows_like_jax():
    _, tree = _tree()
    rows = [{"prompt": p} for p in _prompts([5, 9, 3], seed=4)]
    _, plain = _builders(TINY, tree)
    free, _ = _serve(serving, plain, rows)
    eos = free[0][2]
    spec = dict(draft_config=dict(TINY), draft_params=tree, draft_len=3,
                eos_id=eos)
    jspec, tspec = _builders(TINY, tree, **spec)
    stats = {}
    ref = list(jserving.predict_rows(jspec, [dict(r) for r in rows],
                                     {"prompt": "tokens"}, batch_size=2,
                                     schedule="continuous"))
    got = list(serving.predict_rows(tspec, [dict(r) for r in rows],
                                    {"prompt": "tokens"}, batch_size=2,
                                    schedule="continuous", stats=stats))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["generated"], r["generated"])
        assert int(g["generated_len"]) == int(r["generated_len"])
    assert int(got[0]["generated_len"]) <= 2


def test_verify_block_fits_the_slot_span():
    """The lookahead: a slot's table spans ``cache_len + draft_len + 1``
    positions, so the last verify block never leaves the slot's pages."""
    _, tree = _tree()
    dec = ttr.SlotDecoder(_port(TINY, tree), None, 2, 6, cache_len=30,
                          chunk_size=2, pad_multiple=16, kv_layout="paged",
                          page_tokens=4, draft_model=_port(TINY, tree),
                          draft_len=3)
    jdec = jtr.SlotDecoder(
        jtr.Transformer(jtr.TransformerConfig(**TINY)), _jnp(tree), 2, 6,
        cache_len=30, chunk_size=2, pad_multiple=16, kv_layout="paged",
        page_tokens=4, paged_impl="gather",
        draft_model=jtr.Transformer(jtr.TransformerConfig(**TINY)),
        draft_params=_jnp(tree), draft_len=3)
    assert dec._bank_len == jdec._bank_len == 34
    assert dec.tables.shape == jdec.tables.shape == (2, 9)
    assert tuple(dec.draft_cache[0]["k"].shape[:2]) == (2, 34)
    # a prompt at the admission bound decodes to the end inside its row
    p = np.arange(1, 25, dtype=np.int32) % 64
    first = dec.admit(0, p)
    jfirst = jdec.admit(0, p)
    assert int(first) == int(np.asarray(jfirst))
    for _ in range(3):
        toks, valid = dec.step_chunk()
        jtoks, jvalid = jdec.step_chunk()
        assert toks[0, :valid[0]].tolist() == \
            np.asarray(jtoks)[0, :int(jvalid[0])].tolist()


@pytest.mark.parametrize("kw,err", [
    ({"temperature": 0.7}, "greedy"),
    ({"draft_len": 0}, "draft_len"),
    ({"draft_params": None}, "draft_params"),
])
def test_decoder_guards_like_jax(kw, err):
    """Once refused: ``draft_model``/``draft_params`` build a speculative
    decoder, with the reference's checks."""
    jmodel, tree = _tree()
    base = dict(cache_len=40, chunk_size=2, pad_multiple=16)
    jkw = dict(base, draft_model=jmodel, draft_params=_jnp(tree))
    jkw.update(kw)
    tkw = dict(base, draft_model=_shell(TINY), draft_params=tree)
    tkw.update(kw)
    with pytest.raises(ValueError, match=err):
        jtr.SlotDecoder(jmodel, _jnp(tree), 2, 6, **jkw)
    with pytest.raises(ValueError, match=err):
        ttr.SlotDecoder(_port(TINY, tree), None, 2, 6, **tkw)


def test_draft_params_without_a_draft_model_are_ignored_like_jax():
    jmodel, tree = _tree()
    prompts = _prompts([5, 9])
    kw = dict(cache_len=40, chunk_size=2, pad_multiple=16)
    jdec = jtr.SlotDecoder(jmodel, _jnp(tree), 2, 6,
                           draft_params=_jnp(tree), **kw)
    dec = ttr.SlotDecoder(_port(TINY, tree), None, 2, 6, draft_params=tree,
                          **kw)
    assert not dec._spec and not jdec._spec
    for i, p in enumerate(prompts):
        assert int(dec.admit(i, p)) == int(np.asarray(jdec.admit(i, p)))
    assert dec.step_chunk()[0].tolist() == \
        np.asarray(jdec.step_chunk()[0]).tolist()


# ----------------------------------------------------------------------
# the static speculative predictor and the builder's keys
# ----------------------------------------------------------------------


@pytest.mark.parametrize("draft", [False, True], ids=["ngram", "draft"])
def test_static_speculative_predictor_matches_jax(draft):
    _, tree = _tree()
    rows = [{"prompt": p} for p in _prompts([8, 8, 8])]
    extra = dict(speculative=True, draft_len=3, ngram=2)
    if draft:
        extra.update(draft_config=dict(TINY), draft_params=tree)
    jspec, tspec = _builders(TINY, tree, **extra)
    _, plain = _builders(TINY, tree)
    ref = list(jserving.predict_rows(jspec, [dict(r) for r in rows],
                                     {"prompt": "tokens"}, batch_size=3,
                                     pad_to_batch=False))
    got = list(serving.predict_rows(tspec, [dict(r) for r in rows],
                                    {"prompt": "tokens"}, batch_size=3,
                                    pad_to_batch=False))
    want = list(serving.predict_rows(plain, [dict(r) for r in rows],
                                     {"prompt": "tokens"}, batch_size=3))
    for g, r, w in zip(got, ref, want):
        assert sorted(g) == sorted(r)
        np.testing.assert_array_equal(g["generated"], r["generated"])
        np.testing.assert_array_equal(g["generated"], w["generated"])
        if draft:
            assert float(g["accept_rate"]) == float(r["accept_rate"]) == 1.0
    assert tspec.last_spec_stats == jspec.last_spec_stats
    assert not hasattr(tspec, "make_slot_decoder")


def test_static_speculative_ragged_rows_named_error():
    _, tree = _tree()
    jspec, tspec = _builders(TINY, tree, speculative=True)
    rows = [{"prompt": p} for p in _prompts([8, 5, 8])]
    for mod, spec in ((jserving, jspec), (serving, tspec)):
        with pytest.raises(ValueError, match=r"row\(s\) \[\(1,"):
            list(mod.predict_rows(spec, rows, {"prompt": "tokens"},
                                  batch_size=3, pad_to_batch=False))


@pytest.mark.parametrize("extra,err", [
    ({"draft_config": {"num_layers": 1}}, "draft"),
    ({"draft_config": {"num_layers": 1}, "draft_params": "tree",
      "temperature": 0.7}, "greedy"),
    ({"speculative": True, "temperature": 0.7}, "greedy"),
])
def test_builder_speculation_guards_like_jax(extra, err):
    _, tree = _tree()
    extra = dict(extra)
    if extra.get("draft_params") == "tree":
        extra["draft_params"] = tree
    for builder, dev in ((jtr.serving_builder, {}),
                         (ttr.serving_builder, {"device": "cpu"})):
        with pytest.raises(ValueError, match=err):
            builder(tree, dict(TINY, **GEN, **extra, **dev))


def test_export_draft_sibling_crosses_both_packages(tmp_path):
    """``{"params": ..., "draft": ...}`` exports: the port writes one the
    JAX package reads unchanged, reads the JAX package's through
    ``convert_jax_export``, and serves its draft through
    ``draft_config`` like the JAX package does."""
    _, tree = _tree()
    dtree = _first_block(tree)
    port_dir = str(tmp_path / "port")
    ckpt.save_for_serving(port_dir, {"params": tree, "draft": dtree})
    jparams, _ = jckpt.load_for_serving(port_dir)
    jax_dir = jckpt.save_for_serving(str(tmp_path / "jax"),
                                     {"params": tree, "draft": dtree})
    tparams, _ = ckpt.load_for_serving(convert_jax_export.convert(
        jax_dir, str(tmp_path / "converted")))
    for got in (jparams, tparams):
        assert sorted(got) == ["draft", "params"]
        for path, leaf in convert._flatten(dtree).items():
            node = got["draft"]
            for k in path.split("/"):
                node = node[k]
            np.testing.assert_array_equal(np.asarray(node), leaf)
    rows = [{"prompt": p} for p in _prompts([6, 9, 4])]
    extra = dict(draft_config=dict(TINY, num_layers=1), draft_len=3)
    ref, jst = _serve(jserving, jtr.serving_builder(
        jparams, dict(TINY, **GEN, **extra)), rows)
    got, st = _serve(serving, ttr.serving_builder(
        tparams, dict(TINY, **GEN, **extra, device="cpu")), rows)
    assert got == ref
    assert st["spec_accepted"] == jst["spec_accepted"]


def test_swap_installs_the_draft_like_jax():
    """``swap_weights(draft_params=)`` installs the new draft; a
    rollback restores the old one.  Accept counters follow the JAX
    package's decoder through the same swaps."""
    _, tree = _tree()
    _, other = _tree(dict(TINY, num_layers=1), seed=5)
    prompts = _prompts([6, 10])
    kw = dict(cache_len=40, chunk_size=2, pad_multiple=16, draft_len=3)
    jm = jtr.Transformer(jtr.TransformerConfig(**TINY))
    jdec = jtr.SlotDecoder(jm, _jnp(tree), 2, 6, draft_model=jtr.Transformer(
        jtr.TransformerConfig(**dict(TINY, num_layers=1))),
        draft_params=_jnp(_first_block(tree)), **kw)
    dec = ttr.SlotDecoder(_port(TINY, tree), None, 2, 6,
                          draft_model=_shell(dict(TINY, num_layers=1)),
                          draft_params=_first_block(tree), **kw)

    def job(d):
        d.reset()
        for i, p in enumerate(prompts):
            d.admit(i, p)
        toks, valid = d.step_chunk()
        return [np.asarray(toks)[i, :int(valid[i])].tolist()
                for i in range(2)], d.spec_accepted

    assert job(dec) == job(jdec)
    snap, jsnap = dec.snapshot_weights(), jdec.snapshot_weights()
    dec.swap_weights(tree, draft_params=other)
    jdec.swap_weights(tree, draft_params=other)
    assert job(dec) == job(jdec)
    dec.restore_weights(snap)
    jdec.restore_weights(jsnap)
    assert job(dec) == job(jdec)


def test_published_draft_swaps_in_through_the_engine(tmp_path):
    """A published step whose export carries a ``"draft"`` sibling: the
    watcher splits it off and the engine's swap installs both trees
    (the reference's ``WeightSet.draft_params``).  The served tokens
    stay the plain greedy ones, and the new draft (the model's own
    first block) accepts where the random one did not."""
    from tensorflowonspark_tpu_torch import hot_swap

    _, tree = _tree()
    rows = [{"prompt": p} for p in _prompts([6, 9, 4, 7])]
    dcfg = dict(TINY, num_layers=1)
    _, rand = _tree(dcfg, seed=1)
    spec = ttr.serving_builder(tree, dict(
        TINY, **GEN, draft_config=dcfg, draft_params=rand, draft_len=3,
        device="cpu"))
    _, plain = _builders(TINY, tree)
    want, _ = _serve(serving, plain, rows)
    before, st0 = _serve(serving, spec, rows)
    root = str(tmp_path / "steps")
    ckpt.publish_for_serving(root, 1, dict(tree, draft=_first_block(tree)))
    watcher = hot_swap.CheckpointWatcher(root, poll_interval=0.0,
                                         background=False)
    try:
        after, st1 = _serve(serving, spec, rows, watcher=watcher,
                            rollback_window=1)
    finally:
        watcher.close()
    assert before == after == want
    assert st1["swaps"] == 1 and st1["weight_generation"] == 1
    dec = spec.make_slot_decoder(2)
    np.testing.assert_array_equal(
        dec.draft_model.embedding.detach().numpy(), tree["embedding"])
    assert dec.draft_model.cfg.num_layers == 1
    assert st1["spec_accepted"] > st0["spec_accepted"]
