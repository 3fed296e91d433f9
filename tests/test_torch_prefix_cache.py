"""The port's radix prefix cache and cached admits against the JAX
package's, on the CPU in f32.

- The radix (``prefix_cache.PrefixCache``): the same operation sequence on
  both packages gives the same matches, evictions, stats and
  fingerprints (exact: host bookkeeping).
- Cached admits on both KV layouts: the port's greedy tokens equal the
  JAX ``SlotDecoder``'s with a prefix cache (exact), for hits, a warm
  second job, eos and budgets, and a budget so small it thrashes.
- What a straight translation from JAX gets wrong: a contiguous extract
  that keeps a view of the lane, a paged suffix written into a shared
  page, refcounts of the pool and the radix out of step, and the pool's
  size and guards.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import prefix_cache as jpc  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu import serving_engine as jengine  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu_torch import prefix_cache as tpc  # noqa: E402
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch import serving_engine  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=8, embed_dim=16, mlp_dim=32, max_seq_len=96,
            dtype="float32")
LAYOUTS = ["contiguous", "paged"]


def _toks(*vals):
    return np.asarray(vals, np.int32)


# ----------------------------------------------------------------------
# the radix: one operation script, run on both packages
# ----------------------------------------------------------------------


def _insert(pc, tokens, first_block=0, nbytes=100):
    n_blocks = len(tokens) // pc.block_tokens
    payloads = ["blk%d" % i for i in range(first_block, n_blocks)]
    return pc.insert(tokens, payloads, first_block, nbytes)


def _ticks():
    it = iter(range(1, 1000))
    return lambda: next(it)


def _whole_blocks(m, out):
    pc = m.PrefixCache(block_tokens=4, mem_budget_bytes=1 << 20)
    prompt = np.arange(11, dtype=np.int32)
    out.append(_insert(pc, prompt))
    lease = pc.acquire(prompt)
    out.append((lease.n_blocks, lease.n_tokens, lease.payloads()))
    pc.release(lease)
    other = np.concatenate([prompt[:4], _toks(99, 98, 97, 96)])
    lease = pc.acquire(other)
    out.append(lease.n_tokens)
    pc.release(lease)
    out.append(pc.acquire(_toks(9, 9, 9, 9, 9)).n_tokens)
    out.append(pc.stats())


def _limit_tokens(m, out):
    pc = m.PrefixCache(block_tokens=4)
    prompt = np.arange(8, dtype=np.int32)
    _insert(pc, prompt)
    lease = pc.acquire(prompt, limit_tokens=7)
    out.append(lease.n_tokens)
    pc.release(lease)
    out.append([len(pc.match_blocks(prompt, n)) for n in range(10)])


def _dtype_keys(m, out):
    pc = m.PrefixCache(block_tokens=4)
    _insert(pc, np.arange(4, dtype=np.int64))
    out.append(pc.acquire(np.arange(4, dtype=np.int32)).n_tokens)


def _shared_nodes(m, out):
    pc = m.PrefixCache(block_tokens=4)
    a = np.arange(12, dtype=np.int32)
    b = np.concatenate([a[:8], _toks(50, 51, 52, 53)])
    _insert(pc, a)
    lease = pc.acquire(b, limit_tokens=11)
    out.append(_insert(pc, b, first_block=lease.n_blocks))
    pc.release(lease)
    out.append((pc.n_nodes, len(pc), pc.stats()))


def _refcount_pins(m, out):
    pc = m.PrefixCache(block_tokens=4, mem_budget_bytes=250)
    a, b, c = _toks(1, 2, 3, 4), _toks(5, 6, 7, 8), _toks(9, 10, 11, 12)
    _insert(pc, a)
    lease = pc.acquire(a)
    _insert(pc, b)
    _insert(pc, c)
    out.append((pc.acquire(a).n_tokens, pc.evictions))
    pc.release(lease)
    try:
        pc.release(lease)
    except ValueError as e:
        out.append(str(e))


def _drops_when_pinned(m, out):
    pc = m.PrefixCache(block_tokens=4, mem_budget_bytes=100)
    a = _toks(1, 2, 3, 4)
    _insert(pc, a)
    lease = pc.acquire(a)
    out.append((_insert(pc, _toks(9, 9, 9, 9)), pc.insert_drops))
    pc.release(lease)


def _interior_outlives(m, out):
    pc = m.PrefixCache(block_tokens=4, mem_budget_bytes=10_000,
                       clock=_ticks())
    a = np.arange(8, dtype=np.int32)
    _insert(pc, a, nbytes=100)
    out.append((pc.evict_cold(150), pc.n_nodes, pc.acquire(a).n_tokens))


def _lru_order(m, out):
    pc = m.PrefixCache(block_tokens=4, mem_budget_bytes=10_000,
                       clock=_ticks())
    a, b = _toks(1, 2, 3, 4), _toks(5, 6, 7, 8)
    _insert(pc, a, nbytes=100)
    _insert(pc, b, nbytes=100)
    pc.release(pc.acquire(a))
    pc.evict_cold(100)
    out.append((pc.acquire(a).n_tokens, pc.acquire(b).n_tokens))


def _budget(m, out):
    pc = m.PrefixCache(block_tokens=4, mem_budget_bytes=1000)
    _insert(pc, np.arange(12, dtype=np.int32), nbytes=100)
    out.append((pc.bytes_used, len(pc)))
    out.append(pc.clear())
    out.append(pc.stats())


def _release_fn_and_census(m, out):
    released = []
    pool = m.PagePool(16)
    pc = m.PrefixCache(block_tokens=4, mem_budget_bytes=1000,
                       release_fn=released.append)
    pages = pool.alloc(4)
    committed = []
    pc.insert(np.arange(16, dtype=np.int32), pages, 0, 100,
              on_insert=committed.append)
    pool.retain(committed)
    out.append((committed, pc.insert_drops, pc.page_census(),
                pool.refcount_census(), pool.stats()["pool_pages_shared"]))
    out.append((pc.evict_blocks(2), sorted(released)))
    pool.release(pages)
    out.append(pool.refcount_census())


RADIX_SCRIPTS = {
    "insert_lookup_whole_blocks_only": _whole_blocks,
    "limit_tokens_caps_match": _limit_tokens,
    "dtype_normalized_keys": _dtype_keys,
    "shared_prefix_is_shared_nodes": _shared_nodes,
    "refcount_blocks_eviction_until_release": _refcount_pins,
    "insert_drops_when_everything_pinned": _drops_when_pinned,
    "interior_nodes_outlive_leaf_eviction": _interior_outlives,
    "lru_eviction_order": _lru_order,
    "budget_accounting": _budget,
    "release_fn_and_page_census": _release_fn_and_census,
}


@pytest.mark.parametrize("name", sorted(RADIX_SCRIPTS))
def test_radix_matches_jax(name):
    got, want = [], []
    RADIX_SCRIPTS[name](tpc, got)
    RADIX_SCRIPTS[name](jpc, want)
    assert got == want


def _fp_geometries(m):
    rng = np.random.RandomState(0)
    head = rng.randint(1, 64, (m.FINGERPRINT_TOKENS,))
    a = np.concatenate([head, rng.randint(1, 64, (9,))])
    b = np.concatenate([head, rng.randint(1, 64, (21,))])
    caches = [m.PrefixCache(block_tokens=w) for w in (4, 8, 16, 32)]
    return ([pc.fingerprint(a) for pc in caches],
            [pc.fingerprint(b) for pc in caches], m.fingerprint(a))


def _fp_heads(m):
    rng = np.random.RandomState(1)
    a = rng.randint(1, 64, (24,)).astype(np.int32)
    b = a.copy()
    b[3] += 1
    c = a.copy()
    c[m.FINGERPRINT_TOKENS + 2] += 1
    return [m.fingerprint(x) for x in (a, b, c, a.astype(np.int64))]


def _fp_short(m):
    return [m.fingerprint(x) for x in (_toks(5, 6, 7), [5, 6, 7], [5, 6])]


def _fp_width(m):
    a = _toks(*range(1, 33))
    b = np.concatenate([a[:8], _toks(*range(50, 74))])
    return [m.fingerprint(a, width=8), m.fingerprint(b, width=8),
            m.fingerprint(a), m.fingerprint(b)]


@pytest.mark.parametrize("fn", [_fp_geometries, _fp_heads, _fp_short,
                                _fp_width],
                         ids=["geometries", "heads_and_dtype", "short",
                              "width"])
def test_fingerprint_matches_jax(fn):
    got = fn(tpc)
    assert got == fn(jpc)
    assert tpc.FINGERPRINT_TOKENS == jpc.FINGERPRINT_TOKENS
    if fn is _fp_geometries:
        assert len(set(got[0])) == 1 and set(got[0]) == set(got[1])
    if fn is _fp_heads:
        assert got[0] != got[1] and got[0] == got[2] == got[3]


# ----------------------------------------------------------------------
# cached admits through the engine, both layouts, against the JAX engine
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree():
    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _shared_rows(n_rows, shared_len=24, seed=3, vocab=64):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, (shared_len,)).astype(np.int32)
    rows = []
    for i in range(n_rows):
        if i % 4 == 3:  # a cold minority
            rows.append({"prompt": rng.randint(
                0, vocab, (rng.randint(3, 20),)).astype(np.int32)})
        else:
            tail = rng.randint(0, vocab, (rng.randint(2, 9),))
            rows.append({"prompt": np.concatenate(
                [shared, tail.astype(np.int32)])})
    return rows


def _cfg(layout, max_new=6, **extra):
    cfg = dict(TINY, mode="generate", max_new_tokens=max_new,
               pad_multiple=16, kv_layout=layout, **extra)
    if layout == "paged":
        cfg.setdefault("kv_page_tokens", extra.get("prefix_block", 16))
    return cfg


def _jax(tree, cfg):
    return jtr.serving_builder(tree, dict(cfg, paged_impl="gather")
                               if cfg["kv_layout"] == "paged" else cfg)


def _port(tree, cfg):
    return ttr.serving_builder(tree, dict(cfg, device="cpu"))


def _run(mod, predict, rows, mapping=None, slots=3, **kw):
    stats = {}
    out = list(mod.predict_rows(
        predict, [dict(r) for r in rows], mapping or {"prompt": "tokens"},
        batch_size=slots, schedule="continuous", stats=stats, **kw))
    return out, stats


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]),
                                          err_msg="%d %s" % (i, key))


PREFIX = dict(prefix_cache=True, prefix_block=8)
_REUSE = ("prefix_hits", "prefix_tokens_saved", "evictions")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_hit_matches_jax_and_cold(tree, layout):
    rows = _shared_rows(8)
    want, wstats = _run(jserving, _jax(tree, _cfg(layout, **PREFIX)), rows)
    cold, _ = _run(serving, _port(tree, _cfg(layout)), rows)
    got, stats = _run(serving, _port(tree, _cfg(layout, **PREFIX)), rows)
    _assert_same(got, want)
    _assert_same(cold, want)
    assert stats["prefix_hits"] > 0
    assert {k: stats[k] for k in _REUSE} == {k: wstats[k] for k in _REUSE}
    assert stats["prefix_hit_admits"] == stats["prefix_hits"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_warm_second_job_matches_jax(tree, layout):
    rows = _shared_rows(8)
    jpred = _jax(tree, _cfg(layout, **PREFIX))
    tpred = _port(tree, _cfg(layout, **PREFIX))
    for job in range(2):
        want, wstats = _run(jserving, jpred, rows)
        got, stats = _run(serving, tpred, rows)
        _assert_same(got, want)
        assert {k: stats[k] for k in _REUSE} == \
            {k: wstats[k] for k in _REUSE}
    # the memoized decoder's cache stayed warm: the second job hit more
    assert stats["prefix_hits"] >= 6


@pytest.mark.parametrize("layout", LAYOUTS)
def test_eos_and_budgets_match_jax(tree, layout):
    rows = _shared_rows(8)
    free, _ = _run(serving, _port(tree, _cfg(layout, max_new=8)), rows)
    eos = int(np.asarray(free[0]["generated"])[2])
    for r, b in zip(rows, [2, 6, 8, 3, 5, 8, 1, 7]):
        r["max_new"] = b
    mapping = {"prompt": "tokens", "max_new": "max_new"}
    cfg = _cfg(layout, max_new=8, eos_id=eos, **PREFIX)
    want, _ = _run(jserving, _jax(tree, cfg), rows, mapping)
    got, _ = _run(serving, _port(tree, cfg), rows, mapping)
    _assert_same(got, want)
    assert any(int(r["generated_len"]) < 8 for r in got)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tiny_budget_thrashes_but_stays_exact(tree, layout):
    """A budget of two blocks under prompts of three shared blocks: the
    tokens equal the JAX engine's without a cache (and, on the
    contiguous layout, with its cache too).  The port never evicts the
    block an insert is extending (the JAX radix does, which on its paged
    layout frees a page a slot still holds: ROADMAP C)."""
    rows = _shared_rows(8)
    cfg = _cfg(layout, prefix_mem_mb=0.004, **PREFIX)
    want, _ = _run(jserving, _jax(tree, _cfg(layout)), rows)
    tpred = _port(tree, cfg)
    got, stats = _run(serving, tpred, rows)
    _assert_same(got, want)
    if layout == "contiguous":
        cached, _ = _run(jserving, _jax(tree, cfg), rows)
        _assert_same(got, cached)
    dec = tpred.make_slot_decoder(3)
    pc = dec.prefix_cache
    assert pc.bytes_used <= int(0.004 * (1 << 20))
    assert pc.insert_drops > 0 and stats["prefix_hits"] > 0
    # every counted byte is a block reachable from the root
    assert pc.bytes_used == len(pc.page_census()) * (pc.bytes_used // len(pc))
    if layout == "paged":
        assert _balanced(dec)


def test_insert_never_evicts_the_block_it_extends():
    pool = tpc.PagePool(8)
    pc = tpc.PrefixCache(block_tokens=4, mem_budget_bytes=200,
                         release_fn=lambda p: pool.release([p]))
    pages = pool.alloc(3)
    committed = []
    assert pc.insert(np.arange(12, dtype=np.int32), pages, 0, 100,
                     on_insert=committed.append) == 2
    pool.retain(committed)
    assert pc.insert_drops == 1 and committed == pages[:2]
    assert pc.page_census() == sorted(pages[:2]) and len(pc) == 2
    assert pool.refcount_census() == {pages[0]: 2, pages[1]: 2,
                                      pages[2]: 1}


# ----------------------------------------------------------------------
# what a straight translation gets wrong
# ----------------------------------------------------------------------


def _decoder(tree, layout, prefix=True):
    return ttr.SlotDecoder(
        ttr.Transformer(ttr.TransformerConfig(**TINY), device="cpu"), tree,
        2, 6, cache_len=64, chunk_size=2, pad_multiple=16,
        kv_layout=layout, paged_impl="kernel",
        prefix_cache=tpc.PrefixCache(block_tokens=8) if prefix else None)


def _greedy(dec, slot, prompt, chunks=2):
    first = int(dec.admit(slot, prompt))
    toks = [first]
    for _ in range(chunks):
        block, _ = dec.step_chunk()
        toks.extend(block[slot].tolist())
    return toks


def _cold_tokens(tree, layout, prompt, chunks=2):
    return _greedy(_decoder(tree, layout, prefix=False), 0, prompt, chunks)


def test_contiguous_payloads_survive_lane_reuse(tree):
    """The extract copies the lane: after a different prompt is admitted
    into the donor's lane, a hit on the first prompt's prefix installs
    the first prompt's KV (a view would now hold the second's)."""
    rng = np.random.RandomState(5)
    a = rng.randint(0, 64, (26,)).astype(np.int32)
    b = rng.randint(0, 64, (26,)).astype(np.int32)
    a2 = np.concatenate([a[:24], rng.randint(0, 64, (5,)).astype(np.int32)])
    dec = _decoder(tree, "contiguous")
    _greedy(dec, 0, a, chunks=0)
    payloads = dec.prefix_cache.acquire(a, limit_tokens=25)
    assert payloads.n_tokens == 24
    seg = payloads.payloads()[0].segment
    dec.prefix_cache.release(payloads)
    before = [t.clone() for t in seg]
    banks = {t.untyped_storage().data_ptr() for t in dec._banks()}
    assert not banks & {t.untyped_storage().data_ptr() for t in seg}
    dec.evict(0)
    _greedy(dec, 0, b, chunks=0)  # overwrites lane 0
    dec.evict(0)
    for x, y in zip(seg, before):
        assert torch.equal(x, y)
    got = _greedy(dec, 1, a2)
    assert dec.last_admit_cached_tokens == 24
    assert got == _cold_tokens(tree, "contiguous", a2)


def test_paged_cached_admit_never_writes_a_shared_page(tree):
    rng = np.random.RandomState(6)
    a = rng.randint(0, 64, (26,)).astype(np.int32)
    a2 = np.concatenate([a[:24], rng.randint(0, 64, (7,)).astype(np.int32)])
    dec = _decoder(tree, "paged")
    _greedy(dec, 0, a, chunks=0)
    shared = dec.prefix_cache.page_census()
    assert len(shared) == 3
    snap = [{n: t[shared].clone() for n, t in layer.items()}
            for layer in dec.cache]
    got = _greedy(dec, 1, a2, chunks=2)
    assert dec.last_admit_cached_tokens == 24
    assert list(dec.tables[1][:3]) == shared
    for layer, old in zip(dec.cache, snap):
        for n, t in layer.items():
            assert torch.equal(t[shared], old[n]), n
    assert got == _cold_tokens(tree, "paged", a2)


def _balanced(dec):
    census = dec.page_pool.refcount_census()
    return census == {p: 1 for p in dec.prefix_cache.page_census()}


def test_pool_and_radix_refcounts_stay_in_step(tree):
    rows = _shared_rows(8)
    tpred = _port(tree, _cfg("paged", **PREFIX))
    _run(serving, tpred, rows, slots=2)
    dec = tpred.make_slot_decoder(2)
    assert _balanced(dec) and dec.prefix_cache.page_census()
    # a slot in flight on shared pages holds its own references
    dec.admit(0, rows[0]["prompt"])
    census = dec.page_pool.refcount_census()
    assert any(v == 2 for v in census.values())
    dec.evict(0)
    assert _balanced(dec)
    dec.admit(1, rows[1]["prompt"])
    dec.step_chunk()
    dec.reset()
    assert _balanced(dec)
    dec.prefix_cache.evict_blocks(2)
    assert _balanced(dec)
    dec.prefix_cache.clear()
    assert dec.page_pool.refcount_census() == {}
    assert dec.page_pool.available() == dec.page_pool.num_pages - 1


@pytest.mark.parametrize("extra,budget_mb", [
    ({}, 256.0), ({}, 0.01), ({"cache_dtype": "int8"}, 256.0),
    ({"cache_dtype": "int8"}, 0.004),
], ids=["default", "small_budget", "int8", "int8_small_budget"])
def test_pool_size_matches_jax(tree, extra, budget_mb):
    """With a prefix cache the pool gains min(budget pages, max(2 x slots
    x span, 64)) pages over the slots' spans, pages counted with int8
    scale pages, as the JAX decoder sizes it."""
    cfg = dict(TINY, **extra)
    kw = dict(cache_len=64, chunk_size=2, pad_multiple=16,
              kv_layout="paged", page_tokens=8)
    jmodel = jtr.Transformer(jtr.TransformerConfig(**cfg))
    jdec = jtr.SlotDecoder(
        jmodel, tree, 2, 6, paged_impl="gather",
        prefix_cache=jpc.PrefixCache(8, int(budget_mb * (1 << 20))), **kw)
    tdec = ttr.SlotDecoder(
        ttr.Transformer(ttr.TransformerConfig(**cfg), device="cpu"), tree,
        2, 6, prefix_cache=tpc.PrefixCache(8, int(budget_mb * (1 << 20))),
        **kw)
    assert tdec.page_pool.num_pages == jdec.page_pool.num_pages
    assert tdec._page_nbytes == jdec._page_nbytes
    assert tdec.model.cfg.kv_pages == tdec.page_pool.num_pages


class TestGuards:
    def _model(self):
        return ttr.Transformer(ttr.TransformerConfig(
            vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
            embed_dim=16, mlp_dim=32, max_seq_len=64, dtype="float32"),
            device="cpu")

    def test_page_tokens_must_match_radix_block(self):
        with pytest.raises(ValueError, match="block_tokens"):
            ttr.SlotDecoder(self._model(), None, 2, 4,
                            prefix_cache=tpc.PrefixCache(block_tokens=8),
                            kv_layout="paged", page_tokens=16)

    def test_shared_radix_across_pools_rejected(self):
        pc = tpc.PrefixCache(block_tokens=16)
        ttr.SlotDecoder(self._model(), None, 2, 4, prefix_cache=pc,
                        kv_layout="paged")
        with pytest.raises(ValueError, match="page pool"):
            ttr.SlotDecoder(self._model(), None, 2, 4, prefix_cache=pc,
                            kv_layout="paged")

    def test_radix_must_be_empty_at_attach(self):
        pc = tpc.PrefixCache(block_tokens=16)
        _insert(pc, np.arange(16, dtype=np.int32))
        with pytest.raises(ValueError, match="EMPTY"):
            ttr.SlotDecoder(self._model(), None, 2, 4, prefix_cache=pc,
                            kv_layout="paged")

    def test_pool_exhaustion_names_the_pool(self):
        pc = tpc.PrefixCache(block_tokens=16)
        dec = ttr.SlotDecoder(self._model(), None, 1, 4, prefix_cache=pc,
                              kv_layout="paged", kv_pages=5)
        dec.page_pool.alloc(dec.page_pool.available())
        with pytest.raises(RuntimeError, match="pool_pages"):
            dec.admit(0, np.arange(5, dtype=np.int32))

    def test_page_tokens_default_to_the_block(self):
        pc = tpc.PrefixCache(block_tokens=8)
        dec = ttr.SlotDecoder(self._model(), None, 2, 4, prefix_cache=pc,
                              kv_layout="paged")
        assert dec.model.cfg.kv_page_tokens == 8


def test_builder_caches_per_geometry_and_keeps_them_warm(tree):
    tpred = _port(tree, _cfg("paged", **PREFIX))
    a, b = tpred.make_slot_decoder(2), tpred.make_slot_decoder(3)
    assert a.prefix_cache is not b.prefix_cache
    assert tpred.make_slot_decoder(2).prefix_cache is a.prefix_cache
    cpred = _port(tree, _cfg("contiguous", **PREFIX))
    assert cpred.make_slot_decoder(2).prefix_cache is \
        cpred.make_slot_decoder(3).prefix_cache
    assert a.prefix_cache.block_tokens == 8
    assert cpred.make_slot_decoder(2).prefix_cache.mem_budget_bytes == \
        256 << 20


@pytest.mark.parametrize("layout", LAYOUTS)
def test_watchdog_recovery_with_prefix_cache(tree, layout):
    """The wedged chunk is abandoned and the in-flight requests re-admit
    through the cached path: tokens equal a cold run's, with no decode
    step added beyond the lost chunk's."""
    import time

    class WedgeOnce:
        fired = 0

        def __call__(self, chunk_index):
            if self.fired == 0 and chunk_index >= 1:
                self.fired += 1
                time.sleep(1.0)

    rows = _shared_rows(6)
    cold, cstats = _run(serving, _port(tree, _cfg(layout, chunk_size=2)),
                        rows, slots=2)
    warm = _port(tree, _cfg(layout, chunk_size=2, **PREFIX))
    wedge = WedgeOnce()
    stats = {}
    eng = serving_engine.ServingEngine(
        warm, {"prompt": "tokens"}, num_slots=2, watchdog_timeout=0.5,
        wedge_fn=wedge, stats=stats)
    out = list(eng.serve([dict(r) for r in rows]))
    assert wedge.fired == 1 and stats["watchdog_fires"] == 1
    assert stats["recovered"] >= 1
    _assert_same(out, cold)
    # the engine counts the chunks that resolved: the lost one is not
    # among them, and the recovery needs no more than the cold run
    assert stats["chunks"] <= cstats["chunks"] + 1


def test_degrade_pressure_evicts_cold_branches(tree):
    rows = _shared_rows(12)
    for mod, build in ((serving, _port), (jserving, _jax)):
        pred = build(tree, _cfg("contiguous", prefix_mem_mb=0.01, **PREFIX))
        _run(mod, pred, _shared_rows(6, seed=9))
        out, stats = _run(mod, pred, rows, slots=2, policy="degrade",
                          queue_depth=2)
        assert len(out) == len(rows) and stats["degraded"] > 0
        if mod is serving:
            got = (out, stats["pressure_evictions"])
        else:
            want = (out, stats["pressure_evictions"])
    _assert_same(got[0], want[0])
    assert got[1] == want[1] > 0
    assert jengine.POLICIES == serving_engine.POLICIES
