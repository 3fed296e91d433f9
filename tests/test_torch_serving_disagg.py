"""Prefill/decode disaggregation in the port against the JAX package, on
the CPU in f32: the page pool's handoff leases (owner, deadline, reaping,
the lease table), the ``PrefillWorker`` → ``SlotDecoder.adopt`` handoff
(zero copy: an adopt whose only device ops are the slot's state writes,
leaving every pool's storage and version alone, the handoff drained), the disaggregated engine (tokens equal to
the unified engine's and to the JAX package's, one merged trace per
request, the ledger's prefill/decode split, TTFT, the health plane's
``prefill`` share), and the chaos prefill faults ``kill_prefill``,
``wedge_prefill`` and ``leak_lease``, contained with the same tokens and
with the pool balanced after every fault family.
"""

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import prefix_cache as jpc  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu import serving_disagg as jdisagg  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu_torch import serving, serving_engine  # noqa: E402
from tensorflowonspark_tpu_torch import telemetry  # noqa: E402
from tensorflowonspark_tpu_torch import convert  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.prefix_cache import (  # noqa: E402
    PagePool, PoolExhausted, PrefixCache,
)
from tensorflowonspark_tpu_torch.serving_disagg import (  # noqa: E402
    Handoff, PrefillAbandoned, PrefillWorker, PrefillWorkerDead,
)
from tensorflowonspark_tpu_torch.telemetry import journal as journal_mod  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import ledger as ledger_mod  # noqa: E402
from tensorflowonspark_tpu_torch.testing import chaos  # noqa: E402

#: the flagship feature stack at test size: GQA, a window, the int8 KV
#: cache, pages of 4 tokens shared with a radix prefix cache
FLAGSHIP = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=128,
                dtype="float32", attention_window=24, cache_dtype="int8")
PAGED = dict(kv_layout="paged", kv_page_tokens=4, prefix_cache=True,
             prefix_block=4)
GEN = dict(mode="generate", max_new_tokens=6, pad_multiple=16,
           chunk_size=2)
#: watchdog of the fault tests, and the hang of their wedges
WATCHDOG, HANG = 2.0, 4.0


class _DeviceOps(TorchDispatchMode):
    """Records the ops that reach a backend and are not views: on a card
    each one is a kernel launch or a copy."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _tree(seed=0):
    model = jtr.Transformer(jtr.TransformerConfig(**FLAGSHIP))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _predict(tree, **extra):
    return ttr.serving_builder(tree, dict(
        FLAGSHIP, **dict(GEN, **PAGED, **extra), device="cpu"))


def _jax_predict(tree, **extra):
    return jtr.serving_builder(tree, dict(
        FLAGSHIP, **dict(GEN, **PAGED, **extra), paged_impl="gather"))


def _shared_rows(n_rows, shared_len=12, seed=3, vocab=64):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, (shared_len,)).astype(np.int32)
    rows = []
    for i in range(n_rows):
        if i % 4 == 3:  # a cold minority
            rows.append({"prompt": rng.randint(
                0, vocab, (rng.randint(3, 20),)).astype(np.int32)})
        else:
            tail = rng.randint(0, vocab, (rng.randint(2, 9),)).astype(
                np.int32)
            rows.append({"prompt": np.concatenate([shared, tail])})
    return rows


def _rows(lens, seed=3, vocab=64):
    rng = np.random.RandomState(seed)
    return [{"prompt": rng.randint(1, vocab, (n,)).astype(np.int32)}
            for n in lens]


def _run(mod, predict, rows, slots=3, mapping=None, **kw):
    stats = {}
    out = list(mod.predict_rows(
        predict, [dict(r) for r in rows], mapping or {"prompt": "tokens"},
        batch_size=slots, schedule="continuous", stats=stats, **kw))
    return out, stats


def _tokens(out):
    return [np.asarray(r["generated"]).tolist() for r in out]


def _decoder(tree, prefix=True, **kw):
    model = convert.params_from_flax(
        tree, ttr.TransformerConfig(**FLAGSHIP), device="cpu")
    pc = (PrefixCache(block_tokens=4, mem_budget_bytes=1 << 22)
          if prefix else None)
    return ttr.SlotDecoder(model, None, 3, 6, cache_len=48, chunk_size=2,
                           pad_multiple=16, prefix_cache=pc,
                           kv_layout="paged", page_tokens=4, **kw)


def _jax_decoder(tree, prefix=True):
    pc = (jpc.PrefixCache(block_tokens=4, mem_budget_bytes=1 << 22)
          if prefix else None)
    return jtr.SlotDecoder(
        jtr.Transformer(jtr.TransformerConfig(**FLAGSHIP)),
        jax.tree.map(jnp.asarray, tree), 3, 6, cache_len=48, chunk_size=2,
        pad_multiple=16, prefix_cache=pc, kv_layout="paged", page_tokens=4,
        paged_impl="gather")


def _pool_tensors(dec):
    return [t for layer in dec.cache for t in layer.values()]


def _balanced(dec):
    """The quiesced pool's balance: every live page is one the radix
    holds, at one reference; nothing in flight; the trash page never
    referenced.  Returns the problems found (empty when balanced)."""
    pool = dec.page_pool
    census = pool.refcount_census()
    radix = dec.prefix_cache.page_census() if dec.prefix_cache else []
    problems = []
    if census != {p: 1 for p in radix}:
        problems.append("pages never rebalanced: census {0} vs radix "
                        "{1}".format(census, radix))
    st = pool.stats()
    if st["pool_pages_handoff"] or st["pool_leases"]:
        problems.append("in flight: {0}".format(pool.lease_table()))
    if any(p < pool.reserved for p in census):
        problems.append("trash page referenced")
    return problems


# ----------------------------------------------------------------------
# the pool's handoff leases, held against the JAX package's pool
# ----------------------------------------------------------------------


def _both_pools(num_pages, **kw):
    clk = [0.0]
    return clk, [cls(num_pages, clock=lambda: clk[0], **kw)
                 for cls in (jpc.PagePool, PagePool)]


def _same(fn, pools):
    """Run ``fn`` on each pool; the outcomes (value or error type and
    text) must agree."""
    outs = []
    for pool in pools:
        try:
            outs.append(("ok", fn(pool)))
        except Exception as e:  # noqa: BLE001 - compared below
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1], outs
    return outs[1]


class TestLeases:
    def test_lease_names_owner_age_and_deadline(self):
        clk, pools = _both_pools(8)
        pages = _same(lambda p: p.alloc(3), pools)[1]
        lease = _same(lambda p: p.begin_handoff(
            pages, owner="req-7", deadline_sec=2.0), pools)[1]
        clk[0] = 1.0
        (rec,) = _same(lambda p: p.handoff_leases(), pools)[1]
        assert rec["lease"] == lease and rec["owner"] == "req-7"
        assert rec["pages"] == 3 and rec["age_sec"] == pytest.approx(1.0)
        assert rec["deadline_sec"] == 2.0 and not rec["expired"]
        assert "req-7" in _same(lambda p: p.lease_table(), pools)[1]
        clk[0] = 3.5
        assert _same(lambda p: p.handoff_leases(), pools)[1][0]["expired"]
        assert "EXPIRED" in _same(lambda p: p.lease_table(), pools)[1]

    def test_reap_by_owner_balances_refcounts(self):
        _, pools = _both_pools(8)
        pages = _same(lambda p: p.alloc(3), pools)[1]
        _same(lambda p: p.begin_handoff(pages, owner="req-7"), pools)
        reaped = _same(lambda p: p.reap_orphans(owner="req-7"), pools)[1]
        assert [r["owner"] for r in reaped] == ["req-7"]
        assert _same(lambda p: p.refcount_census(), pools)[1] == {}
        st = _same(lambda p: p.stats(), pools)[1]
        assert st["pool_pages_handoff"] == st["pool_leases"] == 0
        assert _same(lambda p: p.available(), pools)[1] == 7

    def test_reap_by_deadline_touches_only_expired(self):
        clk, pools = _both_pools(16)
        old = _same(lambda p: p.alloc(2), pools)[1]
        young = _same(lambda p: p.alloc(2), pools)[1]
        _same(lambda p: p.begin_handoff(old, owner="old",
                                        deadline_sec=0.5), pools)
        _same(lambda p: p.begin_handoff(young, owner="young",
                                        deadline_sec=5.0), pools)
        clk[0] = 1.0
        reaped = _same(lambda p: p.reap_orphans(), pools)[1]
        assert [r["owner"] for r in reaped] == ["old"]
        forever = _same(lambda p: p.alloc(1), pools)[1]
        _same(lambda p: p.begin_handoff(forever, owner="forever"), pools)
        clk[0] = 1e9
        # an un-deadlined lease is reaped by owner only, never by age
        assert [r["owner"] for r in _same(lambda p: p.reap_orphans(),
                                          pools)[1]] == ["young"]
        assert [r["owner"] for r in _same(lambda p: p.handoff_leases(),
                                          pools)[1]] == ["forever"]

    def test_reap_of_shared_page_releases_exactly_one_ref(self):
        _, pools = _both_pools(8)
        pages = _same(lambda p: p.alloc(2), pools)[1]  # the radix's ref
        _same(lambda p: p.retain(pages), pools)        # the handoff's
        _same(lambda p: p.begin_handoff(pages, owner="req-1"), pools)
        _same(lambda p: p.reap_orphans(owner="req-1"), pools)
        assert _same(lambda p: p.refcount_census(), pools)[1] == \
            {int(p): 1 for p in pages}
        _same(lambda p: p.release(pages), pools)
        assert _same(lambda p: p.refcount_census(), pools)[1] == {}

    def test_pool_exhausted_names_the_owning_lease(self):
        _, pools = _both_pools(4)
        pages = _same(lambda p: p.alloc(3), pools)[1]
        _same(lambda p: p.begin_handoff(pages, owner="req-42"), pools)
        err = _same(lambda p: p.alloc(2), pools)
        assert err[0] == "PoolExhausted" and "req-42" in err[1]
        with pytest.raises(PoolExhausted, match="req-42"):
            pools[1].alloc(2)

    def test_end_handoff_drains_leases_page_by_page(self):
        _, pools = _both_pools(8)
        pages = _same(lambda p: p.alloc(4), pools)[1]
        _same(lambda p: p.begin_handoff(pages, owner="r"), pools)
        _same(lambda p: p.end_handoff(pages[:2]), pools)
        assert _same(lambda p: p.stats(), pools)[1]["pool_leases"] == 1
        _same(lambda p: p.end_handoff(pages[2:]), pools)
        st = _same(lambda p: p.stats(), pools)[1]
        assert st["pool_leases"] == st["pool_pages_handoff"] == 0

    def test_begin_handoff_on_free_page_raises(self):
        _, pools = _both_pools(8)
        err = _same(lambda p: p.begin_handoff([7]), pools)
        assert err[0] == "ValueError" and "free page" in err[1]

    def test_reserved_trash_pages_never_allocated(self):
        _, pools = _both_pools(4, reserved=2)
        assert min(_same(lambda p: p.alloc(2), pools)[1]) >= 2
        assert _same(lambda p: p.alloc(1), pools)[0] == "PoolExhausted"


# ----------------------------------------------------------------------
# the handoff protocol
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree():
    return _tree()


class TestHandoff:
    def test_zero_copy_and_first_token_like_jax(self, tree):
        dec, jdec = _decoder(tree), _jax_decoder(tree)
        w, jw = PrefillWorker(dec), jdisagg.PrefillWorker(jdec)
        p = np.random.RandomState(1).randint(0, 64, (19,)).astype(np.int32)
        h, jh = w.prefill(p), jw.prefill(p)
        assert w.last_prefill_dispatches == 1
        assert h.pages == jh.pages and h.n_tokens == jh.n_tokens == 19
        assert dec.page_pool.stats()["pool_pages_handoff"] == len(h.pages)
        before = [(t.data_ptr(), t._version) for t in _pool_tensors(dec)]
        with _DeviceOps() as seen:
            first = dec.adopt(0, h)
        jfirst = jdec.adopt(0, jh)
        # the adopt reads and writes no pool: same storage, same version
        assert [(t.data_ptr(), t._version)
                for t in _pool_tensors(dec)] == before
        # its device ops are the four state writes, as counted; the
        # reference's adopt is one jitted program of the same writes
        assert seen.ops == ["aten.copy_.default"] * 4
        assert dec.last_adopt_dispatches == len(seen.ops)
        assert jdec.last_adopt_dispatches == dec.last_admit_dispatches == 1
        assert dec.page_pool.stats()["pool_pages_handoff"] == 0
        assert dec.page_pool.stats()["pool_leases"] == 0
        assert dec.active[0] and int(first) == int(np.asarray(jfirst))
        assert dec.tables[0].tolist() == np.asarray(jdec.tables[0]).tolist()
        toks, _ = dec.step_chunk()
        jtoks, _ = jdec.step_chunk()
        assert toks[0].tolist() == np.asarray(jtoks)[0].tolist()

    def test_adopted_decode_equals_a_unified_admit(self, tree):
        split, unified = _decoder(tree), _decoder(tree)
        w = PrefillWorker(split)
        prompts = [p["prompt"] for p in _shared_rows(3)]
        for slot, p in enumerate(prompts):
            a = split.adopt(slot, w.prefill(p))
            b = unified.admit(slot, p)
            assert int(a) == int(b)
            assert split.last_admit_cached_tokens == \
                unified.last_admit_cached_tokens
        for _ in range(2):
            assert split.step_chunk()[0].tolist() == \
                unified.step_chunk()[0].tolist()

    def test_abandon_releases_pages_like_jax(self, tree):
        for dec, cls in ((_decoder(tree, prefix=False), PrefillWorker),
                         (_jax_decoder(tree, prefix=False),
                          jdisagg.PrefillWorker)):
            w = cls(dec)
            base = dec.page_pool.stats()["pool_pages_used"]
            h = w.prefill(np.arange(1, 12, dtype=np.int32))
            assert dec.page_pool.stats()["pool_pages_used"] > base
            w.abandon(h)
            st = dec.page_pool.stats()
            assert st["pool_pages_used"] == base
            assert st["pool_pages_handoff"] == st["pool_leases"] == 0
            assert h.pages == []

    def test_handoff_keeps_shared_pages_alive_like_jax(self, tree):
        got = []
        for dec, cls in ((_decoder(tree), PrefillWorker),
                         (_jax_decoder(tree), jdisagg.PrefillWorker)):
            w = cls(dec)
            p = np.arange(1, 20, dtype=np.int32)
            dec.adopt(0, w.prefill(p))
            h2 = w.prefill(p)
            dec.adopt(1, h2)
            got.append((h2.cached_tokens,
                        dec.page_pool.stats()["pool_pages_shared"],
                        dec.page_pool.refcount_census()))
        assert got[0] == got[1]
        assert got[0][0] >= 4 and got[0][1] > 0

    @pytest.mark.parametrize("path", ["unified", "split"])
    def test_exhausted_pool_releases_the_cached_pages(self, tree, path):
        """Both admits run ``_prefill_row``: when the private pages cannot
        be allocated, the cached prefix pages the row retained are
        released again, and every page keeps one reference per holder."""
        from collections import Counter

        dec = _decoder(tree)
        p = np.arange(1, 20, dtype=np.int32)
        dec.admit(0, p)
        pool = dec.page_pool
        held = pool.alloc(pool.available())
        with pytest.raises(RuntimeError, match="exhausted"):
            if path == "unified":
                dec.admit(1, p)
            else:
                PrefillWorker(dec).prefill(p)
        want = (Counter(dec._slot_pages[0]) + Counter(held)
                + Counter(dec.prefix_cache.page_census()))
        assert pool.refcount_census() == dict(want)
        assert not dec.active[1] and pool.stats()["pool_leases"] == 0

    def test_adopt_guards(self, tree):
        dec = _decoder(tree)
        w = PrefillWorker(dec)
        dec.adopt(0, w.prefill(np.arange(1, 10, dtype=np.int32)))
        h2 = w.prefill(np.arange(1, 10, dtype=np.int32))
        with pytest.raises(ValueError, match="active"):
            dec.adopt(0, h2)
        with pytest.raises(ValueError, match="span"):
            dec.adopt(1, Handoff(h2.pages[:-1], 9, 0, h2.first))
        w.abandon(h2)
        contig = ttr.SlotDecoder(
            convert.params_from_flax(tree, ttr.TransformerConfig(**FLAGSHIP),
                                     device="cpu"), None, 2, 4, cache_len=48,
            chunk_size=2, pad_multiple=16)
        with pytest.raises(ValueError, match="paged"):
            contig.adopt(0, h2)

    def test_worker_refusals_like_jax(self, tree):
        model = jtr.Transformer(jtr.TransformerConfig(**FLAGSHIP))
        jcontig = jtr.SlotDecoder(model, jax.tree.map(jnp.asarray, tree), 2,
                                  4, cache_len=48, chunk_size=2,
                                  pad_multiple=16)
        contig = ttr.SlotDecoder(
            convert.params_from_flax(tree, ttr.TransformerConfig(**FLAGSHIP),
                                     device="cpu"), None, 2, 4, cache_len=48,
            chunk_size=2, pad_multiple=16)
        for cls, dec in ((jdisagg.PrefillWorker, jcontig),
                         (PrefillWorker, contig)):
            with pytest.raises(ValueError, match="paged"):
                cls(dec)
        spec = _decoder(tree, draft_model=convert.params_from_flax(
            tree, ttr.TransformerConfig(**FLAGSHIP), device="cpu"))
        with pytest.raises(ValueError, match="speculation"):
            PrefillWorker(spec)
        dead = PrefillWorker(_decoder(tree), fault_fn=None)
        dead.dead = True
        with pytest.raises(PrefillWorkerDead):
            dead.prefill(np.arange(1, 5, dtype=np.int32))
        with pytest.raises(ValueError, match="exceeds"):
            PrefillWorker(_decoder(tree)).prefill(
                np.arange(1, 46, dtype=np.int32) % 64)

    def test_abandoned_prefill_stops_before_any_write(self, tree):
        dec = _decoder(tree)
        w = PrefillWorker(dec)
        before = [t._version for t in _pool_tensors(dec)]
        with pytest.raises(PrefillAbandoned):
            w.prefill(np.arange(1, 9, dtype=np.int32), owner="r",
                      abandoned_fn=lambda: True)
        assert [t._version for t in _pool_tensors(dec)] == before
        assert [r["owner"] for r in dec.page_pool.reap_orphans(
            owner="r")] == ["r"]
        assert _balanced(dec) == []

    def test_builder_rejects_disagg_without_paged(self, tree):
        for builder, kw in ((jtr.serving_builder, {}),
                            (ttr.serving_builder, {"device": "cpu"})):
            with pytest.raises(ValueError, match="paged"):
                builder(tree, dict(FLAGSHIP, **GEN, disaggregate=True,
                                   **kw))


# ----------------------------------------------------------------------
# the disaggregated engine
# ----------------------------------------------------------------------


class TestEngine:
    def test_tokens_equal_unified_and_jax(self, tree):
        rows = _shared_rows(8)
        ref, rs = _run(serving, _predict(tree), rows)
        got, ds = _run(serving, _predict(tree, disaggregate=True), rows)
        jgot, js = _run(jserving, _jax_predict(tree, disaggregate=True),
                        rows)
        assert _tokens(got) == _tokens(ref) == _tokens(jgot)
        assert ds["disaggregated"] is True and rs["disaggregated"] is False
        assert ds["prefix_hits"] == js["prefix_hits"] > 0
        assert ds["prefill_wall_sec"] > 0
        assert ds["pool_pages_used"] == rs["pool_pages_used"]

    def test_one_merged_trace_per_request(self, tree):
        tracer = telemetry.get_tracer()
        tracer.clear()
        rows = _shared_rows(4)
        for i, r in enumerate(rows):
            r["trace"] = "disagg-%d" % i
        _run(serving, _predict(tree, disaggregate=True), rows,
             mapping={"prompt": "tokens", "trace": "trace_id"})
        kinds = [s["name"] for s in tracer.spans(trace="disagg-1")]
        for expected in ("admission", "prefill", "handoff", "decode_chunk",
                         "emit"):
            assert expected in kinds, kinds
        pre = [s for s in tracer.spans(trace="disagg-1")
               if s["name"] == "prefill"]
        assert pre and pre[0]["attrs"].get("disaggregated") is True

    def test_ledger_splits_prefill_from_decode(self, tree):
        led = ledger_mod.get_ledger()
        led.enabled_override = True
        try:
            rows = _shared_rows(6)
            for i, r in enumerate(rows):
                r["tenant"] = "t%d" % (i % 2)
                r["trace"] = "split-%d" % i
            eng = serving_engine.ServingEngine(
                _predict(tree, disaggregate=True),
                {"prompt": "tokens", "tenant": "tenant",
                 "trace": "trace_id"}, None, 3)
            out = list(eng.serve([dict(r) for r in rows]))
            assert all("error" not in o for o in out)
            led_rows = [led.row("split-%d" % i) for i in range(6)]
            assert all(r["prefill_chip_sec"] > 0 for r in led_rows)
            assert sum(r["chip_sec"] for r in led_rows) == pytest.approx(
                eng.stats["decode_wall_sec"], rel=1e-9)
            assert sum(r["prefill_chip_sec"] for r in led_rows) == \
                pytest.approx(eng.stats["prefill_wall_sec"], rel=1e-9)
        finally:
            led.enabled_override = None

    def test_ttft_and_the_health_prefill_share(self, tree):
        base = serving_engine.ttft_histogram().snapshot()
        rows = _shared_rows(5)
        eng = serving_engine.ServingEngine(
            _predict(tree, disaggregate=True), {"prompt": "tokens"}, None,
            3)
        list(eng.serve([dict(r) for r in rows]))
        stats = eng.stats
        assert len(stats["ttft_sec"]) == len(rows)
        for idx, ttft in stats["ttft_sec"].items():
            assert 0 < ttft <= stats["latency_sec"][idx] + 0.05
        summ = serving_engine.ttft_summary(since=base)
        assert summ["count"] == len(rows)
        assert summ["p99_ms"] >= summ["p50_ms"] > 0
        assert eng.health_status()["usage"]["prefill_chip_sec"] > 0

    def test_engine_argument_overrides_the_predictor(self, tree):
        rows = _shared_rows(3)
        stats = {}
        eng = serving_engine.ServingEngine(
            _predict(tree), {"prompt": "tokens"}, None, 3,
            disaggregate=True, stats=stats)
        out = list(eng.serve([dict(r) for r in rows]))
        ref, _ = _run(serving, _predict(tree), rows)
        assert _tokens(out) == _tokens(ref)
        assert stats["disaggregated"] is True


# ----------------------------------------------------------------------
# the prefill faults: contained with the same tokens
# ----------------------------------------------------------------------


LENS = (12, 9, 17, 8, 21, 11)


def _warm(predict, rows, monkeypatch, mapping=None):
    """The fault-free run, before the plan is advertised (compiled and
    warm, so that a watchdog never fires on a cold first call)."""
    monkeypatch.delenv(chaos.TFOS_CHAOS_PLAN, raising=False)
    out, _ = _run(serving, predict, rows, slots=2, mapping=mapping)
    return _tokens(out)


def _arm(plan, tmp_path, monkeypatch):
    monkeypatch.setenv(chaos.TFOS_CHAOS_PLAN,
                       plan.save(str(tmp_path / "plan.json")))


class TestContainment:
    def test_kill_prefill_recovers_like_jax(self, tree, tmp_path,
                                            monkeypatch):
        """The JAX package's engine contains the same kill with the same
        tokens and counters."""
        rows = _rows(LENS)
        predict = _predict(tree, disaggregate=True)
        jpredict = _jax_predict(tree, disaggregate=True)
        ref = _warm(predict, rows, monkeypatch)
        _arm(chaos.ChaosPlan().kill_prefill(at_admit=1), tmp_path,
             monkeypatch)
        journal_mod.get_journal().clear()
        out, stats = _run(serving, predict, rows, slots=2)
        jout, jstats = _run(jserving, jpredict, rows, slots=2)
        assert _tokens(out) == ref == _tokens(jout)
        for key in ("prefill_worker_deaths", "prefill_restarts",
                    "leases_reaped", "errors"):
            assert stats[key] == jstats[key], key
        assert stats["prefill_worker_deaths"] == 1
        assert stats["leases_reaped"] >= 1
        ev = journal_mod.get_journal().events(kind="prefill_worker_dead")
        assert ev and ev[-1].severity == "page"
        assert _balanced(predict.make_slot_decoder(2)) == []

    def test_wedge_prefill_watchdog_fires_and_recovers(
            self, tree, tmp_path, monkeypatch):
        rows = _rows(LENS, seed=5)
        predict = _predict(tree, disaggregate=True)
        ref = _warm(predict, rows, monkeypatch)
        _arm(chaos.ChaosPlan().wedge_prefill(at_admit=1, hang_sec=HANG),
             tmp_path, monkeypatch)
        out, stats = _run(serving, predict, rows, slots=2,
                          watchdog_timeout=WATCHDOG)
        assert _tokens(out) == ref
        assert stats["prefill_watchdog_fires"] == 1
        assert stats["errors"] == 0
        ev = journal_mod.get_journal().events(kind="prefill_watchdog_fire")
        assert ev and ev[-1].severity == "page"

    def test_leaked_lease_reaped_by_deadline(self, tree, tmp_path,
                                             monkeypatch):
        rows = _rows(LENS, seed=9)
        predict = _predict(tree, disaggregate=True)
        ref = _warm(predict, rows, monkeypatch)
        journal_mod.get_journal().clear()
        _arm(chaos.ChaosPlan().leak_lease(at_admit=1, deadline_sec=0.0),
             tmp_path, monkeypatch)
        out, stats = _run(serving, predict, rows, slots=2,
                          watchdog_timeout=WATCHDOG)
        assert _tokens(out) == ref
        assert stats["leases_reaped"] >= 1 and stats["errors"] == 0
        ev = journal_mod.get_journal().events(kind="lease_reaped")
        assert ev and ev[-1].severity == "page"
        assert ev[-1].attrs.get("owner") == "chaos:leak_lease"

    def test_each_engine_has_its_own_worker(self, tree, tmp_path,
                                            monkeypatch):
        """The worker is built per engine: a plan's prefill index counts
        from each job's first prefill, and each job's leases take that
        engine's deadline."""
        rows = _rows(LENS, seed=5)
        predict = _predict(tree, disaggregate=True)
        ref = _warm(predict, rows, monkeypatch)
        _arm(chaos.ChaosPlan().kill_prefill(at_admit=1), tmp_path,
             monkeypatch)
        for timeout in (WATCHDOG, 2 * WATCHDOG):
            out, stats = _run(serving, predict, rows, slots=2,
                              watchdog_timeout=timeout)
            assert _tokens(out) == ref
            assert stats["prefill_worker_deaths"] == 1
        engines = [serving_engine.ServingEngine(
            predict, {"prompt": "tokens"}, None, 2, watchdog_timeout=t)
            for t in (WATCHDOG, 2 * WATCHDOG)]
        workers = [e._prefill_worker for e in engines]
        assert workers[0] is not workers[1]
        assert [w.lease_deadline_sec for w in workers] == [
            4 * WATCHDOG, 8 * WATCHDOG]
        assert _balanced(predict.make_slot_decoder(2)) == []

    def test_recovery_rides_the_original_trace(self, tree, tmp_path,
                                               monkeypatch):
        rows = _rows(LENS, seed=11)
        for i, r in enumerate(rows):
            r["trace"] = "contain-%d" % i
        mapping = {"prompt": "tokens", "trace": "trace_id"}
        predict = _predict(tree, disaggregate=True)
        _warm(predict, rows, monkeypatch, mapping=mapping)
        _arm(chaos.ChaosPlan().kill_prefill(at_admit=1), tmp_path,
             monkeypatch)
        tracer = telemetry.get_tracer()
        tracer.clear()
        _, stats = _run(serving, predict, rows, slots=2, mapping=mapping,
                        watchdog_timeout=WATCHDOG)
        assert stats["prefill_worker_deaths"] == 1
        recovered = [s for i in range(len(rows))
                     for s in tracer.spans(trace="contain-%d" % i)
                     if s["name"] == "prefill"
                     and s["attrs"].get("prefill_recovered")]
        assert len(recovered) == 1
        kinds = [s["name"] for s in tracer.spans(
            trace=recovered[0]["trace"])]
        for expected in ("admission", "prefill", "decode_chunk", "emit"):
            assert expected in kinds, kinds


def _family_plans():
    return [
        ("kill_prefill", lambda p: p.kill_prefill(at_admit=1)),
        ("wedge_prefill", lambda p: p.wedge_prefill(at_admit=1,
                                                     hang_sec=HANG)),
        ("leak_lease", lambda p: p.leak_lease(at_admit=1,
                                              deadline_sec=0.0)),
        ("wedge_dispatch", lambda p: p.wedge_dispatch(at_chunk=2,
                                                      hang_sec=HANG)),
        ("poison_rows", None),
    ]


@pytest.mark.parametrize("family,arm", _family_plans(),
                         ids=[f for f, _ in _family_plans()])
def test_family_leaves_pool_balanced(tree, family, arm, tmp_path,
                                     monkeypatch):
    predict = _predict(tree, disaggregate=True)
    rows = _rows(LENS, seed=13)
    ref = _warm(predict, rows, monkeypatch)
    if arm is not None:
        plan = chaos.ChaosPlan()
        arm(plan)
        _arm(plan, tmp_path, monkeypatch)
    load = [dict(r) for r in rows]
    if family == "poison_rows":
        load.insert(2, chaos.poison_row("bad_dtype"))
    eng = serving_engine.ServingEngine(
        predict, {"prompt": "tokens"}, None, 2, on_error="record",
        watchdog_timeout=WATCHDOG)
    out = list(eng.serve(load))
    assert len(out) == len(load)
    errors = [i for i, r in enumerate(out) if "error" in r]
    assert errors == ([2] if family == "poison_rows" else [])
    good = [r for r in out if "error" not in r]
    assert _tokens(good) == ref
    assert _balanced(eng.decoder) == []


def test_balance_check_names_an_actual_leak(tree, monkeypatch):
    """The balance check can fail: a page held outside the radix is
    named."""
    predict = _predict(tree, disaggregate=True)
    _warm(predict, _rows((8, 10)), monkeypatch)
    dec = predict.make_slot_decoder(2)
    leak = dec.page_pool.alloc(1)
    try:
        assert any("never rebalanced" in p for p in _balanced(dec))
    finally:
        dec.page_pool.release(leak)
    assert _balanced(dec) == []


def test_recovery_readmits_a_long_prompt_through_the_split(tree):
    """ROADMAP C7 on the split path: a request whose prompt fills its
    cache up to the budget, requeued by the decode watchdog with
    committed tokens, re-prefills through the worker with room for the
    rest of its budget only (``PrefillWorker.prefill(new_tokens=)``) and
    finishes with the fault-free tokens, the JAX package's.  (The JAX
    package's worker asks for the whole budget again.)"""
    import time

    class WedgeOnce(object):
        fired = False

        def __call__(self, chunk_index):
            if not self.fired and chunk_index >= 2:
                self.fired = True
                time.sleep(HANG)

    rows = _rows([48, 5, 9])
    extra = dict(max_new_tokens=8, max_prompt_len=40, disaggregate=True)
    pred = _predict(tree, **extra)
    assert pred.make_slot_decoder(2).cache_len == 56
    ref, _ = _run(jserving, _jax_predict(tree, **extra), rows, slots=2)
    warm, _ = _run(serving, pred, rows, slots=2)
    stats = {}
    out = list(serving_engine.ServingEngine(
        pred, {"prompt": "tokens"}, num_slots=2, watchdog_timeout=WATCHDOG,
        wedge_fn=WedgeOnce(), stats=stats, on_error="record").serve(
            [dict(r) for r in rows]))
    assert stats["watchdog_fires"] == 1 and stats["recovered"] == 2
    assert _tokens(out) == _tokens(warm) == _tokens(ref)
    assert _balanced(pred.make_slot_decoder(2)) == []
