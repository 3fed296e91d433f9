"""The port's serving engine under overload and faults, against the JAX
package's engine on the same rows, on the CPU in f32: load shedding
(``reject``, ``degrade``), deadlines in the queue and in a slot, drain,
retunes, poison rows, the chaos plan's wedges and slow consumers, and the
decode watchdog's recovery on both KV layouts.  Records (kind, index,
message, committed tokens) and tokens are compared exactly; the clock is
the test's, advanced at the same points for both engines.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu import serving_engine as jengine  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu.testing import chaos as jchaos  # noqa: E402
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch import serving_engine  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.testing import chaos  # noqa: E402

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=8, embed_dim=16, mlp_dim=32, max_seq_len=96,
            dtype="float32")
LAYOUTS = ["contiguous", "paged"]


@pytest.fixture(scope="module")
def tree():
    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _cfg(layout="contiguous", max_new=6, **extra):
    return dict(TINY, mode="generate", max_new_tokens=max_new,
                pad_multiple=16, kv_layout=layout, **extra)


def _pair(tree, layout="contiguous", **kw):
    """``[(serving module, engine module, predictor)]`` of the port and
    the JAX package on the same config."""
    cfg = _cfg(layout, **kw)
    jcfg = dict(cfg, paged_impl="gather") if layout == "paged" else cfg
    return [(serving, serving_engine,
             ttr.serving_builder(tree, dict(cfg, device="cpu"))),
            (jserving, jengine, jtr.serving_builder(tree, jcfg))]


def _rows(lens, vocab=64, seed=13, **cols):
    rng = np.random.RandomState(seed)
    rows = [{"prompt": rng.randint(0, vocab, (n,)).astype(np.int32)}
            for n in lens]
    for k, vals in cols.items():
        for r, v in zip(rows, vals):
            r[k] = v
    return rows


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (i, g, w)
        for key in w:
            if key == "error":
                assert g[key] == w[key], i
            else:
                np.testing.assert_array_equal(
                    np.asarray(g[key]), np.asarray(w[key]),
                    err_msg="%d %s" % (i, key))


class _Clock(object):
    """A clock that moves only when the test moves it."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _ticking_wedge(clock, step=1.0):
    def wedge(chunk_index):
        clock.now += step
    return wedge


def _both(pairs, rows, mapping=None, slots=2, **kw):
    """Serve ``rows`` through each engine of ``pairs`` with a fresh
    test clock that the chunk hook advances by a second; returns the
    outputs and stats of each."""
    res = []
    for _, eng_mod, pred in pairs:
        clock = _Clock()
        stats = {}
        eng = eng_mod.ServingEngine(
            pred, mapping or {"prompt": "tokens"}, num_slots=slots,
            stats=stats, clock=clock, wedge_fn=_ticking_wedge(clock), **kw)
        res.append((list(eng.serve([dict(r) for r in rows])), stats))
    return res


COUNTERS = ("admitted", "completed", "errors", "shed", "expired",
            "degraded", "watchdog_fires", "recovered", "drained",
            "tokens_out")


def _same_counters(a, b):
    assert {k: a[k] for k in COUNTERS} == {k: b[k] for k in COUNTERS}


# ----------------------------------------------------------------------
# admission policies
# ----------------------------------------------------------------------


def test_reject_sheds_past_queue_bound_like_jax(tree):
    (got, s), (want, w) = _both(_pair(tree, max_new=4), _rows([4] * 10),
                                policy="reject", queue_depth=2)
    _assert_same(got, want)
    _same_counters(s, w)
    assert s["shed"] == 6 and s["completed"] == 4
    assert [r["error"]["request_index"] for r in got if "error" in r] == \
        list(range(4, 10))


def test_degrade_shrinks_budgets_like_jax(tree):
    (got, s), (want, w) = _both(_pair(tree, max_new=12), _rows([4] * 12),
                                policy="degrade", queue_depth=2)
    _assert_same(got, want)
    _same_counters(s, w)
    lens = [int(r["generated_len"]) for r in got]
    assert s["degraded"] > 0 and min(lens) < 12 and max(lens) == 12


def test_degrade_floor_bounds_the_shrink(tree):
    ((got, s),) = _both(_pair(tree, max_new=12)[:1], _rows([4] * 12),
                        policy="degrade", queue_depth=1, degrade_floor=5)
    assert min(int(r["generated_len"]) for r in got) == 5


def test_block_serves_everything_and_bad_policy_raises(tree):
    (got, s), (want, w) = _both(_pair(tree, max_new=4), _rows([4] * 9),
                                policy="block", queue_depth=2)
    _assert_same(got, want)
    assert s["shed"] == 0 and s["completed"] == 9
    with pytest.raises(ValueError, match="policy"):
        serving_engine.ServingEngine(_pair(tree)[0][2], {"prompt": "tokens"},
                                     policy="nope")


# ----------------------------------------------------------------------
# deadlines
# ----------------------------------------------------------------------


def test_queued_request_expires_like_jax(tree):
    rows = _rows([4, 6, 5], deadline_sec=[1e9, 0.5, 0.5])
    mapping = {"prompt": "tokens", "deadline_sec": "deadline_sec"}
    (got, s), (want, w) = _both(_pair(tree, max_new=8), rows, mapping,
                                slots=1, policy="degrade")
    _assert_same(got, want)
    _same_counters(s, w)
    assert s["expired"] == 2 and s["admitted"] == 1
    assert all(r["error"]["kind"] == "deadline"
               and r["error"]["tokens_done"] == 0 for r in got[1:])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_expired_lane_cancelled_neighbours_unaffected_like_jax(tree, layout):
    rows = _rows([4, 7, 9], deadline_sec=[1e9, 1.5, 1e9])
    mapping = {"prompt": "tokens", "deadline_sec": "deadline_sec"}
    pairs = _pair(tree, layout, max_new=12, chunk_size=2)
    (got, s), (want, w) = _both(pairs, rows, mapping, slots=3)
    _assert_same(got, want)
    _same_counters(s, w)
    free, _ = _both(pairs[:1], _rows([4, 7, 9]), slots=3)[0]
    err = got[1]["error"]
    assert err["kind"] == "deadline" and err["tokens_done"] == 5
    assert err["partial"] == np.asarray(free[1]["generated"])[:5].tolist()
    _assert_same([got[0], got[2]], [free[0], free[2]])


def test_default_deadline_and_bad_deadline_like_jax(tree):
    rows = _rows([4, 6, 5], deadline_sec=[1e9, "soon", 1e9])
    mapping = {"prompt": "tokens", "deadline_sec": "deadline_sec"}
    (got, _), (want, _) = _both(_pair(tree, max_new=4), rows, mapping,
                                on_error="record")
    _assert_same(got, want)
    assert got[1]["error"]["kind"] == "bad_deadline"
    (got, s), (want, w) = _both(_pair(tree, max_new=8, chunk_size=2),
                                _rows([4, 6]), default_deadline=1.5)
    _assert_same(got, want)
    assert s["expired"] == 2


# ----------------------------------------------------------------------
# drain
# ----------------------------------------------------------------------


def _drained(pairs, rows, when, mapping=None, deadline=None, **kw):
    res = []
    for _, eng_mod, pred in pairs:
        stats = {}
        eng = eng_mod.ServingEngine(pred, mapping or {"prompt": "tokens"},
                                    num_slots=2, stats=stats, **kw)
        gen = eng.serve([dict(r) for r in rows])
        out = [next(gen) for _ in range(when)]
        eng.drain(deadline=deadline)
        out.extend(gen)
        res.append((out, stats))
    return res


def test_drain_finishes_inflight_and_records_queued_like_jax(tree):
    (got, s), (want, w) = _drained(
        _pair(tree, max_new=6, chunk_size=2), _rows([4, 7, 5, 9]), 1,
        policy="degrade")
    _assert_same(got, want)
    drained = [r for r in got if "error" in r]
    assert drained and s["drained"] == w["drained"] == len(drained)
    assert all(r["error"]["kind"] == "drained" for r in drained)


def test_drain_deadline_cancels_stragglers_like_jax(tree):
    (got, s), (want, w) = _drained(
        _pair(tree, max_new=12, chunk_size=2),
        _rows([4, 7], max_new=[2, 12]), 1,
        mapping={"prompt": "tokens", "max_new": "max_new"}, deadline=0.0)
    _assert_same(got, want)
    assert got[1]["error"]["kind"] == "drained"
    assert len(got[1]["error"]["partial"]) >= 1 and s["drained"] == 1


def test_drain_before_any_admission_ends_empty(tree):
    for _, eng_mod, pred in _pair(tree, max_new=4):
        eng = eng_mod.ServingEngine(pred, {"prompt": "tokens"}, num_slots=2)
        gen = eng.serve([dict(r) for r in _rows([4, 7])])
        eng.drain()
        assert list(gen) == []


def test_drain_stops_pulling_the_source(tree):
    counts = []
    for _, eng_mod, pred in _pair(tree, max_new=4, chunk_size=2):
        pulled = []

        def source():
            for i, r in enumerate(_rows([4] * 50)):
                pulled.append(i)
                yield r

        eng = eng_mod.ServingEngine(pred, {"prompt": "tokens"}, num_slots=2)
        gen = eng.serve(source())
        next(gen)
        n_before = len(pulled)
        eng.drain()
        list(gen)
        assert len(pulled) <= n_before + 2 and len(pulled) < 10
        counts.append(len(pulled))
    assert counts[0] == counts[1]


# ----------------------------------------------------------------------
# retunes, poison rows, emit order, stats
# ----------------------------------------------------------------------


def test_request_retune_applies_between_chunks(tree):
    assert serving_engine.ServingEngine.RETUNABLE == \
        jengine.ServingEngine.RETUNABLE
    pred = _pair(tree, max_new=4)[0][2]
    eng = serving_engine.ServingEngine(pred, {"prompt": "tokens"},
                                       num_slots=2)
    with pytest.raises(ValueError, match="retunable"):
        eng.request_retune(chunk_size=4)
    eng.request_retune(queue_depth=0, watchdog_timeout=5,
                       default_deadline=None)
    assert eng.queue_depth == 4 and eng._watchdog is None
    out = list(eng.serve([dict(r) for r in _rows([4, 5])]))
    assert eng.queue_depth == 1 and eng.watchdog_timeout == 5.0
    assert eng._watchdog is not None and len(out) == 2


def test_every_poison_kind_is_isolated_like_jax(tree):
    good = _rows([6, 5], seed=7)
    rows = [dict(good[0], max_new=4)]
    for k in chaos.POISON_KINDS:
        row = chaos.poison_row(k)
        row.setdefault("max_new", 4)
        rows.append(row)
    rows.append(dict(good[1], max_new=4))
    mapping = {"prompt": "tokens", "max_new": "max_new"}
    (got, s), (want, w) = _both(_pair(tree, max_new=4), rows, mapping,
                                on_error="record")
    _assert_same(got, want)
    assert [r["error"]["kind"] for r in got[1:-1]] == [
        "missing_input", "bad_dtype", "bad_shape", "empty_prompt",
        "too_long", "bad_budget"]
    for kind in chaos.POISON_KINDS:
        a, b = chaos.poison_row(kind), jchaos.poison_row(kind)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key], dtype=object),
                                          np.asarray(b[key], dtype=object))
    with pytest.raises(ValueError, match="unknown poison kind"):
        chaos.poison_row("nope")
    with pytest.raises(serving_engine.RequestValidationError,
                       match="request 1"):
        list(serving.predict_rows(
            _pair(tree)[0][2], [good[0], chaos.poison_row("bad_dtype")],
            {"prompt": "tokens"}, batch_size=2, schedule="continuous"))


def test_emit_order_under_mixed_evict_reasons_like_jax(tree):
    free, _ = _both(_pair(tree, max_new=8)[:1], _rows([4, 7, 11, 2, 9, 5]),
                    slots=1)[0]
    eos = int(np.asarray(free[0]["generated"])[2])
    rows = _rows([4, 7, 11, 2, 9, 5], max_new=[8, 2, 8, 8, 3, 8],
                 deadline_sec=[1e9, 1e9, 0.5, 1e9, 1e9, 1e9])
    rows.insert(3, {"poison": np.arange(3, dtype=np.int32)})
    mapping = {"prompt": "tokens", "max_new": "max_new",
               "deadline_sec": "deadline_sec"}
    (got, s), (want, w) = _both(
        _pair(tree, max_new=8, eos_id=eos, chunk_size=2), rows, mapping,
        on_error="record")
    _assert_same(got, want)
    _same_counters(s, w)
    assert got[2]["error"]["kind"] == "deadline"
    assert got[3]["error"]["kind"] == "missing_input"


def test_stats_surface_robustness_counters(tree):
    stats = {}
    list(serving.predict_rows(_pair(tree, max_new=4)[0][2], _rows([4, 5]),
                              {"prompt": "tokens"}, batch_size=2,
                              schedule="continuous", stats=stats))
    for key in ("latency_sec", "done_at", "admitted", "chunks",
                "completed", "errors", "shed", "expired", "degraded",
                "watchdog_fires", "recovered", "drained", "prefix_hits",
                "prefix_tokens_saved", "evictions", "pressure_evictions",
                "prefix_hit_admits", "swaps", "swap_commits", "rollbacks",
                "swap_requeued", "swap_events", "swap_latency_sec",
                "weight_generation"):
        assert key in stats, key
    assert stats["completed"] == 2 and stats["errors"] == 0


# ----------------------------------------------------------------------
# chaos plan hooks and slow consumers
# ----------------------------------------------------------------------


def test_plan_hooks_match_jax(tmp_path, monkeypatch):
    monkeypatch.delenv(chaos.TFOS_CHAOS_PLAN, raising=False)
    assert chaos.serving_wedge_fn() is None and chaos.ingest_delay() is None
    path = str(tmp_path / "plan.json")
    monkeypatch.setenv(chaos.TFOS_CHAOS_PLAN, path)
    chaos.ChaosPlan().kill_worker(1, at_step=3).save(path)
    assert chaos.serving_wedge_fn() is None
    plan = chaos.ChaosPlan().wedge_dispatch(2, hang_sec=0.05)
    plan.wedge_dispatch(5, hang_sec=0.05).slow_ingest(1.25)
    plan.save(path)
    assert plan.faults == jchaos.ChaosPlan(plan.faults).faults
    assert chaos.ingest_delay() == jchaos.ingest_delay() == 1.25
    wedge = chaos.serving_wedge_fn()
    walls = []
    for idx in range(8):
        t0 = time.perf_counter()
        wedge(idx)
        walls.append(time.perf_counter() - t0)
    assert [i for i, w in enumerate(walls) if w > 0.04] == [2, 5]
    chaos.ChaosPlan().swap_during_wedge(3, hang_sec=0.5).save(path)
    assert chaos.swap_chunk_from_plan() == jchaos.swap_chunk_from_plan() \
        == 3
    assert [f["kind"] for f in chaos.ChaosPlan.load(path).faults] == \
        ["wedge_dispatch", "swap_at_chunk"]


def test_slow_consumer_keeps_order_and_can_expire_deadlines(tree):
    pred = _pair(tree, max_new=4)[0][2]
    rows = _rows([4, 6, 5, 7, 3], seed=7)
    ref = list(serving.predict_rows(pred, [dict(r) for r in rows],
                                    {"prompt": "tokens"}, batch_size=2,
                                    schedule="continuous"))
    out = list(chaos.slow_consumer(serving.predict_rows(
        pred, [dict(r) for r in rows], {"prompt": "tokens"}, batch_size=2,
        schedule="continuous"), stall_sec=0.02, every=2))
    _assert_same(out, ref)
    stats = {}
    out = list(chaos.slow_consumer(serving.predict_rows(
        _pair(tree, max_new=8, chunk_size=1)[0][2], rows[:4],
        {"prompt": "tokens"}, batch_size=1, schedule="continuous",
        default_deadline=0.05, stats=stats), stall_sec=0.2))
    assert len(out) == 4
    assert all("error" not in r or r["error"]["kind"] == "deadline"
               for r in out)
    assert stats["completed"] + stats["expired"] == 4


# ----------------------------------------------------------------------
# the decode watchdog
# ----------------------------------------------------------------------


class _WedgeOnce(object):
    def __init__(self, at_chunk, hang_sec):
        self.at_chunk, self.hang_sec, self.fired = at_chunk, hang_sec, 0
        self.woke = threading.Event()

    def __call__(self, chunk_index):
        if self.fired == 0 and chunk_index >= self.at_chunk:
            self.fired += 1
            time.sleep(self.hang_sec)
            self.woke.set()


class _Counting(object):
    """Wraps a decoder's ``step_chunk`` to record the threads that call
    it."""

    def __init__(self, dec):
        self.dec, self.calls = dec, []
        self._orig = dec.step_chunk
        dec.step_chunk = self

    def __call__(self):
        self.calls.append(threading.current_thread().name)
        return self._orig()

    def undo(self):
        self.dec.step_chunk = self._orig


@pytest.mark.parametrize("layout", LAYOUTS)
def test_watchdog_recovery_is_token_identical(tree, layout):
    rows = _rows([4, 7, 5, 9, 3])
    port, jax_side = _pair(tree, layout, max_new=10, chunk_size=2)
    want = list(jserving.predict_rows(
        jax_side[2], [dict(r) for r in rows], {"prompt": "tokens"},
        batch_size=2, schedule="continuous"))
    pred = port[2]
    counting = _Counting(pred.make_slot_decoder(2))
    try:
        _, cstats = _both([port], rows)[0]
        cold_calls = len(counting.calls)
        counting.calls.clear()
        wedge = _WedgeOnce(at_chunk=2, hang_sec=1.0)
        stats = {}
        eng = serving_engine.ServingEngine(
            pred, {"prompt": "tokens"}, num_slots=2, watchdog_timeout=0.5,
            wedge_fn=wedge, stats=stats)
        out = list(eng.serve([dict(r) for r in rows]))
        assert wedge.woke.wait(5.0)
        time.sleep(0.2)
    finally:
        counting.undo()
    assert wedge.fired == 1 and stats["watchdog_fires"] == 1
    assert stats["recovered"] == 2  # both slots were in flight
    _assert_same(out, want)
    # the abandoned chunk never reached the decoder: every call came
    # from a live watchdog thread, and no more of them than a clean run
    assert len(counting.calls) == stats["chunks"] <= cold_calls \
        == cstats["chunks"]
    assert set(counting.calls) == {"serving-watchdog"}


def test_watchdog_worker_enters_the_decoders_device(tree, monkeypatch):
    seen = []
    real = serving_engine.device_scope

    def scope(device):
        seen.append((device, threading.current_thread().name))
        return real(device)

    monkeypatch.setattr(serving_engine, "device_scope", scope)
    pred = _pair(tree, max_new=4)[0][2]
    eng = serving_engine.ServingEngine(pred, {"prompt": "tokens"},
                                       num_slots=2, watchdog_timeout=5.0)
    out = list(eng.serve([dict(r) for r in _rows([4, 5])]))
    assert len(out) == 2
    assert seen == [(eng.decoder.device, "serving-watchdog")]
    assert serving_engine.ServingEngine(pred, {"prompt": "tokens"},
                                        num_slots=2)._watchdog is None


def test_engine_picks_wedge_up_from_plan_env(tree, tmp_path, monkeypatch):
    monkeypatch.delenv(chaos.TFOS_CHAOS_PLAN, raising=False)
    pred = _pair(tree, max_new=8, chunk_size=2)[0][2]
    rows = _rows([4, 7, 5], seed=7)
    ref = list(serving.predict_rows(pred, [dict(r) for r in rows],
                                    {"prompt": "tokens"}, batch_size=2,
                                    schedule="continuous"))
    path = str(tmp_path / "plan.json")
    chaos.ChaosPlan().wedge_dispatch(1, hang_sec=1.0).save(path)
    monkeypatch.setenv(chaos.TFOS_CHAOS_PLAN, path)
    stats = {}
    out = list(serving.predict_rows(
        pred, [dict(r) for r in rows], {"prompt": "tokens"}, batch_size=2,
        schedule="continuous", watchdog_timeout=0.4, stats=stats))
    _assert_same(out, ref)
    assert stats["watchdog_fires"] == 1


def test_recovery_readmits_a_long_prompt_with_its_remaining_budget(tree):
    """A request whose prompt fills its cache up to the budget, requeued
    by the watchdog with committed tokens: the port re-admits it with
    room for the rest of its budget and finishes it token-identically.
    The JAX engine asks for the whole budget again and turns the request
    into an ``admit`` record (ROADMAP C)."""
    rows = _rows([48, 5, 9])
    res = []
    for _, eng_mod, pred in _pair(tree, max_new=8, chunk_size=2,
                                  max_prompt_len=40):
        assert pred.make_slot_decoder(2).cache_len == 56
        ref = list(eng_mod.ServingEngine(pred, {"prompt": "tokens"},
                                         num_slots=2).serve(
            [dict(r) for r in rows]))
        stats = {}
        out = list(eng_mod.ServingEngine(
            pred, {"prompt": "tokens"}, num_slots=2, watchdog_timeout=0.5,
            wedge_fn=_WedgeOnce(at_chunk=2, hang_sec=1.0), stats=stats,
            on_error="record").serve([dict(r) for r in rows]))
        assert stats["watchdog_fires"] == 1
        res.append((ref, out))
    (ref, out), (jref, jout) = res
    _assert_same(out, ref)
    _assert_same(ref, jref)
    assert jout[0]["error"]["kind"] == "admit"
    _assert_same(jout[1:], jref[1:])
