"""The port's serving telemetry against the JAX package's, on the CPU in
f32: a tiny ``Transformer`` on the paged and the contiguous layout, a
radix prefix cache, greedy requests of three tenants with trace ids,
served by both packages' engines under one test clock.

Held equal between the packages: the tokens, the deltas of the
``serving.*`` and ``prefix_cache.*`` counters, the latency, TTFT and
queue-wait histograms (the engine clock is the test's, so even their
buckets agree), the per-tenant ledger tokens and prefix tokens saved, the
multiset of span names on each request's trace, the swap marks of a hot
swap under load and of a canary rollback, and the ``bad_tenant`` records.
Held in the port: the ledger's chip-seconds sum to the engine's decode
wall, every request has page-seconds, the ``"serving"`` status provider
lets a finished engine go, a watchdog fire leaves one flight-recorder
bundle, and ``profile_dir`` writes a ``torch.profiler`` trace after
``profile_steps`` chunks.
"""

import collections
import gc
import glob
import json
import os
import time
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu import checkpoint as jckpt  # noqa: E402
from tensorflowonspark_tpu import hot_swap as jhot  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu import serving_engine as jengine  # noqa: E402
from tensorflowonspark_tpu import telemetry as jtel  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu_torch import checkpoint as ckpt  # noqa: E402
from tensorflowonspark_tpu_torch import hot_swap  # noqa: E402
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch import serving_engine  # noqa: E402
from tensorflowonspark_tpu_torch import telemetry as ttel  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.telemetry import blackbox  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import health  # noqa: E402

TINY = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=8, embed_dim=16, mlp_dim=32, max_seq_len=96,
            dtype="float32")
LAYOUTS = ["contiguous", "paged"]
PREFIX = dict(prefix_cache=True, prefix_block=8)
TENANTS = ("acme", "beta", "gamma")
MAPPING = {"prompt": "tokens", "who": "tenant", "tid": "trace_id"}
PORT, JAX = (serving, serving_engine, ttel), (jserving, jengine, jtel)
HISTS = ("serving.request_latency_sec", "serving.ttft_sec",
         "serving.queue_wait_sec")


def _params(seed):
    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    return jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def trees():
    return {0: _params(0), 1: _params(1)}


@pytest.fixture(autouse=True)
def _telemetry_on():
    for tel in (ttel, jtel):
        tel.set_enabled(True)
    yield
    for tel in (ttel, jtel):
        tel.set_enabled(True)


def _cfg(layout, max_new=6, **extra):
    cfg = dict(TINY, mode="generate", max_new_tokens=max_new,
               pad_multiple=16, kv_layout=layout, **extra)
    if layout == "paged":
        cfg.setdefault("kv_page_tokens", extra.get("prefix_block", 8))
    return cfg


def _build(pkg, tree, layout, **kw):
    cfg = _cfg(layout, **kw)
    if pkg is PORT:
        return ttr.serving_builder(tree, dict(cfg, device="cpu"))
    if layout == "paged":
        cfg["paged_impl"] = "gather"
    return jtr.serving_builder(tree, cfg)


def _rows(tag, n=9, seed=13, header=16):
    """``n`` requests sharing a ``header``-token system prompt, of three
    tenants, each with its own trace id."""
    rng = np.random.RandomState(seed)
    head = rng.randint(0, 64, (header,))
    return [{"prompt": np.concatenate([head, rng.randint(
                0, 64, (int(rng.randint(2, 12)),))]).astype(np.int32),
             "who": TENANTS[i % 3], "tid": "%s-%d" % (tag, i)}
            for i in range(n)]


class _Clock(object):
    """A clock that moves only where the test moves it."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _ticking(clock, step=0.25):
    def wedge(chunk_index):
        clock.now += step
    return wedge


def _wedge_once(at_chunk, hang_sec):
    """A dispatch hook that hangs chunk ``at_chunk`` once."""
    fired = []

    def wedge(chunk_index):
        if chunk_index >= at_chunk and not fired:
            fired.append(chunk_index)
            time.sleep(hang_sec)
    return wedge


def _last_id(tracer):
    return max((s["id"] for s in tracer.spans()), default=0)


def _serve(pkg, predict, rows, slots=3, mapping=MAPPING, **kw):
    """One engine job under a fresh test clock; returns the outputs, the
    stats, the registry and ledger deltas, and the spans it recorded."""
    _, eng_mod, tel = pkg
    tracer, reg, led = tel.get_tracer(), tel.get_registry(), tel.get_ledger()
    base_id, base_reg, base_led = _last_id(tracer), reg.snapshot(), \
        led.snapshot()
    clock = _Clock()
    stats = {}
    eng = eng_mod.ServingEngine(predict, mapping, num_slots=slots,
                                stats=stats, clock=clock,
                                wedge_fn=kw.pop("wedge_fn", _ticking(clock)),
                                **kw)
    out = list(eng.serve([dict(r) for r in rows]))
    return dict(
        out=out, stats=stats, engine=eng,
        reg=tel.snapshot_delta(reg.snapshot(), base_reg),
        ledger=tel.ledger.snapshot_delta(led.snapshot(), base_led),
        spans=[s for s in tracer.spans() if s["id"] > base_id])


def _tokens(out):
    return [np.asarray(r["generated"]).tolist() if "error" not in r
            else r["error"]["kind"] for r in out]


def _counters(res):
    """The job's nonzero ``serving.*``/``prefix_cache.*`` counter deltas
    (a counter another test created earlier shows a zero delta)."""
    return {k: v for k, v in res["reg"]["counters"].items()
            if k.startswith(("serving.", "prefix_cache.")) and v}


def _span_names(res, traces):
    by = collections.defaultdict(collections.Counter)
    for s in res["spans"]:
        if s["trace"] in traces:
            by[s["trace"]][s["name"]] += 1
    return dict(by)


@pytest.fixture(scope="module", params=LAYOUTS)
def served(request, trees):
    """Both packages' engines over the same rows, twice on one predictor
    (cold, then a warm radix cache)."""
    layout = request.param
    out = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        pred = _build(pkg, trees[0], layout, chunk_size=2, **PREFIX)
        out[name] = [_serve(pkg, pred, _rows("%s-%s" % (layout, job)))
                     for job in ("cold", "warm")]
    return layout, out


def test_tokens_counters_and_histograms_like_jax(served):
    _, res = served
    for got, want in zip(res["port"], res["jax"]):
        assert _tokens(got["out"]) == _tokens(want["out"])
        assert all("error" not in r for r in got["out"])
        assert _counters(got) == _counters(want)
        c = _counters(got)
        assert c["serving.completed"] == c["serving.admitted"] == 9
        assert c["serving.chunks"] == got["stats"]["chunks"]
        for name in HISTS:
            g, w = got["reg"]["histograms"][name], \
                want["reg"]["histograms"][name]
            assert g["count"] == w["count"] == 9, name
            assert g["buckets"] == w["buckets"], name
            assert g["p50"] == w["p50"] and g["p99"] == w["p99"], name
    warm = _counters(res["port"][1])
    assert warm["prefix_cache.hits"] == 9
    assert warm["prefix_cache.tokens_saved"] == \
        res["port"][1]["stats"]["prefix_tokens_saved"] > 0


def test_ledger_tenants_like_jax_and_chip_sec_sums_to_decode_wall(served):
    _, res = served
    for got, want in zip(res["port"], res["jax"]):
        gt, wt = got["ledger"]["tenants"], want["ledger"]["tenants"]
        assert sorted(gt) == sorted(wt) == sorted(TENANTS)
        for t in TENANTS:
            for f in ("requests", "tokens_in", "tokens_out",
                      "prefix_tokens_saved", "wire_bytes"):
                assert gt[t][f] == wt[t][f], (t, f)
        stats = got["stats"]
        assert sum(v["tokens_out"] for v in gt.values()) == \
            stats["tokens_out"]
        assert sum(v["prefix_tokens_saved"] for v in gt.values()) == \
            stats["prefix_tokens_saved"]
        assert sum(v["chip_sec"] for v in gt.values()) == pytest.approx(
            stats["decode_wall_sec"], rel=1e-9)
    # the rows are keyed by trace id
    layout = served[0]
    led = ttel.get_ledger()
    for job, got in zip(("cold", "warm"), res["port"]):
        rids = [r["tid"] for r in _rows("%s-%s" % (layout, job))]
        rows = [led.row(rid) for rid in rids]
        assert all(r["closed"] and r["page_sec"] > 0 for r in rows)
        assert [r["tenant"] for r in rows] == [TENANTS[i % 3]
                                                for i in range(9)]
        assert sum(r["chip_sec"] for r in rows) == pytest.approx(
            got["stats"]["decode_wall_sec"], rel=1e-9)


def test_span_names_per_trace_like_jax(served):
    layout, res = served
    for job, got, want in zip(("cold", "warm"), res["port"], res["jax"]):
        traces = {r["tid"] for r in _rows("%s-%s" % (layout, job))}
        g, w = _span_names(got, traces), _span_names(want, traces)
        assert g == w
        assert set(g) == traces
        for names in g.values():
            assert names["admission"] == names["prefill"] == 1
            assert names["queue_wait"] == names["emit"] == 1
            assert names["decode_chunk"] >= 1
        hits = [s["attrs"]["prefix_hit"] for s in got["spans"]
                if s["name"] == "prefill"]
        assert hits == [s["attrs"]["prefix_hit"] for s in want["spans"]
                        if s["name"] == "prefill"]
        # the first admit of the cold job misses; the warm job hits
        assert not hits[0] if job == "cold" else all(hits)
    chrome = ttel.get_tracer().export_chrome(trace="%s-warm-0" % layout)
    names = [e["name"] for e in json.loads(json.dumps(chrome))[
        "traceEvents"] if e["ph"] == "X"]
    assert names[:3] == ["admission", "queue_wait", "prefill"]
    assert names[-1] == "emit"


def test_bad_tenant_like_jax_and_validate_tenant(trees):
    rows = _rows("badt", n=6)
    for i, v in ((1, 7), (2, ""), (4, None), (5, b"\xff")):
        rows[i]["who"] = v
    res = [_serve(pkg, _build(pkg, trees[0], "paged", chunk_size=2), rows,
                  on_error="record") for pkg in (PORT, JAX)]
    got, want = (r["out"] for r in res)
    assert [r.get("error") for r in got] == [r.get("error") for r in want]
    assert [i for i, r in enumerate(got) if "error" in r] == [1, 2, 4, 5]
    for i in (1, 2, 4, 5):
        with pytest.raises(serving_engine.RequestValidationError) as e:
            serving_engine.validate_tenant(rows[i], i, "who")
        with pytest.raises(jengine.RequestValidationError) as je:
            jengine.validate_tenant(rows[i], i, "who")
        assert (e.value.kind, str(e.value)) == (je.value.kind,
                                               str(je.value))
        assert got[i]["error"]["message"] == str(e.value)
    assert serving_engine.validate_tenant({"w": np.str_("a")}, 0, "w") == \
        jengine.validate_tenant({"w": np.str_("a")}, 0, "w") == "a"
    assert serving_engine.validate_tenant({"w": b"ab"}, 0, "w") == "ab"
    assert _counters(res[0]) == _counters(res[1])


@pytest.fixture(scope="module")
def swapped(trees, tmp_path_factory):
    """The hot-swap scenario of test_torch_hotswap: step 5 published while
    request 1 is in flight, committed after two clean requests; then a
    step 7 of NaN weights whose canary rolls back."""
    tmp = tmp_path_factory.mktemp("swap")
    rows = [dict(r, max_new=b) for r, b in zip(
        _rows("swap", n=6), [2, 12, 12, 12, 12, 12])]
    mapping = dict(MAPPING, max_new="max_new")
    nan = jax.tree.map(lambda x: np.full_like(x, np.nan), trees[1])
    res = {}
    for name, pkg, ck, hs in (("port", PORT, ckpt, hot_swap),
                              ("jax", JAX, jckpt, jhot)):
        root = str(tmp / name)
        pred = _build(pkg, trees[0], "paged", max_new=12, chunk_size=2)
        watcher = hs.CheckpointWatcher(root, poll_interval=0.0,
                                       background=False)
        tracer = pkg[2].get_tracer()
        base_id = _last_id(tracer)
        gen = pkg[0].predict_rows(
            pred, [dict(r) for r in rows], mapping, batch_size=2,
            schedule="continuous", watcher=watcher, rollback_window=2)
        out = [next(gen)]
        ck.publish_for_serving(root, 5, trees[1])
        out.extend(gen)
        ck.publish_for_serving(root, 7, nan)
        out2 = list(pkg[0].predict_rows(
            pred, [dict(r, tid=r["tid"] + "b") for r in rows], mapping,
            batch_size=2, schedule="continuous", watcher=watcher))
        spans = [s for s in tracer.spans() if s["id"] > base_id]
        res[name] = (out + out2, spans)
    return res


SWAP_MARKS = ("swap_ingest", "swap", "swap_apply", "swap_commit",
              "swap_rollback", "checkpoint_quarantined", "swap_requeue")


def test_swap_marks_like_jax(swapped):
    (got, gs), (want, ws) = swapped["port"], swapped["jax"]
    assert _tokens(got) == _tokens(want)

    def marks(spans):
        return [(s["name"], s.get("trace"), s.get("severity"),
                 (s.get("attrs") or {}).get("step"),
                 (s.get("attrs") or {}).get("kind"))
                for s in spans if s["name"] in SWAP_MARKS]

    assert marks(gs) == marks(ws)
    names = [m[0] for m in marks(gs)]
    for name in ("swap_ingest", "swap", "swap_apply", "swap_commit",
                 "swap_rollback", "checkpoint_quarantined"):
        assert name in names, name
    rollback = [m for m in marks(gs) if m[0] == "swap_rollback"]
    assert rollback == [("swap_rollback", "swap", "page", 7, None)]


def test_status_provider_lets_a_finished_engine_go(trees):
    pred = _build(PORT, trees[0], "paged", chunk_size=2)
    res = _serve(PORT, pred, _rows("status", n=4))
    eng = res.pop("engine")
    status = health.provider_statuses()["serving"]
    assert status["completed"] == 4 and status["in_flight"] == 0
    assert status["usage"]["tokens_out"] == res["stats"]["tokens_out"]
    ref = weakref.ref(eng)
    del eng, res
    gc.collect()
    assert ref() is None
    assert health.provider_statuses()["serving"] == {"finished": True}


def test_watchdog_fire_leaves_one_flight_recorder_bundle(trees, tmp_path):
    """A planted wedge fires the watchdog once: a recorder on the
    journal's bus freezes one bundle holding the ``watchdog_fire`` event
    and the recent ``decode_chunk`` spans; the tokens equal an unwedged
    run's."""
    pred = _build(PORT, trees[0], "paged", chunk_size=2)
    rows = _rows("wd", n=4)
    ref = _serve(PORT, pred, rows)
    rec = blackbox.FlightRecorder(dump_dir=str(tmp_path), min_interval=0)
    rec.start()
    try:
        res = _serve(PORT, pred, rows, watchdog_timeout=1.0,
                     wedge_fn=_wedge_once(1, 2.0))
    finally:
        rec.stop()
    assert _tokens(res["out"]) == _tokens(ref["out"])
    assert res["stats"]["watchdog_fires"] == 1
    assert res["reg"]["counters"]["serving.watchdog_fires"] == 1
    dumps = glob.glob(os.path.join(str(tmp_path), "blackbox-*.json"))
    assert len(dumps) == 1
    data = blackbox.load_dump(dumps[0])
    assert data["reason"] == "watchdog_fire"
    assert data["trigger"]["severity"] == "page"
    assert any(e["kind"] == "watchdog_fire" for e in data["events"])
    assert any(s["name"] == "decode_chunk" and s["trace"] == "wd-0"
               for s in data["spans"])
    recovered = [s for s in res["spans"] if s["name"] == "watchdog_recover"]
    assert len(recovered) == res["stats"]["recovered"] > 0


def test_profile_dir_writes_a_torch_profiler_trace(trees, tmp_path):
    prof = str(tmp_path / "prof")
    pred = _build(PORT, trees[0], "paged", chunk_size=2,
                  profile_dir=prof, profile_steps=2)
    assert pred.profile == {"dir": prof, "steps": 2}
    res = _serve(PORT, pred, _rows("prof", n=4))
    assert res["stats"]["chunks"] > 2
    session = res["engine"]._profile
    assert session.remaining <= 0
    files = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    assert files == [session.trace_path]
    with open(files[0]) as f:
        trace = json.load(f)
    # the decode's operators ran inside the trace (on a card, K1's
    # kernels: chip_smoke.py's telemetry phase checks them by name)
    ops = {e["name"] for e in trace["traceEvents"]
           if str(e.get("name", "")).startswith("aten::")}
    assert {"aten::matmul", "aten::softmax"} & ops
