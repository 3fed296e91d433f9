"""The port's telemetry registry, tracer, snapshot merging and metric
catalog (``tensorflowonspark_tpu_torch/telemetry/``) against the JAX
package's, on the CPU.

- The same observations give equal histogram snapshots: bucket bounds,
  counts, min/max, percentiles, deltas, merges and tail exemplars.  The
  sums differ by design: the port's running sum is compensated
  (Neumaier, the rule of Python 3.12's ``sum()``) and equals
  ``sum(values)`` bit for bit, where the reference's plain ``+=`` is
  within ``(n - 1) * 2**-53`` of the exact sum relative to the sum of
  magnitudes (the bound of recursive summation): the sums are held to
  that, which is 1e-15 relative for up to 9 values.
- The disabled registry hands out the shared null metrics by identity.
- The same spans under one injected clock export the same Chrome trace.
- Every literal metric name in the port is in its catalog, and each
  catalog row is the reference's row for that name.
"""

import ast
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from tensorflowonspark_tpu import telemetry as jtel
from tensorflowonspark_tpu.telemetry import catalog as jcatalog
from tensorflowonspark_tpu.telemetry import registry as jreg
from tensorflowonspark_tpu.telemetry import tracing as jtracing
from tensorflowonspark_tpu_torch import telemetry as ttel
from tensorflowonspark_tpu_torch.telemetry import catalog as tcatalog
from tensorflowonspark_tpu_torch.telemetry import registry as treg
from tensorflowonspark_tpu_torch.telemetry import tracing as ttracing

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tensorflowonspark_tpu_torch")
#: the unit roundoff of float64: a plain running sum of n values is within
#: (n - 1) * U of the exact sum, relative to the sum of their magnitudes
U = 2.0 ** -53


def _values(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "gamma":
        v = rng.gamma(2.0, 0.05, n)
    elif kind == "wide":
        v = 10.0 ** rng.uniform(-7, 3, n)  # under and over the buckets
    else:
        v = rng.exponential(0.01, n) + (rng.rand(n) < 0.05) * 3.0
    return [float(x) for x in v]


def _strip_ts(hist):
    """A histogram snapshot without its exemplars' wall times, and with
    its sum and mean apart."""
    out = {k: v for k, v in hist.items() if k not in ("sum", "mean")}
    if "exemplars" in out:
        out["exemplars"] = [[lo, hi, {k: v for k, v in ex.items()
                                      if k != "ts"}]
                            for lo, hi, ex in out["exemplars"]]
    return out


def _same_hist(got, want, magnitude, terms=None):
    """Equal snapshots, the sums within the recursive-summation bound of
    ``terms`` additions (default: ``want``'s count) over values whose
    magnitudes sum to ``magnitude``."""
    assert _strip_ts(got) == _strip_ts(want)
    n = max(1, want["count"])
    tol = max((terms or n) - 1, 1) * U * magnitude
    assert abs(got["sum"] - want["sum"]) <= tol
    if "mean" in want:
        assert abs(got["mean"] - want["mean"]) <= tol / n


def _observe(mod, vals, name="lat", exemplars=True):
    reg = mod.MetricsRegistry(enabled=True)
    h = reg.histogram(name)
    for i, v in enumerate(vals):
        h.observe(v, exemplar=("req%d" % i) if exemplars else None)
    return reg, h


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------


def test_default_buckets_match_jax():
    assert treg.default_buckets() == jreg.default_buckets()
    assert treg.Histogram("h").bounds == jreg.Histogram("h").bounds


@pytest.mark.parametrize("kind,n,seed", [
    ("gamma", 8000, 0), ("wide", 500, 1), ("tail", 2000, 2), ("gamma", 1, 3),
])
def test_same_observations_give_equal_snapshots(kind, n, seed):
    vals = _values(kind, n, seed)
    (treg_, th), (jreg_, jh) = _observe(treg, vals), _observe(jreg, vals)
    got, want = th.snapshot(), jh.snapshot()
    _same_hist(got, want, sum(map(abs, vals)))
    assert got["sum"] == sum(vals)  # the port's sum is exact
    for q in (1, 25, 50, 90, 99, 99.9, 100):
        assert th.percentile(q) == jh.percentile(q)
        assert (treg.histogram_percentile(got, q)
                == jreg.histogram_percentile(want, q))
    for q in (50, 99):
        got_tail = [{k: v for k, v in e.items() if k != "ts"}
                    for e in treg.tail_exemplars(got, q)]
        want_tail = [{k: v for k, v in e.items() if k != "ts"}
                     for e in jreg.tail_exemplars(want, q)]
        assert got_tail == want_tail
    # a delta over a window and a merge with a second process
    base_t, base_j = treg_.snapshot(), jreg_.snapshot()
    extra = _values(kind, 300, seed + 10)
    for i, v in enumerate(extra):
        th.observe(v, exemplar="late%d" % i)
        jh.observe(v, exemplar="late%d" % i)
    dt = treg.snapshot_delta(treg_.snapshot(), base_t)["histograms"]["lat"]
    dj = jreg.snapshot_delta(jreg_.snapshot(), base_j)["histograms"]["lat"]
    # the delta subtracts two sums of n + 300 and n values
    _same_hist(dt, dj, 2 * sum(map(abs, vals)) + sum(map(abs, extra)),
               terms=2 * n + 300)
    assert dt["count"] == 300
    other = _values("wide", 200, seed + 20)
    (ot, _), (oj, _) = (_observe(treg, other, exemplars=False),
                        _observe(jreg, other, exemplars=False))
    mt = ttel.merge_snapshots([treg_.snapshot(), ot.snapshot()])
    mj = jtel.merge_snapshots([jreg_.snapshot(), oj.snapshot()])
    _same_hist(mt["histograms"]["lat"], mj["histograms"]["lat"],
               sum(map(abs, vals + extra + other)))
    assert mt["histograms"]["lat"]["sum"] == sum(vals + extra) + sum(other)
    view_t = ttel.fleet_view({0: {"metrics": treg_.snapshot()},
                              1: {"metrics": ot.snapshot()}})
    assert sorted(view_t) == ["executors", "fleet"]
    assert view_t["fleet"]["histograms"]["lat"]["count"] == (
        n + 300 + 200)


def test_counters_and_gauges_snapshot_and_delta_like_jax():
    snaps = []
    for mod in (treg, jreg):
        reg = mod.MetricsRegistry(enabled=True)
        reg.counter("rows").inc(5)
        reg.gauge("depth").set(3)
        base = reg.snapshot()
        reg.counter("rows").inc(37)
        reg.counter("new").add(2)
        reg.gauge("depth").set(7.5)
        snaps.append((reg.snapshot(), mod.snapshot_delta(reg.snapshot(),
                                                         base)))
    assert snaps[0] == snaps[1]
    assert snaps[0][1]["counters"] == {"rows": 37, "new": 2}
    json.dumps(snaps[0][0])
    with pytest.raises(ValueError, match="is a Counter"):
        reg = treg.MetricsRegistry(enabled=True)
        reg.counter("x")
        reg.histogram("x")


def test_histogram_sum_exact_through_delta_and_merge():
    """The JAX package's test of this name, against the port's registry:
    the exact running sum threads through snapshot, delta and merge
    (the reference's own plain ``+=`` fails its first assertion)."""
    vals_a = [0.0123456789, 0.987654321, 1.5e-4, 3.14159]
    vals_b = [0.5, 0.25, 0.125]
    a = treg.MetricsRegistry(enabled=True)
    b = treg.MetricsRegistry(enabled=True)
    for v in vals_a:
        a.histogram("h").observe(v)
    for v in vals_b:
        b.histogram("h").observe(v)
    sa = a.snapshot()["histograms"]["h"]
    assert sa["sum"] == sum(vals_a)  # bit-exact
    assert sa["mean"] == sum(vals_a) / len(vals_a)
    base = a.snapshot()
    extra = [0.777, 0.001]
    for v in extra:
        a.histogram("h").observe(v)
    d = treg.snapshot_delta(a.snapshot(), base)
    dh = d["histograms"]["h"]
    assert dh["sum"] == pytest.approx(sum(extra), rel=0, abs=1e-15)
    assert dh["mean"] == pytest.approx(sum(extra) / 2, rel=0, abs=1e-15)
    m = ttel.merge_snapshots([
        {"counters": {}, "gauges": {}, "histograms": {"h": sa}},
        b.snapshot()])
    mh = m["histograms"]["h"]
    assert mh["sum"] == sum(vals_a) + sum(vals_b)
    assert mh["mean"] == (sum(vals_a) + sum(vals_b)) / 7


@pytest.mark.parametrize("seed", range(4))
def test_running_sum_is_python_sum_bit_for_bit(seed):
    rng = np.random.RandomState(seed)
    vals = [float(x) for x in np.concatenate([
        rng.exponential(1e-3, 500), -rng.exponential(1e2, 50),
        10.0 ** rng.uniform(-9, 15, 500)])]
    rng.shuffle(vals)
    h = treg.Histogram("h")
    for v in vals:
        h.observe(v)
    assert h.sum == sum(vals) == h.snapshot()["sum"]


def test_counter_concurrency_exact():
    reg = treg.MetricsRegistry(enabled=True)
    c = reg.counter("n")
    h = reg.histogram("h")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                c.inc()
                h.observe(0.5)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.value == 32000
    assert h.count == 32000 and h.sum == 16000.0


def test_disabled_registry_hands_out_null_singletons():
    reg = treg.MetricsRegistry(enabled=False)
    assert reg.counter("a") is treg.NULL_COUNTER
    assert reg.counter("b") is treg.NULL_COUNTER
    assert reg.gauge("g") is treg.NULL_GAUGE
    assert reg.histogram("h") is treg.NULL_HISTOGRAM
    reg.counter("a").inc(5)
    reg.histogram("h").observe(1.0)
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert (treg.NULL_HISTOGRAM.snapshot()
            == jreg.NULL_HISTOGRAM.snapshot())
    tr = ttracing.Tracer(enabled=False)
    span = tr.span("x", trace="t")
    assert span is tr.span("y")
    with span:
        pass
    tr.add("z", 0.0, 1.0)
    tr.mark("m")
    assert tr.spans() == []


def test_env_kill_switch(monkeypatch):
    monkeypatch.setenv("TFOS_TELEMETRY", "0")
    assert not treg.MetricsRegistry().enabled
    assert not ttracing.Tracer().enabled
    monkeypatch.setenv("TFOS_TELEMETRY", "1")
    assert treg.MetricsRegistry().enabled


def test_set_enabled_flips_registry_and_tracer():
    try:
        ttel.set_enabled(False)
        assert not ttel.enabled() and not ttel.get_tracer().enabled
        assert ttel.get_registry().counter("x") is treg.NULL_COUNTER
        ttel.set_enabled(True)
        assert ttel.enabled() and ttel.get_tracer().enabled
        assert ttel.get_registry().counter("x") is not treg.NULL_COUNTER
    finally:
        ttel.set_enabled(True)


# ----------------------------------------------------------------------
# tracing
# ----------------------------------------------------------------------


class _FakeClock(object):
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _span_story(mod, journal):
    tr = mod.Tracer(enabled=True, journal=journal)
    with tr.span("admission", trace="req0"):
        pass
    with tr.span("outer", trace="req1", batches=2) as sp:
        sp.set("prefix_hit", True)
        with tr.span("inner"):
            pass
    tr.add("decode_chunk", time.perf_counter(), 0.5, trace="req1", chunk=0)
    tr.mark("shed", trace="req2", severity="warn", request_index=2)
    tr.mark("emit", trace="req0")
    return tr


def test_chrome_trace_equal_under_an_injected_clock(monkeypatch):
    exports = []
    for mod, jmod in ((ttracing, ttel), (jtracing, jtel)):
        monkeypatch.setattr(time, "perf_counter", _FakeClock())
        tr = _span_story(mod, jmod.EventJournal(enabled=True))
        exports.append(tr.export_chrome())
        assert [s["name"] for s in tr.spans(trace="req1")] == [
            "inner", "outer", "decode_chunk"]
    got, want = exports
    assert got == want
    assert json.loads(json.dumps(got)) == got
    ev = {e["name"]: e for e in got["traceEvents"]}
    assert ev["inner"]["args"]["trace"] == "req1"  # inherited
    assert "parent" in ev["inner"]["args"]
    assert "parent" not in ev["outer"]["args"]
    assert ev["shed"]["args"]["severity"] == "warn"
    assert ev["decode_chunk"]["dur"] == 500000.0
    one = _span_story(ttracing, ttel.EventJournal(enabled=True))
    assert {e["args"].get("trace") for e in one.export_chrome(
        trace="req0")["traceEvents"] if e["ph"] == "X"} == {"req0"}


def test_merge_traces_like_jax(monkeypatch):
    parts = []
    for i in range(2):
        monkeypatch.setattr(time, "perf_counter", _FakeClock())
        parts.append(_span_story(ttracing, ttel.EventJournal(
            enabled=True)).export_chrome())
    spec = [(parts[0], 0.0, "driver"), {"trace": parts[1], "offset": 1.5,
                                        "label": "executor-1"}]
    got, want = ttel.merge_traces(spec), jtel.merge_traces(spec)
    assert got == want
    ts = [e["ts"] for e in got["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)


def test_bounded_store_counts_dropped_spans():
    reg = ttel.get_registry()
    base = reg.counter("tracing.dropped_spans").value
    tr = ttracing.Tracer(enabled=True, max_spans=10,
                         journal=ttel.EventJournal(enabled=True))
    for i in range(10):
        tr.mark("m%d" % i)
    assert tr.dropped_spans == 0
    for i in range(7):
        tr.mark("x%d" % i)
    spans = tr.spans()
    assert len(spans) == 10 and spans[-1]["name"] == "x6"
    assert tr.dropped_spans == 7
    assert reg.counter("tracing.dropped_spans").value == base + 7
    assert len(tr.spans(name="x3")) == 1 and tr.spans(name="m0") == []


def test_default_span_bound_matches_jax():
    assert ttracing.MAX_SPANS == jtracing.MAX_SPANS


# ----------------------------------------------------------------------
# catalog
# ----------------------------------------------------------------------

_METRIC_CALLS = ("counter", "gauge", "histogram")


def _port_metric_names():
    """``(literal names, dynamic call sites)`` of every
    ``.counter/.gauge/.histogram(...)`` call in the port: a literal first
    argument, or a module-level string constant named by it."""
    names, dynamic = set(), []
    for root, _dirs, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            consts = {
                t.id: node.value.value
                for node in tree.body if isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                for t in node.targets if isinstance(t, ast.Name)
            }
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _METRIC_CALLS
                        and node.args):
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    names.add(arg.value)
                elif isinstance(arg, ast.Name) and arg.id in consts:
                    names.add(consts[arg.id])
                else:
                    dynamic.append("%s:%d" % (os.path.relpath(path, PKG),
                                              node.lineno))
    return names, dynamic


def test_every_port_metric_name_is_in_the_catalog():
    names, dynamic = _port_metric_names()
    assert len(names) >= 20
    unknown = sorted(n for n in names if not tcatalog.known(n))
    assert unknown == []
    # the one minted name: the ledger's usage.<field>.<tenant> mirror
    assert [d.split(":")[0] for d in dynamic] == ["telemetry/ledger.py"]
    # every catalog row is created somewhere in the port
    assert sorted(tcatalog.NAMES - names) == []


def test_catalog_rows_equal_the_reference_rows():
    ref = {m.name: m for m in jcatalog.METRICS}
    assert tcatalog.duplicates() == []
    for m in tcatalog.METRICS:
        assert tuple(m) == tuple(ref[m.name]), m.name
    assert tcatalog.DYNAMIC_PREFIXES == jcatalog.DYNAMIC_PREFIXES
    assert tcatalog.RESERVED_INPUT_COLUMNS == jcatalog.RESERVED_INPUT_COLUMNS
    assert tcatalog.known("usage.tokens_in.acme")
    assert not tcatalog.known("serving.admited")


def test_engine_reserved_inputs_equal_the_catalog():
    from tensorflowonspark_tpu_torch import serving_engine

    assert serving_engine.RESERVED_INPUTS == tcatalog.RESERVED_INPUT_COLUMNS


# ----------------------------------------------------------------------
# status providers
# ----------------------------------------------------------------------


def test_status_providers():
    from tensorflowonspark_tpu.telemetry import health as jhealth
    from tensorflowonspark_tpu_torch.telemetry import health as thealth

    def boom():
        raise RuntimeError("down")

    for mod in (thealth, jhealth):
        mod.register_status_provider("t_ok", lambda: {"up": 1})
        mod.register_status_provider("t_boom", boom)
    try:
        got = {k: v for k, v in thealth.provider_statuses().items()
               if k.startswith("t_")}
        want = {k: v for k, v in jhealth.provider_statuses().items()
                if k.startswith("t_")}
        assert got == want == {"t_ok": {"up": 1},
                               "t_boom": {"error": "down"}}
    finally:
        for mod in (thealth, jhealth):
            mod.unregister_status_provider("t_ok")
            mod.unregister_status_provider("t_boom")
    assert "t_ok" not in thealth.provider_statuses()
