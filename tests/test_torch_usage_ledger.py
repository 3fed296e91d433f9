"""The port's usage ledger (``telemetry/ledger.py``) against the JAX
package's, on the CPU: the same open, chunk-charge and close sequence
gives equal rows, tenant aggregates and registry mirrors; the
space-saving sketch ranks a skewed stream as the reference's does; the
tenant table folds into the overflow tenant as the reference's does; and
``usage_openmetrics`` renders the same text.
"""

import numpy as np
import pytest

from tensorflowonspark_tpu import telemetry as jtel
from tensorflowonspark_tpu.telemetry import ledger as jledger
from tensorflowonspark_tpu_torch import telemetry as ttel
from tensorflowonspark_tpu_torch.telemetry import ledger as tledger

PKGS = [(tledger, ttel), (jledger, jtel)]


def _ledger(mod, tel, **kw):
    reg = tel.MetricsRegistry(enabled=True)
    return mod.UsageLedger(registry=reg, **kw), reg


def _story(mod, tel, n=24, seed=0, **kw):
    """An engine's life: admissions, per-chunk charges split by slot
    share, closes with latency, a request re-opened after close, and a
    static-schedule record."""
    led, reg = _ledger(mod, tel, **kw)
    rng = np.random.RandomState(seed)
    tenants = ["acme", "beta.co", "c d", "acme"]
    live = []
    for i in range(n):
        rid = "req%d" % i
        led.open(rid, tenant=tenants[i % 4],
                 tokens_in=int(rng.randint(4, 90)),
                 wire_bytes=4 * int(rng.randint(4, 90)),
                 prefix_tokens_saved=16 * (i % 3),
                 queue_wait_sec=float(rng.rand()) / 8)
        live.append(rid)
        if len(live) >= 4 or i == n - 1:
            for chunk in range(3):
                dur = 0.0625 * (chunk + 1)
                for r in live:
                    led.charge(r, chip_sec=dur / len(live),
                               page_sec=dur * (2 + chunk))
            for r in live:
                led.close(r, tokens_out=int(rng.randint(1, 33)),
                          latency_sec=0.5)
            live = []
    led.close("req3", tokens_out=40)         # a re-close corrects tokens
    led.open("req3", tenant="late", tokens_in=5)   # closed: opens fresh
    led.settle("req3", chip_sec=0.25, page_sec=1.0, tokens_out=7)
    led.record("sj1-req0", tenant="acme", tokens_in=9, tokens_out=8,
               latency_sec=0.125)
    return led, reg


def test_same_sequence_gives_equal_rows_and_tenants():
    (tl, treg), (jl, jreg) = (_story(m, t) for m, t in PKGS)
    assert tl.rows() == jl.rows()
    assert tl.tenants() == jl.tenants()
    assert tl.row("req3") == jl.row("req3")
    assert tl.row("nope") is None
    assert tl.top(3) == jl.top(3)
    assert tl.snapshot() == jl.snapshot()
    assert treg.snapshot()["counters"] == jreg.snapshot()["counters"]
    # the registry mirror recovers the tenant table
    assert (tledger.tenants_from_snapshot(treg.snapshot())
            == jledger.tenants_from_snapshot(jreg.snapshot()))
    acme = tl.tenants()["acme"]
    assert acme["requests"] == 13 and acme["tokens_out"] > 0
    rows = tl.rows(tenant="acme")
    # req3's acme row left the table when the rid opened fresh
    assert all(r["tenant"] == "acme" for r in rows) and len(rows) == 12
    assert tl.row("req3")["tenant"] == "late"


def test_rows_bounded_and_conserved_like_jax():
    (tl, _), (jl, _) = (_story(m, t, n=40, max_rows=6) for m, t in PKGS)
    assert tl.snapshot() == jl.snapshot()
    assert tl.rows_evicted == jl.rows_evicted > 0
    for f in ("chip_sec", "page_sec", "tokens_in"):
        total = sum(r[f] for r in tl.rows()) + tl.evicted_totals[f]
        agg = sum(t[f] for t in tl.tenants().values())
        assert total == pytest.approx(agg, rel=1e-12)


def test_overflow_tenant_folding_like_jax():
    res = []
    for mod, tel in PKGS:
        led, _ = _ledger(mod, tel, max_tenants=3, sketch_capacity=4)
        for i in range(12):
            t = "t%d" % (i % 6)
            led.record("r%d" % i, tenant=t, tokens_in=10 * (i % 6) + 1,
                       tokens_out=i)
        res.append(led)
    tl, jl = res
    assert tl.tenants() == jl.tenants()
    assert tledger.OVERFLOW_TENANT in tl.tenants()
    assert tl.tenants_folded == jl.tenants_folded > 0
    assert len(tl.tenants()) <= 3 + 1
    text = tledger.usage_openmetrics(tl.tenants())
    assert text == jledger.usage_openmetrics(jl.tenants())
    assert text.endswith("# EOF\n")
    assert 'usage_tokens_in_total{tenant="__other__"}' in text


@pytest.mark.parametrize("capacity", [4, 16])
def test_space_saving_top_k_like_jax(capacity):
    rng = np.random.RandomState(capacity)
    stream = ["k%d" % k for k in rng.zipf(1.3, 4000) % 200]
    weights = rng.randint(1, 20, len(stream))
    sk = [mod.SpaceSaving(capacity) for mod, _ in PKGS]
    for key, w in zip(stream, weights):
        for s in sk:
            s.add(key, float(w))
    assert sk[0].top() == sk[1].top()
    assert sk[0].top(3) == sk[1].top(3)
    assert len(sk[0]) == capacity and sk[0].total == sk[1].total
    heavy = sk[0].top(1)[0][0]
    assert sk[0].estimate(heavy) == sk[1].estimate(heavy)
    assert sk[0].estimate("absent") == (0.0, 0.0)
    sk[0].add("k0", 0.0)
    sk[0].add("k0", -1.0)
    assert sk[0].total == sk[1].total


def test_snapshot_delta_merge_and_ratios_like_jax():
    out = []
    for mod, tel in PKGS:
        led, _ = _story(mod, tel, n=8)
        base = led.snapshot()
        led.record("x", tenant="acme", tokens_in=3, tokens_out=4)
        led.record("y", tenant="new", tokens_in=2, tokens_out=0)
        delta = mod.snapshot_delta(led.snapshot(), base)
        merged = mod.merge_usage([base, led.snapshot(), None])
        ratios = mod.chip_sec_per_token(led.tenants(), min_tokens=2)
        out.append((delta, merged, ratios))
    assert out[0] == out[1]
    delta = out[0][0]
    assert delta["tenants"]["acme"]["tokens_out"] == 4
    assert "new" in delta["tenants"]


def test_safe_tenant_like_jax():
    for t in ("acme", "a.b", "c d", "", "é", 7):
        assert tledger.safe_tenant(t) == jledger.safe_tenant(t)
    assert "." not in tledger.safe_tenant("a.b.c")


def test_disabled_ledger_is_a_noop():
    reg = ttel.MetricsRegistry(enabled=False)
    led = tledger.UsageLedger(registry=reg)
    led.open("r", tenant="a", tokens_in=3)
    led.settle("r", chip_sec=1.0, tokens_out=2)
    assert led.rows() == [] and led.tenants() == {}
    led.enabled_override = True
    led.record("r", tenant="a", tokens_in=3)
    assert led.tenants()["a"]["tokens_in"] == 3


def test_default_tenant_and_global_ledger():
    assert tledger.DEFAULT_TENANT == jledger.DEFAULT_TENANT
    assert tledger.OVERFLOW_TENANT == jledger.OVERFLOW_TENANT
    assert tledger.FIELDS == jledger.FIELDS
    led = ttel.get_ledger()
    assert led is tledger.get_ledger()
    base = led.snapshot()
    led.record("t_default_probe", tokens_in=2, tokens_out=1)
    d = tledger.snapshot_delta(led.snapshot(), base)["tenants"]
    assert d[tledger.DEFAULT_TENANT]["requests"] == 1
