"""The port's HTTP exposition (``telemetry/exposition.py``) against the JAX
package's, on the CPU.

- For the same snapshot (a registry's, and a fleet merge) the
  OpenMetrics text of both packages is equal byte for byte, and each
  package's strict ``parse_openmetrics`` reads the other's text to the
  same families.
- The reference's malformed expositions (``tests/test_exposition.py``)
  are refused by both parsers with the same message.
- A live plane answers its five routes (``/metrics`` strict-parsed,
  ``/healthz``, ``/status``, ``/usage`` in both formats, ``/journal``)
  and a 404 elsewhere; ``/healthz`` turns 503 when an executor's
  heartbeats stop (death by silence) and 200 when they resume; a plane
  over a bare reservation server exposes what the heartbeats carried.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from tensorflowonspark_tpu.telemetry import aggregate as jaggregate
from tensorflowonspark_tpu.telemetry import exposition as jexpo
from tensorflowonspark_tpu.telemetry import registry as jreg
from tensorflowonspark_tpu_torch.cluster import reservation
from tensorflowonspark_tpu_torch.telemetry import aggregate as taggregate
from tensorflowonspark_tpu_torch.telemetry import exposition as texpo
from tensorflowonspark_tpu_torch.telemetry import health as thealth
from tensorflowonspark_tpu_torch.telemetry import registry as treg

EXPOS = {"jax": jexpo, "torch": texpo}


def _sample(reg_mod, scale=1):
    reg = reg_mod.MetricsRegistry(enabled=True)
    reg.counter("serving.admitted").inc(42 * scale)
    reg.counter("train.steps").inc(7 * scale)
    reg.counter("usage.chip_sec.acme").inc(0.25 * scale)
    reg.gauge("serving.weight_generation").set(3)
    reg.gauge("queue.depth").set(float("inf"))
    h = reg.histogram("serving.request_latency_sec")
    for v in (0.002, 0.004, 0.011, 0.7, 1.5, 1.5, 0.03, 1e5):
        h.observe(v * scale)
    reg.histogram("empty.sec")
    return reg.snapshot()


def _snapshots():
    one = _sample(treg)
    fleet = taggregate.merge_snapshots([one, _sample(treg, 2), None, {}])
    return {"registry": one, "fleet": fleet, "empty": {}}


@pytest.mark.parametrize("which", ["registry", "fleet", "empty"])
def test_text_equals_the_reference_byte_for_byte(which):
    snap = _snapshots()[which]
    got = texpo.to_openmetrics(snap)
    assert got == jexpo.to_openmetrics(json.loads(json.dumps(snap)))
    assert got.endswith("# EOF\n")


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_each_parser_reads_the_other_text(writer, reader):
    snap = _snapshots()["fleet"]
    text = EXPOS[writer].to_openmetrics(snap)
    fams = EXPOS[reader].parse_openmetrics(text)
    assert fams == EXPOS[writer].parse_openmetrics(text)
    assert fams["serving_admitted"]["type"] == "counter"
    assert fams["serving_admitted"]["samples"] == [
        ("serving_admitted_total", {}, 42.0 * 3)]
    assert fams["queue_depth"]["samples"][0][2] == float("inf")
    by_name = {}
    for name, labels, value in fams["serving_request_latency_sec"][
            "samples"]:
        by_name.setdefault(name, []).append((labels, value))
    h = snap["histograms"]["serving.request_latency_sec"]
    assert by_name["serving_request_latency_sec_count"] == [({}, 16.0)]
    assert by_name["serving_request_latency_sec_sum"] == [({}, h["sum"])]
    assert by_name["serving_request_latency_sec_bucket"][-1] == (
        {"le": "+Inf"}, 16.0)
    # the overflow bucket (1e5 s, 2e5 s) folds into +Inf only
    assert by_name["serving_request_latency_sec_bucket"][-2][1] == 14.0


def test_sanitize_like_the_reference():
    for name in ("serving.request_latency_sec", "9lives", "a-b c", "ok_1"):
        assert texpo.sanitize_name(name) == jexpo.sanitize_name(name)
    assert texpo.sanitize_name("9lives") == "_9lives"


def _good():
    return texpo.to_openmetrics(_sample(treg))


MALFORMED = [
    ("missing_eof", lambda: _good().replace("# EOF\n", ""), "EOF"),
    ("mid_text_eof", lambda: "# EOF\n" + _good(), "before the end"),
    ("no_type", lambda: "mystery_total 3\n# EOF\n", "no TYPE"),
    ("counter_suffix", lambda: "# TYPE c counter\nc 3\n# EOF\n", "_total"),
    ("missing_inf", lambda: ('# TYPE h histogram\nh_bucket{le="1.0"} 2\n'
                             "h_sum 0.5\nh_count 2\n# EOF\n"), r"\+Inf"),
    ("non_cumulative", lambda: (
        '# TYPE h histogram\nh_bucket{le="1.0"} 5\nh_bucket{le="2.0"} 3\n'
        'h_bucket{le="+Inf"} 5\nh_sum 0.5\nh_count 5\n# EOF\n'),
     "cumulative"),
    ("inf_vs_count", lambda: (
        '# TYPE h histogram\nh_bucket{le="1.0"} 2\nh_bucket{le="+Inf"} 2\n'
        "h_sum 0.5\nh_count 3\n# EOF\n"), "_count"),
    ("bad_value", lambda: "# TYPE c counter\nc_total banana\n# EOF\n",
     "value"),
    ("bad_label", lambda: '# TYPE h histogram\nh_bucket{le=1} 2\n# EOF\n',
     "sample line|label"),
    ("duplicate_type", lambda: ("# TYPE c counter\n# TYPE c counter\n"
                                "c_total 1\n# EOF\n"), "duplicate"),
    ("unknown_type", lambda: "# TYPE c thing\n# EOF\n", "unknown metric"),
    ("blank_line", lambda: "# TYPE c counter\n\nc_total 1\n# EOF\n",
     "blank line"),
    ("unsorted_le", lambda: (
        '# TYPE h histogram\nh_bucket{le="2.0"} 1\nh_bucket{le="1.0"} 1\n'
        'h_bucket{le="+Inf"} 1\nh_sum 0.5\nh_count 1\n# EOF\n'),
     "ascending"),
    ("no_sum", lambda: ('# TYPE h histogram\nh_bucket{le="+Inf"} 1\n'
                        "h_count 1\n# EOF\n"), "_sum"),
]


@pytest.mark.parametrize("text_fn,match", [m[1:] for m in MALFORMED],
                         ids=[m[0] for m in MALFORMED])
def test_strict_parser_refuses_like_the_reference(text_fn, match):
    text = text_fn()
    errors = []
    for mod in (texpo, jexpo):
        with pytest.raises(ValueError, match=match) as err:
            mod.parse_openmetrics(text)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ----------------------------------------------------------------------
# a live plane
# ----------------------------------------------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), \
            resp.read().decode("utf-8")


@pytest.fixture
def plane():
    reg = treg.MetricsRegistry(enabled=True)
    reg.counter("train.steps").inc(5)
    p = thealth.HealthPlane.local(
        registry=reg, interval=60,
        journal_fn=lambda: {"events": [{"kind": "restart", "seq": 1}],
                            "clocks": {"0": {"offset": 0.0, "rtt": 1e-4}}})
    p.scrape_once()
    srv = p.serve(port=0)
    yield p, srv
    p.stop()


def test_metrics_route_parses_and_counts_once(plane):
    _p, srv = plane
    code, ctype, body = _get(srv.url + "/metrics")
    assert code == 200 and ctype == texpo.OPENMETRICS_CONTENT_TYPE
    fams = texpo.parse_openmetrics(body)
    assert jexpo.parse_openmetrics(body) == fams
    assert fams["train_steps"]["samples"] == [("train_steps_total", {}, 5.0)]


def test_status_healthz_journal_and_404(plane):
    _p, srv = plane
    code, _, body = _get(srv.url + "/status")
    status = json.loads(body)
    assert code == 200 and status["scrapes"] == 1
    assert "0" in status["executors"] and "providers" in status
    code, _, body = _get(srv.url + "/healthz")
    assert code == 200 and json.loads(body)["healthy"] is True
    code, _, body = _get(srv.url + "/journal")
    assert code == 200 and json.loads(body)["events"][0]["kind"] == "restart"
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.url + "/nope")
    assert e.value.code == 404


def test_usage_route_in_both_formats(plane):
    from tensorflowonspark_tpu_torch.telemetry import ledger

    _p, srv = plane
    ledger.get_ledger().record("usage-route-req", tenant="route-t",
                               tokens_in=3, tokens_out=9, latency_sec=0.01)
    code, ctype, body = _get(srv.url + "/usage")
    assert code == 200 and ctype == texpo.OPENMETRICS_CONTENT_TYPE
    fams = texpo.parse_openmetrics(body)
    samples = {labels["tenant"]: v
               for _n, labels, v in fams["usage_tokens_out"]["samples"]}
    assert samples["route-t"] == 9.0
    code, _, body = _get(srv.url + "/usage?format=json")
    assert code == 200
    assert json.loads(body)["tenants"]["route-t"]["tokens_out"] == 9


def test_healthz_turns_503_on_a_dead_executors_silence():
    server = reservation.Server(1, heartbeat_interval=0.1)
    addr = server.start()
    plane = thealth.HealthPlane.local(interval=60,
                                      liveness_fn=server.liveness.health)
    srv = plane.serve(port=0)
    try:
        client = reservation.Client(addr)
        client.heartbeat(0, compute_alive=True, host="n0")
        code, _, body = _get(srv.url + "/healthz")
        assert code == 200 and json.loads(body)["healthy"] is True
        time.sleep(0.5)  # past 3 missed 0.1 s intervals
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/healthz")
        assert e.value.code == 503
        hz = json.loads(e.value.read().decode("utf-8"))
        assert hz["healthy"] is False
        assert any("executor 0" in r for r in hz["reasons"])
        assert "no heartbeat" in hz["liveness"]["dead"]["0"]
        client.heartbeat(0, compute_alive=False, host="n0")
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/healthz")
        assert "compute process dead" in json.loads(
            e.value.read().decode("utf-8"))["liveness"]["dead"]["0"]
        client.heartbeat(0, compute_alive=True, host="n0")  # recovered
        code, _, _body = _get(srv.url + "/healthz")
        assert code == 200
        client.close()
    finally:
        plane.stop()
        server.stop()


def test_plane_over_a_bare_reservation_server():
    server = reservation.Server(1)
    addr = server.start()
    try:
        reg = treg.MetricsRegistry(enabled=True)
        reg.counter("worker.rows").inc(11)
        client = reservation.Client(addr)
        client.heartbeat(0, metrics=reg.snapshot(), host="n0")
        client.close()
        plane = thealth.HealthPlane.for_reservation_server(server,
                                                           interval=60)
        plane.scrape_once()
        srv = plane.serve(port=0)
        try:
            _code, _, body = _get(srv.url + "/metrics")
            fams = texpo.parse_openmetrics(body)
            assert fams["worker_rows"]["samples"] == [
                ("worker_rows_total", {}, 11.0)]
        finally:
            plane.stop()
    finally:
        server.stop()


def test_page_severity_alert_turns_healthz_red():
    reg = treg.MetricsRegistry(enabled=True)
    reg.histogram("serving.request_latency_sec").observe(5.0)
    plane = thealth.HealthPlane.local(
        registry=reg, interval=60,
        slo=[{"name": "latency-page", "metric": "serving.request_latency_sec",
              "stat": "p99", "op": "<", "threshold": 0.001, "window": 300,
              "severity": "page"}])
    plane.scrape_once()
    hz = plane.healthz()
    assert hz["healthy"] is False
    assert any("latency-page" in r for r in hz["reasons"])


def test_fleet_merge_text_through_both_aggregates():
    # both packages' merges of the same snapshots give the same text
    snaps = [_sample(treg), _sample(treg, 3)]
    got = texpo.to_openmetrics(taggregate.merge_snapshots(snaps))
    want = jexpo.to_openmetrics(jaggregate.merge_snapshots(
        json.loads(json.dumps(snaps))))
    assert got == want
    # the JAX registry's own snapshot reads the same way in the port
    jsnap = _sample(jreg)
    assert texpo.parse_openmetrics(texpo.to_openmetrics(jsnap)) \
        == jexpo.parse_openmetrics(jexpo.to_openmetrics(jsnap))
