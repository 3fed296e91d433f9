"""The port's ``forensics`` (``explain``, the incident report) against the
JAX package's, on the CPU: flight-recorder bundles, journal JSONL files
and ``TPUCluster.journal()`` exports written by either package are read
by both, and the report dicts, their rendering and the merged Chrome
trace are equal.  Covers the fault-kind map (the prefill faults'
included, from a real disaggregated engine run), clock offsets, the p99
exemplars and the request pin, and the remediation and config-change
sections (journal events written directly: neither plane is ported).
"""

import json
import time

import numpy as np
import pytest

from tensorflowonspark_tpu import forensics as jfx
from tensorflowonspark_tpu import telemetry as jtel
from tensorflowonspark_tpu.telemetry import blackbox as jbb
from tensorflowonspark_tpu.telemetry import registry as jreg
from tensorflowonspark_tpu_torch import forensics as tfx
from tensorflowonspark_tpu_torch import telemetry as ttel
from tensorflowonspark_tpu_torch.telemetry import blackbox as tbb
from tensorflowonspark_tpu_torch.telemetry import journal as tjournal

#: (blackbox module, telemetry package) of each writer
WRITERS = {"port": (tbb, ttel), "jax": (jbb, jtel)}


def _recorder(writer, dump_dir, executor=None):
    mod, tel = WRITERS[writer]
    j = tel.EventJournal(executor=executor, enabled=True)
    tr = tel.Tracer(enabled=True, journal=j)
    rec = mod.FlightRecorder(journal=j, tracer=tr, dump_dir=str(dump_dir),
                             min_interval=0.0).start()
    return j, tr, rec


def _explain_both(paths, **kw):
    """Both packages' report on the same files; they must be equal, as
    must their renderings.  Returns the port's."""
    got = tfx.explain(paths, **kw)
    want = jfx.explain(paths, **kw)
    assert json.loads(json.dumps(got, default=str)) == \
        json.loads(json.dumps(want, default=str))
    assert tfx.render_report(got) == jfx.render_report(want)
    return got


def _event(tel, kind, **kw):
    return tel.journal.Event(kind, **kw).to_dict()


def test_vocabulary_equals_the_reference():
    assert tfx.FAULT_KINDS == jfx.FAULT_KINDS
    assert tfx.FAULT_MAP == jfx.FAULT_MAP
    assert tfx.REMEDIATION_KINDS == jfx.REMEDIATION_KINDS
    assert tfx.PLANNER_KINDS == jfx.PLANNER_KINDS
    assert tfx.LATENCY_METRIC == jfx.LATENCY_METRIC
    assert tfx.FAULT_MAP["prefill_worker_dead"] == "kill_prefill"
    assert tfx.FAULT_MAP["prefill_watchdog_fire"] == "wedge_prefill"
    assert tfx.FAULT_MAP["lease_reaped"] == "leak_lease"


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_explain_names_fault_and_executor_from_dump(tmp_path, writer):
    _, tr, rec = _recorder(writer, tmp_path, executor=4)
    with tr.span("step", trace="t9"):
        with tr.span("dispatch", trace="t9"):
            time.sleep(0.02)
    tr.mark("leader_failover", trace="hier", severity="page",
            dead_member=4)
    rec.stop()
    report = _explain_both([str(tmp_path)])
    assert report["incident"]["fault_kind"] == "kill_leader"
    assert report["incident"]["trigger"] == "leader_failover"
    assert report["incident"]["executor"] == 4
    assert report["critical_path"]["dominant_phase"] == "dispatch"
    text = tfx.render_report(report)
    assert "kill_leader" in text and "executor 4" in text


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_explain_reads_cluster_journal_export(tmp_path, writer):
    tel = WRITERS[writer][1]
    export = {
        "events": [
            _event(tel, "executor_restart", ts=50.0, seq=1, pid=1,
                   executor=2, severity="warn"),
            _event(tel, "executor_dead", ts=60.0, seq=2, pid=1, executor=2,
                   severity="page", attrs={"reason": "no heartbeat"}),
            _event(tel, "heartbeat", ts=55.0, seq=1, pid=2, executor=3),
        ],
        "clocks": {"2": {"offset": -1.5, "rtt": 0.01},
                   "3": {"offset": 0.25, "rtt": 0.02}},
    }
    p = tmp_path / "journal_export.json"
    p.write_text(json.dumps(export))
    report = _explain_both([str(p)])
    assert report["timeline"][0]["t"] == pytest.approx(48.5)
    assert report["incident"]["fault_kind"] == "kill"
    assert report["incident"]["executor"] == 2
    assert report["executors"] == [2, 3]
    # an explicit offsets map overrides the export's
    report = _explain_both([str(p)], offsets={2: 0.0})
    assert report["timeline"][0]["t"] == pytest.approx(50.0)


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_jsonl_journal_and_bundle_dedupe(tmp_path, writer):
    """A journal file and a bundle of the same process carry the same
    events: the timeline keeps one of each."""
    j, tr, rec = _recorder(writer, tmp_path / "dumps", executor=1)
    tr.mark("swap_apply", trace="swap", step=3)
    tr.mark("swap_rollback", trace="swap", severity="page", step=3)
    rec.stop()
    j.save(str(tmp_path / "dumps" / "journal.jsonl"))
    report = _explain_both([str(tmp_path / "dumps")])
    assert report["events_by_kind"] == {"swap_apply": 1, "swap_rollback": 1}
    assert report["incident"]["fault_kind"] == "corrupt_checkpoint"
    assert len(report["sources"]) == 2


def _exemplar_bundle(tmp_path, reg, bb):
    h = reg.Histogram("serving.request_latency_sec")
    for _ in range(20):
        h.observe(0.01)
    h.observe(0.8, exemplar="flt1-req3")
    spans = [
        {"name": "prefill", "trace": "flt1-req3", "id": 1, "t0": 0.0,
         "dur": 0.1, "tid": 1},
        {"name": "decode_chunk", "trace": "flt1-req3", "id": 2,
         "parent": 1, "t0": 0.02, "dur": 0.7, "tid": 1},
        {"name": "emit", "trace": "other", "id": 3, "t0": 0.0, "dur": 0.9,
         "tid": 1},
    ]
    bundle = {
        "format": bb.BUNDLE_FORMAT, "executor": 0, "pid": 1234,
        "events": [{"ts": 100.0, "seq": 1, "executor": 0, "pid": 1234,
                    "severity": "page", "kind": "watchdog_fire",
                    "trace": "serve", "attrs": {}}],
        "spans": spans, "clock": {"epoch_wall": 100.0},
        "metrics": {"histograms": {
            "serving.request_latency_sec": h.snapshot()}},
    }
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(bundle))
    return str(path)


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_p99_exemplar_request_pin_and_merged_trace(tmp_path, writer):
    from tensorflowonspark_tpu_torch.telemetry import registry as treg

    reg = treg if writer == "port" else jreg
    path = _exemplar_bundle(tmp_path, reg, WRITERS[writer][0])
    report = _explain_both([path])
    assert report["p99_exemplars"][0]["ref"] == "flt1-req3"
    # the exemplar's trace wins over the busier "other"
    assert report["critical_path"]["trace"] == "flt1-req3"
    assert "flt1-req3" in tfx.render_report(report)
    pinned = _explain_both([path], request="other")
    assert pinned["critical_path"]["trace"] == "other"
    for request in (None, "flt1-req3"):
        got = tfx.merged_chrome([path], request=request)
        assert got == jfx.merged_chrome([path], request=request)
    names = {e["name"] for e in tfx.merged_chrome(
        [path], request="flt1-req3")["traceEvents"]}
    assert "emit" not in names and "decode_chunk" in names


def test_critical_path_and_timeline_units_equal_the_reference():
    spans = [
        {"name": "root", "id": 1, "t0": 0.0, "dur": 1.0},
        {"name": "a", "id": 2, "parent": 1, "t0": 0.0, "dur": 0.3},
        {"name": "b", "id": 3, "parent": 1, "t0": 0.2, "dur": 0.7},
        {"name": "c", "id": 4, "parent": 3, "t0": 0.3, "dur": 0.2},
        {"name": "mark", "id": 5, "parent": 3, "t0": 0.6, "dur": 0.0},
    ]
    assert tfx.critical_path(spans) == jfx.critical_path(spans)
    assert tfx.critical_path([]) == jfx.critical_path([])
    sources = [
        {"path": "a", "executor": 1, "offset": -1.0, "spans": [],
         "events": [{"ts": 100.0, "seq": 1, "pid": 7, "executor": 1,
                     "kind": "watchdog_fire", "severity": "page"},
                    {"ts": 100.0, "seq": 1, "pid": 7, "executor": 1,
                     "kind": "watchdog_fire", "severity": "page"},
                    {"kind": "no_ts"}]},
        {"path": "b", "executor": 0, "offset": 0.0, "spans": [],
         "events": [{"ts": 99.5, "executor": 0, "kind": "restart",
                     "severity": "warn"}]},
    ]
    for offsets in (None, {1: 0.0}, {"1": 2.0}):
        assert tfx.build_timeline(sources, offsets) == \
            jfx.build_timeline(sources, offsets)


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_remediation_decisions_section(tmp_path, writer):
    tel = WRITERS[writer][1]
    export = {"events": [
        _event(tel, "replica_dead", ts=50.0, seq=1, pid=1, executor=0,
               severity="page", attrs={"replica_id": 1}),
        _event(tel, "remediation_decision", ts=51.0, seq=2, pid=1,
               executor=0, severity="warn", attrs={
                   "decision": 1, "engine": "remediation1",
                   "action": "spawn_replica", "policy": "fault-response",
                   "target": {},
                   "evidence": {"event": {"kind": "replica_dead",
                                          "seq": 1}},
                   "reason": "journal fault 'replica_dead'",
                   "executed": True, "dry_run": False}),
        _event(tel, "remediation_decision", ts=52.0, seq=3, pid=1,
               executor=0, severity="info", attrs={
                   "action": "drain", "policy": "p", "target": "r2",
                   "executed": False, "dry_run": True}),
        _event(tel, "remediation_budget_exhausted", ts=53.0, seq=4, pid=1,
               executor=0, severity="page", attrs={"budget": 3}),
    ]}
    p = tmp_path / "journal_export.json"
    p.write_text(json.dumps(export))
    report = _explain_both([str(p)])
    assert report["incident"]["fault_kind"] == "kill_replica"
    assert [e["kind"] for e in report["remediation"]] == [
        "remediation_decision", "remediation_decision",
        "remediation_budget_exhausted"]
    text = tfx.render_report(report)
    for needle in ("why did the fleet do that?", "spawn_replica",
                   "fault-response", "[dry-run]", "on r2"):
        assert needle in text


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_config_changes_section(tmp_path, writer):
    tel = WRITERS[writer][1]
    export = {"events": [
        _event(tel, "planner_decision", ts=10.0, seq=1, pid=1, executor=0,
               attrs={"workload": "serving",
                      "chosen": {"chunk_size": 16, "kv_layout": "paged"},
                      "gap_pct": 3.2, "profile_source": "probe"}),
        _event(tel, "replan", ts=20.0, seq=2, pid=1, executor=0,
               attrs={"trigger": "dcn_rtt", "knob": "push_every",
                      "old": 8, "new": 25, "applied": True,
                      "evidence": {"measured_rtt_ms": 20.0,
                                   "baseline_rtt_ms": 1.0}}),
        _event(tel, "engine_retune", ts=21.0, seq=3, pid=1, executor=0,
               attrs={"knobs": {"queue_depth": {"old": 4, "new": 8}}}),
    ]}
    p = tmp_path / "journal_export.json"
    p.write_text(json.dumps(export))
    report = _explain_both([str(p)])
    assert [e["kind"] for e in report["config_changes"]] == [
        "planner_decision", "replan", "engine_retune"]
    assert report["incident"] is None
    text = tfx.render_report(report)
    for needle in ("config changes", "planned serving",
                   "replan [dcn_rtt] push_every: 8 -> 25",
                   "measured_rtt_ms", "no fault-class events"):
        assert needle in text


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_cli_writes_report_trace_and_json(tmp_path, writer, capsys):
    _, tr, rec = _recorder(writer, tmp_path / "dumps", executor=0)
    with tr.span("step", trace="t1"):
        pass
    tr.mark("watchdog_fire", trace="serve", severity="page")
    rec.stop()
    outs = {}
    for name, mod in (("port", tfx), ("jax", jfx)):
        out_txt = tmp_path / (name + ".txt")
        out_trace = tmp_path / (name + ".json")
        assert mod.main(["explain", str(tmp_path / "dumps"), "--out",
                         str(out_txt), "--trace", str(out_trace)]) == 0
        assert "wedge_dispatch" in out_txt.read_text()
        assert any(e["name"] == "step" for e in json.loads(
            out_trace.read_text())["traceEvents"])
        assert mod.main(["explain", str(tmp_path / "dumps"), "--json"]) == 0
        outs[name] = (out_txt.read_text(), json.loads(out_trace.read_text()),
                      capsys.readouterr().out)
    assert outs["port"][:2] == outs["jax"][:2]
    assert outs["port"][2].replace(str(tmp_path / "port"), "X") == \
        outs["jax"][2].replace(str(tmp_path / "jax"), "X")


def test_no_sources_raises_like_the_reference(tmp_path):
    for mod in (tfx, jfx):
        with pytest.raises(FileNotFoundError):
            mod.explain([str(tmp_path)])


def test_explain_names_a_contained_prefill_kill(tmp_path, monkeypatch):
    """A disaggregated engine of the port under ``kill_prefill``: the
    journal's export and the flight recorder's bundle name the fault
    (``kill_prefill``, triggered by ``prefill_worker_dead``) in both
    packages' reports."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import transformer as jtr
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.models import transformer as ttr
    from tensorflowonspark_tpu_torch.testing import chaos

    cfg = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
               head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=128,
               dtype="float32")
    model = jtr.Transformer(jtr.TransformerConfig(**cfg))
    tree = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    predict = ttr.serving_builder(tree, dict(
        cfg, mode="generate", max_new_tokens=4, pad_multiple=16,
        chunk_size=2, kv_layout="paged", kv_page_tokens=4,
        disaggregate=True, device="cpu"))
    monkeypatch.setenv(chaos.TFOS_CHAOS_PLAN, chaos.ChaosPlan().kill_prefill(
        at_admit=1).save(str(tmp_path / "plan.json")))
    dumps = tmp_path / "dumps"
    journal = tjournal.get_journal()
    journal.clear()
    rec = tbb.FlightRecorder(journal=journal, tracer=ttel.get_tracer(),
                             dump_dir=str(dumps), min_interval=0.0).start()
    try:
        rng = np.random.RandomState(2)
        rows = [{"prompt": rng.randint(1, 64, (n,)).astype(np.int32)}
                for n in (9, 14, 6)]
        stats = {}
        out = list(serving.predict_rows(
            predict, rows, {"prompt": "tokens"}, batch_size=2,
            schedule="continuous", stats=stats))
    finally:
        rec.stop()
    assert len(out) == 3 and stats["prefill_worker_deaths"] == 1
    export = tmp_path / "journal.jsonl"
    journal.save(str(export))
    report = _explain_both([str(export), str(dumps)])
    assert report["incident"]["fault_kind"] == "kill_prefill"
    assert report["incident"]["trigger"] == "prefill_worker_dead"
    assert report["incident"]["severity"] == "page"
    assert any(s.endswith(".json") for s in report["sources"])
    assert "kill_prefill" in tfx.render_report(report)
