"""The port's event journal (``telemetry/journal.py``) against the JAX
package's, on the CPU: the severity-split rings, the size-rotated JSONL
files, the mark bridge from the tracer, and files that each package
writes read back by the other's ``load_journal``.
"""

import json

import pytest

from tensorflowonspark_tpu import telemetry as jtel
from tensorflowonspark_tpu.telemetry import journal as jjournal
from tensorflowonspark_tpu_torch import telemetry as ttel
from tensorflowonspark_tpu_torch.telemetry import journal as tjournal
from tensorflowonspark_tpu_torch.telemetry import registry as treg

PKGS = [(tjournal, ttel), (jjournal, jtel)]


class _Clock(object):
    def __init__(self):
        self.t = 1.7e9

    def __call__(self):
        self.t += 0.5
        return self.t


def _flood(mod, tel, n_info=50, max_events=8, **kw):
    """``n_info`` routine events around three faults, on a journal with
    its own registry and clock."""
    reg = tel.MetricsRegistry(enabled=True)
    j = mod.EventJournal(max_events=max_events, registry=reg,
                         clock=_Clock(), enabled=True, executor=3, **kw)
    j.emit("watchdog_fire", severity="page", trace="serve", chunk=2)
    for i in range(n_info):
        j.emit("emit", trace="req%d" % i)
        if i == n_info // 2:
            j.emit("shed", severity="warn", trace="req%d" % i,
                   attrs={"queue_depth": 4}, request_index=i)
    j.emit("swap_rollback", severity="bogus", step=7)
    return j, reg


def _dicts(events):
    return [e.to_dict() for e in events]


def test_severity_rings_like_jax():
    (tj, treg_), (jj, jreg_) = (_flood(m, t) for m, t in PKGS)
    assert _dicts(tj.events()) == _dicts(jj.events())
    faults = [e.kind for e in tj.events() if e.severity != "info"]
    # a flood of routine events evicts none of the faults
    assert faults == ["watchdog_fire", "shed", "swap_rollback"]
    assert tj.events(kind="swap_rollback")[0].severity == "warn"
    assert tj.dropped_events == jj.dropped_events == 42
    assert treg_.snapshot()["counters"] == jreg_.snapshot()["counters"] \
        == {"journal.events": 53, "journal.dropped_events": 42}
    for q in ({"kind": "emit"}, {"severity": "page"}, {"trace": "req25"},
              {"limit": 4}):
        assert _dicts(tj.events(**q)) == _dicts(jj.events(**q))
    assert len(tj.events(kind="emit")) == jj.count("emit") == 8


def test_disabled_journal_stores_nothing():
    j = tjournal.EventJournal(enabled=False)
    assert j.emit("shed", severity="warn") is None
    assert j.events() == []


def test_listener_failure_never_propagates():
    j = tjournal.EventJournal(enabled=True,
                              registry=treg.MetricsRegistry(enabled=True))
    seen = []

    def boom(ev):
        raise RuntimeError("listener down")

    j.add_listener(boom)
    j.add_listener(seen.append)
    j.add_listener(seen.append)  # registered once
    ev = j.emit("watchdog_fire", severity="page")
    assert seen == [ev]
    j.remove_listener(seen.append)
    j.emit("emit")
    assert seen == [ev]


@pytest.mark.parametrize("max_bytes,max_files", [(400, 3), (250, 2)])
def test_rotation_like_jax(tmp_path, max_bytes, max_files):
    files = []
    for name, (mod, tel) in zip(("port", "jax"), PKGS):
        path = tmp_path / name / "journal.jsonl"
        path.parent.mkdir()
        _flood(mod, tel, n_info=30, max_events=64, path=str(path),
               max_bytes=max_bytes, max_files=max_files)
        files.append(sorted(p.name for p in path.parent.iterdir()))
        # every file within the bound, the oldest rotation dropped
        for p in path.parent.iterdir():
            assert p.stat().st_size <= max_bytes
        loaded = mod.load_journal(str(path))
        assert [e.kind for e in loaded][-1] == "swap_rollback"
        assert len(loaded) < 33
    assert files[0] == files[1]
    assert len(files[0]) == max_files + 1
    got, want = (_dicts(m.load_journal(str(tmp_path / n / "journal.jsonl")))
                 for n, (m, _) in zip(("port", "jax"), PKGS))
    for g, w in zip(got, want):
        g.pop("pid"), w.pop("pid")
    assert got == want


@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)])
def test_files_cross_read(tmp_path, writer, reader):
    wmod, wtel = PKGS[writer]
    rmod, _ = PKGS[reader]
    j, _ = _flood(wmod, wtel, n_info=5, max_events=64)
    saved = j.save(str(tmp_path / "saved.jsonl"))
    live = str(tmp_path / "live.jsonl")
    _flood(wmod, wtel, n_info=5, max_events=64, path=live)
    with open(live, "a") as f:
        f.write('{"torn": ')  # a killed process's last line
    for path in (saved, live):
        back = rmod.load_journal(path)
        assert _dicts(back) == _dicts(j.events())
        assert type(back[0]).__module__ == rmod.__name__


def test_event_round_trip_like_jax():
    d = {"ts": 1.5, "seq": 4, "kind": "shed", "severity": "warn",
         "pid": 11, "executor": 2, "trace": "req1", "attrs": {"a": 1}}
    assert (tjournal.Event.from_dict(d).to_dict()
            == jjournal.Event.from_dict(d).to_dict() == d)
    assert tjournal.Event.from_dict({}).to_dict()["kind"] == "?"
    assert json.loads(json.dumps(tjournal.Event("x").to_dict()))


def test_mark_bridge():
    """Every mark of an enabled tracer lands in its journal, severity and
    attributes included; a disabled tracer's marks land nowhere."""
    for mod, tel in PKGS:
        j = mod.EventJournal(enabled=True,
                             registry=tel.MetricsRegistry(enabled=True))
        tr = tel.Tracer(enabled=True, journal=j)
        tr.mark("watchdog_fire", trace="serve", severity="page",
                attrs={"inflight": 2}, chunk=5)
        tr.mark("emit", trace="req0")
        tel.Tracer(enabled=False, journal=j).mark("shed")
        evs = j.events()
        assert [(e.kind, e.severity, e.trace, e.attrs) for e in evs] == [
            ("watchdog_fire", "page", "serve", {"inflight": 2, "chunk": 5}),
            ("emit", "info", "req0", {})]
        assert tr.spans()[0]["severity"] == "page"


def test_global_journal_receives_global_marks():
    j = ttel.get_journal()
    assert j is tjournal.get_journal()
    n = len(j.events(kind="t_bridge_probe"))
    ttel.get_tracer().mark("t_bridge_probe", severity="warn", probe=1)
    assert len(j.events(kind="t_bridge_probe")) == n + 1
    assert j.events(kind="t_bridge_probe")[-1].attrs == {"probe": 1}
    assert tjournal.MAX_EVENTS == jjournal.MAX_EVENTS
    assert tjournal.SEVERITIES == jjournal.SEVERITIES
