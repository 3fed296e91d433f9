"""The port's flight recorder (``telemetry/blackbox.py``) against the JAX
package's, on the CPU: the trigger set, bundles that each package writes
read back by the other's ``load_dump``, and the disk bounds (the per-kind
``MIN_INTERVAL`` rate limit and the ``MAX_DUMPS`` cap).
"""

import json

import pytest

from tensorflowonspark_tpu import telemetry as jtel
from tensorflowonspark_tpu.telemetry import blackbox as jbb
from tensorflowonspark_tpu_torch import telemetry as ttel
from tensorflowonspark_tpu_torch.telemetry import blackbox as tbb

PKGS = [(tbb, ttel), (jbb, jtel)]


class _Clock(object):
    def __init__(self):
        self.t = 1.7e9

    def __call__(self):
        return self.t


def _recorder(mod, tel, dump_dir, clock=None, **kw):
    """A recorder over its own journal, tracer and registry."""
    reg = tel.MetricsRegistry(enabled=True)
    journal = tel.EventJournal(enabled=True, registry=reg, executor=1)
    tracer = tel.Tracer(enabled=True, journal=journal)
    rec = mod.FlightRecorder(journal=journal, tracer=tracer, registry=reg,
                             dump_dir=str(dump_dir), clock=clock, **kw)
    return rec.start(), tracer, reg


def test_triggers_and_format_equal_the_reference():
    assert tbb.DUMP_TRIGGERS == jbb.DUMP_TRIGGERS
    assert tbb.BUNDLE_FORMAT == jbb.BUNDLE_FORMAT == "tfos-blackbox-1"
    assert tbb.MIN_INTERVAL == jbb.MIN_INTERVAL
    assert tbb.MAX_DUMPS == jbb.MAX_DUMPS
    assert tbb.DUMP_DIR_ENV == jbb.DUMP_DIR_ENV == "TFOS_BLACKBOX_DIR"


@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)])
def test_bundles_cross_read(tmp_path, writer, reader):
    wmod, wtel = PKGS[writer]
    rmod, _ = PKGS[reader]
    rec, tracer, reg = _recorder(wmod, wtel, tmp_path)
    reg.counter("serving.chunks").inc(3)
    with tracer.span("decode_chunk", trace="req0", chunk=1):
        pass
    tracer.mark("emit", trace="req0")  # info: no dump
    assert rec.dumps == []
    tracer.mark("watchdog_fire", trace="serve", severity="page",
                inflight=2, chunk=4)
    assert len(rec.dumps) == 1
    data = rmod.load_dump(rec.dumps[0]["path"])
    assert data["reason"] == "watchdog_fire"
    assert data["trigger"]["kind"] == "watchdog_fire"
    assert data["trigger"]["attrs"] == {"inflight": 2, "chunk": 4}
    assert [e["kind"] for e in data["events"]] == ["emit", "watchdog_fire"]
    assert [s["name"] for s in data["spans"]] == [
        "decode_chunk", "emit", "watchdog_fire"]
    assert data["metrics_delta"]["counters"]["serving.chunks"] == 3
    assert data["clock"]["epoch_wall"] == tracer.epoch_wall
    assert data["executor"] == 1
    assert reg.counter("blackbox.dumps").value == 1


@pytest.mark.parametrize("mod,tel", PKGS, ids=["port", "jax"])
def test_min_interval_and_cap_bound_the_dumps(tmp_path, mod, tel):
    clock = _Clock()
    rec, tracer, reg = _recorder(mod, tel, tmp_path, clock=clock,
                                 max_dumps=3)
    fire = lambda: tracer.mark("watchdog_fire", severity="page")  # noqa
    fire()
    clock.t += mod.MIN_INTERVAL / 2
    fire()  # the same kind inside the interval: suppressed
    assert len(rec.dumps) == 1
    assert reg.counter("blackbox.dumps_suppressed").value == 1
    tracer.mark("swap_rollback", severity="page")  # another kind dumps
    clock.t += mod.MIN_INTERVAL
    fire()
    assert [d["reason"] for d in rec.dumps] == [
        "watchdog_fire", "swap_rollback", "watchdog_fire"]
    clock.t += 10 * mod.MIN_INTERVAL
    fire()  # past the cap
    assert len(rec.dumps) == 3
    assert reg.counter("blackbox.dumps_suppressed").value == 2
    assert len(list(tmp_path.iterdir())) == 3
    rec.stop()
    clock.t += 10 * mod.MIN_INTERVAL
    fire()
    assert reg.counter("blackbox.dumps_suppressed").value == 2


def test_page_severity_and_custom_triggers(tmp_path):
    rec, tracer, _ = _recorder(tbb, ttel, tmp_path, triggers={"shed"},
                               min_interval=0)
    tracer.mark("watchdog_fire", severity="warn")  # not a trigger here
    tracer.mark("shed", severity="warn")
    tracer.mark("anything", severity="page")
    assert [d["reason"] for d in rec.dumps] == ["shed", "anything"]
    assert json.load(open(rec.dumps[0]["path"]))["format"] == \
        tbb.BUNDLE_FORMAT


def test_load_dump_rejects_other_files(tmp_path):
    path = tmp_path / "x.json"
    path.write_text(json.dumps({"format": "other"}))
    for mod, _ in PKGS:
        with pytest.raises(ValueError, match="tfos-blackbox-1"):
            mod.load_dump(str(path))


def test_install_is_idempotent_and_off_switch(monkeypatch):
    monkeypatch.setenv("TFOS_BLACKBOX", "0")
    assert tbb.install() is None
    monkeypatch.setenv("TFOS_BLACKBOX", "1")
    rec = tbb.install()
    assert rec is not None and tbb.install() is rec
    assert tbb.get_recorder() is rec
    assert ttel.get_recorder() is rec
