"""Rolling deploys over the port's fleet (``fleet/deploy.py``) against the
JAX package's, on the CPU: zero requests dropped across a rollout, the
canary's halt leaving every sibling on the old generation, the install
refusal, a corrupted published step halted by its validation and
quarantined, the phase timeout on the injected clock, the ``applied``
gate on an idle fleet, and one deploy at a time.

The state machine's tests drive the fake engines of ``torch_fleet_fakes``
through both packages' routers and compare the deploys' statuses; the
real-model ones run the TINY transformer in f32 (greedy, tokens compared
exactly).
"""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_fleet_fakes as ff  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu.fleet import deploy as jdeploy  # noqa: E402
from tensorflowonspark_tpu.fleet import router as jrouter  # noqa: E402
from tensorflowonspark_tpu_torch import checkpoint, hot_swap  # noqa: E402
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch.fleet import deploy, router  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import journal  # noqa: E402
from tensorflowonspark_tpu_torch.testing import chaos  # noqa: E402

#: the status fields that do not depend on timing.  The status's
#: ``generations`` is not one of them: the deploy snapshots it from the
#: replicas' stats when it halts or finishes, while each replica's engine
#: thread sets its ``weight_generation`` on its own schedule (a canary
#: rollback counts the rollback before it quarantines the step and sets
#: the generation), so the snapshot may read the old or the new value in
#: either package.  :func:`_settled` reads the generations once the fleet
#: is closed instead.
_STATUS = ("state", "replicas_done", "halted", "gate", "target_step")


def _status(dep):
    st = {k: dep.status[k] for k in _STATUS}
    if st["halted"]:
        st["halted"] = {k: st["halted"][k] for k in ("replica", "kind")}
    return st


def _settled(rt):
    """Every replica engine's ``weight_generation`` after ``rt.close()``
    (its engine thread has exited, so the value is final)."""
    return [int(r.engine.stats["weight_generation"]) for r in rt.replicas]


def _deploy_during(rt, rows, at=4, **deploy_kw):
    dep, out = None, []
    try:
        for i, r in enumerate(rt.serve(rows)):
            out.append(r)
            if i == at and dep is None:
                dep = rt.start_rolling_deploy(**deploy_kw)
    finally:
        rt.close()
    return out, dep


def _paced(n, sec=0.01):
    for r in ff.prompts([4] * n):
        time.sleep(sec)
        yield dict(r)


def test_rolling_deploy_over_every_replica_drops_nothing_like_jax():
    """Paced traffic spans the three drain, swap and commit rounds: every
    request served, each replica swapped and committed once, the same
    status in both packages."""
    res = []
    for pkg in (router, jrouter):
        rt = pkg.FleetRouter(
            None, ff.MAPPING, replicas=3, num_slots=2,
            predict_factory=lambda: ff.FakePredict(chunk=4, max_new=8,
                                                   delay=0.01),
            engine_opts={"rollback_window": 1}, poll_sec=0.01)
        out, dep = _deploy_during(rt, _paced(120), params="v1", step=7,
                                  phase_timeout=30.0)
        assert len(out) == 120 and all("error" not in r for r in out)
        assert rt.stats["swaps"] == rt.stats["swap_commits"] == 3
        assert all(r.engine.decoder.params == "v1" for r in rt.replicas)
        # the commit gate waits for clean completions after each install,
        # so the snapshot at the end of the rollout is settled
        assert all(g >= 1 for g in dep.status["generations"].values())
        res.append(dict(_status(dep), settled=_settled(rt)))
    assert res[0] == res[1]
    assert res[0]["state"] == "done"
    assert sorted(res[0]["replicas_done"]) == [0, 1, 2]
    assert res[0]["settled"] == [1, 1, 1]
    assert journal.get_journal().events(kind="deploy_done")


def test_canary_burn_halts_the_fleet_on_the_old_generation():
    """The canary's post-install check fails ("burn" weights): its engine
    rolls itself back, the rollout halts, and replicas 1 and 2 never see
    a swap, in both packages."""
    j0 = len(journal.get_journal().events(kind="deploy_halted"))
    res = []
    for pkg in (router, jrouter):
        rt = ff.fake_router(pkg, n=3, engine_opts={"rollback_window": 1})
        out, dep = _deploy_during(rt, [dict(r) for r in ff.prompts([4] * 30)],
                                  params="burn", step=9)
        assert len(out) == 30 and all("error" not in r for r in out)
        assert rt.replicas[0].engine.decoder.params == "v0"
        assert [r.stats["swaps"] for r in rt.replicas] == [0, 0, 0]
        res.append(dict(_status(dep), settled=_settled(rt)))
    assert res[0] == res[1]
    assert res[0]["state"] == "halted" and res[0]["replicas_done"] == []
    assert res[0]["halted"] == {"replica": 0, "kind": "canary_failed"}
    # the canary installed and restored (the fake decoder counts each),
    # and its siblings never swapped
    assert res[0]["settled"] == [2, 0, 0]
    ev = journal.get_journal().events(kind="deploy_halted")
    assert len(ev) > j0 and ev[-1].severity == "page"
    assert ev[-1].attrs["canary"] is True


def test_install_refusal_halts_like_jax():
    res = []
    for pkg in (router, jrouter):
        rt = ff.fake_router(pkg, n=2, engine_opts={"rollback_window": 1})
        out, dep = _deploy_during(rt, [dict(r) for r in ff.prompts([4] * 20)],
                                  params="refuse", step=3, refuse_grace=0.2,
                                  phase_timeout=20.0)
        assert len(out) == 20 and all("error" not in r for r in out)
        assert rt.replicas[1].stats["swaps"] == 0
        res.append(dict(_status(dep), settled=_settled(rt)))
    assert res[0] == res[1]
    assert res[0]["halted"] == {"replica": 0, "kind": "install_refused"}
    assert res[0]["settled"] == [0, 0]
    with pytest.raises(deploy.DeployHalted, match="install_refused"):
        dep_port = deploy.RollingDeploy(params="x")
        dep_port.status.update(state="halted",
                               halted={"kind": "install_refused"})
        dep_port.raise_if_halted()


class _Clock(object):
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_phase_timeout_halts_on_the_injected_clock():
    """A commit gate that no traffic can close: the deploy's clock runs a
    second a step, so the gate phase outlives ``phase_timeout`` and the
    rollout halts with ``timeout``, in both packages alike."""
    res = []
    for pkg in (router, jrouter):
        rt = ff.fake_router(pkg, n=2, engine_opts={"rollback_window": 50})
        out, dep = _deploy_during(rt, [dict(r) for r in ff.prompts([4] * 8)],
                                  at=1, params="v1", step=2,
                                  phase_timeout=30.0, clock=_Clock())
        assert len(out) == 8
        res.append(dict(_status(dep), settled=_settled(rt)))
    assert res[0] == res[1]
    assert res[0]["halted"] == {"replica": 0, "kind": "timeout"}
    assert res[0]["settled"] == [1, 0]


def test_applied_gate_finishes_against_an_idle_fleet():
    """``gate="applied"`` deploys an idle fleet: the deploy armed at the
    end of a stream finishes before the stream's generator returns."""
    res = []
    for pkg in (router, jrouter):
        rt = ff.fake_router(pkg, n=3)
        rows = [dict(r) for r in ff.prompts([4] * 6)]
        out, dep = _deploy_during(rt, rows, at=5, params="v2", step=4,
                                  gate="applied")
        assert len(out) == 6 and dep.finished
        assert [r.engine.decoder.params for r in rt.replicas] == ["v2"] * 3
        assert rt.health_status()["deploy"]["state"] == "done"
        res.append(dict(_status(dep), settled=_settled(rt)))
    assert res[0] == res[1] and res[0]["replicas_done"] == [0, 1, 2]
    assert res[0]["settled"] == [1, 1, 1]


def test_exactly_one_deploy_and_one_weight_source():
    for pkg, dmod in ((router, deploy), (jrouter, jdeploy)):
        rt = ff.fake_router(pkg, n=2)
        try:
            rt.start_rolling_deploy(params="v1")
            assert rt.deploy_active()
            with pytest.raises(RuntimeError, match="already in progress"):
                rt.start_rolling_deploy(params="v2")
        finally:
            rt.close()
        with pytest.raises(ValueError, match="exactly one"):
            dmod.RollingDeploy()
        with pytest.raises(ValueError, match="exactly one"):
            dmod.RollingDeploy(params="x", step_dir="/tmp/x")
        with pytest.raises(ValueError, match="gate"):
            dmod.RollingDeploy(params="x", gate="soon")


# ----------------------------------------------------------------------
# the real model
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree():
    return ff.jax_tree()


@pytest.fixture(scope="module")
def port3(tree):
    return ff.trio(ff.port_predict(tree))


def test_real_rolling_deploy_drops_nothing_and_serves_the_new_weights(
        tree, port3):
    """Three replicas move from the seed weights to weights x 1.01 under
    live traffic (the commit gate): nothing dropped, every replica on the
    new generation, and the requests admitted after the rollout ended
    carry one engine's tokens on the new weights (the port's and the JAX
    package's engines alike)."""
    new = jax.tree.map(lambda a: np.asarray(a) * 1.01, tree)
    rt = ff.real_router(router, port3, engine_opts={"rollback_window": 1})
    base = ff.prompts([6, 9, 5, 8] * 4, vocab=64, seed=41)
    hold = {}

    def traffic():
        for i in range(1500):
            d = hold.get("dep")
            if d is not None and d.finished:
                hold.setdefault("after", i)
                if i >= hold["after"] + 6:
                    return
            time.sleep(0.02)
            yield dict(base[i % len(base)])

    out = []
    try:
        for i, r in enumerate(rt.serve(traffic())):
            out.append(r)
            if i == 3 and "dep" not in hold:
                hold["dep"] = rt.start_rolling_deploy(
                    params=new, step=11, phase_timeout=60.0)
    finally:
        rt.close()
    dep = hold["dep"]
    assert all("error" not in r for r in out)
    assert dep.status["state"] == "done", dep.status
    assert sorted(dep.status["replicas_done"]) == [0, 1, 2]
    assert rt.stats["swaps"] == 3
    after = list(range(hold["after"], len(out)))
    assert len(after) == 6
    rows = [base[i % len(base)] for i in after]
    want = ff.tokens(ff.single(serving, ff.port_predict(new), rows))
    assert [ff.tokens(out)[i] for i in after] == want == ff.tokens(
        ff.single(jserving, ff.jax_predict(new), rows))


def test_corrupt_checkpoint_halts_at_the_canary_and_is_quarantined(
        tree, port3, tmp_path):
    """A published step with a mis-shaped leaf (``corrupt_checkpoint``)
    fails the canary replica's validation: the rollout halts with
    ``shape_mismatch``, every replica stays on the old generation, the
    step is quarantined and nothing is dropped."""
    step_dir = checkpoint.publish_for_serving(str(tmp_path / "pub"), 5,
                                              tree)
    chaos.corrupt_checkpoint(step_dir, "shape_mismatch")
    rt = ff.real_router(router, port3)
    gens = [r.stats.get("weight_generation", 0) for r in rt.replicas]
    out, dep = _deploy_during(
        rt, [dict(r) for r in ff.prompts([6, 9, 5, 8] * 8, vocab=64,
                                         seed=43)],
        at=2, step_dir=step_dir)
    assert len(out) == 32 and all("error" not in r for r in out)
    assert dep.status["state"] == "halted"
    assert dep.status["halted"]["kind"] == "shape_mismatch"
    assert dep.status["halted"]["replica"] == 0
    assert dep.status["replicas_done"] == []
    assert [r.stats["weight_generation"] for r in rt.replicas] == gens
    assert [r.stats["swaps"] for r in rt.replicas] == [0, 0, 0]
    assert hot_swap.read_quarantine(step_dir)["kind"] == "shape_mismatch"
