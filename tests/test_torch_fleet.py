"""The port's fleet (``tensorflowonspark_tpu_torch/fleet/``) against the JAX
package's on the CPU: the four dispatch policies' tokens and picks, fleet
admission, the load snapshots and ``/status``, replica faults
(``kill_replica`` re-dispatch, ``device_error`` quarantine,
``slow_replica`` routed around and re-admitted behind
``CleanRoundsSensor``), the usage ledger's re-dispatch count, the fleet's
catalog rows and the surface checks.

The real-model tests run the TINY transformer in f32 on the same Flax
tree in both packages (the JAX side's paged decoder through
``paged_impl="gather"``, the port's K1 wrapper through its plain
version); tokens are greedy and compared exactly.  The scheduler-logic
tests drive a deterministic fake decoder (``torch_fleet_fakes``) through
both packages' routers.  The straggler policy's decisions are driven with
the router's injected clock, never by wall-clock races.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch_fleet_fakes as ff  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu import serving_engine as jengine  # noqa: E402
from tensorflowonspark_tpu.fleet import replica as jreplica  # noqa: E402
from tensorflowonspark_tpu.fleet import router as jrouter  # noqa: E402
from tensorflowonspark_tpu.prefix_cache import (  # noqa: E402
    fingerprint as jfingerprint,
)
from tensorflowonspark_tpu.telemetry import catalog as jcatalog  # noqa: E402
from tensorflowonspark_tpu.telemetry import health as jhealth  # noqa: E402
from tensorflowonspark_tpu.telemetry import ledger as jledger  # noqa: E402
from tensorflowonspark_tpu.testing import chaos as jchaos  # noqa: E402
from tensorflowonspark_tpu_torch import forensics, serving  # noqa: E402
from tensorflowonspark_tpu_torch import serving_engine, telemetry  # noqa: E402
from tensorflowonspark_tpu_torch.fleet import replica  # noqa: E402
from tensorflowonspark_tpu_torch.fleet import router  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import catalog  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import health  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import journal  # noqa: E402
from tensorflowonspark_tpu_torch.telemetry import ledger  # noqa: E402
from tensorflowonspark_tpu_torch.testing import chaos  # noqa: E402

POLICIES = ("least_loaded", "prefix_affinity", "weighted_rr", "random")


@pytest.fixture(scope="module")
def tree():
    return ff.jax_tree()


@pytest.fixture(scope="module")
def port3(tree):
    """The port's predictor and two replicas of it, shared by the module's
    real-model fleets (each replica its own decoder and pool)."""
    return ff.trio(ff.port_predict(tree))


@pytest.fixture(scope="module")
def jax3(tree):
    return ff.trio(ff.jax_predict(tree))


@pytest.fixture
def plan_env(tmp_path):
    """Arm a chaos plan for both packages (one env var names it)."""
    def arm(plan):
        os.environ[chaos.TFOS_CHAOS_PLAN] = plan.save(
            str(tmp_path / "plan.json"))

    yield arm
    os.environ.pop(chaos.TFOS_CHAOS_PLAN, None)


def _rows(seed=21, lens=(5, 9, 14, 3, 8, 12, 7, 6, 11, 4)):
    return ff.prompts(list(lens), vocab=64, seed=seed)


# ----------------------------------------------------------------------
# the four policies: tokens and picks
# ----------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_tokens_equal_the_jax_fleet_and_engine(port3, jax3, policy):
    """Greedy f32, exact: the port's 3-replica fleet, the JAX fleet and
    one JAX engine give the same tokens in input order."""
    rows = _rows()
    want = ff.tokens(ff.single(jserving, jax3[0], rows))
    got, rt = ff.serve(ff.real_router(router, port3, dispatch=policy), rows)
    ref, jrt = ff.serve(ff.real_router(jrouter, jax3, dispatch=policy), rows)
    assert ff.tokens(got) == ff.tokens(ref) == want
    assert rt.stats["completed"] == len(rows) == jrt.stats["completed"]
    assert rt.stats["dispatch_policy"] == policy
    assert rt.stats["tokens_out"] == len(rows) * ff.GEN["max_new_tokens"]
    # every replica released its pages
    assert all(r.engine.decoder.page_pool.stats()["pool_pages_used"] == 0
               for r in rt.replicas)


class _Rep(object):
    def __init__(self, rid, state="live"):
        self.replica_id, self.state, self.alive = rid, state, True


class _Counter(object):
    def inc(self, n=1):
        pass


class _StubRouter(object):
    """The router attributes a policy reads, over a seeded load table."""

    def __init__(self, n, seed):
        import collections
        import threading

        rng = np.random.RandomState(seed)
        self.replicas = [_Rep(i) for i in range(n)]
        self.replicas[int(rng.randint(n))].state = "routed_around"
        self.assigned = {i: int(rng.randint(0, 6)) for i in range(n)}
        self.weights = {i: float(rng.choice([1.0, 2.0, 3.0]))
                        for i in range(n)}
        self.imbalance = 2
        self.stats = {"affinity_hits": 0, "affinity_spills": 0}
        self._m = collections.defaultdict(_Counter)
        self._rr_current = {}
        self._rng = np.random.RandomState(seed)
        self._pressure_lock = threading.Lock()
        self._spill_times = collections.deque()
        self._clock = lambda: 0.0

    def _assigned_count(self, rid):
        return self.assigned[rid]

    def _weight(self, rid):
        return self.weights[rid]


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_picks_equal_the_reference_on_seeded_loads(policy):
    """Pure functions of the load table: 200 requests over seeded tables
    (assigned counts, weights, a routed-around replica, candidate sets,
    prompts sharing heads) pick the same replica in both packages, and the
    affinity counters agree."""
    rng = np.random.RandomState(3)
    heads = [rng.randint(1, 64, (16,)) for _ in range(5)]
    for seed in range(4):
        stubs = [_StubRouter(5, seed), _StubRouter(5, seed)]
        picks = [[], []]
        for k in range(50):
            prompt = np.concatenate([heads[k % 5], rng.randint(1, 64, (3,))])
            live = [r.replica_id for r in stubs[0].replicas
                    if r.state == "live"]
            keep = [rid for rid in live if rng.rand() < 0.8] or live[:1]
            for i, (pkg, st) in enumerate(zip((router, jrouter), stubs)):
                fp = (router.fingerprint if pkg is router
                      else jfingerprint)(prompt)
                cands = [st.replicas[rid] for rid in keep]
                pick = pkg.DISPATCH_POLICIES[policy](
                    st, {"fingerprint": fp, "excluded": set()}, cands)
                picks[i].append(pick.replica_id)
                st.assigned[pick.replica_id] += 1
                if k % 7 == 6:  # a completion somewhere
                    rid = max(st.assigned, key=st.assigned.get)
                    st.assigned[rid] -= 1
        assert picks[0] == picks[1], (policy, seed)
        assert stubs[0].stats == stubs[1].stats


def test_custom_policy_callable_and_unknown_names():
    seen = []

    def first(rt, req, candidates):
        seen.append(len(candidates))
        return candidates[0]

    out, rt = ff.serve(ff.fake_router(router, n=2, dispatch=first),
                       ff.prompts([4, 5, 6]))
    assert len(out) == 3 and seen and rt.dispatch_name == "first"
    for pkg in (router, jrouter):
        with pytest.raises(ValueError, match="least_loaded"):
            ff.fake_router(pkg, dispatch="fastest_wins")
        with pytest.raises(ValueError, match="fleet policy"):
            ff.fake_router(pkg, policy="drop")
    assert sorted(router.DISPATCH_POLICIES) == sorted(
        jrouter.DISPATCH_POLICIES)
    assert (router.FLEET_BUDGET_COL, router.FLEET_TRACE_COL,
            router._RAISE_KINDS) == (jrouter.FLEET_BUDGET_COL,
                                     jrouter.FLEET_TRACE_COL,
                                     jrouter._RAISE_KINDS)
    for fp in (0, 1, 2 ** 63 + 5, 12345678901234567):
        for rid in range(4):
            assert router._mix(fp, rid) == jrouter._mix(fp, rid)
    for vals in ([], [3.0], [1.0, 5.0], [4.0, 1.0, 2.0]):
        assert router._median(vals) == jrouter._median(vals)


def test_least_loaded_and_rr_never_exceed_a_replica_capacity():
    """The reference's queue-depth invariant: no pick lands on a replica
    at its capacity, and both replicas take work."""
    rows = ff.prompts([5, 7, 3, 9, 4, 6, 8, 5, 7, 3, 9, 4, 6, 8, 5, 7])
    for name in ("least_loaded", "weighted_rr"):
        seen = []

        def spy(rt, req, candidates, _inner=router.DISPATCH_POLICIES[name]):
            pick = _inner(rt, req, candidates)
            seen.append((rt._assigned_count(pick.replica_id),
                         pick.capacity()))
            return pick

        out, rt = ff.serve(ff.fake_router(router, dispatch=spy,
                                          policy="reject"), rows)
        assert len(out) == 16 and all("error" not in r for r in out)
        assert seen and all(depth < cap for depth, cap in seen)
        assert all(s["admitted"] > 0
                   for s in rt.stats["per_replica"].values())


def test_weighted_rr_splits_by_weight_like_jax():
    res = []
    for pkg in (router, jrouter):
        _, rt = ff.serve(ff.fake_router(
            pkg, slots=8, dispatch="weighted_rr", policy="reject",
            replica_queue_depth=16, replica_weights={0: 3.0, 1: 1.0}),
            ff.prompts([4] * 16))
        res.append({k: v["admitted"]
                    for k, v in rt.stats["per_replica"].items()})
    assert res[0] == res[1] == {0: 12, 1: 4}


def test_prefix_affinity_keeps_each_family_on_one_replica_like_jax():
    rng = np.random.RandomState(5)
    heads = [rng.randint(1, 50, (16,)) for _ in range(2)]
    rows = [{"prompt": np.concatenate([heads[i % 2], rng.randint(
        1, 50, (3,))]).astype(np.int32)} for i in range(12)]
    res = []
    for pkg in (router, jrouter):
        picks = {}

        def spy(rt, req, candidates, _pkg=pkg):
            pick = _pkg.DISPATCH_POLICIES["prefix_affinity"](rt, req,
                                                             candidates)
            picks.setdefault(req["fingerprint"], set()).add(pick.replica_id)
            return pick

        _, rt = ff.serve(ff.fake_router(
            pkg, dispatch=spy, policy="reject", replica_queue_depth=12,
            imbalance=10 ** 6), rows)
        assert len(picks) == 2 and all(len(v) == 1 for v in picks.values())
        res.append((sorted(picks.items()), rt.stats["affinity_hits"]))
    assert res[0] == res[1] and res[0][1] == 12


def test_affinity_hits_beat_random_in_a_fixed_order(tree):
    """4 of 5 requests extend one of 4 shared 16-token heads (blocks of
    8), submitted in a fixed order over two replicas with radix caches:
    affinity keeps each family on one replica and hits more than random
    (the same counts as the JAX fleet's for the same policy)."""
    extra = {"prefix_cache": True, "prefix_block": 8}
    rng = np.random.RandomState(11)
    heads = [rng.randint(1, 64, (16,)) for _ in range(4)]
    rows = []
    for i in range(20):
        if i % 5 == 4:
            rows.append({"prompt": rng.randint(1, 64, (18,)).astype(
                np.int32)})
        else:
            rows.append({"prompt": np.concatenate(
                [heads[i % 4], rng.randint(1, 64, (2,))]).astype(np.int32)})
    hits = {}
    for pkg, build in ((router, ff.port_predict), (jrouter, ff.jax_predict)):
        p0 = build(tree, **extra)
        pair = [p0, p0.make_replica()]
        for name in ("prefix_affinity", "random"):
            out, rt = ff.serve(ff.real_router(
                pkg, pair, n=2, dispatch=name, replica_queue_depth=24), rows)
            assert len(out) == 20 and all("error" not in r for r in out)
            hits[(name, pkg.__name__)] = rt.stats["prefix_hits"]
            for p in pair:  # cold caches for the next policy
                p.make_slot_decoder(2).prefix_cache.clear()
    port = router.__name__
    assert hits[("prefix_affinity", port)] > hits[("random", port)], hits
    assert hits[("prefix_affinity", port)] == hits[
        ("prefix_affinity", jrouter.__name__)]


# ----------------------------------------------------------------------
# fleet admission
# ----------------------------------------------------------------------


def test_reject_sheds_typed_records_beyond_the_fleet_bound(port3, jax3):
    """A burst past the fleet queue and the replicas' room sheds typed
    records at the same input positions as the JAX fleet, and no engine
    sheds (spill before shed)."""
    rows = _rows(seed=5, lens=[4, 6, 5, 7] * 6)
    kw = dict(replica_queue_depth=1, policy="reject", queue_depth=4)
    got, rt = ff.serve(ff.real_router(router, port3, **kw), rows)
    ref, jrt = ff.serve(ff.real_router(jrouter, jax3, **kw), rows)
    assert ff.tokens(got) == ff.tokens(ref)
    shed = [r for r in got if "error" in r]
    assert shed and all(r["error"]["kind"] == "shed" for r in shed)
    assert all("fleet admission queue" in r["error"]["message"]
               for r in shed)
    assert [r["error"]["request_index"] for r in shed] == [
        i for i, r in enumerate(got) if "error" in r]
    assert rt.stats["shed"] == len(shed) == jrt.stats["shed"]
    assert all(s["shed"] == 0 for s in rt.stats["per_replica"].values())


def test_degrade_shrinks_budgets_like_jax(port3, jax3):
    rows = _rows(seed=6, lens=[4, 6, 5, 7] * 6)
    kw = dict(replica_queue_depth=1, policy="degrade", queue_depth=4)
    got, rt = ff.serve(ff.real_router(router, port3, **kw), rows)
    ref, jrt = ff.serve(ff.real_router(jrouter, jax3, **kw), rows)
    assert all("error" not in r for r in got)
    lens = [int(r["generated_len"]) for r in got]
    assert lens == [int(r["generated_len"]) for r in ref]
    assert min(lens) < ff.GEN["max_new_tokens"] == max(lens)
    assert ff.tokens(got) == ff.tokens(ref)
    assert rt.stats["degraded"] == jrt.stats["degraded"] > 0


def test_block_backpressures_the_source():
    res = []
    for pkg in (router, jrouter):
        pulled, peak = [], []

        def source(rt_box):
            for i, r in enumerate(ff.prompts([4] * 12)):
                pulled.append(i)
                rt = rt_box[0]
                peak.append(len(rt._queue) + sum(
                    rt._assigned_count(x.replica_id) for x in rt.replicas))
                yield r

        rt = ff.fake_router(pkg, replica_queue_depth=1, policy="block")
        box = [rt]
        out = list(rt.serve(source(box)))
        rt.close()
        assert len(out) == 12 and len(pulled) == 12
        assert rt.stats["shed"] == 0
        # never more in the fleet than its routable room
        assert max(peak) <= sum(r.capacity() for r in rt.replicas)
        res.append(ff.tokens(out))
    assert res[0] == res[1]


# ----------------------------------------------------------------------
# load snapshots and /status
# ----------------------------------------------------------------------


def test_engine_load_equals_jax_and_health_status(port3, jax3):
    snaps = []
    for eng_mod, pred in ((serving_engine, port3[0]), (jengine, jax3[0])):
        eng = eng_mod.ServingEngine(pred, ff.MAPPING, None, 3, queue_depth=5)
        snap = eng.load()
        hs = eng.health_status()
        assert all(hs[k] == snap[k] for k in snap if k in hs)
        assert {"free_slots", "queued", "queue_depth",
                "prefix_blocks"} <= set(hs)
        snaps.append(snap)
    assert snaps[0] == snaps[1] == {
        "slots": 3, "free_slots": 3, "in_flight": 0, "queued": 0,
        "queue_depth": 5, "prefix_blocks": 0, "weight_generation": 0,
        "draining": False}


def test_engine_load_makes_no_registry_traffic():
    telemetry.set_enabled(False)
    try:
        eng = serving_engine.ServingEngine(ff.FakePredict(), ff.MAPPING,
                                           None, 2)
        before = telemetry.get_registry().snapshot()
        for _ in range(64):
            snap = eng.load()
        assert telemetry.get_registry().snapshot() == before
        assert all(isinstance(v, (int, bool)) for v in snap.values())
    finally:
        telemetry.set_enabled(True)


def test_router_load_and_status_like_jax(port3, jax3):
    res = []
    for pkg, hmod, preds in ((router, health, port3),
                             (jrouter, jhealth, jax3)):
        rt = ff.real_router(pkg, preds)
        try:
            out = list(rt.serve([dict(r) for r in _rows()]))
            st = hmod.provider_statuses()["fleet"]
            load = rt.load()
        finally:
            rt.close()
        assert len(out) == 10
        assert st["replicas"] == 3 and st["live"] == 3
        assert st["completed"] == 10 and st["outstanding"] == 0
        assert [s["replica"] for s in st["loads"]] == [0, 1, 2]
        assert sum(c["tokens_out"] for c in st["costs"].values()) == 60
        res.append((sorted(st), sorted(st["pressure"]),
                    sorted(st["loads"][0]), load))
    assert res[0] == res[1]


# ----------------------------------------------------------------------
# replica faults
# ----------------------------------------------------------------------


def test_kill_replica_redispatches_like_jax(port3, jax3, plan_env,
                                            tmp_path):
    """``kill_replica(2, at_chunk=1)``: every request served, tokens equal
    one JAX engine's and the JAX fleet's under the same plan; the death
    and the re-dispatches are journal events and ``forensics.explain``
    names the fault."""
    rows = _rows(seed=31, lens=[6, 9, 5, 13, 8, 4, 7, 11, 6, 9, 5, 13])
    want = ff.tokens(ff.single(jserving, jax3[0], rows))
    plan_env(chaos.ChaosPlan().kill_replica(2, at_chunk=1))
    j = journal.get_journal()
    j.clear()
    got, rt = ff.serve(ff.real_router(router, port3), rows)
    events = [e.to_dict() for e in j.events()]
    ref, jrt = ff.serve(ff.real_router(jrouter, jax3), rows)
    assert ff.tokens(got) == ff.tokens(ref) == want
    for r in (rt, jrt):
        assert r.stats["replica_deaths"] == 1
        assert r.stats["redispatched"] >= 1
        assert not r.replicas[2].alive
    kinds = {e["kind"] for e in events}
    assert {"replica_dead", "fleet_redispatch"} <= kinds
    path = str(tmp_path / "journal.json")
    with open(path, "w") as f:
        json.dump({"events": events}, f)
    report = forensics.explain([path])
    assert report["incident"]["fault_kind"] == "kill_replica"


def test_redispatch_keeps_a_long_prompt_within_its_budget(port3, jax3,
                                                          plan_env):
    """Prompts near ``max_prompt_len`` killed mid-decode re-dispatch with
    their committed tokens in the prompt and the rest of the budget: they
    are served with one engine's tokens (the reference's engine asks for
    the whole budget again and refuses them as ``too_long``)."""
    top = ff.GEN["max_prompt_len"]
    rows = _rows(seed=9, lens=[top, top - 1, top - 2, top, 5, 6])
    want = ff.tokens(ff.single(jserving, jax3[0], rows))
    plan_env(chaos.ChaosPlan().kill_replica(0, at_chunk=1))
    got, rt = ff.serve(ff.real_router(router, port3, n=2), rows)
    assert rt.stats["replica_deaths"] == 1 and rt.stats["redispatched"] >= 1
    assert ff.tokens(got) == want


def test_device_error_quarantines_rebuilds_and_keeps_tokens(port3, jax3,
                                                            plan_env):
    """``device_error(1, at_chunk=1)``: the replica quarantines (routed
    around, its engine rebuilt on its reset decoder) instead of dying,
    and the stream equals one JAX engine's and the JAX fleet's."""
    rows = _rows(seed=33, lens=[6, 9, 5, 13, 8, 4, 7, 11, 6, 9, 5, 13])
    want = ff.tokens(ff.single(jserving, jax3[0], rows))
    plan_env(chaos.ChaosPlan().device_error(1, at_chunk=1))
    j0 = len(journal.get_journal().events(kind="replica_quarantined"))
    got, rt = ff.serve(ff.real_router(router, port3), rows)
    ref, jrt = ff.serve(ff.real_router(jrouter, jax3), rows)
    assert ff.tokens(got) == ff.tokens(ref) == want
    for r in (rt, jrt):
        assert r.stats["quarantined"] == 1 and r.stats["replica_deaths"] == 0
        assert r.replicas[1].alive
        assert r.replicas[1].state in ("live", "routed_around")
    ev = journal.get_journal().events(kind="replica_quarantined")
    assert len(ev) > j0 and ev[-1].severity == "page"
    # the rebuild's reset freed the quarantined incarnation's pages:
    # nothing is held after the job
    dec = rt.replicas[1].engine.decoder
    assert dec.page_pool.stats()["pool_pages_used"] == 0


def test_quarantine_rebuild_keeps_cumulative_stats(plan_env):
    """On the fake engines: the quarantined replica's rebuilt engine
    keeps the earlier incarnation's counters, and the stream equals one
    engine's in both packages."""
    plan_env(chaos.ChaosPlan().device_error(0, at_chunk=2))
    rows = ff.prompts([5, 7, 3, 9, 4, 6, 8, 5, 7, 3, 9, 4])
    ref = ff.tokens(list(serving_engine.ServingEngine(
        ff.FakePredict(chunk=2, max_new=12), ff.MAPPING, None, 2,
        on_error="record").serve([dict(r) for r in rows])))
    for pkg in (router, jrouter):
        out, rt = ff.serve(ff.fake_router(pkg, max_new=12, chunk=2), rows)
        assert ff.tokens(out) == ref
        assert rt.stats["quarantined"] == 1
        assert rt.stats["replica_deaths"] == 0
        # the fault fired at chunk 2: the chunks before it stay counted
        assert rt.stats["per_replica"][0]["chunks"] >= 2


def test_replica_fault_hook_fires_like_jax(plan_env):
    plan_env(chaos.ChaosPlan().kill_replica(1, 3).device_error(2, 1)
             .slow_replica(0, per_chunk_sec=0.0, chunks=2))
    assert chaos.replica_fault_fn(5) is None is jchaos.replica_fault_fn(5)
    for pkg, rmod in ((chaos, replica), (jchaos, jreplica)):
        kill = pkg.replica_fault_fn(1)
        kill(2)
        with pytest.raises(rmod.ReplicaKilled, match="chunk 3"):
            kill(3)
        kill(4)  # fired once
        dev = pkg.replica_fault_fn(2)
        with pytest.raises(rmod.ReplicaDeviceError):
            dev(1)
        dev(2)
        assert rmod._is_device_error(rmod.ReplicaDeviceError("x"))
        assert not rmod._is_device_error(rmod.ReplicaKilled("x"))
        slow = pkg.replica_fault_fn(0)
        for i in range(4):
            slow(i)
    assert chaos.ChaosPlan().kill_replica(1, 3).device_error(2, 1) \
        .slow_replica(0, 0.5, 2).faults == jchaos.ChaosPlan() \
        .kill_replica(1, 3).device_error(2, 1).slow_replica(0, 0.5, 2).faults
    # torch's runtime error classes count as device errors, by name
    err = type("AcceleratorError", (RuntimeError,), {})
    assert replica._is_device_error(err("sticky"))
    assert replica._CUMULATIVE_STATS == jreplica._CUMULATIVE_STATS
    assert replica.STATES == jreplica.STATES


class _Clock(object):
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Plane(object):
    """The health plane's face the sensor reads: scrapes, hints, SLO."""

    def __init__(self):
        import types

        self.store = types.SimpleNamespace(scrapes=0)
        self.hints = {}
        self.firing = []
        self.slo = types.SimpleNamespace(active=lambda: list(self.firing))


#: scripted completions: (replica, latency seconds), then the plane's
#: state at that point
_SCRIPT = ([(0, 0.01), (1, 0.01), (2, 0.01)] * 2
           + [(0, 0.5), (1, 0.01), (0, 0.6), (2, 0.01), (0, 0.7)]
           + [(0, 0.01), (1, 0.01), (0, 0.01), (0, 0.02), (2, 0.01)]
           + [(0, 0.01)] * 6)


def _straggle(pkg, hmod, gate_rounds):
    clock = _Clock()
    plane = _Plane()
    gate = hmod.CleanRoundsSensor(plane, rounds=gate_rounds)
    rt = ff.fake_router(pkg, n=3, clock=clock, suspect_rounds=2,
                        readmit_rounds=2, min_slow_sec=0.1, slow_factor=3.0,
                        readmit_gate=gate)
    states = []
    try:
        for k, (rid, lat) in enumerate(_SCRIPT):
            if k == 15:
                plane.hints = {"executor": 1}   # a dirty round
            if k == 17:
                plane.hints = {}
            plane.store.scrapes += 1
            req = {"sent_at": clock.t}
            clock.t += lat
            rt._observe_latency(rid, req)
            states.append((rt.replicas[rid].state, gate.streak))
    finally:
        rt.close()
    return states, {k: rt.stats[k] for k in ("evicted", "readmitted")}


def test_slow_replica_evicted_then_readmitted_behind_clean_rounds():
    """The straggler policy on scripted completion latencies (the
    router's injected clock): replica 0 is routed around after two slow
    completions, its clean probes re-admit it only once the health plane
    saw its clean rounds (a dirty round resets the gate), and every
    decision equals the JAX router's."""
    got = _straggle(router, health, gate_rounds=3)
    want = _straggle(jrouter, jhealth, gate_rounds=3)
    assert got == want
    states, counts = got
    assert counts == {"evicted": 1, "readmitted": 1}
    around = [i for i, (s, _) in enumerate(states) if s == "routed_around"]
    assert around and states[-1][0] == "live"
    gated = journal.get_journal().events(kind="readmit_gated")
    assert gated and gated[-1].attrs["required_rounds"] == 3
    assert journal.get_journal().events(kind="readmit_cleared")


def test_clean_rounds_sensor_like_jax():
    res = []
    for hmod in (health, jhealth):
        plane = _Plane()
        s = hmod.CleanRoundsSensor(plane, rounds=2)
        trace = []
        for step in range(10):
            if step in (2, 3):
                plane.store.scrapes += 1
            if step == 5:
                plane.firing = ["p99"]
            if step == 6:
                plane.firing = []
            if step >= 6:
                plane.store.scrapes += 1
            trace.append((s.poll(), s.streak, s.ready(), s.dirty()))
        s.reset()
        trace.append((s.streak, s.ready()))
        res.append(trace)
    assert res[0] == res[1]
    assert any(t[2] for t in res[0][:-1]) and not res[0][-1][1]


def test_slow_replica_is_routed_around_and_readmitted_end_to_end(plan_env):
    """The chaos ``slow_replica`` on the fake engines: routed around
    while slow, probed and re-admitted after; streams are served until it
    is re-admitted (bounded), every output equal to one engine's."""
    plan_env(chaos.ChaosPlan().slow_replica(0, per_chunk_sec=0.3, chunks=2))
    rt = router.FleetRouter(
        None, ff.MAPPING, replicas=2, num_slots=1,
        predict_factory=lambda: ff.FakePredict(chunk=4, max_new=4,
                                               delay=0.015),
        replica_queue_depth=1, poll_sec=0.01, suspect_rounds=1,
        probe_every=2, readmit_rounds=2, min_slow_sec=0.1, slow_factor=3.0)
    rows = ff.prompts([4] * 40)
    ref = ff.tokens(list(serving_engine.ServingEngine(
        ff.FakePredict(chunk=4, max_new=4), ff.MAPPING, None, 1,
        on_error="record").serve([dict(r) for r in rows])))
    try:
        for _ in range(6):
            out = list(rt.serve([dict(r) for r in rows]))
            assert ff.tokens(out) == ref
            if rt.stats["readmitted"] and rt.replicas[0].state == "live":
                break
    finally:
        rt.close()
    assert rt.stats["evicted"] >= 1 and rt.stats["readmitted"] >= 1
    assert rt.replicas[0].state == "live"
    j = journal.get_journal()
    assert j.events(kind="replica_evicted")
    assert j.events(kind="replica_readmitted")


# ----------------------------------------------------------------------
# ledger, catalog
# ----------------------------------------------------------------------


def test_usage_ledger_redispatch_like_jax():
    rows = []
    for lmod in (ledger, jledger):
        lg = lmod.UsageLedger()
        lg.enabled_override = True
        lg.open("r1", tenant="acme", tokens_in=5)
        lg.redispatch("r1")
        lg.redispatch("r1")
        lg.redispatch("r2")   # a row the re-dispatch opens
        lg.close("r1", tokens_out=7)
        lg.enabled_override = False
        lg.redispatch("r1")   # disabled: no-op
        rows.append((lg.row("r1"), lg.row("r2")))
    assert rows[0] == rows[1]
    assert rows[0][0]["redispatches"] == 2


def test_fleet_catalog_rows_equal_the_reference():
    ref = {m.name: m for m in jcatalog.METRICS if m.name.startswith(
        "fleet.")}
    got = {m.name: m for m in catalog.METRICS if m.name.startswith(
        "fleet.")}
    assert len(got) == 11 and got == ref


def test_router_counters_move_in_the_registry():
    reg = telemetry.get_registry()
    base = reg.snapshot()
    out, rt = ff.serve(ff.fake_router(router, n=2), ff.prompts([4, 5, 6]))
    delta = telemetry.snapshot_delta(reg.snapshot(), base)["counters"]
    assert delta["fleet.dispatched"] == delta["fleet.completed"] == 3
    assert reg.snapshot()["gauges"]["fleet.live_replicas"] == 2


# ----------------------------------------------------------------------
# surface checks (the reference's tests/test_fleet.py TestSurface)
# ----------------------------------------------------------------------


def test_static_schedule_rejects_replicas():
    for mod in (serving, jserving):
        with pytest.raises(ValueError, match="continuous"):
            list(mod.predict_rows(lambda b: b, [], {"c": "x"}, replicas=2))


def test_fleet_rejects_single_engine_watcher_knobs():
    for mod in (serving, jserving):
        with pytest.raises(ValueError, match="rolling deploys"):
            list(mod.predict_rows(lambda b: b, [], {"c": "x"},
                                  schedule="continuous", replicas=2,
                                  checkpoint_dir="/tmp/nope"))


def test_replicas_need_make_replica():
    for rmod in (replica, jreplica):
        with pytest.raises(ValueError, match="make_replica"):
            rmod.ReplicaSet(ff.FakePredict(), 2, ff.MAPPING)
        with pytest.raises(ValueError, match="at least one"):
            rmod.ReplicaSet(ff.FakePredict(), 0, ff.MAPPING)


def test_engine_mapping_adds_the_internal_columns():
    rt = ff.fake_router(router, n=1)
    try:
        m = rt.engine_input_mapping()
        assert m[router.FLEET_BUDGET_COL] == serving_engine.BUDGET_INPUT
        assert m[router.FLEET_TRACE_COL] == serving_engine.TRACE_INPUT
        m2 = rt.engine_input_mapping({"prompt": "tokens",
                                      "budget": "max_new"})
        assert router.FLEET_BUDGET_COL not in m2
    finally:
        rt.close()


def test_user_budget_column_respected_like_jax():
    rows = ff.prompts([4] * 6)
    for i, r in enumerate(rows):
        r["budget"] = 3 if i % 2 else 8
    for pkg in (router, jrouter):
        rt = pkg.FleetRouter(
            None, {"prompt": "tokens", "budget": "max_new"}, replicas=2,
            num_slots=2, predict_factory=lambda: ff.FakePredict(max_new=8),
            poll_sec=0.01)
        out, _ = ff.serve(rt, rows)
        assert [int(r["generated_len"]) for r in out] == [8, 3] * 3


def test_replica_lifecycle_verbs():
    rt = ff.fake_router(router, n=2)
    try:
        rs = rt.replica_set
        rs.drain(1)
        assert rt.replicas[1].state == "draining"
        rs.evict(1)
        assert rt.replicas[1].state == "routed_around"
        rs.readmit(1)
        assert rt.replicas[1].state == "live"
        assert [r.replica_id for r in rs.live()] == [0, 1]
        snap = rs.load()
        assert [s["replica"] for s in snap] == [0, 1]
        assert all({"free_slots", "queued", "in_flight"} <= set(s)
                   for s in snap)
    finally:
        rt.close()


def test_scale_up_down_and_set_policy():
    rt = ff.fake_router(router, n=2)
    try:
        assert rt.set_policy("reject") == "block"
        with pytest.raises(ValueError):
            rt.set_policy("drop")
        assert rt.scale_up() == 2 and len(rt.replicas) == 3
        out = list(rt.serve([dict(r) for r in ff.prompts([4] * 9)]))
        assert len(out) == 9
        assert rt.stats["per_replica"][2]["admitted"] > 0
        assert rt.scale_down() in (0, 1, 2)
        assert rt.stats["scaled_up"] == rt.stats["scaled_down"] == 1
        assert len(rt._routable()) == 2
    finally:
        rt.close()


def test_on_error_raise_names_the_fleet_index():
    rows = ff.prompts([4, 5]) + [{"prompt": np.zeros((0,), np.int32)}]
    with pytest.raises(serving_engine.RequestError, match="fleet request 2"):
        ff.serve(ff.fake_router(router, n=2, on_error="raise"), rows)
    out, rt = ff.serve(ff.fake_router(router, n=2), rows)
    assert out[2]["error"]["kind"] == "empty_prompt"
    assert out[2]["error"]["request_index"] == 2


def test_k1_launch_count_loses_no_update_across_replica_threads():
    """Replicas launch K1 from threads of their own: the launch count's
    read-modify-write is taken under a lock (16 threads, a shortened
    switch interval, every increment counted)."""
    import sys
    import threading

    from tensorflowonspark_tpu_torch.ops import paged_attention as tpa

    old = sys.getswitchinterval()
    before = tpa.paged_attention.launches
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            tpa._count_launch() for _ in range(5000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert tpa.paged_attention.launches - before == 16 * 5000
    tpa.paged_attention.launches = before
