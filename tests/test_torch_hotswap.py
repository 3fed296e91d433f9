"""The port's live weight hot swap (``hot_swap.py``, the engine's swap
transaction and the decoder's swap surface) against the JAX package's, on
the CPU in f32: quarantine kinds, which step is offered, swaps before and
under load with committed prefixes kept, int8 re-quantization on ingest
(codes bit-exact), rollbacks, a swap during a wedge, and exports crossing
between the packages.  Tokens and records are compared exactly.

Two ways a straight translation goes wrong are held here too: a snapshot
that aliases the live weights (an in-place ``copy_`` swap would make a
rollback serve the new weights), and a swap that reads the weights
before the ingest thread's copy onto the card has landed.
"""

import os
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import convert_jax_export  # noqa: E402
from tensorflowonspark_tpu import checkpoint as jckpt  # noqa: E402
from tensorflowonspark_tpu import hot_swap as jhot  # noqa: E402
from tensorflowonspark_tpu import quantize as jqz  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu import serving_engine as jengine  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu.testing import chaos as jchaos  # noqa: E402
from tensorflowonspark_tpu_torch import checkpoint as ckpt  # noqa: E402
from tensorflowonspark_tpu_torch import hot_swap  # noqa: E402
from tensorflowonspark_tpu_torch import pipeline as tpl  # noqa: E402
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch import serving_engine  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.testing import chaos  # noqa: E402

TINY = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
            embed_dim=16, mlp_dim=32, max_seq_len=96, dtype="float32")
#: wide enough that int8 quantizes some leaves (min_size 16384)
BIG = dict(TINY, vocab_size=512, embed_dim=64, mlp_dim=64)


def _params(seed, cfg=TINY):
    model = jtr.Transformer(jtr.TransformerConfig(**cfg))
    return jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def trees():
    return {0: _params(0), 1: _params(1)}


def _cfg(max_new=8, tiny=TINY, **extra):
    return dict(tiny, mode="generate", max_new_tokens=max_new,
                pad_multiple=16, **extra)


def _port(tree, **kw):
    return ttr.serving_builder(tree, dict(_cfg(**kw), device="cpu"))


def _jax(tree, **kw):
    cfg = _cfg(**kw)
    if cfg.get("kv_layout") == "paged":
        cfg["paged_impl"] = "gather"
    return jtr.serving_builder(tree, cfg)


def _rows(lens, vocab=64, seed=13, **cols):
    rng = np.random.RandomState(seed)
    rows = [{"prompt": rng.randint(0, vocab, (n,)).astype(np.int32)}
            for n in lens]
    for k, vals in cols.items():
        for r, v in zip(rows, vals):
            r[k] = v
    return rows


def _serve(mod, predict, rows, mapping=None, slots=2, **kw):
    stats = {}
    out = list(mod.predict_rows(
        predict, [dict(r) for r in rows], mapping or {"prompt": "tokens"},
        batch_size=slots, schedule="continuous", stats=stats, **kw))
    return out, stats


def _tokens(out):
    return [np.asarray(r["generated"]).tolist() for r in out]


def _watcher(mod, root, **kw):
    kw.setdefault("poll_interval", 0.0)
    kw.setdefault("background", False)
    return mod.CheckpointWatcher(root, **kw)


LIFECYCLE = ("swaps", "swap_commits", "rollbacks", "swap_requeued",
             "weight_generation", "swap_events")


# ----------------------------------------------------------------------
# validation and quarantine
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind,reason", [
    ("truncate_array", "load_failed"), ("bad_manifest", "bad_manifest"),
    ("shape_mismatch", "shape_mismatch"),
])
def test_corrupt_checkpoint_quarantined_like_jax(trees, tmp_path, kind,
                                                 reason):
    """Each package corrupts its own published step; both quarantine it
    with the same typed reason, and the port serves on unchanged."""
    rows = _rows([4, 7, 5, 9])
    pred = _port(trees[0], chunk_size=2)
    ref, _ = _serve(serving, pred, rows)
    got = []
    for name, (ck, hs, ch) in {"port": (ckpt, hot_swap, chaos),
                               "jax": (jckpt, jhot, jchaos)}.items():
        root = str(tmp_path / name)
        step_dir = ck.publish_for_serving(root, 1, trees[0])
        ch.corrupt_checkpoint(step_dir, kind)
        expect = ck.param_manifest(trees[0])
        w = _watcher(hs, root, expect=expect)
        assert w.poll() is None
        got.append((w.quarantined[-1]["kind"],
                    hs.read_quarantine(step_dir)["kind"]))
        w2 = _watcher(hs, root, expect=expect)
        assert w2.poll() is None and w2.stats["quarantined"] == 0
    assert got[0] == got[1] == (reason, reason)
    out, stats = _serve(serving, pred, rows,
                        watcher=_watcher(hot_swap, str(tmp_path / "port")))
    assert stats["swaps"] == 0 and _tokens(out) == _tokens(ref)


def test_torn_and_dtype_kind_steps_quarantined_like_jax(trees, tmp_path):
    bad = jax.tree.map(lambda x: x.astype(np.int32) if x.ndim >= 2 else x,
                       trees[0])
    kinds = []
    for name, (ck, hs) in {"port": (ckpt, hot_swap),
                           "jax": (jckpt, jhot)}.items():
        root = str(tmp_path / name)
        ck.publish_for_serving(root, 1, bad)
        os.makedirs(os.path.join(root, "2", "params"))  # torn: no manifest
        os.makedirs(os.path.join(root, "3"))
        with open(os.path.join(root, "3", "manifest.json"), "w") as f:
            f.write('{"step": 3}')  # incomplete
        w = _watcher(hs, root, expect=ck.param_manifest(trees[0]))
        assert w.poll() is None
        kinds.append(sorted((r["step"], r["kind"]) for r in w.quarantined))
        assert ck.list_serving_steps(root) == [1]
    assert kinds[0] == kinds[1] == [(1, "dtype_mismatch"),
                                    (2, "bad_manifest"), (3, "incomplete")]
    # the live census of a bf16 decoder takes an f32 checkpoint: kinds
    # match (numpy does not know "bfloat16"; the port counts it a float)
    hot_swap.check_tree({"a": {"shape": [2], "dtype": "bfloat16"}},
                        {"a": {"shape": [2], "dtype": "float32"}})


def test_watcher_offers_newest_once_and_canary_quarantines(trees, tmp_path):
    root = str(tmp_path / "pub")
    for step in (3, 8, 5):
        ckpt.publish_for_serving(root, step, trees[1])
    for hs in (hot_swap, jhot):
        w = _watcher(hs, root)
        assert w.poll().step == 8 and w.poll() is None
    root2 = str(tmp_path / "canary")
    ckpt.publish_for_serving(root2, 1, trees[1])
    w = _watcher(hot_swap, root2, canary_fn=lambda p: False)
    assert w.poll() is None
    assert w.quarantined[-1]["kind"] == "canary_failed"
    # device= copies the loaded leaves (CPU here: no event to wait on)
    root3 = str(tmp_path / "device")
    ckpt.publish_for_serving(root3, 2, trees[1])
    ws = _watcher(hot_swap, root3, device="cpu").poll()
    assert ws.ready is None
    assert isinstance(ws.params["embedding"], torch.Tensor)


# ----------------------------------------------------------------------
# the swap
# ----------------------------------------------------------------------


def test_swap_before_admissions_serves_the_new_generation(trees, tmp_path):
    rows = _rows([4, 7, 5, 9])
    want, _ = _serve(jserving, _jax(trees[1], chunk_size=2), rows)
    root = str(tmp_path / "pub")
    ckpt.publish_for_serving(root, 1, trees[1])
    pred = _port(trees[0], chunk_size=2)
    out, stats = _serve(serving, pred, rows,
                        watcher=_watcher(hot_swap, root), rollback_window=2)
    assert stats["swaps"] == stats["weight_generation"] == 1
    assert stats["swap_commits"] == 1 and len(stats["swap_latency_sec"]) == 1
    assert _tokens(out) == _tokens(want)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_swap_under_load_keeps_committed_prefixes_like_jax(trees, tmp_path,
                                                           layout):
    rows = _rows([4, 7, 5, 9, 3, 6], max_new=[2, 12, 12, 12, 12, 12])
    mapping = {"prompt": "tokens", "max_new": "max_new"}
    kw = dict(max_new=12, chunk_size=2, kv_layout=layout,
              **({"kv_page_tokens": 8} if layout == "paged" else {}))
    res = []
    for name, mod, ck, hs, build in (
            ("port", serving, ckpt, hot_swap, _port),
            ("jax", jserving, jckpt, jhot, _jax)):
        root = str(tmp_path / name)
        stats = {}
        gen = mod.predict_rows(
            build(trees[0], **kw), [dict(r) for r in rows], mapping,
            batch_size=2, schedule="continuous", stats=stats,
            watcher=_watcher(hs, root), rollback_window=2)
        out = [next(gen)]  # row 0 (budget 2) done; row 1 in flight
        ck.publish_for_serving(root, 5, trees[1])
        out.extend(gen)
        res.append((out, stats))
    (got, s), (want, w) = res
    assert _tokens(got) == _tokens(want)
    assert {k: s[k] for k in LIFECYCLE} == {k: w[k] for k in LIFECYCLE}
    ev = s["swap_events"][0]
    assert s["swaps"] == 1 and ev["requeued"]
    ref_a, _ = _serve(serving, _port(trees[0], **kw), rows, mapping)
    ref_b, _ = _serve(serving, _port(trees[1], **kw), rows, mapping)
    for idx, committed in ev["requeued"].items():
        assert _tokens(got)[idx][:committed] == \
            _tokens(ref_a)[idx][:committed]
    assert _tokens(got)[0] == _tokens(ref_a)[0]
    for i in range(len(rows)):
        if i and i not in ev["requeued"]:
            assert _tokens(got)[i] == _tokens(ref_b)[i], i


def test_int8_requantizes_on_ingest_bit_exact(tmp_path):
    pa, pb = _params(0, BIG), _params(1, BIG)
    rows = _rows([4, 7, 5, 9], vocab=512)
    kw = dict(tiny=BIG, max_new=6, chunk_size=2, quantize="int8")
    want, _ = _serve(jserving, _jax(pb, **kw), rows)
    pred = _port(pa, **kw)
    dec = pred.make_slot_decoder(2)
    root = str(tmp_path / "pub")
    ckpt.publish_for_serving(root, 1, pb)
    out, stats = _serve(serving, pred, rows,
                        watcher=_watcher(hot_swap, root))
    assert stats["swaps"] == 1 and dec._quantized and dec._wq == "int8"
    assert _tokens(out) == _tokens(want)
    ref = jqz.quantize_tree(jax.tree.map(jnp.asarray, pb))
    names = dec._qparams.names()
    assert names
    for name in names:
        path, qt = dec._qparams._leaves[name]
        node = ref
        for k in path.split("/"):
            node = node[k]
        np.testing.assert_array_equal(qt.q.numpy(), np.asarray(node.q))
        np.testing.assert_array_equal(qt.scale.numpy(),
                                      np.asarray(node.scale))


def test_swap_weights_rejects_mismatched_trees(trees):
    dec = _port(trees[0], max_new=4).make_slot_decoder(2)
    with pytest.raises(ValueError, match="shape mismatch"):
        dec.swap_weights(chaos.shape_mismatched_params(trees[0]))
    with pytest.raises(ValueError, match="tree mismatch"):
        dec.swap_weights({"nothing": np.zeros((2, 2))})
    assert dec.weight_generation == 0
    assert dec.param_spec() == jckpt.param_manifest(trees[0])


def test_manual_request_swap_like_jax(trees):
    rows = _rows([4, 7])
    res = []
    for eng_mod, build in ((serving_engine, _port), (jengine, _jax)):
        stats = {}
        eng = eng_mod.ServingEngine(build(trees[0], max_new=4,
                                          chunk_size=2),
                                    {"prompt": "tokens"}, num_slots=2,
                                    stats=stats, rollback_window=1)
        eng.request_swap(trees[1], step=3)
        res.append((_tokens(eng.serve([dict(r) for r in rows])), stats))
    assert res[0][0] == res[1][0]
    assert {k: res[0][1][k] for k in LIFECYCLE} == \
        {k: res[1][1][k] for k in LIFECYCLE}


def test_snapshot_stays_resident_and_rollback_restores(trees):
    """The snapshot is the old model, whose tensors the swap never
    writes: the swapped-in weights are new tensors, and a restore
    serves the old generation's tokens again."""
    pred = _port(trees[0], max_new=6, chunk_size=2)
    rows = _rows([4, 7, 5])
    ref_a, _ = _serve(serving, pred, rows)
    dec = pred.make_slot_decoder(2)
    snap = dec.snapshot_weights()
    before = {n: p.clone() for n, p in dec.model.named_parameters()}
    old_ptrs = {p.data_ptr() for p in dec.model.parameters()}
    dec.swap_weights(trees[1])
    assert not old_ptrs & {p.data_ptr() for p in dec.model.parameters()}
    ref_b, _ = _serve(serving, _port(trees[1], max_new=6, chunk_size=2),
                      rows)
    assert _tokens(_serve(serving, pred, rows)[0]) == _tokens(ref_b)
    for n, p in snap[0].named_parameters():
        assert torch.equal(p, before[n]), n
    assert dec.restore_weights(snap) == 0
    assert _tokens(_serve(serving, pred, rows)[0]) == _tokens(ref_a)


class _LateCopy(object):
    """A stand-in for the ingest thread's CUDA event: the weights hold
    NaN until :meth:`wait`, which lands the copy."""

    def __init__(self, real):
        self.real, self.waited = real, False
        self.tree = jax.tree.map(
            lambda x: torch.full(x.shape, float("nan")), real)

    def wait(self):
        jax.tree.map(lambda t, x: t.copy_(torch.from_numpy(np.array(x))),
                     self.tree, self.real)
        self.waited = True


class _OneShotWatcher(object):
    """Offers one :class:`hot_swap.WeightSet` at the first poll."""

    expect = None
    device = "cpu"

    def __init__(self, ws):
        self.ws, self.quarantined = ws, []

    def poll(self):
        ws, self.ws = self.ws, None
        return ws

    def quarantine_step(self, w, kind, message):
        self.quarantined.append(kind)

    def close(self):
        pass


def test_swap_waits_for_the_ingest_copy(trees):
    rows = _rows([4, 7, 5])
    ref_b, _ = _serve(serving, _port(trees[1], max_new=6, chunk_size=2),
                      rows)
    late = _LateCopy(trees[1])
    ws = hot_swap.WeightSet(4, "<test>", late.tree, ready=late)
    watcher = _OneShotWatcher(ws)
    out, stats = _serve(serving, _port(trees[0], max_new=6, chunk_size=2),
                        rows, watcher=watcher)
    assert late.waited and stats["swaps"] == 1 and stats["rollbacks"] == 0
    assert not watcher.quarantined
    assert _tokens(out) == _tokens(ref_b)


# ----------------------------------------------------------------------
# rollback
# ----------------------------------------------------------------------


def test_rollback_on_post_install_canary_failure(trees, tmp_path):
    nan = jax.tree.map(lambda x: np.full_like(x, np.nan), trees[1])
    rows = _rows([4, 7, 5, 9])
    pred = _port(trees[0], max_new=6, chunk_size=2)
    ref, _ = _serve(serving, pred, rows)
    root = str(tmp_path / "pub")
    ckpt.publish_for_serving(root, 7, nan)
    watcher = _watcher(hot_swap, root)
    out, stats = _serve(serving, pred, rows, watcher=watcher)
    assert stats["rollbacks"] == 1 and stats["swaps"] == 0
    assert stats["weight_generation"] == 0
    assert watcher.quarantined[-1]["kind"] == "canary_failed"
    assert _tokens(out) == _tokens(ref)
    _, stats2 = _serve(serving, pred, rows,
                       watcher=_watcher(hot_swap, root))
    assert stats2["rollbacks"] == stats2["swaps"] == 0


class _FakeDecoder(object):
    max_new_tokens, eos_id, cache_len, chunk_size = 4, None, 64, 4

    def __init__(self, n):
        self._n = n
        self.weight_generation = 0
        self.active = np.zeros((n,), bool)
        self.generation_params = "A"
        self.fail_on = "B"

    def free_slots(self):
        return [i for i in range(self._n) if not self.active[i]]

    def admit(self, slot, prompt, new_tokens=None):
        if self.fail_on == self.generation_params:
            raise RuntimeError("device OOM on new weights")
        self.active[slot] = True
        return 1

    def step_chunk(self):
        return (np.ones((self._n, self.chunk_size), np.int32),
                np.full((self._n,), self.chunk_size, np.int32))

    def evict(self, slot):
        self.active[slot] = False

    cancel = evict

    def reset(self):
        self.active[:] = False

    def param_spec(self):
        return {}

    def snapshot_weights(self):
        return self.generation_params

    def swap_weights(self, params, draft_params=None):
        self.generation_params = params
        self.weight_generation += 1

    def restore_weights(self, snap):
        self.generation_params = snap
        self.weight_generation = 0

    def canary_check(self, raw_params=None):
        return True


class _FakePredict(object):
    column_padding = {"tokens": 0}

    def __init__(self):
        self.dec = _FakeDecoder(2)

    def make_slot_decoder(self, n, chunk=None):
        return self.dec


def test_rollback_on_probation_error_spike_like_jax():
    res = []
    for eng_mod in (serving_engine, jengine):
        pred = _FakePredict()
        stats = {}
        eng = eng_mod.ServingEngine(pred, {"prompt": "tokens"}, num_slots=2,
                                    stats=stats, policy="degrade",
                                    on_error="record", rollback_window=8)
        eng.request_swap("B", step=2)
        rows = [{"prompt": np.arange(1, 4, dtype=np.int32)}
                for _ in range(6)]
        out = list(eng.serve(rows))
        assert len(out) == 6 and pred.dec.generation_params == "A"
        res.append((out, {k: stats[k] for k in LIFECYCLE}))
    assert res[0][1] == res[1][1]
    assert [e["event"] for e in res[0][1]["swap_events"]] == \
        ["swap", "rollback"]
    assert [("error" in r) for r in res[0][0]] == \
        [("error" in r) for r in res[1][0]]
    assert hot_swap.flag_probation_fault(
        serving_engine.ServingEngine(_FakePredict(), {"prompt": "tokens"},
                                     num_slots=2)) is False


def test_swap_during_a_wedge_lands_and_drops_nothing(trees, tmp_path,
                                                     monkeypatch):
    monkeypatch.delenv(chaos.TFOS_CHAOS_PLAN, raising=False)
    rows = _rows([4, 7, 5, 9, 3, 6], seed=7, max_new=[2, 8, 8, 8, 8, 8])
    mapping = {"prompt": "tokens", "max_new": "max_new"}
    pred = _port(trees[0], max_new=8, chunk_size=2)
    plan = str(tmp_path / "plan.json")
    chaos.ChaosPlan().swap_during_wedge(2, hang_sec=1.0).save(plan)
    monkeypatch.setenv(chaos.TFOS_CHAOS_PLAN, plan)
    assert chaos.swap_chunk_from_plan() == 2
    root = str(tmp_path / "pub")
    ckpt.publish_for_serving(root, 1, trees[1])
    out, stats = _serve(serving, pred, rows, mapping,
                        watcher=_watcher(hot_swap, root, ingest_delay=0),
                        watchdog_timeout=0.5, rollback_window=1)
    assert len(out) == len(rows) and all("error" not in r for r in out)
    assert stats["swaps"] == stats["swap_commits"] == 1
    assert stats["watchdog_fires"] >= 1 and stats["rollbacks"] == 0
    assert stats["weight_generation"] == 1


def test_wedge_inside_probation_rolls_back(trees, tmp_path, monkeypatch):
    monkeypatch.delenv(chaos.TFOS_CHAOS_PLAN, raising=False)

    class WedgeOnce(object):
        fired = 0

        def __call__(self, chunk_index):
            if self.fired == 0 and chunk_index >= 1:
                self.fired += 1
                time.sleep(1.0)

    rows = _rows([4, 7, 5, 9])
    pred = _port(trees[0], max_new=8, chunk_size=2)
    ref, _ = _serve(serving, pred, rows)
    root = str(tmp_path / "pub")
    ckpt.publish_for_serving(root, 1, trees[1])
    watcher = _watcher(hot_swap, root)
    stats = {}
    eng = serving_engine.ServingEngine(
        pred, {"prompt": "tokens"}, num_slots=2, watchdog_timeout=0.5,
        wedge_fn=WedgeOnce(), stats=stats, watcher=watcher,
        rollback_window=100)
    out = list(eng.serve([dict(r) for r in rows]))
    assert all("error" not in r for r in out) and len(out) == 4
    assert stats["swaps"] == stats["rollbacks"] == 1
    assert stats["weight_generation"] == 0
    assert watcher.quarantined[-1]["kind"] == "rollback"
    assert [e["event"] for e in stats["swap_events"]] == ["swap", "rollback"]
    # requests admitted after the rollback are the old generation's
    after = [i for i in range(4)
             if i not in stats["swap_events"][1]["requeued"]
             and i not in stats["swap_events"][0]["requeued"]]
    for i in after:
        if i >= 2:
            assert _tokens(out)[i] == _tokens(ref)[i]


# ----------------------------------------------------------------------
# exports crossing between the packages, and the entry points
# ----------------------------------------------------------------------


def test_jax_export_swaps_into_the_port(trees, tmp_path):
    rows = _rows([4, 7, 5, 9])
    want, _ = _serve(jserving, _jax(trees[1], chunk_size=2), rows)
    src = jckpt.publish_for_serving(str(tmp_path / "jax"), 3, trees[1])
    root = str(tmp_path / "port")
    convert_jax_export.convert(src, os.path.join(root, "3"))
    out, stats = _serve(serving, _port(trees[0], chunk_size=2), rows,
                        watcher=_watcher(hot_swap, root))
    assert stats["swaps"] == 1 and _tokens(out) == _tokens(want)


def test_port_export_swaps_into_jax(trees, tmp_path):
    rows = _rows([4, 7, 5, 9])
    root = str(tmp_path / "pub")
    ckpt.publish_for_serving(root, 4, trees[1])
    want, ws = _serve(jserving, _jax(trees[0], chunk_size=2), rows,
                      watcher=_watcher(jhot, root))
    got, gs = _serve(serving, _port(trees[0], chunk_size=2), rows,
                     watcher=_watcher(hot_swap, root))
    assert ws["swaps"] == gs["swaps"] == 1
    assert _tokens(got) == _tokens(want)


def test_predict_rows_checkpoint_dir_and_the_cli(trees, tmp_path):
    from tensorflowonspark_tpu_torch.data import interchange

    rows = _rows([4, 7, 5])
    root = str(tmp_path / "pub")
    ckpt.publish_for_serving(root, 2, trees[1])
    export = str(tmp_path / "export")
    ckpt.save_for_serving(export, trees[0], extra_metadata={
        "model_ref": "tensorflowonspark_tpu.models.transformer:"
                     "serving_builder",
        "model_config": dict(_cfg(chunk_size=2), device="cpu")})
    pred = serving.load_predictor(export, use_cache=False)
    ref_a, _ = _serve(serving, pred, rows)
    # the engine builds, binds and closes its own background watcher,
    # whose first scan comes one poll interval (5 s) in: this short job
    # ends on the old weights
    out, stats = _serve(serving, pred, rows, checkpoint_dir=root)
    assert _tokens(out) == _tokens(ref_a) and stats["swaps"] == 0
    inp, dst = str(tmp_path / "in"), str(tmp_path / "out")
    interchange.save_as_tfrecords(rows, inp)
    assert serving.main([
        "--export_dir", export, "--input", inp, "--input_mapping",
        "prompt=tokens", "--output", dst, "--batch_size", "2",
        "--schedule", "continuous", "--checkpoint_dir", root,
        "--checkpoint_poll", "0.01"]) == 3
    assert hot_swap.read_quarantine(os.path.join(root, "2")) is None


def test_set_checkpoint_dir_serves_with_hot_swap(trees, tmp_path,
                                                 monkeypatch):
    rows = _rows([4, 7, 5])
    want, _ = _serve(jserving, _jax(trees[1], chunk_size=2), rows)
    root = str(tmp_path / "pub")
    ckpt.publish_for_serving(root, 2, trees[1])
    export = str(tmp_path / "export")
    ckpt.save_for_serving(export, trees[0], extra_metadata={
        "model_ref": "tensorflowonspark_tpu.models.transformer:"
                     "serving_builder",
        "model_config": dict(_cfg(chunk_size=2), device="cpu")})

    class Synchronous(hot_swap.CheckpointWatcher):
        def __init__(self, root, **kw):
            kw.update(poll_interval=0.0, background=False)
            super().__init__(root, **kw)

    monkeypatch.setattr(hot_swap, "CheckpointWatcher", Synchronous)
    model = (tpl.TFModel().setExportDir(export).setInputMapping(
        {"prompt": "tokens"}).setBatchSize(2).setSchedule("continuous")
        .setCheckpointDir(root))
    assert model.getCheckpointDir() == root
    tpl._TRANSFORM_STATE.update(key=None, predict=None)
    out = tpl._run_model([dict(r) for r in rows], model.merge_args_params())
    assert _tokens(out) == _tokens(want)
