"""The port's checkpoints and serving exports against the JAX package's,
on the CPU.

- Exports cross between the packages both ways: the port writes and the
  JAX package's ``load_for_serving`` reads every leaf back to the bit;
  the JAX package writes (OCDBT, zstd), ``convert_jax_export.py``
  rewrites it, and the port reads it to the bit.  The raw OCDBT export
  and compressed chunks are refused with a ``ValueError`` naming the tool.
- The reference's atomicity tests (``tests/test_checkpoint.py``),
  mirrored on the port's functions.
- ``Checkpointer``: round trips of a ``TrainState`` (weights, AdamW's
  moments and count, SGD's momentum), orbax's retention and
  save-interval rules held against the JAX package's ``Checkpointer``
  on the same step sequences, the host copy taken before an async save
  returns, and two gloo ranks (rank 0 writes, both restore).
- ``train_on_feed(checkpointer=)``: the reference's resume-hook test on
  both packages (same steps and kept steps; the same commits but one at
  the exit of a run that ended on a periodic save, ROADMAP C4); a tiny
  Transformer trained 4 steps, checkpointed and resumed by a fresh
  trainer for 3 more equals 7 straight steps to the bit (SGD and
  AdamW), and the JAX trainer's 7 steps at rtol 1e-5 (losses) and atol
  1e-5 (weights), the tolerances of ``tests/test_torch_feed.py``; a
  crash and a resume through ``cluster.run``.
"""

import os
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import convert_jax_export  # noqa: E402
import torch_dist_workers as workers  # noqa: E402
from tensorflowonspark_tpu import checkpoint as jck  # noqa: E402
from tensorflowonspark_tpu_torch import checkpoint as tck  # noqa: E402
from tensorflowonspark_tpu_torch import convert, optim  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.parallel import dp  # noqa: E402
from test_torch_feed import (  # noqa: E402
    B, TINY, assert_trajectories_match, tiny_tree, token_rows,
)


def _bits(x):
    """A leaf as comparable numpy bits: bf16 (ml_dtypes or torch) as its
    uint16 pattern, everything else as it is."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_same_bits(got, want):
    got, want = convert._flatten(got), convert._flatten(want)
    assert set(got) == set(want)
    for path in want:
        g, w = _bits(got[path]), _bits(want[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def _leaf(kind, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return rng.standard_normal((3, 4)).astype(np.float32)
    if kind == "bf16":
        return np.asarray(jnp.asarray(rng.standard_normal((2, 5)),
                                      jnp.bfloat16))
    if kind == "int8":
        return rng.integers(-128, 128, (4, 3)).astype(np.int8)
    if kind == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, (7,)).astype(np.int32)
    if kind == "0d":
        return np.asarray(np.float32(0.5))
    assert kind == "scalar"
    return np.float32(-2.25)


LEAF_KINDS = ["f32", "bf16", "int8", "int32", "0d", "scalar"]


def _tree(kind):
    return {"block_0": {"attn": {"q": {"kernel": _leaf(kind)}}},
            "ln_f": {"scale": _leaf("f32", seed=2)}, "x": _leaf(kind, 3)}


# ----------------------------------------------------------------------
# (a) the port writes, the JAX package reads
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", LEAF_KINDS)
def test_port_export_loads_in_the_jax_package(tmp_path, kind):
    tree = _tree(kind)
    out = tck.save_for_serving(tmp_path / "export", tree,
                               extra_metadata={"note": kind, "n": [1, 2]},
                               step=4)
    got, meta = jck.load_for_serving(out)
    assert meta == {"note": kind, "n": [1, 2]}
    want = jax.tree.map(np.asarray, tree)
    _assert_same_bits(jax.tree.map(np.asarray, got), want)
    manifest = tck.read_manifest(out)
    assert manifest["step"] == 4 and manifest["complete"] is True
    assert manifest["params"] == jck.param_manifest(tree)
    assert tck.param_manifest(tree) == jck.param_manifest(tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_exports_tensors(tmp_path, dtype):
    """Tensor leaves (a model's, e.g.) are written by value, bf16 as
    bf16, and censused with numpy's dtype names."""
    t = torch.linspace(-3, 3, 12, dtype=dtype).reshape(3, 4)
    out = tck.save_for_serving(tmp_path / "e", {"w": t})
    got, _ = jck.load_for_serving(out)
    _assert_same_bits({"w": np.asarray(got["w"])}, {"w": t})
    name = str(dtype).replace("torch.", "")
    assert tck.read_manifest(out)["params"] == {
        "['w']": {"shape": [3, 4], "dtype": name}}
    back, _ = tck.load_for_serving(out)
    assert isinstance(back["w"], torch.Tensor if dtype == torch.bfloat16
                      else np.ndarray)
    _assert_same_bits(back, {"w": t})


def test_port_census_of_a_flax_tree_matches_the_reference():
    tree = tiny_tree()
    assert tck.param_manifest(tree) == jck.param_manifest(tree)


# ----------------------------------------------------------------------
# (b) the JAX package writes, the port reads (after the tool)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", LEAF_KINDS)
def test_converted_jax_export_loads_in_the_port(tmp_path, kind):
    tree = _tree(kind)
    src = jck.save_for_serving(tmp_path / "jax", tree,
                               extra_metadata={"model_ref": "m:b"}, step=9)
    with pytest.raises(ValueError, match="convert_jax_export.py"):
        tck.load_for_serving(src)
    dst = str(tmp_path / "port")
    assert convert_jax_export.main([str(src), dst]) == 0
    got, meta = tck.load_for_serving(dst)
    assert meta == {"model_ref": "m:b"}
    assert tck.read_manifest(dst)["step"] == 9
    _assert_same_bits(got, jax.tree.map(np.asarray, tree))


def test_compressed_chunks_are_refused(tmp_path):
    """orbax without OCDBT still zstd-compresses each chunk."""
    import orbax.checkpoint as ocp

    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False))
    ckptr.save(str(tmp_path / "e" / "params"), _tree("f32"))
    with pytest.raises(ValueError, match="compressed.*convert_jax_export"):
        tck.load_for_serving(tmp_path / "e")


def test_remote_uri_is_refused():
    with pytest.raises(NotImplementedError, match="remote checkpoint URIs"):
        tck.load_for_serving("gs://bucket/export")
    with pytest.raises(NotImplementedError, match="remote checkpoint URIs"):
        tck.Checkpointer("s3://bucket/ckpt")


# ----------------------------------------------------------------------
# (c) the reference's atomicity tests, on the port
# ----------------------------------------------------------------------


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(8, 4).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}


def test_export_carries_complete_manifest(tmp_path):
    out = tck.save_for_serving(tmp_path / "export", _params(), step=3)
    m = tck.read_manifest(out)
    assert m["complete"] is True and m["step"] == 3
    assert set(m["params"]) == set(tck.param_manifest(_params()))


def test_reader_polling_mid_save_never_sees_torn_step(tmp_path):
    root = str(tmp_path / "pub")
    stop = threading.Event()
    failures, observed = [], set()

    def poller():
        while not stop.is_set():
            for step in tck.list_serving_steps(root):
                observed.add(step)
                step_dir = os.path.join(root, str(step))
                m = tck.read_manifest(step_dir)
                if not (m and m.get("complete")):
                    failures.append((step, "manifest", m))
                    continue
                try:
                    params, _ = tck.load_for_serving(step_dir)
                    if tck.param_manifest(params) != m["params"]:
                        failures.append((step, "census", None))
                except Exception as e:  # noqa: BLE001 - a torn read
                    failures.append((step, "load", repr(e)))

    t = threading.Thread(target=poller, daemon=True)
    t.start()
    try:
        for step in (1, 2, 3):
            tck.publish_for_serving(root, step, _params(step))
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert not failures, failures[:3]
    assert observed


def test_mid_save_staging_is_invisible(tmp_path):
    root = str(tmp_path / "pub")
    tck.publish_for_serving(root, 1, _params())
    staging = os.path.join(root, "2.tmp-999")
    os.makedirs(os.path.join(staging, "params"))
    assert tck.list_serving_steps(root) == [1]
    os.rename(staging, os.path.join(root, "2"))
    assert tck.list_serving_steps(root) == [1]


def test_publish_then_read_manifest_roundtrip(tmp_path):
    root = str(tmp_path / "pub")
    p = _params(7)
    step_dir = tck.publish_for_serving(root, 12, p,
                                       extra_metadata={"note": "hi"})
    loaded, meta = tck.load_for_serving(step_dir)
    assert meta["note"] == "hi"
    np.testing.assert_array_equal(loaded["w"], p["w"])
    assert tck.list_serving_steps(root) == [12]
    # republishing a step replaces it whole
    tck.publish_for_serving(root, 12, _params(8))
    np.testing.assert_array_equal(
        tck.load_for_serving(step_dir)[0]["w"], _params(8)["w"])
    assert sorted(os.listdir(root)) == ["12"]


# ----------------------------------------------------------------------
# (d) Checkpointer
# ----------------------------------------------------------------------


def _trained(opt, steps=2, seed=0):
    """The tiny Transformer (seed-``seed`` tree) and a state after
    ``steps`` steps of ``opt``."""
    model = convert.params_from_flax(
        convert.init_params_tree(ttr.TransformerConfig(**TINY), seed=seed),
        ttr.TransformerConfig(**TINY), device="cpu",
        param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), opt)
    state = trainer.create_state(dict(model.named_parameters()))
    tokens = np.random.default_rng(11).integers(0, 256, (steps, B, 64))
    for t in tokens:
        state, _ = trainer.step(state, {"tokens": t.astype(np.int32)})
    return model, trainer, state


def _opt_snapshot(state):
    tree = optim.state_tree(state.opt_state, state.params)
    return jax.tree.map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else np.array(x),
        tree)


OPTS = {"adamw": lambda: optim.adamw(1e-3),
        "sgd_momentum": lambda: optim.sgd(0.05, momentum=0.9)}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_checkpointer_round_trip(tmp_path, opt):
    model, _, state = _trained(OPTS[opt]())
    ck = tck.Checkpointer(tmp_path / "ck")
    assert ck.save(2, state, wait=True) is True
    want_params = convert.tree_from_model(model)
    want_opt = _opt_snapshot(state)

    model2, _, fresh = _trained(OPTS[opt](), steps=0, seed=5)
    restored = tck.Checkpointer(tmp_path / "ck").restore(fresh)
    assert int(restored.step) == 2 and restored.step.dtype == torch.int64
    # in place: the model's own tensors hold the restored weights
    assert restored.params["embedding"] is fresh.params["embedding"]
    _assert_same_bits(convert.tree_from_model(model2), want_params)
    got_opt = _opt_snapshot(restored)
    assert jax.tree.structure(got_opt) == jax.tree.structure(want_opt)
    for g, w in zip(jax.tree.leaves(got_opt), jax.tree.leaves(want_opt)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if opt == "adamw":
        assert int(got_opt["count"]) == 2
    ck.close()


def test_checkpointer_round_trip_of_a_dict_state(tmp_path):
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "meta": {"count": np.asarray(3, np.int64),
                      "h": torch.ones(4, dtype=torch.bfloat16)}}
    ck = tck.Checkpointer(tmp_path / "ck")
    ck.save(1, state, wait=True)
    like = {"w": torch.zeros(2, 3),
            "meta": {"count": np.asarray(0, np.int64),
                     "h": torch.zeros(4, dtype=torch.bfloat16)}}
    got = ck.restore(like)
    assert got["w"] is like["w"]
    _assert_same_bits(got, state)
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"w": torch.zeros(3, 2), "meta": like["meta"]})


# (max_to_keep, save_interval_steps, steps saved in turn)
RETENTION_CASES = {
    "keep2": (2, 1, [1, 2, 3, 4, 5]),
    "keep_all": (None, 1, [1, 2, 3]),
    "interval3": (3, 3, [1, 2, 3, 4, 5, 6, 7, 9, 10, 12]),
    "interval2_from_5": (2, 2, [5, 6, 7, 8, 8, 3, 10]),
    "repeat_and_lower": (3, 1, [4, 4, 2, 6]),
}


@pytest.mark.parametrize("case", sorted(RETENTION_CASES))
def test_retention_and_interval_match_the_reference(tmp_path, case):
    keep, interval, sequence = RETENTION_CASES[case]
    ref = jck.Checkpointer(tmp_path / "jax", max_to_keep=keep,
                           save_interval_steps=interval)
    port = tck.Checkpointer(tmp_path / "port", max_to_keep=keep,
                            save_interval_steps=interval)
    tree = {"w": np.zeros(2, np.float32)}
    for step in sequence:
        want = bool(ref.save(step, tree, wait=True))
        got = port.save(step, tree, wait=True)
        assert got == want, step
        assert port.all_steps() == ref.all_steps(), step
        assert port.latest_step() == ref.latest_step(), step
    ref.close()
    port.close()
    # a fresh Checkpointer sees what is on disk
    assert tck.Checkpointer(tmp_path / "port").all_steps() == ref.all_steps()
    assert sorted(int(n) for n in os.listdir(tmp_path / "port")) == \
        ref.all_steps()


def test_restore_missing_raises(tmp_path):
    _, _, state = _trained(optim.sgd(0.1), steps=0)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tck.Checkpointer(tmp_path / "empty").restore(state)


def test_async_save_copies_before_it_returns(tmp_path):
    """``save(wait=False)`` takes its host copy before it returns: an
    in-place update right after it (what the next step does) does not
    reach the checkpoint."""
    model, trainer, state = _trained(optim.adamw(1e-3))
    want = convert.tree_from_model(model)
    want_mu = {k: v.clone() for k, v in
               optim.state_tree(state.opt_state, state.params)["mu"].items()}
    ck = tck.Checkpointer(tmp_path / "ck")
    ck.save(2, state, wait=False)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
        for st in state.opt_state.state.values():
            st["mu"].mul_(-3.0)
    ck.wait_until_finished()
    model2, _, fresh = _trained(optim.adamw(1e-3), steps=0)
    restored = ck.restore(fresh)
    _assert_same_bits(convert.tree_from_model(model2), want)
    got_mu = optim.state_tree(restored.opt_state, restored.params)["mu"]
    for name, mu in want_mu.items():
        torch.testing.assert_close(got_mu[name], mu, rtol=0, atol=0)


def test_a_failed_write_raises_at_the_wait(tmp_path):
    ck = tck.Checkpointer(tmp_path / "ck")
    ck.save(1, {"a.b": np.zeros(2), "a": {"b": np.ones(2)}}, wait=False)
    with pytest.raises(FileExistsError):
        ck.wait_until_finished()
    assert tck.list_serving_steps(tmp_path / "ck") == []
    assert os.listdir(tmp_path / "ck") == []  # no staging left behind
    assert ck.latest_step() is None
    ck.save(1, {"a": np.ones(2)}, wait=True)
    assert ck.all_steps() == [1]


def test_two_gloo_ranks_rank0_writes_both_restore(tmp_path):
    out, ckpt_dir = tmp_path / "out", tmp_path / "ck"
    out.mkdir()
    workers.run_ranks(workers.checkpoint_worker, 2, tmp_path, str(out),
                      str(ckpt_dir))
    ranks = workers.load_ranks(str(out), "ckpt", 2)
    for r in ranks:
        # save(wait=True) returned on every rank after rank 0's commit
        assert r["on_disk"].tolist() == [2]
        assert int(r["step"]) == 2 and int(r["count"]) == 2
    saved = {k: v for k, v in ranks[0].items() if k.startswith("saved/")}
    for r in ranks:
        for k, v in saved.items():
            # the ranks trained one model (rank 0's start, reduced grads)
            np.testing.assert_array_equal(r[k], v, err_msg=k)
            np.testing.assert_array_equal(
                r["restored/" + k[len("saved/"):]], v, err_msg=k)
    assert [n for n in os.listdir(ckpt_dir)] == ["2"]


# ----------------------------------------------------------------------
# (e) the resume hook of train_on_feed
# ----------------------------------------------------------------------


class _FakeFeed(object):
    """A DataFeed stand-in serving the given batches of rows, then the
    end of the feed; counts partition commits (the reference suite's
    ``_FakeFeed``, with distinct batches)."""

    def __init__(self, batches):
        self.batches = list(batches)
        self.commits = 0
        self.done = False

    def should_stop(self):
        return self.done

    def next_batch(self, batch_size):
        if not self.batches:
            self.done = True
            return []
        return self.batches.pop(0)

    def commit_partitions(self):
        self.commits += 1
        return 0

    def terminate(self):
        pass


def _stack(rows):
    return {"tokens": np.stack([r["tokens"] for r in rows])}


def _feed_batches(first, last):
    rows = token_rows(7 * B)
    return [rows[i * B:(i + 1) * B] for i in range(first, last)]


def _hook_sequence(package, tmp_path):
    """The reference's ``test_auto_resume_and_commit_sequencing`` on one
    package: 4 batches with ``checkpoint_every=2``, then a fresh trainer
    over the same directory and 3 more."""
    cfg = dict(TINY, attention_impl="dot")
    out = []
    for batches in (_feed_batches(0, 4), _feed_batches(4, 7)):
        feed = _FakeFeed(batches)
        if package == "jax":
            from tensorflowonspark_tpu.models import transformer as jtr
            from tensorflowonspark_tpu.parallel import dp as jdp
            from tensorflowonspark_tpu.parallel.mesh import build_mesh

            model = jtr.Transformer(jtr.TransformerConfig(**cfg))
            trainer = jdp.SyncTrainer(
                jtr.loss_fn(model), optax.sgd(0.05),
                mesh=build_mesh(devices=jax.devices()[:1]))
            state = trainer.create_state(tiny_tree())
            cp = jck.Checkpointer(tmp_path / "jax")
        else:
            model = convert.params_from_flax(
                tiny_tree(), ttr.TransformerConfig(**cfg), device="cpu",
                param_dtype=torch.float32)
            trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.sgd(0.05))
            state = trainer.create_state(dict(model.named_parameters()))
            cp = tck.Checkpointer(tmp_path / "port")
        state = trainer.train_on_feed(
            state, feed, batch_size=B, preprocess=_stack, checkpointer=cp,
            checkpoint_every=2, log_every=0)
        out.append((int(state.step), feed.commits, cp.latest_step(),
                    list(cp.all_steps())))
        cp.close()
    return out


def test_resume_hook_steps_and_commits_match_the_reference(tmp_path):
    got = _hook_sequence("port", tmp_path)
    want = _hook_sequence("jax", tmp_path)
    # run 1 ends on a periodic save (step 4): the port commits once more
    # at exit, where the reference leaves later deliveries uncommitted
    # (ROADMAP C4); run 2 ends with a final save in both
    assert got == [(want[0][0], want[0][1] + 1) + want[0][2:], want[1]]
    assert got[0][0] == 4 and got[1][0] == 7  # resumed at 4, not from 0


def _losses_of(trainer):
    losses = []
    one = trainer.step_on_device

    def step_on_device(*a):
        state, metrics = one(*a)
        losses.append(metrics["loss"].item())
        return state, metrics

    trainer.step_on_device = step_on_device
    return losses


def _port_on_feed(opt, batches, **kw):
    model = convert.params_from_flax(
        tiny_tree(), ttr.TransformerConfig(**TINY), device="cpu",
        param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), OPTS[opt]())
    state = trainer.create_state(dict(model.named_parameters()))
    losses = _losses_of(trainer)
    feed = _FakeFeed(batches)
    state = trainer.train_on_feed(state, feed, batch_size=B, **kw)
    return losses, convert.tree_from_model(model), int(state.step), feed


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_resumed_training_equals_straight_training(tmp_path, opt):
    want_losses, want_params, steps, _ = _port_on_feed(
        opt, _feed_batches(0, 7))
    assert steps == 7
    ck = tck.Checkpointer(tmp_path / "ck")
    first, _, steps1, feed1 = _port_on_feed(
        opt, _feed_batches(0, 4), checkpointer=ck, checkpoint_every=4)
    # the periodic save at step 4 commits, and so does the exit
    assert steps1 == 4 and feed1.commits == 2 and ck.all_steps() == [4]
    ck2 = tck.Checkpointer(tmp_path / "ck")
    second, got_params, steps2, feed2 = _port_on_feed(
        opt, _feed_batches(4, 7), checkpointer=ck2, checkpoint_every=4)
    assert steps2 == 7 and feed2.commits == 1
    assert ck2.all_steps() == [4, 7]
    np.testing.assert_array_equal(first + second, want_losses)
    _assert_same_bits(got_params, want_params)
    if opt == "sgd_momentum":
        from tensorflowonspark_tpu.cluster import manager as jmanager

        from test_torch_feed import jax_train_on_feed

        mgr, _ = jmanager.start(b"ckpt-jax", ["input", "output", "error"])
        try:
            jax_losses, jax_params, jax_steps = jax_train_on_feed(
                mgr, token_rows(7 * B) + [None], tiny_tree(), batch_size=B)
        finally:
            mgr.shutdown()
        assert jax_steps == 7
        assert_trajectories_match(np.asarray(first + second), got_params,
                                  jax_losses, jax_params)


# ----------------------------------------------------------------------
# (f) a crash and a resume through the cluster
# ----------------------------------------------------------------------


def test_cluster_failure_then_resume(tmp_path):
    from tensorflowonspark_tpu_torch.cluster import cluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    args = {"dir": str(tmp_path / "ckpts"), "total_steps": 6, "fail_at": 3}
    for run_args in (args, dict(args, fail_at=None)):
        engine = LocalEngine(1)
        try:
            c = cluster.run(engine, workers.resumable_train_fn, run_args,
                            num_executors=1,
                            input_mode=cluster.InputMode.TENSORFLOW,
                            reservation_timeout=60)
            if run_args["fail_at"] is None:
                c.shutdown(timeout=60)
            else:
                with pytest.raises(RuntimeError, match="injected crash"):
                    c.shutdown(timeout=60)
                assert tck.Checkpointer(args["dir"]).latest_step() == 3
        finally:
            engine.stop()
    ck = tck.Checkpointer(args["dir"])
    assert ck.latest_step() == 6
    assert ck.all_steps() == [1, 2, 3, 4, 5, 6]
    # run 2 went on from run 1's weights: three steps, then three more on
    # batches drawn anew from the seed
    w = torch.zeros(2)
    for run in range(2):
        rng = np.random.RandomState(0)
        for _ in range(3):
            x = torch.from_numpy(rng.rand(16, 2).astype(np.float32))
            y = x @ torch.tensor([3.0, -1.0])
            w = w.detach().requires_grad_(True)
            loss = ((x @ w - y) ** 2).mean()
            (g,) = torch.autograd.grad(loss, [w])
            w = w - 0.05 * g
    np.testing.assert_allclose(
        np.load(os.path.join(args["dir"], "w-final.npy")),
        w.detach().numpy(), rtol=1e-6)


# ----------------------------------------------------------------------
# the elastic arguments of cluster.run
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{"elastic": True}, {"max_restarts": 1},
                                {"recovery_timeout": 5.0}],
                         ids=["elastic", "max_restarts", "recovery_timeout"])
def test_elastic_args_reach_the_cluster(kw):
    """Each argument lands where the reference's ``run`` puts it:
    ``elastic`` and ``max_restarts`` in ``cluster_meta`` (which every
    node's supervisor reads), ``elastic`` and ``recovery_timeout`` on the
    monitor; the others keep their defaults."""
    from tensorflowonspark_tpu_torch.cluster import cluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    want = dict({"elastic": False, "max_restarts": 3,
                 "recovery_timeout": 120.0}, **kw)
    engine = LocalEngine(1)
    try:
        c = cluster.run(engine, workers.idle_fn, num_executors=1,
                        reservation_timeout=60, **kw)
        c.shutdown(timeout=60)
    finally:
        engine.stop()
    assert c.cluster_meta["elastic"] is want["elastic"] is c.elastic
    assert c.cluster_meta["max_restarts"] == want["max_restarts"]
    assert c.monitor.elastic is want["elastic"]
    assert c.monitor.recovery_timeout == want["recovery_timeout"]


def test_no_restart_budget_fails_at_the_first_death(tmp_path):
    from tensorflowonspark_tpu_torch.cluster import cluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.testing import chaos

    plan = chaos.ChaosPlan().kill_worker(0, at_step=1)
    args = {"ckpt": str(tmp_path / "ckpt"), "keep": str(tmp_path),
            "log": str(tmp_path), "batch": 2}
    tokens = workers.elastic_tokens(0, 4, 2)
    engine = LocalEngine(1, env=plan.env(plan.save(tmp_path / "plan.json")))
    try:
        c = cluster.run(engine, workers.elastic_train_fn, args,
                        num_executors=1, elastic=True, max_restarts=0,
                        heartbeat_interval=0.5, reservation_timeout=60)
        with pytest.raises(RuntimeError,
                           match=r"died 1 times \(restart budget 0 "
                                 r"exhausted\)"):
            c.train([[{"tokens": r} for r in t] for t in tokens],
                    feed_timeout=60)
        assert c.server.generation == 0
        with pytest.raises(RuntimeError, match="restart budget 0 exhausted"):
            c.shutdown(timeout=60)
    finally:
        engine.stop()
