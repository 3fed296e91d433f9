"""The port's feed plane against the JAX package's, on the CPU.

The same scripted queue items (rows, ``Block``s, ``ColumnarBlock``s,
``EndPartition`` and the ``None`` end-of-feed sentinel, each built from
its own package's marker classes) go into a reference queue manager +
``DataFeed`` and into the port's; the outputs must be equal exactly,
array dtypes included.  The cases are those of ``tests/test_datafeed.py``.

Then the tiny Transformer of ``tests/test_torch_train.py`` trains from
one Flax tree through the JAX ``SyncTrainer.train_on_feed`` and the
port's, each on an identical feed: per-step losses held at rtol 1e-5 and
the final weights at atol 1e-5, the tolerances of the three-step SGD
trajectory test there (the same f32 arithmetic in another summation
order).  The port runs at ``device="cpu"`` with ``attention_impl=
"flash"``, which takes the plain versions of K2-K4 there; the JAX side
runs the Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.cluster import manager as jmanager
from tensorflowonspark_tpu.cluster import marker as jmarker
from tensorflowonspark_tpu.data import feed as jfeed
from tensorflowonspark_tpu_torch import convert, optim
from tensorflowonspark_tpu_torch.cluster import manager as tmanager
from tensorflowonspark_tpu_torch.cluster import marker as tmarker
from tensorflowonspark_tpu_torch.data import feed as tfeed
from tensorflowonspark_tpu_torch.models import transformer as ttr
from tensorflowonspark_tpu_torch.parallel import dp

PACKAGES = {"jax": (jmanager, jmarker, jfeed),
            "torch": (tmanager, tmarker, tfeed)}


@pytest.fixture()
def mgrs():
    started = {}
    for name, (mgr_mod, _, _) in PACKAGES.items():
        started[name], _ = mgr_mod.start(
            b"key-" + name.encode(), ["input", "output", "error"])
    yield started
    for m in started.values():
        m.shutdown()


def _build(marker, spec):
    """One queue item from a package-neutral spec."""
    kind = spec[0]
    if kind == "row":
        return spec[1]
    if kind == "block":
        return marker.Block(spec[1])
    if kind == "cblock":
        return marker.pack_columnar(spec[1])
    if kind == "end":
        return marker.EndPartition()
    assert kind == "eof"
    return None


def _drive(name, mgr, script, calls, input_mapping=None):
    """Feed ``script`` into ``mgr``'s input queue, run ``calls`` on a
    fresh DataFeed, and return their outputs."""
    _, marker, feed_mod = PACKAGES[name]
    q = mgr.get_queue("input")
    for spec in script:
        q.put(_build(marker, spec))
    feed = feed_mod.DataFeed(mgr, input_mapping=input_mapping)
    out = []
    for call in calls:
        if call[0] == "batches":
            out.append(list(feed.batches(call[1], **call[2])))
        else:
            out.append(getattr(feed, call[0])(*call[1:]))
    return out


def assert_same(got, want, where="out"):
    """Exact equality through lists, tuples and dicts; arrays and numpy
    scalars also by dtype."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, np.ndarray) or isinstance(want, np.generic):
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], "{0}[{1!r}]".format(where, k))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, "{0}[{1}]".format(where, i))
    else:
        assert got == want, where


def _f32(i):
    return np.float32(i)


ROWS_F3 = [(np.full(3, i, np.float32), np.int64(i)) for i in range(10)]

FEED_CASES = {
    "next_batch": (
        [("row", [1, 2]), ("row", [3, 4]), ("row", [5, 6]), ("eof",)],
        [("next_batch", 2), ("should_stop",), ("next_batch", 2),
         ("should_stop",)], None),
    "next_batch_input_mapping": (
        [("row", [0, 10]), ("row", [1, 11]), ("eof",)],
        [("next_batch", 4), ("should_stop",)], {"x": "inp", "y": "label"}),
    "next_batch_end_partition": (
        [("row", [1]), ("row", [2]), ("end",), ("row", [3]), ("eof",)],
        [("next_batch", 10), ("next_batch", 10), ("should_stop",)], None),
    "block_end_partition": (
        [("block", [[1], [2], [3]]), ("end",), ("block", [[4], [5]]),
         ("eof",)],
        [("next_batch", 10), ("next_batch", 10), ("should_stop",)], None),
    "block_spans_batches": (
        [("block", [[i] for i in range(10)]), ("eof",)],
        [("next_batch", 4)] * 3 + [("should_stop",)], None),
    "block_input_mapping": (
        [("block", [[0, 10], [1, 11]]), ("eof",)],
        [("next_batch", 4)], {"x": "a", "y": "b"}),
    "next_batch_unpacks_columnar": (
        [("cblock", list(range(5))), ("eof",)], [("next_batch", 10)], None),
    "next_arrays_columnar": (
        [("cblock", ROWS_F3[:6]), ("cblock", ROWS_F3[6:]), ("eof",)],
        [("next_arrays", 4)] * 3 + [("should_stop",), ("next_arrays", 4)],
        None),
    "next_arrays_mixed_rows_and_columnar": (
        [("cblock", [(_f32(i), _f32(2 * i)) for i in range(4)]),
         ("block", [(_f32(i), _f32(2 * i)) for i in range(4, 8)]),
         ("eof",)],
        [("next_arrays", 8)], None),
    "next_arrays_input_mapping": (
        [("cblock", [(_f32(i), _f32(10 + i)) for i in range(4)]),
         ("eof",)],
        [("next_arrays", 4)], {"x": "inp", "y": "label"}),
    "next_arrays_dict_rows_input_mapping": (
        [("cblock", [{"a": _f32(i), "b": _f32(10 + i), "junk": _f32(0)}
                     for i in range(4)]), ("eof",)],
        [("next_arrays", 4)], {"a": "inp", "b": "label"}),
    "next_arrays_end_partition": (
        [("cblock", ROWS_F3[:3]), ("end",), ("cblock", ROWS_F3[3:5]),
         ("eof",)],
        [("next_arrays", 4), ("next_arrays", 4), ("next_arrays", 4)], None),
    "batches_stack_and_pad": (
        [("row", [i, 2 * i]) for i in range(5)] + [("eof",)],
        [("batches", 2, {"pad_to_batch": True})], None),
    "batches_stack_array_rows": (
        [("block", [np.arange(3, dtype=np.int32) + i for i in range(5)]),
         ("eof",)],
        [("batches", 2, {})], None),
}


@pytest.mark.parametrize("case", sorted(FEED_CASES))
def test_datafeed_matches_jax(mgrs, case):
    script, calls, mapping = FEED_CASES[case]
    want = _drive("jax", mgrs["jax"], script, calls, mapping)
    got = _drive("torch", mgrs["torch"], script, calls, mapping)
    assert_same(got, want)


def test_batch_results_matches_jax(mgrs):
    for name, mgr in mgrs.items():
        PACKAGES[name][2].DataFeed(mgr).batch_results([7, 8, 9])
    blocks = {name: mgr.get_queue("output").get()
              for name, mgr in mgrs.items()}
    assert isinstance(blocks["torch"], tmarker.Block)
    assert blocks["torch"].items == blocks["jax"].items == [7, 8, 9]


def test_terminate_matches_jax(mgrs):
    for name, mgr in mgrs.items():
        q = mgr.get_queue("input")
        for i in range(3):
            q.put([i])
        PACKAGES[name][2].DataFeed(mgr).terminate()
        assert mgr.get("state")._getvalue() == "terminating"
        q.join()  # drained: returns at once


PACK_CASES = {
    "tuple_rows": [(np.arange(4, dtype=np.float32) + i, i) for i in range(6)],
    "dict_rows": [{"a": i, "b": [i, i]} for i in range(3)],
    "scalar_rows": [1, 2, 3],
    "list_rows": [[1, 2], [3, 4]],
    "ragged": [[1, 2], [3]],
    "mixed_int_float": [(1, 0), (2.5, 1)],
    "mixed_array_dtypes": [(np.array([1, 2]),), (np.array([1.5, 2.5]),)],
    "same_array_dtype": [(np.array([1, 2]),), (np.array([3, 4]),)],
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_columnar_matches_jax(case):
    rows = PACK_CASES[case]
    want = jmarker.pack_columnar(rows)
    got = tmarker.pack_columnar(rows)
    if want is None:
        assert got is None
        return
    assert type(got) is tmarker.ColumnarBlock
    assert got.count == want.count
    assert (got._scalar, got._list_rows) == (want._scalar, want._list_rows)
    assert_same(got.columns, want.columns)
    assert_same(got.rows(), want.rows())


# ----------------------------------------------------------------------
# train_on_feed against the JAX package's
# ----------------------------------------------------------------------

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=64,
            dtype="float32", attention_impl="flash")
B, S, N_BATCHES = 2, 64, 7


def tiny_tree(seed=0):
    """The Flax tree of the tiny Transformer, as numpy leaves."""
    import jax
    import jax.numpy as jnp

    from tensorflowonspark_tpu.models import transformer as jtr

    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def token_rows(n_rows, seed=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, TINY["vocab_size"], (n_rows, S)).astype(np.int32)
    return [{"tokens": t} for t in tokens]


def _record_losses(trainer, losses):
    """Wrap the trainer's step entry points so every step's loss is kept
    (``train_on_feed`` hands its callback only a group's last one)."""
    one, many = trainer.step_on_device, trainer.multi_step_on_device

    def step_on_device(*a):
        state, metrics = one(*a)
        losses.append(np.asarray(metrics["loss"], np.float64).reshape(1))
        return state, metrics

    def multi_step_on_device(*a):
        state, metrics = many(*a)
        losses.append(np.asarray(metrics["loss"], np.float64).reshape(-1))
        return state, metrics

    trainer.step_on_device = step_on_device
    trainer.multi_step_on_device = multi_step_on_device


def jax_train_on_feed(mgr, items, tree, **kw):
    """The JAX package's ``train_on_feed`` of the tiny Transformer on
    ``items`` fed into ``mgr``: ``(per-step losses, params, steps)``."""
    import jax
    import optax

    from tensorflowonspark_tpu.models import transformer as jtr
    from tensorflowonspark_tpu.parallel import dp as jdp
    from tensorflowonspark_tpu.parallel.mesh import build_mesh

    q = mgr.get_queue("input")
    for item in items:
        q.put(item)
    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    trainer = jdp.SyncTrainer(jtr.loss_fn(model),
                              optax.sgd(0.05, momentum=0.9),
                              mesh=build_mesh(devices=jax.devices()[:1]))
    losses = []
    _record_losses(trainer, losses)
    state = trainer.create_state(jax.tree.map(np.asarray, tree))
    state = trainer.train_on_feed(state, jfeed.DataFeed(mgr), **kw)
    return (np.concatenate(losses), jax.tree.map(np.asarray, state.params),
            int(state.step))



def port_trainer(tree, device="cpu"):
    model = convert.params_from_flax(tree, ttr.TransformerConfig(**TINY),
                                     device=device,
                                     param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.sgd(0.05,
                                                           momentum=0.9))
    return model, trainer, trainer.create_state(
        dict(model.named_parameters()))


def port_train_on_feed(mgr, items, tree, **kw):
    q = mgr.get_queue("input")
    for item in items:
        q.put(item)
    model, trainer, state = port_trainer(tree)
    losses = []
    _record_losses(trainer, losses)
    state = trainer.train_on_feed(state, tfeed.DataFeed(mgr), **kw)
    return (np.concatenate(losses), convert.tree_from_model(model),
            int(state.step))


def assert_trajectories_match(got_losses, got_params, want_losses,
                              want_params):
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    want, got = convert._flatten(want_params), convert._flatten(got_params)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5, rtol=0,
                                   err_msg=path)


@pytest.mark.parametrize("spe,max_steps", [(1, None), (3, None), (3, 4)],
                         ids=["spe1", "spe3", "spe3_max_steps4"])
@pytest.mark.parametrize("columnar", [False, True], ids=["rows", "columnar"])
def test_train_on_feed_matches_jax(mgrs, columnar, spe, max_steps):
    tree = tiny_tree()
    rows = token_rows(N_BATCHES * B)
    kw = dict(batch_size=B, steps_per_execution=spe, max_steps=max_steps,
              columnar=columnar)
    results = {}
    for name, run in (("jax", jax_train_on_feed),
                      ("torch", port_train_on_feed)):
        marker = PACKAGES[name][1]
        # blocks of 5 rows: batches of 2 straddle them
        chunks = [rows[i:i + 5] for i in range(0, len(rows), 5)]
        items = [marker.pack_columnar(c) if columnar else marker.Block(c)
                 for c in chunks] + [None]
        results[name] = run(mgrs[name], items, tree, **kw)
    want_steps = N_BATCHES if max_steps is None else max_steps
    assert results["jax"][2] == results["torch"][2] == want_steps
    assert len(results["torch"][0]) == want_steps
    assert_trajectories_match(*results["torch"][:2], *results["jax"][:2])
    if max_steps is not None:
        # the step cap terminated the feed with data in flight, in both
        for mgr in mgrs.values():
            assert mgr.get("state")._getvalue() == "terminating"
            mgr.get_queue("input").join()


def test_train_on_feed_rejects_checkpointer():
    trainer = dp.SyncTrainer(lambda p, b, r: 0.0, optim.sgd(0.1))
    with pytest.raises(NotImplementedError, match="Checkpointing"):
        trainer.train_on_feed(None, None, 8, checkpointer=object())


def test_all_hosts_ready_at_world_size_one():
    assert not torch.distributed.is_initialized()
    assert dp.all_hosts_ready(True) is True
    assert dp.all_hosts_ready(False) is False
