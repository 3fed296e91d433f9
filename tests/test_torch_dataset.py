"""The port's ``data/dataset.Dataset`` against the JAX package's, on the
CPU: the cases of the reference's ``tests/test_dataset.py``, each chain
run through both packages on the same numpy columns, batch for batch
(same rows, same order, same dtypes); where the reference raises, the
port raises the same error class with the same message."""

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu.data import interchange as jic
from tensorflowonspark_tpu.data.dataset import Dataset as JDataset
from tensorflowonspark_tpu_torch.data import interchange as tic
from tensorflowonspark_tpu_torch.data.dataset import Dataset as TDataset

PACKAGES = {"jax": JDataset, "torch": TDataset}


def _columns(n=20):
    return dict(x=np.arange(n * 2, dtype=np.float32).reshape(n, 2),
                y=np.arange(n, dtype=np.int64))


def _double(batch):
    return {"x2": batch["x"] * 2, "y": batch["y"]}


#: name -> (rows, chain applied to a fresh Dataset)
CHAINS = {
    "batch_drop": (10, lambda d: d.batch(4)),
    "batch_keep": (10, lambda d: d.batch(4, drop_remainder=False)),
    "in_order": (8, lambda d: d.batch(4)),
    "shuffle_two_epochs": (16, lambda d: d.shuffle(seed=1).repeat(2)
                           .batch(16)),
    "shuffle_seed_7": (23, lambda d: d.shuffle(seed=7).repeat(3).batch(5)),
    "repeat": (12, lambda d: d.repeat(3).batch(4)),
    "shard_0": (10, lambda d: d.shard(2, 0).batch(5)),
    "shard_1_of_3": (10, lambda d: d.shard(3, 1).batch(3)),
    "map": (8, lambda d: d.batch(4).map(_double)),
    "shard_shuffle_map": (30, lambda d: d.shard(3, 2).shuffle(seed=5)
                          .repeat(2).batch(4, drop_remainder=False)
                          .map(_double)),
}


def _run(package, n, chain):
    ds = chain(PACKAGES[package].from_arrays(**_columns(n)))
    return ds, list(ds)


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            g_k = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            w_k = np.asarray(w[k])
            assert g_k.dtype == w_k.dtype, k
            np.testing.assert_array_equal(g_k, w_k)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_batches_match_jax(name):
    n, chain = CHAINS[name]
    jds, want = _run("jax", n, chain)
    tds, got = _run("torch", n, chain)
    assert_batches_equal(got, want)
    assert tds.num_rows == jds.num_rows
    assert tds.steps_per_epoch() == jds.steps_per_epoch()


def test_shuffle_reshuffles_every_epoch():
    _, got = _run("torch", 16, CHAINS["shuffle_two_epochs"][1])
    assert not np.array_equal(got[0]["y"], got[1]["y"])
    assert sorted(got[0]["y"]) == sorted(got[1]["y"]) == list(range(16))


def test_steps_per_epoch_with_explicit_batch_size():
    for cls in PACKAGES.values():
        assert cls.from_arrays(**_columns(12)).steps_per_epoch(5) == 2


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raise", type(e).__name__, str(e))


#: name -> fn(Dataset class) that the reference makes raise
ERRORS = {
    "no_batch": lambda D: list(D.from_arrays(**_columns())),
    "bad_shard": lambda D: D.from_arrays(**_columns()).shard(2, 2),
    "unequal_columns": lambda D: D.from_arrays(a=np.zeros(3),
                                               b=np.zeros(4)),
    "sub_batch": lambda D: next(iter(
        D.from_arrays(x=np.zeros(3)).repeat(None).batch(8))),
    "empty": lambda D: next(iter(D.from_arrays(x=np.zeros(0)).repeat(None)
                                 .batch(8, drop_remainder=False))),
    "no_batch_size": lambda D: D.from_arrays(**_columns()).steps_per_epoch(),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_errors_match_jax(name):
    want = _outcome(lambda: ERRORS[name](JDataset))
    assert want[0] == "raise"
    assert _outcome(lambda: ERRORS[name](TDataset)) == want


def test_short_batch_kept_without_drop():
    out = list(TDataset.from_arrays(x=np.zeros(3)).batch(
        8, drop_remainder=False))
    assert out[0]["x"].shape == (3,)


@pytest.mark.parametrize("shard", [None, (2, 0), (2, 1), (3, 2)])
def test_from_tfrecords_matches_jax(tmp_path, shard):
    rng = np.random.default_rng(0)
    rows = [{"feat": rng.standard_normal(4).astype(np.float32),
             "tokens": rng.integers(0, 32000, 16).astype(np.int32),
             "label": i} for i in range(27)]
    path = str(tmp_path / "recs")
    tic.save_as_tfrecords(rows, path, num_shards=3)
    columns = {"feat": ("float32", 4), "tokens": ("int32", 16),
               "label": ("int64", 1)}
    want = JDataset.from_tfrecords(path, columns, shard=shard)
    got = TDataset.from_tfrecords(path, columns, shard=shard)
    assert got.num_rows == want.num_rows
    assert_batches_equal(list(got.shuffle(seed=3).batch(4)),
                         list(want.shuffle(seed=3).batch(4)))
    batch = next(iter(got.batch(got.num_rows)))
    assert batch["label"].shape == (got.num_rows,)  # width 1 squeezed
    assert batch["tokens"].dtype == np.int32


def test_from_tfrecords_bad_shard_matches_jax(tmp_path):
    path = str(tmp_path / "recs")
    jic.save_as_tfrecords([{"x": 1}], path)
    columns = {"x": ("int64", 1)}
    want = _outcome(lambda: JDataset.from_tfrecords(path, columns, (2, 2)))
    assert want[0] == "raise"
    assert _outcome(lambda: TDataset.from_tfrecords(path, columns,
                                                    (2, 2))) == want


def test_prefetch_places_batches_on_the_cpu():
    ds = TDataset.from_arrays(**_columns(8)).batch(4)
    want = list(JDataset.from_arrays(**_columns(8)).batch(4))
    out = list(ds.prefetch(size=2, sharding="cpu"))
    assert len(out) == 2
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for b in out for v in b.values())
    assert_batches_equal(out, want)


def test_prefetch_without_a_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        next(iter(TDataset.from_arrays(**_columns(8)).batch(4).prefetch()))
