"""The port's on-device preprocessing, ``prefetch_to_device`` and
``SyncTrainer(device_preprocess=)`` against the JAX package's, on the CPU.

- ``make_preprocess`` against ``jax.jit`` of the reference's on the same
  numpy batches: casts exact (dtype and values), float transforms at rtol
  1e-6 (the same f32 operations in the same order); a 64-bit leaf
  passed through is compared in the 32-bit type JAX gives it.  The random flip
  draws from a ``torch.Generator`` where the reference splits a JAX key,
  so it is held by property: every row equal or mirrored, both seen,
  reproducible from a seed, skipped without a generator.
- ``prefetch_to_device`` with ``sharding="cpu"`` (the same pipeline as
  on the GPU without the copy stream): order, values and ``(batch, n)``
  against the reference's, preprocess after placement, error
  forwarding, abandonment without a hung thread; ``place_tree`` (the
  copy ``SyncTrainer._place`` shares) gives identical tensors.
- Three steps of the tiny Transformer on a ``uint16`` token wire widened
  by ``device_preprocess``: losses at rtol 1e-5 and weights at atol 1e-5
  against the JAX ``SyncTrainer(device_preprocess=)`` (the tolerance of
  ``test_torch_train.py``'s trajectories), and exactly equal to the
  port's own run on an int32 wire.
"""

import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import optax  # noqa: E402

from tensorflowonspark_tpu.data import feed as jfeed  # noqa: E402
from tensorflowonspark_tpu.data import preprocess as jpp  # noqa: E402
from tensorflowonspark_tpu.parallel import dp as jdp  # noqa: E402
from tensorflowonspark_tpu.parallel.mesh import build_mesh  # noqa: E402
from tensorflowonspark_tpu_torch import compat, convert, optim  # noqa: E402
from tensorflowonspark_tpu_torch.data import feed as tfeed  # noqa: E402
from tensorflowonspark_tpu_torch.data import preprocess as tpp  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.parallel import dp  # noqa: E402
from test_torch_train import TINY, _batches, _tree  # noqa: E402


def _pixels(shape=(4, 8, 8, 3), seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _numpy(tree):
    """A port or reference output as numpy, leaf by leaf."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def assert_tree_close(got, want, rtol):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)  # jax.jit returns sorted keys
        for k in want:
            assert_tree_close(got[k], want[k], rtol)
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_close(g, w, rtol)
    else:
        # JAX runs without 64-bit types: an int64/float64 leaf the
        # preprocess passes through comes back 32-bit there
        assert jax.dtypes.canonicalize_dtype(got.dtype) == want.dtype, (
            got.dtype, want.dtype)
        if rtol == 0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol)


MEAN = np.array([125.3, 123.0, 113.9], np.float32)
STD = np.array([63.0, 62.1, 66.7], np.float32)

#: name -> (make_preprocess kwargs, batch maker, rtol)
PRE_CASES = {
    "cast_uint8": ({}, lambda: _pixels(), 0),
    "cast_uint16_to_int32": (
        {"dtype": "int32"},
        lambda: np.arange(31990, 32006, dtype=np.uint16).reshape(2, 8), 0),
    "cast_int16_named_column": (
        {"dtype": "int32", "columns": ["t"]},
        lambda: {"t": np.array([[-5, 7]], np.int16)}, 0),
    "scale": ({"scale": 1.0 / 255.0}, lambda: _pixels(), 1e-6),
    "scale_offset": ({"scale": 2.0 / 255.0, "offset": -1.0},
                     lambda: _pixels(seed=2), 1e-6),
    "mean_std": ({"mean": MEAN, "std": STD}, lambda: _pixels(seed=1), 1e-6),
    "crop": ({"crop": (4, 6)}, lambda: _pixels((2, 8, 10, 3)), 0),
    "default_selects_narrow_only": (
        {"scale": 1.0 / 255.0},
        lambda: {"x": _pixels(), "y": np.arange(4, dtype=np.int64),
                 "w": np.full(4, 7.0, np.float32)}, 1e-6),
    "explicit_columns_dict": (
        {"columns": ["b"], "scale": 0.5},
        lambda: {"a": _pixels(seed=3), "b": _pixels(seed=4)}, 1e-6),
    "explicit_columns_tuple": (
        {"columns": [1], "dtype": "float32"},
        lambda: (_pixels(seed=5), np.arange(6, dtype=np.int8)), 0),
    "default_tuple": (
        {}, lambda: (np.arange(6, dtype=np.int8),
                     np.arange(3, dtype=np.int32)), 0),
}


@pytest.mark.parametrize("case", sorted(PRE_CASES))
def test_make_preprocess_matches_jax(case):
    kw, make, rtol = PRE_CASES[case]
    batch = make()
    want = _numpy(jax.jit(jpp.make_preprocess(**kw))(batch))
    got = _numpy(tpp.make_preprocess(**kw)(batch))
    assert_tree_close(got, want, rtol)


def test_resolve_and_takes_rng_match_jax():
    for mod in (tpp, jpp):
        assert mod.resolve_preprocess(None) is None
        fn = lambda b: b  # noqa: E731
        assert mod.resolve_preprocess(fn) is fn
        with pytest.raises(TypeError):
            mod.resolve_preprocess(3)
        assert not mod.takes_rng(mod.make_preprocess())
        assert mod.takes_rng(mod.make_preprocess(flip=True))
        assert mod.takes_rng(lambda b, rng: b)
        assert mod.takes_rng(lambda *a: a)
        assert not mod.takes_rng(len)
    assert tpp.NARROW_DTYPES == jpp.NARROW_DTYPES
    batch = {"x": _pixels()}
    np.testing.assert_array_equal(
        tpp.resolve_preprocess({"scale": 0.5})(batch)["x"].numpy(),
        np.asarray(jpp.resolve_preprocess({"scale": 0.5})(batch)["x"]))


def test_flip_mirrors_rows_from_a_generator():
    x = torch.from_numpy(_pixels((32, 4, 6, 3)))
    pre = tpp.make_preprocess(flip=True, dtype="float32")
    # no generator: the deterministic path, no flip
    np.testing.assert_array_equal(pre(x).numpy(), x.float().numpy())
    a = pre(x, torch.Generator().manual_seed(0))
    b = pre(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)  # reproducible from the seed
    flipped = 0
    for i in range(32):
        if torch.equal(a[i], x[i].float()):
            continue
        assert torch.equal(a[i], x[i].float().flip(1)), i
        flipped += 1
    assert 0 < flipped < 32
    with pytest.raises(ValueError, match="flip needs"):
        pre(torch.zeros(4, 3), torch.Generator())
    with pytest.raises(ValueError, match="larger than input"):
        tpp.make_preprocess(crop=(9, 9))(x)


# --- prefetch_to_device ------------------------------------------------------


def _items(n=5, with_count=True):
    for i in range(n):
        batch = {"x": np.arange(6, dtype=np.uint8).reshape(2, 3) + i,
                 "y": (np.full(2, i, np.int64),)}
        yield (batch, 2 - i % 2) if with_count else batch


@pytest.mark.parametrize("host", [False, True], ids=["sync", "host"])
@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_matches_jax(size, host):
    pre = {"columns": ["x"], "dtype": "float32", "scale": 0.5}
    want = list(jfeed.prefetch_to_device(_items(), size=size, preprocess=pre,
                                         host_prefetch=host))
    got = list(tfeed.prefetch_to_device(_items(), size=size,
                                        sharding="cpu", preprocess=pre,
                                        host_prefetch=host))
    assert len(got) == len(want) == 5
    for (gb, gn), (wb, wn) in zip(got, want):
        assert type(gn) is int and gn == wn
        assert isinstance(gb["x"], torch.Tensor)
        assert_tree_close(_numpy(gb), _numpy(wb), 0)


@pytest.mark.parametrize("host", [False, True], ids=["sync", "host"])
def test_prefetch_forwards_iterator_errors(host):
    def failing():
        yield from _items(2, with_count=False)
        raise RuntimeError("decode failed")

    it = tfeed.prefetch_to_device(failing(), size=2, sharding="cpu",
                                  host_prefetch=host)
    assert next(it)["x"][0, 0] == 0
    with pytest.raises(RuntimeError, match="decode failed"):
        list(it)


def test_prefetch_abandonment_does_not_hang():
    def endless():
        i = 0
        while True:
            yield {"x": np.full(4, i, np.float32)}
            i += 1

    before = {t.ident for t in threading.enumerate()}
    it = tfeed.prefetch_to_device(endless(), size=2,
                                  sharding=torch.device("cpu"),
                                  host_prefetch=True)
    assert [float(next(it)["x"][0]) for _ in range(3)] == [0.0, 1.0, 2.0]
    it.close()  # the consumer walks away with the buffer full
    end = time.monotonic() + 5
    while time.monotonic() < end and any(
            t.name == "prefetch-host" and t.ident not in before
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "prefetch-host" and t.ident not in before
                   for t in threading.enumerate())


def test_prefetch_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="size must be"):
        tfeed.prefetch_to_device(iter([]), size=0, sharding="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU DP"):
        tfeed.prefetch_to_device(iter([]), sharding=[torch.device("cpu")])
    if not torch.cuda.is_available():
        with pytest.raises(compat.NoCudaDevice):
            tfeed.prefetch_to_device(iter([]))


def test_place_tree_gives_identical_tensors():
    tree = {"tokens": np.arange(12, dtype=np.uint16).reshape(3, 4),
            "pair": (np.ones(2, np.float32), [np.int64(7),
                                              torch.arange(3)]),
            "scalar": np.float64(2.5)}
    out = tfeed.place_tree(tree, torch.device("cpu"))
    assert out["tokens"].dtype == torch.uint16
    assert torch.equal(out["tokens"].to(torch.int32),
                       torch.arange(12, dtype=torch.int32).reshape(3, 4))
    assert isinstance(out["pair"], tuple) and isinstance(out["pair"][1],
                                                         list)
    assert torch.equal(out["pair"][0], torch.ones(2))
    assert out["pair"][1][0].dtype == torch.int64
    assert int(out["pair"][1][0]) == 7
    assert out["pair"][1][1] is tree["pair"][1][1]
    assert out["scalar"].dtype == torch.float64
    # the trainer's placement is this copy
    trainer = dp.SyncTrainer(lambda p, b, r: 0.0, optim.sgd(0.1))
    trainer.device = torch.device("cpu")
    placed = trainer._place(tree)
    assert torch.equal(placed["tokens"], out["tokens"])


# --- SyncTrainer(device_preprocess=) ----------------------------------------

WIDEN = {"columns": ["tokens"], "dtype": "int32"}


def _jax_widened(tokens):
    model, params = _tree(TINY)
    from tensorflowonspark_tpu.models import transformer as jtr

    trainer = jdp.SyncTrainer(jtr.loss_fn(model), optax.sgd(0.05, 0.9),
                              mesh=build_mesh(devices=jax.devices()[:1]),
                              device_preprocess=WIDEN)
    state = trainer.create_state(params)
    losses = []
    for t in tokens:
        state, metrics = trainer.step(state, {"tokens": t})
        losses.append(float(metrics["loss"]))
    return np.asarray(losses), jax.tree.map(np.asarray, state.params)


def _port_trainer(tree, **kw):
    model = convert.params_from_flax(tree, ttr.TransformerConfig(**TINY),
                                     device="cpu", param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model),
                             optim.sgd(0.05, momentum=0.9), **kw)
    return model, trainer, trainer.create_state(
        dict(model.named_parameters()))


def test_device_preprocess_trains_like_jax_on_a_uint16_wire():
    tokens = _batches()
    wire = tokens.astype(np.uint16)
    want_loss, want_params = _jax_widened(wire)
    tree = jax.tree.map(np.asarray, _tree(TINY)[1])

    model, trainer, state = _port_trainer(tree, device_preprocess=WIDEN)
    losses = []
    for t in wire:
        state, m = trainer.step(state, {"tokens": t})
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, want_loss, rtol=1e-5)
    got = convert._flatten(convert.tree_from_model(model))
    want = convert._flatten(want_params)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5, rtol=0,
                                   err_msg=path)

    # exactly the port's run on an int32 wire, and per step under
    # multi_step as well
    ref_model, ref_trainer, ref_state = _port_trainer(tree)
    ref_losses = []
    for t in tokens:
        ref_state, m = ref_trainer.step(ref_state, {"tokens": t})
        ref_losses.append(m["loss"].item())
    assert losses == ref_losses
    for a, b in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(a, b)
    multi_model, multi_trainer, multi_state = _port_trainer(
        tree, device_preprocess=WIDEN)
    multi_state, m = multi_trainer.multi_step(multi_state, {"tokens": wire})
    assert m["loss"].tolist() == ref_losses
    assert int(multi_state.step) == len(tokens)


def test_rng_preprocess_receives_the_step_generator():
    seen = []

    def augment(batch, rng):
        seen.append(rng)
        return {"x": batch["x"].float()}

    def loss_fn(params, batch, rng):
        assert batch["x"].dtype == torch.float32
        return (batch["x"].mean() * params["w"]) ** 2

    w = torch.nn.Parameter(torch.ones(()))
    trainer = dp.SyncTrainer(loss_fn, optim.sgd(0.1),
                             device_preprocess=augment)
    state = trainer.create_state({"w": w})
    gen = torch.Generator()
    state, _ = trainer.step(state, {"x": np.ones((2, 3), np.uint8)}, gen)
    state, _ = trainer.multi_step(state, {"x": np.ones((2, 2, 3), np.uint8)},
                                  [gen, None])
    assert seen == [gen, gen, None]
    det = []
    trainer = dp.SyncTrainer(loss_fn, optim.sgd(0.1),
                             device_preprocess=lambda b: det.append(1) or {
                                 "x": b["x"].float()})
    state = trainer.create_state({"w": w})
    trainer.step(state, {"x": np.ones((2, 3), np.uint8)}, gen)
    assert det == [1]
