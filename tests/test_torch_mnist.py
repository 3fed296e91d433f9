"""The port's MNIST and linear models against the JAX package, on the CPU
in f32, and ``examples/mnist/mnist_spark.py``'s flow on the port.

The same numpy inputs and Flax weights (``mlp.params_from_flax``) go
through both packages.  Tolerances: the deterministic forward, the loss
and its gradients within 1e-6 relative (the largest absolute difference
over the largest absolute reference value; one f32 matmul chain).
Dropout is held by its distribution: over 1e5 units the kept share is
0.8 within 3 standard deviations and every kept unit is scaled by
1 / 0.8.  Exports cross the packages both ways with equal predictions
(float outputs within 1e-5).
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import convert_jax_export  # noqa: E402
import torch_dist_workers as workers  # noqa: E402
from tensorflowonspark_tpu import checkpoint as jck  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu.models import linear as jlinear  # noqa: E402
from tensorflowonspark_tpu.models import mlp as jmlp  # noqa: E402
from tensorflowonspark_tpu_torch import checkpoint as tck  # noqa: E402
from tensorflowonspark_tpu_torch import serving  # noqa: E402
from tensorflowonspark_tpu_torch.cluster import cluster  # noqa: E402
from tensorflowonspark_tpu_torch.engine import LocalEngine  # noqa: E402
from tensorflowonspark_tpu_torch.models import linear, mlp  # noqa: E402

TOL = 1e-6


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def synthetic_mnist(n, seed=0):
    """``examples/mnist/mnist_data_setup.py``'s learnable synthetic
    digits: label k lights a 7x4 patch at column block k, plus noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    images = rng.uniform(0.0, 0.3, size=(n, 28, 28)).astype(np.float32)
    for i, k in enumerate(labels):
        r, c = divmod(int(k), 5)
        images[i, 7 + r * 10:14 + r * 10, c * 5:c * 5 + 4] += 0.7
    return images.reshape(n, 784), labels


def _mnist_pair(seed=0):
    """``(jax model, params, port model)`` over one Flax init."""
    jm = jmlp.MNISTNet()
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), np.zeros((1, 784), np.float32))["params"])
    pm = mlp.MNISTNet(device="cpu")
    mlp.params_from_flax(params, pm)
    return jm, params, pm


@pytest.mark.parametrize("shape", [(8, 784), (8, 28, 28)],
                         ids=["flat", "image"])
def test_mnistnet_forward_matches_jax(shape):
    jm, params, pm = _mnist_pair()
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= TOL
    # dropout needs a generator: without one the train path is the eval
    with torch.no_grad():
        assert torch.equal(pm(torch.from_numpy(x), deterministic=False),
                           pm(torch.from_numpy(x)))


@pytest.mark.parametrize("form", ["dict", "tuple"])
def test_mnist_loss_and_grads_match_jax(form):
    jm, params, pm = _mnist_pair()
    x, y = synthetic_mnist(16, seed=2)
    jbatch = {"image": x, "label": y} if form == "dict" else (x, y)
    (want, aux), grads = jax.value_and_grad(jmlp.loss_fn(jm), has_aux=True)(
        params, jbatch, None)
    t = (torch.from_numpy(x), torch.from_numpy(y))
    batch = {"image": t[0], "label": t[1]} if form == "dict" else t
    loss, got_aux = mlp.loss_fn(pm)(dict(pm.named_parameters()), batch, None)
    loss.backward()
    assert _rel(loss.item(), float(want)) <= TOL
    assert got_aux["accuracy"].item() == float(aux["accuracy"])
    got = mlp.tree_from_model(pm)["params"]
    for layer in ("dense1", "dense2"):
        mod = getattr(pm, layer)
        assert _rel(mod.weight.grad.t().numpy(),
                    np.asarray(grads[layer]["kernel"])) <= TOL
        assert _rel(mod.bias.grad.numpy(),
                    np.asarray(grads[layer]["bias"])) <= TOL
        np.testing.assert_array_equal(got[layer]["kernel"],
                                      params[layer]["kernel"])


def test_dropout_keeps_units_at_the_rate():
    """Over 1e5 hidden units the kept share is 0.8 within 3 sigma, and a
    kept unit is the deterministic activation divided by 0.8."""
    pm = mlp.MNISTNet(hidden=1000, device="cpu")
    x = torch.rand((100, 784), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        h = torch.relu(pm.dense1(x))
        pm.dense2 = torch.nn.Identity()
        out = pm(x, deterministic=False,
                 rng=torch.Generator().manual_seed(4))
    live = h > 0
    kept = (out != 0) & live
    n = int(live.sum())
    share = float(kept.sum()) / n
    assert abs(share - 0.8) <= 3 * (0.8 * 0.2 / n) ** 0.5
    assert n > 0.3 * 1e5
    torch.testing.assert_close(out[kept], h[kept] / 0.8, rtol=1e-6, atol=0)
    # a seeded generator gives the same mask
    with torch.no_grad():
        again = pm(x, deterministic=False,
                   rng=torch.Generator().manual_seed(4))
    assert torch.equal(out, again)


def test_linear_matches_jax():
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal(6).astype(np.float32),
            "b": np.asarray(0.25, np.float32)}
    x = rng.standard_normal((9, 6)).astype(np.float32)
    batch = {"features": x, "label": rng.standard_normal(9).astype(
        np.float32)}
    assert _rel(linear.apply(linear.params_from_flax(tree, "cpu"),
                             torch.from_numpy(x)).numpy(),
                np.asarray(jlinear.apply(tree, x))) <= TOL
    want, grads = jax.value_and_grad(jlinear.loss_fn)(tree, batch)
    params = {k: v.requires_grad_(True)
              for k, v in linear.params_from_flax(tree, "cpu").items()}
    loss = linear.loss_fn(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    loss.backward()
    assert _rel(loss.item(), float(want)) <= TOL
    for k in ("w", "b"):
        assert _rel(params[k].grad.numpy(), np.asarray(grads[k])) <= TOL
    init = linear.init_params(6, device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == {"w": (6,),
                                                            "b": ()}
    back = linear.tree_from_model(params)
    np.testing.assert_array_equal(back["w"], tree["w"])
    with pytest.raises(ValueError, match="w"):
        linear.params_from_flax({"w": tree["w"]}, "cpu")
    with pytest.raises(ValueError, match="dim"):
        linear.params_from_flax({"w": x, "b": tree["b"]}, "cpu")


def _export_case(name):
    """``(params tree, model_config, batch)`` of an export."""
    if name == "mlp":
        _, params, _ = _mnist_pair(seed=6)
        x, _ = synthetic_mnist(12, seed=7)
        return params, {"input_name": "image"}, {"image": x}
    rng = np.random.default_rng(8)
    tree = {"w": rng.standard_normal(4).astype(np.float32),
            "b": np.asarray(-0.5, np.float32)}
    return tree, {}, {"features": rng.standard_normal((5, 4)).astype(
        np.float32)}


@pytest.mark.parametrize("name", ["mlp", "linear"])
def test_exports_serve_in_both_packages(tmp_path, name):
    """A port export serves under the reference's ``load_predictor`` and
    a reference export (through ``convert_jax_export.py``) under the
    port's: the same classes, float outputs within 1e-5."""
    tree, config, batch = _export_case(name)
    module = mlp if name == "mlp" else linear
    meta = {"model_ref": "tensorflowonspark_tpu.models.%s:serving_builder"
            % name, "model_config": config}
    if name == "mlp":
        pm = mlp.MNISTNet(device="cpu")
        port_tree = mlp.tree_from_model(mlp.params_from_flax(tree, pm))
    else:
        port_tree = linear.tree_from_model(
            linear.params_from_flax(tree, "cpu"))
    port_dir = tck.save_for_serving(tmp_path / "port", port_tree,
                                    extra_metadata=meta)
    jax_dir = convert_jax_export.convert(
        jck.save_for_serving(tmp_path / "jax", tree, extra_metadata=meta),
        str(tmp_path / "conv"))
    for export in (port_dir, jax_dir):
        want = jserving.load_predictor(export, use_cache=False)(batch)
        got = serving.load_predictor(
            export, use_cache=False, config_overrides={"device": "cpu"})(
            batch)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            if want[key].dtype.kind == "f":
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           atol=1e-5)
            else:
                np.testing.assert_array_equal(got[key], want[key])
    assert module.serving_builder is serving.resolve_ref(meta["model_ref"])


def test_mnist_spark_flow_on_the_port(tmp_path):
    """``mnist_spark.py``'s flow: ``cluster.run(LocalEngine(1), main_fun,
    input_mode=SPARK)`` over synthetic rows, ``MNISTNet`` trained with
    ``adam(1e-3)`` through ``train_on_feed(columnar=True)``, exported,
    and served by ``load_predictor`` in the driver: the loss falls, and
    the export serves the JAX package the same predictions."""
    x, y = synthetic_mnist(512)
    data = [(x[i], int(y[i])) for i in range(len(x))]
    parts = [data[i::4] for i in range(4)]
    args = {"batch_size": 32, "steps": 16, "out": str(tmp_path / "r.json"),
            "export_dir": str(tmp_path / "export")}
    engine = LocalEngine(1, deterministic=True)
    try:
        c = cluster.run(engine, workers.mnist_spark_fn, args,
                        num_executors=1, input_mode=cluster.InputMode.SPARK,
                        reservation_timeout=60)
        c.train(parts, num_epochs=1, feed_timeout=60)
        c.shutdown(timeout=60)
    finally:
        engine.stop()
    with open(args["out"]) as f:
        res = json.load(f)
    assert res["steps"] == 16 and len(res["losses"]) == 16
    assert np.mean(res["losses"][-4:]) < 0.5 * np.mean(res["losses"][:4])
    assert os.path.isdir(args["export_dir"])
    test_x, test_y = synthetic_mnist(64, seed=1)
    got = serving.load_predictor(args["export_dir"], use_cache=False,
                                 config_overrides={"device": "cpu"})(
        {"image": test_x})
    want = jserving.load_predictor(args["export_dir"], use_cache=False)(
        {"image": test_x})
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    assert np.mean(got["prediction"] == test_y) > 0.5
