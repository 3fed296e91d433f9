"""The port's vision models (ResNetCIFAR, ResNet50, UNet), their layers
and the trainer's model state against the JAX package, on the CPU in
f32.

The same numpy inputs and the same Flax weights (converted by the
models' ``params_from_flax``) go through both packages.  Tolerances
(relative: the largest absolute difference over the largest absolute
reference value, per leaf for trees):

- layers and eval forwards 1e-5; train forwards and the new
  ``batch_stats`` 1e-5 (the same f32 arithmetic summed in another
  order);
- gradients 1e-4 (through every layer of the backward);
- ResNet50's training path (train forward, statistics, gradients) is
  compared in f64 on both sides (``jax.enable_x64``) at the same
  tolerances: in f32 its gradients jump where one package's rounding
  crosses a ReLU kink or a max-pool near tie and the other's does not
  (measured on one seed: the JAX package's own f32 gradients 7.7e-2
  per leaf from its f64 ones at 65 px, where the port's are 8e-6; with
  the s2d stem the port's 4.1e-2, the JAX package's 2.5e-5; f32 against
  f32 up to 2.3e-1 over seeds and batches 2-8; the JAX package's f32
  train forward 1.45e-5 from its f64 one), so an f32 comparison
  measures those flips, not the port;
- exports: each package serves the other's export exactly as it serves
  the same weights from memory; across the packages the classes agree
  off near ties (both serve in bf16);
- three ``SyncTrainer(has_model_state=True)`` steps against the
  reference's trainer: loss, params and ``batch_stats`` 1e-4;
- two gloo ranks against one process over the global batch: losses
  rtol 1e-5, weights and statistics atol 1e-5, as the port's other
  multi-process tests.

Each of the reference's traps has a test that a straight translation
fails, and each such test also shows the straight translation's error:
Flax's asymmetric "SAME" padding of strided convolutions and max
pooling, ``ConvTranspose``'s unflipped kernel, BatchNorm's biased
running variance, GroupNorm's 1e-6 epsilon and BatchNorm statistics
over the global batch under data parallelism.
"""

import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from test_torch_checkpoint import _FakeFeed  # noqa: E402
from tensorflowonspark_tpu import checkpoint as jck  # noqa: E402
from tensorflowonspark_tpu import serving as jserving  # noqa: E402
from tensorflowonspark_tpu.models import resnet as jresnet  # noqa: E402
from tensorflowonspark_tpu.models import unet as junet  # noqa: E402
from tensorflowonspark_tpu.parallel import dp as jdp  # noqa: E402
from tensorflowonspark_tpu.parallel.mesh import build_mesh  # noqa: E402
import convert_jax_export  # noqa: E402
from tensorflowonspark_tpu_torch import checkpoint as tck  # noqa: E402
from tensorflowonspark_tpu_torch import optim, serving  # noqa: E402
from tensorflowonspark_tpu_torch.models import layers  # noqa: E402
from tensorflowonspark_tpu_torch.models import resnet, unet  # noqa: E402
from tensorflowonspark_tpu_torch.parallel import dp  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-4
TRAIN_TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _images(b, hw, seed=0, channels=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, hw, hw, channels)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _flat(tree):
    return layers._flatten(tree)


# ----------------------------------------------------------------------
# the layers and the reference's traps
# ----------------------------------------------------------------------


@pytest.mark.parametrize("size,kernel,stride,groups", [
    (8, 3, 2, 1), (9, 3, 2, 1), (8, 3, 1, 1), (8, 1, 2, 1), (8, 3, 2, 4),
    (7, 3, 2, 4),
], ids=["even_s2", "odd_s2", "s1", "1x1_s2", "depthwise_even_s2",
        "depthwise_odd_s2"])
def test_same_conv_pads_as_flax(size, kernel, stride, groups):
    """Trap 1: a strided "SAME" conv over an even size pads (0, 1);
    ``F.conv2d(padding=k // 2)`` is off there."""
    x = _images(2, size, channels=4)
    ref = fnn.Conv(6 if groups == 1 else 4, (kernel, kernel),
                   strides=(stride, stride), padding="SAME",
                   feature_group_count=groups)
    v = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0), x))
    want = np.asarray(ref.apply(v, x))
    conv = layers.Conv(4, want.shape[-1], kernel, stride, groups=groups,
                       device="cpu")
    layers.load_flax(v, conv)
    assert _rel(_nhwc(conv(_nchw(x))), want) <= TOL
    naive = F.conv2d(_nchw(x), conv.weight, conv.bias, stride,
                     kernel // 2, groups=groups)
    lo, hi = layers.same_pads(size, kernel, stride)
    if lo != hi:
        assert _rel(_nhwc(naive), want) > 1e-2
    else:
        assert _rel(_nhwc(naive), want) <= TOL


@pytest.mark.parametrize("size", [8, 9])
def test_max_pool_pads_as_flax(size):
    """Trap 2: ``nn.max_pool(3x3, stride 2, "SAME")`` pads (0, 1) with
    -inf over an even size; ``F.max_pool2d(padding=1)`` is off there."""
    x = _images(2, size, channels=4)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding="SAME"))
    assert _rel(_nhwc(layers.max_pool(_nchw(x), 3, 2)), want) == 0.0
    naive = _nhwc(F.max_pool2d(_nchw(x), 3, 2, padding=1))
    if size % 2 == 0:
        assert _rel(naive, want) > 1e-2
    else:
        assert _rel(naive, want) == 0.0


@pytest.mark.parametrize("size", [4, 5])
def test_conv_transpose_flips_the_flax_kernel(size):
    """Trap 3: ``nn.ConvTranspose(4x4, stride 2, "SAME")`` is PyTorch's
    transposed conv over the kernel flipped on both spatial axes; the
    unflipped kernel is off."""
    x = _images(2, size, channels=4)
    ref = fnn.ConvTranspose(6, (4, 4), strides=(2, 2), padding="SAME")
    v = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0), x))
    want = np.asarray(ref.apply(v, x))
    up = layers.ConvTranspose(4, 6, 4, 2, device="cpu")
    layers.load_flax(v, up)
    got = _nhwc(up(_nchw(x)))
    assert got.shape == want.shape == (2, 2 * size, 2 * size, 6)
    assert _rel(got, want) <= TOL
    unflipped = torch.tensor(v["params"]["kernel"]).permute(2, 3, 0, 1)
    naive = F.conv_transpose2d(_nchw(x), unflipped, up.bias, 2, 1)
    assert _rel(_nhwc(naive), want) > 1e-2
    # the carrier's way back gives the Flax tree
    back = layers.flax_variables(up)
    np.testing.assert_array_equal(back["params"]["kernel"],
                                  v["params"]["kernel"])


def test_batch_norm_keeps_flax_running_statistics():
    """Trap 4: running averages ``0.9 ra + 0.1 batch`` with the biased
    variance (``nn.BatchNorm2d`` folds in the unbiased one), outputs
    from the batch's statistics in training and the running ones in
    evaluation."""
    x = _images(2, 4, channels=5) * 2.0 + 0.5
    ref = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    v = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0), x))
    v["params"]["scale"] = np.linspace(0.5, 1.5, 5).astype(np.float32)
    v["batch_stats"]["var"] = np.full(5, 2.0, np.float32)
    want, new = ref.apply(v, x, mutable=["batch_stats"])
    bn = layers.BatchNorm(5, device="cpu")
    layers.load_flax(v, bn)
    bn.path = ""
    updates = {}
    got = bn(_nchw(x), True, updates)
    assert _rel(_nhwc(got), np.asarray(want)) <= TOL
    for name in ("mean", "var"):
        assert _rel(updates[name].numpy(),
                    np.asarray(new["batch_stats"][name])) <= TOL
    # the layer left its buffers alone
    np.testing.assert_array_equal(bn.var.numpy(), v["batch_stats"]["var"])
    naive = torch.nn.BatchNorm2d(5, eps=1e-5, momentum=0.1)
    naive.running_var.fill_(2.0)
    naive(_nchw(x))
    assert _rel(naive.running_var.numpy(),
                np.asarray(new["batch_stats"]["var"])) > 1e-3
    # evaluation reads the running statistics
    want = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                         epsilon=1e-5).apply(v, x)
    assert _rel(_nhwc(bn(_nchw(x))), np.asarray(want)) <= TOL


def test_group_norm_uses_flax_epsilon():
    """Trap 5: GroupNorm's epsilon is 1e-6 (PyTorch's default 1e-5 is off
    on activations of small variance)."""
    x = _images(2, 4, channels=8) * 1e-2
    ref = fnn.GroupNorm(num_groups=4, dtype=jnp.float32)
    v = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0), x))
    want = np.asarray(ref.apply(v, x))
    gn = layers.GroupNorm(4, 8, device="cpu")
    layers.load_flax(v, gn)
    assert _rel(_nhwc(gn(_nchw(x))), want) <= TOL
    naive = F.group_norm(_nchw(x), 4, gn.scale, gn.bias, eps=1e-5)
    assert _rel(_nhwc(naive), want) > 1e-2


def test_load_flax_refuses_mismatched_trees():
    conv = layers.Conv(4, 6, 3, device="cpu")
    good = {"params": {"kernel": np.zeros((3, 3, 4, 6), np.float32),
                       "bias": np.zeros((6,), np.float32)}}
    layers.load_flax(good, conv)
    with pytest.raises(ValueError, match="missing"):
        layers.load_flax({"params": {"kernel": good["params"]["kernel"]}},
                         conv)
    with pytest.raises(ValueError, match="extra"):
        layers.load_flax({"params": dict(good["params"],
                                         other=np.zeros(1))}, conv)
    with pytest.raises(ValueError, match="shape"):
        layers.load_flax({"params": dict(good["params"], kernel=np.zeros(
            (3, 3, 6, 4), np.float32))}, conv)


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------

R50 = dict(num_classes=10, stage_sizes=(1, 1, 1, 1))

#: name: (JAX model, port model, their keywords, batch, input size); the
#: odd sizes pad the strided convolutions and the max pool symmetrically
MODELS = {
    "cifar8": (jresnet.ResNetCIFAR, resnet.ResNetCIFAR, dict(depth=8), 4,
               16),
    "cifar14": (jresnet.ResNetCIFAR, resnet.ResNetCIFAR, dict(depth=14), 2,
                32),
    "cifar8_odd": (jresnet.ResNetCIFAR, resnet.ResNetCIFAR, dict(depth=8),
                   2, 33),
    "resnet50_conv7": (jresnet.ResNet50, resnet.ResNet50, R50, 2, 64),
    "resnet50_s2d": (jresnet.ResNet50, resnet.ResNet50,
                     dict(R50, stem="s2d"), 2, 64),
    "resnet50_odd": (jresnet.ResNet50, resnet.ResNet50, R50, 2, 65),
    "unet": (junet.UNet, unet.UNet, dict(base_filters=8), 2, 32),
}

#: the models whose training path is compared in f64 (see the module
#: docstring): ResNet50's f32 gradients jump at ReLU kinks and max-pool
#: near-ties that one package's rounding crosses and the other's does not
F64_TRAIN = ("resnet50_conv7", "resnet50_s2d", "resnet50_odd")


def _moved_stats(tree, rng):
    """Running statistics as training leaves them: means near 0,
    variances about 1 (each BatchNorm's ``{"mean", "var"}``)."""
    if "mean" in tree:
        return {"mean": rng.normal(0, 0.1, tree["mean"].shape).astype(
                    np.float32),
                "var": rng.uniform(0.5, 1.5, tree["var"].shape).astype(
                    np.float32)}
    return {k: _moved_stats(t, rng) for k, t in tree.items()}


def _pair(name, seed=0, dtype="float32"):
    """``(jax model, variables, port model, images)`` over one init (f32
    weights; ``dtype`` the compute type of both models)."""
    jax_cls, port_cls, kw, b, hw = MODELS[name]
    x = _images(b, hw, seed=seed + 1)
    v = jax.tree.map(np.asarray, jax.jit(jax_cls(
        dtype="float32", **kw).init)(jax.random.PRNGKey(seed), x[:1]))
    if "batch_stats" in v:  # running statistics away from their init
        v["batch_stats"] = _moved_stats(v["batch_stats"],
                                        np.random.default_rng(seed + 2))
    pm = port_cls(dtype=dtype, device="cpu", **kw)
    (unet if name == "unet" else resnet).params_from_flax(v, pm)
    if dtype == "float64":
        x = x.astype(np.float64)
        v = jax.tree.map(lambda a: a.astype(np.float64), v)
    return jax_cls(dtype=dtype, **kw), v, pm, x


def _train_pair(name, seed=0):
    """:func:`_pair` in the type the training path is compared in, and
    whether that is f64 (call the JAX side under ``jax.enable_x64``)."""
    f64 = name in F64_TRAIN
    return _pair(name, seed, "float64" if f64 else "float32"), f64


def _labels(name, x, seed=3):
    rng = np.random.default_rng(seed)
    if name == "unet":
        return rng.integers(0, 3, x.shape[:3]).astype(np.int32)
    return rng.integers(0, 10, (x.shape[0],)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_forward_matches_jax(name):
    jm, v, pm, x = _pair(name)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(v, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.ptp(want) > 1e-2  # not a dead network's constant output
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("name", sorted(n for n in MODELS if n != "unet"))
def test_train_forward_and_batch_stats_match_jax(name):
    (jm, v, pm, x), f64 = _train_pair(name)
    with jax.enable_x64(f64):
        want, new = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, x)
    with torch.no_grad():
        got, stats = pm(torch.from_numpy(x), train=True)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    # keyed as the model's buffers, which the forward left alone
    assert set(stats) == {n for n, _ in pm.named_buffers()}
    buffers = dict(pm.named_buffers())
    for path, ref in _flat(jax.tree.map(np.asarray,
                                        new["batch_stats"])).items():
        key = path.replace("/", ".")
        assert _rel(stats[key].numpy(), ref) <= TOL, path
        assert not torch.equal(buffers[key], stats[key]), path


def _grad_tree(model):
    """The gradients of ``model``'s parameters as a Flax params tree."""
    out = {}
    for (coll, path), (module, attr, layout) in layers.flax_layout(
            model).items():
        if coll == "params":
            out[path] = layers._TO_FLAX[layout](
                getattr(module, attr).grad).numpy()
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_grads_match_jax(name):
    (jm, v, pm, x), f64 = _train_pair(name)
    y = _labels(name, x)
    params = dict(pm.named_parameters())
    if name == "unet":
        jloss = junet.loss_fn(jm)
        (want, aux), grads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(v["params"], {"image": x, "mask": y},
                                  None)
        loss, got_aux = unet.loss_fn(pm)(
            params, {"image": torch.from_numpy(x),
                     "mask": torch.from_numpy(y)}, None)
    else:
        jloss = jresnet.loss_fn(jm)
        state = {"batch_stats": v["batch_stats"]}
        with jax.enable_x64(f64):
            (want, (aux, _)), grads = jax.jit(jax.value_and_grad(
                jloss, has_aux=True))(v["params"], state, (x, y), None)
        loss, (got_aux, new) = resnet.loss_fn(pm)(
            params, {"batch_stats": dict(pm.named_buffers())},
            (torch.from_numpy(x), torch.from_numpy(y)), None)
        assert set(new) == {"batch_stats"}
    loss.backward()
    assert _rel(loss.item(), float(want)) <= TOL
    assert got_aux["accuracy"].item() == float(aux["accuracy"])
    got = _grad_tree(pm)
    want_grads = _flat(jax.tree.map(np.asarray, grads))
    assert set(got) == set(want_grads)
    for path, ref in want_grads.items():
        assert _rel(got[path], ref) <= GRAD_TOL, path


def test_s2d_stem_equals_conv7_stem():
    """``space_to_depth`` and ``conv7_to_s2d_kernel`` as the reference's:
    the s2d stem over the converted kernel computes the conv7 stem."""
    x = _images(2, 32, seed=5)
    np.testing.assert_array_equal(
        resnet.space_to_depth(torch.from_numpy(x), 2).numpy(),
        np.asarray(jresnet.space_to_depth(jnp.asarray(x), 2)))
    j7 = jresnet.ResNet50(num_classes=10, dtype="float32", stage_sizes=(1,))
    v7 = jax.tree.map(np.asarray, j7.init(jax.random.PRNGKey(0), x))
    k7 = v7["params"]["stem_conv"]["kernel"]
    ks = resnet.conv7_to_s2d_kernel(k7)
    np.testing.assert_array_equal(ks, np.asarray(
        jresnet.conv7_to_s2d_kernel(k7)))
    assert torch.equal(resnet.conv7_to_s2d_kernel(torch.tensor(k7)),
                       torch.from_numpy(ks))
    vs = {"params": dict(v7["params"], stem_conv={"kernel": ks}),
          "batch_stats": v7["batch_stats"]}
    m7 = resnet.ResNet50(num_classes=10, dtype="float32", stage_sizes=(1,),
                         device="cpu")
    ms = resnet.ResNet50(num_classes=10, dtype="float32", stage_sizes=(1,),
                         stem="s2d", device="cpu")
    resnet.params_from_flax(v7, m7)
    resnet.params_from_flax(vs, ms)
    with torch.no_grad():
        out7 = m7(torch.from_numpy(x)).numpy()
        outs = ms(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(outs, out7, atol=1e-5)
    np.testing.assert_allclose(out7, np.asarray(j7.apply(v7, x)), atol=1e-5)


def test_cifar_schedule_matches_jax():
    ours = resnet.CIFARSchedule(batch_size=256, steps_per_epoch=10)
    ref = jresnet.CIFARSchedule(batch_size=256, steps_per_epoch=10)
    for step in (0, 909, 910, 911, 1359, 1360, 1361):
        assert np.float32(ours(step)) == np.float32(ref(jnp.int32(step)))


def test_bf16_models_run_in_bf16_over_f32_weights():
    for pm in (resnet.ResNetCIFAR(depth=8, device="cpu"),
               unet.UNet(base_filters=8, device="cpu")):
        assert {p.dtype for p in pm.parameters()} == {torch.float32}
        with torch.no_grad():
            out = pm(torch.from_numpy(_images(2, 32)))
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert resnet.ResNetCIFAR(depth=8, device="cpu").stem.bn.dtype == \
        torch.bfloat16


# ----------------------------------------------------------------------
# the trainer's model state
# ----------------------------------------------------------------------

SCHEDULE = {2: 0.1}


def _jax_train(v, batches):
    jm = jresnet.ResNetCIFAR(depth=8, dtype="float32")
    trainer = jdp.SyncTrainer(
        jresnet.loss_fn(jm),
        optax.sgd(optax.piecewise_constant_schedule(0.1, SCHEDULE),
                  momentum=0.9),
        mesh=build_mesh(devices=jax.devices()[:1]), has_model_state=True)
    state = trainer.create_state(v["params"],
                                 {"batch_stats": v["batch_stats"]})
    losses = []
    for i, batch in enumerate(batches):
        state, metrics = trainer.step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    return losses, jax.tree.map(np.asarray, {
        "params": state.params,
        "batch_stats": state.model_state["batch_stats"]})


def _port_trainer(v):
    pm = resnet.ResNetCIFAR(depth=8, dtype="float32", device="cpu")
    resnet.params_from_flax(v, pm)
    trainer = dp.SyncTrainer(
        resnet.loss_fn(pm),
        optim.sgd(optim.piecewise_constant_schedule(0.1, SCHEDULE),
                  momentum=0.9), has_model_state=True)
    state = trainer.create_state(dict(pm.named_parameters()),
                                 {"batch_stats": dict(pm.named_buffers())})
    return pm, trainer, state


def _cifar_batches(steps=3, b=4, hw=16, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
             rng.integers(0, 10, (b,)).astype(np.int32))
            for _ in range(steps)]


def _assert_trees_close(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for path, ref in want.items():
        assert _rel(got[path], ref) <= tol, path


def test_trainer_with_model_state_matches_jax():
    """Three steps of ``SyncTrainer(has_model_state=True)`` with
    ``sgd(piecewise_constant_schedule, momentum=0.9)``: losses, params
    and ``batch_stats`` as the reference's trainer."""
    _, v, _, _ = _pair("cifar8")
    batches = _cifar_batches()
    want_losses, want = _jax_train(v, batches)
    pm, trainer, state = _port_trainer(v)
    losses = []
    for batch in batches:
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"].item())
        assert set(metrics) == {"loss", "accuracy"}
    np.testing.assert_allclose(losses, want_losses, rtol=TRAIN_TOL)
    _assert_trees_close(resnet.tree_from_model(pm), want, TRAIN_TOL)
    # the state's statistics are the model's buffers, updated in place
    buffers = dict(pm.named_buffers())
    for name, t in state.model_state["batch_stats"].items():
        assert t is buffers[name]
    assert int(state.step) == 3


def test_model_state_through_multi_step_and_train_on_feed():
    """``multi_step`` and ``train_on_feed`` carry the model state as
    ``step`` does, to the bit."""
    _, v, _, _ = _pair("cifar8")
    batches = _cifar_batches(steps=4)
    runs = []
    for mode in ("step", "multi", "feed"):
        pm, trainer, state = _port_trainer(v)
        if mode == "step":
            for batch in batches:
                state, _ = trainer.step(state, batch)
        elif mode == "multi":
            stacked = tuple(np.stack(c) for c in zip(*batches))
            state, metrics = trainer.multi_step(state, stacked)
            assert metrics["loss"].shape == (4,)
        else:
            rows = [[(x[i], y[i]) for i in range(len(y))]
                    for x, y in batches]
            state = trainer.train_on_feed(state, _FakeFeed(rows), 4)
        assert int(state.step) == 4
        runs.append(resnet.tree_from_model(pm))
    for other in runs[1:]:
        for path, leaf in _flat(runs[0]).items():
            np.testing.assert_array_equal(_flat(other)[path], leaf,
                                          err_msg=path)


@pytest.mark.parametrize("mesh", [None, {"data": 2}],
                         ids=["default", "mesh_data"])
def test_model_state_is_reduced_over_ranks(tmp_path, mesh):
    """Trap 6: two gloo ranks, each on its half of the global batch, train
    as one process on the whole batch: BatchNorm's statistics are the
    global batch's, and the gradients their mean's (the default trainer,
    and over a ``{"data": 2}`` mesh)."""
    _, v, _, _ = _pair("cifar8")
    path = tmp_path / "variables.pkl"
    with open(path, "wb") as f:
        pickle.dump(v, f)
    batches = _cifar_batches(steps=2, b=8)
    spec = dict(variables=str(path), lr=0.1, mesh=mesh,
                images=np.stack([x for x, _ in batches]),
                labels=np.stack([y for _, y in batches]))
    want = workers.bn_train(spec)
    workers.run_ranks(workers.bn_train_worker, 2, tmp_path, str(tmp_path),
                      spec)
    r0, r1 = workers.load_ranks(str(tmp_path), "bn", 2)
    assert set(r0) == set(want)
    for key in r0:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=1e-5)
    for key, ref in want.items():
        if key != "losses":
            np.testing.assert_allclose(r0[key], ref, atol=1e-5, rtol=0,
                                       err_msg=key)


def test_checkpoint_resume_with_model_state(tmp_path):
    """A run resumed from a checkpoint (params, momentum, the schedule's
    count and the batch statistics) ends where an uninterrupted run
    ends, to the bit."""
    _, v, _, _ = _pair("cifar8")
    batches = _cifar_batches(steps=4)
    pm, trainer, state = _port_trainer(v)
    ck = tck.Checkpointer(tmp_path / "ck")
    for i, batch in enumerate(batches):
        state, metrics = trainer.step(state, batch)
        if i == 1:
            ck.save(2, state, wait=True)
    want, want_loss = resnet.tree_from_model(pm), metrics["loss"].item()
    pm, trainer, state = _port_trainer(v)
    state = ck.restore(state)
    assert int(state.step) == 2
    assert state.opt_state.count == 2
    for batch in batches[2:]:
        state, metrics = trainer.step(state, batch)
    assert metrics["loss"].item() == want_loss
    for path, leaf in _flat(want).items():
        np.testing.assert_array_equal(_flat(resnet.tree_from_model(pm))[
            path], leaf, err_msg=path)


# ----------------------------------------------------------------------
# serving exports across the packages
# ----------------------------------------------------------------------

#: a top-2 logit gap under this share of the logit spread is a near tie
#: (the models serve in bf16 in both packages, rounded at other points:
#: the JAX package's CPU backend keeps excess precision across fused ops)
NEAR_TIE = 0.1
EXPORTS = {
    "resnet": ("prediction", "cifar8", {"depth": 8}),
    "unet": ("mask", "unet", {"base_filters": 8}),
}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_exports_serve_in_both_packages(tmp_path, name):
    """A port export serves under the reference's ``load_predictor``
    exactly as the reference serves the same weights from memory, and a
    reference export (through ``convert_jax_export.py``) under the port's
    as the port's builder serves them; across the packages the
    predictions agree but for near ties."""
    out, model, config = EXPORTS[name]
    module = resnet if name == "resnet" else unet
    jmodule = jresnet if name == "resnet" else junet
    _, v, pm, x = _pair(model, seed=4)
    meta = {"model_ref": "tensorflowonspark_tpu.models.%s:serving_builder"
            % name, "model_config": dict(config)}
    port_dir = tck.save_for_serving(tmp_path / "port",
                                    module.tree_from_model(pm),
                                    extra_metadata=meta)
    jax_dir = convert_jax_export.convert(
        jck.save_for_serving(tmp_path / "jax", v, extra_metadata=meta),
        str(tmp_path / "conv"))
    want = jmodule.serving_builder(v, config)({"image": x})
    got = module.serving_builder(v, dict(config, device="cpu"))(
        {"image": x})
    for key in (out, "logits"):
        np.testing.assert_array_equal(jserving.load_predictor(
            port_dir, use_cache=False)({"image": x})[key], want[key])
        np.testing.assert_array_equal(serving.load_predictor(
            jax_dir, use_cache=False, config_overrides={"device": "cpu"})(
            {"image": x})[key], got[key])
        assert got[key].shape == want[key].shape
        assert got[key].dtype == want[key].dtype
    top = np.sort(want["logits"], axis=-1)
    spread = want["logits"].max() - want["logits"].min()
    clear = (top[..., -1] - top[..., -2]) > NEAR_TIE * spread
    np.testing.assert_array_equal(got[out][clear], want[out][clear])
    assert clear.any()
