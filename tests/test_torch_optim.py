"""The port's optimizers and learning-rate schedules against optax, on
the CPU in f32: ``adam``, ``adamw`` and ``sgd`` with constant rates and
with schedules (evaluated at optax's count, 0 for the first update),
and ``piecewise_constant_schedule``.

Five updates from the same f32 parameters and gradients (numpy, from a
seed) must give parameters within 1e-6 of optax's (absolute, on values
of order 1: the same f32 operations, Adam's in optax's order; SGD's
through ``torch.optim.SGD``, which rounds ``-lr * t`` as optax does).
Schedules must equal optax's values exactly at ``boundary - 1``,
``boundary`` and ``boundary + 1``.  A scheduled SGD resumed from its
``state_tree`` equals an uninterrupted run to the bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu_torch import optim  # noqa: E402

STEPS = 5
SHAPES = {"a": (4, 3), "b": (5,)}
BOUNDARIES = {2: 0.5, 4: 0.1}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed=1):
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(STEPS)]


def _optax_run(tx):
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    state = tx.init(params)
    out = []
    for g in _grads():
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


def _port_run(opt, steps=STEPS):
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    opt_state = opt.init(params)
    out = []
    for g in _grads()[:steps]:
        opt.update(opt_state, params, [torch.from_numpy(g[k])
                                       for k in params])
        out.append({k: v.detach().numpy().copy() for k, v in params.items()})
    return out, params, opt_state


CASES = {
    "adam": (lambda: optim.adam(1e-2), lambda: optax.adam(1e-2)),
    "adam_schedule": (
        lambda: optim.adam(optim.piecewise_constant_schedule(1e-2,
                                                             BOUNDARIES)),
        lambda: optax.adam(optax.piecewise_constant_schedule(1e-2,
                                                             BOUNDARIES))),
    "adamw_schedule": (
        lambda: optim.adamw(optim.piecewise_constant_schedule(1e-2,
                                                              BOUNDARIES)),
        lambda: optax.adamw(optax.piecewise_constant_schedule(1e-2,
                                                              BOUNDARIES))),
    "sgd_schedule_momentum": (
        lambda: optim.sgd(optim.piecewise_constant_schedule(0.1, BOUNDARIES),
                          momentum=0.9),
        lambda: optax.sgd(optax.piecewise_constant_schedule(0.1, BOUNDARIES),
                          momentum=0.9)),
    "sgd_schedule_nesterov": (
        lambda: optim.sgd(optim.piecewise_constant_schedule(0.1, BOUNDARIES),
                          momentum=0.9, nesterov=True),
        lambda: optax.sgd(optax.piecewise_constant_schedule(0.1, BOUNDARIES),
                          momentum=0.9, nesterov=True)),
    "sgd_schedule": (
        lambda: optim.sgd(optim.piecewise_constant_schedule(0.1, BOUNDARIES)),
        lambda: optax.sgd(optax.piecewise_constant_schedule(0.1,
                                                            BOUNDARIES))),
    "sgd_callable": (
        lambda: optim.sgd(lambda count: 0.1 / (1.0 + count), momentum=0.9),
        lambda: optax.sgd(lambda count: 0.1 / (1.0 + count), momentum=0.9)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimizer_matches_optax(name):
    port, ref = CASES[name]
    got, _, _ = _port_run(port())
    want = _optax_run(ref())
    for step, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0,
                                       err_msg="{0} step {1}".format(k, step))


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5, 0, 100])
def test_piecewise_constant_schedule_matches_optax(count):
    """At ``boundary - 1``, ``boundary`` and ``boundary + 1`` of both
    boundaries (a scale applies from ``count >= boundary``)."""
    ours = optim.piecewise_constant_schedule(0.1, BOUNDARIES)
    ref = optax.piecewise_constant_schedule(0.1, BOUNDARIES)
    got = ours(np.int32(count))
    assert got.dtype == np.float32
    assert got == np.asarray(ref(jnp.int32(count)))
    assert optim.piecewise_constant_schedule(0.1)(np.int32(count)) == \
        np.float32(0.1)
    with pytest.raises(ValueError, match="non-negative"):
        optim.piecewise_constant_schedule(0.1, {2: -1.0})


def test_scheduled_sgd_resumes_from_its_state_tree():
    """The schedule's count travels in ``state_tree``: a fresh optimizer
    loaded after 3 updates takes updates 4 and 5 at their rates."""
    make = CASES["sgd_schedule_momentum"][0]
    want, _, _ = _port_run(make())
    _, params, opt_state = _port_run(make(), steps=3)
    tree = optim.state_tree(opt_state, params)
    assert int(tree["count"]) == 3 and set(tree) == {"momentum", "count"}
    fresh = {k: v.detach().clone() for k, v in params.items()}
    opt = make()
    resumed = opt.init(fresh)
    optim.load_state_tree(resumed, fresh, tree)
    for g in _grads()[3:]:
        opt.update(resumed, fresh, [torch.from_numpy(g[k]) for k in fresh])
    for k in SHAPES:
        np.testing.assert_array_equal(fresh[k].numpy(), want[-1][k])
    # a constant-rate SGD keeps its old tree
    _, params, opt_state = _port_run(optim.sgd(0.1, momentum=0.9), steps=1)
    assert set(optim.state_tree(opt_state, params)) == {"momentum"}


def test_adam_state_tree_has_adamw_keys():
    _, params, opt_state = _port_run(optim.adam(1e-2), steps=2)
    tree = optim.state_tree(opt_state, params)
    assert set(tree) == {"mu", "nu", "count"} and int(tree["count"]) == 2
    assert set(tree["mu"]) == set(SHAPES)


@pytest.mark.parametrize("bad", ["0.1", True, None, [0.1]])
def test_learning_rate_must_be_a_number_or_a_schedule(bad):
    for factory in (optim.adam, optim.adamw, optim.sgd):
        with pytest.raises(TypeError, match="learning_rate"):
            factory(bad)
