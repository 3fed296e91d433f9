"""Sequence-parallel training of the port's Transformer against the JAX
package's, on the CPU in f32.

The port's ranks (gloo processes) each run their slice of the sequence
with ring or Ulysses attention under ``SyncTrainer(mesh=build_mesh(
...))``, which sums the gradients over ``seq`` and averages them over
``data``; the reference trains the same Flax weights with
``TransformerConfig(attention_impl=..., mesh=...)`` and
``SyncTrainer(mesh=...)`` on global arrays over its CPU devices.  Three
SGD steps: every rank's losses against the reference's at rtol 1e-5 and
its weights at atol 1e-5, as the single-process trajectory tests of
``test_torch_train.py`` (the same f32 arithmetic in another summation
order); the ranks' losses and weights must be identical.
"""

import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu.parallel import dp as jdp  # noqa: E402
from tensorflowonspark_tpu.parallel.mesh import build_mesh  # noqa: E402
from tensorflowonspark_tpu_torch import convert  # noqa: E402

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=64,
            dtype="float32")
STEPS, S, LR = 3, 64, 0.05
#: name -> (ranks, mesh axes, TransformerConfig fields, batch rows)
CONFIGS = {
    "ring_seq2": (2, {"seq": 2}, dict(attention_impl="ring"), 2),
    "ring_seq2_window24": (2, {"seq": 2}, dict(attention_impl="ring",
                                               attention_window=24), 2),
    "ulysses_seq2": (2, {"seq": 2}, dict(attention_impl="ulysses"), 2),
    "ring_data2_seq2": (4, {"data": 2, "seq": 2},
                        dict(attention_impl="ring"), 4),
}


def _tokens(rows, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (STEPS, rows, S)).astype(np.int32)


def _params():
    model = jtr.Transformer(jtr.TransformerConfig(**TINY))
    return model.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every config trained by the port's ranks: one group of processes
    per rank count."""
    out = tmp_path_factory.mktemp("sp_train")
    tree = out / "tree.pkl"
    with open(tree, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, _params()), f)
    for world in sorted({c[0] for c in CONFIGS.values()}):
        specs = {
            name: dict(cfg=dict(TINY, **extra), tree=str(tree), mesh=axes,
                       lr=LR, tokens=_tokens(rows, seed=i))
            for i, (name, (n, axes, extra, rows)) in enumerate(
                sorted(CONFIGS.items())) if n == world
        }
        workers.run_ranks(workers.train_worker, world, out, str(out), specs)
    return str(out)


def _jax_run(name):
    world, axes, extra, rows = CONFIGS[name]
    seed = sorted(CONFIGS).index(name)
    mesh = build_mesh(axes, devices=jax.devices()[:world])
    model = jtr.Transformer(jtr.TransformerConfig(**dict(TINY, mesh=mesh,
                                                         **extra)))
    trainer = jdp.SyncTrainer(jtr.loss_fn(model),
                              optax.sgd(LR, momentum=0.9), mesh=mesh,
                              data_axes=("data",))
    state = trainer.create_state(_params())
    losses = []
    for batch in _tokens(rows, seed):
        state, metrics = trainer.step(state, {"tokens": batch})
        losses.append(float(metrics["loss"]))
    return np.asarray(losses), convert._flatten(
        jax.tree.map(np.asarray, state.params))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sequence_parallel_training_matches_jax(port_runs, name):
    world = CONFIGS[name][0]
    want_losses, want_params = _jax_run(name)
    ranks = workers.load_ranks(port_runs, name, world)
    for r in ranks[1:]:
        for key in r:
            np.testing.assert_array_equal(r[key], ranks[0][key],
                                          err_msg=key)
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert {"param/" + k for k in want_params} == set(got) - {"losses"}
    for path, want in want_params.items():
        np.testing.assert_allclose(got["param/" + path], want, atol=1e-5,
                                   rtol=0, err_msg=path)
    assert not np.allclose(got["losses"][0], got["losses"][-1])
