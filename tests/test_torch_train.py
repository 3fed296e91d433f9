"""The port's training path against the JAX package's, on the CPU in f32:
``SyncTrainer`` + ``loss_fn`` with flash attention (the plain path here,
the Pallas kernels in interpret mode there) from the same Flax tree, the
optimizers against optax, and the trainer's own contract.

Tolerances: losses rtol 1e-5 and parameters atol 1e-5 over three SGD
steps (the same f32 arithmetic in another summation order, through two
layers and three updates); one AdamW update atol 1e-7 (optax and torch
apply the decay and the bias corrections as algebraically equal
expressions, a few ulp apart on weights of order 0.1-1); AdamW losses
rtol 1e-4 over three steps (Adam's normalised update magnifies the
ulp-level gradient differences where a second moment is tiny).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tensorflowonspark_tpu.models import transformer as jtr  # noqa: E402
from tensorflowonspark_tpu.parallel import dp as jdp  # noqa: E402
from tensorflowonspark_tpu.parallel.mesh import build_mesh  # noqa: E402
from tensorflowonspark_tpu_torch import convert, optim  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.parallel import dp  # noqa: E402

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=64,
            dtype="float32", attention_impl="flash")
B, S, STEPS = 2, 64, 3


def _tree(cfg_kw, seed=0):
    model = jtr.Transformer(jtr.TransformerConfig(**cfg_kw))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _batches(seed=3, vocab=256):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (STEPS, B, S)).astype(np.int32)


def _jax_run(cfg_kw, tx, tokens):
    model, params = _tree(cfg_kw)
    trainer = jdp.SyncTrainer(jtr.loss_fn(model), tx,
                              mesh=build_mesh(devices=jax.devices()[:1]))
    state = trainer.create_state(params)
    losses = []
    for t in tokens:
        state, metrics = trainer.step(state, {"tokens": t})
        losses.append(float(metrics["loss"]))
    return np.asarray(losses), jax.tree.map(np.asarray, state.params)


def _port_model(cfg_kw, tree=None):
    cfg = ttr.TransformerConfig(**cfg_kw)
    if tree is None:
        tree = jax.tree.map(np.asarray, _tree(cfg_kw)[1])
    return convert.params_from_flax(tree, cfg, device="cpu",
                                    param_dtype=torch.float32)


def _port_run(cfg_kw, opt, tokens):
    model = _port_model(cfg_kw)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), opt)
    state = trainer.create_state(dict(model.named_parameters()))
    losses = []
    for t in tokens:
        state, metrics = trainer.step(state, {"tokens": t})
        losses.append(metrics["loss"].item())
    return np.asarray(losses), convert.tree_from_model(model), state


@pytest.mark.parametrize("extra", [{}, {"attention_window": 24}],
                         ids=["flash", "flash_window"])
def test_sgd_trajectory_matches_jax(extra):
    cfg_kw = dict(TINY, **extra)
    tokens = _batches()
    want_loss, want_params = _jax_run(
        cfg_kw, optax.sgd(0.05, momentum=0.9), tokens)
    got_loss, got_params, state = _port_run(
        cfg_kw, optim.sgd(0.05, momentum=0.9), tokens)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    want, got = convert._flatten(want_params), convert._flatten(got_params)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5, rtol=0,
                                   err_msg=path)
    assert int(state.step) == STEPS
    assert not np.allclose(got_loss[0], got_loss[-1])


def test_adamw_trajectory_matches_jax():
    tokens = _batches(seed=4)
    want, _ = _jax_run(TINY, optax.adamw(1e-3), tokens)
    got, _, _ = _port_run(TINY, optim.adamw(1e-3), tokens)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32) * 0.3,
            "s": 1.0 + rng.standard_normal((8,)).astype(np.float32) * 0.1}


@pytest.mark.parametrize("make,tx", [
    (lambda: optim.adamw(1e-3), lambda: optax.adamw(1e-3)),
    (lambda: optim.adamw(3e-2, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1),
     lambda: optax.adamw(3e-2, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1)),
    (lambda: optim.sgd(0.1), lambda: optax.sgd(0.1)),
    (lambda: optim.sgd(0.1, momentum=0.9), lambda: optax.sgd(0.1, 0.9)),
    (lambda: optim.sgd(0.1, momentum=0.9, nesterov=True),
     lambda: optax.sgd(0.1, 0.9, nesterov=True)),
], ids=["adamw_defaults", "adamw_custom", "sgd", "sgd_momentum",
        "sgd_nesterov"])
def test_updates_match_optax(make, tx):
    """Identical gradients in, identical parameters out, step by step."""
    params = _leaves(0)
    tx = tx()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    opt = make()
    tstate = opt.init(tparams)
    for step in range(3):
        grads = _leaves(10 + step)
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update(tstate, tparams, [torch.tensor(grads[k]) for k in tparams])
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), atol=1e-7,
                                       rtol=0, err_msg="{0} step {1}".format(
                                           k, step))


def test_adamw_default_weight_decay_is_optax_s():
    opt = optim.adamw(1e-3).init({"w": torch.zeros(2)})
    assert opt.param_groups[0]["weight_decay"] == 1e-4
    assert opt.param_groups[0]["eps"] == 1e-8
    assert opt.param_groups[0]["betas"] == (0.9, 0.999)


def test_multi_step_equals_single_steps():
    tokens = _batches(seed=5)
    tree = jax.tree.map(np.asarray, _tree(TINY)[1])
    runs = []
    for fused in (False, True):
        model = _port_model(TINY, tree)
        trainer = dp.SyncTrainer(ttr.loss_fn(model),
                                 optim.sgd(0.05, momentum=0.9))
        state = trainer.create_state(dict(model.named_parameters()))
        if fused:
            state, metrics = trainer.multi_step(state, {"tokens": tokens})
            losses = metrics["loss"]
        else:
            losses = []
            for t in tokens:
                state, metrics = trainer.step(state, {"tokens": t})
                losses.append(metrics["loss"])
            losses = torch.stack(losses)
        runs.append((losses, convert.tree_from_model(model), state))
    assert runs[1][0].shape == (STEPS,)
    assert torch.equal(runs[0][0], runs[1][0])
    for path, leaf in convert._flatten(runs[0][1]).items():
        np.testing.assert_array_equal(leaf, convert._flatten(runs[1][1])[path])
    assert int(runs[0][2].step) == int(runs[1][2].step) == STEPS


def test_step_on_device_and_batch_sharding():
    model = _port_model(TINY)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.sgd(0.01))
    state = trainer.create_state(dict(model.named_parameters()))
    assert trainer.batch_sharding() == torch.device("cpu")
    batch = {"tokens": torch.from_numpy(_batches()[0]).to(
        trainer.batch_sharding())}
    state, metrics = trainer.step_on_device(state, batch)
    assert metrics["loss"].shape == () and not metrics["loss"].requires_grad
    assert int(state.step) == 1


def test_loss_matches_jax_and_eval_step():
    model_j, params = _tree(TINY)
    tokens = _batches()[0]
    want = float(jtr.loss_fn(model_j)(params, {"tokens": jnp.asarray(tokens)},
                                      None))
    model = _port_model(TINY, jax.tree.map(np.asarray, params))
    trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.sgd(0.01))
    state = trainer.create_state(dict(model.named_parameters()))
    loss = trainer.eval_step(state, {"tokens": tokens},
                             lambda p, b: ttr.loss_fn(model)(p, b, None))
    assert not loss.requires_grad
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    logits = trainer.eval_step(
        state, {"tokens": tokens},
        lambda p, b: torch.func.functional_call(model, p, (b["tokens"],)))
    want_logits = np.asarray(model_j.apply({"params": params},
                                           jnp.asarray(tokens)))
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-4,
                               rtol=1e-4)


def test_has_aux_metrics_are_stacked():
    model = _port_model(TINY)
    base = ttr.loss_fn(model)

    def loss_with_aux(params, batch, rng):
        loss = base(params, batch, rng)
        return loss, {"twice": 2 * loss.detach()}

    trainer = dp.SyncTrainer(loss_with_aux, optim.sgd(0.01), has_aux=True)
    state = trainer.create_state(dict(model.named_parameters()))
    _, metrics = trainer.multi_step(state, {"tokens": _batches()})
    assert set(metrics) == {"loss", "twice"}
    torch.testing.assert_close(metrics["twice"], 2 * metrics["loss"])


def test_bf16_model_keeps_f32_masters():
    cfg_kw = dict(TINY, dtype="bfloat16")
    tree = convert.init_params_tree(ttr.TransformerConfig(**cfg_kw), seed=1)
    model = _port_model(cfg_kw, tree)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    serving = convert.params_from_flax(tree, ttr.TransformerConfig(**cfg_kw),
                                       device="cpu")
    assert serving.block_0.attn.q.weight.dtype == torch.bfloat16
    assert serving.block_0.ln1.scale.dtype == torch.float32
    trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.adamw(1e-3))
    state = trainer.create_state(dict(model.named_parameters()))
    before = model.block_0.mlp.wo.weight.detach().clone()
    state, metrics = trainer.multi_step(state, {"tokens": _batches()[:2]})
    assert torch.isfinite(metrics["loss"]).all()
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    # a 1e-3 Adam step moves every weight by ~1e-3: it survives in f32
    assert (model.block_0.mlp.wo.weight != before).float().mean() > 0.99
    with torch.no_grad():
        logits = model(torch.from_numpy(_batches()[0]).long())
    assert logits.dtype == torch.float32
    fresh = ttr.Transformer(ttr.TransformerConfig(**cfg_kw), device="cpu",
                            param_dtype=torch.float32)
    assert {p.dtype for p in fresh.parameters()} == {torch.float32}


@pytest.mark.parametrize("kw,item", [
    ({"mesh": object()}, "multi-GPU DP"),
    ({"rules": object()}, "multi-GPU DP"),
    ({"annotations": {}}, "multi-GPU DP"),
    ({"has_model_state": True}, "model state"),
    ({"device_preprocess": lambda b: b},
     "device_preprocess and the shm ring"),
], ids=["mesh", "rules", "annotations", "model_state", "preprocess"])
def test_unported_trainer_knobs_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        dp.SyncTrainer(lambda p, b, r: 0.0, optim.sgd(0.1), **kw)


def test_train_on_feed_is_not_ported():
    """What of ``train_on_feed`` is still not ported: its checkpoint
    hooks."""
    trainer = dp.SyncTrainer(lambda p, b, r: 0.0, optim.sgd(0.1))
    with pytest.raises(NotImplementedError, match="Checkpointing"):
        trainer.train_on_feed(None, None, 8, checkpointer=object())
    with pytest.raises(NotImplementedError, match="Checkpointing"):
        trainer.train_on_feed(None, None, 8, checkpoint_every=2)


def test_train_on_feed_runs_a_tiny_feed():
    from tensorflowonspark_tpu_torch.cluster import manager
    from tensorflowonspark_tpu_torch.cluster.marker import pack_columnar
    from tensorflowonspark_tpu_torch.data.feed import DataFeed

    mgr, _ = manager.start(b"tiny-feed", ["input", "output", "error"])
    try:
        q = mgr.get_queue("input")
        q.put(pack_columnar([{"tokens": t} for t in
                             _batches().reshape(STEPS * B, S)]))
        q.put(None)
        model = _port_model(TINY)
        trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.sgd(0.01))
        state = trainer.create_state(dict(model.named_parameters()))
        state = trainer.train_on_feed(state, DataFeed(mgr), batch_size=B,
                                      max_steps=2, columnar=True)
        assert int(state.step) == 2
        # the cap ended training with a batch in flight: feed terminated
        assert mgr.get("state")._getvalue() == "terminating"
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("field,item", [
    ({"cache_dtype": "int8"}, "int8"),
    ({"fused_qkv": True}, "queue A: fused_qkv"),
    ({"attention_impl": "ring"}, "ring/Ulysses"),
    ({"attention_impl": "ulysses"}, "ring/Ulysses"),
], ids=["int8_cache", "fused_qkv", "ring", "ulysses"])
def test_unported_model_knobs_raise(field, item):
    with pytest.raises(NotImplementedError, match=item):
        model = ttr.Transformer(ttr.TransformerConfig(**dict(TINY, **field)),
                                device="cpu")
        model(torch.zeros((1, 8), dtype=torch.long))


def test_optimizer_rejects_schedules():
    with pytest.raises(TypeError, match="learning_rate"):
        optim.adamw(lambda step: 1e-3)
