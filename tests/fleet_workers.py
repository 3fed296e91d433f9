"""User fns of the fleet-telemetry tests, one set per package: the
spawned compute processes import this module by name, and it imports
nothing of either package (nor ``torch`` or ``jax``) at module level, so
each process loads only the package it runs.

Every fn writes ``<args["out"]>/<executor>.json`` when its feed ends:
its steps, pid, the feed's wire counts, and ``TFOS_PROFILE_DIR`` as its
environment held it.
"""

import json
import os
import time


def _write(args, ctx, **fields):
    path = os.path.join(args["out"], "%d.json" % ctx.executor_id)
    with open(path, "w") as f:
        json.dump(dict(fields, pid=os.getpid(),
                       profile_env=os.environ.get("TFOS_PROFILE_DIR")), f)


def port_train_fn(args, ctx):
    """The tiny Transformer trained from the node's feed on the CPU by
    the port's ``train_on_feed``; executors named in ``args["marks"]``
    first mark a ``watchdog_fire`` (a flight-recorder trigger)."""
    import torch

    from tensorflowonspark_tpu_torch import convert, optim, telemetry
    from tensorflowonspark_tpu_torch.models import transformer as ttr
    from tensorflowonspark_tpu_torch.parallel import dp

    if ctx.executor_id in args.get("marks", ()):
        telemetry.get_tracer().mark("watchdog_fire", severity="page",
                                    injected=True)
    model = convert.params_from_flax(
        args["tree"], ttr.TransformerConfig(**args["config"]),
        device="cpu", param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.sgd(0.05))
    state = trainer.create_state(dict(model.named_parameters()))
    feed = ctx.get_data_feed()
    state = trainer.train_on_feed(state, feed, batch_size=args["batch"],
                                  columnar=True, log_every=0)
    _write(args, ctx, steps=int(state.step), wire=feed.wire_stats())


def jax_train_fn(args, ctx):
    """:func:`port_train_fn` on the JAX package."""
    import jax
    import optax

    from tensorflowonspark_tpu.models import transformer as jtr
    from tensorflowonspark_tpu.parallel import dp as jdp
    from tensorflowonspark_tpu.parallel.mesh import build_mesh

    model = jtr.Transformer(jtr.TransformerConfig(**args["config"]))
    trainer = jdp.SyncTrainer(jtr.loss_fn(model), optax.sgd(0.05),
                              mesh=build_mesh(devices=jax.devices()[:1]))
    state = trainer.create_state(args["tree"])
    feed = ctx.get_data_feed()
    state = trainer.train_on_feed(state, feed, batch_size=args["batch"],
                                  columnar=True, log_every=0)
    _write(args, ctx, steps=int(state.step), wire=feed.wire_stats())


def port_straggler_fn(args, ctx):
    """A feed loop that publishes the series the health plane scrapes
    (``train.step_sec``, ``train.feed_wait_sec``, ``train.steps``), with
    the chaos plan's feed stall around the feed (the reference's
    ``tests/test_chaos.py`` straggler fn, on the port)."""
    import numpy as np

    from tensorflowonspark_tpu_torch import telemetry, tensorboard
    from tensorflowonspark_tpu_torch.testing import chaos

    reg = telemetry.get_registry()
    h_step = reg.histogram("train.step_sec")
    h_feed = reg.histogram("train.feed_wait_sec")
    steps = reg.counter("train.steps")
    feed = ctx.get_data_feed(train_mode=True)
    delay = chaos.slow_feed_fn(ctx)
    if delay is not None:
        feed = chaos.SlowFeed(feed, delay)
    n = 0
    while not feed.should_stop():
        t0 = time.perf_counter()
        rows = feed.next_batch(4)
        h_feed.observe(time.perf_counter() - t0)
        if not rows:
            continue
        t1 = time.perf_counter()
        float(np.sum(np.asarray(rows, dtype=np.float64)))
        time.sleep(0.004)
        h_step.observe(time.perf_counter() - t1)
        steps.inc()
        n += 1
        # feeds the requested capture, so its steps run out while
        # batches still flow (train_on_feed does the same)
        tensorboard.profile_step()
    _write(args, ctx, steps=n)
