"""User fns of ``tests/test_torch_remediation_hold.py``: the spawned compute
processes import this module by name, and it imports nothing of either
package (nor ``torch``) at module level.

- :func:`hold_train_fn`: the reference's hold e2e fn
  (``tests/test_remediation.py`` ``_hold_train_fn``) in torch: paced
  linear-regression SGD from the feed with ``Checkpointer`` auto-resume.
  Each step publishes ``hold_progress`` (this process's generation and
  steps) into the node's kv, so a driver can key a hold and its release
  on steps trained; each process logs its losses to
  ``<log>/e<executor>.g<generation>.jsonl``.
- :func:`straggler_fn`: a feed loop that publishes the series the health
  plane scrapes, with the chaos plan's feed stall around its feed.
"""

import json
import os
import time

#: the linear model the hold fn learns: y = 2 x0 - 3 x1 + 1
W_TRUE, B_TRUE = (2.0, -3.0), 1.0


def make_rows(n, seed):
    """``n`` rows ``(x0, x1, y)`` of the linear model, from ``seed``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.randn(n, 2)
    y = W_TRUE[0] * x[:, 0] + W_TRUE[1] * x[:, 1] + B_TRUE
    return [(float(a), float(b), float(c)) for (a, b), c in zip(x, y)]


def held_out_loss(w, b):
    """Mean squared error of ``(w, b)`` on 256 held-out rows."""
    import numpy as np

    rows = np.asarray(make_rows(256, seed=999))
    err = rows[:, :2] @ np.asarray(w) + b - rows[:, 2]
    return float(np.mean(err ** 2))


def hold_train_fn(args, ctx):
    import torch

    from tensorflowonspark_tpu_torch.checkpoint import Checkpointer

    torch.set_num_threads(1)
    ckpt = Checkpointer(os.path.join(args["ckpt_dir"],
                                     "w%d" % ctx.task_index),
                        max_to_keep=None)
    # w[:2] the weights, w[2] the bias; 1-D tensors only
    state = {"w": torch.zeros(3, dtype=torch.float64),
             "step": torch.zeros(1, dtype=torch.int64)}
    if ckpt.latest_step() is not None:
        state = ckpt.restore(state)
    step = int(state["step"][0])
    trained = 0
    log = open(os.path.join(args["log"], "e{0}.g{1}.jsonl".format(
        ctx.executor_id, ctx.generation)), "a")
    feed = ctx.get_data_feed(train_mode=True)
    while not feed.should_stop():
        rows = feed.next_batch(16)
        if not rows:
            continue
        time.sleep(args.get("pace_sec", 0.02))
        arr = torch.tensor(rows, dtype=torch.float64)
        x = torch.cat([arr[:, :2], torch.ones(len(arr), 1,
                                              dtype=torch.float64)], 1)
        err = x @ state["w"] - arr[:, 2]
        loss = float((err ** 2).mean())
        state["w"] = state["w"] - args["lr"] * (x.T @ err) / len(err)
        step += 1
        trained += 1
        state["step"] = torch.tensor([step], dtype=torch.int64)
        log.write(json.dumps({"step": step, "loss": loss}) + "\n")
        log.flush()
        ctx.mgr.set("hold_progress", {"generation": ctx.generation,
                                      "steps": trained})
        if step % args["ckpt_every"] == 0:
            ckpt.save(step, state, wait=True)
            feed.commit_partitions()
    ckpt.save(step, state, wait=True)
    feed.commit_partitions()
    ckpt.close()
    w = state["w"].tolist()
    ctx.mgr.set("final_loss", held_out_loss(w[:2], w[2]))
    ctx.mgr.set("generation_seen", ctx.generation)


def straggler_fn(args, ctx):
    """A feed loop that publishes ``train.step_sec``,
    ``train.feed_wait_sec`` and ``train.steps`` (the health plane's
    straggler series), with the chaos plan's feed stall around its feed
    (``fleet_workers.port_straggler_fn``, with two changes for an elastic
    cluster): the first pull of each process, which waits for the feed to
    start (or to resume after a re-rendezvous), is not observed, so only
    the planted stall reads as a straggler; and the fn commits what it
    consumed every few steps, as a checkpointing trainer would, so a
    re-rendezvous requeues only the partitions in flight."""
    import numpy as np

    from tensorflowonspark_tpu_torch import telemetry
    from tensorflowonspark_tpu_torch.testing import chaos

    reg = telemetry.get_registry()
    h_step = reg.histogram("train.step_sec")
    h_feed = reg.histogram("train.feed_wait_sec")
    steps = reg.counter("train.steps")
    feed = ctx.get_data_feed(train_mode=True)
    delay = chaos.slow_feed_fn(ctx)
    if delay is not None:
        feed = chaos.SlowFeed(feed, delay)
    pulls = 0
    while not feed.should_stop():
        t0 = time.perf_counter()
        rows = feed.next_batch(4)
        if pulls:
            h_feed.observe(time.perf_counter() - t0)
        pulls += 1
        if not rows:
            continue
        t1 = time.perf_counter()
        float(np.sum(np.asarray(rows, dtype=np.float64)))
        time.sleep(args.get("pace_sec", 0.01))
        h_step.observe(time.perf_counter() - t1)
        steps.inc()
        if steps.value % 4 == 0:
            feed.commit_partitions()
    feed.commit_partitions()
