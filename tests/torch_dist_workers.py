"""Processes for the port's multi-process tests: ``torch.distributed``
over ``gloo`` on the CPU, one spawned process per rank.

Kept apart from the test files so that the spawned ranks import only
``torch`` and the port (never ``jax``).  Every worker makes its inputs
from numpy seeds, as the test that compares it with the JAX package
does, and writes what it computed to ``out_dir`` as ``.npz`` files.
"""

import os
import pickle
import time
import uuid

import numpy as np
import torch

#: seconds a group of ranks may take before the test fails
TIMEOUT = 150


def _entry(rank, fn, world, init, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init,
                            world_size=world, rank=rank)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, tmp_dir, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in
    one gloo group; raises if a rank fails or :data:`TIMEOUT` passes."""
    import torch.multiprocessing as mp

    init = os.path.join(str(tmp_dir), "rdv-" + uuid.uuid4().hex)
    ctx = mp.start_processes(_entry, args=(fn, world, init, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError("ranks of {0} did not finish in {1} s".format(
                fn.__name__, TIMEOUT))


# -- attention -------------------------------------------------------------


def attention_inputs(spec):
    """Global q, k, v and the output cotangent of an attention case."""
    rng = np.random.default_rng(spec["seed"])
    b, s, h, hkv, d = (spec[n] for n in ("b", "s", "h", "hkv", "d"))
    shapes = [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def attention_worker(rank, world, out_dir, cases):
    """Each case's ring or Ulysses attention over a ``{"seq": world}``
    mesh on this rank's shards: output and gradients of
    ``sum(out * cot)``, written to ``<case>.<rank>.npz``."""
    from tensorflowonspark_tpu_torch.ops import ring_attention as ra
    from tensorflowonspark_tpu_torch.ops import ulysses as ul
    from tensorflowonspark_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh({"seq": world})
    for name, spec in cases.items():
        q, k, v, cot = attention_inputs(spec)
        sl = spec["s"] // world
        part = slice(rank * sl, (rank + 1) * sl)
        ql, kl, vl = (torch.from_numpy(x[:, part].copy()).requires_grad_(True)
                      for x in (q, k, v))
        kw = dict(causal=spec["causal"], window=spec["window"])
        if spec["mode"] == "ring":
            out = ra.ring_attention_sharded(ql, kl, vl, mesh,
                                            impl=spec["impl"], **kw)
        else:
            out = ul.ulysses_attention_sharded(ql, kl, vl, mesh, **kw)
        out.backward(torch.from_numpy(cot[:, part].copy()))
        np.savez(os.path.join(out_dir, "{0}.{1}.npz".format(name, rank)),
                 out=out.detach().numpy(), dq=ql.grad.numpy(),
                 dk=kl.grad.numpy(), dv=vl.grad.numpy())


# -- training --------------------------------------------------------------


def _port_model(tree, cfg_kw, mesh):
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer as ttr

    cfg = ttr.TransformerConfig(**dict(cfg_kw, mesh=mesh))
    return convert.params_from_flax(tree, cfg, device="cpu",
                                    param_dtype=torch.float32)


def train_worker(rank, world, out_dir, specs):
    """For each named spec, train the port's Transformer with
    ``SyncTrainer`` and write ``<name>.<rank>.npz``: the losses and every
    weight after the last step.

    A spec holds ``cfg`` (``TransformerConfig`` fields), ``tree`` (a
    pickled Flax tree to start from, or ``None`` for a rank-seeded init
    that differs on every rank, to show the rank-0 start), ``mesh``
    (``None`` for the default trainer, else ``build_mesh``'s axes),
    ``lr`` and ``tokens`` ``[steps, B, S]``: each rank takes the rows of
    its ``data`` coordinate."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import transformer as ttr
    from tensorflowonspark_tpu_torch.parallel import dp

    for name, spec in specs.items():
        mesh = None
        if spec["mesh"] is not None:
            from tensorflowonspark_tpu_torch.parallel.mesh import build_mesh

            mesh = build_mesh(spec["mesh"])
        if spec["tree"] is None:
            torch.manual_seed(100 + rank)  # a different start on every rank
            model = ttr.Transformer(ttr.TransformerConfig(**spec["cfg"]),
                                    device="cpu", param_dtype=torch.float32)
        else:
            with open(spec["tree"], "rb") as f:
                tree = pickle.load(f)
            model = _port_model(tree, spec["cfg"], mesh)
        trainer = dp.SyncTrainer(ttr.loss_fn(model),
                                 optim.sgd(spec["lr"], momentum=0.9),
                                 mesh=mesh, data_axes=("data",))
        state = trainer.create_state(dict(model.named_parameters()))
        if mesh is None:
            data_size, data_index = world, rank
        else:
            data_size = mesh.axis_size("data")
            data_index = mesh.axis_index("data")
        tokens = np.asarray(spec["tokens"])
        rows = tokens.shape[1] // data_size
        part = slice(data_index * rows, (data_index + 1) * rows)
        losses = []
        for batch in tokens:
            state, metrics = trainer.step(state, {"tokens": batch[part]})
            losses.append(metrics["loss"].item())
        flat = convert._flatten(convert.tree_from_model(model))
        np.savez(os.path.join(out_dir, "{0}.{1}.npz".format(name, rank)),
                 losses=np.asarray(losses),
                 **{"param/" + k: np.asarray(v) for k, v in flat.items()})


def mesh_worker(rank, world, out_dir, axes):
    """``build_mesh(axes)`` seen from this rank, and a sum over each of
    its axis groups: writes ``mesh.<rank>.npz``."""
    import torch.distributed as dist

    from tensorflowonspark_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(axes)
    out = {"ranks": np.asarray(mesh.ranks)}
    for name in mesh.axis_names:
        out["coord/" + name] = np.asarray(mesh.axis_index(name))
        out["line/" + name] = np.asarray(mesh.line(name))
        x = torch.tensor([float(rank)])
        if mesh.group(name) is not None:
            dist.all_reduce(x, group=mesh.group(name))
        out["sum/" + name] = x.numpy()
    np.savez(os.path.join(out_dir, "mesh.{0}.npz".format(rank)), **out)


def load_ranks(out_dir, name, world):
    """The ``.npz`` files ``<name>.<rank>.npz`` of every rank."""
    return [dict(np.load(os.path.join(out_dir, "{0}.{1}.npz".format(
        name, r)))) for r in range(world)]


# -- checkpoints -------------------------------------------------------------

#: the tiny Transformer of the checkpoint tests
CKPT_TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                 head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=64,
                 dtype="float32", attention_impl="flash")


def checkpoint_worker(rank, world, out_dir, ckpt_dir):
    """Two steps of the tiny Transformer from rank 0's start, saved at
    step 2 (rank 0 writes, every rank waits), then restored into a state
    whose weights each rank perturbed its own way: writes the saved and
    the restored weights and what this rank saw on disk when ``save``
    returned, as ``ckpt.<rank>.npz``."""
    from tensorflowonspark_tpu_torch import checkpoint, convert, optim
    from tensorflowonspark_tpu_torch.models import transformer as ttr
    from tensorflowonspark_tpu_torch.parallel import dp

    def trained(seed):
        torch.manual_seed(seed)
        model = ttr.Transformer(ttr.TransformerConfig(**CKPT_TINY),
                                device="cpu", param_dtype=torch.float32)
        trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.adamw(1e-3))
        return model, trainer, trainer.create_state(
            dict(model.named_parameters()))

    model, trainer, state = trained(100 + rank)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 2, 64))
    for t in tokens:
        state, _ = trainer.step(state, {"tokens": t.astype(np.int32)})
    saved = convert._flatten(convert.tree_from_model(model))
    ckptr = checkpoint.Checkpointer(ckpt_dir)
    ckptr.save(2, state, wait=True)
    on_disk = checkpoint.list_serving_steps(ckpt_dir)
    ckptr.close()

    model2, _, fresh = trained(200 + rank)
    with torch.no_grad():
        for p in model2.parameters():
            p.add_(float(rank + 1))
    restored = checkpoint.Checkpointer(ckpt_dir).restore(fresh)
    got = convert._flatten(convert.tree_from_model(model2))
    np.savez(os.path.join(out_dir, "ckpt.{0}.npz".format(rank)),
             on_disk=np.asarray(on_disk), step=int(restored.step),
             count=int(fresh.opt_state.state[
                 next(iter(fresh.params.values()))]["count"]),
             **{"saved/" + k: v for k, v in saved.items()},
             **{"restored/" + k: v for k, v in got.items()})


def resumable_train_fn(args, ctx):
    """The user fn of the cluster crash-and-resume test (the reference's
    ``tests/test_checkpoint.py`` ``_resumable_train_fn``, on the port): a
    linear model trained one step at a time, each step saved; it raises
    after saving ``args["fail_at"]``, and a restart resumes from the
    latest step (its batches drawn anew from the seed, as the
    reference's).  A run that completes writes ``w-final.npy``."""
    from tensorflowonspark_tpu_torch import checkpoint, optim
    from tensorflowonspark_tpu_torch.parallel import dp

    def loss(params, batch, rng):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()

    trainer = dp.SyncTrainer(loss, optim.sgd(0.05))
    state = trainer.create_state({"w": torch.zeros(2, requires_grad=True)})
    ckptr = checkpoint.Checkpointer(args["dir"], max_to_keep=None)
    latest = ckptr.latest_step()
    if latest is not None:
        state = ckptr.restore(state, step=latest)
    rng = np.random.RandomState(0)
    w_true = np.array([3.0, -1.0], np.float32)
    for _ in range(int(state.step), args["total_steps"]):
        x = rng.rand(16, 2).astype(np.float32)
        state, _ = trainer.step(state, (x, (x @ w_true).astype(np.float32)))
        ckptr.save(int(state.step), state, wait=True)
        if args["fail_at"] is not None and int(state.step) == args["fail_at"]:
            ckptr.close()
            raise RuntimeError("injected crash at step %d" % args["fail_at"])
    ckptr.close()
    np.save(os.path.join(args["dir"], "w-final.npy"),
            state.params["w"].detach().numpy())


# -- elastic supervision -----------------------------------------------------

#: steps between the elastic fns' checkpoints
ELASTIC_CKPT_EVERY = 4


def tokens_fingerprint(tokens):
    """sha256 of a token batch's bytes (int32, C order): the id of a
    batch in the elastic fns' step logs."""
    import hashlib

    return hashlib.sha256(
        np.ascontiguousarray(tokens, dtype=np.int32).tobytes()).hexdigest()


def elastic_model():
    """The tiny Transformer (seed 0, f32 masters), its ``SyncTrainer``
    (adamw 1e-3) and a fresh state: what the elastic fn trains and what
    the tests replay."""
    from tensorflowonspark_tpu_torch import optim
    from tensorflowonspark_tpu_torch.models import transformer as ttr
    from tensorflowonspark_tpu_torch.parallel import dp

    torch.manual_seed(0)
    model = ttr.Transformer(ttr.TransformerConfig(**CKPT_TINY), device="cpu",
                            param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.adamw(1e-3))
    return model, trainer, trainer.create_state(
        dict(model.named_parameters()))


def link_step(ckpt_dir, step, keep_dir):
    """Hard-link checkpoint ``step`` of ``ckpt_dir`` under ``keep_dir``,
    so it outlives the checkpointer's retention at no cost in disk."""
    import shutil

    shutil.copytree(os.path.join(ckpt_dir, str(step)),
                    os.path.join(keep_dir, str(step)), copy_function=os.link,
                    dirs_exist_ok=True)


def elastic_train_fn(args, ctx):
    """The user fn of the elastic tests: the tiny Transformer trained from
    the feed by ``train_on_feed`` with a ``Checkpointer`` (every
    ``ELASTIC_CKPT_EVERY`` steps, two kept) and the chaos plan's kill
    hook, under ``torch.distributed`` (gloo) when the cluster has several
    compute nodes.

    Each step appends ``{"step", "fp", "loss"}`` to
    ``<log>/gen<g>.rank<r>.jsonl`` as it ends (a killed incarnation
    leaves the steps it took); a process that restored a checkpoint
    hard-links that step under ``args["keep"]`` (rank 0) and logs it as
    ``{"restored": step}``; a process that finishes writes
    ``<log>/final.rank<r>.json`` with its generation, step count and the
    digest of its weights."""
    import hashlib
    import json

    from tensorflowonspark_tpu_torch import checkpoint
    from tensorflowonspark_tpu_torch.testing import chaos

    torch.set_num_threads(1)
    ctx.initialize_distributed()
    rank = ctx.process_id
    model, trainer, state = elastic_model()
    ckptr = checkpoint.Checkpointer(args["ckpt"], max_to_keep=2)
    log = open(os.path.join(args["log"], "gen{0}.rank{1}.jsonl".format(
        ctx.generation, rank)), "a")

    def write(rec):
        log.write(json.dumps(rec) + "\n")
        log.flush()

    restore = ckptr.restore

    def keep_restored(state_like, step=None):
        step = ckptr.latest_step() if step is None else step
        out = restore(state_like, step=step)
        if rank == 0:
            link_step(args["ckpt"], step, args["keep"])
        write({"restored": int(step)})
        return out

    ckptr.restore = keep_restored
    fps = []
    place = trainer._place

    def logged_place(batch):
        fps.append(tokens_fingerprint(batch["tokens"]))
        return place(batch)

    trainer._place = logged_place
    state = trainer.train_on_feed(
        state, ctx.get_data_feed(), batch_size=args["batch"], columnar=True,
        checkpointer=ckptr, checkpoint_every=ELASTIC_CKPT_EVERY,
        step_callback=chaos.step_fault_fn(ctx),
        metrics_callback=lambda step, m: write(
            {"step": step, "fp": fps[-1], "loss": float(m["loss"])}))
    ckptr.close()
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().numpy().tobytes())
    with open(os.path.join(args["log"], "final.rank{0}.json".format(rank)),
              "w") as f:
        json.dump({"generation": ctx.generation, "steps": int(state.step),
                   "weights": digest.hexdigest()}, f)


def elastic_tokens(seed, batches, batch, seq=64, vocab=256):
    """``[batches, batch, seq]`` int32 tokens drawn from ``seed``: the
    elastic tests' data, one partition per batch."""
    return np.random.default_rng(seed).integers(
        0, vocab, (batches, batch, seq)).astype(np.int32)


def elastic_rows(seed, batches, batch, index):
    """Partition ``index`` of :func:`elastic_tokens` as rows, made on the
    executor (the callable form of a partition)."""
    return [{"tokens": r} for r in elastic_tokens(seed, batches,
                                                  batch)[index]]


def idle_fn(args, ctx):
    """A user fn that returns at once."""


# -- the pipeline API --------------------------------------------------------

#: the serving knobs of the pipeline tests' exports (the CPU device is a
#: deployment knob of the port's builder)
PIPELINE_GEN = dict(mode="generate", kv_layout="paged", kv_page_tokens=8,
                    max_new_tokens=8, chunk_size=4, pad_multiple=16,
                    max_prompt_len=40)
PORT_MODEL_REF = "tensorflowonspark_tpu_torch.models.transformer:serving_builder"


def pipeline_model(tree):
    """The tiny Transformer on the CPU from a Flax-layout tree (f32), its
    ``SyncTrainer`` (adamw 1e-3) and a fresh state."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import transformer as ttr
    from tensorflowonspark_tpu_torch.parallel import dp

    model = convert.params_from_flax(
        tree, ttr.TransformerConfig(**CKPT_TINY), device="cpu",
        param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.adamw(1e-3))
    return model, trainer, trainer.create_state(
        dict(model.named_parameters()))


def pipeline_train_fn(args, ctx):
    """The ``TFEstimator`` train fn of the pipeline tests: the tiny
    Transformer from ``args.tree`` trained on the feed's ``tokens`` column
    (one thread, so the losses can be replayed to the bit), the losses
    written to ``args.losses``; worker 0 exports the weights with the
    port's ``model_ref``, a CPU generation ``model_config`` and the output
    schema that ``serving.infer_output_schema`` gives for a sample
    prompt."""
    import json

    from tensorflowonspark_tpu_torch import checkpoint, convert, serving
    from tensorflowonspark_tpu_torch.models import transformer as ttr

    torch.set_num_threads(1)
    model, trainer, state = pipeline_model(args.tree)
    losses = []
    trainer.train_on_feed(
        state, ctx.get_data_feed(input_mapping=args.input_mapping),
        batch_size=args.batch_size, columnar=True,
        metrics_callback=lambda step, m: losses.append(float(m["loss"])))
    with open(args.losses, "w") as f:
        json.dump(losses, f)
    if ctx.job_name == "worker" and ctx.task_index == 0:
        tree = convert.tree_from_model(model)
        config = dict(CKPT_TINY, **PIPELINE_GEN, device="cpu")
        config.pop("attention_impl")
        schema = serving.infer_output_schema(
            ttr.serving_builder(tree, config),
            {"prompt": np.arange(5, dtype=np.int32)}, {"prompt": "tokens"})
        checkpoint.save_for_serving(
            args.export_dir, tree, output_schema=schema, extra_metadata={
                "model_ref": PORT_MODEL_REF, "model_config": config})


def pipeline_count_fn(args, ctx):
    """A ``TFEstimator`` train fn that consumes its feed and writes the
    rows it got to ``<args.out>/rows-<executor>.json``."""
    import json

    feed = ctx.get_data_feed(input_mapping=args.input_mapping)
    rows = []
    while not feed.should_stop():
        batch = feed.next_batch(4)
        rows.extend([np.asarray(v).tolist() for v in row]
                    for row in zip(*(batch[k] for k in sorted(batch))))
    with open(os.path.join(args.out, "rows-{0}.json".format(
            ctx.executor_id)), "w") as f:
        json.dump(rows, f)


def pipeline_export_fn(args, ctx):
    """A ``TFEstimator`` export fn that records which node ran it."""
    with open(os.path.join(args.out, "export-{0}-{1}".format(
            ctx.job_name, ctx.task_index)), "w") as f:
        f.write(str(ctx.executor_id))


# -- model state -------------------------------------------------------------


def bn_train(spec, rank=0, world=1):
    """ResNetCIFAR (depth 8, f32) from the pickled Flax variables at
    ``spec["variables"]``, trained by ``SyncTrainer(has_model_state=True)``
    with ``sgd(spec["lr"], momentum=0.9)`` on this rank's share of each
    global batch of ``spec["images"]`` / ``spec["labels"]`` (``[steps, B,
    ...]``), over ``build_mesh(spec["mesh"])`` when a mesh is given.
    Returns the losses and the final Flax variables, flattened
    (``params/...``, ``batch_stats/...``)."""
    from tensorflowonspark_tpu_torch import optim
    from tensorflowonspark_tpu_torch.models import layers, resnet
    from tensorflowonspark_tpu_torch.parallel import dp

    with open(spec["variables"], "rb") as f:
        variables = pickle.load(f)
    model = resnet.ResNetCIFAR(depth=8, dtype="float32", device="cpu")
    resnet.params_from_flax(variables, model)
    mesh = None
    if spec.get("mesh") is not None and world > 1:
        from tensorflowonspark_tpu_torch.parallel.mesh import build_mesh

        mesh = build_mesh(spec["mesh"])
    trainer = dp.SyncTrainer(resnet.loss_fn(model),
                             optim.sgd(spec["lr"], momentum=0.9),
                             mesh=mesh, data_axes=("data",),
                             has_model_state=True)
    state = trainer.create_state(dict(model.named_parameters()),
                                 {"batch_stats": dict(model.named_buffers())})
    rows = spec["images"].shape[1] // world
    part = slice(rank * rows, (rank + 1) * rows)
    losses = []
    for x, y in zip(spec["images"], spec["labels"]):
        state, metrics = trainer.step(state, (x[part], y[part]))
        losses.append(metrics["loss"].item())
    out = {"losses": np.asarray(losses)}
    for coll, tree in resnet.tree_from_model(model).items():
        for path, leaf in layers._flatten(tree).items():
            out[coll + "/" + path] = leaf
    return out


def bn_train_worker(rank, world, out_dir, spec):
    """:func:`bn_train` on this rank's rows; writes ``bn.<rank>.npz``."""
    np.savez(os.path.join(out_dir, "bn.{0}.npz".format(rank)),
             **bn_train(spec, rank, world))


# -- MNIST -------------------------------------------------------------------

MNIST_REF = "tensorflowonspark_tpu.models.mlp:serving_builder"


def mnist_spark_fn(args, ctx):
    """``examples/mnist/mnist_spark.py``'s ``main_fun`` on the port, on
    the CPU: ``MNISTNet`` under ``adam(1e-3)`` through ``train_on_feed(
    columnar=True)`` with dropout from a seeded generator, then
    ``save_for_serving``; writes the per-step losses to ``args["out"]``."""
    import json

    from tensorflowonspark_tpu_torch import optim
    from tensorflowonspark_tpu_torch.checkpoint import save_for_serving
    from tensorflowonspark_tpu_torch.models import mlp
    from tensorflowonspark_tpu_torch.parallel import dp

    torch.manual_seed(0)
    model = mlp.MNISTNet(device="cpu")
    trainer = dp.SyncTrainer(mlp.loss_fn(model), optim.adam(1e-3),
                             has_aux=True)
    state = trainer.create_state(dict(model.named_parameters()))

    def preprocess(cols):
        images, labels = cols
        return {"image": np.asarray(images, np.float32),
                "label": np.asarray(labels, np.int64).reshape(-1)}

    losses = []
    state = trainer.train_on_feed(
        state, ctx.get_data_feed(train_mode=True),
        batch_size=args["batch_size"], preprocess=preprocess,
        max_steps=args["steps"], columnar=True,
        rng=torch.Generator().manual_seed(0),
        metrics_callback=lambda step, m: losses.append(m["loss"].item()))
    save_for_serving(args["export_dir"],
                     mlp.tree_from_model(model)["params"],
                     extra_metadata={"model_ref": MNIST_REF,
                                     "model_config": {"input_name": "image"}})
    with open(args["out"], "w") as f:
        json.dump({"losses": losses, "steps": int(state.step)}, f)
