"""``SyncTrainer`` over several processes, and the port's process-group
mesh, on the CPU (gloo).

The reference's contract (``tests/test_distributed.py:11-19``): the
processes of one job run ONE synchronised data-parallel step, so their
per-step losses are identical, and so are their weights.  Here two gloo
ranks, each starting from its own random weights and training on its own
half of the global batch, must report identical losses and end with
identical weights (the all-reduce gives every rank the same sums), equal
to one process training on the global batch from rank 0's weights:
losses rtol 1e-5, weights atol 1e-5 (the same f32 gradients summed in
another order), as the port's other trajectory tests.
"""

import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from tensorflowonspark_tpu_torch import convert, optim
from tensorflowonspark_tpu_torch.models import transformer as ttr
from tensorflowonspark_tpu_torch.parallel import dp
from tensorflowonspark_tpu_torch.parallel import mesh as pm

TINY = dict(vocab_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, embed_dim=64, mlp_dim=128, max_seq_len=64,
            dtype="float32", attention_impl="flash")
STEPS, B, S, LR = 3, 4, 64, 0.05


def _tokens(seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (STEPS, B, S)).astype(np.int32)


def _one_process_run(tokens):
    """The global batch in one process, from rank 0's start."""
    torch.manual_seed(100)
    model = ttr.Transformer(ttr.TransformerConfig(**TINY), device="cpu",
                            param_dtype=torch.float32)
    trainer = dp.SyncTrainer(ttr.loss_fn(model), optim.sgd(LR, momentum=0.9))
    state = trainer.create_state(dict(model.named_parameters()))
    losses = []
    for batch in tokens:
        state, metrics = trainer.step(state, {"tokens": batch})
        losses.append(metrics["loss"].item())
    return np.asarray(losses), convert._flatten(convert.tree_from_model(model))


@pytest.fixture(scope="module")
def one_process_run():
    return _one_process_run(_tokens())


@pytest.mark.parametrize("name,mesh", [("default", None),
                                       ("mesh_data", {"data": 2})])
def test_ranks_train_one_model_on_the_global_batch(one_process_run, tmp_path,
                                                   name, mesh):
    want_losses, want_params = one_process_run
    spec = dict(cfg=TINY, tree=None, mesh=mesh, lr=LR, tokens=_tokens())
    workers.run_ranks(workers.train_worker, 2, tmp_path, str(tmp_path),
                      {name: spec})
    r0, r1 = workers.load_ranks(str(tmp_path), name, 2)
    # one synchronised step: the same losses and weights on every rank
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    for key in r0:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    # and the step of one process over the global batch
    np.testing.assert_allclose(r0["losses"], want_losses, rtol=1e-5)
    assert {"param/" + k for k in want_params} == set(r0) - {"losses"}
    for path, want in want_params.items():
        np.testing.assert_allclose(r0["param/" + path], want, atol=1e-5,
                                   rtol=0, err_msg=path)


def test_mesh_groups_follow_the_reference_layout(tmp_path):
    """``{"data": 2, "seq": 2}`` over four ranks, row-major as the
    reference's device mesh: the seq lines are [0, 1] and [2, 3], the
    data lines [0, 2] and [1, 3], and each group sums over its line."""
    workers.run_ranks(workers.mesh_worker, 4, tmp_path, str(tmp_path),
                      {"data": 2, "seq": 2})
    ranks = workers.load_ranks(str(tmp_path), "mesh", 4)
    for r, got in enumerate(ranks):
        assert list(got["ranks"]) == [0, 1, 2, 3]
        assert (int(got["coord/data"]), int(got["coord/seq"])) == divmod(r, 2)
        seq_line = [2 * (r // 2), 2 * (r // 2) + 1]
        data_line = [r % 2, r % 2 + 2]
        assert list(got["line/seq"]) == seq_line
        assert list(got["line/data"]) == data_line
        assert float(got["sum/seq"][0]) == sum(seq_line)
        assert float(got["sum/data"][0]) == sum(data_line)


def test_mesh_of_one_process():
    """No process group: one rank, every axis of size 1, no groups."""
    mesh = pm.build_mesh()
    assert mesh.shape == {"data": 1} and mesh.size == 1
    assert mesh.world_group is None and mesh.group("data") is None
    assert mesh.line("seq") == [0] and mesh.axis_index("seq") == 0
    with pytest.raises(ValueError, match="needs 2 devices"):
        pm.build_mesh({"seq": 2})


@pytest.mark.parametrize("axes,n", [
    ({"seq": 2, "data": -1}, 8),
    ([("seq", 2), ("data", -1)], 8),
    ({"data": 2, "fsdp": 2, "model": 2}, 8),
    ({"custom": 4, "data": 1}, 4),
    ({"model": 2, "expert": 2, "pipe": 2}, 8),
])
def test_mesh_spec_resolves_as_the_reference(axes, n):
    from tensorflowonspark_tpu.parallel import mesh as jm

    def spec(mod):
        if isinstance(axes, dict):
            return mod.MeshSpec(**axes)
        return mod.MeshSpec.from_axes(axes)

    assert spec(pm).resolve(n) == spec(jm).resolve(n)


def test_mesh_sizes_and_local_batch():
    mesh = pm.build_mesh()
    assert pm.mesh_axis_size(mesh, "data", "seq") == 1
    assert pm.local_batch_size(mesh, 8) == 8


def test_trainer_takes_only_a_port_mesh():
    with pytest.raises(TypeError, match="build_mesh"):
        dp.SyncTrainer(lambda p, b, r: 0.0, optim.sgd(0.1), mesh=object())


def test_planted_reduction_fault_still_applies_to_the_trainer():
    """``chip_mutants.py``'s ``sp_grads_seq_mean`` (gradients averaged over
    every rank of the mesh) finds its line in ``parallel/dp.py`` exactly
    once, and its check is the four-card ``sp_train_flagship``."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_mutants", os.path.join(root, "chip_mutants.py"))
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    name = "sp_grads_seq_mean"
    _, subs, check = mutants.MUTANTS[name]
    assert check in mutants.CHECKS and name in mutants.FOUR_CARD
    with open(os.path.join(root, mutants.SOURCES[name])) as f:
        text = f.read()
    mutated = mutants.mutate(text, subs)
    assert mutated != text
    with pytest.raises(ValueError, match="found 0 times"):
        mutants.mutate(mutated, subs)
