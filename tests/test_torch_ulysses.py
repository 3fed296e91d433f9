"""The port's Ulysses attention against the JAX package's, on the CPU in
f32: ``ulysses_attention_sharded`` over 2 and 4 gloo processes (each
passing its shard; the all-to-alls are ``dist.all_to_all_single``)
against the reference's on its 8-device CPU mesh, outputs and the
gradients of ``sum(out * cot)``, at 1e-5 absolute (the same f32
products summed in another order: the port's plain flash path over the
whole row, the reference's Pallas kernels in interpret mode block by
block).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from tensorflowonspark_tpu.ops import ulysses as jul  # noqa: E402
from tensorflowonspark_tpu_torch.ops import ulysses as tul  # noqa: E402
from tensorflowonspark_tpu_torch.ops.ring_attention import (  # noqa: E402
    SeqAxis,
)

ATOL = 1e-5
D = 16
#: heads divide by 4, so every case runs on 2 and on 4 ranks
CASES = {
    "causal_mha": dict(causal=True, window=0, h=4, hkv=4),
    "gqa_window20": dict(causal=True, window=20, h=8, hkv=4),
    "non_causal_mha": dict(causal=False, window=0, h=4, hkv=4),
}


@pytest.fixture(scope="module", params=[2, 4], ids=["p2", "p4"])
def ulysses_run(request, tmp_path_factory):
    """Every case over ``world`` gloo ranks in one group of processes."""
    world = request.param
    out = tmp_path_factory.mktemp("ulysses_p{0}".format(world))
    cases = {n: dict(s, mode="ulysses", seed=10 + i, b=2, s=64, d=D)
             for i, (n, s) in enumerate(sorted(CASES.items()))}
    workers.run_ranks(workers.attention_worker, world, out, str(out), cases)
    return world, str(out), cases


@pytest.mark.parametrize("name", sorted(CASES))
def test_ulysses_attention_sharded_matches_jax(ulysses_run, name):
    world, out_dir, cases = ulysses_run
    spec = cases[name]
    q, k, v, cot = (jnp.asarray(x) for x in workers.attention_inputs(spec))
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("seq",))

    @jax.jit
    def out_and_grads(q, k, v, cot):
        out, vjp = jax.vjp(lambda q, k, v: jul.ulysses_attention_sharded(
            q, k, v, mesh, causal=spec["causal"], window=spec["window"]),
            q, k, v)
        return (out,) + vjp(cot)

    want = [np.asarray(x) for x in out_and_grads(q, k, v, cot)]
    ranks = workers.load_ranks(out_dir, name, world)
    for i, key in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([r[key] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want[i], atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("h,hkv", [(6, 2), (4, 1)])
def test_heads_must_divide_by_the_seq_axis(h, hkv):
    """The reference's refusal, before any all-to-all."""
    q = torch.zeros(1, 8, h, D)
    kv = torch.zeros(1, 8, hkv, D)
    with pytest.raises(ValueError, match="divisible by the seq axis"):
        tul._ulysses(q, kv, kv, SeqAxis(4, 0), True, None, "flash", 1024,
                     1024, 0)


def test_untileable_length_takes_the_dot_step():
    """On CPU tensors ``flash`` takes ``dot`` where the tiling rule
    refuses the sequence (S=96 under 64-row blocks), as the reference
    does (on CUDA tensors it raises); one rank without a process group
    attends locally."""
    q, k, v, _ = (torch.from_numpy(x) for x in workers.attention_inputs(
        dict(seed=4, b=1, s=96, h=2, hkv=2, d=D)))
    got = tul.ulysses_attention(q, k, v, block_q=64, block_k=64, window=9)
    want = tul.ulysses_attention(q, k, v, local_impl="dot", window=9)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="local_impl"):
        tul.ulysses_attention(q, k, v, local_impl="magic")
