"""The port's ring attention and the ``q_offset`` path of its flash
kernels against the JAX package's, on the CPU in f32.

- ``_fwd_core``/``_bwd_core`` with ``q_offset > 0`` (the chunk at ring
  distance m), causal and windowed, GQA: the port's plain versions (what
  its K2-K4 compute) against the reference's Pallas kernels in interpret
  mode, at 1e-5 absolute.  Rows that see no key of the chunk are held to
  a finite output and an lse of -1e30; their output is the reference's
  own artefact of its block structure, so it is compared only where a
  row sees a key.
- ``ring_attention_sharded`` over 2 and 4 gloo processes (each passing
  its shard) against the reference's on its 8-device CPU mesh (global
  arrays): outputs and the gradients of ``sum(out * cot)``, flash and
  dense inner steps, at 1e-5 absolute.  Both sides compute the same f32
  products; only the order of the sums differs.
- The per-hop pieces (``hop_branch``, ``merge_partial``) and
  ``parallel.cp`` against their reference counterparts.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from tensorflowonspark_tpu.ops import flash_attention as jfa  # noqa: E402
from tensorflowonspark_tpu.ops import ring_attention as jra  # noqa: E402
from tensorflowonspark_tpu.parallel import cp as jcp  # noqa: E402
from tensorflowonspark_tpu_torch.ops import (  # noqa: E402
    flash_attention as tfa,
)
from tensorflowonspark_tpu_torch.ops import (  # noqa: E402
    ring_attention as tra,
)
from tensorflowonspark_tpu_torch.parallel import cp as tcp  # noqa: E402

ATOL = 1e-5

OFFSET_CASES = {
    "causal_gqa_offset64": dict(b=2, s=64, h=4, hkv=2, causal=True,
                                window=0, q_offset=64),
    "window40_gqa_offset64": dict(b=2, s=64, h=4, hkv=2, causal=True,
                                  window=40, q_offset=64),
    "window24_mha_offset48_rows_see_nothing": dict(
        b=1, s=64, h=2, hkv=2, causal=True, window=24, q_offset=48),
    "window16_gqa_offset32": dict(b=1, s=64, h=4, hkv=1, causal=True,
                                  window=16, q_offset=32),
}
D = 16


def _offset_inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    b, s, h, hkv = c["b"], c["s"], c["h"], c["hkv"]
    q, do = (rng.standard_normal((b, s, h, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, D)).astype(np.float32)
            for _ in range(2))
    # the ring's backward takes the ring-global lse and delta: any finite
    # rows do for the chunk's arithmetic
    lse = (4.0 + rng.standard_normal((b, h, s))).astype(np.float32)
    delta = rng.standard_normal((b, h, s)).astype(np.float32)
    return q, k, v, do, lse, delta


def _seen_rows(c):
    """``[S]`` bool: which local rows see at least one key."""
    qpos = c["q_offset"] + np.arange(c["s"])[:, None]
    kpos = np.arange(c["s"])[None, :]
    vis = qpos >= kpos
    if c["window"]:
        vis &= kpos > qpos - c["window"]
    return vis.any(axis=1)


def _t(x):
    """``[B, S, H, D]`` <-> ``[B, H, S, D]``."""
    return np.swapaxes(np.asarray(x), 1, 2)


@pytest.mark.parametrize("name", sorted(OFFSET_CASES))
def test_offset_forward_matches_jax(name):
    c = OFFSET_CASES[name]
    q, k, v, _, _, _ = _offset_inputs(c)
    scale = D ** -0.5
    want_o, want_lse = jfa._fwd_core(
        jnp.asarray(_t(q)), jnp.asarray(_t(k)), jnp.asarray(_t(v)), scale,
        c["causal"], 1024, 1024, out_dtype=jnp.float32, window=c["window"],
        q_offset=c["q_offset"])
    got_o, got_lse = tfa._fwd_core(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale,
        c["causal"], out_dtype=torch.float32, window=c["window"],
        q_offset=c["q_offset"])
    assert got_o.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=ATOL, rtol=0)
    seen = _seen_rows(c)
    got_o = got_o.numpy()
    assert np.isfinite(got_o).all()
    np.testing.assert_allclose(got_o[:, seen], _t(want_o)[:, seen],
                               atol=ATOL, rtol=0)
    if not seen.all():
        # a row that sees nothing: lse -1e30, so merge_partial weighs it 0
        assert (got_lse.numpy()[:, :, ~seen] <= -1e29).all()


@pytest.mark.parametrize("name", sorted(OFFSET_CASES))
def test_offset_backward_matches_jax(name):
    c = OFFSET_CASES[name]
    q, k, v, do, lse, delta = _offset_inputs(c, seed=1)
    scale = D ** -0.5
    want = jfa._bwd_core(
        scale, c["causal"], 1024, 1024, *(jnp.asarray(_t(x))
                                          for x in (q, k, v, do)),
        jnp.asarray(lse[..., None]), jnp.asarray(delta[..., None]),
        window=c["window"], q_offset=c["q_offset"])
    got = tfa._bwd_core(*(torch.from_numpy(x) for x in (q, k, v, do, lse,
                                                       delta)),
                        scale, c["causal"], window=c["window"],
                        q_offset=c["q_offset"])
    for name_, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), _t(w), atol=ATOL, rtol=0,
                                   err_msg=name_)
    seen = _seen_rows(c)
    if not seen.all():
        assert not got[0].numpy()[:, ~seen].any()  # exact zeros


def test_offset_f32_partial_from_bf16_inputs():
    """``out_dtype=float32`` hands over the forward's f32 output where the
    default rounds it to the inputs' bf16."""
    c = OFFSET_CASES["window40_gqa_offset64"]
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _offset_inputs(c)[:3])
    kw = dict(window=c["window"], q_offset=c["q_offset"])
    o32, lse32 = tfa._fwd_core(q, k, v, D ** -0.5, True,
                               out_dtype=torch.float32, **kw)
    o16, lse16 = tfa._fwd_core(q, k, v, D ** -0.5, True, **kw)
    assert o32.dtype == torch.float32 and o16.dtype == torch.bfloat16
    assert torch.equal(o32.bfloat16(), o16) and torch.equal(lse32, lse16)
    assert not torch.equal(o32, o16.float())


def test_offset_must_not_be_negative():
    q = torch.zeros(1, 8, 1, D, device="meta")
    with pytest.raises(ValueError, match="q_offset"):
        tfa._common(q, q, 1.0, True, 0, -8)


@pytest.mark.parametrize("causal,window", [
    (True, 0), (True, 5), (True, 20), (True, 40), (False, 0)])
def test_hop_branch_matches_the_reference_switch(causal, window):
    s_local = 16
    for p in range(1, 5):
        reach = jra._window_reach(window, s_local, p) if window else None
        for my in range(p):
            for t in range(p):
                got = tra.hop_branch(my, t, p, causal, window, s_local)
                if causal and window:
                    idx = int(jra._window_branch(my, t, p, reach))
                    want = None if idx == 0 else (True, (idx - 1) * s_local)
                elif causal:
                    idx = int(jra._causal_branch(my, t, p))
                    want = [None, (True, 0), (False, 0)][idx]
                else:
                    want = (False, 0)
                assert got == want, (p, my, t)


def test_merge_partial_matches_jax():
    rng = np.random.default_rng(2)
    o, oc = (rng.standard_normal((2, 8, 3, 4)).astype(np.float32)
             for _ in range(2))
    lse, lsec = (rng.standard_normal((2, 3, 8)).astype(np.float32) * 3
                 for _ in range(2))
    lsec[:, :, :2] = -1e30  # rows the chunk did not reach
    want_o, want_lse = jra._merge_partial(
        jnp.asarray(_t(o)), jnp.asarray(lse[..., None]), jnp.asarray(_t(oc)),
        jnp.asarray(lsec[..., None]))
    got_o, got_lse = tra.merge_partial(*(torch.from_numpy(x)
                                         for x in (o, lse, oc, lsec)))
    np.testing.assert_allclose(got_o.numpy(), _t(want_o), atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0],
                               atol=1e-6)


def test_ring_of_one_is_flash_attention():
    """Without a process group the ring has one rank: one causal chunk,
    the flash path's output and gradients."""
    q, k, v, do = (torch.from_numpy(x) for x in workers.attention_inputs(
        dict(seed=3, b=2, s=32, h=4, hkv=2, d=D)))
    outs = []
    for fn in (tra.ring_attention, tfa.flash_attention):
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = fn(qs, ks, vs, window=7)
        out.backward(do)
        outs.append([out.detach(), qs.grad, ks.grad, vs.grad])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_ring_rejects_what_the_reference_rejects():
    x = torch.zeros(1, 8, 4, D)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tra.ring_attention(x, x[:, :, :3], x[:, :, :3])
    with pytest.raises(ValueError, match="requires causal"):
        tra.ring_attention(x, x, x, causal=False, window=4)
    with pytest.raises(ValueError, match="unknown ring attention impl"):
        tra.ring_attention(x, x, x, impl="magic")


def test_untileable_shard_takes_the_dense_step():
    """On CPU tensors the flash ring takes the dense step where the tiling
    rule refuses the shard (S_local=96 under 64-row blocks), as the
    reference does (on CUDA tensors it raises)."""
    q, k, v, _ = (torch.from_numpy(x) for x in workers.attention_inputs(
        dict(seed=4, b=1, s=96, h=4, hkv=2, d=D)))
    got = tra.ring_attention(q, k, v, block_q=64, block_k=64, window=9)
    want = tra.ring_attention(q, k, v, impl="dense", window=9)
    assert torch.equal(got, want)


# -- across processes ----------------------------------------------------

RING_CASES = {
    "causal_mha": dict(mode="ring", impl="flash", causal=True, window=0,
                       h=4, hkv=4),
    "gqa_window20": dict(mode="ring", impl="flash", causal=True, window=20,
                         h=4, hkv=2),
    "mha_window5": dict(mode="ring", impl="flash", causal=True, window=5,
                        h=2, hkv=2),
    "non_causal_gqa": dict(mode="ring", impl="flash", causal=False,
                           window=0, h=4, hkv=1),
    "dense_gqa_window20": dict(mode="ring", impl="dense", causal=True,
                               window=20, h=4, hkv=2),
}


def _case(spec, seed):
    return dict(spec, seed=seed, b=2, s=64, d=D)


@pytest.fixture(scope="module", params=[2, 4], ids=["p2", "p4"])
def ring_run(request, tmp_path_factory):
    """Every ring case over ``world`` gloo ranks, in one group of
    processes: ``(world, out_dir)``."""
    world = request.param
    out = tmp_path_factory.mktemp("ring_p{0}".format(world))
    cases = {n: _case(s, i) for i, (n, s) in enumerate(sorted(
        RING_CASES.items()))}
    workers.run_ranks(workers.attention_worker, world, out, str(out), cases)
    return world, str(out), cases


def _jax_sharded(fn, spec, world, **kw):
    """The reference's ``*_sharded`` attention on global arrays over a
    ``{"seq": world}`` mesh of the CPU devices: output and the gradients
    of ``sum(out * cot)``."""
    q, k, v, cot = (jnp.asarray(x) for x in workers.attention_inputs(spec))
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("seq",))

    def run(q, k, v):
        return fn(q, k, v, mesh, causal=spec["causal"],
                  window=spec["window"], **kw)

    @jax.jit
    def out_and_grads(q, k, v, cot):
        out, vjp = jax.vjp(run, q, k, v)
        return (out,) + vjp(cot)

    return [np.asarray(x) for x in out_and_grads(q, k, v, cot)]


def _assert_ranks_match(out_dir, name, world, want):
    ranks = workers.load_ranks(out_dir, name, world)
    for i, key in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([r[key] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want[i], atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_attention_sharded_matches_jax(ring_run, name):
    world, out_dir, cases = ring_run
    spec = cases[name]
    want = _jax_sharded(jra.ring_attention_sharded, spec, world,
                        impl=spec["impl"])
    _assert_ranks_match(out_dir, name, world, want)


@pytest.mark.parametrize("args", [
    dict(seq_len=8192, num_heads=8, head_dim=128, seq_devices=4),
    dict(seq_len=32768, num_heads=8, head_dim=128, seq_devices=4),
    dict(seq_len=8192, num_heads=6, head_dim=64, seq_devices=4),
    dict(seq_len=2048, num_heads=8, head_dim=128, seq_devices=1),
])
def test_cp_plan_matches_jax(args):
    assert tcp.choose_strategy(**args) == jcp.choose_strategy(**args)
    assert tcp.plan(batch=2, **args) == jcp.plan(batch=2, **args)

