"""The port's ``flash_attention`` (its plain PyTorch path on the CPU)
against the JAX package's Pallas ``flash_attention`` in interpret mode:
forward outputs and the gradients of a shared random cotangent, in f32.

Tolerances: forward 1e-5 and gradients 1e-4 absolute.  Both sides
compute the same f32 products; only the order of the sums differs (the
Pallas kernels accumulate block by block with a running max, the plain
version over the whole row), which moves f32 results by a few ulp of
values of order 1, more for the gradients' longer sums.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu.ops import flash_attention as jfa  # noqa: E402
from tensorflowonspark_tpu_torch import compat  # noqa: E402
from tensorflowonspark_tpu_torch.models import (  # noqa: E402
    transformer as ttr,
)
from tensorflowonspark_tpu_torch.ops import _build  # noqa: E402
from tensorflowonspark_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from tensorflowonspark_tpu_torch.ops.attention import (  # noqa: E402
    attention,
    dot_attention,
)

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4

CASES = {
    "causal_mha": dict(b=2, s=128, h=4, hkv=4, d=16, causal=True, window=0,
                       block=64),
    "gqa": dict(b=2, s=128, h=4, hkv=2, d=16, causal=True, window=0,
                block=64),
    "window40_banded": dict(b=1, s=128, h=2, hkv=2, d=16, causal=True,
                            window=40, block=32),
    "non_causal": dict(b=2, s=64, h=2, hkv=1, d=16, causal=False, window=0,
                       block=32),
    "seq_le_block": dict(b=1, s=48, h=2, hkv=2, d=16, causal=True, window=0,
                         block=1024),
}


def _inputs(b, s, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_gradients_match_jax(name):
    c = CASES[name]
    q, k, v, cot = _inputs(c["b"], c["s"], c["h"], c["hkv"], c["d"])
    kw = dict(causal=c["causal"], block_q=c["block"], block_k=c["block"],
              window=c["window"])

    ref, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(cot))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot))

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=FWD_ATOL, rtol=0)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gqa", "window40_banded"])
def test_forward_lse_matches_the_jax_kernel(name):
    """The plain forward's lse is the Pallas kernel's (f32 [B, H, S])."""
    c = CASES[name]
    q, k, v, _ = _inputs(c["b"], c["s"], c["h"], c["hkv"], c["d"], seed=1)
    scale = c["d"] ** -0.5
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v))
    out_t, lse = jfa._fwd_core(qt, kt, vt, scale, c["causal"], c["block"],
                               c["block"], window=c["window"])
    got_out, got_lse = tfa.flash_forward_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=c["causal"],
        scale=scale, window=c["window"])
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                               atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(got_out.numpy(),
                               np.asarray(jnp.swapaxes(out_t, 1, 2)),
                               atol=FWD_ATOL, rtol=0)


def test_backward_reference_splits_into_dq_and_dkv():
    c = CASES["gqa"]
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(
        c["b"], c["s"], c["h"], c["hkv"], c["d"], seed=2))
    kw = dict(causal=True, scale=0.25, window=0)
    out, lse = tfa.flash_forward_reference(q, k, v, **kw)
    dq, dk, dv = tfa.flash_backward_reference(q, k, v, out, lse, dout, **kw)
    delta = tfa._delta(out, dout)
    assert torch.equal(dq, tfa.flash_dq_reference(q, k, v, dout, lse, delta,
                                                  **kw))
    dk2, dv2 = tfa.flash_dkv_reference(q, k, v, dout, lse, delta, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert dk.shape == k.shape and dv.shape == v.shape


def test_matches_dot_attention_through_the_dispatcher():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 64, 4, 2, 16))
    got = attention(q, k, v, impl="flash", block_q=32, block_k=32,
                    window=20)
    want = dot_attention(q, k, v, window=20)
    torch.testing.assert_close(got, want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("seq_len", [48, 64, 200, 256, 384, 1000, 1536,
                                     2048, 3000])
@pytest.mark.parametrize("block", [32, 128, 512, 1024])
def test_tile_legality_matches_jax(seq_len, block):
    assert tfa._fit_block(block, seq_len) == jfa._fit_block(block, seq_len)
    assert (tfa.flash_supported(0.5, seq_len, block, block)
            == jfa.flash_supported(0.5, seq_len, block, block))


def test_untileable_sequence_raises_like_jax():
    q, k, v, _ = _inputs(1, 200, 2, 2, 16)
    with pytest.raises(ValueError, match="lane-aligned block") as want:
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            block_q=128, block_k=128)
    with pytest.raises(ValueError, match="lane-aligned block") as got:
        tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                            block_q=128, block_k=128)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,kv_heads", [
    (dict(window=-1), 2),
    (dict(window=8, causal=False), 2),
    ({}, 3),
], ids=["negative_window", "window_without_causal", "heads_not_grouped"])
def test_validation_errors_match_jax(kw, kv_heads):
    q, k, v, _ = _inputs(1, 32, 4, kv_heads, 8)
    with pytest.raises(ValueError) as want:
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
    with pytest.raises(ValueError) as got:
        tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    assert type(got.value) is type(want.value)
    # the shape text differs (torch.Size vs tuple); the message does not
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


def test_kv_shape_mismatch_raises():
    q, k, v, _ = _inputs(1, 32, 4, 2, 8)
    with pytest.raises(ValueError, match="k/v must match"):
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v)[:, :16])


def test_cpu_path_counts_no_launches():
    before = dict(tfa.flash_attention.launches)
    q, k, v, dout = (torch.tensor(x, requires_grad=True)
                     for x in _inputs(1, 64, 2, 2, 16))
    out = tfa.flash_attention(q, k, v)
    torch.autograd.grad(out, (q, k, v), dout.detach())
    assert tfa.flash_attention.launches == before
    assert set(before) == {"fwd", "dq", "dkv"}


@pytest.mark.parametrize("head_dim,dtype,ok", [
    (128, torch.bfloat16, True),
    (64, "float32", True),
    (16, torch.float32, False),
    (128, torch.float16, False),
])
def test_check_flash_shapes(head_dim, dtype, ok):
    if ok:
        assert tfa.check_flash_shapes(head_dim, dtype) is None
    else:
        with pytest.raises(tfa.FlashShapeError, match="CUDA flash kernels"):
            tfa.check_flash_shapes(head_dim, dtype)


def test_cuda_requests_without_a_gpu_raise():
    if compat.has_cuda():
        pytest.skip("a CUDA device is present")
    cfg = ttr.TransformerConfig(vocab_size=64, num_layers=1, num_heads=2,
                                head_dim=64, embed_dim=32, mlp_dim=64,
                                attention_impl="flash")
    with pytest.raises(compat.NoCudaDevice):
        ttr.Transformer(cfg)
    with pytest.raises(_build.KernelBuildError, match="sm_90a"):
        _build.load("flash_attention")


def test_flash_kernels_are_registered():
    src, fns = _build.KERNELS["flash_attention"]
    assert src == "flash_attention.cu"
    assert set(fns) == {"tfos_flash_fwd", "tfos_flash_dq", "tfos_flash_dkv"}
    with open(os.path.join(_build.CSRC_DIR, src)) as f:
        text = f.read()
    for fn in fns:
        assert "int {0}(".format(fn) in text


def _repo_script(name):
    """The repository's top-level script ``<name>.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["diag", "zero_dq", "fwd_wgmma_diag",
                                  "dq_wgmma_diag", "dkv_wgmma_diag",
                                  "dq_wgmma_diag_key",
                                  "dkv_wgmma_first_head"])
def test_planted_faults_still_apply_to_the_kernel_source(name):
    """Each planted fault of ``chip_mutants.py`` finds its lines in the
    kernel source exactly once, so the card-side check of the checks
    keeps breaking what it says it breaks."""
    mutants = _repo_script("chip_mutants")
    _, subs, check = mutants.MUTANTS[name]
    assert check in mutants.CHECKS
    with open(os.path.join(_build.CSRC_DIR, "flash_attention.cu")) as f:
        text = f.read()
    mutated = mutants.mutate(text, subs)
    assert mutated != text
    with pytest.raises(ValueError, match="found 0 times"):
        mutants.mutate(mutated, subs)


@pytest.mark.parametrize("hkv", [4, 1])
def test_flash_bounds_count_each_operand_once_and_the_visible_pairs(hkv):
    """``chip_smoke.flash_bounds`` (the ``bound_ms`` of K2-K4, MHA and
    GQA) against the bytes of the tensors each kernel reads and writes
    and the flop of its products over the causal mask's pairs."""
    b, s, h, d = 2, 96, 4, 64
    q = torch.empty(b, s, h, d, dtype=torch.bfloat16)
    kv = torch.empty(b, s, hkv, d, dtype=torch.bfloat16)
    rows = torch.empty(b, h, s, dtype=torch.float32)

    def nbytes(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    product = 2 * d * b * h * int(torch.ones(s, s).tril().sum())
    want = {
        "fwd": (nbytes(q, kv, kv, q, rows), 2 * product),
        "dq": (nbytes(q, kv, kv, q, rows, rows, q), 3 * product),
        "dkv": (nbytes(q, kv, kv, q, rows, rows, kv, kv), 4 * product),
    }
    assert _repo_script("chip_smoke").flash_bounds(b, s, h, hkv, d, 2) == want
