"""The port's attention ops against their JAX twins, on the CPU in f32.

The JAX ``paged_attention`` runs its Pallas kernel in interpret mode
here (as tests/test_paged_attention.py runs it); the port's wrapper,
given CPU tensors, runs its plain PyTorch version.  Same inputs, made
with numpy from a seed; tolerance 1e-5 (f32, summation order only).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tensorflowonspark_tpu.ops.attention import (  # noqa: E402
    dot_attention as jax_dot_attention,
)
from tensorflowonspark_tpu.ops import paged_attention as jpa  # noqa: E402
from tensorflowonspark_tpu_torch import compat  # noqa: E402
from tensorflowonspark_tpu_torch.ops import _build  # noqa: E402
from tensorflowonspark_tpu_torch.ops.attention import dot_attention  # noqa: E402
from tensorflowonspark_tpu_torch.ops import paged_attention as tpa  # noqa: E402

ATOL = RTOL = 1e-5


def _paged_case(seed, b=3, h=4, hkv=2, d=8, t=4, nb=5, lengths=None,
                int8=False, idle=()):
    rng = np.random.RandomState(seed)
    p = b * nb + 1
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(p, t, hkv, d).astype(np.float32)
    v = rng.randn(p, t, hkv, d).astype(np.float32)
    ks = vs = None
    if int8:
        ks = (0.01 + 0.05 * rng.rand(p, t, hkv, 1)).astype(np.float32)
        vs = (0.01 + 0.05 * rng.rand(p, t, hkv, 1)).astype(np.float32)
        k = np.clip(np.round(k / ks), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs), -127, 127).astype(np.int8)
    tables = (rng.permutation(p - 1)[:b * nb] + 1).reshape(b, nb)
    tables = tables.astype(np.int32)
    for i in idle:
        tables[i] = 0  # idle lanes park on the trash page
    if lengths is None:
        lengths = rng.randint(1, nb * t + 1, (b,))
    lengths = np.asarray(lengths, np.int32)
    return dict(q=q, k=k, v=v, tables=tables, lengths=lengths, ks=ks, vs=vs)


def _both(fn_j, fn_t, c, **kw):
    j = fn_j(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["lengths"]),
        k_scale_pool=None if c["ks"] is None else jnp.asarray(c["ks"]),
        v_scale_pool=None if c["vs"] is None else jnp.asarray(c["vs"]),
        **kw,
    )
    t = fn_t(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]),
        torch.from_numpy(c["v"]), torch.from_numpy(c["tables"]),
        torch.from_numpy(c["lengths"]),
        k_scale_pool=None if c["ks"] is None else torch.from_numpy(c["ks"]),
        v_scale_pool=None if c["vs"] is None else torch.from_numpy(c["vs"]),
        **kw,
    )
    return np.asarray(j), t.numpy()


PAGED_CASES = {
    "mha": dict(h=4, hkv=4),
    "gqa": dict(h=6, hkv=2),
    "window_across_pages": dict(window=6, lengths=[3, 13, 20]),
    "int8_pools_with_scales": dict(int8=True),
    "ragged_last_page": dict(lengths=[1, 5, 18]),
    "idle_lanes_on_page_0": dict(lengths=[1, 9, 4], idle=(0, 2)),
}


class TestPagedAttention:
    @pytest.mark.parametrize("name", sorted(PAGED_CASES))
    def test_matches_jax_kernel(self, name):
        spec = dict(PAGED_CASES[name])
        window = spec.pop("window", 0)
        c = _paged_case(sorted(PAGED_CASES).index(name), **spec)
        before = tpa.paged_attention.launches
        j, t = _both(jpa.paged_attention, tpa.paged_attention, c,
                     window=window)
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)
        # the CPU path is the plain version: no kernel launch counted
        assert tpa.paged_attention.launches == before

    def test_reference_is_the_cpu_path(self):
        c = _paged_case(7, h=6, hkv=3)
        args = [torch.from_numpy(c[k]) for k in
                ("q", "k", "v", "tables", "lengths")]
        np.testing.assert_array_equal(
            tpa.paged_attention(*args, window=5).numpy(),
            tpa.paged_attention_reference(*args, window=5).numpy(),
        )

    @pytest.mark.parametrize("span", [None, 13])
    def test_gather_pool_matches_jax(self, span):
        c = _paged_case(8)
        j = jpa.gather_pool(jnp.asarray(c["k"]), jnp.asarray(c["tables"]),
                            span)
        t = tpa.gather_pool(torch.from_numpy(c["k"]),
                            torch.from_numpy(c["tables"]), span)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    @pytest.mark.parametrize("window,int8", [(0, False), (5, False),
                                             (0, True)])
    def test_paged_gather_attention_matches_jax(self, window, int8):
        c = _paged_case(9, int8=int8)
        rng = np.random.RandomState(10)
        s = 6
        q = rng.randn(3, s, 4, 8).astype(np.float32)
        start = np.asarray([0, 3, 11])
        positions = (start[:, None] + np.arange(s)[None]).astype(np.int32)
        kw = dict(span=18, window=window)
        j = jpa.paged_gather_attention(
            jnp.asarray(q), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
            jnp.asarray(c["tables"]), jnp.asarray(positions),
            k_scale_pool=None if c["ks"] is None else jnp.asarray(c["ks"]),
            v_scale_pool=None if c["vs"] is None else jnp.asarray(c["vs"]),
            **kw,
        )
        t = tpa.paged_gather_attention(
            torch.from_numpy(q), torch.from_numpy(c["k"]),
            torch.from_numpy(c["v"]), torch.from_numpy(c["tables"]),
            torch.from_numpy(positions),
            k_scale_pool=None if c["ks"] is None else torch.from_numpy(
                c["ks"]),
            v_scale_pool=None if c["vs"] is None else torch.from_numpy(
                c["vs"]),
            **kw,
        )
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=RTOL)


DOT_CASES = {
    "causal_mha": dict(h=4, hkv=4),
    "causal_gqa": dict(h=6, hkv=2),
    "window": dict(window=3),
    "additive_mask": dict(mask=True, causal=False),
    "int8_scales": dict(int8=True),
    "decode_step": dict(sq=1),
}


@pytest.mark.parametrize("name", sorted(DOT_CASES))
def test_dot_attention_matches_jax(name):
    spec = DOT_CASES[name]
    rng = np.random.RandomState(20 + sorted(DOT_CASES).index(name))
    b, sq, sk, d = 2, spec.get("sq", 7), 7, 8
    h, hkv = spec.get("h", 4), spec.get("hkv", 2)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, hkv, d).astype(np.float32)
    v = rng.randn(b, sk, hkv, d).astype(np.float32)
    kw = dict(causal=spec.get("causal", True), window=spec.get("window", 0))
    jkw, tkw = dict(kw), dict(kw)
    if spec.get("mask"):
        m = np.where(rng.rand(b, 1, sq, sk) < 0.3, -np.inf, 0.0)
        m[..., 0] = 0.0  # keep every row attending somewhere
        m = m.astype(np.float32)
        jkw["mask"], tkw["mask"] = jnp.asarray(m), torch.from_numpy(m)
    if spec.get("int8"):
        ks = (0.01 + 0.05 * rng.rand(b, sk, hkv, 1)).astype(np.float32)
        vs = (0.01 + 0.05 * rng.rand(b, sk, hkv, 1)).astype(np.float32)
        k = np.clip(np.round(k / ks), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs), -127, 127).astype(np.int8)
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw.update(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    j = jax_dot_attention(jnp.asarray(q), jnp.asarray(k),
                          jnp.asarray(v), **jkw)
    t = dot_attention(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), **tkw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                               rtol=RTOL)


class TestTilesAndDevices:
    def test_flagship_geometry_is_legal(self):
        out = tpa.check_tiles(16, 128, torch.bfloat16)
        assert out["page_tokens"] == 16 and out["head_dim"] == 128
        assert tpa.check_tiles(8, 16, "float32", group=2)["smem_bytes"] > 0

    @pytest.mark.parametrize("page_tokens,head_dim,dtype,group", [
        (0, 128, torch.bfloat16, 1),
        (128, 128, torch.bfloat16, 1),
        (16, 512, torch.float32, 1),
        (16, 128, torch.float16, 1),
        (64, 256, torch.float32, 64),
    ])
    def test_illegal_geometry_raises_named_error(self, page_tokens,
                                                 head_dim, dtype, group):
        with pytest.raises(tpa.TileLegalityError):
            tpa.check_tiles(page_tokens, head_dim, dtype, group=group)

    def test_cuda_request_without_gpu_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(compat.NoCudaDevice):
            compat.resolve_device()
        with pytest.raises(compat.NoCudaDevice):
            compat.resolve_device("cuda")
        assert compat.resolve_device("cpu").type == "cpu"
        assert not compat.is_hopper()
        with pytest.raises(ValueError):
            compat.resolve_device("mps")

    def test_wrapper_takes_only_cpu_or_cuda_tensors(self):
        c = _paged_case(30)
        args = [torch.from_numpy(c[k]).to("meta") for k in
                ("q", "k", "v", "tables", "lengths")]
        with pytest.raises(ValueError, match="cuda or cpu"):
            tpa.paged_attention(*args)

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(_build.KernelBuildError, match="nvcc"):
            _build.nvcc_path()

    def test_library_path_keys_on_source_and_flags(self):
        path = _build.library_path("paged_attention")
        assert path.startswith(_build.BUILD_DIR)
        assert path.endswith(".so")
