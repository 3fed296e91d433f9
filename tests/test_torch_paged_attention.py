"""The port's attention ops against their JAX twins, on the CPU in f32.

The JAX ``paged_attention`` runs its Pallas kernel in interpret mode
here (as tests/test_paged_attention.py runs it); the port's wrapper,
given CPU tensors, runs its plain PyTorch version.  Same inputs, made
with numpy from a seed; tolerance 1e-5 (f32, summation order only).
"""

import functools
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

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


@functools.lru_cache(maxsize=None)
def _jax_paged_case(name):
    """``(case, window, JAX output)`` of ``PAGED_CASES[name]``: the JAX
    kernel runs once per case in interpret mode."""
    spec = dict(PAGED_CASES[name])
    window = spec.pop("window", 0)
    c = _paged_case(sorted(PAGED_CASES).index(name), **spec)
    j, _ = _both(jpa.paged_attention, tpa.paged_attention_reference, c,
                 window=window)
    return c, window, j


def _live_pages(length, page_tokens, window):
    """The pages holding a position the query at ``length - 1`` sees,
    from the positions themselves."""
    start = max(0, length - window) if window else 0
    return sorted({pos // page_tokens for pos in range(start, length)})


class TestSplitArithmetic:
    """The kernel's split-and-combine arithmetic, as its plain version
    computes it, against the JAX kernel (f32, 1e-5)."""

    @pytest.mark.parametrize("splits", [1, 2, 3, "past_live_pages"])
    @pytest.mark.parametrize("name", sorted(PAGED_CASES))
    def test_split_reference_matches_jax_kernel(self, name, splits):
        c, window, j = _jax_paged_case(name)
        nb = c["tables"].shape[1]
        # more splits than any slot has live pages: some shares are empty
        s = nb + 3 if splits == "past_live_pages" else splits
        t = tpa.paged_attention_split_reference(
            *[torch.from_numpy(c[k]) for k in
              ("q", "k", "v", "tables", "lengths")],
            splits=s, window=window,
            k_scale_pool=None if c["ks"] is None else torch.from_numpy(
                c["ks"]),
            v_scale_pool=None if c["vs"] is None else torch.from_numpy(
                c["vs"]),
        ).numpy()
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=RTOL)

    def test_empty_splits_hold_the_neutral_state(self):
        c = _paged_case(3, lengths=[1, 5, 18])
        args = [torch.from_numpy(c[k]) for k in
                ("q", "k", "v", "tables", "lengths")]
        splits = 8
        m, l, acc = tpa.split_partials(*args, splits=splits)
        lo, hi = tpa.split_page_ranges(args[4], 4, 5, 0, splits)
        empty = (hi <= lo)[:, None, :].expand(m.shape)
        assert empty.any() and (~empty).any()
        assert (m[empty] == tpa.NEG_INF).all()
        assert (l[empty] == 0).all() and (acc[empty] == 0).all()
        assert (l[~empty] > 0).all()

    @pytest.mark.parametrize("args,want", [
        ((8, 8, 32, 132, 16), 9),  # the flagship decode: 4 blocks an SM
        ((32, 8, 128, 132, 16), 16),  # a full bank: 8 pages a split
        ((1, 2, 128, 132, 16), 128),  # one long request: a page a split
        ((1, 1, 4096, 132, 16), tpa.MAX_SPLITS),
        ((64, 64, 1, 132, 16), 1),  # never past the table
    ])
    def test_num_splits_rule(self, args, want):
        assert tpa.num_splits(*args) == want

    def test_num_splits_caps_at_the_pages_a_window_touches(self):
        # 37 positions span at most 1 + ceil(36 / 16) = 4 pages
        assert tpa.num_splits(1, 2, 128, 132, 16, window=37) == 4
        assert tpa.num_splits(1, 2, 128, 132, 16, window=1) == 1


@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_split_partition_covers_live_pages_once(data):
    """Every slot's live pages fall in exactly one split's share, the
    shares in order; for any lengths, window, page size, table width and
    split count."""
    t = data.draw(st.integers(1, 64), label="page_tokens")
    nb = data.draw(st.integers(1, 40), label="blocks_per_slot")
    splits = data.draw(st.integers(1, tpa.MAX_SPLITS), label="splits")
    lengths = data.draw(st.lists(st.integers(0, nb * t), min_size=1,
                                 max_size=6), label="lengths")
    window = data.draw(st.integers(0, nb * t + 3), label="window")
    lo, hi = tpa.split_page_ranges(torch.tensor(lengths), t, nb, window,
                                   splits)
    assert lo.shape == hi.shape == (len(lengths), splits)
    for i, n in enumerate(lengths):
        assert (hi[i] >= lo[i]).all()
        assert (lo[i, 1:] == hi[i, :-1]).all()
        pages = [p for a, b in zip(lo[i].tolist(), hi[i].tolist())
                 for p in range(a, b)]
        assert pages == _live_pages(n, t, window)


def _repo_script(name):
    """The repository's top-level script ``<name>.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["paged_split_short",
                                  "paged_combine_last_split",
                                  "paged_mask_last_key"])
def test_planted_paged_faults_still_apply_to_the_kernel_source(name):
    """Each planted fault of ``chip_mutants.py`` in the paged-decode
    kernels finds its lines in the source exactly once."""
    mutants = _repo_script("chip_mutants")
    _, subs, check = mutants.MUTANTS[name]
    assert check in mutants.CHECKS
    assert mutants.SOURCES[name].endswith("csrc/paged_attention.cu")
    with open(os.path.join(_build.CSRC_DIR, "paged_attention.cu")) as f:
        text = f.read()
    mutated = mutants.mutate(text, subs)
    assert mutated != text
    with pytest.raises(ValueError, match="found 0 times"):
        mutants.mutate(mutated, subs)


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


def _first_kernel_smem(group, head_dim, page_tokens):
    """Shared memory of the first CUDA kernel (one block per slot and kv
    head, K/V pages staged as f32), which set what check_tiles took."""
    g, d, t = group, head_dim, page_tokens
    return 4 * (2 * g * d + 2 * t * d + g * t + 2 * t + 3 * g)


@pytest.mark.parametrize("page_tokens,head_dim,group", [
    (64, 256, 1), (64, 256, 13), (16, 128, 64), (16, 128, 196),
    (1, 1, 9000), (1, 129, 215), (64, 64, 100), (7, 33, 3),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_check_tiles_takes_every_geometry_the_first_kernel_took(
        page_tokens, head_dim, group, dtype):
    assert _first_kernel_smem(group, head_dim, page_tokens) \
        <= tpa.MAX_SMEM_BYTES
    out = tpa.check_tiles(page_tokens, head_dim, dtype, group=group)
    assert out["smem_bytes"] <= tpa.MAX_SMEM_BYTES


def test_kernel_geometry_ring():
    """The flagship page (16 x 128 bf16) takes the full ring of four
    8,320-byte stages; a 64 x 256 f32 page takes one."""
    g = tpa._kernel_geometry(1, 128, 16, 2)
    assert g == {"row_bytes": 256, "stage_bytes": 8320, "stages": 4,
                 "smem_bytes": 4 * 8320 + 8 * 128 + 8}
    assert tpa._kernel_geometry(1, 256, 64, 4)["stages"] == 1
    # D=36 bf16: 72-byte rows padded to 80 for 16-byte stage rows
    assert tpa._kernel_geometry(2, 36, 16, 2)["row_bytes"] == 80
