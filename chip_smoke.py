"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

Each phase prints one JSON line and raises on failure (nothing is
caught):

1. ``env``: torch, the card, its power limit.
2. ``build``: compiles every kernel source under
   ``tensorflowonspark_tpu_torch/csrc/`` with ``nvcc`` (one process per
   source, all started together).
3. ``kernel_case``: the paged-decode kernel against its plain PyTorch
   version on the card, case by case (bf16 flagship geometry, f32 GQA,
   sliding window, int8 pools with scales, a length-1 slot).
4. ``kernel_timing``: the kernel, its plain version and a library
   yardstick at the flagship decode shape, beside the byte bound.
5. ``slice_flagship``: ``serving_builder`` + ``predict_rows(schedule=
   "continuous")`` at the flagship's full width (L16 H8 Dh128 Dm1024,
   bf16, paged KV) with random weights made from a seed; the kernel's
   launch count over that run must be 16 per decode step.
6. ``slice_kernel_vs_gather``: the same path in f32 at two layers with
   ``paged_impl="kernel"`` and ``"gather"``; greedy tokens must agree.

Then a ``kernels`` summary line, the ``nvidia-smi`` name/power-limit
line, and as the last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM memory rate and f32 (non-tensor-core) peak, NVIDIA data sheet
HBM_BYTES_PER_SEC = 3.35e12
F32_FLOPS_PER_SEC = 67e12

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

FLAGSHIP = dict(
    vocab_size=32000, num_layers=16, num_heads=8, head_dim=128,
    embed_dim=1024, mlp_dim=4096, max_seq_len=2048, dtype="bfloat16",
)
SERVING = dict(
    mode="generate", kv_layout="paged", kv_page_tokens=16,
    max_new_tokens=64, chunk_size=16, pad_multiple=64, max_prompt_len=448,
)
SLOTS = 8
REQUESTS = 16


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_env():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         nvidia_smi=nvidia_smi())


def phase_build():
    from tensorflowonspark_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build()
    emit("build", seconds=time.perf_counter() - t0, per_library=secs,
         ptxas={name: _build.build_report(name) for name in secs})


def make_paged_case(gen, *, b, h, hkv, d, t, nb, lengths, dtype,
                    pool_dtype=None, idle=()):
    """Pools with a private page run per live slot (page 0 is the trash
    page), idle slots' tables all on page 0, random q/K/V."""
    dev = "cuda"
    pool_dtype = pool_dtype or dtype
    p = b * nb + 1
    shape = (p, t, hkv, d)
    if pool_dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(shape[:3] + (1,), generator=gen, device=dev) / 64
        vs = torch.rand(shape[:3] + (1,), generator=gen, device=dev) / 64
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(pool_dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(pool_dtype)
        ks = vs = None
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(p - 1, generator=gen, device=dev) + 1
    tables = perm[:b * nb].reshape(b, nb).to(torch.int32)
    for i in idle:
        tables[i] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=k, v_pool=v, block_tables=tables, lengths=lens,
                k_scale_pool=ks, v_scale_pool=vs)


def check_case(name, case, window=0):
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference,
    )

    args = [case[k] for k in ("q", "k_pool", "v_pool", "block_tables",
                              "lengths")]
    kw = dict(window=window, k_scale_pool=case["k_scale_pool"],
              v_scale_pool=case["v_scale_pool"])
    out = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[case["q"].dtype]
    emit("kernel_case", case=name, dtype=str(case["q"].dtype),
         max_abs_err=err, tol=tol, ok=err <= tol)
    if not (err <= tol and torch.isfinite(out).all().item()):
        raise AssertionError(
            "kernel case {0}: max abs err {1} > {2}".format(name, err, tol)
        )
    return err


def phase_kernel_cases():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [
        ("flagship_bf16_mha", dict(
            b=8, h=8, hkv=8, d=128, t=16, nb=32, dtype=torch.bfloat16,
            lengths=[1, 17, 100, 255, 256, 257, 511, 512], idle=(0,),
        ), 0),
        ("f32_gqa", dict(
            b=4, h=8, hkv=2, d=128, t=16, nb=8, dtype=torch.float32,
            lengths=[5, 16, 33, 128],
        ), 0),
        ("f32_window_across_pages", dict(
            b=4, h=8, hkv=4, d=64, t=16, nb=8, dtype=torch.float32,
            lengths=[10, 40, 77, 128],
        ), 37),
        ("int8_pools_with_scales", dict(
            b=4, h=8, hkv=2, d=128, t=16, nb=8, dtype=torch.float32,
            pool_dtype=torch.int8, lengths=[3, 31, 64, 100],
        ), 0),
        ("bf16_int8_pools", dict(
            b=2, h=8, hkv=8, d=128, t=16, nb=4, dtype=torch.bfloat16,
            pool_dtype=torch.int8, lengths=[20, 64],
        ), 0),
        ("length_one_slot", dict(
            b=3, h=8, hkv=8, d=128, t=16, nb=4, dtype=torch.float32,
            lengths=[1, 1, 49], idle=(1,),
        ), 0),
    ]
    for name, spec, window in cases:
        check_case(name, make_paged_case(gen, **spec), window=window)


def bytes_and_flops(case, t):
    """Least bytes the decode attention must move (each live page of
    each kv head read once, q read, out written, tables and lengths
    read) and its f32 operations."""
    q, k = case["q"], case["k_pool"]
    b, h, d = q.shape
    hkv = k.shape[2]
    lens = case["lengths"].cpu().numpy().astype(np.int64)
    live = int((-(-lens // t) * t).sum())
    nbytes = live * hkv * d * 2 * k.element_size()
    if case["k_scale_pool"] is not None:
        nbytes += live * hkv * 2 * 4
    nbytes += 2 * q.numel() * q.element_size()
    nbytes += case["block_tables"].numel() * 4 + b * 4
    flops = 4 * h * d * int(lens.sum())
    return nbytes, flops


def time_ms(fn, inputs, reps=200, warmup=20):
    """Median per-call device time over ``reps`` calls, cycling through
    ``inputs`` (enough copies of the pools to exceed the L2 cache, so
    each call reads its KV cold, as the decode path does between
    layers)."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return float(np.median(samples))


def phase_kernel_timing():
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        gather_pool, paged_attention, paged_attention_reference,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rng = np.random.default_rng(1)
    b, h, d, t, nb = 8, 8, 128, 16, 32
    lengths = sorted(int(x) for x in rng.integers(32, 501, size=b))
    spec = dict(b=b, h=h, hkv=h, d=d, t=t, nb=nb, dtype=torch.bfloat16,
                lengths=lengths)
    # 8 copies x 2 pools x 8.4 MB: well past the 50 MB L2
    copies = [make_paged_case(gen, **spec) for _ in range(8)]
    case = copies[0]

    def run(c):
        return paged_attention(c["q"], c["k_pool"], c["v_pool"],
                               c["block_tables"], c["lengths"])

    def plain(c):
        return paged_attention_reference(c["q"], c["k_pool"], c["v_pool"],
                                         c["block_tables"], c["lengths"])

    mask_len = nb * t
    masks = [
        (torch.arange(mask_len, device="cuda")[None, :]
         < c["lengths"][:, None].long())[:, None, None, :]
        for c in copies
    ]
    for c, m in zip(copies, masks):
        c["mask"] = m

    def library(c):
        kk = gather_pool(c["k_pool"], c["block_tables"]).transpose(1, 2)
        vv = gather_pool(c["v_pool"], c["block_tables"]).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            c["q"][:, :, None], kk, vv, attn_mask=c["mask"]
        )[:, :, 0]

    out = run(case)
    ref = plain(case)
    lib = library(case)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lib_err = (lib.float() - ref.float()).abs().max().item()
    if err > TOL[torch.bfloat16]:
        raise AssertionError("kernel at the flagship decode shape: max abs "
                             "err {0}".format(err))
    kernel_ms = time_ms(run, copies)
    plain_ms = time_ms(plain, copies, reps=50)
    library_ms = time_ms(library, copies, reps=50)
    nbytes, flops = bytes_and_flops(case, t)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
    ops_ms = 1e3 * flops / F32_FLOPS_PER_SEC
    res = dict(
        shape=dict(B=b, H=h, Hkv=h, D=d, T=t, NB=nb, lengths=lengths,
                   dtype="bfloat16"),
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes=nbytes, flops=flops, max_abs_err=err,
        library_max_abs_err=lib_err,
    )
    emit("kernel_timing", **res)
    return res


def make_requests(rng, n, vocab, lo, hi):
    return [
        {"tokens": rng.integers(0, vocab, size=int(m)).astype(np.int32)}
        for m in rng.integers(lo, hi + 1, size=n)
    ]


def serve(model_cfg, serving_cfg, params, rows):
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    predict = serving_builder(params, dict(model_cfg, **serving_cfg))
    stats = {}
    paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(serving.predict_rows(
        predict, rows, {"tokens": "tokens"}, batch_size=SLOTS,
        schedule="continuous", stats=stats,
    ))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, stats, wall, paged_attention.launches


def pct(values, q):
    return float(np.percentile(np.asarray(list(values), np.float64), q))


def phase_slice_flagship():
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    cfg = TransformerConfig(**FLAGSHIP)
    t0 = time.perf_counter()
    params = convert.init_params_tree(cfg, seed=0)
    init_s = time.perf_counter() - t0
    rows = make_requests(np.random.default_rng(2), REQUESTS,
                         cfg.vocab_size, 16, SERVING["max_prompt_len"])
    out, stats, wall, launches = serve(FLAGSHIP, SERVING, params, rows)
    max_new = SERVING["max_new_tokens"]
    for r in out:
        g = np.asarray(r["generated"])
        if g.shape != (max_new,) or g.min() < 0 or g.max() >= cfg.vocab_size:
            raise AssertionError("bad generated row {0}".format(g))
    steps = stats["chunks"] * SERVING["chunk_size"]
    if stats["admitted"] != REQUESTS or len(out) != REQUESTS:
        raise AssertionError("admitted {0} of {1}".format(
            stats["admitted"], REQUESTS))
    if not (steps > 0 and launches == cfg.num_layers * steps):
        raise AssertionError(
            "paged_attention launches {0} != {1} layers x {2} decode "
            "steps".format(launches, cfg.num_layers, steps))
    res = dict(
        model="L16 H8 Dh128 Dm1024 bf16", requests=REQUESTS, slots=SLOTS,
        prompt_lens=[int(len(r["tokens"])) for r in rows],
        params_init_sec=init_s, wall_sec=wall,
        tokens_out=stats["tokens_out"], tokens_per_sec=stats["tokens_out"]
        / wall, decode_steps=steps, chunks=stats["chunks"],
        decode_wall_sec=stats["decode_wall_sec"],
        prefill_wall_sec=stats["prefill_wall_sec"],
        decode_step_ms=1e3 * stats["decode_wall_sec"] / steps,
        paged_attention_launches=launches,
        latency_p50_ms=1e3 * pct(stats["latency_sec"].values(), 50),
        latency_p99_ms=1e3 * pct(stats["latency_sec"].values(), 99),
        ttft_p50_ms=1e3 * pct(stats["ttft_sec"].values(), 50),
        ttft_p99_ms=1e3 * pct(stats["ttft_sec"].values(), 99),
        pool_pages=stats.get("pool_pages"),
        device=torch.cuda.get_device_name(0),
    )
    emit("slice_flagship", **res)
    return res


def phase_kernel_vs_gather():
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    model_cfg = dict(FLAGSHIP, dtype="float32", num_layers=2)
    params = convert.init_params_tree(TransformerConfig(**model_cfg), seed=3)
    rows = make_requests(np.random.default_rng(4), REQUESTS,
                         model_cfg["vocab_size"], 16,
                         SERVING["max_prompt_len"])
    runs = {}
    for impl in ("kernel", "gather"):
        out, stats, wall, launches = serve(
            model_cfg, dict(SERVING, paged_impl=impl), params, rows)
        runs[impl] = (np.stack([r["generated"] for r in out]), launches,
                      wall)
    same = bool(np.array_equal(runs["kernel"][0], runs["gather"][0]))
    emit("slice_kernel_vs_gather", model="L2 H8 Dh128 Dm1024 f32",
         identical_tokens=same,
         kernel_launches=runs["kernel"][1], gather_launches=runs["gather"][1],
         kernel_wall_sec=runs["kernel"][2], gather_wall_sec=runs["gather"][2])
    if not same:
        rows_diff = np.nonzero(
            (runs["kernel"][0] != runs["gather"][0]).any(axis=1))[0]
        raise AssertionError(
            "greedy tokens differ between paged_impl kernel and gather "
            "for requests {0}".format(rows_diff.tolist()))
    if runs["kernel"][1] == 0 or runs["gather"][1] != 0:
        raise AssertionError("launch counts {0}/{1}".format(
            runs["kernel"][1], runs["gather"][1]))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    import tensorflowonspark_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_env()
    phase_build()
    phase_kernel_cases()
    timing = phase_kernel_timing()
    flagship = phase_slice_flagship()
    phase_kernel_vs_gather()
    print(json.dumps({"kernels": [dict(
        name="paged_attention", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        replaces="tensorflowonspark_tpu/ops/paged_attention.py:143",
        launches=flagship["paged_attention_launches"],
        max_abs_err=timing["max_abs_err"], ms=timing["kernel_ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
    )]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
