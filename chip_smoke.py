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
7. ``flash_case``: the flash kernels (forward, dQ, dK/dV) against their
   plain versions on the card (bf16 flagship geometry, f32 GQA, a
   window across tiles, non-causal, a ragged S=1000, bf16 D=64); bf16
   outputs are held row by row (:data:`FLASH_TOL`).
8. ``flash_timing``: the three kernels, their plain versions and
   ``scaled_dot_product_attention`` as a yardstick at the flagship
   training shape (B=8, S=2048, H=8, D=128, bf16, causal), beside the
   operation bound.
9. ``train_flagship``: ``SyncTrainer(loss_fn(model), adamw(1e-4))`` on
   the flagship at full width (f32 master weights, bf16 compute, flash
   attention), one warm-up and two timed ``multi_step`` of K=4 on a
   [4, 8, 2048] batch; losses finite and falling, 16 launches of each
   flash kernel per step, tokens/s, mfu, peak memory.
10. ``train_kernel_vs_dot``: three SGD steps in f32 at two layers with
    ``attention_impl="flash"`` and ``"dot"``; losses agree, and every
    weight leaf agrees to a fraction of how far the steps moved it.
11. ``train_to_serve``: the trained weights through ``serving_builder``
    and ``predict_rows(schedule="continuous")``.
12. ``optimizer_timing``: one update of the port's AdamW beside
    ``torch.optim.AdamW(fused=True)`` over the flagship's parameters.
13. ``gmm_case``: the grouped-matmul kernels (K5 forward, K6 dX, K7 dW)
    against their plain versions on the card, on dropless layouts from
    a skewed router (one heavy expert, one absent): bf16 at the MoE
    flagship's shapes in both directions (D=1024 -> F=4096 and back),
    and f32 with ragged counts and edges (:data:`GMM_TOL`).
14. ``gmm_timing``: the three kernels, their plain versions and a
    library yardstick at the MoE flagship's training shape, beside the
    operation bound.
15. ``moe_train_flagship``: the JAX package's MoE bench model (L4 H8
    Dh128 Dm1024 Dff4096 V32000, 8 experts top-2, dropless, remat
    ``block``, flash attention, bf16 compute over f32 masters) under
    ``SyncTrainer(moe_loss_fn(model), adamw(1e-4), has_aux=True)``, one
    warm-up and two timed ``multi_step`` of K=4 on a [4, 4, 2048] batch;
    losses finite and falling, 24/12/12 launches of K5/K6/K7 and 8/4/4
    of K2/K3/K4 per step, tokens/s, active-parameter mfu, peak memory.
16. ``moe_train_dropless_vs_gather``: three SGD steps in f32 at the MoE
    flagship's widths (two layers, S=512, B=2) with ``dropless`` (the
    kernels) and ``gather`` at capacity factor E/k (plain PyTorch, where
    nothing can drop); losses agree, and every weight leaf agrees to a
    fraction of how far the steps moved it.
17. ``moe_train_to_serve``: the trained MoE weights through
    ``serving_builder`` and ``predict_rows(schedule="continuous")`` (K5
    in every prefill and decode step, K1 in every decode step).

Then a ``kernels`` summary line, the ``nvidia-smi`` name/power-limit
line, and as the last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
``phase_train_profile`` (not run by :func:`main`) breaks a training step
down by kernel class for the dense or the MoE flagship.
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


def phase_slice_flagship(params, init_s):
    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    cfg = TransformerConfig(**FLAGSHIP)
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


#: flash kernels against their plain versions.  f32 O to 1e-5 and f32
#: dQ/dK/dV to 1e-4 absolute (the same f32 products summed in another
#: order over up to S keys).  lse is f32 in both types: 1e-5 absolute
#: (about ten f32 ulps at |lse| <= 16).  bf16 O/dQ/dK/dV: every element
#: to 2^-5 of |ref| + the RMS of its row of D values
#: (:func:`row_relative_error`; bf16 output
#: rounding, up to 2^-7 of |ref|, plus p and ds rounded to bf16 on
#: either side of a rounding boundary).  The row's own RMS holds the
#: late rows, whose values are ~50x smaller than the first rows', as
#: tightly as the first: a kernel that skips a key tile fails.
FLASH_TOL = {"f32_out": 1e-5, "f32_grad": 1e-4, "lse": 1e-5,
             "bf16_row_rel": 2 ** -5}
FLASH_CASES = [
    ("flagship_bf16_causal", dict(b=2, s=2048, h=8, hkv=8, d=128,
                                  dtype=torch.bfloat16, causal=True)),
    ("f32_gqa", dict(b=2, s=512, h=8, hkv=2, d=128, dtype=torch.float32,
                     causal=True)),
    ("f32_window_300", dict(b=1, s=1024, h=4, hkv=4, d=128,
                            dtype=torch.float32, causal=True, window=300)),
    ("f32_non_causal", dict(b=2, s=256, h=4, hkv=4, d=128,
                            dtype=torch.float32, causal=False)),
    ("f32_ragged_s1000", dict(b=1, s=1000, h=4, hkv=2, d=128,
                              dtype=torch.float32, causal=True)),
    ("bf16_d64_gqa", dict(b=2, s=1024, h=8, hkv=4, d=64,
                          dtype=torch.bfloat16, causal=True)),
]
#: H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
BF16_FLOPS_PER_SEC = 989e12


def make_flash_case(gen, *, b, s, h, hkv, d, dtype, causal, window=0):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return dict(q=rnd(b, s, h, d), k=rnd(b, s, hkv, d), v=rnd(b, s, hkv, d),
                dout=rnd(b, s, h, d), scale=d ** -0.5, causal=causal,
                window=window)


def flash_outputs(c):
    """Each kernel's outputs and its plain version's on one case; the
    backward of both takes the plain forward's O and lse."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    kw = dict(scale=c["scale"], causal=c["causal"], window=c["window"])
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, **kw)
    delta = fa._delta(ref_out, dout)
    args = (q, k, v, dout, ref_lse, delta)
    pos = (kw["scale"], kw["causal"], kw["window"])
    got = dict(zip(("out", "lse"), fa._launch_fwd(q, k, v, *pos)))
    got["dq"] = fa._launch_dq(*args, *pos)
    got["dk"], got["dv"] = fa._launch_dkv(*args, *pos)
    torch.cuda.synchronize()
    ref = dict(out=ref_out, lse=ref_lse,
               dq=fa.flash_dq_reference(*args, **kw))
    ref["dk"], ref["dv"] = fa.flash_dkv_reference(*args, **kw)
    return got, ref


def row_relative_error(got, ref):
    """Largest ``|got - ref| / (|ref| + RMS of ref's row + 2^-6 RMS of
    ref)`` over the elements, a row being the last dimension.  The last
    term holds a row whose exact value cancels to 0 (causal row 0's dQ:
    p = 1 there, so dP equals delta) to the f32 rounding noise of the
    cancellation rather than to nothing."""
    rms = ref.square().mean(dim=-1, keepdim=True).sqrt()
    floor = 2 ** -6 * ref.square().mean().sqrt()
    return ((got - ref).abs() / (ref.abs() + rms + floor).clamp_min(1e-30)) \
        .max().item()


def flash_errors(got, ref, dtype):
    """``{output: (max abs err, checked err, tolerance)}``: the checked
    error is the max abs error for f32 outputs and lse, and
    :func:`row_relative_error` for bf16 O/dQ/dK/dV."""
    out = {}
    for name in ("out", "lse", "dq", "dk", "dv"):
        g, r = got[name].float(), ref[name].float()
        err = (g - r).abs().max().item()
        if name == "lse":
            checked, tol = err, FLASH_TOL["lse"]
        elif dtype == torch.bfloat16:
            checked = row_relative_error(g, r)
            tol = FLASH_TOL["bf16_row_rel"]
        else:
            checked = err
            tol = FLASH_TOL["f32_out" if name == "out" else "f32_grad"]
        if not torch.isfinite(g).all().item():
            err = checked = float("inf")
        out[name] = (err, checked, tol)
    return out


def flash_ok(errs):
    return all(c <= t for _, c, t in errs.values())


def flash_case_errors():
    """``(name, dtype, errors, plain outputs)`` for each of
    :data:`FLASH_CASES`, inputs drawn on the card from one seed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for name, spec in FLASH_CASES:
        got, ref = flash_outputs(make_flash_case(gen, **spec))
        yield name, spec["dtype"], flash_errors(got, ref, spec["dtype"]), ref


def phase_flash_cases():
    for name, dtype, errs, _ in flash_case_errors():
        ok = flash_ok(errs)
        emit("flash_case", case=name, dtype=str(dtype),
             max_abs_err={n: e for n, (e, _, _) in errs.items()},
             checked_err={n: c for n, (_, c, _) in errs.items()},
             tol={n: t for n, (_, _, t) in errs.items()}, ok=ok)
        if not ok:
            raise AssertionError("flash case {0}: {1}".format(name, errs))


def flash_bounds(b, s, h, d, itemsize, causal=True):
    """Least bytes (each input read once, each output written once) and
    tensor-core flop of K2, K3 and K4 at one shape (MHA): one product
    over the visible (query, key) pairs is 2 * D flop per pair."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    product = 2 * d * pairs
    t = b * s * h * d * itemsize  # one [B, S, H, D] tensor
    rows = b * h * s * 4  # one f32 [B, H, S] tensor
    return {
        "fwd": (4 * t + rows, 2 * product),   # q, k, v -> o, lse
        "dq": (5 * t + 2 * rows, 3 * product),  # q, k, v, dO, lse, delta -> dq
        "dkv": (6 * t + 2 * rows, 4 * product),  # ... -> dk, dv
    }


def phase_flash_timing():
    """K2, K3 and K4 at the flagship training shape, beside their plain
    versions, the bound, and scaled_dot_product_attention as a yardstick."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    b, s, h, d = 8, 2048, 8, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    c = make_flash_case(gen, b=b, s=s, h=h, hkv=h, d=d,
                        dtype=torch.bfloat16, causal=True)
    got, ref = flash_outputs(c)
    errs = flash_errors(got, ref, torch.bfloat16)
    if not flash_ok(errs):
        raise AssertionError("flash kernels at the flagship training shape: "
                             "{0}".format(errs))
    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    lse, delta = ref["lse"], fa._delta(ref["out"], dout)
    pos = (c["scale"], True, 0)
    kw = dict(scale=c["scale"], causal=True, window=0)
    args = (q, k, v, dout, lse, delta)
    runs = {
        "fwd": (lambda _: fa._launch_fwd(q, k, v, *pos),
                lambda _: fa.flash_forward_reference(q, k, v, **kw)),
        "dq": (lambda _: fa._launch_dq(*args, *pos),
               lambda _: fa.flash_dq_reference(*args, **kw)),
        "dkv": (lambda _: fa._launch_dkv(*args, *pos),
                lambda _: fa.flash_dkv_reference(*args, **kw)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot_ = dout.transpose(1, 2)

    def lib_fwd(_):
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True)

    def lib_fwd_bwd(_):
        return torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True),
                                   (qt, kt, vt), dot_)

    lib_fwd_ms = time_ms(lib_fwd, [None], reps=20, warmup=3)
    lib_bwd_ms = time_ms(lib_fwd_bwd, [None], reps=20, warmup=3) - lib_fwd_ms
    # SDPA's backward is one call for dQ, dK and dV: its time stands on
    # the dq row alone
    library = {
        "fwd": (lib_fwd_ms, "scaled_dot_product_attention(is_causal=True) "
                "forward"),
        "dq": (lib_bwd_ms, "SDPA's backward (forward+backward minus "
               "forward), one call computing dQ, dK and dV: compare with "
               "flash_dq + flash_dkv"),
        "dkv": (None, "SDPA's backward covers dK and dV; its time stands "
                "on flash_dq"),
    }
    bounds = flash_bounds(b, s, h, d, 2)
    err_of = {"fwd": max(errs["out"][0], errs["lse"][0]),
              "dq": errs["dq"][0], "dkv": max(errs["dk"][0], errs["dv"][0])}
    res = {}
    for name, (kernel, plain) in runs.items():
        nbytes, flops = bounds[name]
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
        ops_ms = 1e3 * flops / BF16_FLOPS_PER_SEC
        res[name] = dict(
            ms=time_ms(kernel, [None], reps=20, warmup=3),
            plain_ms=time_ms(plain, [None], reps=3, warmup=1),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, flops=flops, max_abs_err=err_of[name],
            library_ms=library[name][0], library_note=library[name][1],
        )
        res[name]["tflops"] = flops / res[name]["ms"] / 1e9
    emit("flash_timing", shape=dict(B=b, S=s, H=h, Hkv=h, D=d,
                                    dtype="bfloat16", causal=True), **res)
    return res


TRAIN_K, TRAIN_B, TRAIN_S = 4, 8, 2048
#: f32 flash vs dot training after three SGD steps: losses to rtol 1e-4;
#: in every parameter leaf, what max|theta_flash - theta_dot| exceeds
#: one f32 ulp of the weight by, under 1e-3 of how far the dot run
#: moved that leaf (max|theta_dot - theta_0|), so a wrong gradient
#: fails however small the leaf's steps are (the same f32 gradients
#: summed in another order differ by far less; a weight whose exact
#: update falls on the other side of a rounding boundary differs by
#: one ulp)
TRAIN_VS_DOT_TOL = {"loss_rtol": 1e-4, "param_rel_to_move": 1e-3}


def flagship_tree():
    """``(tree, seconds)``: the flagship's random Flax-layout weights from
    seed 0 (the serving and training phases share one) and the time it
    took to make them."""
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer

    t0 = time.perf_counter()
    tree = convert.init_params_tree(transformer.TransformerConfig(**FLAGSHIP),
                                    seed=0)
    return tree, time.perf_counter() - t0


def flagship_trainer(tree):
    """The bench flagship for training at full width: f32 master weights,
    bf16 compute, flash attention, ``SyncTrainer(loss_fn(model),
    adamw(1e-4))``, and one stacked [4, 8, 2048] token batch on the card."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import dp

    cfg = transformer.TransformerConfig(**dict(FLAGSHIP,
                                               attention_impl="flash"))
    model = convert.params_from_flax(tree, cfg, param_dtype=torch.float32)
    trainer = dp.SyncTrainer(transformer.loss_fn(model), optim.adamw(1e-4))
    state = trainer.create_state(dict(model.named_parameters()))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN_K, TRAIN_B, TRAIN_S))
    stacked = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(
        trainer.batch_sharding())}
    return cfg, model, trainer, state, stacked


def phase_train_flagship(tree, flash_timing):
    """One warm-up and two timed ``multi_step`` of K=4 of
    :func:`flagship_trainer` on its stacked batch."""
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    cfg, model, trainer, state, stacked = flagship_trainer(tree)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    losses, walls = [], []
    for _ in range(3):  # warm-up, then two timed groups
        t0 = time.perf_counter()
        state, metrics = trainer.multi_step_on_device(state, stacked)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    launches = dict(flash_attention.launches)
    losses = torch.cat(losses).float().cpu().numpy()
    steps = len(losses)
    peak = torch.cuda.max_memory_allocated()
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    best = min(walls[1:])
    step_ms = 1e3 * best / TRAIN_K
    tokens_per_sec = TRAIN_K * TRAIN_B * TRAIN_S / best
    flops_per_token = 6.0 * n_params + 12.0 * cfg.num_layers * \
        cfg.num_heads * cfg.head_dim * TRAIN_S
    res = dict(
        model="L16 H8 Dh128 Dm1024 V32000 bf16 compute, f32 masters",
        params=n_params, batch=[TRAIN_K, TRAIN_B, TRAIN_S], steps=steps,
        losses=losses.tolist(), warmup_sec=walls[0], timed_sec=walls[1:],
        step_ms=step_ms, tokens_per_sec=tokens_per_sec,
        mfu=tokens_per_sec * flops_per_token / BF16_FLOPS_PER_SEC,
        flops_per_token=flops_per_token, peak_memory_bytes=peak,
        launches=launches, param_dtypes=dtypes,
        kernel_share_of_step={
            name: cfg.num_layers * flash_timing[name]["ms"] / step_ms
            for name in ("fwd", "dq", "dkv")},
        device=torch.cuda.get_device_name(0),
    )
    emit("train_flagship", **res)
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss: {0}".format(losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall: {0}".format(losses))
    for name, n in launches.items():
        if n != cfg.num_layers * steps:
            raise AssertionError(
                "flash {0} launches {1} != {2} layers x {3} steps".format(
                    name, n, cfg.num_layers, steps))
    if dtypes != ["torch.float32"]:
        raise AssertionError("master parameters are {0}".format(dtypes))
    return res, model


def phase_train_kernel_vs_dot():
    """The flagship width in f32 at two layers, S=512, B=4: three SGD
    steps from the same weights with flash (the kernels) and dot
    attention (plain PyTorch), both on the card."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from tensorflowonspark_tpu_torch.parallel import dp

    base = dict(FLAGSHIP, dtype="float32", num_layers=2, max_seq_len=512)
    tree = convert.init_params_tree(transformer.TransformerConfig(**base),
                                    seed=8)
    tokens = np.random.default_rng(9).integers(
        0, base["vocab_size"], (3, 4, 512)).astype(np.int32)
    runs = {}
    for impl in ("flash", "dot"):
        cfg = transformer.TransformerConfig(**dict(base, attention_impl=impl))
        model = convert.params_from_flax(tree, cfg,
                                         param_dtype=torch.float32)
        trainer = dp.SyncTrainer(transformer.loss_fn(model),
                                 optim.sgd(0.01, momentum=0.9))
        state = trainer.create_state(dict(model.named_parameters()))
        flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
        state, metrics = trainer.multi_step(state, {"tokens": tokens})
        runs[impl] = (metrics["loss"].cpu().numpy(),
                      convert._flatten(convert.tree_from_model(model)),
                      dict(flash_attention.launches))
        del model, trainer, state
    loss_f, params_f, launches_f = runs["flash"]
    loss_d, params_d, launches_d = runs["dot"]
    loss_rel = float(np.max(np.abs(loss_f - loss_d) / np.abs(loss_d)))
    moved, diff, rel = leaf_agreement(convert._flatten(tree), params_f,
                                      params_d)
    worst = max(rel, key=rel.get)
    ok = (loss_rel <= TRAIN_VS_DOT_TOL["loss_rtol"]
          and rel[worst] <= TRAIN_VS_DOT_TOL["param_rel_to_move"]
          and min(launches_f.values()) > 0 and max(launches_d.values()) == 0)
    emit("train_kernel_vs_dot", model="L2 H8 Dh128 Dm1024 f32 S512 B4",
         losses_flash=loss_f.tolist(), losses_dot=loss_d.tolist(),
         loss_max_rel_diff=loss_rel, param_max_abs_diff=max(diff.values()),
         param_moved_by_leaf=moved, param_diff_rel_to_move=rel,
         worst_leaf=worst, tol=TRAIN_VS_DOT_TOL, launches_flash=launches_f,
         launches_dot=launches_d, ok=ok)
    if not ok:
        raise AssertionError("flash vs dot training disagree")


def leaf_agreement(init, got, want):
    """``(moved, diff, rel)`` per leaf of two trained trees from the same
    ``init``: how far ``want`` moved each leaf, the largest gap between
    the two, and what that gap exceeds one f32 rounding of the weight by,
    as a fraction of the move."""
    moved, diff, rel = {}, {}, {}
    for p in want:
        d = want[p]
        moved[p] = float(np.max(np.abs(d.astype(np.float64) - init[p])))
        gap = np.abs(got[p].astype(np.float64) - d)
        diff[p] = float(np.max(gap))
        # what exceeds one f32 rounding of the weight itself
        excess = float(np.max(np.maximum(gap - np.spacing(np.abs(d)), 0)))
        rel[p] = excess / moved[p] if moved[p] else \
            (0.0 if excess == 0 else float("inf"))
    return moved, diff, rel


def phase_train_to_serve(model):
    """The trained flagship weights through slice 1's serving path."""
    from tensorflowonspark_tpu_torch import convert

    tree = convert.tree_from_model(model)
    serving_cfg = dict(SERVING, max_new_tokens=16, max_prompt_len=64)
    rows = make_requests(np.random.default_rng(10), 4, FLAGSHIP["vocab_size"],
                         16, 64)
    out, stats, wall, launches = serve(FLAGSHIP, serving_cfg, tree, rows)
    gen = [np.asarray(r["generated"]) for r in out]
    ok = (len(gen) == 4 and all(
        g.shape == (16,) and g.min() >= 0 and g.max() < FLAGSHIP["vocab_size"]
        for g in gen) and launches > 0)
    emit("train_to_serve", requests=len(gen), tokens_out=stats["tokens_out"],
         wall_sec=wall, paged_attention_launches=launches,
         first_tokens=[g[:4].tolist() for g in gen], ok=ok)
    if not ok:
        raise AssertionError("trained weights did not serve: {0}".format(gen))


def phase_optimizer_timing(model):
    """One AdamW update over parameters of the flagship's shapes (f32):
    the port's ``optim.adamw``, which follows optax's op order and
    rounding, beside ``torch.optim.AdamW(fused=True)`` with the same
    hyperparameters, a one-pass yardstick the port does not call (its
    update equals optax's up to a few ulp).  The bound reads p, g, m, v
    and writes p, m, v once.  Gates nothing."""
    from tensorflowonspark_tpu_torch import optim

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    shapes = {n: p.shape for n, p in model.named_parameters()}

    def rnd():
        return {n: torch.randn(s, generator=gen, device="cuda") * 0.02
                for n, s in shapes.items()}

    params, grads = rnd(), list(rnd().values())
    port = optim.adamw(1e-4)
    state = port.init(params)
    port_ms = time_ms(lambda _: port.update(state, params, grads), [None],
                      reps=5, warmup=2)
    del state
    fused = torch.optim.AdamW(list(params.values()), lr=1e-4,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4, fused=True)
    for p, g in zip(params.values(), grads):
        p.grad = g
    fused_ms = time_ms(lambda _: fused.step(), [None], reps=5, warmup=2)
    n = sum(p.numel() for p in params.values())
    emit("optimizer_timing", params=n, port_adamw_ms=port_ms,
         fused_adamw_ms=fused_ms,
         bound_ms=1e3 * 7 * 4 * n / HBM_BYTES_PER_SEC, bound_by="bytes",
         device=torch.cuda.get_device_name(0))


#: lower-case kernel-name fragments -> class, first match wins, for the
#: profile of a training step
KERNEL_CLASSES = (
    ("flash_", "flash attention (K2-K4)"),
    ("gmm_kernel", "grouped matmul (K5-K7)"),
    ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
    ("nvjet", "matmul"), ("cublas", "matmul"),
    ("multi_tensor", "optimizer"), ("foreach", "optimizer"),
    ("softmax", "cross-entropy"), ("nll_loss", "cross-entropy"),
    ("reduce", "reductions"), ("copy", "casts and copies"),
    ("memcpy", "casts and copies"), ("memset", "casts and copies"),
    ("elementwise", "elementwise"),
)


def phase_train_profile(moe=False):
    """Device time of the flagship's training step by kernel class, from
    ``torch.profiler`` over one ``multi_step`` of K=4 after a warm-up;
    ``moe=True`` profiles the MoE flagship (:func:`moe_trainer`).  Not
    run by :func:`main`; run it alone with ``python3 -c "import
    chip_smoke as c; c.phase_env(); c.phase_build();
    c.phase_train_profile()"`` (or ``phase_train_profile(moe=True)``)."""
    from torch.profiler import ProfilerActivity, profile

    if moe:
        _, _, trainer, state, stacked = moe_trainer(moe_tree())
    else:
        _, _, trainer, state, stacked = flagship_trainer(flagship_tree()[0])
    state, _ = trainer.multi_step_on_device(state, stacked)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = trainer.multi_step_on_device(state, stacked)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes, kernels = {}, []
    for e in prof.key_averages():
        # device-side ranges of user annotations (the optimizer's step)
        # span kernels counted on their own
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        us = float(getattr(e, "self_device_time_total", 0.0)
                   or getattr(e, "self_cuda_time_total", 0.0))
        name = e.key.lower()
        kind = next((c for frag, c in KERNEL_CLASSES if frag in name),
                    "other")
        classes[kind] = classes.get(kind, 0.0) + us
        kernels.append((us, e.count, e.key[:120]))
    device_ms = sum(classes.values()) / 1e3
    per_step = {k: v / 1e3 / TRAIN_K for k, v in sorted(
        classes.items(), key=lambda kv: -kv[1])}
    emit("train_profile", model="moe" if moe else "dense", steps=TRAIN_K,
         wall_ms_per_step=1e3 * wall / TRAIN_K,
         device_ms_per_step=device_ms / TRAIN_K,
         device_busy_share=device_ms / (1e3 * wall) if wall else None,
         device_ms_per_step_by_class=per_step,
         top_kernels=[dict(ms_per_step=us / 1e3 / TRAIN_K,
                           calls_per_step=n / TRAIN_K, name=name)
                      for us, n, name in sorted(kernels, reverse=True)[:25]],
         note="wall includes the profiler's own overhead",
         device=torch.cuda.get_device_name(0))


#: the JAX package's MoE bench model (``python bench.py moe``, its
#: "dropless" row): 485M parameters, 183M active per token
MOE_FLAGSHIP = dict(
    vocab_size=32000, num_layers=4, num_heads=8, head_dim=128,
    embed_dim=1024, mlp_dim=4096, max_seq_len=2048, dtype="bfloat16",
    num_experts=8, expert_k=2, expert_dispatch="dropless",
)
MOE_TRAIN_B = 4
#: kernel launches per layer and training step under remat "block":
#: each block's forward runs twice (K5 for wi, wg, wo; K2) and its
#: backward once (K6 and K7 for each projection; K3, K4)
MOE_LAUNCHES_PER_LAYER = {"gmm": 6, "gmm_dxt": 3, "tgmm": 3,
                          "fwd": 2, "dq": 1, "dkv": 1}
GMM_SRC = "tensorflowonspark_tpu_torch/csrc/gmm.cu"
#: grouped-matmul kernels against their plain versions.  f32: max abs
#: error within 1e-5 of the output's max |ref| (the same f32 products
#: summed in another order, over up to a few thousand rows for dW).
#: bf16: every element within 2^-6 of |ref| + the RMS of its row
#: (:func:`row_relative_error`): both sides sum in f32 and round once,
#: so they differ by at most one bf16 ulp (2^-7 of |ref|).  An absent
#: expert's dW must be exactly 0.
GMM_TOL = {"f32_rel": 1e-5, "bf16_row_rel": 2 ** -6}
GMM_CASES = [
    ("flagship_bf16_d1024_f4096", dict(
        g=8192, k=2, e=8, d=1024, f=4096, bm=256, dtype=torch.bfloat16,
        heavy=0, absent=7)),
    ("flagship_bf16_f4096_d1024", dict(
        g=8192, k=2, e=8, d=4096, f=1024, bm=256, dtype=torch.bfloat16,
        heavy=3, absent=5)),
    ("f32_ragged_absent_bm256", dict(
        g=1000, k=2, e=6, d=200, f=392, bm=256, dtype=torch.float32,
        heavy=1, absent=2)),
]
GMM_KERNELS = ("gmm", "gmm_dxt", "tgmm")


def make_gmm_case(gen, *, g, k, e, d, f, bm, dtype, heavy=0, absent=None,
                  skew=2.0):
    """A dropless layout from a router that favours expert ``heavy`` and
    never picks ``absent``; tokens ``[G, D]`` gathered into it, expert
    weights ``[E, D, F]``, and an upstream gradient ``[NP, F]`` that is 0
    on pad rows, as the backward hands it over."""
    from tensorflowonspark_tpu_torch.ops import moe

    logits = torch.randn((g, e), generator=gen, device="cuda")
    logits[:, heavy] += skew
    if absent is not None:
        logits[:, absent] = -1e4
    experts, _, _ = moe.dropless_topk(logits, k=k)
    layout = moe.dropless_layout(experts, e, bm=bm)
    tokens = torch.randn((g, d), generator=gen, device="cuda").to(dtype)
    x = moe.dispatch_sorted(tokens, layout)
    live = (layout.slot_token < g)[:, None].float()
    dy = torch.randn((x.shape[0], f), generator=gen, device="cuda") * live
    w = torch.randn((e, d, f), generator=gen, device="cuda") * d ** -0.5
    return dict(x=x, w=w.to(dtype), dy=dy.to(dtype), te=layout.tile_expert,
                bm=bm, e=e, routed=g * k, absent=absent)


def gmm_outputs(c):
    """Each kernel's output and its plain version's on one case."""
    from tensorflowonspark_tpu_torch.ops import gmm

    x, w, dy, te, bm, e = (c[n] for n in ("x", "w", "dy", "te", "bm", "e"))
    got = dict(gmm=gmm.gmm_call(x, w, te, bm=bm),
               gmm_dxt=gmm.gmm_dxt_call(dy, w, te, bm=bm),
               tgmm=gmm.tgmm_call(x, dy, te, e, bm=bm))
    torch.cuda.synchronize()
    ref = dict(gmm=gmm.gmm_plain(x, w, te, bm=bm),
               gmm_dxt=gmm.gmm_dxt_plain(dy, w, te, bm=bm),
               tgmm=gmm.tgmm_plain(x, dy, te, e, bm=bm))
    return got, ref


def gmm_errors(got, ref, dtype):
    """``{kernel: (max abs err, checked err, tolerance)}``."""
    out = {}
    for name in GMM_KERNELS:
        g, r = got[name].float(), ref[name].float()
        err = (g - r).abs().max().item()
        if dtype == torch.bfloat16:
            checked, tol = row_relative_error(g, r), GMM_TOL["bf16_row_rel"]
        else:
            checked = err / max(r.abs().max().item(), 1e-30)
            tol = GMM_TOL["f32_rel"]
        if not torch.isfinite(g).all().item():
            err = checked = float("inf")
        out[name] = (err, checked, tol)
    return out


def gmm_case_results():
    """``(name, dtype, errors, absent expert's max |dW|)`` for each of
    :data:`GMM_CASES`, inputs drawn on the card from one seed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for name, spec in GMM_CASES:
        c = make_gmm_case(gen, **spec)
        got, ref = gmm_outputs(c)
        absent = got["tgmm"][c["absent"]].float().abs().max().item()
        yield name, spec["dtype"], gmm_errors(got, ref, spec["dtype"]), absent


def gmm_case_ok(errs, absent_dw):
    return all(c <= t for _, c, t in errs.values()) and absent_dw == 0.0


def phase_gmm_cases():
    for name, dtype, errs, absent_dw in gmm_case_results():
        ok = gmm_case_ok(errs, absent_dw)
        emit("gmm_case", case=name, dtype=str(dtype),
             max_abs_err={n: e for n, (e, _, _) in errs.items()},
             checked_err={n: c for n, (_, c, _) in errs.items()},
             tol={n: t for n, (_, _, t) in errs.items()},
             absent_expert_max_abs_dw=absent_dw, ok=ok)
        if not ok:
            raise AssertionError("gmm case {0}: {1}, absent expert dW "
                                 "{2}".format(name, errs, absent_dw))


def gmm_library(c):
    """One PyTorch call per kernel over the same expert runs (the
    yardstick; the port never calls it): ``torch._grouped_mm`` where this
    PyTorch has it, else a loop of ``torch.matmul`` over the experts.
    The runs' offsets are read from ``tile_expert`` here, outside any
    timed region."""
    x, w, dy, te, bm, e = (c[n] for n in ("x", "w", "dy", "te", "bm", "e"))
    rows = torch.bincount(te.long(), minlength=e) * bm
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(rows, 0).to(torch.int32)
        gm = torch._grouped_mm
        return {
            "gmm": lambda _: gm(x, w, offs=offs),
            "gmm_dxt": lambda _: gm(dy, w.transpose(-2, -1), offs=offs),
            "tgmm": lambda _: gm(x.t(), dy, offs=offs),
        }, "torch._grouped_mm over the layout's expert runs"
    ends = torch.cumsum(rows, 0).tolist()
    runs = [(end - n, end) for n, end in zip(rows.tolist(), ends)]

    def fwd(_):
        return [x[a:b] @ w[i] for i, (a, b) in enumerate(runs)]

    def dxt(_):
        return [dy[a:b] @ w[i].t() for i, (a, b) in enumerate(runs)]

    def tg(_):
        return [x[a:b].t() @ dy[a:b] for i, (a, b) in enumerate(runs)]

    return {"gmm": fwd, "gmm_dxt": dxt, "tgmm": tg}, \
        "a loop of torch.matmul over the experts' runs"


def phase_gmm_timing():
    """K5, K6 and K7 at the MoE flagship's training shape (8192 tokens,
    top-2 of 8 experts, D=1024, F=4096, bf16), beside their plain
    versions, the bound over the routed rows and the library yardstick."""
    from tensorflowonspark_tpu_torch.ops import gmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    c = make_gmm_case(gen, g=8192, k=2, e=8, d=1024, f=4096, bm=256,
                      dtype=torch.bfloat16, skew=0.0)
    got, ref = gmm_outputs(c)
    errs = gmm_errors(got, ref, torch.bfloat16)
    if not all(x <= t for _, x, t in errs.values()):
        raise AssertionError("gmm kernels at the flagship shape: {0}".format(
            errs))
    x, w, dy, te, bm, e = (c[n] for n in ("x", "w", "dy", "te", "bm", "e"))
    runs = {
        "gmm": (lambda _: gmm.gmm_call(x, w, te, bm=bm),
                lambda _: gmm.gmm_plain(x, w, te, bm=bm)),
        "gmm_dxt": (lambda _: gmm.gmm_dxt_call(dy, w, te, bm=bm),
                    lambda _: gmm.gmm_dxt_plain(dy, w, te, bm=bm)),
        "tgmm": (lambda _: gmm.tgmm_call(x, dy, te, e, bm=bm),
                 lambda _: gmm.tgmm_plain(x, dy, te, e, bm=bm)),
    }
    library, note = gmm_library(c)
    n_rows, d = x.shape
    f = w.shape[2]
    routed = c["routed"]
    present = int(torch.unique(te).numel())
    # least work: the routed rows only (NP adds each run's padding and
    # the tail tiles), each operand read once and each output written once
    flops = 2 * routed * d * f
    nbytes = 2 * (routed * d + present * d * f + routed * f)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
    ops_ms = 1e3 * flops / BF16_FLOPS_PER_SEC
    res = {}
    for name, (kernel, plain) in runs.items():
        ms = time_ms(kernel, [None], reps=20, warmup=3)
        res[name] = dict(
            ms=ms, plain_ms=time_ms(plain, [None], reps=3, warmup=1),
            library_ms=time_ms(library[name], [None], reps=20, warmup=3),
            library_note=note, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, flops=flops, flops_over_np=2 * n_rows * d * f,
            tflops=flops / ms / 1e9, max_abs_err=errs[name][0],
        )
    emit("gmm_timing", shape=dict(tokens=8192, k=2, E=8, D=d, F=f, bm=bm,
                                  routed_rows=routed, NP=n_rows,
                                  dtype="bfloat16"), **res)
    return res


def moe_tree():
    """The MoE flagship's random Flax-layout weights from seed 14."""
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer

    return convert.init_params_tree(
        transformer.TransformerConfig(**MOE_FLAGSHIP), seed=14)


def moe_trainer(tree):
    """The MoE bench model for training as the JAX package's bench runs
    it: f32 master weights, bf16 compute, flash attention, remat
    ``block``, ``SyncTrainer(moe_loss_fn(model), adamw(1e-4),
    has_aux=True)``, and one stacked [4, 4, 2048] token batch on the
    card."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import moe, transformer
    from tensorflowonspark_tpu_torch.parallel import dp

    cfg = transformer.TransformerConfig(**dict(
        MOE_FLAGSHIP, attention_impl="flash", remat=True,
        remat_policy="block"))
    model = convert.params_from_flax(tree, cfg, param_dtype=torch.float32)
    trainer = dp.SyncTrainer(moe.moe_loss_fn(model), optim.adamw(1e-4),
                             has_aux=True)
    state = trainer.create_state(dict(model.named_parameters()))
    tokens = np.random.default_rng(15).integers(
        0, cfg.vocab_size, (TRAIN_K, MOE_TRAIN_B, TRAIN_S))
    stacked = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(
        trainer.batch_sharding())}
    return cfg, model, trainer, state, stacked


def reset_launches():
    """Every kernel launch count of the port to 0."""
    from tensorflowonspark_tpu_torch.ops import flash_attention, gmm

    flash_attention.flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    gmm.grouped_matmul.launches = {n: 0 for n in GMM_KERNELS}


def read_launches():
    from tensorflowonspark_tpu_torch.ops import flash_attention, gmm

    return dict(gmm.grouped_matmul.launches,
                **flash_attention.flash_attention.launches)


def phase_moe_train_flagship(gmm_timing, flash_timing):
    """One warm-up and two timed ``multi_step`` of K=4 of
    :func:`moe_trainer` on its stacked batch."""
    cfg, model, trainer, state, stacked = moe_trainer(moe_tree())
    n_params = sum(p.numel() for p in model.parameters())
    expert = sum(p.numel() for n, p in model.named_parameters()
                 if ".moe." in n and not n.endswith(".router"))
    n_active = n_params - expert + expert * cfg.expert_k // cfg.num_experts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics, walls = [], []
    for _ in range(3):  # warm-up, then two timed groups
        t0 = time.perf_counter()
        state, m = trainer.multi_step_on_device(state, stacked)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = read_launches()
    per_step = {k: torch.cat([m[k] for m in metrics]).float().cpu().numpy()
                for k in ("loss", "ce", "moe_aux")}
    losses = per_step["loss"]
    steps = len(losses)
    peak = torch.cuda.max_memory_allocated()
    best = min(walls[1:])
    step_ms = 1e3 * best / TRAIN_K
    tokens_per_sec = TRAIN_K * MOE_TRAIN_B * TRAIN_S / best
    flops_per_token = 6.0 * n_active + 12.0 * cfg.num_layers * \
        cfg.num_heads * cfg.head_dim * TRAIN_S
    # per-step device time of each kernel at the timing phases' shapes
    # (the flash timing ran at B=8; this batch is B=4)
    per_launch_ms = {n: gmm_timing[n]["ms"] for n in GMM_KERNELS}
    per_launch_ms.update({n: flash_timing[n]["ms"] * MOE_TRAIN_B / TRAIN_B
                          for n in ("fwd", "dq", "dkv")})
    want = {n: c * cfg.num_layers * steps
            for n, c in MOE_LAUNCHES_PER_LAYER.items()}
    res = dict(
        model="L4 H8 Dh128 Dm1024 Dff4096 V32000 E8 top-2 dropless, remat "
              "block, flash, bf16 compute, f32 masters",
        params=n_params, active_params=n_active,
        batch=[TRAIN_K, MOE_TRAIN_B, TRAIN_S], steps=steps,
        losses=losses.tolist(), ce=per_step["ce"].tolist(),
        moe_aux=per_step["moe_aux"].tolist(), warmup_sec=walls[0],
        timed_sec=walls[1:], step_ms=step_ms, tokens_per_sec=tokens_per_sec,
        mfu_active=tokens_per_sec * flops_per_token / BF16_FLOPS_PER_SEC,
        flops_per_token=flops_per_token, peak_memory_bytes=peak,
        launches=launches, launches_expected=want,
        launches_per_step={n: v / steps for n, v in launches.items()},
        kernel_share_of_step_est={
            n: launches[n] / steps * ms / step_ms
            for n, ms in per_launch_ms.items()},
        device=torch.cuda.get_device_name(0),
    )
    emit("moe_train_flagship", **res)
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss: {0}".format(losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall: {0}".format(losses))
    if launches != want:
        raise AssertionError("launches {0} != {1}".format(launches, want))
    return res, model


def phase_moe_dropless_vs_gather():
    """The MoE flagship's widths in f32 at two layers, S=512, B=2: three
    SGD steps from the same weights with ``dropless`` (the kernels) and
    with ``gather`` at capacity factor E/k (plain PyTorch, nothing
    dropped), both on the card (dot attention in both), held to
    :data:`TRAIN_VS_DOT_TOL` (the same f32 products in another order)."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import moe, transformer
    from tensorflowonspark_tpu_torch.parallel import dp

    base = dict(MOE_FLAGSHIP, dtype="float32", num_layers=2,
                max_seq_len=512, capacity_factor=MOE_FLAGSHIP["num_experts"]
                / MOE_FLAGSHIP["expert_k"])
    tree = convert.init_params_tree(transformer.TransformerConfig(**base),
                                    seed=16)
    tokens = np.random.default_rng(17).integers(
        0, base["vocab_size"], (3, 2, 512)).astype(np.int32)
    runs = {}
    for dispatch in ("dropless", "gather"):
        cfg = transformer.TransformerConfig(**dict(base,
                                                   expert_dispatch=dispatch))
        model = convert.params_from_flax(tree, cfg,
                                         param_dtype=torch.float32)
        trainer = dp.SyncTrainer(moe.moe_loss_fn(model),
                                 optim.sgd(0.01, momentum=0.9), has_aux=True)
        state = trainer.create_state(dict(model.named_parameters()))
        reset_launches()
        state, metrics = trainer.multi_step(state, {"tokens": tokens})
        runs[dispatch] = (metrics["loss"].cpu().numpy(),
                          convert._flatten(convert.tree_from_model(model)),
                          {n: read_launches()[n] for n in GMM_KERNELS})
        del model, trainer, state
    loss_k, params_k, launches_k = runs["dropless"]
    loss_g, params_g, launches_g = runs["gather"]
    loss_rel = float(np.max(np.abs(loss_k - loss_g) / np.abs(loss_g)))
    moved, diff, rel = leaf_agreement(convert._flatten(tree), params_k,
                                      params_g)
    worst = max(rel, key=rel.get)
    ok = (loss_rel <= TRAIN_VS_DOT_TOL["loss_rtol"]
          and rel[worst] <= TRAIN_VS_DOT_TOL["param_rel_to_move"]
          and min(launches_k.values()) > 0 and max(launches_g.values()) == 0)
    emit("moe_train_dropless_vs_gather",
         model="L2 H8 Dh128 Dm1024 Dff4096 E8 top-2 f32 S512 B2",
         capacity_factor=base["capacity_factor"],
         losses_dropless=loss_k.tolist(), losses_gather=loss_g.tolist(),
         loss_max_rel_diff=loss_rel, param_max_abs_diff=max(diff.values()),
         param_moved_by_leaf=moved, param_diff_rel_to_move=rel,
         worst_leaf=worst, tol=TRAIN_VS_DOT_TOL,
         launches_dropless=launches_k, launches_gather=launches_g, ok=ok)
    if not ok:
        raise AssertionError("dropless vs gather MoE training disagree")


def phase_moe_train_to_serve(model):
    """The trained MoE weights through slice 1's serving path: K5 in
    every prefill and decode forward of every layer, K1 in every decode
    step."""
    from tensorflowonspark_tpu_torch import convert

    tree = convert.tree_from_model(model)
    serving_cfg = dict(SERVING, max_new_tokens=16, max_prompt_len=64)
    rows = make_requests(np.random.default_rng(18), 4,
                         MOE_FLAGSHIP["vocab_size"], 16, 64)
    reset_launches()
    out, stats, wall, paged = serve(MOE_FLAGSHIP, serving_cfg, tree, rows)
    launches = {n: read_launches()[n] for n in GMM_KERNELS}
    layers = MOE_FLAGSHIP["num_layers"]
    steps = stats["chunks"] * serving_cfg["chunk_size"]
    want = {"gmm": 3 * layers * (stats["admitted"] + steps), "gmm_dxt": 0,
            "tgmm": 0}
    gen = [np.asarray(r["generated"]) for r in out]
    vocab = MOE_FLAGSHIP["vocab_size"]
    ok = (len(gen) == 4 and all(g.shape == (16,) and g.min() >= 0
                                and g.max() < vocab for g in gen)
          and launches == want and paged == layers * steps)
    emit("moe_train_to_serve", requests=len(gen),
         tokens_out=stats["tokens_out"], wall_sec=wall, decode_steps=steps,
         prefills=stats["admitted"], gmm_launches=launches,
         gmm_launches_expected=want, paged_attention_launches=paged,
         first_tokens=[g[:4].tolist() for g in gen], ok=ok)
    if not ok:
        raise AssertionError("trained MoE weights did not serve: {0} "
                             "{1}".format(launches, gen))


def kernel_entry(name, replaces, launches, timing,
                 source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu"):
    return dict(
        name=name, route="cuda", source=source,
        replaces=replaces, launches=launches,
        max_abs_err=timing["max_abs_err"], ms=timing["ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
        library_note=timing["library_note"],
    )


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
    tree, init_s = flagship_tree()
    flagship = phase_slice_flagship(tree, init_s)
    phase_kernel_vs_gather()
    phase_flash_cases()
    flash = phase_flash_timing()
    train, model = phase_train_flagship(tree, flash)
    del tree
    phase_train_kernel_vs_dot()
    phase_train_to_serve(model)
    phase_optimizer_timing(model)
    del model
    phase_gmm_cases()
    gmm_timing = phase_gmm_timing()
    moe, moe_model = phase_moe_train_flagship(gmm_timing, flash)
    phase_moe_dropless_vs_gather()
    phase_moe_train_to_serve(moe_model)
    del moe_model
    jax_flash = "tensorflowonspark_tpu/ops/flash_attention.py:"
    jax_gmm = "tensorflowonspark_tpu/ops/gmm.py:"
    print(json.dumps({"kernels": [dict(
        name="paged_attention", route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        replaces="tensorflowonspark_tpu/ops/paged_attention.py:143",
        launches=flagship["paged_attention_launches"],
        max_abs_err=timing["max_abs_err"], ms=timing["kernel_ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
    )] + [
        kernel_entry("flash_fwd", jax_flash + "132",
                     train["launches"]["fwd"], flash["fwd"]),
        kernel_entry("flash_dq", jax_flash + "198",
                     train["launches"]["dq"], flash["dq"]),
        kernel_entry("flash_dkv", jax_flash + "256",
                     train["launches"]["dkv"], flash["dkv"]),
    ] + [
        kernel_entry(name, jax_gmm + line, moe["launches"][name],
                     gmm_timing[name], source=GMM_SRC)
        for name, line in (("gmm", "71"), ("gmm_dxt", "144"),
                           ("tgmm", "219"))
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
