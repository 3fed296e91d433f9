"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

Each phase prints one JSON line and raises on failure (nothing is
caught):

1. ``env``: torch, the card, its power limit.
2. ``build``: compiles every kernel source under
   ``tensorflowonspark_tpu_torch/csrc/`` with ``nvcc`` (one process per
   source, all started together), and fails unless ``cuobjdump -sass``
   shows ``HGMMA`` and ``UTMALDG`` in the bf16 Hopper kernels
   (:data:`WGMMA_KERNELS`) and ``-Xptxas=-v`` reports no spills for
   them, nor for the paged-decode kernels (:data:`SPILL_FREE_KERNELS`).
3. ``kernel_case``: the paged-decode kernels (split, combine) against
   their plain PyTorch version on the card, case by case
   (:data:`KERNEL_CASES`: bf16 flagship geometry, f32 GQA, sliding
   windows, int8 pools with scales, a length-1 slot, one long GQA
   request, more splits than live pages, narrow head-dim rows, two
   chunks of query heads, D=256); bf16 outputs held element by element
   to the row-relative rule of ``flash_case``.  ``paged_repeat``: two
   runs of the bf16 kernel give bit-identical outputs.
4. ``kernel_timing``: the kernel, its plain version and a library
   yardstick (gather + ``scaled_dot_product_attention``) beside the byte
   bound, at the flagship decode shape, a full 2048-token serving bank
   (B=32) and one long request under GQA (:data:`PAGED_TIMING_SHAPES`).
5. ``slice_flagship``: ``serving_builder`` + ``predict_rows(schedule=
   "continuous")`` at the flagship's full width (L16 H8 Dh128 Dm1024,
   bf16, paged KV) with random weights made from a seed; the kernel's
   launch count over that run must be 16 per decode step.
6. ``slice_kernel_vs_gather``: the same path in f32 at two layers with
   ``paged_impl="kernel"`` and ``"gather"``; greedy tokens must agree.
7. ``flash_case``: the flash kernels (forward, dQ, dK/dV) against their
   plain versions on the card (bf16 flagship geometry, bf16 D=64 GQA, and
   in both types a window across tiles, non-causal, a ragged S=1000 with
   GQA); bf16 outputs are held row by row (:data:`FLASH_TOL`).
   ``flash_repeat``: two runs of the bf16 dQ and dK/dV kernels on the
   flagship case give bit-identical outputs.
8. ``flash_timing``: the three kernels, their plain versions and
   ``scaled_dot_product_attention`` as a yardstick at the flagship
   training shape (B=8, S=2048, H=8, D=128, bf16, causal), beside the
   operation bound; then the kernels and the yardstick under GQA at the
   flagship width (Hkv=2) and at S=8192 (B=2), each checked against the
   plain versions.
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
    and both types with ragged counts and edges (:data:`GMM_TOL`); then
    the same with the layout's counts passed to K5 and K6 (and a
    four-token decode layout), whose rows past each expert's count must
    be exactly 0.
14. ``gmm_timing``: the three kernels, their plain versions and a
    library yardstick at the MoE flagship's training shape, beside the
    operation bound; K5 and K6 with and without the counts in both
    geometries on the balanced and the skewed layouts, K7 on the skewed
    layout, and K5 at a four-request decode step.
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
18. ``feed_train_flagship``: the executor-fleet feed path.
    ``cluster.run(LocalEngine(1), feed_train_fn, num_chips_per_node=1,
    input_mode=InputMode.SPARK)`` spawns the compute process on the card
    that ``cluster/gpu_info`` chose; ``TPUCluster.train`` feeds the
    ``train_flagship`` tokens as 32 rows ``{"tokens": int32[2048]}`` for
    3 epochs through the node's queue, and the compute process trains
    the flagship with ``SyncTrainer.train_on_feed`` (columnar, K=4): a
    warm-up call of 4 steps, a timed call of 8, then ``feed.terminate()``
    timed apart (what ``terminate_on_max_steps`` adds).  Its 12 losses must
    equal ``train_flagship``'s within :data:`FEED_LOSS_RTOL` (1e-6)
    relative, K2-K4 must launch 16 x 12 times there, its card's UUID
    must be the one ``gpu_info`` chose, and a second tiny cluster whose
    fn raises at once must fail the driver with an error naming the
    executor.

Then a ``kernels`` summary line, the ``nvidia-smi`` name/power-limit
line, and as the last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
``phase_train_profile`` (not run by :func:`main`) breaks a training step
down by kernel class for the dense or the MoE flagship, and
``phase_serve_profile`` (not run by it either) a serving decode step;
``phase_register_probe`` (not run by it either) builds a minimal kernel
in five variants of its roles and waits and reports ptxas's registers
and spills; ``phase_feed_global_stop(4)`` (not run by it either; four
cards) holds the feed path's global stop across four executors with a
card each, over NCCL with a ``gloo`` flag group.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM memory rate and f32 (non-tensor-core) peak, NVIDIA data sheet
HBM_BYTES_PER_SEC = 3.35e12
F32_FLOPS_PER_SEC = 67e12

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


#: library -> the Hopper kernels built in it whose SASS must hold every
#: instruction of :data:`SASS_MUST_HOLD`, with no spills in ``-Xptxas=-v``
#: (each name matched as a substring of the mangled names, so no name may
#: be a substring of another's)
WGMMA_KERNELS = {"flash_attention": ["flash_fwd_wgmma", "flash_dq_wgmma",
                                     "flash_dkv_wgmma"],
                 "gmm": ["tgmm_wgmma", "gmm_rows_wgmma"]}
#: warpgroup MMA (``wgmma``) and TMA tile loads (``cp.async.bulk.tensor``)
SASS_MUST_HOLD = ("HGMMA", "UTMALDG")
#: library -> kernels of it that must spill nothing in ``-Xptxas=-v``
#: (no instruction required of their SASS); names as for WGMMA_KERNELS
SPILL_FREE_KERNELS = {"paged_attention": ["paged_decode_split",
                                          "paged_combine"]}


def cuda_tool(name):
    """A CUDA toolkit program: ``PATH``, then ``$CUDA_HOME/bin``."""
    return shutil.which(name) or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", name)


def sass_functions(library):
    """``{mangled function name: SASS text}`` of a built library, from
    ``cuobjdump -sass``."""
    text = subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", library], check=True,
        capture_output=True, text=True, timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {n: "\n".join(lines) for n, lines in funcs.items()}


def ptxas_functions(report):
    """``{mangled function name: {registers, stack, spill_stores,
    spill_loads}}`` from an ``-Xptxas=-v`` report."""
    funcs, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name is not None:
            funcs[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            funcs[name]["registers"] = int(m.group(1))
    return funcs


def wgmma_sass_check(library, kernel, report, must_hold=SASS_MUST_HOLD):
    """What the SASS and the compiler report say of one Hopper kernel:
    each of its instantiations must hold every instruction of
    ``must_hold`` and spill nothing."""
    sass = {n: t for n, t in sass_functions(library).items() if kernel in n}
    ptxas = {n: f for n, f in ptxas_functions(report).items() if kernel in n}
    found = {n: {op: op in t for op in must_hold}
             for n, t in sass.items()}
    warnings = [line.strip() for line in report.splitlines()
                if "warning" in line.lower()]
    ok = (bool(sass) and set(sass) == set(ptxas)
          and all(all(v.values()) for v in found.values())
          and all(f.get("spill_stores", 1) == 0 and f.get("spill_loads", 1)
                  == 0 for f in ptxas.values()))
    return dict(kernel=kernel, instructions=found, ptxas=ptxas,
                ptxas_warnings=warnings, ok=ok)


def phase_build():
    from tensorflowonspark_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build()
    reports = {name: _build.build_report(name) for name in secs}
    checks = {name: [wgmma_sass_check(_build.library_path(name), kernel,
                                      reports[name]) for kernel in kernels]
              for name, kernels in WGMMA_KERNELS.items()}
    checks.update({
        name: [wgmma_sass_check(_build.library_path(name), kernel,
                                reports[name], must_hold=())
               for kernel in kernels]
        for name, kernels in SPILL_FREE_KERNELS.items()})
    emit("build", seconds=time.perf_counter() - t0, per_library=secs,
         ptxas=reports, sass_check=checks)
    bad = [c for cs in checks.values() for c in cs if not c["ok"]]
    if bad:
        raise AssertionError(
            "Hopper kernels without {0} in their SASS (WGMMA_KERNELS), or "
            "spilling: {1}".format("/".join(SASS_MUST_HOLD), bad))


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


#: the paged-decode kernel against its plain version: f32 to 1e-5
#: absolute (the same f32 products summed in another order, the splits
#: combined); bf16 every element to ``FLASH_TOL["bf16_row_rel"]`` of
#: |ref| + the RMS of its row of D values (:func:`row_relative_error`),
#: which holds a dropped page at long lengths far more tightly than a
#: max-abs rule
PAGED_F32_TOL = 1e-5

#: (name, make_paged_case spec, window); the split counts are the
#: wrapper's (``ops/paged_attention.num_splits`` on 132 SMs: 9 for the
#: flagship case, 128 for the long request, 16 and 8 for the two cases
#: with more splits than some slots' live pages)
KERNEL_CASES = [
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
    # S3 of kernel_timing: one long request under GQA, 128 splits
    ("bf16_long_gqa_request", dict(
        b=1, h=8, hkv=2, d=128, t=16, nb=128, dtype=torch.bfloat16,
        lengths=[2048],
    ), 0),
    # 16 splits: three slots have fewer live pages (empty splits)
    ("bf16_splits_past_live_pages", dict(
        b=4, h=8, hkv=2, d=128, t=16, nb=16, dtype=torch.bfloat16,
        lengths=[1, 20, 100, 256],
    ), 0),
    # the window's first position falls inside a page of a split; 8
    # splits over 7 live pages
    ("bf16_window_edge_inside_split", dict(
        b=2, h=8, hkv=4, d=64, t=16, nb=16, dtype=torch.bfloat16,
        lengths=[200, 250],
    ), 100),
    # 72-byte rows: 8-byte copies
    ("bf16_d36_narrow_rows", dict(
        b=3, h=4, hkv=2, d=36, t=16, nb=8, dtype=torch.bfloat16,
        lengths=[5, 64, 127],
    ), 0),
    # 66-byte rows: element copies
    ("bf16_d33_element_copies", dict(
        b=2, h=4, hkv=4, d=33, t=8, nb=6, dtype=torch.bfloat16,
        lengths=[7, 48],
    ), 0),
    # 36-byte int8 rows (4-byte copies) with scales and a window
    ("f32_int8_d36_window", dict(
        b=2, h=4, hkv=1, d=36, t=8, nb=10, dtype=torch.float32,
        pool_dtype=torch.int8, lengths=[30, 77],
    ), 20),
    # G=16: two chunks of 8 query heads
    ("f32_mqa_two_head_chunks", dict(
        b=2, h=16, hkv=1, d=64, t=16, nb=8, dtype=torch.float32,
        lengths=[50, 128],
    ), 0),
    # D=256: 8 elements a lane, 8 query heads in registers
    ("bf16_d256_gqa8", dict(
        b=2, h=16, hkv=2, d=256, t=16, nb=8, dtype=torch.bfloat16,
        lengths=[33, 128],
    ), 0),
]


def paged_error(out, ref):
    """``(max abs err, checked err, tolerance)`` of a paged-decode output
    against its plain version: the max abs error in f32, the
    row-relative error in bf16."""
    got, want = out.float(), ref.float()
    err = (got - want).abs().max().item()
    if ref.dtype == torch.bfloat16:
        checked, tol = row_relative_error(got, want), FLASH_TOL["bf16_row_rel"]
    else:
        checked, tol = err, PAGED_F32_TOL
    if not torch.isfinite(got).all().item():
        err = checked = float("inf")
    return err, checked, tol


def paged_args(case, window=0):
    args = [case[k] for k in ("q", "k_pool", "v_pool", "block_tables",
                              "lengths")]
    kw = dict(window=window, k_scale_pool=case["k_scale_pool"],
              v_scale_pool=case["v_scale_pool"])
    return args, kw


def paged_case_results():
    """``(name, dtype, (max abs err, checked err, tol))`` for each of
    :data:`KERNEL_CASES`, inputs drawn on the card from one seed."""
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name, spec, window in KERNEL_CASES:
        case = make_paged_case(gen, **spec)
        args, kw = paged_args(case, window)
        out = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_attention_reference(*args, **kw)
        yield name, spec["dtype"], paged_error(out, ref)


def phase_kernel_cases():
    for name, dtype, (err, checked, tol) in paged_case_results():
        ok = checked <= tol
        emit("kernel_case", case=name, dtype=str(dtype), max_abs_err=err,
             checked_err=checked, tol=tol, ok=ok)
        if not ok:
            raise AssertionError(
                "kernel case {0}: checked err {1} > {2}".format(
                    name, checked, tol))


def phase_paged_repeat():
    """Two runs of the bf16 kernel on the flagship case of
    :data:`KERNEL_CASES` (several splits, so the combine runs) must give
    bit-identical outputs."""
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _, spec, window = KERNEL_CASES[0]
    args, kw = paged_args(make_paged_case(gen, **spec), window)
    runs = [paged_attention(*args, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    same = torch.equal(runs[0], runs[1])
    emit("paged_repeat", case=KERNEL_CASES[0][0], bit_identical=same,
         ok=same)
    if not same:
        raise AssertionError("bf16 paged kernel differs between two runs")


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


def device_ms(fn, inputs, reps=50, warmup=5):
    """Mean device time per call of ``fn`` (every CUDA kernel it runs),
    from ``torch.profiler`` over ``reps`` calls cycling through
    ``inputs``: for calls shorter than their host-side cost, where CUDA
    events around back-to-back calls would time the host instead."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0.0)
                   or getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def graph_ms(fn, inputs, reps=50):
    """Device time per call of ``fn`` with no host in the way: ``reps``
    calls cycling through ``inputs`` captured in one CUDA graph, the
    median over five timed replays (CUDA events) divided by ``reps``.
    Each call's kernels and the gaps between them count; the host's
    dispatch does not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(samples))


#: the shapes ``kernel_timing`` times (bf16, T=16, D=128): the flagship
#: decode step, which the ``kernels`` line reports; a full serving bank
#: at the flagship's max_seq_len; one long request under GQA.  Lengths
#: are drawn from ``np.random.default_rng(seed)`` in [lo, hi].
PAGED_TIMING_SHAPES = [
    ("s1_flagship", dict(b=8, h=8, hkv=8, nb=32, lo=32, hi=500, seed=1)),
    ("s2_full_bank", dict(b=32, h=8, hkv=8, nb=128, lo=1024, hi=2048,
                          seed=2)),
    ("s3_long_gqa", dict(b=1, h=8, hkv=2, nb=128, lo=2048, hi=2048,
                         seed=3)),
]
#: bytes of pools the timed calls cycle through: three times the L2
TIMING_POOL_BYTES = 150e6


def paged_timing_at(gen, *, b, h, hkv, nb, lo, hi, seed, d=128, t=16):
    """The kernel, its plain version and gather + SDPA at one bf16 decode
    shape, beside the byte bound; the kernel checked against the plain
    version first.  Each call reads its pools cold: the calls cycle
    through copies of the pools worth :data:`TIMING_POOL_BYTES`.
    Needs only the wrapper's public functions."""
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        gather_pool, paged_attention, paged_attention_reference,
    )

    rng = np.random.default_rng(seed)
    lengths = sorted(int(x) for x in rng.integers(lo, hi + 1, size=b))
    spec = dict(b=b, h=h, hkv=hkv, d=d, t=t, nb=nb, dtype=torch.bfloat16,
                lengths=lengths)
    pool_bytes = 2 * (b * nb + 1) * t * hkv * d * 2
    n_copies = max(2, int(np.ceil(TIMING_POOL_BYTES / pool_bytes)))
    copies = [make_paged_case(gen, **spec) for _ in range(n_copies)]
    case = copies[0]
    span = torch.arange(nb * t, device="cuda")
    for c in copies:
        c["mask"] = (span[None, :] < c["lengths"][:, None].long())[
            :, None, None, :]

    def run(c):
        return paged_attention(c["q"], c["k_pool"], c["v_pool"],
                               c["block_tables"], c["lengths"])

    def plain(c):
        return paged_attention_reference(c["q"], c["k_pool"], c["v_pool"],
                                         c["block_tables"], c["lengths"])

    def library(c):
        kk = gather_pool(c["k_pool"], c["block_tables"]).transpose(1, 2)
        vv = gather_pool(c["v_pool"], c["block_tables"]).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            c["q"][:, :, None], kk, vv, attn_mask=c["mask"],
            enable_gqa=hkv != h,
        )[:, :, 0]

    out = run(case)
    ref = plain(case)
    lib = library(case)
    torch.cuda.synchronize()
    err, checked, tol = paged_error(out, ref)
    lib_err = (lib.float() - ref.float()).abs().max().item()
    del out, ref, lib
    if not checked <= tol:
        raise AssertionError("kernel at B={0} H={1} Hkv={2} NB={3}: checked "
                             "err {4} > {5}".format(b, h, hkv, nb, checked,
                                                    tol))
    nbytes, flops = bytes_and_flops(case, t)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
    ops_ms = 1e3 * flops / F32_FLOPS_PER_SEC
    kernel_ms = graph_ms(run, copies)
    heavy = nb * b > 1024
    return dict(
        shape=dict(B=b, H=h, Hkv=hkv, D=d, T=t, NB=nb, lengths=lengths,
                   dtype="bfloat16"),
        pool_copies=n_copies,
        kernel_ms=kernel_ms,
        kernel_device_ms=device_ms(run, copies),
        kernel_eager_ms=time_ms(run, copies),
        plain_ms=time_ms(plain, copies, reps=5 if heavy else 50,
                         warmup=2),
        library_ms=graph_ms(library, copies, reps=4 if heavy else 20),
        library_eager_ms=time_ms(library, copies, reps=10 if heavy else 50,
                                 warmup=2),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_share=max(bytes_ms, ops_ms) / kernel_ms,
        bytes=nbytes, flops=flops, max_abs_err=err, checked_err=checked,
        tol=tol, library_max_abs_err=lib_err,
        note="kernel_ms and library_ms: CUDA-graph replays (device only); "
             "*_eager_ms: back-to-back calls timed by CUDA events, the "
             "host's dispatch included; kernel_device_ms: the profiler's "
             "sum of kernel times per call",
    )


def phase_kernel_timing():
    """:func:`paged_timing_at` over :data:`PAGED_TIMING_SHAPES`, one line
    each; returns the flagship shape's timings."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = {}
    for name, shape in PAGED_TIMING_SHAPES:
        res = paged_timing_at(gen, **shape)
        emit("kernel_timing", case=name, **res)
        out[name] = res
        torch.cuda.empty_cache()
    return out["s1_flagship"]


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
    ("bf16_window_300", dict(b=1, s=1024, h=4, hkv=4, d=128,
                             dtype=torch.bfloat16, causal=True, window=300)),
    ("bf16_non_causal", dict(b=2, s=256, h=4, hkv=4, d=128,
                             dtype=torch.bfloat16, causal=False)),
    ("bf16_ragged_s1000_gqa", dict(b=1, s=1000, h=4, hkv=2, d=128,
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


def phase_flash_repeat():
    """Two runs of the bf16 K3 and K4 on the inputs of the flagship case
    of :data:`FLASH_CASES` must give bit-identical outputs."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    c = make_flash_case(gen, **dict(FLASH_CASES)["flagship_bf16_causal"])
    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    pos = (c["scale"], c["causal"], c["window"])
    out, lse = fa.flash_forward_reference(q, k, v, scale=pos[0],
                                          causal=pos[1], window=pos[2])
    args = (q, k, v, dout, lse, fa._delta(out, dout))
    runs = [(fa._launch_dq(*args, *pos),) + fa._launch_dkv(*args, *pos)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = {n: torch.equal(x, y)
            for n, x, y in zip(("dq", "dk", "dv"), *runs)}
    emit("flash_repeat", case="flagship_bf16_causal", bit_identical=same,
         ok=all(same.values()))
    if not all(same.values()):
        raise AssertionError("bf16 K3/K4 differ between two runs: "
                             "{0}".format(same))


def flash_bounds(b, s, h, hkv, d, itemsize, causal=True):
    """Least bytes (each input read once, each output written once) and
    tensor-core flop of K2, K3 and K4 at one shape: one product over the
    visible (query, key) pairs of every query head is 2 * D flop per
    pair."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    product = 2 * d * pairs
    t = b * s * h * d * itemsize  # one [B, S, H, D] tensor
    tk = b * s * hkv * d * itemsize  # one [B, S, Hkv, D] tensor
    rows = b * h * s * 4  # one f32 [B, H, S] tensor
    return {
        # q, k, v -> o, lse
        "fwd": (2 * t + 2 * tk + rows, 2 * product),
        # q, k, v, dO, lse, delta -> dq
        "dq": (3 * t + 2 * tk + 2 * rows, 3 * product),
        # ... -> dk, dv
        "dkv": (2 * t + 4 * tk + 2 * rows, 4 * product),
    }


#: the shapes ``flash_timing`` times (bf16, causal): the flagship training
#: shape, which the ``kernels`` line reports, then GQA at the flagship
#: width and a long sequence
FLASH_TIMING_SHAPES = [
    ("flagship", dict(b=8, s=2048, h=8, hkv=8, d=128)),
    ("gqa_hkv2", dict(b=8, s=2048, h=8, hkv=2, d=128)),
    ("s8192", dict(b=2, s=8192, h=8, hkv=8, d=128)),
]


def flash_timing_at(gen, *, b, s, h, hkv, d, plain=True):
    """K2, K3 and K4 at one bf16 causal shape, checked against their
    plain versions, beside the bound and scaled_dot_product_attention as
    a yardstick (``plain``: the plain versions timed too)."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    c = make_flash_case(gen, b=b, s=s, h=h, hkv=hkv, d=d,
                        dtype=torch.bfloat16, causal=True)
    got, ref = flash_outputs(c)
    errs = flash_errors(got, ref, torch.bfloat16)
    if not flash_ok(errs):
        raise AssertionError("flash kernels at B={0} S={1} H={2} Hkv={3}: "
                             "{4}".format(b, s, h, hkv, errs))
    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    lse, delta = ref["lse"], fa._delta(ref["out"], dout)
    del got, ref
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
    gqa = dict(enable_gqa=True) if hkv != h else {}

    def lib_fwd(_):
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True, **gqa)

    def lib_fwd_bwd(_):
        return torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True, **gqa),
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
    bounds = flash_bounds(b, s, h, hkv, d, 2)
    err_of = {"fwd": max(errs["out"][0], errs["lse"][0]),
              "dq": errs["dq"][0], "dkv": max(errs["dk"][0], errs["dv"][0])}
    res = {}
    for name, (kernel, plain_fn) in runs.items():
        nbytes, flops = bounds[name]
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
        ops_ms = 1e3 * flops / BF16_FLOPS_PER_SEC
        res[name] = dict(
            ms=time_ms(kernel, [None], reps=20, warmup=3),
            plain_ms=(time_ms(plain_fn, [None], reps=3, warmup=1)
                      if plain else None),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, flops=flops, max_abs_err=err_of[name],
            library_ms=library[name][0], library_note=library[name][1],
        )
        res[name]["tflops"] = flops / res[name]["ms"] / 1e9
    return res


def phase_flash_timing():
    """:func:`flash_timing_at` over :data:`FLASH_TIMING_SHAPES`, one line
    each; returns the flagship shape's timings."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out = {}
    for name, shape in FLASH_TIMING_SHAPES:
        res = flash_timing_at(gen, plain=name == "flagship", **shape)
        emit("flash_timing", case=name, shape=dict(
            B=shape["b"], S=shape["s"], H=shape["h"], Hkv=shape["hkv"],
            D=shape["d"], dtype="bfloat16", causal=True), **res)
        out[name] = res
    return out["flagship"]


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


#: A minimal kernel shaped like the bf16 K4 consumer's loop at D = 128
#: (dK and dV sums of 64 registers each, S^T and dP^T tiles of 32, the
#: packed P^T and dS^T fragments), built in five variants to see
#: which one ptxas lets hold them without spilling: 0, 384 threads with
#: the role index threadIdx.x / 128 and setmaxnreg 24/240, the producer
#: returning at once; 1, the same with the index read from lane 0
#: (warp-uniform); 2, 288 threads (two consumer warpgroups and one
#: producer warp), no setmaxnreg; 3, as 0 but with the consumer in the
#: else branch of the role test, so both roles reach the kernel's end; 4,
#: as 0 but the consumer's barrier wait has the watchdog (a __trap after
#: 4 s) that the others' lacks.
REGISTER_PROBE = r"""
#include <cuda_bf16.h>

#include "hopper.cuh"
constexpr int kThreads = VARIANT == 2 ? 288 : 384;
__global__ void __launch_bounds__(kThreads, 1)
    register_probe(float* out, int n, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (hopper::smem_u32(smem) + 1023u) & ~1023u;
  const float* col = reinterpret_cast<const float*>(smem);
#if VARIANT == 1
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
#else
  const int wg = threadIdx.x / 128;
#endif
  const bool producer = VARIANT == 2 ? wg == 2 : wg == 0;
  if (producer) {
#if VARIANT != 2
    hopper::reg_dealloc<24>();
#endif
    if (threadIdx.x % 128 == 0) out[0] = 0.f;
#if VARIANT != 3
    return;
  }
#else
  } else {
#endif
#if VARIANT != 2
  hopper::reg_alloc<240>();
#endif
  const int t = threadIdx.x & 3;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  for (int it = 0; it < n; ++it) {
    float s[32], dp[32];
    const uint32_t st = base + (it & 1) * 32768;
#if VARIANT == 4
    hopper::mbar_wait(base + 65536, it & 1);
#else
    hopper::mbar_wait_spin(base + 65536, it & 1);
#endif
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t a0 = base + (kk >> 2) * 16384 + (kk & 3) * 32;
      const uint32_t b0 = st + (kk >> 2) * 16384 + (kk & 3) * 32;
      hopper::wgmma_m64n64_ss<0, 0>(s, hopper::desc_sw128(a0, 16, 1024),
                                    hopper::desc_sw128(b0, 16, 1024), kk > 0);
      hopper::wgmma_m64n64_ss<0, 0>(dp, hopper::desc_sw128(a0 + 8192, 16, 1024),
                                    hopper::desc_sw128(b0 + 8192, 16, 1024),
                                    kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    uint32_t pp[16], dsp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 8 * (i >> 1) + 2 * t;
      float p0 = exp2f(fmaf(s[2 * i], scale, -col[c]));
      float p1 = exp2f(fmaf(s[2 * i + 1], scale, -col[c + 1]));
      if (c > it) p0 = p1 = 0.f;
      const float d0 = p0 * (dp[2 * i] - col[64 + c]) * scale;
      const float d1 = p1 * (dp[2 * i + 1] - col[65 + c]) * scale;
      __nv_bfloat162 x = __floats2bfloat162_rn(p0, p1);
      __nv_bfloat162 y = __floats2bfloat162_rn(d0, d1);
      pp[i] = *reinterpret_cast<uint32_t*>(&x);
      dsp[i] = *reinterpret_cast<uint32_t*>(&y);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t b0 = st + kk * 2048;
      hopper::wgmma_m64n128_rs<1>(
          dv, pp + 4 * kk, hopper::desc_sw128(b0 + 16384, 8192, 1024), 1);
      hopper::wgmma_m64n128_rs<1>(
          dk, dsp + 4 * kk, hopper::desc_sw128(b0, 8192, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::fence_regs(pp);
    hopper::fence_regs(dsp);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    out[threadIdx.x * 128 + i] = dk[i];
    out[threadIdx.x * 128 + 64 + i] = dv[i];
  }
#if VARIANT == 3
  }
#endif
}
"""


def phase_register_probe():
    """Build :data:`REGISTER_PROBE` in its five variants (one
    ``nvcc`` each, all started together) and report what ``-Xptxas=-v``
    says of each: registers, stack, spills.  Not run by :func:`main`:
    ``python3 -c "import chip_smoke as c; c.phase_env();
    c.phase_register_probe()"``."""
    from tensorflowonspark_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "register_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "register_probe.cu")
    with open(src, "w") as f:
        f.write(REGISTER_PROBE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",
                                                       "-Xcompiler",
                                                       "-fPIC")]
    procs = {v: subprocess.Popen(
        [_build.nvcc_path(), *flags, "-cubin", "-DVARIANT={0}".format(v),
         "-I", _build.CSRC_DIR, "-o",
         os.path.join(out_dir, "probe{0}.cubin".format(v)), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v in (0, 1, 2, 3, 4)}
    layouts = {0: "384 threads, threadIdx.x / 128, setmaxnreg 24/240",
               1: "384 threads, warp-uniform index, setmaxnreg 24/240",
               2: "288 threads, no setmaxnreg",
               3: "384 threads, setmaxnreg 24/240, roles joined at the end",
               4: "as 0, the consumer's wait with the trapping watchdog"}
    res = {}
    for v, proc in procs.items():
        report = proc.communicate()[0]
        res[layouts[v]] = dict(rc=proc.returncode,
                               ptxas=ptxas_functions(report),
                               report=report[-2000:])
    emit("register_probe", **res)
    return res


#: lower-case kernel-name fragments -> class, first match wins, for the
#: profile of a training step
KERNEL_CLASSES = (
    ("paged_", "paged attention (K1)"),
    ("flash_", "flash attention (K2-K4)"),
    ("gmm_kernel", "grouped matmul (K5-K7)"),
    ("gmm_rows_wgmma", "grouped matmul (K5-K7)"),
    ("tgmm_wgmma", "grouped matmul (K5-K7)"),
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
    if moe:
        _, _, trainer, state, stacked = moe_trainer(moe_tree())
    else:
        _, _, trainer, state, stacked = flagship_trainer(flagship_tree()[0])
    state, _ = trainer.multi_step_on_device(state, stacked)
    torch.cuda.synchronize()

    def steps():
        trainer.multi_step_on_device(state, stacked)

    emit("train_profile", model="moe" if moe else "dense",
         **profile_steps(steps, TRAIN_K))


def profile_steps(run, steps):
    """Device time of ``run()`` (which must do ``steps`` steps) by
    kernel class, from ``torch.profiler``, beside its wall (host clock,
    ending in a synchronize), per step.  ``run()`` goes once without
    the profiler first: the busy share is the device time over that
    wall (``device_busy_share``) and over the profiled one."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    per_step = {k: v / 1e3 / steps for k, v in sorted(
        classes.items(), key=lambda kv: -kv[1])}
    return dict(
        steps=steps, wall_ms_per_step=1e3 * plain_wall / steps,
        profiled_wall_ms_per_step=1e3 * wall / steps,
        device_ms_per_step=device_ms / steps,
        device_busy_share=device_ms / (1e3 * plain_wall),
        device_busy_share_profiled=device_ms / (1e3 * wall),
        device_ms_per_step_by_class=per_step,
        top_kernels=[dict(ms_per_step=us / 1e3 / steps,
                          calls_per_step=n / steps, name=name)
                     for us, n, name in sorted(kernels, reverse=True)[:25]],
        note="profiled_wall includes the profiler's own overhead",
        device=torch.cuda.get_device_name(0))


def phase_serve_profile(chunks=3):
    """Device time of the flagship's serving decode step by kernel class
    (K1's share included) and the device's busy share of the wall, from
    ``torch.profiler`` over ``chunks`` decode chunks of 16 steps on 8
    slots (after the prompts' prefill, one warm-up chunk and ``chunks``
    unprofiled ones, :func:`profile_steps`).  Random
    weights as in ``slice_flagship``.  Not run by :func:`main`; run it
    alone with ``python3 -c "import chip_smoke as c; c.phase_env();
    c.phase_build(); c.phase_serve_profile()"``.  Needs only the
    serving entry points, so it also profiles another tree's package."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )

    serving_cfg = dict(SERVING, max_new_tokens=(2 * chunks + 1)
                       * SERVING["chunk_size"])
    predict = serving_builder(flagship_tree()[0],
                              dict(FLAGSHIP, **serving_cfg))
    dec = predict.make_slot_decoder(SLOTS)
    rows = make_requests(np.random.default_rng(2), SLOTS,
                         FLAGSHIP["vocab_size"], 16, SERVING["max_prompt_len"])
    for slot, row in enumerate(rows):
        dec.admit(slot, row["tokens"])
    dec.step_chunk()
    torch.cuda.synchronize()

    def run():
        for _ in range(chunks):
            dec.step_chunk()

    res = profile_steps(run, chunks * SERVING["chunk_size"])
    k1 = res["device_ms_per_step_by_class"].get("paged attention (K1)", 0.0)
    emit("serve_profile", model="L16 H8 Dh128 Dm1024 bf16, 8 slots",
         prompt_lens=[int(len(r["tokens"])) for r in rows],
         k1_share_of_device=k1 / res["device_ms_per_step"], **res)


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
#: expert's dW must be exactly 0.  The ``*_counts`` cases pass the
#: layout's ``group_sizes`` to K5 and K6 and make the pad rows of x and dy
#: random instead of zero, so that a kernel that ignored the counts would
#: show: the rows past each expert's count must be exactly 0 in y and dx,
#: and the live rows are held as above.  (Their absent expert is not the
#: last one, which owns the layout's tail tiles and so their random rows.)
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
    ("bf16_ragged_absent_bm256", dict(
        g=1000, k=2, e=6, d=200, f=392, bm=256, dtype=torch.bfloat16,
        heavy=1, absent=2)),
    ("flagship_bf16_d1024_f4096_counts", dict(
        g=8192, k=2, e=8, d=1024, f=4096, bm=256, dtype=torch.bfloat16,
        heavy=0, absent=6, counts=True)),
    ("flagship_bf16_f4096_d1024_counts", dict(
        g=8192, k=2, e=8, d=4096, f=1024, bm=256, dtype=torch.bfloat16,
        heavy=3, absent=5, counts=True)),
    ("bf16_ragged_absent_bm128_counts", dict(
        g=1000, k=2, e=6, d=200, f=392, bm=128, dtype=torch.bfloat16,
        heavy=1, absent=2, counts=True)),
    ("f32_ragged_absent_bm256_counts", dict(
        g=1000, k=2, e=6, d=200, f=392, bm=256, dtype=torch.float32,
        heavy=1, absent=2, counts=True)),
    ("bf16_decode_g4_counts", dict(
        g=4, k=2, e=8, d=1024, f=4096, bm=256, dtype=torch.bfloat16,
        heavy=0, absent=6, counts=True)),
]
GMM_KERNELS = ("gmm", "gmm_dxt", "tgmm")


def make_gmm_case(gen, *, g, k, e, d, f, bm, dtype, heavy=0, absent=None,
                  skew=2.0, counts=False):
    """A dropless layout from a router that favours expert ``heavy`` and
    never picks ``absent``; tokens ``[G, D]`` gathered into it, expert
    weights ``[E, D, F]``, and an upstream gradient ``[NP, F]`` that is 0
    on pad rows, as the backward hands it over.  ``sizes`` holds each
    expert's routed rows.  With ``counts``, K5 and K6 get them as
    ``group_sizes``, and the pad rows of x and dy are random."""
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
    dy = torch.randn((x.shape[0], f), generator=gen, device="cuda")
    if not counts:
        dy = dy * live
    w = torch.randn((e, d, f), generator=gen, device="cuda") * d ** -0.5
    if counts:
        x = x + (torch.randn(x.shape, generator=gen, device="cuda")
                 * (1 - live)).to(dtype)
    sizes = moe.expert_counts(experts, e).to(torch.int32)
    return dict(x=x, w=w.to(dtype), dy=dy.to(dtype), te=layout.tile_expert,
                bm=bm, e=e, routed=g * k, absent=absent, sizes=sizes,
                group_sizes=sizes if counts else None)


def gmm_outputs(c):
    """Each kernel's output and its plain version's on one case."""
    from tensorflowonspark_tpu_torch.ops import gmm

    x, w, dy, te, bm, e, gs = (c[n] for n in ("x", "w", "dy", "te", "bm", "e",
                                               "group_sizes"))
    got = dict(gmm=gmm.gmm_call(x, w, te, bm=bm, group_sizes=gs),
               gmm_dxt=gmm.gmm_dxt_call(dy, w, te, bm=bm, group_sizes=gs),
               tgmm=gmm.tgmm_call(x, dy, te, e, bm=bm))
    torch.cuda.synchronize()
    ref = dict(gmm=gmm.gmm_plain(x, w, te, bm=bm, group_sizes=gs),
               gmm_dxt=gmm.gmm_dxt_plain(dy, w, te, bm=bm, group_sizes=gs),
               tgmm=gmm.tgmm_plain(x, dy, te, e, bm=bm))
    return got, ref


def gmm_dead_rows(c, got):
    """Largest ``|y|`` and ``|dx|`` over the rows past their expert's
    count when the case passes ``group_sizes`` (0.0 when it does not):
    the kernels must write those rows as exact zeros."""
    from tensorflowonspark_tpu_torch.ops import gmm

    if c["group_sizes"] is None:
        return 0.0
    dead = ~gmm.live_row_mask(c["te"], c["group_sizes"], c["bm"])[:, 0]
    return max(got[n][dead].float().abs().max().item()
               for n in ("gmm", "gmm_dxt"))


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
    """``(name, dtype, errors, absent expert's max |dW|, max |y|, |dx| on
    the rows past the counts)`` for each of :data:`GMM_CASES`, inputs
    drawn on the card from one seed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for name, spec in GMM_CASES:
        c = make_gmm_case(gen, **spec)
        got, ref = gmm_outputs(c)
        absent = got["tgmm"][c["absent"]].float().abs().max().item()
        yield (name, spec["dtype"], gmm_errors(got, ref, spec["dtype"]),
               absent, gmm_dead_rows(c, got))


def gmm_case_ok(errs, absent_dw, dead_rows):
    return (all(c <= t for _, c, t in errs.values()) and absent_dw == 0.0
            and dead_rows == 0.0)


def phase_gmm_cases():
    for name, dtype, errs, absent_dw, dead_rows in gmm_case_results():
        ok = gmm_case_ok(errs, absent_dw, dead_rows)
        emit("gmm_case", case=name, dtype=str(dtype),
             max_abs_err={n: e for n, (e, _, _) in errs.items()},
             checked_err={n: c for n, (_, c, _) in errs.items()},
             tol={n: t for n, (_, _, t) in errs.items()},
             absent_expert_max_abs_dw=absent_dw,
             rows_past_counts_max_abs=dead_rows, ok=ok)
        if not ok:
            raise AssertionError(
                "gmm case {0}: {1}, absent expert dW {2}, rows past the "
                "counts {3}".format(name, errs, absent_dw, dead_rows))


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


#: the bf16 K5/K6 timing geometries, ``w [E, D, F]``: the MoE flagship's
#: ``wi``/``wg`` (D=1024 -> F=4096) and ``wo`` (4096 -> 1024)
GMM_GEOMETRIES = {"wi": (1024, 4096), "wo": (4096, 1024)}
#: the bf16 kernel each grouped-matmul entry runs
GMM_WGMMA = {"gmm": "gmm_rows_wgmma<kFwd>", "gmm_dxt": "gmm_rows_wgmma<kDxt>",
             "tgmm": "tgmm_wgmma"}


def gmm_bound(c):
    """``(bound ms, bound_by, bytes, flops)`` of one grouped-matmul call on
    case ``c``: the routed rows only (NP adds each run's padding and the
    tail tiles), each operand read once, each output written once, the
    weights of the experts that got a row."""
    d, f = c["w"].shape[1:]
    routed = c["routed"]
    present = int((c["sizes"] > 0).sum().item())
    flops = 2 * routed * d * f
    nbytes = c["w"].element_size() * (routed * d + present * d * f
                                      + routed * f)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
    ops_ms = 1e3 * flops / BF16_FLOPS_PER_SEC
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def phase_gmm_timing():
    """K5, K6 and K7 at the MoE flagship's training shape (8192 tokens,
    top-2 of 8 experts, D=1024, F=4096, bf16) as its training step calls
    them (K5 and K6 with the layout's counts), beside their plain
    versions, the bound over the routed rows and the library yardstick;
    then K5 and K6 with and without the counts in both geometries on the
    balanced and the skewed layouts (:func:`rows_wgmma_timing`), K7 on the
    skewed layout, and K5 at a decode step (:func:`gmm_decode_timing`)."""
    from tensorflowonspark_tpu_torch.ops import gmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    c = make_gmm_case(gen, g=8192, k=2, e=8, d=1024, f=4096, bm=256,
                      dtype=torch.bfloat16, skew=0.0)
    c["group_sizes"] = c["sizes"]
    got, ref = gmm_outputs(c)
    errs = gmm_errors(got, ref, torch.bfloat16)
    if not all(x <= t for _, x, t in errs.values()):
        raise AssertionError("gmm kernels at the flagship shape: {0}".format(
            errs))
    x, w, dy, te, bm, e, gs = (c[n] for n in ("x", "w", "dy", "te", "bm",
                                              "e", "group_sizes"))
    runs = {
        "gmm": (lambda _: gmm.gmm_call(x, w, te, bm=bm, group_sizes=gs),
                lambda _: gmm.gmm_plain(x, w, te, bm=bm, group_sizes=gs)),
        "gmm_dxt": (lambda _: gmm.gmm_dxt_call(dy, w, te, bm=bm,
                                               group_sizes=gs),
                    lambda _: gmm.gmm_dxt_plain(dy, w, te, bm=bm,
                                                group_sizes=gs)),
        "tgmm": (lambda _: gmm.tgmm_call(x, dy, te, e, bm=bm),
                 lambda _: gmm.tgmm_plain(x, dy, te, e, bm=bm)),
    }
    library, note = gmm_library(c)
    n_rows, d = x.shape
    f = w.shape[2]
    bound_ms, bound_by, nbytes, flops = gmm_bound(c)
    routed = c["routed"]
    res = {}
    for name, (kernel, plain) in runs.items():
        ms = time_ms(kernel, [None], reps=20, warmup=3)
        res[name] = dict(
            ms=ms, plain_ms=time_ms(plain, [None], reps=3, warmup=1),
            library_ms=time_ms(library[name], [None], reps=20, warmup=3),
            library_note=note, bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, flops=flops, flops_over_np=2 * n_rows * d * f,
            tflops=flops / ms / 1e9, max_abs_err=errs[name][0],
            kernel=GMM_WGMMA[name], group_sizes=name != "tgmm",
        )
    del c, got, ref, x, w, dy, runs, library
    res["rows_wgmma"] = rows_wgmma_timing(gen)
    res["tgmm_skewed"] = tgmm_skewed_timing(gen)
    res["gmm_decode"] = gmm_decode_timing(gen)
    emit("gmm_timing", shape=dict(tokens=8192, k=2, E=8, D=d, F=f, bm=bm,
                                  routed_rows=routed, NP=n_rows,
                                  dtype="bfloat16"), **res)
    return res


def rows_wgmma_timing(gen):
    """K5 and K6 (``gmm_rows_wgmma``) at the training shape with and
    without the counts, in both :data:`GMM_GEOMETRIES`, on the balanced
    layout and on the skewed one (expert 0's logits raised by 2), each
    beside its library call and its bound; every output is held to the
    plain version under :data:`GMM_TOL`."""
    from tensorflowonspark_tpu_torch.ops import gmm

    out = {}
    for layout, skew in (("balanced", 0.0), ("skewed", 2.0)):
        for geo, (d, f) in GMM_GEOMETRIES.items():
            c = make_gmm_case(gen, g=8192, k=2, e=8, d=d, f=f, bm=256,
                              dtype=torch.bfloat16, skew=skew)
            x, w, dy, te, bm, gs = (c[n] for n in ("x", "w", "dy", "te",
                                                   "bm", "sizes"))
            library, _ = gmm_library(c)
            bound_ms, bound_by, _, flops = gmm_bound(c)
            calls = {
                "gmm": (lambda s: gmm.gmm_call(x, w, te, bm=bm,
                                               group_sizes=s),
                        lambda: gmm.gmm_plain(x, w, te, bm=bm)),
                "gmm_dxt": (lambda s: gmm.gmm_dxt_call(dy, w, te, bm=bm,
                                                       group_sizes=s),
                            lambda: gmm.gmm_dxt_plain(dy, w, te, bm=bm)),
            }
            for name, (call, plain) in calls.items():
                ref = plain().float()
                checked = max(row_relative_error(call(s).float(), ref)
                              for s in (gs, None))
                if not checked <= GMM_TOL["bf16_row_rel"]:
                    raise AssertionError("{0} {1} {2}: {3}".format(
                        name, geo, layout, checked))
                ms = time_ms(lambda _: call(gs), [None], reps=20, warmup=3)
                ms_all = time_ms(lambda _: call(None), [None], reps=20,
                                 warmup=3)
                out["{0}_{1}_{2}".format(name, geo, layout)] = dict(
                    ms=ms, ms_all_rows=ms_all,
                    library_ms=time_ms(library[name], [None], reps=20,
                                       warmup=3),
                    bound_ms=bound_ms, bound_by=bound_by,
                    tflops=flops / ms / 1e9,
                    tflops_all_rows=flops / ms_all / 1e9,
                    checked_err=checked, D=d, F=f, skew=skew,
                    expert_rows=c["sizes"].tolist())
            del c, x, w, dy, calls, library
    return out


def gmm_decode_timing(gen):
    """K5 at a decode step of ``moe_train_to_serve``: 4 tokens, top-2 of 8
    experts, 8 routed rows in NP = 2,304, D=1024 -> F=4096, bf16, with and
    without the counts, beside ``torch._grouped_mm`` and the bound.  The
    calls alternate between two copies of the weights (128 MB, more than
    the L2 cache), so each reads them cold, as a layer does in a decode
    step.  ``ms`` is CUDA events around back-to-back calls (what the
    eager decode loop pays, host included), ``device_ms`` the profiler's
    kernel time."""
    from tensorflowonspark_tpu_torch.ops import gmm

    c = make_gmm_case(gen, g=4, k=2, e=8, d=1024, f=4096, bm=256,
                      dtype=torch.bfloat16, skew=0.0)
    x, w, te, bm, gs = (c[n] for n in ("x", "w", "te", "bm", "sizes"))
    ref = gmm.gmm_plain(x, w, te, bm=bm).float()
    checked = max(row_relative_error(
        gmm.gmm_call(x, w, te, bm=bm, group_sizes=s).float(), ref)
        for s in (gs, None))
    if not checked <= GMM_TOL["bf16_row_rel"]:
        raise AssertionError("gmm at the decode shape: {0}".format(checked))
    ws = [w, w.clone()]
    ms = time_ms(lambda ww: gmm.gmm_call(x, ww, te, bm=bm, group_sizes=gs),
                 ws, reps=50, warmup=6)
    ms_all = time_ms(lambda ww: gmm.gmm_call(x, ww, te, bm=bm), ws, reps=50,
                     warmup=6)
    dev = device_ms(lambda ww: gmm.gmm_call(x, ww, te, bm=bm,
                                            group_sizes=gs), ws)
    dev_all = device_ms(lambda ww: gmm.gmm_call(x, ww, te, bm=bm), ws)
    library_ms = library_device_ms = None
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(torch.bincount(te.long(), minlength=c["e"])
                            * bm, 0).to(torch.int32)
        library_ms = time_ms(
            lambda ww: torch._grouped_mm(x, ww, offs=offs), ws, reps=50,
            warmup=6)
        library_device_ms = device_ms(
            lambda ww: torch._grouped_mm(x, ww, offs=offs), ws)
    bound_ms, bound_by, nbytes, flops = gmm_bound(c)
    return dict(ms=ms, ms_all_rows=ms_all, device_ms=dev,
                device_ms_all_rows=dev_all,
                library_device_ms=library_device_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops, NP=x.shape[0], routed_rows=c["routed"],
                expert_rows=c["sizes"].tolist(), checked_err=checked)


def tgmm_skewed_timing(gen):
    """K7 and its library call at the same shape on a skewed layout: the
    ``gmm_case`` router with expert 0's logits raised by 2, so the runs
    differ several-fold in length."""
    from tensorflowonspark_tpu_torch.ops import gmm

    c = make_gmm_case(gen, g=8192, k=2, e=8, d=1024, f=4096, bm=256,
                      dtype=torch.bfloat16, skew=2.0)
    x, dy, te, bm, e = (c[n] for n in ("x", "dy", "te", "bm", "e"))
    got = gmm.tgmm_call(x, dy, te, e, bm=bm)
    torch.cuda.synchronize()
    ref = gmm.tgmm_plain(x, dy, te, e, bm=bm)
    checked = row_relative_error(got.float(), ref.float())
    if not checked <= GMM_TOL["bf16_row_rel"]:
        raise AssertionError("tgmm on the skewed layout: {0}".format(checked))
    d, f = x.shape[1], dy.shape[1]
    rows = (torch.bincount(te.long(), minlength=e) * bm).tolist()
    flops = 2 * c["routed"] * d * f
    present = sum(1 for r in rows if r)
    nbytes = 2 * (c["routed"] * d + present * d * f + c["routed"] * f)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
    ops_ms = 1e3 * flops / BF16_FLOPS_PER_SEC
    ms = time_ms(lambda _: gmm.tgmm_call(x, dy, te, e, bm=bm), [None],
                 reps=20, warmup=3)
    library, _ = gmm_library(c)
    return dict(
        ms=ms, library_ms=time_ms(library["tgmm"], [None], reps=20,
                                  warmup=3),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        tflops=flops / ms / 1e9, expert_rows=rows,
        max_abs_err=(got.float() - ref.float()).abs().max().item(),
        checked_err=checked, skew=2.0,
    )


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


#: the fed losses against ``train_flagship``'s, relative: the same
#: weights, kernels and batches run in the same order, so they agree to
#: the bit (0 in every run so far); within the first epoch the losses of
#: different batches differ by ~1e-3, so a feeder that swapped or
#: repeated rows or batches fails this
FEED_LOSS_RTOL = 1e-6


def card_uuid(device=0):
    """The UUID of a CUDA device as ``nvidia-smi`` prints it, lower-case
    and without the ``GPU-`` prefix."""
    return _bare_uuid(str(torch.cuda.get_device_properties(device).uuid))


def _bare_uuid(uuid):
    uuid = uuid.lower()
    return uuid[4:] if uuid.startswith("gpu-") else uuid


def feed_train_fn(args, ctx):
    """The user fn of ``feed_train_flagship``, run in the compute
    process: the flagship from the seed-0 tree, trained from the node's
    feed by two ``train_on_feed`` calls; writes ``args["out"]``.

    Neither callback synchronises: a host timestamp in each measures
    the feed wait between groups."""
    t_start = time.perf_counter()
    from tensorflowonspark_tpu_torch import compat, convert, optim
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from tensorflowonspark_tpu_torch.parallel import dp

    device = compat.resolve_device()
    build_s = _build.build(["flash_attention"])["flash_attention"]
    ctx.initialize_distributed()
    feed = ctx.get_data_feed()
    tree = convert.init_params_tree(
        transformer.TransformerConfig(**FLAGSHIP), seed=0)  # as flagship_tree
    cfg = transformer.TransformerConfig(**dict(FLAGSHIP,
                                               attention_impl="flash"))
    model = convert.params_from_flax(tree, cfg, device=device,
                                     param_dtype=torch.float32)
    del tree
    trainer = dp.SyncTrainer(transformer.loss_fn(model), optim.adamw(1e-4))
    state = trainer.create_state(dict(model.named_parameters()))
    losses, marks = [], []
    multi = trainer.multi_step_on_device

    def multi_step_on_device(*a):
        out = multi(*a)
        losses.append(out[1]["loss"])  # a device tensor: no sync
        return out

    trainer.multi_step_on_device = multi_step_on_device
    k, b = args["k"], args["batch"]
    calls = dict(batch_size=b, columnar=True, steps_per_execution=k,
                 step_callback=lambda step: marks.append(
                     ("step", time.perf_counter())),
                 metrics_callback=lambda step, m: marks.append(
                     ("metrics", time.perf_counter())))
    flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    state = trainer.train_on_feed(state, feed, max_steps=k,
                                  terminate_on_max_steps=False, **calls)
    torch.cuda.synchronize()
    first_step = marks[0][1]
    del marks[:]
    t0 = time.perf_counter()
    state = trainer.train_on_feed(state, feed, max_steps=2 * k,
                                  terminate_on_max_steps=False, **calls)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # what terminate_on_max_steps would add at the cap, timed apart: the
    # drain waits out its quiet gap even when nothing is in flight
    t1 = time.perf_counter()
    feed.terminate()
    terminate_sec = time.perf_counter() - t1
    waits, prev = [], t0
    for kind, t in marks:
        if kind == "step":
            waits.append(t - prev)
        else:
            prev = t
    result = dict(
        losses=torch.cat(losses).float().cpu().numpy().tolist(),
        launches=dict(flash_attention.launches), steps=int(state.step),
        timed_steps=2 * k, wall_sec=wall, feed_wait_sec=waits,
        terminate_sec=terminate_sec,
        startup_sec=first_step - t_start, flash_build_sec=build_s,
        cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
        device=torch.cuda.get_device_name(device), uuid=card_uuid(device),
        pid=os.getpid(), wire=feed.wire_stats(),
        peak_memory_bytes=torch.cuda.max_memory_allocated(device),
    )
    with open(args["out"], "w") as f:
        json.dump(result, f)


def feed_fail_fn(args, ctx):
    """A user fn that raises at once (the failure check of
    ``feed_train_flagship``)."""
    raise RuntimeError("injected failure in the user fn")


def feed_cluster(fn, args, rows, epochs):
    """``cluster.run`` over a one-executor ``LocalEngine`` with one GPU,
    ``train`` of
    ``rows`` as one partition, ``shutdown``; the engine is stopped
    whatever happens.  Returns ``(startup_sec, train_sec, error)``, where
    ``error`` is the ``RuntimeError`` that ``train`` or ``shutdown``
    raised (``None`` when neither did)."""
    from tensorflowonspark_tpu_torch.cluster import cluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    engine = LocalEngine(1)
    try:
        t0 = time.perf_counter()
        c = cluster.run(engine, fn, args, num_executors=1,
                        num_chips_per_node=1,
                        input_mode=cluster.InputMode.SPARK,
                        reservation_timeout=120)
        t1 = time.perf_counter()
        error = None
        try:
            c.train([rows], num_epochs=epochs, feed_timeout=600)
        except RuntimeError as e:
            error = e
        t2 = time.perf_counter()
        try:
            c.shutdown(timeout=600)
        except RuntimeError as e:
            error = error or e
        return t1 - t0, t2 - t1, error
    finally:
        engine.stop()


def phase_feed_train_flagship(train):
    """The feed path: see the module docstring, phase 18.  ``train`` is
    :func:`phase_train_flagship`'s result."""
    import gc
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch.cluster import gpu_info

    gc.collect()
    torch.cuda.empty_cache()
    free_bytes, total_bytes = torch.cuda.mem_get_info()
    print("feed_train_flagship: {0} of {1} bytes free on the card before "
          "the compute process starts".format(free_bytes, total_bytes),
          flush=True)
    chosen = gpu_info.get_gpus(1, worker_index=0)
    chosen_uuid = [_bare_uuid(g["uuid"]) for g in gpu_info.allocatable_gpus()
                   if g["id"] == chosen[0]][0]
    # the fns by module name, not as __main__'s: the spawned processes
    # import this module under its own name
    smoke = importlib.import_module("chip_smoke")
    rng = np.random.default_rng(7)  # flagship_trainer's tokens, as rows
    tokens = rng.integers(0, FLAGSHIP["vocab_size"],
                          (TRAIN_K, TRAIN_B, TRAIN_S)).astype(np.int32)
    rows = [{"tokens": t} for t in tokens.reshape(-1, TRAIN_S)]
    out = os.path.join(tempfile.mkdtemp(prefix="feed_train_"), "result.json")
    startup, train_sec, error = feed_cluster(
        smoke.feed_train_fn, {"out": out, "k": TRAIN_K, "batch": TRAIN_B},
        rows, epochs=3)
    if error is not None:
        raise error
    if not os.path.exists(out):
        raise AssertionError("the compute process wrote no result")
    with open(out) as f:
        res = json.load(f)
    # the failure path: a fn that raises at once fails the driver
    _, _, failure = feed_cluster(smoke.feed_fail_fn, None, rows[:TRAIN_B],
                                 epochs=1)
    got = np.asarray(res["losses"])
    want = np.asarray(train["losses"])
    rel = (np.abs(got - want) / np.abs(want)).max() if got.shape == \
        want.shape else float("inf")
    steps = res["timed_steps"]
    tokens_per_sec = steps * TRAIN_B * TRAIN_S / res["wall_sec"]
    wait_ms = [1e3 * w for w in res["feed_wait_sec"]]
    line = dict(
        model=train["model"], rows=len(rows), epochs=3,
        steps=len(res["losses"]), timed_steps=steps,
        tokens_per_sec=tokens_per_sec,
        step_ms=1e3 * res["wall_sec"] / steps,
        train_flagship_tokens_per_sec=train["tokens_per_sec"],
        fed_over_stacked=tokens_per_sec / train["tokens_per_sec"],
        feed_wait_ms=wait_ms,
        feed_wait_share=sum(res["feed_wait_sec"]) / res["wall_sec"],
        terminate_sec=res["terminate_sec"],
        startup_sec=res["startup_sec"], cluster_startup_sec=startup,
        train_call_sec=train_sec, flash_build_sec=res["flash_build_sec"],
        losses=res["losses"], max_rel_loss_diff=rel,
        launches=res["launches"], compute_pid=res["pid"],
        driver_pid=os.getpid(),
        cuda_visible_devices=res["cuda_visible_devices"],
        chosen_gpus=chosen, chosen_uuid=chosen_uuid,
        compute_device=res["device"], compute_uuid=res["uuid"],
        peak_memory_bytes=res["peak_memory_bytes"], wire=res["wire"],
        free_bytes_before=free_bytes,
        failure=None if failure is None else next(
            (ln for ln in str(failure).splitlines()
             if re.search(r"executor \d", ln)), str(failure).splitlines()[0]),
        nvidia_smi=nvidia_smi(),
    )
    emit("feed_train_flagship", **line)
    if not rel <= FEED_LOSS_RTOL:
        raise AssertionError("fed losses differ from train_flagship's by "
                             "{0} relative".format(rel))
    want_launches = FLAGSHIP["num_layers"] * len(want)
    if res["launches"] != {n: want_launches for n in ("fwd", "dq", "dkv")}:
        raise AssertionError("fed flash launches {0}, want {1} each".format(
            res["launches"], want_launches))
    if res["pid"] == os.getpid():
        raise AssertionError("the fn ran in the driver process")
    if (res["cuda_visible_devices"] != ",".join(map(str, chosen))
            or res["uuid"] != chosen_uuid):
        raise AssertionError("compute process on {0} (visible {1}), "
                             "gpu_info chose {2} ({3})".format(
                                 res["uuid"], res["cuda_visible_devices"],
                                 chosen, chosen_uuid))
    if failure is None or "executor 0" not in str(failure) \
            or "injected failure" not in str(failure):
        raise AssertionError("a raising user fn did not fail the driver "
                             "naming the executor: {0!r}".format(failure))
    return line


def global_stop_fn(args, ctx):
    """The user fn of :func:`phase_feed_global_stop`: a linear model
    trained from the node's feed under ``torch.distributed``, then one
    all-reduce over the default group; writes ``rank<r>.json``."""
    from tensorflowonspark_tpu_torch import compat, optim
    from tensorflowonspark_tpu_torch.parallel import dp

    dist = ctx.initialize_distributed()
    device = compat.resolve_device()
    model = torch.nn.Linear(4, 1).to(device)

    def loss_fn(params, batch, rng):
        x, y = batch
        return torch.mean((x @ params["weight"].T + params["bias"] - y) ** 2)

    trainer = dp.SyncTrainer(loss_fn, optim.sgd(0.1))
    state = trainer.create_state(dict(model.named_parameters()))
    state = trainer.train_on_feed(state, ctx.get_data_feed(), batch_size=4,
                                  columnar=True)
    rank = torch.full((1,), float(dist.get_rank() + 1), device=device)
    dist.all_reduce(rank)
    out = dict(rank=dist.get_rank(), world=dist.get_world_size(),
               backend=dist.get_backend(), steps=int(state.step),
               all_reduce=rank.item(),
               cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
               uuid=card_uuid(device))
    dist.destroy_process_group()
    with open(os.path.join(args["out"], "rank%d.json" % out["rank"]),
              "w") as f:
        json.dump(out, f)


def phase_feed_global_stop(n=4):
    """Not run by :func:`main`: ``n`` executors, one GPU each by
    host-local rank, ``initialize_distributed`` (NCCL with a ``gloo``
    flag group), executor ``i`` fed ``3 + i`` batches; every rank must
    stop after 3 steps (the global stop), the all-reduce must sum the
    ranks, and each rank must hold the card that ``gpu_info`` gave its
    executor."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch.cluster import cluster, gpu_info
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    smoke = importlib.import_module("chip_smoke")
    pool = {_bare_uuid(g["uuid"]): str(g["id"])
            for g in gpu_info.allocatable_gpus()}
    gen = np.random.default_rng(0)
    parts = [[(gen.standard_normal(4).astype(np.float32),
               gen.standard_normal(1).astype(np.float32))
              for _ in range(4 * (3 + i))] for i in range(n)]
    out = tempfile.mkdtemp(prefix="global_stop_")
    engine = LocalEngine(n, deterministic=True)
    try:
        t0 = time.perf_counter()
        c = cluster.run(engine, smoke.global_stop_fn, {"out": out},
                        num_executors=n, num_chips_per_node=1,
                        reservation_timeout=120)
        c.train(parts, feed_timeout=300)
        c.shutdown(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    ranks = []
    for r in range(n):
        with open(os.path.join(out, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    emit("feed_global_stop", executors=n, wall_sec=wall, ranks=ranks)
    if [r["steps"] for r in ranks] != [3] * n:
        raise AssertionError("ranks stopped at different steps")
    if {r["all_reduce"] for r in ranks} != {n * (n + 1) / 2.0}:
        raise AssertionError("the all-reduce did not sum the ranks")
    if len({r["uuid"] for r in ranks}) != n or any(
            pool.get(r["uuid"]) != r["cuda_visible_devices"] for r in ranks):
        raise AssertionError("the ranks do not hold one distinct card "
                             "each, the one gpu_info chose: {0}".format(pool))
    return ranks


def kernel_entry(name, kernel, replaces, launches, timing,
                 source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
                 **extra):
    """One entry of the ``kernels`` line; ``kernel`` names the CUDA
    function that ran at the timing shape."""
    return dict(
        name=name, kernel=kernel, route="cuda", source=source,
        replaces=replaces, launches=launches,
        max_abs_err=timing["max_abs_err"], ms=timing["ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
        library_note=timing["library_note"], **extra
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
    phase_paged_repeat()
    timing = phase_kernel_timing()
    tree, init_s = flagship_tree()
    flagship = phase_slice_flagship(tree, init_s)
    phase_kernel_vs_gather()
    phase_flash_cases()
    phase_flash_repeat()
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
    fed = phase_feed_train_flagship(train)
    jax_flash = "tensorflowonspark_tpu/ops/flash_attention.py:"
    jax_gmm = "tensorflowonspark_tpu/ops/gmm.py:"
    print(json.dumps({"kernels": [dict(
        name="paged_attention", kernel="paged_decode_split+paged_combine",
        route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        replaces="tensorflowonspark_tpu/ops/paged_attention.py:143",
        launches=flagship["paged_attention_launches"],
        max_abs_err=timing["max_abs_err"], ms=timing["kernel_ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
        library_note="gather_pool of K and V, then "
                     "scaled_dot_product_attention with the length mask",
    )] + [
        kernel_entry("flash_" + name, kernel, jax_flash + line,
                     train["launches"][name], flash[name],
                     fed_launches=fed["launches"][name])
        for name, kernel, line in (("fwd", "flash_fwd_wgmma", "132"),
                                   ("dq", "flash_dq_wgmma", "198"),
                                   ("dkv", "flash_dkv_wgmma", "256"))
    ] + [
        kernel_entry(name, GMM_WGMMA[name], jax_gmm + line,
                     moe["launches"][name], gmm_timing[name], source=GMM_SRC)
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
