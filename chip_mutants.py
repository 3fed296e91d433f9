"""Planted faults in the flash, grouped-matmul and paged-decode kernels,
to show that the checks of ``chip_smoke.py`` catch them.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_mutants.py            # every mutant
    python3 chip_mutants.py diag       # one

Each mutant copies ``chip_smoke.py``, this file and the port's package
into a temporary directory, rewrites a few lines of its kernel source
there (``csrc/flash_attention.cu``, or the source :data:`SOURCES`
names), builds the kernels in that copy and runs the
``chip_smoke.py`` check it names.  ``diag``, ``zero_dq`` and
``tgmm_last_tile`` break the ``mma.sync``-shaped kernels, which run f32
only (K2, K3, K4, K7); ``fwd_wgmma_diag``, ``dq_wgmma_diag``,
``dkv_wgmma_diag``, ``tgmm_wgmma_last_tile``, ``rows_wgmma_fwd_shift``
and ``rows_wgmma_dxt_last_stage`` break the bf16 Hopper kernels
``flash_fwd_wgmma``, ``flash_dq_wgmma``, ``flash_dkv_wgmma``,
``tgmm_wgmma`` and ``gmm_rows_wgmma`` (K5, K6) by a tile or a stage;
``dq_wgmma_diag_key`` (one key of each row masked in the bf16 K3) and
``dkv_wgmma_first_head`` (the bf16 K4 drops every query head of a GQA
group but the first) are smaller faults; ``skip_last_live_tile`` breaks
the skip of the all-pad row tiles that K5 and K6 share in both types.
``paged_split_short``, ``paged_combine_last_split`` and
``paged_mask_last_key`` break the paged-decode kernels (K1): each split
stops one page short, the combine drops the last split, the key at
position ``len - 1`` is masked.
It prints one JSON line per case and one per mutant; the last line
lists the mutants that survived, and the exit code is 0 only when every
mutant was caught.  The repository itself is never modified.
"""

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCE = "tensorflowonspark_tpu_torch/csrc/flash_attention.cu"
GMM_SOURCE = "tensorflowonspark_tpu_torch/csrc/gmm.cu"
PAGED_SOURCE = "tensorflowonspark_tpu_torch/csrc/paged_attention.cu"

#: name -> (what it breaks, [(source text, replacement)], check)
MUTANTS = {
    "diag": (
        "the f32 K2/K3 skip the diagonal key tile and the f32 K4 the "
        "diagonal query tile, for tiles at or past position 512",
        [("hi = a.causal ? q_last / kBN : (a.S - 1) / kBN;",
          "hi = a.causal ? q_last / kBN - (q0 >= 512) : (a.S - 1) / kBN;"),
         ("lo = a.causal ? k0 / kBM : 0;",
          "lo = a.causal ? k0 / kBM + (k0 >= 512) : 0;")],
        "flash_case",
    ),
    "zero_dq": (
        "the f32 K3 (flash_dq_kernel) stores 0 x dQ",
        [("store2(dst + 8 * n + 2 * t, dq[n][2 * r], dq[n][2 * r + 1]);",
          "store2(dst + 8 * n + 2 * t, 0.f * dq[n][2 * r], "
          "0.f * dq[n][2 * r + 1]);")],
        "train_kernel_vs_dot",
    ),
    "tgmm_last_tile": (
        "K7 drops the last row tile of each expert's run",
        [("    k_end = (last + 1) * a.bm;", "    k_end = last * a.bm;")],
        "gmm_case+moe_train_dropless_vs_gather",
    ),
    "fwd_wgmma_diag": (
        "the bf16 K2 (flash_fwd_wgmma) skips its diagonal key tile for q "
        "tiles at or past position 512",
        [("  const int j_hi = a.causal ? q_last / kWgKeys : (a.S - 1) / "
          "kWgKeys;",
          "  const int j_hi = a.causal ? q_last / kWgKeys - (q0 >= 512) : "
          "(a.S - 1) / kWgKeys;")],
        "flash_case",
    ),
    "tgmm_wgmma_last_tile": (
        "the bf16 K7 (tgmm_wgmma) drops each expert's last 64-row stage",
        [("  it.row_end = (last[it.e] + 1) * a.bm;",
          "  it.row_end = (last[it.e] + 1) * a.bm - kTgDepth;")],
        "gmm_case",
    ),
    "rows_wgmma_fwd_shift": (
        "the bf16 K5 (gmm_rows_wgmma<kFwd>) loads each weight box one "
        "8-row group of D late",
        [("&tm_w, bar, n, k0,", "&tm_w, bar, n, k0 + 8,")],
        "gmm_case",
    ),
    "rows_wgmma_dxt_last_stage": (
        "the bf16 K6 (gmm_rows_wgmma<kDxt>) drops the last 64-deep stage "
        "of its reduction over F",
        [(": (a.F + kRwDepth - 1) / kRwDepth;",
          ": (a.F + kRwDepth - 1) / kRwDepth - 1;")],
        "gmm_case",
    ),
    "dq_wgmma_diag": (
        "the bf16 K3 (flash_dq_wgmma) skips its diagonal key tile for q "
        "tiles at or past position 512",
        [("  const int j_hi = a.causal ? q_last / kBwStep : (a.S - 1) / "
          "kBwStep;",
          "  const int j_hi = a.causal ? q_last / kBwStep - (q0 >= 512) : "
          "(a.S - 1) / kBwStep;")],
        "flash_case",
    ),
    "dkv_wgmma_diag": (
        "the bf16 K4 (flash_dkv_wgmma) skips its diagonal q tile for key "
        "tiles at or past position 512",
        [("  const int i_lo = a.causal ? k0 / kBwStep : 0;",
          "  const int i_lo = a.causal ? k0 / kBwStep + (k0 >= 512) : 0;")],
        "flash_case",
    ),
    "dq_wgmma_diag_key": (
        "the bf16 K3 (flash_dq_wgmma) masks the diagonal element itself: "
        "one key of each row",
        [("        if (!visible(row[r], col, a)) p0 = 0.f;\n"
          "        if (!visible(row[r], col + 1, a)) p1 = 0.f;",
          "        if (!visible(row[r], col, a) || col == row[r]) p0 = 0.f;\n"
          "        if (!visible(row[r], col + 1, a) || col + 1 == row[r]) "
          "p1 = 0.f;")],
        "flash_case",
    ),
    "dkv_wgmma_first_head": (
        "the bf16 K4 (flash_dkv_wgmma) sums only the first query head of "
        "each kv head's group",
        [("    if (kw0 >= a.S || (a.causal && q0 + kBwStep - 1 < kw0) ||",
          "    if (it >= nq || kw0 >= a.S || "
          "(a.causal && q0 + kBwStep - 1 < kw0) ||")],
        "flash_case",
    ),
    "skip_last_live_tile": (
        "K5 and K6 (both types) treat an expert's last live 128-row tile "
        "as dead when the counts are passed",
        [("  return live <= 0 ? 0 : min(live, kBM);",
          "  return live < kBM ? 0 : kBM;")],
        "gmm_case+moe_train_dropless_vs_gather",
    ),
    "paged_split_short": (
        "K1 (paged_decode_split): each split stops one page short of its "
        "share",
        [("  const int np = hi - lo;",
          "  const int np = max(hi - lo - 1, 0);")],
        "kernel_case",
    ),
    "paged_combine_last_split": (
        "K1 (paged_combine) drops the last split's partial state",
        [("  const int S = a.splits;", "  const int S = a.splits - 1;")],
        "kernel_case",
    ),
    "paged_mask_last_key": (
        "K1 (paged_decode_split) masks the key at position len - 1, the "
        "query's own",
        [("keep[i] = r < T && pos < len &&",
          "keep[i] = r < T && pos < len - 1 &&")],
        "kernel_case",
    ),
}
#: mutants of another source than :data:`SOURCE`
SOURCES = dict(
    {name: GMM_SOURCE for name in (
        "tgmm_last_tile", "tgmm_wgmma_last_tile", "rows_wgmma_fwd_shift",
        "rows_wgmma_dxt_last_stage", "skip_last_live_tile")},
    **{name: PAGED_SOURCE for name in (
        "paged_split_short", "paged_combine_last_split",
        "paged_mask_last_key")})


def mutate(text, subs):
    """``text`` with each ``(old, new)`` applied; every ``old`` must
    occur exactly once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError("mutation site found {0} times: {1!r}".format(
                text.count(old), old))
        text = text.replace(old, new)
    return text


def check_flash_cases():
    """``flash_case``'s comparison over every case, not stopping at the
    first failure, beside what the first bf16 rule (2% of max|ref|)
    would have allowed.  True when any case fails."""
    import chip_smoke as c

    caught_any = False
    for name, _, errs, ref in c.flash_case_errors():
        caught = not c.flash_ok(errs)
        caught_any |= caught
        old = {n: 0.02 * ref[n].float().abs().max().item() for n in errs}
        print(json.dumps(dict(
            case=name, caught=caught,
            max_abs_err={n: e for n, (e, _, _) in errs.items()},
            checked_err={n: x for n, (_, x, _) in errs.items()},
            tol={n: t for n, (_, _, t) in errs.items()},
            first_bf16_rule_tol=old,
        )), flush=True)
    return caught_any


def check_paged_cases():
    """``kernel_case``'s comparison over every case, not stopping at the
    first failure, beside what the first bf16 rule (2e-2 max abs) would
    have allowed.  True when any case fails."""
    import chip_smoke as c

    caught_any = False
    for name, dtype, (err, checked, tol) in c.paged_case_results():
        caught = not checked <= tol
        caught_any |= caught
        print(json.dumps(dict(
            case=name, caught=caught, max_abs_err=err, checked_err=checked,
            tol=tol, first_bf16_rule_caught=(
                err > 2e-2 if dtype == c.torch.bfloat16 else None),
        )), flush=True)
    return caught_any


def check_train_kernel_vs_dot():
    """True when ``train_kernel_vs_dot`` fails."""
    import chip_smoke as c

    try:
        c.phase_train_kernel_vs_dot()
    except AssertionError:
        return True
    return False


def check_gmm_cases():
    """``gmm_case``'s comparison over every case, not stopping at the
    first failure.  True when any case fails."""
    import chip_smoke as c

    caught_any = False
    for name, _, errs, absent_dw, dead_rows in c.gmm_case_results():
        caught = not c.gmm_case_ok(errs, absent_dw, dead_rows)
        caught_any |= caught
        print(json.dumps(dict(
            case=name, caught=caught,
            max_abs_err={n: e for n, (e, _, _) in errs.items()},
            checked_err={n: x for n, (_, x, _) in errs.items()},
            tol={n: t for n, (_, _, t) in errs.items()},
            absent_expert_max_abs_dw=absent_dw,
            rows_past_counts_max_abs=dead_rows,
        )), flush=True)
    return caught_any


def check_moe_dropless_vs_gather():
    """True when ``moe_train_dropless_vs_gather`` fails."""
    import chip_smoke as c

    try:
        c.phase_moe_dropless_vs_gather()
    except AssertionError:
        return True
    return False


def check_gmm_and_moe_training():
    """Both ``gmm_case`` and ``moe_train_dropless_vs_gather``; True only
    when each of them catches the fault."""
    caught = [check_gmm_cases(), check_moe_dropless_vs_gather()]
    print(json.dumps(dict(gmm_case=caught[0],
                          moe_train_dropless_vs_gather=caught[1])),
          flush=True)
    return all(caught)


CHECKS = {"flash_case": check_flash_cases,
          "kernel_case": check_paged_cases,
          "train_kernel_vs_dot": check_train_kernel_vs_dot,
          "gmm_case": check_gmm_cases,
          "gmm_case+moe_train_dropless_vs_gather": check_gmm_and_moe_training}


def run_in_copy(name):
    """In a copy: plant ``name``, build, run its check.  0 if caught."""
    what, subs, check = MUTANTS[name]
    src = Path(SOURCES.get(name, SOURCE))
    src.write_text(mutate(src.read_text(), subs))
    import chip_smoke as c

    c.phase_env()
    c.phase_build()
    caught = CHECKS[check]()
    print(json.dumps(dict(mutant=name, breaks=what, check=check,
                          caught=caught)), flush=True)
    return 0 if caught else 1


def main(names):
    import torch

    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    unknown = sorted(set(names) - set(MUTANTS))
    if unknown:
        print("chip_mutants: unknown mutants {0}; known: {1}".format(
            unknown, sorted(MUTANTS)), file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    survived = []
    for name in names or list(MUTANTS):
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            for f in ("chip_smoke.py", "chip_mutants.py"):
                shutil.copy2(root / f, copy / f)
            shutil.copytree(
                root / "tensorflowonspark_tpu_torch",
                copy / "tensorflowonspark_tpu_torch",
                ignore=shutil.ignore_patterns("_build", "__pycache__"),
            )
            rc = subprocess.run(
                [sys.executable, "-c", "import sys, chip_mutants; "
                 "sys.exit(chip_mutants.run_in_copy({0!r}))".format(name)],
                cwd=copy, check=False,
            ).returncode
        if rc != 0:
            survived.append(name)
    print(json.dumps(dict(mutants=names or list(MUTANTS),
                          survived=survived)), flush=True)
    return 1 if survived else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
