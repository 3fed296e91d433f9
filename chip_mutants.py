"""Planted faults in the flash and grouped-matmul kernels, to show that
the checks of ``chip_smoke.py`` catch them.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_mutants.py            # every mutant
    python3 chip_mutants.py diag       # one

Each mutant copies ``chip_smoke.py``, this file and the port's package
into a temporary directory, rewrites a few lines of its kernel source
there (``csrc/flash_attention.cu``, or ``csrc/gmm.cu`` for the mutants
in :data:`SOURCES`), builds the kernels in that copy and runs the
``chip_smoke.py`` check it names.  It prints one JSON line per
case and one per mutant; the last line lists the mutants that survived,
and the exit code is 0 only when every mutant was caught.  The
repository itself is never modified.
"""

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCE = "tensorflowonspark_tpu_torch/csrc/flash_attention.cu"
GMM_SOURCE = "tensorflowonspark_tpu_torch/csrc/gmm.cu"

#: name -> (what it breaks, [(source text, replacement)], check)
MUTANTS = {
    "diag": (
        "K2/K3 skip the diagonal key tile and K4 the diagonal query tile, "
        "for tiles at or past position 512",
        [("hi = a.causal ? q_last / kBN : (a.S - 1) / kBN;",
          "hi = a.causal ? q_last / kBN - (q0 >= 512) : (a.S - 1) / kBN;"),
         ("lo = a.causal ? k0 / kBM : 0;",
          "lo = a.causal ? k0 / kBM + (k0 >= 512) : 0;")],
        "flash_case",
    ),
    "zero_dq": (
        "K3 stores 0 x dQ",
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
}
#: mutants of another source than :data:`SOURCE`
SOURCES = {"tgmm_last_tile": GMM_SOURCE}


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
    for name, _, errs, absent_dw in c.gmm_case_results():
        caught = not c.gmm_case_ok(errs, absent_dw)
        caught_any |= caught
        print(json.dumps(dict(
            case=name, caught=caught,
            max_abs_err={n: e for n, (e, _, _) in errs.items()},
            checked_err={n: x for n, (_, x, _) in errs.items()},
            tol={n: t for n, (_, _, t) in errs.items()},
            absent_expert_max_abs_dw=absent_dw,
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
          "train_kernel_vs_dot": check_train_kernel_vs_dot,
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
