"""The kernel build's bookkeeping, on the CPU: a library is keyed by its
source, the ``csrc/`` headers that source includes and the compiler
flags, so an edit to a shared header (``hopper.cuh``) rebuilds every
library that includes it and no other."""

import os
import re
import shutil

import pytest

from tensorflowonspark_tpu_torch.ops import _build

INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that :mod:`_build` reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    return copy


@pytest.mark.parametrize("name", ["flash_attention", "gmm"])
def test_library_path_follows_an_included_header(name, csrc_copy):
    assert "hopper.cuh" in _build.sources(name)
    before = _build.library_path(name)
    assert _build.library_path(name) == before
    header = csrc_copy / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


def test_library_path_ignores_headers_it_does_not_include(csrc_copy):
    assert _build.sources("paged_attention") == ["paged_attention.cu"]
    before = _build.library_path("paged_attention")
    header = csrc_copy / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("paged_attention") == before


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_library_path_follows_its_source(name, csrc_copy):
    before = _build.library_path(name)
    src = csrc_copy / _build.KERNELS[name][0]
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(_build.CSRC_DIR) if f.endswith((".cu", ".cuh"))))
def test_every_local_include_names_a_file_of_csrc(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        included = INCLUDE.findall(f.read())
    for header in included:
        assert os.path.isfile(os.path.join(_build.CSRC_DIR, header)), header


def test_every_source_is_built_by_one_library():
    sources = sorted(f for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cu"))
    assert sorted(src for src, _ in _build.KERNELS.values()) == sources


def test_wgmma_kernel_names_are_distinct_and_name_kernels_of_their_source():
    """``chip_smoke.WGMMA_KERNELS`` matches each name as a substring of the
    mangled names in its library, so no name may be a substring of
    another; each names a kernel its library's source defines."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    names = [n for kernels in smoke.WGMMA_KERNELS.values() for n in kernels]
    assert len(names) == len(set(names))
    for a in names:
        for b in names:
            assert a == b or a not in b, (a, b)
    for lib, kernels in smoke.WGMMA_KERNELS.items():
        with open(os.path.join(_build.CSRC_DIR, _build.KERNELS[lib][0])) as f:
            text = f.read()
        for name in kernels:
            assert re.search(r"__global__[^;{]*\b" + name + r"\s*\(", text), name
