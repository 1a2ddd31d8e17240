"""The kernel build (stable_renderer_tpu_torch/kernels/_build.py) on the CPU,
with a stand-in for nvcc: the library's name follows the sources and the
headers, and a verbose build gives ptxas's report even when the library is
already built."""

from __future__ import annotations

import shutil
import stat

import pytest

from stable_renderer_tpu_torch.kernels import _build

# writes the file after -o; prints a ptxas line for each source with -Xptxas -v
FAKE_NVCC = """#!/bin/sh
out=""; verbose=0; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    -v) verbose=1 ;;
    *.cu) src="$1" ;;
  esac
  shift
done
: > "$out"
if [ $verbose = 1 ]; then
  echo "ptxas info    : Compiling entry function '_Z13conv3x3_wgmmav' for 'sm_90a' ($src)"
fi
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "ptxas_log", None)
    monkeypatch.setattr(_build, "build_seconds", None)
    return csrc


def test_library_name_follows_sources_and_headers(fake_tree):
    """An edit to a .cu or to a shared .cuh header names a new library, so a
    stale build is never loaded."""
    first = _build.library_path()
    assert first == _build.library_path()
    assert [h.name for h in _build.headers()] == ["hopper.cuh"]
    header = fake_tree / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = _build.library_path()
    assert second != first
    src = fake_tree / "conv3x3.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path() not in (first, second)


def test_verbose_build_reports_even_when_built(fake_tree):
    """build(verbose=True) on a tree whose library exists compiles again for
    ptxas's report, leaves the library as it was and no object behind."""
    out = _build.build()
    assert out.exists() and _build.ptxas_log is None and _build.build_seconds is not None
    before = out.stat().st_mtime_ns
    assert _build.build(verbose=True) == out
    assert out.stat().st_mtime_ns == before
    assert _build.ptxas_log.count("conv3x3_wgmma") == len(_build.sources())
    assert [p.name for p in _build.BUILD_DIR.iterdir()] == [out.name]


def test_serialized_wgmma_lines():
    log = ("ptxas info    : Compiling entry function '_Z13conv3x3_wgmmav' for 'sm_90a'\n"
           "ptxas info    : (C7511) Potential Performance Loss: wgmma.mma_async instructions "
           "are serialized due to insufficient register resources\n"
           "ptxas info    : Used 168 registers\n"
           "ptxas info    : (C7520) something else\n"
           "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async ...\n")
    lines = log.splitlines()
    assert _build.serialized_wgmma(log) == [lines[1], lines[4]]
