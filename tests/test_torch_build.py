"""The kernel build driver (``repro_torch.kernels._build``) with a stand-in
compiler: sources build in parallel into libraries keyed by a hash of the
sources, a current library is not rebuilt, and a failed compile raises
with the compiler's report.  The real ``nvcc`` runs only where the GPU is
(``test_torch_cuda.py``, ``chip_smoke.py``)."""

import stat

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *.cu) src="$1"; shift;; *) shift;; esac
done
echo "ptxas info    : Used 32 registers ($src)"
case "$src" in *"$FAIL_ON"*) [ -n "$FAIL_ON" ] && exit 2;; esac
echo built > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(nvcc.parent), prepend=":")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("FAIL_ON", raising=False)
    return tmp_path / "build"


def test_builds_every_source_once(fake_nvcc):
    secs = _build.build()
    assert set(secs) == set(_build.SOURCES)
    for name in _build.SOURCES:
        lib = _build.library_path(name)
        assert lib.parent == fake_nvcc and lib.exists()
        assert f"{name}.cu" in _build.build_log(name)
    assert _build.build() == {n: 0.0 for n in _build.SOURCES}


def test_failed_compile_raises_with_the_report(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAIL_ON", "conv2d_ws_pipe")
    with pytest.raises(RuntimeError, match=r"conv2d_ws_pipe \(nvcc exit 2\)"):
        _build.build()
    assert not _build.library_path("conv2d_ws_pipe").exists()
    assert _build.library_path("matmul_ws").exists()
