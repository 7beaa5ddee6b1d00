"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Libraries go to ``build/torch_kernels/`` at the
repository root, keyed by a hash of every source and header in ``csrc/``
and of the flags, and are built at first use; ``build()`` compiles several
sources at once, one ``nvcc`` process each, all started together.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception, because a launch the
card refuses (too much shared memory, a bad configuration) never runs and
``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("conv2d_ws", "conv2d_ws_pipe", "matmul_ws")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that holds the GPU")


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that have no current library, all in
    parallel.  Returns the seconds each build took (0.0 when current);
    the compiler's report (registers, shared memory, spills) is kept
    beside each library as ``.log``."""
    todo = [n for n in names if not library_path(n).exists()]
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    failed = []
    try:
        for name in todo:
            dst = library_path(name)
            tmp = dst.with_suffix(f".tmp{os.getpid()}.so")
            with open(dst.with_suffix(".log"), "w") as log:
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT),
                    tmp, dst, time.perf_counter())
        for name, (proc, tmp, dst, t0) in procs.items():
            rc = proc.wait()
            seconds[name] = time.perf_counter() - t0
            if rc == 0:
                os.replace(tmp, dst)
            else:
                failed.append(f"{name} (nvcc exit {rc}):\n"
                              + dst.with_suffix(".log").read_text())
    finally:
        for proc, *_ in procs.values():      # on error: stop every compiler
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code:
        msg = _libs[name].error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code}: {msg}")
