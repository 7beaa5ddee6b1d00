"""Bias-preloaded blocked GEMM as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``repro.kernels.matmul_ws.matmul_ws``:
``[M,K] @ [K,N] + bias`` with int8 × int8 → int32 or f32 → f32 (no TF32).
The CUDA source is ``csrc/matmul_ws.cu`` (64×64 output tiles, the K loop
inside the block, bias preloaded into the accumulators; its note says what
bounds it on the H100).

On a CUDA tensor ``matmul_ws`` launches the kernel and counts the launch in
``matmul_ws.launches``; on a CPU tensor it runs ``matmul_ws_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref, matmul_ref_int8


def _int_path(x: torch.Tensor, w: torch.Tensor) -> bool:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_ws needs [M,K] @ [K,N], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype == torch.int8 and w.dtype == torch.int8:
        return True
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return False
    raise TypeError(f"matmul_ws takes int8 or float32 operands of one type, "
                    f"got x {x.dtype}, w {w.dtype}")


def matmul_ws_plain(x, w, bias=None) -> torch.Tensor:
    """Plain PyTorch version: exact int32 for int8 operands, f32 else."""
    if _int_path(x, w):
        return matmul_ref_int8(x, w, bias)
    return matmul_ref(x, w, bias)


def _launch(x, w, bias, int_path: bool) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    acc_dtype = torch.int32 if int_path else torch.float32
    if bias is None:
        bias = torch.zeros((n,), dtype=acc_dtype, device=x.device)
    bias = bias.to(device=x.device, dtype=acc_dtype).contiguous()
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((m, n), dtype=acc_dtype, device=x.device)
    fn = _build.load("matmul_ws").matmul_ws_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check("matmul_ws", fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), m, n, k,
                                 0 if int_path else 1, stream))
    return out


def matmul_ws(x, w, bias=None) -> torch.Tensor:
    """x: [M,K] @ w: [K,N] (+bias [N]) → [M,N] (int32 for int8 operands,
    f32 for f32).  A CUDA tensor launches the kernel, a CPU tensor runs the
    plain version."""
    int_path = _int_path(x, w)
    if x.device.type == "cpu":
        return matmul_ws_plain(x, w, bias)
    if not x.is_cuda:
        raise ValueError(f"matmul_ws runs on a CUDA or CPU tensor, "
                         f"got {x.device}")
    out = _launch(x, w, bias, int_path)
    matmul_ws.launches += 1
    return out


matmul_ws.launches = 0
