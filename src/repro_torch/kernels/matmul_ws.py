"""Bias-preloaded GEMM as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``repro.kernels.matmul_ws.matmul_ws``:
``[M,K] @ [K,N] + bias`` with int8 × int8 → int32, f32 → f32 (no TF32), or
bf16 × bf16 → bf16 (f32 products and sums plus an f32 bias, rounded once:
what the reference's ``ops.matmul_ws`` returns).  The CUDA source,
``csrc/matmul_ws.cu``, holds three forms (its note says what bounds each on
the H100); ``mm_path`` picks one by geometry alone, and none falls back to
another:

* ``"wgmma"`` — bf16 at M > ``SHORT_M``, K and N multiples of 8: the
  prefill GEMMs.  128 × 128 or 128 × 256 output tiles (``wgmma_bn``) on the
  bf16 tensor cores, fed by TMA through a 4-stage ring; bound by
  operations.
* ``"stream"`` — bf16 or int8 at M ≤ ``SHORT_M``, N a multiple of 8 (and K
  too for bf16): decode and the dense heads.  w is read once in wide
  vectors, with K split over blocks where the columns alone would not fill
  the card (``stream_plan``); bound by the bytes of w.
* ``"scalar"`` — the first port's 64×64-tile kernel: f32, int8 at long M,
  and bf16 whose rows are not 16-byte multiples (K or N not a multiple of
  8), which TMA cannot address.

``matmul_ws`` calls the ``torch.library`` op ``repro_torch::matmul_ws``,
so a dispatch mode (the roofline's counter, a fake tensor, a selective
checkpoint's policy) sees one op where the kernel runs.  On a CUDA tensor
the op launches the kernel and counts the launch in ``matmul_ws.launches``
and, by form, in ``matmul_ws.path_launches``; on a CPU tensor it runs
``matmul_ws_plain``; on a fake tensor it makes the output's shape and
dtype and launches nothing.  A CPU call that autograd records runs
``matmul_ws_plain`` directly, which autograd differentiates.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.utils.flop_counter

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_ws import SMS
from repro_torch.kernels.ref import matmul_ref, matmul_ref_int8

SHORT_M = 16              # the stream form's rows at most (csrc: MT <= 16)
STREAM_COLS = 256         # columns a stream block covers (csrc: stream::BN)
STREAM_BLOCKS = 4 * SMS   # stream blocks wanted in flight
STREAM_MIN_KC = 256       # K rows a stream block takes at least ...
STREAM_MAX_KC = 512       # ... and at most (its x slice in shared memory)
STREAM_WARPS = 8          # warps a stream block, each every 8th row of K
PATHS = ("wgmma", "stream", "scalar")
_DTYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def _dtype(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_ws needs [M,K] @ [K,N], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"matmul_ws takes int8, float32 or bfloat16 operands "
                        f"of one type, got x {x.dtype}, w {w.dtype}")
    return x.dtype


@functools.lru_cache(maxsize=None)
def mm_path(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The form that runs ``[m,k] @ [k,n]`` in ``dtype`` on the card:
    "wgmma", "stream" or "scalar" (see the module note)."""
    if dtype not in _DTYPES:
        raise TypeError(f"matmul_ws has no kernel for {dtype}")
    if dtype == torch.float32:
        return "scalar"
    if dtype == torch.bfloat16:
        if k % 8 or n % 8:            # rows of x or w not 16-byte multiples
            return "scalar"
        return "stream" if m <= SHORT_M else "wgmma"
    return "stream" if m <= SHORT_M and n % 8 == 0 else "scalar"


def wgmma_bn(m: int, n: int) -> int:
    """The wgmma form's output tile width: 256, unless 128 × 256 tiles
    would fill fewer than half the SMs, where 128 doubles the blocks.  On
    the H100, 256 measured faster at [512..3000, 3072] @ [3072, 8192] and
    [3000, 8192] @ [8192, 3072], and 128 at M = 64 (``PERF.md``)."""
    tiles = -(-m // 128) * -(-n // 256)
    return 256 if tiles >= SMS // 2 else 128


@functools.lru_cache(maxsize=None)
def stream_plan(m: int, k: int, n: int) -> Tuple[int, int]:
    """(split, kc) of the stream form: K in ``split`` slices of ``kc`` rows
    (a multiple of 32, the block's 8 warps times 4 rows in flight), as many
    as bring ``STREAM_BLOCKS`` blocks without a slice under
    ``STREAM_MIN_KC`` or over ``STREAM_MAX_KC`` rows."""
    del m
    col_blocks = -(-n // STREAM_COLS)
    split = min(-(-STREAM_BLOCKS // col_blocks), -(-k // STREAM_MIN_KC))
    split = max(split, -(-k // STREAM_MAX_KC), 1)
    rows = -(-k // split)
    kc = -(-rows // 32) * 32
    return -(-k // kc), kc


def matmul_ws_stream_emulate(x, w, bias=None) -> torch.Tensor:
    """The stream form's arithmetic, replayed in PyTorch on any device:
    K in ``stream_plan``'s slices of ``kc`` rows; in each slice warp ``g``
    sums rows g, g + 8, g + 16, ... in order from 0 (exact bf16 products in
    f32, or int32); the eight warps' sums meet in warp order, onto the bias
    where K is not split; with a split, each slice's sum is a partial, and
    the reduce adds bias and partials in slice order; bf16 rounds once.
    The same rounding steps in the same order as ``csrc/matmul_ws.cu``'s
    ``mm_stream_kernel`` and ``mm_split_reduce_kernel``."""
    dt = _dtype(x, w)
    (m, k), n = x.shape, w.shape[1]
    if mm_path(m, k, n, dt) != "stream":
        raise ValueError(f"[{m},{k}]@[{k},{n}] {dt} runs the "
                         f"{mm_path(m, k, n, dt)} form, not the stream form")
    split, kc = stream_plan(m, k, n)
    acc_dt = torch.int32 if dt == torch.int8 else torch.float32
    steps = kc // STREAM_WARPS
    xp = x.new_zeros((m, split * kc), dtype=acc_dt)
    xp[:, :k] = x.to(acc_dt)
    wp = w.new_zeros((split * kc, n), dtype=acc_dt)
    wp[:k] = w.to(acc_dt)
    # row s·kc + STREAM_WARPS·t + g of K: slice s, step t, warp g
    xs = xp.reshape(m, split, steps, STREAM_WARPS).permute(2, 1, 3, 0)
    ws = wp.reshape(split, steps, STREAM_WARPS, n).permute(1, 0, 2, 3)
    acc = x.new_zeros((split, STREAM_WARPS, m, n), dtype=acc_dt)
    for t in range(steps):                  # [s, g, m, 1] · [s, g, 1, n]
        acc += xs[t].unsqueeze(-1) * ws[t].unsqueeze(-2)
    b = (x.new_zeros((n,), dtype=acc_dt) if bias is None
         else bias.to(device=x.device, dtype=acc_dt))
    if split == 1:
        out = b.expand(m, n).clone()
        for g in range(STREAM_WARPS):
            out += acc[0, g]
    else:
        part = acc[:, 0].clone()
        for g in range(1, STREAM_WARPS):
            part += acc[:, g]
        out = b.expand(m, n).clone()
        for s in range(split):
            out += part[s]
    return out if dt == torch.int8 else out.to(dt)


def matmul_ws_plain(x, w, bias=None) -> torch.Tensor:
    """Plain PyTorch version: exact int32 for int8 operands; f32 for f32;
    for bf16 the f32 product of the upcast operands (exact products, f32
    sums) plus the bias, rounded once to bf16.  TF32 stays as the caller
    set it (off by default for matmuls on the card)."""
    dt = _dtype(x, w)
    if dt == torch.int8:
        return matmul_ref_int8(x, w, bias)
    out = matmul_ref(x, w, bias)
    return out if dt == torch.float32 else out.to(dt)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library, built on first use, with its entries' C
    signatures set once."""
    lib = _build.load("matmul_ws")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.matmul_ws_scalar, [ptr] * 4 + [i32] * 4),
                     (lib.matmul_ws_stream, [ptr] * 5 + [i32] * 6),
                     (lib.matmul_ws_wgmma, [ptr] * 4 + [i32] * 4)):
        fn.argtypes = args + [ptr]
        fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (TMA and the stream
    form's vector loads); copies only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w, bias, path: str) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    dt = x.dtype
    x, w = _aligned(x), _aligned(w)
    if bias is not None:          # none: a null pointer, no zeros made
        acc = torch.int32 if dt == torch.int8 else torch.float32
        bias = bias.to(device=x.device, dtype=acc).contiguous()
    out = torch.empty((m, n), dtype=torch.int32 if dt == torch.int8 else dt,
                      device=x.device)
    lib = _library()
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # about 10 us of host time a call on the H100's host
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    args = (x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr())
    if path == "wgmma":
        code = lib.matmul_ws_wgmma(*args, m, n, k, wgmma_bn(m, n), stream)
    elif path == "stream":
        split, kc = stream_plan(m, k, n)
        part = (torch.empty((split, m, n), dtype=out.dtype if dt == torch.int8
                            else torch.float32, device=x.device)
                if split > 1 else None)
        code = lib.matmul_ws_stream(
            *args, None if part is None else part.data_ptr(), m, n, k,
            kc, split, _DTYPES[dt], stream)
    else:
        code = lib.matmul_ws_scalar(*args, m, n, k, _DTYPES[dt], stream)
    _build.check("matmul_ws", code)
    return out


def _out_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.int32 if dt == torch.int8 else dt


def _cuda_impl(x, w, bias=None):
    path = mm_path(x.shape[0], x.shape[1], w.shape[1], x.dtype)
    out = _launch(x, w, bias, path)
    matmul_ws.launches += 1
    matmul_ws.path_launches[path] += 1
    return out


def _fake_impl(x, w, bias=None):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=_out_dtype(x.dtype))


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("matmul_ws(Tensor x, Tensor w, Tensor? bias=None) -> Tensor")
_LIB.impl("matmul_ws", matmul_ws_plain, "CPU")
_LIB.impl("matmul_ws", _cuda_impl, "CUDA")
torch.library.register_fake("repro_torch::matmul_ws", _fake_impl, lib=_LIB)
_OP = torch.ops.repro_torch.matmul_ws.default


@torch.utils.flop_counter.register_flop_formula(
    torch.ops.repro_torch.matmul_ws)
def _flops(x_shape, w_shape, *args, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * w_shape[1]


def matmul_ws(x, w, bias=None) -> torch.Tensor:
    """x: [M,K] @ w: [K,N] (+bias [N]) → [M,N]: int32 for int8 operands,
    else the operands' dtype (f32 or bf16).  A CUDA tensor launches the
    form ``mm_path`` names, a CPU tensor runs the plain version (see the
    module note)."""
    _dtype(x, w)
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        raise TypeError(f"the matmul_ws kernel takes plain tensors, got "
                        f"{type(x).__name__} @ {type(w).__name__}: call "
                        f"kernels.ops.matmul_ws, which runs a DTensor's "
                        f"local shards")
    if x.device.type == "cpu":
        from repro_torch.kernels.ops import _recorded
        if _recorded(x, w, bias):
            return matmul_ws_plain(x, w, bias)
    elif not x.is_cuda:
        raise ValueError(f"matmul_ws runs on a CUDA or CPU tensor, "
                         f"got {x.device}")
    return _OP(x, w, bias)


matmul_ws.launches = 0
matmul_ws.path_launches = dict.fromkeys(PATHS, 0)
