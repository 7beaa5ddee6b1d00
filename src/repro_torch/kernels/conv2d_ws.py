"""The paper's IP core as a hand-written Hopper kernel: weight-stationary,
channel-banked, bias-preloaded convolution with the fused ReLU → 2×2
max-pool → requantize epilogue, spatially tiled by the ``TilePlan``.

Replaces the Pallas TPU kernel ``repro.kernels.conv2d_ws.conv2d_ws``.  The
CUDA source is ``csrc/conv2d_ws.cu`` (its note says what bounds it on the
H100 and what the design does about it); this module holds

* ``setup_conv`` / ``ConvGeom`` — the host-side geometry both conv kernels
  share (banking legality, halo math, tile extents, epilogue shapes);
* ``conv2d_ws_plain`` — the plain PyTorch version of the same function;
* ``conv2d_ws`` — the wrapper: on a CUDA tensor it launches the kernel (and
  counts the launch in ``conv2d_ws.launches``), on a CPU tensor it takes
  the plain version.

Zero padding and the trailing tiles' zero extension happen inside the
kernel (exact for the symmetric zero-point-0 int8 scheme), so the padded
map is never materialized.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (check_groups, conv2d_epilogue_ref,
                                     conv_out_shape, dilated_extent,
                                     halo_window, normalize_padding)

SMEM_BYTES = 232_448      # Hopper: dynamic shared memory one block may use
THREADS = 256             # csrc/conv_common.cuh: kConvThreads


class ConvGeom(NamedTuple):
    """Resolved static geometry of one conv layer pass: the fields of the
    reference's ``ConvGeom`` that the CUDA kernels read, plus the input
    extents and the top/left padding they place their windows with (the
    kernels zero-pad in place, so no padded map exists)."""
    n: int
    kh: int
    kw: int
    k: int
    stride: int
    cin_banks: int
    kout_banks: int
    cb: int                   # channels per cin bank (within one group)
    kb: int                   # kernels per kout bank
    cgrp: int                 # channels per group (C // groups)
    bpg: int                  # kout banks per group
    th: int                   # conv-output tile extents (pre-pool)
    tw: int
    n_th: int
    n_tw: int
    in_th: int                # halo'd input window extents
    in_tw: int
    pth: int                  # epilogue output tile extents (post-pool)
    ptw: int
    poh: int                  # whole-map epilogue output extents
    pow_: int
    int_path: bool
    requant: bool
    dilation: int = 1
    h: int = 0                # unpadded input extents and channels
    w: int = 0
    c: int = 0
    pt: int = 0               # top / left zero padding
    pl: int = 0


def setup_conv(x_shape, w_shape, *, stride: int = 1, padding="VALID",
               groups: int = 1, cin_banks: int = 4, kout_banks: int = 4,
               h_tile: int = 0, w_tile: int = 0, pool: bool = False,
               requant: bool = False, dilation: int = 1,
               int_path: bool = True) -> ConvGeom:
    """Validate one conv layer pass and resolve its geometry.  Raises the
    errors the kernels contract with the planner (banking invariant, group
    boundaries, sub-2×2 pooled outputs, pool-aligned tiles)."""
    n, h, w_dim, c = x_shape
    kh, kw, c2, k = w_shape
    check_groups(c, k, groups)
    cgrp = c // groups
    if cgrp != c2:
        raise ValueError(f"weights carry the per-group channel slice: "
                         f"w.shape[2]={c2} must be C/groups={cgrp}")
    if groups > 1 and kout_banks % groups:
        raise ValueError(
            f"grouped conv needs kout banks that split along group "
            f"boundaries: kout_banks={kout_banks} is not a multiple "
            f"of groups={groups} (C={c}, K={k})")
    if cgrp % cin_banks or k % kout_banks:
        raise ValueError(
            f"paper banking invariant (§4.1): C/groups={cgrp} and K={k} "
            f"must divide by the bank counts ({cin_banks}, {kout_banks})")
    (pt, pb), (pl_, pr) = normalize_padding(padding, kh, kw, stride,
                                            h, w_dim, dilation)
    oh, ow = conv_out_shape(h, w_dim, kh, kw, stride, padding, dilation)
    if oh < 1 or ow < 1:
        raise ValueError(
            f"dilated kernel extent "
            f"{dilated_extent(kh, dilation)}×{dilated_extent(kw, dilation)} "
            f"(kernel {kh}×{kw}, dilation={dilation}) exceeds the padded "
            f"input {h + pt + pb}×{w_dim + pl_ + pr}")
    if pool:
        if oh < 2 or ow < 2:
            raise ValueError(
                f"2×2 pool needs a ≥2×2 conv output, got {oh}×{ow}")
        oh, ow = (oh // 2) * 2, (ow // 2) * 2     # floor semantics
    th = oh if h_tile in (0, None) else min(h_tile, oh)
    tw = ow if w_tile in (0, None) else min(w_tile, ow)
    if pool and (th % 2 or tw % 2):
        raise ValueError(f"pool-aligned tiles required: 2×2 windows must "
                         f"not straddle tile edges, got {th}×{tw}")
    n_th, n_tw = -(-oh // th), -(-ow // tw)
    in_th = halo_window(th, stride, kh, dilation)
    in_tw = halo_window(tw, stride, kw, dilation)
    pth, ptw = (th // 2, tw // 2) if pool else (th, tw)
    poh, pow_ = (oh // 2, ow // 2) if pool else (oh, ow)
    return ConvGeom(
        n=n, kh=kh, kw=kw, k=k, stride=stride,
        cin_banks=cin_banks, kout_banks=kout_banks,
        cb=cgrp // cin_banks, kb=k // kout_banks, cgrp=cgrp,
        bpg=kout_banks // groups,
        th=th, tw=tw, n_th=n_th, n_tw=n_tw, in_th=in_th, in_tw=in_tw,
        pth=pth, ptw=ptw, poh=poh, pow_=pow_, int_path=int_path,
        requant=requant,
        dilation=dilation, h=h, w=w_dim, c=c, pt=pt, pl=pl_)


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def smem_bytes(g: ConvGeom, slots: int) -> int:
    """Shared memory one block of a conv kernel uses: the accumulator plus
    ``slots`` copies of the input window and the weight block (1 for
    ``conv2d_ws``, 2 for the ``conv2d_ws_pipe`` ring).  The same total as
    ``SmemLayout`` in ``csrc/conv_common.cuh``."""
    es = 1 if g.int_path else 4
    acc = _align16(g.th * g.tw * g.kb * 4)
    xw = _align16(g.in_th * g.in_tw * g.cb * es)
    ww = _align16(g.kh * g.kw * g.cb * g.kb * es)
    return acc + slots * (xw + ww)


# Field order of ``ConvParams`` in csrc/conv_common.cuh.
_GEOM_FIELDS = ("n", "h", "w", "c", "k", "kh", "kw", "stride", "dilation",
                "pt", "pl", "cin_banks", "cb", "kout_banks", "kb", "cgrp",
                "bpg", "th", "tw", "n_th", "n_tw", "in_th", "in_tw", "pth",
                "ptw", "poh", "pow_")


def _chunk(row_bytes: int, *aligns: int) -> int:
    """Widest cp.async chunk (16, 8 or 4 bytes) dividing a slab row and
    every offset it starts at; 0 → ordinary loads."""
    for v in (16, 8, 4):
        if row_bytes % v == 0 and all(a % v == 0 for a in aligns):
            return v
    return 0


def conv_params(g: ConvGeom, x: torch.Tensor, w: torch.Tensor, relu: bool,
                pool: bool) -> ctypes.Array:
    """The ``ConvParams`` record of one launch, as a C int array."""
    es = x.element_size()
    xvec = _chunk(g.cb * es, g.c * es, g.cgrp * es, x.data_ptr())
    wvec = _chunk(g.kb * es, g.k * es, w.data_ptr())
    vals = [int(getattr(g, f)) for f in _GEOM_FIELDS]
    vals += [int(relu), int(pool), xvec, wvec]
    return (ctypes.c_int * len(vals))(*vals)


def _mode(g: ConvGeom) -> int:
    """Kernel instantiation: 0 int8→int32, 1 int8→int8, 2 f32→f32,
    3 f32→int8."""
    return (0 if g.int_path else 2) + int(g.requant)


def _operands(x, w, bias, out_scale, g: ConvGeom):
    acc_dtype = torch.int32 if g.int_path else torch.float32
    if bias is None:
        bias = torch.zeros((g.k,), dtype=acc_dtype, device=x.device)
    bias = bias.to(device=x.device, dtype=acc_dtype).contiguous()
    scale = torch.broadcast_to(
        torch.as_tensor(1.0 if out_scale is None else out_scale,
                        dtype=torch.float32, device=x.device),
        (g.k,)).contiguous()
    out_dtype = torch.int8 if g.requant else acc_dtype
    return bias, scale, out_dtype


def _check_operands(x: torch.Tensor, w: torch.Tensor) -> bool:
    """int8/int8 → True, f32/f32 → False; anything else is refused."""
    if x.dtype == torch.int8 and w.dtype == torch.int8:
        return True
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return False
    raise TypeError(f"conv kernels take int8 or float32 operands of one "
                    f"type, got x {x.dtype}, w {w.dtype}")


def launch_conv(lib_name: str, slots: int, x, w, bias, out_scale,
                g: ConvGeom, relu: bool, pool: bool) -> torch.Tensor:
    """Launch one of the two conv kernels on PyTorch's current stream."""
    need = smem_bytes(g, slots)
    if need > SMEM_BYTES:
        raise ValueError(
            f"{lib_name}: the tile plan needs {need} bytes of shared memory "
            f"per block, over the {SMEM_BYTES} a Hopper block may use; plan "
            f"the layer with banking.plan_tiles(smem_budget=...)")
    x = x.contiguous()
    w = w.contiguous()
    bias, scale, out_dtype = _operands(x, w, bias, out_scale, g)
    out = torch.empty((g.n, g.poh, g.pow_, g.k), dtype=out_dtype,
                      device=x.device)
    lib = _build.load(lib_name)
    fn = getattr(lib, f"{lib_name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    params = conv_params(g, x, w, relu, pool)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib_name, fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                              scale.data_ptr(), out.data_ptr(), params,
                              len(params), _mode(g), stream))
    return out


def conv2d_ws_plain(x, w, bias=None, out_scale=None, *, stride: int = 1,
                    padding="VALID", groups: int = 1, cin_banks: int = 4,
                    kout_banks: int = 4, h_tile: int = 0, w_tile: int = 0,
                    relu: bool = False, pool: bool = False,
                    dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``conv2d_ws``: the same validation and the
    same result.  The int path does not depend on banking or tiling, and
    the f32 path differs from the kernel only in summation order."""
    int_path = _check_operands(x, w)
    setup_conv(tuple(x.shape), tuple(w.shape), stride=stride,
               padding=padding, groups=groups, cin_banks=cin_banks,
               kout_banks=kout_banks, h_tile=h_tile, w_tile=w_tile,
               pool=pool, requant=out_scale is not None, dilation=dilation,
               int_path=int_path)
    return conv2d_epilogue_ref(x, w, bias, stride=stride, padding=padding,
                               relu=relu, pool=pool, out_scale=out_scale,
                               groups=groups, dilation=dilation)


def run_conv(lib_name: str, slots: int, plain, x, w, bias, out_scale, *,
             relu: bool, pool: bool, **geo) -> Tuple[torch.Tensor, bool]:
    """Shared body of the two conv wrappers → (result, launched): the
    plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return plain(x, w, bias, out_scale, relu=relu, pool=pool, **geo), False
    if not x.is_cuda:
        raise ValueError(f"{lib_name} runs on a CUDA or CPU tensor, "
                         f"got {x.device}")
    g = setup_conv(tuple(x.shape), tuple(w.shape), pool=pool,
                   requant=out_scale is not None,
                   int_path=_check_operands(x, w), **geo)
    return launch_conv(lib_name, slots, x, w, bias, out_scale, g, relu,
                       pool), True


def conv2d_ws(x, w, bias=None, out_scale=None, *, stride: int = 1,
              padding="VALID", groups: int = 1, cin_banks: int = 4,
              kout_banks: int = 4, h_tile: int = 0, w_tile: int = 0,
              relu: bool = False, pool: bool = False,
              dilation: int = 1) -> torch.Tensor:
    """Paper-dataflow convolution: x [N,H,W,C] ⊛ w [KH,KW,C/groups,K]
    (+bias [K]) → [N,OH',OW',K]; int32 out for int8 in, f32 for f32 in, int8
    whenever ``out_scale`` (scalar or [K]) requantizes.  Epilogue order:
    ``relu`` → ``pool`` (2×2/2, floor) → requantize.  ``h_tile``/``w_tile``
    are conv-output tile extents (0 = whole map; pool-aligned when pooling).

    On a CUDA tensor this launches ``csrc/conv2d_ws.cu``; on a CPU tensor it
    runs ``conv2d_ws_plain``."""
    out, launched = run_conv(
        "conv2d_ws", 1, conv2d_ws_plain, x, w, bias, out_scale, relu=relu,
        pool=pool, stride=stride, padding=padding, groups=groups,
        cin_banks=cin_banks, kout_banks=kout_banks, h_tile=h_tile,
        w_tile=w_tile, dilation=dilation)
    if launched:
        conv2d_ws.launches += 1
    return out


conv2d_ws.launches = 0
