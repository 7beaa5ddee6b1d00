"""The paper's IP core as a hand-written Hopper kernel: weight-stationary,
channel-banked, bias-preloaded convolution with the fused ReLU → 2×2
max-pool → requantize epilogue.

Replaces the Pallas TPU kernel ``repro.kernels.conv2d_ws.conv2d_ws``.  The
CUDA source is ``csrc/conv2d_ws.cu`` (its note and ``csrc/conv_common.cuh``'s
say what bounds each layer on the H100 and what the design does about it);
this module holds

* ``setup_conv`` / ``ConvGeom`` — the host-side geometry both conv kernels
  share (banking legality, halo math, tile extents, epilogue shapes): the
  contract with the planner, validated on every call;
* ``conv_path`` — the path rule: layers whose per-group output width
  K/groups is at least 8 run an implicit GEMM, int8 on the tensor cores
  ("tc"), f32 on register-tiled FFMA ("simt"); narrower groups of one
  input channel (depthwise) run a channel-vectorised direct conv ("dw"),
  narrower groups of several input channels a direct conv that sums them
  ("nk"), both in int8 and in f32; a geometry no plan takes runs the
  first port's scalar kernel ("scalar");
* ``tc_plan`` / ``pack_weights`` — the tensor-core path's launch plan (block
  rectangles, N-tile, K-chunks, shared-memory layout) and its K-major
  weights; ``conv2d_ws_tc_emulate`` replays that plan in plain PyTorch, block
  by block, for the CPU tests;
* ``simt_plan`` — the f32 path's launch plan (block rectangles, N-tile,
  K-chunks, K split, ring depth); ``conv2d_ws_simt_emulate`` replays its
  order of sums in plain PyTorch for the CPU tests;
* ``dw_plan`` — the dw path's launch plan (block rectangles, channel
  runs, padded row pitches); ``conv2d_ws_dw_emulate`` replays its order of
  sums in plain PyTorch;
* ``nk_plan`` — the nk path's launch plan (block rectangles, runs of
  groups, channel chunks, padded row pitches); ``conv2d_ws_nk_emulate``
  replays its order of sums in plain PyTorch, f32 FFMA rounding included;
* ``conv2d_ws_plain`` — the plain PyTorch version of the same function;
* ``conv2d_ws`` — the wrapper.  It resolves the padding to four ints and
  the requantize scale to a tensor or a float, and calls the
  ``torch.library`` op ``repro_torch::conv2d_ws`` (``define_conv_op``), so
  that a dispatch mode (the roofline's counter, a fake tensor) sees one op
  where the kernel runs.  On a CUDA tensor the op launches the kernel and
  counts the launch in ``conv2d_ws.launches``, and in
  ``conv2d_ws.tc_launches``, ``conv2d_ws.simt_launches``,
  ``conv2d_ws.dw_launches``, ``conv2d_ws.nk_launches`` or
  ``conv2d_ws.scalar_launches`` by path; on a CPU tensor it runs the plain
  version; on a fake tensor it makes the output's shape and dtype and
  launches nothing.  Its FLOP formula is the conv's,
  ``2·N·OH·OW·K·(C/groups)·KH·KW`` before pooling.  A CPU call that
  autograd records runs the plain version directly, which autograd
  differentiates; a CUDA call that autograd records raises (the op has no
  backward: ``ops.conv2d`` differentiates the float conv through its own
  Function, whose forward and backward call the wrapper under no-grad).

Zero padding and the trailing blocks' zero extension happen inside the
kernel (exact for the symmetric zero-point-0 int8 scheme), so the padded
map is never materialized.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.flop_counter

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ref import (check_groups, conv2d_epilogue_ref,
                                     conv_out_shape, dilated_extent,
                                     halo_window, normalize_padding)

SMEM_BYTES = 232_448      # Hopper: dynamic shared memory one block may use
THREADS = 256             # csrc/conv_common.cuh: kConvThreads
SMS = 132                 # H100 SXM streaming multiprocessors
SM_SMEM = 233_472         # shared memory of one SM; 1 KB of it per block
                          # is reserved
# blocks of the tensor-core kernels one SM's registers hold, by N-tile
# width (csrc: __launch_bounds__(256, NT == 2 ? 4 : 2))
TC_BLOCKS_PER_SM = {32: 4, 64: 2}
GEMM_MIN_KGRP = 8         # narrowest group output width of the implicit
                          # GEMMs (tc, simt); narrower groups run dw (one
                          # input channel a group) or nk (several)
TC_BM = 128               # output pixels per tensor-core block (kTcBM)
TC_MAX_STAGES = 4         # deepest conv2d_ws_pipe ring


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


# what a scalar block aims for when it picks its own tiles: two blocks a SM
SCALAR_HALF_SM = SM_SMEM // 2 - 1024


def _retile(g: ConvGeom, th: int, tw: int, kb: int) -> ConvGeom:
    """``g`` with conv-output tiles ``th`` × ``tw`` and ``kb`` kernels a
    kout bank; every other field (the cin banks among them) kept."""
    pool = _pooled(g)
    oh, ow = (2 * g.poh, 2 * g.pow_) if pool else (g.poh, g.pow_)
    kout_banks = g.k // kb
    return g._replace(
        th=th, tw=tw, n_th=-(-oh // th), n_tw=-(-ow // tw),
        in_th=halo_window(th, g.stride, g.kh, g.dilation),
        in_tw=halo_window(tw, g.stride, g.kw, g.dilation),
        pth=th // 2 if pool else th, ptw=tw // 2 if pool else tw,
        kout_banks=kout_banks, kb=kb,
        bpg=kout_banks // (g.c // g.cgrp))


def scalar_tiles(g: ConvGeom, slots: int) -> ConvGeom:
    """The geometry a scalar-path launch runs: ``g`` itself where its tile
    plan fits a block's shared memory (``slots`` = 1 for ``conv2d_ws``, 2
    for ``conv2d_ws_pipe``), else tiles the launcher picks (a whole-map
    f32 layer, as training runs, needs megabytes).

    It keeps the caller's cin banks and changes only the spatial tiles
    (halved, larger side first, pool-aligned) and the kout sub-banks (more
    of them, ``kb`` down its divisors).  Each output pixel's f32 sum runs
    bias, then cin bank by cin bank, tap by tap, in the same order on any
    tiling, so the choice changes no value.  The first fit wins: under
    half an SM's shared memory (two blocks a SM), else under
    ``SMEM_BYTES``.  A geometry whose smallest tile (one pixel, or a 2×2
    pool window, of one kernel) still overflows raises."""
    if smem_bytes(g, slots) <= SMEM_BYTES:
        return g
    pool = _pooled(g)
    tmin = 2 if pool else 1

    def halve(t):
        h = -(-t // 2)
        return h + h % 2 if pool else h

    kbs = [d for d in range(g.kb, 0, -1) if g.kb % d == 0]
    for budget in (SCALAR_HALF_SM, SMEM_BYTES):
        for kb in kbs:
            th, tw = g.th, g.tw
            while True:
                cand = _retile(g, th, tw, kb)
                if smem_bytes(cand, slots) <= budget:
                    return cand
                if th <= tmin and tw <= tmin:
                    break
                if th >= tw and th > tmin:
                    th = halve(th)
                else:
                    tw = halve(tw)
    least = smem_bytes(_retile(g, tmin, tmin, 1), slots)
    raise ValueError(
        f"no tile of this layer fits a block's shared memory: "
        f"[{g.n},{g.h},{g.w},{g.c}] ⊛ [{g.kh},{g.kw},{g.cgrp},{g.k}] "
        f"(stride {g.stride}, dilation {g.dilation}, cin banks "
        f"{g.cin_banks} of {g.cb} channels, {'int8' if g.int_path else 'f32'}"
        f", {slots} slot{'s' if slots > 1 else ''}) needs {least} bytes "
        f"at {tmin}×{tmin} pixels of one kernel, over the {SMEM_BYTES} a "
        f"Hopper block may use")


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
    if out_scale is None or isinstance(out_scale, (int, float)):
        # filled on the device: a host scalar copied up would sync the host
        scale = torch.full((g.k,), 1.0 if out_scale is None else out_scale,
                           dtype=torch.float32, device=x.device)
    else:
        scale = torch.broadcast_to(torch.as_tensor(
            out_scale, dtype=torch.float32, device=x.device),
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


# ---------------------------------------------------------------------------
# The int8 tensor-core path (csrc/conv_common.cuh: TcParams and the tc_*
# device functions).  Its blocks are sized for the card: the TilePlan's
# banks and tiles are validated by ``setup_conv`` but shape no grid here,
# since int32 sums are exact in any order.
# ---------------------------------------------------------------------------

# Field order of ``TcParams`` in csrc/conv_common.cuh.
TC_FIELDS = ("n", "h", "w", "c", "k", "kh", "kw", "stride", "dil", "pt",
             "pl", "cgrp", "kgrp", "poh", "pow_", "relu", "pool", "rh", "rw",
             "n_ry", "n_rx", "bn", "n_nt", "cs", "n_slices", "taps", "ksp",
             "kpad", "win_h", "win_w", "ps", "ws", "wruns", "wrun",
             "wsrc_step", "wfill", "word", "stages", "slots", "win_bytes",
             "slot_bytes", "slot0", "smem", "xvec", "wvec")


class TcPlan(NamedTuple):
    """One tensor-core launch: every ``TcParams`` field but the two copy
    widths, which depend on the operands' addresses (``tc_params``)."""
    n: int
    h: int
    w: int
    c: int
    k: int
    kh: int
    kw: int
    stride: int
    dil: int
    pt: int
    pl: int
    cgrp: int                 # input channels per group
    kgrp: int                 # output channels per group
    poh: int                  # epilogue output extents
    pow_: int
    relu: int
    pool: int
    rh: int                   # block rectangle of conv-output pixels
    rw: int                   # (rh·rw = TC_BM, pool-aligned)
    n_ry: int                 # rectangles per image, down and across
    n_rx: int
    bn: int                   # N-tile: output channels per block (32/64)
    n_nt: int                 # N-tiles per group
    cs: int                   # input channels per K-chunk (slice)
    n_slices: int             # K-chunks: cgrp // cs
    taps: int                 # kh·kw
    ksp: int                  # K columns per chunk, (tap, channel), ⌈·⌉32
    kpad: int                 # packed weight row: taps·cgrp, ⌈·⌉32
    win_h: int                # halo'd input window of one rectangle
    win_w: int
    ps: int                   # shared bytes per window pixel
    ws: int                   # shared bytes per weight-slab row
    wruns: int                # weight-slab copy: runs per row ...
    wrun: int                 # ... of this many bytes ...
    wsrc_step: int            # ... this far apart in the packed row
    wfill: int                # slab columns [wfill, ksp) stay zero
    word: int                 # 1: a (tap, 4 channels) A word is one load
    stages: int               # ring depth (1 for conv2d_ws)
    slots: int                # ring slots in shared memory
    win_bytes: int
    slot_bytes: int
    slot0: int                # byte offset of slot 0 (after the K table)
    smem: int                 # dynamic shared memory of one block


def blocks_per_sm(bn: int, smem: int) -> int:
    """Tensor-core blocks of N-tile ``bn`` and ``smem`` bytes of shared
    memory that one SM holds: as many as its registers allow, fewer where
    their shared memory runs out first."""
    return min(TC_BLOCKS_PER_SM[bn], SM_SMEM // (smem + 1024))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pooled(g: ConvGeom) -> bool:
    """Whether ``g`` was set up with the 2×2 pool (its epilogue tile is
    half the conv-output tile)."""
    return g.pth != g.th


def _slice_channels(cgrp: int) -> int:
    """Channels of one K-chunk: 32 where they divide the group, else the
    largest divisor of the group's channels up to 64 (the whole group for
    the narrow maps: C = 1, 4, 8, 16)."""
    if cgrp % 32 == 0:
        return 32
    return max(d for d in range(1, min(cgrp, 64) + 1) if cgrp % d == 0)


def _tc_plan(g: ConvGeom, relu: bool, pipelined: bool,
             bn: Optional[int] = None) -> TcPlan:
    pool = _pooled(g)
    groups = g.c // g.cgrp
    kgrp = g.k // groups
    oh, ow = (2 * g.poh, 2 * g.pow_) if pool else (g.poh, g.pow_)
    rw = 16 if ow > 8 else 8 if ow > 4 else 4
    rh = TC_BM // rw
    n_ry, n_rx = -(-oh // rh), -(-ow // rw)
    if bn is None:
        wide = g.n * n_ry * n_rx * groups * -(-kgrp // 64)
        bn = 64 if kgrp >= 64 and wide >= 2 * SMS else 32
    cs = _slice_channels(g.cgrp)
    n_slices = g.cgrp // cs
    taps = g.kh * g.kw
    ksp = _round_up(taps * cs, 32)
    kpad = _round_up(taps * g.cgrp, 32)
    if cs < 16:
        ps = cs
    else:
        ps = _round_up(cs, 16)
        ps += 16 if ps % 32 == 0 else 0     # ≡ 16 mod 32: no bank conflicts
    win_h = (rh - 1) * g.stride + (g.kh - 1) * g.dilation + 1
    win_w = (rw - 1) * g.stride + (g.kw - 1) * g.dilation + 1
    ws = ksp + 16
    win_bytes = _align16(win_h * win_w * ps)
    slot_bytes = win_bytes + bn * ws
    slot0 = _align16(ksp * 4)
    acc_bytes = TC_BM * (bn + 8) * 4        # the epilogue's int32 tile

    def smem(slots):
        return slot0 + max(slots * slot_bytes, acc_bytes)

    stages = slots = 1
    if pipelined:       # as deep as the SM still holds conv2d_ws's blocks
        held = blocks_per_sm(bn, smem(1))
        fits = [s for s in range(2, TC_MAX_STAGES + 1)
                if blocks_per_sm(bn, smem(min(s, n_slices))) >= held]
        stages = max(fits, default=1)     # 1: conv2d_ws's data motion
        slots = min(stages, n_slices)
    if n_slices == 1:
        wruns, wrun, wsrc_step, wfill = 1, ksp, 0, ksp
    else:
        wruns, wrun, wsrc_step, wfill = taps, cs, g.cgrp, taps * cs
    return TcPlan(
        n=g.n, h=g.h, w=g.w, c=g.c, k=g.k, kh=g.kh, kw=g.kw,
        stride=g.stride, dil=g.dilation, pt=g.pt, pl=g.pl, cgrp=g.cgrp,
        kgrp=kgrp, poh=g.poh, pow_=g.pow_, relu=int(relu), pool=int(pool),
        rh=rh, rw=rw, n_ry=n_ry, n_rx=n_rx, bn=bn, n_nt=-(-kgrp // bn),
        cs=cs, n_slices=n_slices, taps=taps, ksp=ksp, kpad=kpad,
        win_h=win_h, win_w=win_w, ps=ps, ws=ws, wruns=wruns, wrun=wrun,
        wsrc_step=wsrc_step, wfill=wfill, word=int(cs % 4 == 0),
        stages=stages, slots=slots, win_bytes=win_bytes,
        slot_bytes=slot_bytes, slot0=slot0, smem=smem(slots))


def tc_plan(g: ConvGeom, relu: bool = False,
            pipelined: bool = False) -> Optional[TcPlan]:
    """The tensor-core launch plan of ``g``, or None where ``conv_path``
    sends it to the scalar kernel.  Deterministic in the geometry:

    * a block computes a pool-aligned rectangle of TC_BM = 128 conv-output
      pixels of one image (16 wide, 8 wide for maps of 8 or fewer columns,
      4 for 4 or fewer) for an N-tile of ``bn`` output channels of one
      group; the grid is (images × rectangles, groups × N-tiles);
    * ``bn`` is 64 where the group has 64 or more output channels and the
      grid at 64 still has two blocks for each of the 132 SMs, else 32
      (and 32 wherever 64 does not fit a block's shared memory);
    * the K loop runs over chunks of ``cs`` input channels × every tap;
      ``conv2d_ws`` loads each chunk and then computes it, and
      ``conv2d_ws_pipe`` keeps up to 4 chunks in flight in a ring, as deep
      as the SM still holds as many blocks as it holds of ``conv2d_ws``'s
      (``blocks_per_sm``); where even two slots would cost a block, the
      ring has one slot and moves data as ``conv2d_ws`` does.

    So the two wrappers' plans are None together: a ring never needs more
    shared memory than the SM gives ``conv2d_ws``'s block."""
    if not g.int_path or g.k // (g.c // g.cgrp) < GEMM_MIN_KGRP:
        return None
    for bn in (None, 32):
        plan = _tc_plan(g, relu, pipelined, bn)
        if _tc_plan(g, relu, False, plan.bn).smem <= SMEM_BYTES:
            return plan
    return None


def conv_path(g: ConvGeom) -> str:
    """The path rule, by geometry alone: K/groups ≥ 8 with one K-chunk's
    window and weight slab within a block's shared memory runs an implicit
    GEMM — "tc" for int8 operands (``tc_plan``), "simt" for f32
    (``simt_plan``); one input channel a group with fewer than 8 outputs
    (depthwise, a channel multiplier under 8, a one-channel map with under
    8 outputs) runs the direct conv "dw" (``dw_plan``), and several input
    channels a group with fewer than 8 outputs (a segmentation head, a
    narrow grouped layer) the direct conv "nk" (``nk_plan``), int8 or f32;
    anything else ("scalar": K/groups ≥ 8 where no chunk of the implicit
    GEMM fits a block, or fewer outputs where no nk block holds one
    window of 4 channels) runs the first port's scalar kernel."""
    if tc_plan(g) is not None:
        return "tc"
    if simt_plan(g) is not None:
        return "simt"
    if dw_plan(g) is not None:
        return "dw"
    return "nk" if nk_plan(g) is not None else "scalar"


# (id(weights), what was derived) → (weak reference to the weights, their
# version, the derived tensor)
_derived: Dict[tuple, tuple] = {}


def derived_weights(w: torch.Tensor, what, make):
    """``make(w)``, cached per weight tensor, its version and ``what``
    (a hashable label), so that a served network derives each layer's
    packed, flipped or sliced weights once and keeps them while the
    weights live.  ``make`` returns tensors (one, or a tuple) that hold no
    reference to ``w`` (copies, not views), or the entry would keep ``w``
    alive."""
    key = (id(w), what)
    hit = _derived.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    out = make(w)
    _derived[key] = (weakref.ref(w, lambda _: _derived.pop(key, None)),
                     w._version, out)
    return out


def _pack(w: torch.Tensor) -> torch.Tensor:
    kh, kw, cgrp, k = w.shape
    cols = kh * kw * cgrp
    packed = torch.zeros((k, _round_up(cols, 32)), dtype=torch.int8,
                         device=w.device)
    packed[:, :cols] = w.permute(3, 0, 1, 2).reshape(k, cols)
    return packed


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """[KH,KW,C/g,K] int8 → [K, kpad] int8, K-major: row k holds kernel
    k's taps in (tap, channel) order, zero-padded to a multiple of 32 —
    the B operand of ``mma.sync … .row.col``.  Cached per weight tensor
    and its version (``derived_weights``), so a served network packs each
    layer once."""
    return derived_weights(w, "pack", _pack)


def tc_params(plan: TcPlan, x: torch.Tensor,
              wp: torch.Tensor) -> ctypes.Array:
    """The ``TcParams`` record of one launch, as a C int array: the plan
    and the widest copy each operand's alignment allows (16, 8 or 4
    bytes through ``cp.async``; 1 = byte loads)."""
    xvec = _chunk(plan.cs, plan.c, plan.cgrp, plan.ps, x.data_ptr()) or 1
    wvec = _chunk(plan.wrun, plan.kpad, plan.wsrc_step, plan.cs, plan.ws,
                  wp.data_ptr()) or 1
    return _tc_record(plan, xvec, wvec)


@functools.lru_cache(maxsize=512)
def _tc_record(plan: TcPlan, xvec: int, wvec: int) -> ctypes.Array:
    vals = [int(v) for v in plan] + [xvec, wvec]
    return (ctypes.c_int * len(vals))(*vals)


def tc_windows(plan: TcPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's A-operand address arithmetic: (row bases [TC_BM], K
    table [ksp]).  Row m of a block is pixel (m // rw, m % rw) of its
    rectangle; its window origin sits ``rows[m]`` bytes into the window
    slab, and K column j of a chunk adds ``table[j]`` (−1: a padded column,
    read as 0).  Built in the kernel by ``tc_row_base`` / ``tc_build_table``."""
    m = torch.arange(TC_BM)
    rows = ((m // plan.rw) * plan.stride * plan.win_w
            + (m % plan.rw) * plan.stride) * plan.ps
    j = torch.arange(plan.ksp)
    tap, c = j // plan.cs, j % plan.cs
    off = ((tap // plan.kw) * plan.dil * plan.win_w
           + (tap % plan.kw) * plan.dil) * plan.ps + c
    return rows, torch.where(tap < plan.taps, off, torch.full_like(off, -1))


def conv2d_ws_tc_emulate(x, w, bias=None, out_scale=None, *,
                         pipelined: bool = False, stride: int = 1,
                         padding="VALID", groups: int = 1,
                         cin_banks: int = 4, kout_banks: int = 4,
                         h_tile: int = 0, w_tile: int = 0,
                         relu: bool = False, pool: bool = False,
                         dilation: int = 1) -> torch.Tensor:
    """The tensor-core kernels' arithmetic replayed in plain PyTorch on the
    CPU, block by block, from the same ``tc_plan``: packed K-major weights
    with their zero K padding, each chunk's halo'd window slab laid out
    with ``ps`` bytes a pixel, A gathered through ``tc_windows``' row bases
    and K table, B the weight slab as the kernel copies it, int32
    accumulators that start at the bias, and the block epilogue (ReLU →
    2×2 max-pool inside the rectangle → requantize) with the ragged edge
    masked.  For the tests only: the wrappers never call it."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("the tensor-core path takes int8 operands")
    g = setup_conv(tuple(x.shape), tuple(w.shape), stride=stride,
                   padding=padding, groups=groups, cin_banks=cin_banks,
                   kout_banks=kout_banks, h_tile=h_tile, w_tile=w_tile,
                   pool=pool, requant=out_scale is not None,
                   dilation=dilation)
    p = tc_plan(g, relu, pipelined)
    if p is None:
        raise ValueError("this geometry takes the scalar path (conv_path)")
    wp = pack_weights(w).to(torch.int64)
    bias, scale, out_dtype = _operands(x, w, bias, out_scale, g)
    rows, table = tc_windows(p)
    # every window, cut from a map zero-extended past its edges
    sy, sx = p.rh * p.stride, p.rw * p.stride
    hp = (p.n_ry - 1) * sy + p.win_h
    wpx = (p.n_rx - 1) * sx + p.win_w
    xp = torch.zeros((p.n, max(hp, p.pt + p.h), max(wpx, p.pl + p.w), p.c),
                     dtype=torch.int64)
    xp[:, p.pt:p.pt + p.h, p.pl:p.pl + p.w] = x.to(torch.int64)
    win = xp.unfold(1, p.win_h, sy).unfold(2, p.win_w, sx)[:, :p.n_ry,
                                                            :p.n_rx]
    win = win.permute(0, 1, 2, 4, 5, 3)        # [N, ry, rx, wh, ww, C]
    nrect = p.n * p.n_ry * p.n_rx
    gather = (rows[:, None] + table.clamp(min=0)[None, :])   # [BM, ksp]
    pad_col = (table < 0)[None, :]
    ph, pw = (p.rh // 2, p.rw // 2) if p.pool else (p.rh, p.rw)
    out = torch.zeros((p.n, p.n_ry * ph, p.n_rx * pw, p.k), dtype=out_dtype)
    for grp in range(groups):
        for nt in range(p.n_nt):
            n0 = nt * p.bn
            valid = torch.arange(n0, n0 + p.bn) < p.kgrp        # [bn]
            kidx = grp * p.kgrp + torch.arange(n0, n0 + p.bn).clamp(
                max=p.kgrp - 1)
            acc = torch.where(valid, bias[kidx].to(torch.int64),
                              torch.zeros((), dtype=torch.int64))
            acc = acc.expand(nrect, TC_BM, p.bn).clone()
            for s in range(p.n_slices):
                c0 = grp * p.cgrp + s * p.cs
                slab = torch.zeros((nrect, p.win_h * p.win_w, p.ps),
                                   dtype=torch.int64)
                slab[..., :p.cs] = win[..., c0:c0 + p.cs].reshape(
                    nrect, p.win_h * p.win_w, p.cs)
                a = slab.reshape(nrect, -1)[:, gather.reshape(-1)]
                a = a.reshape(nrect, TC_BM, p.ksp).masked_fill(pad_col, 0)
                b = torch.zeros((p.bn, p.ksp), dtype=torch.int64)
                for r in range(p.wruns):
                    src = r * p.wsrc_step + s * p.cs
                    b[:, r * p.cs:r * p.cs + p.wrun] = \
                        wp[kidx, src:src + p.wrun]
                b[~valid] = 0
                acc += a @ b.T
            acc = acc.to(torch.int32).reshape(p.n, p.n_ry, p.n_rx, p.rh,
                                              p.rw, p.bn)
            if p.relu:
                acc = acc.clamp(min=0)
            if p.pool:
                acc = acc.reshape(p.n, p.n_ry, p.n_rx, ph, 2, pw, 2, p.bn)
                acc = acc.amax(dim=(4, 6))
            if out_scale is not None:
                acc = ref.requantize_ref(acc, scale[kidx])
            tile = acc.permute(0, 1, 3, 2, 4, 5).reshape(
                p.n, p.n_ry * ph, p.n_rx * pw, p.bn)
            cols = kidx[valid]
            out[..., cols] = tile[..., valid]
    return out[:, :p.poh, :p.pow_].contiguous()


# ---------------------------------------------------------------------------
# The f32 simt path (csrc/conv_common.cuh: SimtParams and the simt_* device
# functions).  Its blocks are sized for the card by geometry alone: the
# TilePlan's banks and tiles are validated by ``setup_conv`` and shape
# nothing here, so the order of each output's f32 sum depends on the shape
# only (a whole-map and a tiled call, and the two kernels, give the same
# bits).
# ---------------------------------------------------------------------------

SIMT_TM = SIMT_TN = 8     # outputs a thread: pixels × channels (kSimtTM/TN)
SIMT_MAX_KC = 72          # K rows (tap, channel) of a chunk at most
SIMT_MAX_STAGES = 4       # deepest conv2d_ws_pipe ring
SIMT_BLOCKS_PER_SM = 2    # csrc: __launch_bounds__(256, 2), 128 registers
SIMT_TILE_PAD = 4         # epilogue tile row: BN + 4 floats (kSimtTilePad)
SIMT_WIDTHS = (4, 8, 16, 32, 64)    # rectangle widths a plan considers

# Field order of ``SimtParams`` in csrc/conv_common.cuh.
SIMT_FIELDS = ("n", "h", "w", "c", "k", "kh", "kw", "stride", "dil", "pt",
               "pl", "cgrp", "kgrp", "oh", "ow", "poh", "pow_", "relu",
               "pool", "rh", "rw", "n_ry", "n_rx", "bn", "n_nt", "cs",
               "n_chunks", "split", "kcs", "taps", "win_h", "win_w", "ps",
               "win_floats", "slot_floats", "stages", "slots", "smem",
               "wvec")


class SimtPlan(NamedTuple):
    """One simt launch: every ``SimtParams`` field but the weight copy
    width, which depends on the weights' address (``simt_params``)."""
    n: int
    h: int
    w: int
    c: int
    k: int
    kh: int
    kw: int
    stride: int
    dil: int
    pt: int
    pl: int
    cgrp: int                 # input channels per group
    kgrp: int                 # output channels per group
    oh: int                   # conv-output extents (pool-trimmed)
    ow: int
    poh: int                  # epilogue output extents
    pow_: int
    relu: int
    pool: int
    rh: int                   # block rectangle of conv-output pixels:
    rw: int                   # rh·rw = 256·8·8 / bn, pool-aligned
    n_ry: int                 # rectangles per image, down and across
    n_rx: int
    bn: int                   # N-tile: output channels per block
    n_nt: int                 # N-tiles per group
    cs: int                   # input channels per K-chunk
    n_chunks: int             # K-chunks: cgrp // cs
    split: int                # K slices over blockIdx.z (1: none)
    kcs: int                  # chunks per slice
    taps: int                 # kh·kw
    win_h: int                # halo'd input window of one rectangle
    win_w: int
    ps: int                   # floats a window pixel: cs rounded up to odd
    win_floats: int           # window slab, rounded up to 4 floats
    slot_floats: int          # one slot: window | weight slab [taps·cs][bn]
    stages: int               # ring depth (1 for conv2d_ws)
    slots: int                # ring slots in shared memory
    smem: int                 # dynamic shared memory of one block


def simt_blocks_per_sm(smem: int) -> int:
    """simt blocks of ``smem`` bytes of shared memory that one SM holds:
    two (the registers' limit), fewer where shared memory runs out."""
    return min(SIMT_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))


def _simt_rect(bm: int, lanes: int, oh: int, ow: int, g: ConvGeom):
    """(rh, rw) of a ``bm``-pixel block rectangle: the width (a power of two
    at least ``lanes``, so that a warp's pixels of one load lie in one row)
    whose rectangles pad the map least, then whose halo'd windows are
    smallest, then the widest."""
    best = None
    for rw in SIMT_WIDTHS:
        rh = bm // rw
        if rw < lanes or rh < 2:
            continue
        area = -(-oh // rh) * rh * -(-ow // rw) * rw
        win = (halo_window(rh, g.stride, g.kh, g.dilation)
               * halo_window(rw, g.stride, g.kw, g.dilation))
        key = (area, win, -rw)
        if best is None or key < best[0]:
            best = (key, rh, rw)
    return best[1], best[2]


@functools.lru_cache(maxsize=512)
def _simt_plan(g: ConvGeom, relu: bool, pipelined: bool
               ) -> Optional[SimtPlan]:
    pool = _pooled(g)
    groups = g.c // g.cgrp
    kgrp = g.k // groups
    oh, ow = (2 * g.poh, 2 * g.pow_) if pool else (g.poh, g.pow_)
    bn = 128 if kgrp >= 128 else 64 if kgrp >= 64 else 32
    ct = bn // SIMT_TN                          # threads across the N-tile
    bm = (THREADS // ct) * SIMT_TM
    rh, rw = _simt_rect(bm, 32 // ct, oh, ow, g)
    n_ry, n_rx = -(-oh // rh), -(-ow // rw)
    taps = g.kh * g.kw
    win_h = halo_window(rh, g.stride, g.kh, g.dilation)
    win_w = halo_window(rw, g.stride, g.kw, g.dilation)
    tile = bm * (bn + SIMT_TILE_PAD)            # the epilogue's f32 tile

    def layout(cs):
        ps = cs | 1
        win_floats = _round_up(win_h * win_w * ps, 4)
        return ps, win_floats, win_floats + taps * cs * bn

    fits = [d for d in range(g.cgrp, 0, -1) if g.cgrp % d == 0
            and (taps * d <= SIMT_MAX_KC or d == 1)
            and 4 * max(layout(d)[2], tile) <= SMEM_BYTES]
    if not fits:
        return None
    cs = fits[0]
    ps, win_floats, slot_floats = layout(cs)
    n_chunks = g.cgrp // cs
    n_nt = -(-kgrp // bn)
    blocks = g.n * n_ry * n_rx * groups * n_nt
    split = 1
    if blocks < SMS:            # under one block an SM: split K to ~two
        split = max(1, min(n_chunks, 2 * SMS // blocks))
    kcs = -(-n_chunks // split)
    split = -(-n_chunks // kcs)

    def smem(slots):
        return 4 * max(slots * slot_floats, tile)

    stages = slots = 1
    if pipelined:       # as deep as the SM still holds conv2d_ws's blocks
        held = simt_blocks_per_sm(smem(1))
        deep = [s for s in range(2, SIMT_MAX_STAGES + 1)
                if smem(min(s, kcs)) <= SMEM_BYTES
                and simt_blocks_per_sm(smem(min(s, kcs))) >= held]
        stages = max(deep, default=1)
        slots = min(stages, kcs)
    return SimtPlan(
        n=g.n, h=g.h, w=g.w, c=g.c, k=g.k, kh=g.kh, kw=g.kw,
        stride=g.stride, dil=g.dilation, pt=g.pt, pl=g.pl, cgrp=g.cgrp,
        kgrp=kgrp, oh=oh, ow=ow, poh=g.poh, pow_=g.pow_, relu=int(relu),
        pool=int(pool), rh=rh, rw=rw, n_ry=n_ry, n_rx=n_rx, bn=bn,
        n_nt=n_nt, cs=cs, n_chunks=n_chunks, split=split, kcs=kcs,
        taps=taps, win_h=win_h, win_w=win_w, ps=ps, win_floats=win_floats,
        slot_floats=slot_floats, stages=stages, slots=slots,
        smem=smem(slots))


def simt_plan(g: ConvGeom, relu: bool = False,
              pipelined: bool = False) -> Optional[SimtPlan]:
    """The f32 simt launch plan of ``g``, or None where ``conv_path`` sends
    it elsewhere (int8 operands; K/groups under 8; no K-chunk of one
    channel fits a block).  Deterministic in the geometry, whatever the
    caller's banks and tiles:

    * a block of 256 threads computes a pool-aligned rectangle of
      conv-output pixels of one image for an N-tile of ``bn`` output
      channels of one group (``bn`` 128 where the group has 128 or more,
      64 where 64 or more, else 32; the rectangle 256·64 / ``bn`` pixels,
      ``_simt_rect``'s shape), each thread 8 pixels × 8 channels in
      registers; the grid is (images × rectangles, groups × N-tiles, K
      slices);
    * the K loop runs over chunks of ``cs`` input channels × every tap
      (the largest divisor of the group's channels with at most
      ``SIMT_MAX_KC`` K rows a chunk that fits shared memory);
      ``conv2d_ws`` loads each chunk and then computes it, and
      ``conv2d_ws_pipe`` keeps up to 4 chunks in flight in a ring, as deep
      as the SM still holds as many blocks as it holds of ``conv2d_ws``'s;
    * where the output tiles number under one block an SM, K goes in
      ``split`` slices of ``kcs`` chunks, as many as bring about two
      blocks an SM, and a reduce adds bias and partials in slice order.

    The two wrappers' plans differ in ``stages``, ``slots`` and ``smem``
    only, so both kernels sum in one order."""
    if g.int_path or g.k // (g.c // g.cgrp) < GEMM_MIN_KGRP:
        return None
    return _simt_plan(g, bool(relu), bool(pipelined))


def simt_params(plan: SimtPlan, w: torch.Tensor) -> ctypes.Array:
    """The ``SimtParams`` record of one launch, as a C int array: the plan
    and the weight copy width (4 floats through 16-byte ``cp.async`` where
    the group's and the map's output widths come in fours and w is
    16-byte aligned, else one)."""
    wvec = 4 if _chunk(plan.kgrp * 4, plan.k * 4, w.data_ptr()) == 16 else 1
    return _simt_record(plan, wvec)


@functools.lru_cache(maxsize=512)
def _simt_record(plan: SimtPlan, wvec: int) -> ctypes.Array:
    vals = [int(v) for v in plan] + [wvec]
    return (ctypes.c_int * len(vals))(*vals)


def simt_windows(plan: SimtPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's input-window address arithmetic, in floats: (pixel
    bases [BM], tap offsets [taps]).  Pixel m of a block is (m // rw,
    m % rw) of its rectangle; its window origin sits ``bases[m]`` floats
    into the window slab (pixel-major, ``ps`` floats a pixel, ``win_w``
    pixels a row), and tap (dy, dx) adds ``taps[dy·kw + dx]``, channel c
    of the chunk c more.  Built in the kernel by ``simt_row_bases`` and
    ``simt_chunk``."""
    m = torch.arange(plan.rh * plan.rw)
    bases = ((m // plan.rw) * plan.stride * plan.win_w
             + (m % plan.rw) * plan.stride) * plan.ps
    t = torch.arange(plan.taps)
    offs = ((t // plan.kw) * plan.dil * plan.win_w
            + (t % plan.kw) * plan.dil) * plan.ps
    return bases, offs


def conv2d_ws_simt_emulate(x, w, bias=None, out_scale=None, *,
                           pipelined: bool = False, stride: int = 1,
                           padding="VALID", groups: int = 1,
                           cin_banks: int = 4, kout_banks: int = 4,
                           h_tile: int = 0, w_tile: int = 0,
                           relu: bool = False, pool: bool = False,
                           dilation: int = 1) -> torch.Tensor:
    """The simt kernels' order of sums replayed in plain PyTorch, block by
    block, from the same ``simt_plan``: each chunk's halo'd window slab
    laid out with ``ps`` floats a pixel and read through ``simt_windows``,
    its weight slab [taps·cs, bn] cut from w's rows, f32 sums that start at
    the bias (without a split) and add the K-chunks in order; with a split,
    each slice's chunks summed from 0 and the reduce's bias + partials in
    slice order; then the epilogue (ReLU → 2×2 max-pool inside the
    rectangle → requantize) with the ragged edge masked.  Within a chunk
    the kernel sums product by product (FFMA), which this does not replay.
    On any device; for the tests and ``chip_smoke.py`` only: the wrappers
    never call it."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("the simt path takes float32 operands")
    g = setup_conv(tuple(x.shape), tuple(w.shape), stride=stride,
                   padding=padding, groups=groups, cin_banks=cin_banks,
                   kout_banks=kout_banks, h_tile=h_tile, w_tile=w_tile,
                   pool=pool, requant=out_scale is not None,
                   dilation=dilation, int_path=False)
    p = simt_plan(g, relu, pipelined)
    if p is None:
        raise ValueError(f"this geometry takes the {conv_path(g)} path "
                         f"(conv_path)")
    bias, scale, out_dtype = _operands(x, w, bias, out_scale, g)
    dev = x.device
    bases, offs = (t.to(dev) for t in simt_windows(p))
    sy, sx = p.rh * p.stride, p.rw * p.stride
    hp = (p.n_ry - 1) * sy + p.win_h
    wpx = (p.n_rx - 1) * sx + p.win_w
    xp = x.new_zeros((p.n, max(hp, p.pt + p.h), max(wpx, p.pl + p.w), p.c))
    xp[:, p.pt:p.pt + p.h, p.pl:p.pl + p.w] = x
    win = xp.unfold(1, p.win_h, sy).unfold(2, p.win_w, sx)[:, :p.n_ry,
                                                            :p.n_rx]
    win = win.permute(0, 1, 2, 4, 5, 3)        # [N, ry, rx, wh, ww, C]
    nrect, bm = p.n * p.n_ry * p.n_rx, p.rh * p.rw
    chan = torch.arange(p.cs, device=dev)
    # K column (tap, c) of pixel m: window float bases[m] + offs[tap] + c
    gather = (bases[:, None, None] + offs[None, :, None]
              + chan).reshape(-1)
    wrows = w.reshape(p.taps * p.cgrp, p.k)
    ph, pw = (p.rh // 2, p.rw // 2) if p.pool else (p.rh, p.rw)
    out = torch.zeros((p.n, p.n_ry * ph, p.n_rx * pw, p.k), dtype=out_dtype,
                      device=dev)
    for grp in range(groups):
        for nt in range(p.n_nt):
            cols = torch.arange(nt * p.bn, (nt + 1) * p.bn, device=dev)
            valid = cols < p.kgrp
            kidx = grp * p.kgrp + cols.clamp(max=p.kgrp - 1)
            b = torch.where(valid, bias[kidx], 0.0)
            parts = []
            for sl in range(p.split):
                acc = (b.expand(nrect, bm, p.bn).clone() if p.split == 1
                       else x.new_zeros((nrect, bm, p.bn)))
                for s in range(sl * p.kcs, min(p.n_chunks,
                                               (sl + 1) * p.kcs)):
                    c0 = grp * p.cgrp + s * p.cs
                    slab = x.new_zeros((nrect, p.win_h * p.win_w, p.ps))
                    slab[..., :p.cs] = win[..., c0:c0 + p.cs].reshape(
                        nrect, p.win_h * p.win_w, p.cs)
                    a = slab.reshape(nrect, -1)[:, gather].reshape(
                        nrect, bm, p.taps * p.cs)
                    rows = (torch.arange(p.taps, device=dev)[:, None]
                            * p.cgrp + s * p.cs + chan).reshape(-1)
                    slab_w = wrows[rows][:, kidx] * valid
                    acc = acc + a @ slab_w
                parts.append(acc)
            acc = parts[0]
            if p.split > 1:             # the reduce: bias, then the slices
                acc = b.expand(nrect, bm, p.bn).clone()
                for part in parts:
                    acc = acc + part
            acc = acc.reshape(p.n, p.n_ry, p.n_rx, p.rh, p.rw, p.bn)
            if p.relu:
                acc = acc.clamp(min=0)
            if p.pool:
                acc = acc.reshape(p.n, p.n_ry, p.n_rx, ph, 2, pw, 2, p.bn)
                acc = acc.amax(dim=(4, 6))
            if out_scale is not None:
                acc = ref.requantize_ref(acc, scale[kidx])
            tile = acc.permute(0, 1, 3, 2, 4, 5).reshape(
                p.n, p.n_ry * ph, p.n_rx * pw, p.bn)
            out[..., kidx[valid]] = tile[..., valid]
    return out[:, :p.poh, :p.pow_].contiguous()


# ---------------------------------------------------------------------------
# The depthwise path, "dw" (csrc/conv_common.cuh: DwParams and the dw_*
# device functions): one input channel a group and fewer than 8 outputs,
# int8 or f32.  A direct conv whose blocks are sized by geometry alone, so
# each output's sum (bias, then the taps in (dy, dx) order) does not depend
# on the caller's tiles or banks.
# ---------------------------------------------------------------------------

DW_V = 4                  # channels a thread's vector (csrc: kDwV)
DW_SP = 4                 # conv-output pixels a thread's strip (kDwSP)
DW_MAX_KC = {True: 64, False: 128}  # channels a run, int8 / f32

# Field order of ``DwParams`` in csrc/conv_common.cuh.
DW_FIELDS = ("n", "h", "w", "c", "k", "kh", "kw", "stride", "dil", "pt",
             "pl", "mult", "oh", "ow", "poh", "pow_", "relu", "pool", "rh",
             "rw", "n_ry", "n_rx", "kc", "n_kc", "cv", "win_h", "win_w",
             "pitch", "tpitch", "win_bytes", "slot_bytes", "slots", "smem",
             "n_rect", "xvec", "wvec", "ovec")


class DwPlan(NamedTuple):
    """One dw launch: every ``DwParams`` field but the three copy widths,
    which depend on the operands' addresses (``dw_params``)."""
    n: int
    h: int
    w: int
    c: int
    k: int
    kh: int
    kw: int
    stride: int
    dil: int
    pt: int
    pl: int
    mult: int                 # K/groups: output channel k reads k // mult
    oh: int                   # conv-output extents (pool-trimmed)
    ow: int
    poh: int                  # epilogue output extents
    pow_: int
    relu: int
    pool: int
    rh: int                   # block rectangle of conv-output pixels:
    rw: int                   # rh·rw = active threads·DW_SP / cv, a
                              # power of two, pool-aligned
    n_ry: int                 # rectangles per image, down and across
    n_rx: int
    kc: int                   # output channels of a run (contiguous)
    n_kc: int                 # runs: ⌈K / kc⌉
    cv: int                   # channel vectors across a run: kc / 4
    win_h: int                # halo'd input window of one rectangle
    win_w: int
    pitch: int                # elements a window row: win_w·kc + pad
    tpitch: int               # accumulators a tile row: rw·kc + pad
    win_bytes: int            # window, 16-byte aligned; the weights
                              # [taps][kc] follow it
    slot_bytes: int           # max(window + weights, accumulator tile)
    slots: int                # 1 for conv2d_ws, 2 for conv2d_ws_pipe's ring
    smem: int                 # dynamic shared memory of one block
    n_rect: int               # blocks' work items: n · n_ry · n_rx · n_kc


def dw_thread(t: int, cv: int, rh: int) -> Tuple[int, int, int]:
    """Thread ``t``'s (channel vector, rectangle row, strip column) —
    csrc ``DwThread``: vectors fastest, then rows, so a warp's strips lie
    in consecutive rows of one strip column."""
    u = t // cv
    return t % cv, u % rh, u // rh


def _ways(spans) -> int:
    """Shared-memory wavefronts one access of ``spans`` (first word, words)
    takes: the most distinct words that fall on one bank."""
    banks: Dict[int, set] = {}
    for start, count in spans:
        for word in range(start, start + count):
            banks.setdefault(word % 32, set()).add(word)
    return max(len(v) for v in banks.values())


def _warps(active: int):
    """The thread numbers of each warp among a block's first ``active``
    threads, those that own a strip."""
    return [range(t, min(t + 32, active)) for t in range(0, active, 32)]


@functools.lru_cache(maxsize=4096)
def dw_read_ways(int_path: bool, cv: int, rh: int, stride: int, kc: int,
                 pitch: int, active: int = THREADS) -> int:
    """Wavefronts of a block's worst window read: a lane reads one channel
    vector of its strip's pixel (4 floats, 16-byte loads in wavefronts of
    8 lanes; 4 int8, one word in wavefronts of 32 lanes)."""
    ways = 1
    for warp in _warps(active):
        lanes = [dw_thread(t, cv, rh) for t in warp]
        if int_path:       # bytes → words
            fronts = [[((r * stride * pitch + c * DW_SP * stride * kc
                         + v * DW_V) // 4, 1) for v, r, c in lanes]]
        else:
            fronts = [[(r * stride * pitch + c * DW_SP * stride * kc
                        + v * DW_V, 4) for v, r, c in lanes[q:q + 8]]
                      for q in range(0, 32, 8)]
        ways = max(ways, *map(_ways, fronts))
    return ways


@functools.lru_cache(maxsize=4096)
def dw_write_ways(cv: int, rh: int, kc: int, tpitch: int,
                  active: int = THREADS) -> int:
    """Wavefronts of a block's worst accumulator-tile write: a lane stores
    4 accumulators of one pixel (16-byte stores, wavefronts of 8)."""
    ways = 1
    for warp in _warps(active):
        lanes = [dw_thread(t, cv, rh) for t in warp]
        ways = max(ways, *(_ways([(r * tpitch + c * DW_SP * kc + v * DW_V, 4)
                                  for v, r, c in lanes[q:q + 8]])
                           for q in range(0, 32, 8)))
    return ways


def _least_ways(base: int, pads, ways) -> int:
    """``base`` plus the first of ``pads`` whose ``ways`` is least."""
    best = None
    for p in pads:
        n = ways(base + p)
        if best is None or n < best[0]:
            best = (n, base + p)
        if n == 1:
            break
    return best[1]


def _dw_layout(g: ConvGeom, kc: int, rh: int, rw: int):
    """(win_h, win_w, pitch, tpitch, win_bytes, slot_bytes) of a block
    rectangle: each row pitch padded by the least (16 bytes at a time, a
    word for an int8 window) that makes the block's window reads and tile
    writes the fewest wavefronts."""
    es = 1 if g.int_path else 4
    cv = kc // DW_V
    active = rh * (rw // DW_SP) * cv
    win_h = halo_window(rh, g.stride, g.kh, g.dilation)
    win_w = halo_window(rw, g.stride, g.kw, g.dilation)
    pitch = _least_ways(win_w * kc, range(0, 128 if g.int_path else 32, 4),
                        lambda pt_: dw_read_ways(g.int_path, cv, rh,
                                                 g.stride, kc, pt_, active))
    tpitch = _least_ways(rw * kc, range(0, 32, 4),
                         lambda tp: dw_write_ways(cv, rh, kc, tp, active))
    win_bytes = _align16(win_h * pitch * es)
    w_bytes = _align16(g.kh * g.kw * kc * es)
    return (win_h, win_w, pitch, tpitch, win_bytes,
            max(win_bytes + w_bytes, _align16(rh * tpitch * 4)))


def _dw_rect(g: ConvGeom, pool: bool, oh: int, ow: int, kc: int,
             strips: int):
    """(rh, rw, layout) of the rectangle of ``strips`` strips whose window
    fits twice in a block's shared memory and that pads the map least,
    then whose halo'd window is smallest, then the widest; None where no
    rectangle fits."""
    best = None
    for rh in (1 << a for a in range(9) if (1 << a) <= strips):
        rw = DW_SP * strips // rh
        if pool and rh % 2:
            continue
        lay = _dw_layout(g, kc, rh, rw)
        if 2 * lay[5] > SMEM_BYTES:
            continue
        area = -(-oh // rh) * rh * -(-ow // rw) * rw
        key = (area, lay[0] * lay[1], -rw)
        if best is None or key < best[0]:
            best = (key, rh, rw, lay)
    return best and best[1:]


@functools.lru_cache(maxsize=512)
def _dw_plan(g: ConvGeom, relu: bool, pipelined: bool) -> DwPlan:
    pool = _pooled(g)
    groups = g.c // g.cgrp
    oh, ow = (2 * g.poh, 2 * g.pow_) if pool else (g.poh, g.pow_)
    runs = sorted((DW_V << a for a in range(8)
                   if DW_V << a <= DW_MAX_KC[g.int_path]),
                  key=lambda r: (-(-g.k // r) * r, -r))  # least padding
    # every thread owning a strip, at the widest run whose window fits;
    # only where none fits, half the threads, and so on
    best = next(((kc, rect) for active in (THREADS >> a for a in range(9))
                 for kc in runs if active >= kc // DW_V
                 for rect in [_dw_rect(g, pool, oh, ow, kc,
                                       active // (kc // DW_V))] if rect),
                None)
    if best is None:
        raise ValueError(
            f"no dw block rectangle of this layer fits a block's shared "
            f"memory: [{g.n},{g.h},{g.w},{g.c}] ⊛ [{g.kh},{g.kw},1,{g.k}] "
            f"(stride {g.stride}, dilation {g.dilation})")
    kc, (rh, rw, (win_h, win_w, pitch, tpitch, win_bytes, slot_bytes)) = best
    cv = kc // DW_V
    slots = 2 if pipelined else 1
    n_ry, n_rx, n_kc = -(-oh // rh), -(-ow // rw), -(-g.k // kc)
    return DwPlan(
        n=g.n, h=g.h, w=g.w, c=g.c, k=g.k, kh=g.kh, kw=g.kw,
        stride=g.stride, dil=g.dilation, pt=g.pt, pl=g.pl,
        mult=g.k // groups, oh=oh, ow=ow, poh=g.poh, pow_=g.pow_,
        relu=int(relu), pool=int(pool), rh=rh, rw=rw, n_ry=n_ry, n_rx=n_rx,
        kc=kc, n_kc=n_kc, cv=cv, win_h=win_h, win_w=win_w, pitch=pitch,
        tpitch=tpitch, win_bytes=win_bytes, slot_bytes=slot_bytes,
        slots=slots, smem=slots * slot_bytes,
        n_rect=g.n * n_ry * n_rx * n_kc)


def dw_plan(g: ConvGeom, relu: bool = False,
            pipelined: bool = False) -> Optional[DwPlan]:
    """The dw launch plan of ``g``, or None where ``conv_path`` sends it
    elsewhere (a group of more than one input channel, or of 8 or more
    outputs).  Deterministic in the geometry, whatever the caller's banks
    and tiles:

    * a block of 256 threads computes a pool-aligned rectangle of
      conv-output pixels of one image for a run of ``kc`` output channels
      that are contiguous in NHWC (4–128 in f32, 4–64 in int8: the power of
      two times 4 that pads K least, the largest of those whose window
      fits twice in a block's shared memory);
    * a thread owns a vector of 4 channels and a strip of ``DW_SP`` pixels
      along a rectangle row; the run's ``cv`` vectors lie across a warp, so
      the rectangle has 256 / cv strips — the shape that pads the map
      least, then whose halo'd window is smallest, then the widest.  Where
      no run's window of that many strips fits (a wide stride in f32), the
      first 128, 64, … threads own strips and the others only copy and
      store;
    * the window and the accumulator tile rows are padded so that a warp's
      reads and writes of shared memory take the fewest wavefronts;
    * ``conv2d_ws`` runs one block a rectangle (``n_rect`` blocks);
      ``conv2d_ws_pipe`` persistent blocks that walk the rectangles and
      prefetch the next one's window into a second slot.

    The two wrappers' plans differ in ``slots`` and ``smem`` only.  Raises
    where even two windows of one strip overflow a block's shared
    memory."""
    if g.cgrp != 1 or g.k // g.c >= GEMM_MIN_KGRP:
        return None
    return _dw_plan(g, bool(relu), bool(pipelined))


def dw_params(plan: DwPlan, x: torch.Tensor, w: torch.Tensor,
              out: torch.Tensor) -> ctypes.Array:
    """The ``DwParams`` record of one launch, as a C int array: the plan
    and the widest copy each operand allows — the window (16, 8 or 4
    bytes a ``cp.async``, dividing the run, the map's pixel, a window row
    and x's address; 0 = one element at a time, as a channel multiplier
    above 1 reads), the weight rows (the same, against K), and the
    output's stores (4 channels where K comes in fours, else 1)."""
    es = x.element_size()
    xvec = (_chunk(plan.kc * es, plan.c * es, plan.pitch * es, x.data_ptr())
            if plan.mult == 1 else 0)
    wvec = _chunk(plan.kc * es, plan.k * es, w.data_ptr())
    ovec = 4 if plan.k % 4 == 0 and out.data_ptr() % (
        4 * out.element_size()) == 0 else 1
    return _dw_record(plan, xvec, wvec, ovec)


@functools.lru_cache(maxsize=512)
def _dw_record(plan: DwPlan, xvec: int, wvec: int, ovec: int
               ) -> ctypes.Array:
    vals = [int(v) for v in plan] + [xvec, wvec, ovec]
    return (ctypes.c_int * len(vals))(*vals)


def conv2d_ws_dw_emulate(x, w, bias=None, out_scale=None, *,
                         pipelined: bool = False, stride: int = 1,
                         padding="VALID", groups: int = 1,
                         cin_banks: int = 4, kout_banks: int = 4,
                         h_tile: int = 0, w_tile: int = 0,
                         relu: bool = False, pool: bool = False,
                         dilation: int = 1) -> torch.Tensor:
    """The dw kernels' order of sums replayed in plain PyTorch: each output
    channel k reads input channel k // (K/groups) of the zero-padded map;
    its sum starts at the bias and adds the taps in (dy, dx) order, one
    fused multiply-add a tap (in f32 the product is exact in float64 and
    the sum rounds to f32 once more, which differs from the card's FFMA
    only where the float64 sum lands on an f32 tie; int8 sums are exact);
    then the epilogue (ReLU → 2×2 max-pool → requantize).  The plan only
    validates: no block shape changes a value.  On any device; for the
    tests and ``chip_smoke.py`` only: the wrappers never call it."""
    int_path = _check_operands(x, w)
    g = setup_conv(tuple(x.shape), tuple(w.shape), stride=stride,
                   padding=padding, groups=groups, cin_banks=cin_banks,
                   kout_banks=kout_banks, h_tile=h_tile, w_tile=w_tile,
                   pool=pool, requant=out_scale is not None,
                   dilation=dilation, int_path=int_path)
    p = dw_plan(g, relu, pipelined)
    if p is None:
        raise ValueError(f"this geometry takes the {conv_path(g)} path "
                         f"(conv_path)")
    bias, scale, out_dtype = _operands(x, w, bias, out_scale, g)
    hp = halo_window(p.oh, p.stride, p.kh, p.dil)
    wpx = halo_window(p.ow, p.stride, p.kw, p.dil)
    xp = x.new_zeros((p.n, max(hp, p.pt + p.h), max(wpx, p.pl + p.w), p.c))
    xp[:, p.pt:p.pt + p.h, p.pl:p.pl + p.w] = x
    xk = xp.index_select(3, torch.arange(p.k, device=x.device) // p.mult)
    wk = w.reshape(p.kh, p.kw, p.k)
    wide = torch.int64 if int_path else torch.float64
    acc = bias.expand(p.n, p.oh, p.ow, p.k)
    for dy in range(p.kh):
        for dx in range(p.kw):
            y0, x0 = dy * p.dil, dx * p.dil
            xs = xk[:, y0:y0 + (p.oh - 1) * p.stride + 1:p.stride,
                    x0:x0 + (p.ow - 1) * p.stride + 1:p.stride]
            acc = (acc.to(wide) + xs.to(wide) * wk[dy, dx].to(wide)).to(
                acc.dtype)
    if p.relu:
        acc = acc.clamp(min=0)
    if p.pool:
        acc = acc.reshape(p.n, p.poh, 2, p.pow_, 2, p.k).amax(dim=(2, 4))
    if out_scale is not None:
        acc = ref.requantize_ref(acc, scale)
    return acc.to(out_dtype).contiguous()


# ---------------------------------------------------------------------------
# The narrow-output path, "nk" (csrc/conv_common.cuh: NkParams and the nk_*
# device functions): several input channels a group and fewer than 8
# outputs, int8 or f32.  A direct conv whose blocks are sized by geometry
# alone, so each output's sum (bias, then chunk by chunk, tap by tap in
# (dy, dx) order, channels ascending) does not depend on the caller's
# tiles or banks.
# ---------------------------------------------------------------------------

NK_SP = 4                 # conv-output pixels a thread's strip (kNkSP)
NK_KP = (1, 2, 3, 4, 8)   # outputs a group the kernels are built for
NK_RUNS = (1, 2, 4, 8)    # groups a block's run may take
NK_HALF_SM = SM_SMEM // 2 - 1024    # two slots under it: two blocks an SM

# Field order of ``NkParams`` in csrc/conv_common.cuh.
NK_FIELDS = ("n", "h", "w", "c", "k", "kh", "kw", "stride", "dil", "pt",
             "pl", "cgrp", "kgrp", "kp", "groups", "oh", "ow", "poh", "pow_",
             "relu", "pool", "rh", "rw", "n_ry", "n_rx", "gr", "n_gr", "rk",
             "cs", "cps", "n_chunks", "win_h", "win_w", "pps", "pitch",
             "wgs", "tpitch", "win_bytes", "slot_bytes", "slots", "smem",
             "n_rect", "xvec")


class NkPlan(NamedTuple):
    """One nk launch: every ``NkParams`` field but the window copy width,
    which depends on x's address (``nk_params``)."""
    n: int
    h: int
    w: int
    c: int
    k: int
    kh: int
    kw: int
    stride: int
    dil: int
    pt: int
    pl: int
    cgrp: int                 # input channels per group (> 1)
    kgrp: int                 # output channels per group (< 8)
    kp: int                   # kgrp padded to an instantiation (NK_KP)
    groups: int
    oh: int                   # conv-output extents (pool-trimmed)
    ow: int
    poh: int                  # epilogue output extents
    pow_: int
    relu: int
    pool: int
    rh: int                   # block rectangle of conv-output pixels:
    rw: int                   # rh·rw = active threads·NK_SP / gr, a power
                              # of two, pool-aligned
    n_ry: int                 # rectangles per image, down and across
    n_rx: int
    gr: int                   # groups a block's run (NK_RUNS)
    n_gr: int                 # runs: ⌈groups / gr⌉
    rk: int                   # outputs a run: gr·kgrp, contiguous in NHWC
    cs: int                   # input channels of a chunk (of each group)
    cps: int                  # cs rounded up to whole window vectors
                              # (``nk_cps``)
    n_chunks: int             # chunks a group: ⌈cgrp / cs⌉
    win_h: int                # halo'd input window of one rectangle
    win_w: int
    pps: int                  # elements a window pixel: gr·cps
    pitch: int                # elements a window row: win_w·pps + pad
    wgs: int                  # elements of one group's weight slab:
                              # taps·cps·kp, + 4 where that is even in fours
    tpitch: int               # accumulators a tile row: rw·rk + pad
    win_bytes: int            # window, 16-byte aligned; the weights
                              # [gr][wgs] follow it
    slot_bytes: int           # window + weights, 16-byte aligned
    slots: int                # 1 for conv2d_ws; min(2, n_chunks) for
                              # conv2d_ws_pipe's ring, 1 where two slots
                              # fit no block
    smem: int                 # max(slots·slot_bytes, accumulator tile)
    n_rect: int               # blocks: n · n_ry · n_rx · n_gr


def nk_cps(cs: int, int_path: bool) -> int:
    """Channels a group takes at a window pixel for a chunk of ``cs``: whole
    vectors of a lane's window read, four f32 channels (16 bytes), and in
    int8 4, 8 or 16 channels (up to 16 bytes, as many as the chunk holds),
    so 4, 8 or a multiple of 16."""
    if not int_path:
        return _round_up(cs, 4)
    return 4 if cs <= 4 else 8 if cs <= 8 else _round_up(cs, 16)


def nk_vector_bytes(cps: int, int_path: bool) -> int:
    """Bytes of a lane's window read (csrc ``VB``): 16 in f32; in int8 the
    group's channels at a pixel up to 16."""
    return 16 if not int_path else min(cps, 16)


def nk_thread(t: int, gr: int, rh: int) -> Tuple[int, int, int]:
    """Thread ``t``'s (group of the run, rectangle row, strip column) —
    csrc ``NkThread``: groups fastest, then rows, so a warp's strips lie in
    consecutive rows of one strip column."""
    u = t // gr
    return t % gr, u % rh, u // rh


@functools.lru_cache(maxsize=4096)
def nk_read_ways(int_path: bool, gr: int, rh: int, stride: int, pitch: int,
                 pps: int, cps: int, active: int = THREADS) -> int:
    """Wavefronts of a block's worst window read: a lane reads one vector
    of its group's channels at one pixel of its strip (``VB`` bytes:
    ``nk_vector_bytes``), and a wavefront serves 128 bytes, 128 / VB
    lanes."""
    es = 1 if int_path else 4
    vb = nk_vector_bytes(cps, int_path)
    lanes = 128 // vb
    ways = 1
    for warp in _warps(active):
        words = [(row * stride * pitch + col * NK_SP * stride * pps
                  + gi * cps) * es // 4
                 for gi, row, col in (nk_thread(t, gr, rh) for t in warp)]
        ways = max(ways, *(_ways([(w, vb // 4) for w in words[q:q + lanes]])
                           for q in range(0, len(words), lanes)))
    return ways


@functools.lru_cache(maxsize=4096)
def nk_write_ways(gr: int, rh: int, kgrp: int, tpitch: int,
                  active: int = THREADS) -> int:
    """Wavefronts of a block's worst accumulator-tile write: a lane stores
    one accumulator of its group at one pixel (4-byte stores)."""
    ways = 1
    for warp in _warps(active):
        ways = max(ways, _ways([(row * tpitch + col * NK_SP * gr * kgrp
                                 + gi * kgrp, 1)
                                for gi, row, col in (nk_thread(t, gr, rh)
                                                     for t in warp)]))
    return ways


def _nk_min_slot(g: ConvGeom, gr: int, kp: int, cs: int, rh: int,
                 rw: int) -> int:
    """A lower bound of ``_nk_window``'s slot bytes (no padding)."""
    es = 1 if g.int_path else 4
    cps = nk_cps(cs, g.int_path)
    return (halo_window(rh, g.stride, g.kh, g.dilation)
            * halo_window(rw, g.stride, g.kw, g.dilation) * gr * cps * es
            + gr * g.kh * g.kw * cps * kp * es)


def _nk_window(g: ConvGeom, gr: int, kp: int, cs: int, rh: int, rw: int,
               active: int):
    """(cps, win_h, win_w, pps, pitch, wgs, win_bytes, slot_bytes) of a
    chunk of ``cs`` channels over a block rectangle: the window row pitch
    padded by the least (a lane's window vector at a time, so that rows
    stay aligned to it) that makes the block's window reads the fewest
    wavefronts."""
    es = 1 if g.int_path else 4
    cps = nk_cps(cs, g.int_path)
    pps = gr * cps
    win_h = halo_window(rh, g.stride, g.kh, g.dilation)
    win_w = halo_window(rw, g.stride, g.kw, g.dilation)
    vec = nk_vector_bytes(cps, g.int_path) // es
    pitch = _least_ways(win_w * pps, range(0, 32 * vec, vec),
                        lambda pt_: nk_read_ways(g.int_path, gr, rh,
                                                 g.stride, pt_, pps, cps,
                                                 active))
    # a group's slab odd in fours, so that a run's groups read their
    # weights on distinct banks
    wgs = g.kh * g.kw * cps * kp
    wgs += 4 * (wgs // 4 % 2 == 0)
    win_bytes = _align16(win_h * pitch * es)
    return (cps, win_h, win_w, pps, pitch, wgs, win_bytes,
            win_bytes + _align16(gr * wgs * es))


def _nk_rect(g: ConvGeom, pool: bool, oh: int, ow: int, gr: int, kp: int,
             active: int, need: int):
    """(rh, rw) of the rectangle of ``active / gr`` strips whose window of
    a chunk of (at most) 4 channels fits ``need`` times in a block's shared
    memory and that pads the map least, then whose halo'd window is
    smallest, then the widest; None where no rectangle fits."""
    strips = active // gr
    cs = min(g.cgrp, 4)
    best = None
    for rh in (1 << a for a in range(9) if (1 << a) <= strips):
        rw = NK_SP * strips // rh
        if pool and rh % 2:
            continue
        if (need * _nk_min_slot(g, gr, kp, cs, rh, rw) > SMEM_BYTES
                or need * _nk_window(g, gr, kp, cs, rh, rw, active)[-1]
                > SMEM_BYTES):
            continue
        area = -(-oh // rh) * rh * -(-ow // rw) * rw
        key = (area, halo_window(rh, g.stride, g.kh, g.dilation)
               * halo_window(rw, g.stride, g.kw, g.dilation), -rw)
        if best is None or key < best[0]:
            best = (key, rh, rw)
    return best and best[1:]


def _nk_chunk(g: ConvGeom, gr: int, kp: int, rh: int, rw: int,
              active: int, need: int) -> int:
    """Channels of a chunk: the whole group where ``need`` slots fit under
    half an SM's shared memory (two blocks an SM); else as many chunks as
    the widest fitting whole number of window vectors needs (f32: fours;
    int8: sixteens, then 8 and 4), their channels spread evenly (rounded
    up the same way); failing half an SM, the same under a block's
    limit."""
    def slot(cs):
        return _nk_window(g, gr, kp, cs, rh, rw, active)[-1]

    step = 16 if g.int_path else 4
    cands = [g.cgrp] + [c for c in range(_round_up(g.cgrp, step) - step, 0,
                                         -step)]
    if g.int_path:
        cands += [c for c in (8, 4) if c < g.cgrp]
    for budget in (NK_HALF_SM, SMEM_BYTES):
        widest = next((cs for cs in cands
                       if need * _nk_min_slot(g, gr, kp, cs, rh, rw)
                       <= budget and need * slot(cs) <= budget), None)
        if widest is not None:
            chunks = -(-g.cgrp // widest)
            even = (g.cgrp if chunks == 1
                    else _round_up(-(-g.cgrp // chunks), min(step, widest)))
            return even if need * slot(even) <= budget else widest
    raise AssertionError("no chunk fits the rectangle _nk_rect chose")


@functools.lru_cache(maxsize=512)
def _nk_plan(g: ConvGeom, relu: bool, pipelined: bool) -> Optional[NkPlan]:
    pool = _pooled(g)
    groups = g.c // g.cgrp
    kgrp = g.k // groups
    kp = next(v for v in NK_KP if v >= kgrp)
    pref = min(NK_RUNS, key=lambda r: (-(-groups // r) * r, -r))
    oh, ow = (2 * g.poh, 2 * g.pow_) if pool else (g.poh, g.pow_)
    # every thread owning a strip where a window of 4 channels fits twice,
    # the preferred run of groups first, then shorter runs; only where none
    # fits, half the threads, and so on; only where two never fit, one
    # (the pipe's ring then has one slot)
    found = next(((need, active, gr, rect)
                  for need in (2, 1)
                  for active in (THREADS >> a for a in range(9))
                  for gr in sorted(NK_RUNS, reverse=True)
                  if gr <= min(pref, active)
                  for rect in [_nk_rect(g, pool, oh, ow, gr, kp, active,
                                        need)]
                  if rect), None)
    if found is None:
        return None
    need, active, gr, (rh, rw) = found
    cs = _nk_chunk(g, gr, kp, rh, rw, active, need)
    cps, win_h, win_w, pps, pitch, wgs, win_bytes, slot_bytes = _nk_window(
        g, gr, kp, cs, rh, rw, active)
    n_chunks = -(-g.cgrp // cs)
    rk = gr * kgrp
    tpitch = _least_ways(rw * rk, range(32),
                         lambda tp: nk_write_ways(gr, rh, kgrp, tp, active))
    slots = min(need, n_chunks) if pipelined else 1
    n_ry, n_rx, n_gr = -(-oh // rh), -(-ow // rw), -(-groups // gr)
    return NkPlan(
        n=g.n, h=g.h, w=g.w, c=g.c, k=g.k, kh=g.kh, kw=g.kw,
        stride=g.stride, dil=g.dilation, pt=g.pt, pl=g.pl, cgrp=g.cgrp,
        kgrp=kgrp, kp=kp, groups=groups, oh=oh, ow=ow, poh=g.poh,
        pow_=g.pow_, relu=int(relu), pool=int(pool), rh=rh, rw=rw,
        n_ry=n_ry, n_rx=n_rx, gr=gr, n_gr=n_gr, rk=rk, cs=cs, cps=cps,
        n_chunks=n_chunks, win_h=win_h, win_w=win_w, pps=pps, pitch=pitch,
        wgs=wgs, tpitch=tpitch, win_bytes=win_bytes, slot_bytes=slot_bytes,
        slots=slots, smem=max(slots * slot_bytes,
                              _align16(rh * tpitch * 4)),
        n_rect=g.n * n_ry * n_rx * n_gr)


def nk_plan(g: ConvGeom, relu: bool = False,
            pipelined: bool = False) -> Optional[NkPlan]:
    """The nk launch plan of ``g``, or None where ``conv_path`` sends it
    elsewhere (one input channel a group, or 8 or more outputs, or a
    window no block holds: see below).  Deterministic in the geometry,
    whatever the caller's banks and tiles:

    * a block of 256 threads computes a pool-aligned rectangle of
      conv-output pixels of one image for a run of ``gr`` groups (1, 2, 4
      or 8: the run that pads the group count least, then the widest);
    * a thread owns one group of the run and a strip of ``NK_SP`` pixels
      along a rectangle row, with all ``kgrp`` outputs of the group in
      registers (``kp`` of them: the instantiation); the rectangle has
      256 / gr strips — the shape that pads the map least, then whose
      halo'd window is smallest, then the widest — and where no window of
      4 channels over that many strips fits twice in shared memory, the
      run shortens (8, 4, 2, 1 groups), then the first 128, 64, …
      threads own strips and the others only copy and store;
    * the group's channels go in chunks of ``cs``: the whole group where
      two slots (window and weights) fit under half an SM's shared memory,
      else the fewest chunks that do (or that fit a block's limit), their
      channels spread evenly in fours; the window and tile row pitches
      are padded so that a warp's shared-memory reads and writes take the
      fewest wavefronts;
    * ``conv2d_ws`` loads each chunk and then computes it;
      ``conv2d_ws_pipe`` streams the chunks through a 2-slot ring (one
      slot where there is one chunk).

    Only where no rectangle holds two slots of a chunk of 4 channels does
    the same search run for one slot: the pipe's ring then has one slot
    and moves data as ``conv2d_ws`` does.  Where not even one fits, the
    plan is None and the layer runs the scalar kernel (``scalar_tiles``,
    which raises where its smallest tile overflows too).

    The two wrappers' plans differ in ``slots`` and ``smem`` only, and f32
    sums run bias, then chunk by chunk, tap by tap, channels ascending, so
    both kernels give the same bits."""
    if g.cgrp == 1 or g.k // (g.c // g.cgrp) >= GEMM_MIN_KGRP:
        return None
    return _nk_plan(g, bool(relu), bool(pipelined))


def nk_params(plan: NkPlan, x: torch.Tensor) -> ctypes.Array:
    """The ``NkParams`` record of one launch, as a C int array: the plan
    and the widest window copy (16, 8 or 4 bytes a ``cp.async``) dividing
    the chunk, the group, the map's pixel, the padded chunk, the window
    pixel and row and x's address; 0 (int8 only) gathers words byte by
    byte."""
    es = x.element_size()
    xvec = _chunk(plan.cs * es, plan.cgrp * es, plan.c * es, plan.cps * es,
                  plan.pps * es, plan.pitch * es, x.data_ptr())
    return _nk_record(plan, xvec)


@functools.lru_cache(maxsize=512)
def _nk_record(plan: NkPlan, xvec: int) -> ctypes.Array:
    vals = [int(v) for v in plan] + [xvec]
    return (ctypes.c_int * len(vals))(*vals)


def fma_f32(acc: torch.Tensor, x: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """``fmaf(x, w, acc)`` elementwise on f32 tensors, rounded once as the
    card's FFMA rounds: the product is exact in float64, the float64 sum's
    rounding error is recovered exactly (TwoSum), and where the float64
    sum lands on a midpoint of two f32 values that error picks the side
    the exact sum lies on (elsewhere rounding the float64 sum to f32 is
    rounding the exact one)."""
    a, p = acc.double(), x.double() * w.double()
    s = a + p
    bp = s - a
    err = (a - (s - bp)) + (p - bp)
    r = s.float()
    d = s - r.double()
    toward = torch.where(d > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    nb = torch.nextafter(r, toward)
    tie = (d != 0) & (err != 0) & (s == (r.double() + nb.double()) / 2)
    return torch.where(tie, torch.where(err > 0, torch.maximum(r, nb),
                                        torch.minimum(r, nb)), r)


def conv2d_ws_nk_emulate(x, w, bias=None, out_scale=None, *,
                         pipelined: bool = False, stride: int = 1,
                         padding="VALID", groups: int = 1,
                         cin_banks: int = 4, kout_banks: int = 4,
                         h_tile: int = 0, w_tile: int = 0,
                         relu: bool = False, pool: bool = False,
                         dilation: int = 1) -> torch.Tensor:
    """The nk kernels' order of sums replayed in plain PyTorch, from the
    same ``nk_plan``: each output of group g reads that group's channels
    of the zero-padded map; int8 sums are exact in any order (the kernels'
    ``__dp4a`` by fours); an f32 sum starts at the bias and adds, chunk by
    chunk, tap by tap in (dy, dx) order, the chunk's channels ascending,
    one FFMA each (``fma_f32``, rounded as the card rounds it), a
    zero-filled channel past the group adding +0; then the epilogue (ReLU
    → 2×2 max-pool → requantize).  No block shape changes a value, so the
    plan's blocks are not replayed.  On any device; for the tests and
    ``chip_smoke.py`` only: the wrappers never call it."""
    int_path = _check_operands(x, w)
    g = setup_conv(tuple(x.shape), tuple(w.shape), stride=stride,
                   padding=padding, groups=groups, cin_banks=cin_banks,
                   kout_banks=kout_banks, h_tile=h_tile, w_tile=w_tile,
                   pool=pool, requant=out_scale is not None,
                   dilation=dilation, int_path=int_path)
    p = nk_plan(g, relu, pipelined)
    if p is None:
        raise ValueError(f"this geometry takes the {conv_path(g)} path "
                         f"(conv_path)")
    bias, scale, out_dtype = _operands(x, w, bias, out_scale, g)
    hp = halo_window(p.oh, p.stride, p.kh, p.dil)
    wpx = halo_window(p.ow, p.stride, p.kw, p.dil)
    xp = x.new_zeros((p.n, max(hp, p.pt + p.h), max(wpx, p.pl + p.w), p.c))
    xp[:, p.pt:p.pt + p.h, p.pl:p.pl + p.w] = x
    xg = xp.reshape(*xp.shape[:3], p.groups, p.cgrp)
    wg = w.reshape(p.kh, p.kw, p.cgrp, p.groups, p.kgrp)

    def window(dy, dx):     # [N, OH, OW, groups, cgrp] of tap (dy, dx)
        y0, x0 = dy * p.dil, dx * p.dil
        return xg[:, y0:y0 + (p.oh - 1) * p.stride + 1:p.stride,
                  x0:x0 + (p.ow - 1) * p.stride + 1:p.stride]

    acc = bias.reshape(p.groups, p.kgrp).expand(p.n, p.oh, p.ow, p.groups,
                                                p.kgrp)
    taps = [(dy, dx) for dy in range(p.kh) for dx in range(p.kw)]
    if int_path:
        acc = acc.to(torch.int64)
        for dy, dx in taps:
            prod = (window(dy, dx).to(torch.int64)[..., None]
                    * wg[dy, dx].permute(1, 0, 2).to(torch.int64))
            acc = acc + prod.sum(-2)
        acc = acc.to(torch.int32)
    else:
        for s in range(p.n_chunks):
            for dy, dx in taps:
                xs, wv = window(dy, dx), wg[dy, dx]
                for c in range(p.cps):
                    cc = s * p.cs + c
                    if c < p.cs and cc < p.cgrp:
                        acc = fma_f32(acc, xs[..., cc:cc + 1], wv[cc])
                    else:           # zero-filled: fma(0, 0, acc)
                        acc = acc + 0.0
    acc = acc.reshape(p.n, p.oh, p.ow, p.k)
    if p.relu:
        acc = acc.clamp(min=0)
    if p.pool:
        acc = acc.reshape(p.n, p.poh, 2, p.pow_, 2, p.k).amax(dim=(2, 4))
    if out_scale is not None:
        acc = ref.requantize_ref(acc, scale)
    return acc.to(out_dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _entry(lib_name: str, suffix: str, pointers: int = 5):
    fn = getattr(_build.load(lib_name), f"{lib_name}{suffix}")
    fn.argtypes = [ctypes.c_void_p] * pointers + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=512)
def _launch_setup(x_shape, w_shape, int_path: bool, requant: bool,
                  relu: bool, pool: bool, pipelined: bool, geo: tuple):
    """(ConvGeom, TcPlan, SimtPlan, DwPlan, NkPlan or None) of one launch,
    cached per call signature: the served network asks for the same few
    every batch.  The validation is ``setup_conv``'s; a geometry it refuses
    raises on every call.  On the scalar path (plan None) the geometry
    carries the tiles ``scalar_tiles`` fits into a block's shared
    memory."""
    g = setup_conv(x_shape, w_shape, pool=pool, requant=requant,
                   int_path=int_path, **dict(geo))
    plan = ((tc_plan if int_path else simt_plan)(g, relu, pipelined)
            or dw_plan(g, relu, pipelined) or nk_plan(g, relu, pipelined))
    if plan is None:
        g = scalar_tiles(g, 2 if pipelined else 1)
    return g, plan


def launch_conv(lib_name: str, pipelined: bool, x, w, bias, out_scale,
                g: ConvGeom, plan, relu: bool, pool: bool
                ) -> Tuple[torch.Tensor, str]:
    """Launch one of the two conv kernels on PyTorch's current stream: on
    the tensor-core path where ``plan`` is a ``TcPlan``, on the simt path
    where it is a ``SimtPlan`` (with the K slices' partial sums in a
    scratch tensor where it splits K), on the dw path where it is a
    ``DwPlan``, on the nk path where it is an ``NkPlan``, else on the
    scalar path, whose ``g`` fits a block's shared memory
    (``scalar_tiles``) → (result, "tc", "simt", "dw", "nk" or
    "scalar")."""
    x = x.contiguous()
    bias, scale, out_dtype = _operands(x, w, bias, out_scale, g)
    out = torch.empty((g.n, g.poh, g.pow_, g.k), dtype=out_dtype,
                      device=x.device)
    # the raw handle: torch.cuda.current_stream() builds a Stream object
    # every call
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    if isinstance(plan, DwPlan):
        w = w.contiguous()
        params = dw_params(plan, x, w, out)
        _build.check(lib_name, _entry(lib_name, "_dw_launch")(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            out.data_ptr(), params, len(params), _mode(g), stream))
        return out, "dw"
    if isinstance(plan, NkPlan):
        w = w.contiguous()
        params = nk_params(plan, x)
        _build.check(lib_name, _entry(lib_name, "_nk_launch")(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            out.data_ptr(), params, len(params), _mode(g), stream))
        return out, "nk"
    if isinstance(plan, SimtPlan):
        w = w.contiguous()
        part = (torch.empty((plan.split, plan.n, plan.oh, plan.ow, plan.k),
                            dtype=torch.float32, device=x.device)
                if plan.split > 1 else None)
        params = simt_params(plan, w)
        _build.check(lib_name, _entry(lib_name, "_simt_launch", 6)(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), scale.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            params, len(params), _mode(g), stream))
        return out, "simt"
    if plan is None:
        w = w.contiguous()
        fn, params = _entry(lib_name, "_launch"), conv_params(g, x, w, relu,
                                                              pool)
    else:
        w = pack_weights(w)
        fn, params = _entry(lib_name, "_tc_launch"), tc_params(plan, x, w)
    _build.check(lib_name, fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                              scale.data_ptr(), out.data_ptr(), params,
                              len(params), _mode(g), stream))
    return out, "scalar" if plan is None else "tc"


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


def run_conv(lib_name: str, pipelined: bool, plain, x, w, bias, out_scale,
             *, relu: bool, pool: bool, stride: int, padding, groups: int,
             cin_banks: int, kout_banks: int, h_tile: int, w_tile: int,
             dilation: int) -> torch.Tensor:
    """Shared body of the two conv wrappers: the op ``repro_torch::<lib_name>``
    (``conv2d_ws_pipe``'s where ``pipelined``) on the padding resolved
    against x's extents, or ``plain`` directly for a CPU call that autograd
    records.  A CUDA call that autograd records raises, as does a tensor on
    neither a CUDA device nor the CPU."""
    from repro_torch.kernels.ops import _recorded
    if x.device.type == "cpu":
        if _recorded(x, w, bias):
            return plain(x, w, bias, out_scale, relu=relu, pool=pool,
                         stride=stride, padding=padding, groups=groups,
                         cin_banks=cin_banks, kout_banks=kout_banks,
                         h_tile=h_tile, w_tile=w_tile, dilation=dilation)
    elif not x.is_cuda:
        raise ValueError(f"{lib_name} runs on a CUDA or CPU tensor, "
                         f"got {x.device}")
    elif _recorded(x, w, bias):
        raise RuntimeError(
            f"{lib_name} has no backward: differentiate a float conv "
            f"through kernels.ops.conv2d (its Function runs the kernels' "
            f"backward), or call it under torch.no_grad()")
    (pt, pb), (pl_, pr) = normalize_padding(
        padding, w.shape[0], w.shape[1], stride, x.shape[1], x.shape[2],
        dilation)
    scale = value = None
    if isinstance(out_scale, (int, float)):
        value = float(out_scale)        # filled on the device at launch
    elif out_scale is not None:
        scale = torch.as_tensor(out_scale, dtype=torch.float32,
                                device=x.device)
    return _CONV_OPS[pipelined](
        x, w, bias, scale, value, stride, [pt, pb, pl_, pr], groups,
        dilation, cin_banks, kout_banks, h_tile, w_tile, bool(relu),
        bool(pool))


# the paths a conv wrapper counts by name, ``<path>_launches``
CONV_PATHS = ("tc", "simt", "dw", "nk", "scalar")


def count_launch(fn, path: str) -> None:
    """Count a launch on the wrapper ``fn``: ``launches`` every one, and
    ``<path>_launches`` (``tc_launches``, ``simt_launches``,
    ``dw_launches``, ``nk_launches``, ``scalar_launches``) those of its
    path."""
    fn.launches += 1
    setattr(fn, f"{path}_launches", getattr(fn, f"{path}_launches") + 1)


def reset_launches(fn) -> None:
    """Set a conv wrapper's counters to 0: ``launches`` and one a path."""
    fn.launches = 0
    for path in CONV_PATHS:
        setattr(fn, f"{path}_launches", 0)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_SCHEMA = ("(Tensor x, Tensor w, Tensor? bias, Tensor? scale, "
           "float? scale_value, int stride, int[] padding, int groups, "
           "int dilation, int cin_banks, int kout_banks, int h_tile, "
           "int w_tile, bool relu, bool pool) -> Tensor")
# pipelined → the op the wrapper calls
_CONV_OPS: Dict[bool, object] = {}


def _op_args(scale, value, stride, padding, groups, dilation, cin_banks,
             kout_banks, h_tile, w_tile, relu, pool):
    """The op's arguments after x, w and bias → (the requantize scale: the
    tensor ``scale``, else the float ``value``, else None; the geometry as
    ``setup_conv``'s keywords, ``padding`` (top, bottom, left, right) made
    pairs; relu; pool)."""
    geo = dict(stride=stride, padding=((padding[0], padding[1]),
                                       (padding[2], padding[3])),
               groups=groups, dilation=dilation, cin_banks=cin_banks,
               kout_banks=kout_banks, h_tile=h_tile, w_tile=w_tile)
    return value if scale is None else scale, geo, relu, pool


def _plain_kernel(x, w, bias, *args):
    """Both ops' CPU kernel: the plain version."""
    out_scale, geo, relu, pool = _op_args(*args)
    return conv2d_ws_plain(x, w, bias, out_scale, relu=relu, pool=pool,
                           **geo)


def _fake_kernel(x, w, bias, *args):
    """Both ops' fake kernel: the output's shape and dtype, after
    ``setup_conv``'s validation."""
    out_scale, geo, _, pool = _op_args(*args)
    int_path = _check_operands(x, w)
    g = setup_conv(tuple(x.shape), tuple(w.shape), pool=pool,
                   requant=out_scale is not None, int_path=int_path, **geo)
    return x.new_empty((g.n, g.poh, g.pow_, g.k), dtype=(
        torch.int8 if g.requant else
        torch.int32 if int_path else torch.float32))


def _cuda_kernel(name: str, pipelined: bool, wrapper):
    """The CUDA kernel of the op ``name``: launch ``csrc/<name>.cu`` and
    count the launch on ``wrapper``."""
    def kernel(x, w, bias, *args):
        out_scale, geo, relu, pool = _op_args(*args)
        g, plan = _launch_setup(tuple(x.shape), tuple(w.shape),
                                _check_operands(x, w), out_scale is not None,
                                relu, pool, pipelined,
                                tuple(geo.items()))
        out, path = launch_conv(name, pipelined, x, w, bias, out_scale, g,
                                plan, relu, pool)
        count_launch(wrapper, path)
        return out
    return kernel


def conv_flops(x_shape, w_shape, bias, scale, value, stride, padding,
               groups, dilation, *args, **kwargs) -> int:
    """The conv ops' FLOP formula, ``2·N·OH·OW·K·(C/groups)·KH·KW`` with
    OH, OW the conv's output before pooling: the multiply-adds.  Bias,
    ReLU, pool and requantize count none, as ``matmul_ws``'s bias counts
    none.  A transposed conv counts what its host lowering launches, the
    stride-1 conv of the zero-inserted map."""
    kh, kw, cgrp, k = w_shape
    oh, ow = conv_out_shape(x_shape[1], x_shape[2], kh, kw, stride,
                            ((padding[0], padding[1]),
                             (padding[2], padding[3])), dilation)
    return 2 * x_shape[0] * oh * ow * k * cgrp * kh * kw


def define_conv_op(name: str, pipelined: bool, wrapper) -> None:
    """Define ``repro_torch::<name>`` (one of the two conv kernels) with its
    CPU, CUDA and fake kernels and ``conv_flops``; ``run_conv`` calls it
    where ``pipelined`` says."""
    _LIB.define(name + _SCHEMA)
    _LIB.impl(name, _plain_kernel, "CPU")
    _LIB.impl(name, _cuda_kernel(name, pipelined, wrapper), "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", _fake_kernel,
                                lib=_LIB)
    packet = getattr(torch.ops.repro_torch, name)
    torch.utils.flop_counter.register_flop_formula(packet)(conv_flops)
    _CONV_OPS[pipelined] = packet.default


def conv2d_ws(x, w, bias=None, out_scale=None, *, stride: int = 1,
              padding="VALID", groups: int = 1, cin_banks: int = 4,
              kout_banks: int = 4, h_tile: int = 0, w_tile: int = 0,
              relu: bool = False, pool: bool = False,
              dilation: int = 1) -> torch.Tensor:
    """Paper-dataflow convolution: x [N,H,W,C] ⊛ w [KH,KW,C/groups,K]
    (+bias [K]) → [N,OH',OW',K]; int32 out for int8 in, f32 for f32 in, int8
    whenever ``out_scale`` (scalar or [K]) requantizes.  Epilogue order:
    ``relu`` → ``pool`` (2×2/2, floor) → requantize.  ``h_tile``/``w_tile``
    are conv-output tile extents (0 = whole map; pool-aligned when pooling):
    validated, and followed by the scalar kernel where they fit a block's
    shared memory (else it picks its own, ``scalar_tiles``, with the same
    values); the tensor-core, simt, dw and nk paths size their blocks for
    the card.

    Calls the op ``repro_torch::conv2d_ws``: on a CUDA tensor it launches
    ``csrc/conv2d_ws.cu``, on a CPU tensor it runs ``conv2d_ws_plain`` (see
    the module note)."""
    return run_conv(
        "conv2d_ws", False, conv2d_ws_plain, x, w, bias, out_scale,
        relu=relu, pool=pool, stride=stride, padding=padding, groups=groups,
        cin_banks=cin_banks, kout_banks=kout_banks, h_tile=h_tile,
        w_tile=w_tile, dilation=dilation)


reset_launches(conv2d_ws)
define_conv_op("conv2d_ws", False, conv2d_ws)
