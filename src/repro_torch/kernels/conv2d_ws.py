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
* ``conv_path`` — the path rule: int8 layers whose per-group output width
  K/groups is at least 8 run the int8 tensor-core implicit GEMM ("tc");
  f32 layers and narrower int8 groups (depthwise) run the scalar kernel
  ("scalar");
* ``tc_plan`` / ``pack_weights`` — the tensor-core path's launch plan (block
  rectangles, N-tile, K-chunks, shared-memory layout) and its K-major
  weights; ``conv2d_ws_tc_emulate`` replays that plan in plain PyTorch, block
  by block, for the CPU tests;
* ``conv2d_ws_plain`` — the plain PyTorch version of the same function;
* ``conv2d_ws`` — the wrapper: on a CUDA tensor it launches the kernel (and
  counts the launch in ``conv2d_ws.launches``, and in
  ``conv2d_ws.tc_launches`` when it took the tensor-core path), on a CPU
  tensor it takes the plain version.

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
TC_MIN_KGRP = 8           # narrowest group output width on the tensor cores
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
    if not g.int_path or g.k // (g.c // g.cgrp) < TC_MIN_KGRP:
        return None
    for bn in (None, 32):
        plan = _tc_plan(g, relu, pipelined, bn)
        if _tc_plan(g, relu, False, plan.bn).smem <= SMEM_BYTES:
            return plan
    return None


def conv_path(g: ConvGeom) -> str:
    """The path rule: "tc" — int8 operands, K/groups ≥ 8 and one K-chunk's
    window and weight slab within a block's shared memory — runs the int8
    tensor-core implicit GEMM; anything else ("scalar": f32, depthwise and
    other groups narrower than 8 outputs) runs PR 11's scalar kernel."""
    return "tc" if tc_plan(g) is not None else "scalar"


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


@functools.lru_cache(maxsize=None)
def _entry(lib_name: str, suffix: str):
    fn = getattr(_build.load(lib_name), f"{lib_name}{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _frozen(v):
    """``v`` with its lists made tuples, so a padding spec can key a
    cache."""
    return tuple(map(_frozen, v)) if isinstance(v, (list, tuple)) else v


@functools.lru_cache(maxsize=512)
def _launch_setup(x_shape, w_shape, int_path: bool, requant: bool,
                  relu: bool, pool: bool, pipelined: bool, geo: tuple):
    """(ConvGeom, TcPlan or None) of one launch, cached per call signature:
    the served network asks for the same few every batch.  The validation
    is ``setup_conv``'s; a geometry it refuses raises on every call.  On
    the scalar path the geometry carries the tiles ``scalar_tiles`` fits
    into a block's shared memory."""
    g = setup_conv(x_shape, w_shape, pool=pool, requant=requant,
                   int_path=int_path, **dict(geo))
    plan = tc_plan(g, relu, pipelined)
    if plan is None:
        g = scalar_tiles(g, 2 if pipelined else 1)
    return g, plan


def launch_conv(lib_name: str, pipelined: bool, x, w, bias, out_scale,
                g: ConvGeom, plan: Optional[TcPlan], relu: bool, pool: bool
                ) -> Tuple[torch.Tensor, str]:
    """Launch one of the two conv kernels on PyTorch's current stream, on
    the tensor-core path where ``plan`` is given (``tc_plan``), else on the
    scalar path, whose ``g`` fits a block's shared memory (``scalar_tiles``)
    → (result, "tc" or "scalar")."""
    x = x.contiguous()
    bias, scale, out_dtype = _operands(x, w, bias, out_scale, g)
    out = torch.empty((g.n, g.poh, g.pow_, g.k), dtype=out_dtype,
                      device=x.device)
    if plan is None:
        w = w.contiguous()
        fn, params = _entry(lib_name, "_launch"), conv_params(g, x, w, relu,
                                                              pool)
    else:
        w = pack_weights(w)
        fn, params = _entry(lib_name, "_tc_launch"), tc_params(plan, x, w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
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
             *, relu: bool, pool: bool, **geo
             ) -> Tuple[torch.Tensor, Optional[str]]:
    """Shared body of the two conv wrappers → (result, path): the plain
    version for a CPU tensor (path None), the kernel for a CUDA tensor
    (path "tc" or "scalar", as ``conv_path`` rules)."""
    if x.device.type == "cpu":
        return plain(x, w, bias, out_scale, relu=relu, pool=pool, **geo), None
    if not x.is_cuda:
        raise ValueError(f"{lib_name} runs on a CUDA or CPU tensor, "
                         f"got {x.device}")
    g, plan = _launch_setup(
        tuple(x.shape), tuple(w.shape), _check_operands(x, w),
        out_scale is not None, bool(relu), bool(pool), pipelined,
        tuple(sorted((k, _frozen(v)) for k, v in geo.items())))
    return launch_conv(lib_name, pipelined, x, w, bias, out_scale, g, plan,
                       relu, pool)


def count_launch(fn, path: Optional[str]) -> None:
    """Count a launch on the wrapper ``fn``: ``launches`` every one,
    ``tc_launches`` those of the tensor-core path."""
    if path is not None:
        fn.launches += 1
        fn.tc_launches += path == "tc"


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
    values); the tensor-core path sizes its blocks for the card.

    On a CUDA tensor this launches ``csrc/conv2d_ws.cu``; on a CPU tensor it
    runs ``conv2d_ws_plain``."""
    out, path = run_conv(
        "conv2d_ws", False, conv2d_ws_plain, x, w, bias, out_scale,
        relu=relu, pool=pool, stride=stride, padding=padding, groups=groups,
        cin_banks=cin_banks, kout_banks=kout_banks, h_tile=h_tile,
        w_tile=w_tile, dilation=dilation)
    count_launch(conv2d_ws, path)
    return out


conv2d_ws.launches = 0
conv2d_ws.tc_launches = 0
