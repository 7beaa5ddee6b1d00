"""Joint spatial-tile × channel-bank planner (counterpart of
``repro.core.banking``), sized for Hopper shared memory.

The paper's image BRAMs are fixed-size: maps stream through a bounded
window.  On the TPU that window was VMEM; on the H100 it is a block's
shared memory, at most ``SMEM_BYTES`` (232,448 bytes of dynamic shared
memory).  A layer pass's working set is

    2 × (halo'd image block + weight block + epilogue output block)
      + accumulator

which bounds both conv kernels: ``conv2d_ws`` holds one image and weight
block beside the accumulator, ``conv2d_ws_pipe`` two of each (its ring).

``plan_tiles`` is the reference's greedy descent unchanged: from the
paper's 4×4 banking and the whole map as one tile it applies whichever
legal move (halve a tile dimension, keeping it pool-aligned; double a bank
count, keeping kout banks on group boundaries) shrinks the working set
most, until the plan fits or nothing shrinks.  Given the same budget it
yields field-for-field the reference's plans.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.core import perfmodel
from repro_torch.kernels.ref import (check_groups, conv_out_shape,
                                     dilated_extent, divisor_banks,
                                     grouped_banks, halo_window,
                                     normalize_padding)

SMEM_BYTES = 232_448     # Hopper: dynamic shared memory one block may use

__all__ = ["SMEM_BYTES", "TilePlan", "plan_tiles", "divisor_banks",
           "grouped_banks"]


@dataclass(frozen=True)
class TilePlan:
    """A joint (spatial tile × channel bank) decomposition of one conv
    layer.  ``h_tile``/``w_tile`` are conv-output tile extents (pre-pool);
    ``in_h_tile``/``in_w_tile`` the halo'd input windows they consume.
    Byte fields are per-block buffers (see the module docstring)."""
    cin_banks: int
    kout_banks: int
    h_tile: int
    w_tile: int
    n_h_tiles: int
    n_w_tiles: int
    in_h_tile: int                    # (h_tile-1)·stride + dilation·(kh-1)+1
    in_w_tile: int
    image_block_bytes: int            # halo'd input window × cb × in_bytes
    weight_block_bytes: int
    acc_block_bytes: int              # accumulator (acc dtype)
    output_block_bytes: int           # epilogue output block (out dtype)
    stride: int = 1
    out_h: int = 0                    # whole-map conv output (pool-floored)
    out_w: int = 0
    pool: bool = False
    in_bytes: int = 1
    budget: int = SMEM_BYTES
    groups: int = 1                   # kout banks stay inside group bounds
    pipelined: bool = False           # run on conv2d_ws_pipe

    @property
    def working_set_bytes(self) -> int:
        # the ×2 is the ping-pong pair of conv2d_ws_pipe's ring; the
        # accumulator is one persistent buffer
        return (2 * (self.image_block_bytes + self.weight_block_bytes
                     + self.output_block_bytes) + self.acc_block_bytes)

    @property
    def fits_smem(self) -> bool:
        return self.working_set_bytes <= self.budget

    @property
    def n_tiles(self) -> int:
        return self.n_h_tiles * self.n_w_tiles

    @property
    def tiled(self) -> bool:
        return self.n_tiles > 1

    @property
    def halo_read_factor(self) -> float:
        """Input bytes read with tiling ÷ the whole-map input bytes for one
        full kout sweep (≥ 1: halo re-reads and zero extension)."""
        kh = self.in_h_tile - (self.h_tile - 1) * self.stride
        kw = self.in_w_tile - (self.w_tile - 1) * self.stride
        whole = (halo_window(self.out_h, self.stride, kh)
                 * halo_window(self.out_w, self.stride, kw))
        tiled = self.n_tiles * self.in_h_tile * self.in_w_tile
        return tiled / whole if whole else 1.0


def _align_tile(v: int, pool: bool) -> int:
    if pool:
        return max(2, -(-v // 2) * 2)
    return max(1, v)


def plan_tiles(h: int, w: int, c: int, k: int, kh: int = 3, kw: int = 3, *,
               stride: int = 1, padding="VALID", pool: bool = False,
               groups: int = 1, dilation: int = 1, in_bytes: int = 1,
               acc_bytes: int = 4, out_bytes: Optional[int] = None,
               cin_banks: int = 4, kout_banks: int = 4,
               smem_budget: Optional[int] = SMEM_BYTES,
               kernel: str = "auto") -> TilePlan:
    """Jointly choose (h_tile, w_tile, cin_banks, kout_banks) so the
    working set fits ``smem_budget`` (None: whole map, one tile).

    ``kernel``: ``"sequential"`` (conv2d_ws), ``"pipelined"``
    (conv2d_ws_pipe) or ``"auto"`` — set ``pipelined`` where the §5.2
    crossover model (``perfmodel.pipeline_estimate``) says the ping-pong
    pipeline wins.  The choice never affects fitting."""
    if kernel not in ("auto", "pipelined", "sequential"):
        raise ValueError(f"kernel must be auto|pipelined|sequential, "
                         f"got {kernel!r}")
    check_groups(c, k, groups)
    cgrp = c // groups
    if cgrp % cin_banks or k % kout_banks or kout_banks % groups:
        raise ValueError(
            f"banking invariant: C/groups and K divisible by the bank "
            f"counts, kout banks on group boundaries (C={c}, K={k}, "
            f"groups={groups}, banks=({cin_banks}, {kout_banks}))")
    out_bytes = acc_bytes if out_bytes is None else out_bytes
    (pt, pb), (pl_, pr) = normalize_padding(padding, kh, kw, stride, h, w,
                                            dilation)
    if (dilated_extent(kh, dilation) > h + pt + pb
            or dilated_extent(kw, dilation) > w + pl_ + pr):
        raise ValueError(
            f"dilated kernel extent "
            f"{dilated_extent(kh, dilation)}×{dilated_extent(kw, dilation)} "
            f"(kernel {kh}×{kw}, dilation={dilation}) exceeds the padded "
            f"input {h + pt + pb}×{w + pl_ + pr}")
    oh, ow = conv_out_shape(h, w, kh, kw, stride, padding, dilation)
    if pool:
        if oh < 2 or ow < 2:
            raise ValueError(
                f"2×2 pool needs a ≥2×2 conv output, got {oh}×{ow}")
        oh, ow = (oh // 2) * 2, (ow // 2) * 2
    budget = SMEM_BYTES if smem_budget is None else smem_budget

    def build(th: int, tw: int, cbn: int, kbn: int) -> TilePlan:
        cb, kb = cgrp // cbn, k // kbn
        in_th = halo_window(th, stride, kh, dilation)
        in_tw = halo_window(tw, stride, kw, dilation)
        pth, ptw = (th // 2, tw // 2) if pool else (th, tw)
        return TilePlan(
            cin_banks=cbn, kout_banks=kbn, h_tile=th, w_tile=tw,
            n_h_tiles=-(-oh // th), n_w_tiles=-(-ow // tw),
            in_h_tile=in_th, in_w_tile=in_tw,
            image_block_bytes=in_th * in_tw * cb * in_bytes,
            weight_block_bytes=kh * kw * cb * kb * in_bytes,
            acc_block_bytes=th * tw * kb * acc_bytes,
            output_block_bytes=pth * ptw * kb * out_bytes,
            stride=stride, out_h=oh, out_w=ow, pool=pool,
            in_bytes=in_bytes, budget=budget, groups=groups)

    def choose_kernel(plan: TilePlan) -> TilePlan:
        if kernel == "sequential":
            return plan
        if kernel == "pipelined":
            return replace(plan, pipelined=True)
        psums = perfmodel.psum_count(h, w, c, k, kh, kw, stride=stride,
                                     padding=padding, groups=groups,
                                     dilation=dilation)
        est = perfmodel.pipeline_estimate(plan, psums)
        return replace(plan, pipelined=est["profitable"])

    state = (oh, ow, cin_banks, kout_banks)
    plan = build(*state)
    if smem_budget is None:
        return choose_kernel(plan)
    min_tile = 2 if pool else 1
    while not plan.fits_smem:
        th, tw, cbn, kbn = state
        moves = []
        if _align_tile(-(-th // 2), pool) < th and th > min_tile:
            moves.append((_align_tile(-(-th // 2), pool), tw, cbn, kbn))
        if _align_tile(-(-tw // 2), pool) < tw and tw > min_tile:
            moves.append((th, _align_tile(-(-tw // 2), pool), cbn, kbn))
        if cgrp // cbn > 1 and cgrp % (cbn * 2) == 0:
            moves.append((th, tw, cbn * 2, kbn))
        if k // kbn > 1 and k % (kbn * 2) == 0:
            moves.append((th, tw, cbn, kbn * 2))
        candidates = [(build(*m), m) for m in moves]
        candidates = [(p, m) for p, m in candidates
                      if p.working_set_bytes < plan.working_set_bytes]
        if not candidates:
            return choose_kernel(plan)     # nothing shrinks: best effort
        plan, state = min(candidates,
                          key=lambda pm: pm[0].working_set_bytes)
    return choose_kernel(plan)
