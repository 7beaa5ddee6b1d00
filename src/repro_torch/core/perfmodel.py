"""Analytic cycle model of the paper's IP core (§5.2), device-independent.

A copy of the uncalibrated half of ``repro.core.perfmodel`` (the port
imports nothing of the reference package).  It reproduces the paper's own
numbers exactly:

* [224×224×8] ⊛ [8×3×3×8] → 3,154,176 psums (= 222·222·8·8),
* the 4-core system computes 16 psums / 8 cycles,
* at 112 MHz (Pynq Z2 synthesis, Table 1) → 0.01408 s,
* paper-GOPS (= psums/second): 0.224; 20 replicated IP cores: 4.48.

These are FPGA analytics, not H100 figures.  ``pipeline_estimate`` is the
crossover the tile planner consults for ``kernel="auto"``;
``network_report`` and ``train_report`` price a whole network's inference
and training step.

Every cost entry point takes an optional ``calib=``, a
``core.calibration.CalibrationTable`` of terms fitted to measured kernel
times (compute-overhead factor, effective DMA bytes/cycle, per-slab
pipeline overhead, per-call overhead).  With ``calib=None`` every function
is bit-identical to the analytic model.  The table is duck-typed here
(attributes, not an import), so perfmodel does not depend on the layer it
feeds.

``h100_conv_roofline`` is the one H100 figure: the least time the card
could take for a conv layer, from the data-sheet peaks below.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

from repro_torch.kernels.ref import conv_out_shape, conv_transpose_out_shape


@dataclass(frozen=True)
class IPCoreConfig:
    clock_hz: float = 112e6        # Pynq Z2 synthesis (Table 1)
    computing_cores: int = 4       # channel-parallel cores (M1)
    pcores_per_core: int = 4       # kernels in flight per core (M2)
    cycles_per_batch: int = 8      # "four psum values for each eight cycles"
    ip_cores: int = 1              # replicated IP cores on the fabric
    dma_bytes_per_cycle: float = 8.0   # 64-bit DDR/AXI interface (shared)


def psum_count(h: int, w: int, c: int, k: int, kh: int = 3, kw: int = 3,
               stride: int = 1, padding="VALID", groups: int = 1,
               dilation: int = 1) -> int:
    """One psum per (output pixel × kernel × input channel of its group)."""
    oh, ow = conv_out_shape(h, w, kh, kw, stride, padding, dilation)
    return oh * ow * k * (c // groups)


def conv_transpose_psum_count(h: int, w: int, c: int, k: int, kh: int = 3,
                              kw: int = 3, stride: int = 1,
                              padding="VALID", groups: int = 1,
                              dilation: int = 1, skip_zeros: bool = True
                              ) -> int:
    """Psums of a transposed conv layer.  ``skip_zeros=True`` (the
    network tables' price): one psum per INPUT pixel × kernel × group
    channel, what a MAC controller that skips the inserted zeros pays;
    ``skip_zeros=False``: one per OUTPUT pixel, what the unmodified core
    pays sweeping the zero-inserted map (about stride² more)."""
    if skip_zeros:
        return h * w * k * (c // groups)
    oh, ow = conv_transpose_out_shape(h, w, kh, kw, stride, padding,
                                      dilation)
    return oh * ow * k * (c // groups)


def cycles(n_psums: int, cfg: IPCoreConfig = IPCoreConfig()) -> int:
    per_batch = cfg.computing_cores * cfg.pcores_per_core  # 16 psums
    batches = -(-n_psums // (per_batch * cfg.ip_cores))
    return batches * cfg.cycles_per_batch


def seconds(n_psums: int, cfg: IPCoreConfig = IPCoreConfig()) -> float:
    return cycles(n_psums, cfg) / cfg.clock_hz


def gops_paper(n_psums: int, cfg: IPCoreConfig = IPCoreConfig()) -> float:
    """The paper's accounting: psums per second / 1e9."""
    return n_psums / seconds(n_psums, cfg) / 1e9


def gops_macs(n_psums: int, kh: int = 3, kw: int = 3,
              cfg: IPCoreConfig = IPCoreConfig()) -> float:
    """Standard accounting: 1 psum = KH·KW MACs = 2·KH·KW ops."""
    return n_psums * 2 * kh * kw / seconds(n_psums, cfg) / 1e9


def paper_reference_numbers():
    """The exact §5.2 workload."""
    n = psum_count(224, 224, 8, 8)
    one = IPCoreConfig()
    twenty = IPCoreConfig(ip_cores=20)
    return {
        "psums": n,
        "seconds_1core": seconds(n, one),
        "gops_1core": gops_paper(n, one),
        "gops_20cores": gops_paper(n, twenty),
        "gops_macs_1core": gops_macs(n, cfg=one),
    }


def network_cycles(layer_psums: Sequence[int],
                   cfg: IPCoreConfig = IPCoreConfig()) -> int:
    """Whole-network cycle estimate: the IP core processes one layer at a
    time (§4.2), so the network cost is the sum of per-layer passes (each
    layer rounds up to full psum batches separately — the pipeline drains
    between layer configurations).  This holds for DAG plans too: parallel
    branches of a residual graph still serialize on the single core, so a
    topological schedule's length is exactly this sum; merge nodes (add /
    concat) contribute zero psums — the output-BRAM crossbar absorbs
    them."""
    return sum(cycles(p, cfg) for p in layer_psums if p)


def tile_traffic(plan) -> dict:
    """DMA traffic of one layer pass under a ``banking.TilePlan``: every
    kout bank revisits every spatial tile."""
    in_b = plan.n_tiles * plan.cin_banks * plan.image_block_bytes \
        * plan.kout_banks
    w_b = plan.n_tiles * plan.cin_banks * plan.kout_banks \
        * plan.weight_block_bytes
    out_b = plan.n_tiles * plan.kout_banks * plan.output_block_bytes
    return {"input_bytes": in_b, "weight_bytes": w_b,
            "output_bytes": out_b, "total_bytes": in_b + w_b + out_b,
            "halo_read_factor": plan.halo_read_factor,
            "kout_revisits": plan.kout_banks}


def dma_cycles(total_bytes: int, cfg: IPCoreConfig = IPCoreConfig(),
               calib=None) -> int:
    """DMA cycles for ``total_bytes`` on the shared interface; a table's
    fitted ``dma_bytes_per_cycle`` replaces the config's bandwidth."""
    bpc = cfg.dma_bytes_per_cycle
    if calib is not None and getattr(calib, "dma_bytes_per_cycle", None):
        bpc = calib.dma_bytes_per_cycle
    return math.ceil(total_bytes / max(bpc, 1e-9))


# Per-slab cost of the explicit ping-pong protocol (descriptor setup,
# semaphore wait, buffer swap): the reason tiny layers stay sequential.
# The no-table value; a fitted table carries its own.
PIPELINE_OVERHEAD_CYCLES = 16


def pipeline_overhead_cycles(calib=None) -> float:
    """The per-slab protocol cost the crossover charges: the table's
    fitted value, or the 16-cycle analytic constant without one."""
    if calib is None:
        return PIPELINE_OVERHEAD_CYCLES
    return float(getattr(calib, "pipeline_overhead_cycles",
                         PIPELINE_OVERHEAD_CYCLES))


def calibrated_cycles(n_psums: int, cfg: IPCoreConfig = IPCoreConfig(),
                      calib=None) -> int:
    """Compute cycles with the table's ``compute_factor`` applied;
    ``calib=None`` returns ``cycles`` unchanged."""
    base = cycles(n_psums, cfg)
    if calib is None:
        return base
    return math.ceil(base * float(getattr(calib, "compute_factor", 1.0)))


def pipeline_slabs(plan) -> int:
    """(spatial tile × kout bank × cin bank) slabs of one layer pass."""
    return plan.n_tiles * plan.kout_banks * plan.cin_banks


def pipeline_estimate(plan, psums: int,
                      cfg: IPCoreConfig = IPCoreConfig(),
                      calib=None) -> dict:
    """Sequential-vs-pipelined cost of one layer pass under ``plan``:
    sequential = D + C; pipelined = d + (n−1)·max(d, c) + c plus the
    per-slab protocol overhead, with d, c the per-slab shares.  ``calib``
    applies the fitted terms to each, and adds its per-call overhead to
    both variants (so it never changes the verdict)."""
    n = max(pipeline_slabs(plan), 1)
    dma = dma_cycles(tile_traffic(plan)["total_bytes"], cfg, calib)
    compute = calibrated_cycles(psums, cfg, calib) if psums else 0
    base = 0 if calib is None else math.ceil(
        float(getattr(calib, "per_call_overhead_cycles", 0.0)))
    d, c = -(-dma // n), -(-compute // n)
    sequential = dma + compute + base
    pipelined = d + (n - 1) * max(d, c) + c + base \
        + math.ceil(n * pipeline_overhead_cycles(calib))
    return {
        "n_slabs": n,
        "dma_cycles": dma,
        "compute_cycles": compute,
        "sequential_cycles": sequential,
        "pipelined_cycles": pipelined,
        "speedup": sequential / pipelined if pipelined else 1.0,
        "profitable": pipelined < sequential,
    }


def network_report(layers: Sequence[Tuple[str, int]],
                   cfg: IPCoreConfig = IPCoreConfig(),
                   full_board_cores: int = 20,
                   tile_plans: Optional[Sequence] = None,
                   calib=None) -> dict:
    """Per-layer and total cycles / seconds / paper-GOPS of a layer list
    [(name, psums per image), ...] on ``cfg`` and on the paper's full board
    (``full_board_cores`` replicated IP cores).  ``tile_plans`` (one
    ``banking.TilePlan`` or None per layer) adds the tiled DMA traffic:
    each layer is priced by ``pipeline_estimate`` for the variant its plan
    carries, and the shared DMA interface floors the full board's cycles.
    ``calib`` prices every row under the fitted terms."""
    board = replace(cfg, ip_cores=full_board_cores)
    if tile_plans is None:
        tile_plans = [None] * len(layers)
    per_layer: List[dict] = []
    total = total_board = 0
    for (name, p), tp in zip(layers, tile_plans):
        compute = calibrated_cycles(p, cfg, calib) if p else 0
        compute_board = calibrated_cycles(p, board, calib) if p else 0
        row = {"name": name, "psums": p, "cycles": compute}
        if tp is not None:
            traffic = tile_traffic(tp)
            dma = dma_cycles(traffic["total_bytes"], cfg, calib)
            pipelined = bool(getattr(tp, "pipelined", False))
            est = pipeline_estimate(tp, p, cfg, calib)
            est_board = pipeline_estimate(tp, p, board, calib)
            key = "pipelined_cycles" if pipelined else "sequential_cycles"
            row.update(dma_bytes=traffic["total_bytes"], dma_cycles=dma,
                       halo_read_factor=traffic["halo_read_factor"],
                       n_tiles=tp.n_tiles,
                       cycles=est[key] if p else dma,
                       pipelined=pipelined,
                       cycles_sequential=est["sequential_cycles"],
                       cycles_pipelined=est["pipelined_cycles"],
                       pipeline_speedup=est["speedup"],
                       dma_bound=dma >= compute,
                       dma_bound_board=dma >= compute_board)
            total += row["cycles"]
            total_board += est_board[key] if p else dma
        else:
            total += compute
            total_board += compute_board
        per_layer.append(row)
    total_psums = sum(p for _, p in layers)
    return {
        "layers": per_layer,
        "dma_bound_board_layers": sum(
            1 for r in per_layer if r.get("dma_bound_board")),
        "pipelined_layers": sum(1 for r in per_layer if r.get("pipelined")),
        "psums": total_psums,
        "cycles": total,
        "seconds": total / cfg.clock_hz,
        "gops_paper": total_psums / (total / cfg.clock_hz) / 1e9 if total
        else 0.0,
        "full_board": {
            "ip_cores": full_board_cores,
            "cycles": total_board,
            "seconds": total_board / board.clock_hz,
            "gops_paper": total_psums / (total_board / board.clock_hz) / 1e9
            if total_board else 0.0,
        },
    }


def train_report(layers: Sequence[Tuple[str, int]],
                 cfg: IPCoreConfig = IPCoreConfig(),
                 weight_bytes: Optional[Sequence[int]] = None,
                 full_board_cores: int = 20,
                 tile_plans: Optional[Sequence] = None,
                 calib=None) -> dict:
    """The §5.2 cycle model of one training step over [(name, forward
    psums per image), ...]: the input gradient (a transposed conv) and the
    weight gradient (a correlation over the same index set) each cost the
    forward's psums, so the backward is 2× and the step 3×.
    ``weight_bytes`` (per layer, None for parameter-free nodes) prices the
    weight gradients' writeback on the shared DMA interface: a layer's
    backward takes max(compute, dW DMA) cycles.  ``calib`` prices both
    passes under the fitted terms."""
    fwd = network_report(layers, cfg, full_board_cores=full_board_cores,
                         tile_plans=tile_plans, calib=calib)
    board = replace(cfg, ip_cores=full_board_cores)
    if weight_bytes is None:
        weight_bytes = [None] * len(layers)
    bwd_rows: List[dict] = []
    bwd_total = bwd_board = 0
    for (name, p), wb in zip(layers, weight_bytes):
        compute = calibrated_cycles(2 * p, cfg, calib) if p else 0
        compute_board = calibrated_cycles(2 * p, board, calib) if p else 0
        row = {"name": name, "psums_bwd": 2 * p, "cycles": compute}
        if wb:
            dma = dma_cycles(wb, cfg, calib)
            row.update(dw_bytes=wb, dw_dma_cycles=dma,
                       cycles=max(compute, dma))
            bwd_total += row["cycles"]
            bwd_board += max(compute_board, dma)   # shared DMA interface
        else:
            bwd_total += compute
            bwd_board += compute_board
        bwd_rows.append(row)
    total = fwd["cycles"] + bwd_total
    total_board = fwd["full_board"]["cycles"] + bwd_board
    step_psums = 3 * fwd["psums"]
    return {
        "forward": fwd,
        "backward": {"layers": bwd_rows, "psums": 2 * fwd["psums"],
                     "cycles": bwd_total,
                     "seconds": bwd_total / cfg.clock_hz},
        "psums": step_psums,
        "cycles": total,
        "seconds": total / cfg.clock_hz,
        "gops_paper": step_psums / (total / cfg.clock_hz) / 1e9 if total
        else 0.0,
        "full_board": {
            "ip_cores": full_board_cores,
            "cycles": total_board,
            "seconds": total_board / board.clock_hz,
            "gops_paper": step_psums / (total_board / board.clock_hz) / 1e9
            if total_board else 0.0,
        },
    }


# H100 SXM data-sheet peaks (dense, no sparsity, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12     # HBM3
INT8_OPS_PER_S = 1979e12      # int8 tensor cores
BF16_OPS_PER_S = 989e12       # bf16 tensor cores
F32_OPS_PER_S = 67e12         # f32 outside the tensor cores


def h100_conv_roofline(h: int, w: int, c: int, k: int, kh: int = 3,
                       kw: int = 3, in_bytes: int = 1,
                       peak_ops: float = INT8_OPS_PER_S,
                       hbm_bw: float = HBM_BYTES_PER_S) -> dict:
    """Roofline terms of one VALID conv layer on one H100 (the int8
    datapath by default; pass ``F32_OPS_PER_S`` and ``in_bytes=4`` for
    f32): the least time the card could take, the larger of the
    operations over the peak rate and the bytes moved (input and weights
    read once, int32 output written once) over HBM's rate."""
    oh, ow = h - kh + 1, w - kw + 1
    ops = 2.0 * oh * ow * k * c * kh * kw
    bytes_moved = (h * w * c + kh * kw * c * k) * in_bytes + oh * ow * k * 4
    t = max(ops / peak_ops, bytes_moved / hbm_bw)
    return {"flops": ops, "bytes": bytes_moved,
            "t_compute": ops / peak_ops, "t_memory": bytes_moved / hbm_bw,
            "seconds": t, "gops_macs": ops / t / 1e9,
            "gops_paper": (oh * ow * k * c) / t / 1e9}
