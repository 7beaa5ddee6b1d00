"""Analytic cycle model of the paper's IP core (§5.2), device-independent.

A copy of the uncalibrated half of ``repro.core.perfmodel`` (the port
imports nothing of the reference package).  It reproduces the paper's own
numbers exactly:

* [224×224×8] ⊛ [8×3×3×8] → 3,154,176 psums (= 222·222·8·8),
* the 4-core system computes 16 psums / 8 cycles,
* at 112 MHz (Pynq Z2 synthesis, Table 1) → 0.01408 s,
* paper-GOPS (= psums/second): 0.224; 20 replicated IP cores: 4.48.

These are FPGA analytics, not H100 figures.  ``pipeline_estimate`` is the
crossover the tile planner consults for ``kernel="auto"``; only the
analytic model (no calibration table) is ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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


def dma_cycles(total_bytes: int, cfg: IPCoreConfig = IPCoreConfig()) -> int:
    """DMA cycles for ``total_bytes`` on the shared interface."""
    return math.ceil(total_bytes / max(cfg.dma_bytes_per_cycle, 1e-9))


# Per-slab cost of the explicit ping-pong protocol (descriptor setup,
# semaphore wait, buffer swap): the reason tiny layers stay sequential.
PIPELINE_OVERHEAD_CYCLES = 16


def pipeline_slabs(plan) -> int:
    """(spatial tile × kout bank × cin bank) slabs of one layer pass."""
    return plan.n_tiles * plan.kout_banks * plan.cin_banks


def pipeline_estimate(plan, psums: int,
                      cfg: IPCoreConfig = IPCoreConfig()) -> dict:
    """Sequential-vs-pipelined cost of one layer pass under ``plan``:
    sequential = D + C; pipelined = d + (n−1)·max(d, c) + c plus the
    per-slab protocol overhead, with d, c the per-slab shares."""
    n = max(pipeline_slabs(plan), 1)
    dma = dma_cycles(tile_traffic(plan)["total_bytes"], cfg)
    compute = cycles(psums, cfg) if psums else 0
    d, c = -(-dma // n), -(-compute // n)
    sequential = dma + compute
    pipelined = d + (n - 1) * max(d, c) + c \
        + math.ceil(n * PIPELINE_OVERHEAD_CYCLES)
    return {
        "n_slabs": n,
        "dma_cycles": dma,
        "compute_cycles": compute,
        "sequential_cycles": sequential,
        "pipelined_cycles": pipelined,
        "speedup": sequential / pipelined if pipelined else 1.0,
        "profitable": pipelined < sequential,
    }
