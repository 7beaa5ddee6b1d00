"""Three-term roofline against the NVIDIA H100's published peaks
(counterpart of ``repro.roofline.analysis``, which is written against the
TPU v5e).

Terms (seconds, per step, per device; ``roofline.counts`` counts what one
rank runs on its local shards):

    compute    = Σ_dtype FLOPs[dtype] / peak_FLOPs[dtype]
    memory     = traffic_bytes / HBM_bw
    collective = wire_bytes_in_node / NVLink_bw + wire_bytes_across / NIC_bw

``H100`` holds the figures of NVIDIA's H100 Tensor Core GPU data sheet
(SXM5 part, dense rates without sparsity, at its 700 W limit): 989 TFLOP/s
in bf16, 67 TFLOP/s in f32 outside the tensor cores (TF32 is off in the
port's matmuls), 1,979 TOP/s in int8, 3.35 TB/s of HBM3; NVLink 4 at
900 GB/s a card in both directions together, so 450 GB/s a direction, for
a group inside one 8-card HGX node; one ConnectX-7 NDR InfiniBand port of
400 Gb/s (50 GB/s) a card for a group that spans nodes.  With bf16 FLOPs
alone and every group across nodes the terms are the reference's formula
with these rates.  ``build_report`` also takes the reference's ``V5E``
dict (one ``peak_flops`` for every dtype, one ``ici_bw``).

``model_flops`` is the analytic useful-work count (6·N_active·D etc.); the
ratio MODEL_FLOPS / counted FLOPs exposes remat, capacity and padding
waste.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict

from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_RGLRU,
                                      BLOCK_RWKV6, ArchConfig, ShapeConfig,
                                      active_param_count)

H100 = {
    "peak_flops": {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12},
    "hbm_bw": 3.35e12,          # bytes/s per card
    "link_bw": 450e9,           # NVLink, bytes/s a direction, in a node
    "network_bw": 50e9,         # one 400 Gb/s NDR port per card, across
}


# ---------------------------------------------------------------------------
# Analytic useful-FLOPs model (global, whole step)
# ---------------------------------------------------------------------------


def _attn_flops_fwd(cfg: ArchConfig, B: int, S: int, kind: str) -> float:
    """score+av matmuls for one layer, forward, causal-halved."""
    H, dh = cfg.num_heads, cfg.head_dim
    if kind == BLOCK_LOCAL and cfg.attention_window:
        eff = min(cfg.attention_window, S)
        pairs = (S * eff - eff * (eff - 1) / 2 if S >= eff
                 else S * (S + 1) / 2)
    else:
        pairs = S * (S + 1) / 2
    return 4.0 * B * H * dh * pairs


def _mixer_state_flops_fwd(cfg: ArchConfig, B: int, S: int,
                           kind: str) -> float:
    if kind == BLOCK_RWKV6:
        H = cfg.d_model // cfg.rwkv_head_size
        N = cfg.rwkv_head_size
        return 6.0 * B * S * H * N * N
    if kind == BLOCK_RGLRU:
        return 8.0 * B * S * cfg.rnn_width * cfg.conv1d_width
    return 0.0


def _n_matmul(cfg: ArchConfig) -> float:
    """Active parameters participating in GEMMs (gathers excluded)."""
    n = float(active_param_count(cfg))
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model   # input embedding gather is free
    return n


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    kinds = cfg.block_kinds()
    if shape.kind == "decode":
        f = 2.0 * _n_matmul(cfg) * B
        for k in kinds:
            if k in (BLOCK_ATTN, BLOCK_LOCAL):
                eff = min(cfg.attention_window, S) if k == BLOCK_LOCAL else S
                f += 4.0 * B * cfg.num_heads * cfg.head_dim * eff
            elif k == BLOCK_RWKV6:
                H = cfg.d_model // cfg.rwkv_head_size
                f += 6.0 * B * H * cfg.rwkv_head_size ** 2
        if cfg.kind == "encdec":
            f += 4.0 * B * cfg.num_heads * cfg.head_dim * S * len(kinds)
        return f

    factor = 6.0 if shape.kind == "train" else 2.0
    att_factor = 3.0 if shape.kind == "train" else 1.0
    f = factor * _n_matmul(cfg) * B * S
    for k in kinds:
        f += att_factor * _attn_flops_fwd(cfg, B, S, k)
        f += att_factor * _mixer_state_flops_fwd(cfg, B, S, k)
    if cfg.kind == "encdec":
        # encoder blocks (non-causal ⇒ full pairs ≈ 2× causal) + cross attn
        f += att_factor * cfg.encoder_layers * 2 * _attn_flops_fwd(
            cfg, B, S, BLOCK_ATTN)
        f += att_factor * len(kinds) * 2 * _attn_flops_fwd(cfg, B, S,
                                                           BLOCK_ATTN)
    return f


def model_bytes_decode(cfg: ArchConfig, shape: ShapeConfig,
                       param_bytes_total: float, cache_bytes: float) -> float:
    """Useful HBM traffic for one decode step (global): read every live
    parameter once + the whole KV/recurrent cache once."""
    return param_bytes_total + cache_bytes


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device counts (the reference's names: its counts come from HLO)
    hlo_flops_dev: float
    hlo_traffic_dev: float
    wire_bytes_dev: float
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    # usefulness
    model_flops_global: float
    useful_ratio: float          # MODEL / (counted × chips)
    mfu_at_roofline: float       # MODEL/(chips·peak) ÷ max(term)
    # the reference's cost_analysis cross-check; the port has none
    xla_flops_dev: float = 0.0

    def as_dict(self) -> Dict:
        return asdict(self)


def _peak(peaks: dict, dtype: str) -> float:
    p = peaks["peak_flops"]
    return p if isinstance(p, float) else p[dtype]


def terms(costs, peaks: dict = H100) -> Dict[str, float]:
    """{"compute", "memory", "collective"} seconds of ``costs`` (a
    ``counts.ModuleCosts``) on one device of ``peaks``."""
    by_dtype = dict(getattr(costs, "flops_by_dtype", None) or {})
    if not by_dtype:
        by_dtype = {"bfloat16": costs.flops}
    t_c = sum(f / _peak(peaks, dt) for dt, f in by_dtype.items())
    t_m = costs.traffic / peaks["hbm_bw"]
    if "ici_bw" in peaks:
        t_x = costs.coll_wire / peaks["ici_bw"]
    else:
        node = getattr(costs, "coll_wire_node", 0.0)
        t_x = (node / peaks["link_bw"]
               + (costs.coll_wire - node) / peaks["network_bw"])
    return {"compute": t_c, "memory": t_m, "collective": t_x}


def build_report(arch: str, shape_name: str, mesh_name: str, chips: int,
                 costs, cfg: ArchConfig, shape: ShapeConfig,
                 xla_flops: float = 0.0,
                 peaks: dict = H100) -> RooflineReport:
    t = terms(costs, peaks)
    bottleneck = max(t, key=t.get)
    mf = model_flops(cfg, shape)
    counted_global = costs.flops * chips
    t_bound = max(t.values())
    ideal = mf / (chips * _peak(peaks, "bfloat16"))
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops_dev=costs.flops, hlo_traffic_dev=costs.traffic,
        wire_bytes_dev=costs.coll_wire,
        t_compute=t["compute"], t_memory=t["memory"],
        t_collective=t["collective"],
        bottleneck=bottleneck,
        model_flops_global=mf,
        useful_ratio=mf / counted_global if counted_global else 0.0,
        mfu_at_roofline=ideal / t_bound if t_bound else 0.0,
        xla_flops_dev=xla_flops,
    )
