"""Per-layer profiler and model-drift detection (counterpart of
``repro.obs.profile``).

* :func:`profile_network` runs a quantized ``NetworkPlan`` program
  layer-at-a-time through the same int8 node semantics the program
  executes (``network.int8_forward`` with a node hook): the paper's single
  IP core processes one layer at a time (§4.2), so the walk is the
  hardware schedule.  The hook synchronizes the device after each node
  (where the reference calls ``block_until_ready``) and clocks it with a
  monotonic clock, giving one :class:`LayerProfile` per node: wall µs,
  psums, achieved GOPS (the paper's psums/second) and the §5.2 cycle
  model's predicted µs.
* :class:`DriftDetector` flags layers whose measured/predicted ratio
  leaves a band; events land in ``obs.metrics`` (``obs.drift.events``) and
  as trace marks.

Only the analytic model is ported: a calibration table (``calib=``) needs
``core/calibration.py`` (ROADMAP A7).  Without a table the predicted
column is the FPGA's §5.2 time, a cross-platform reference and not
comparable to the card's wall time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs

# measured/predicted inside [lo, hi] is "the model holds"; outside is drift
DEFAULT_DRIFT_BAND = (0.5, 2.0)


@dataclass(frozen=True)
class LayerProfile:
    """One node's profile record: measurement, workload, prediction."""
    index: int
    name: str
    kind: str
    wall_us: float
    psums: int                         # per image (the paper accounting)
    batch: int
    gops: float                        # achieved, psums·batch / wall / 1e9
    predicted_us: Optional[float]      # None: the model prices it free
    pipelined: Optional[bool]          # conv nodes: kernel variant
    calibrated: bool

    @property
    def ratio(self) -> Optional[float]:
        """measured / predicted (None where the model prices the node
        free: merges, pools, flatten)."""
        if not self.predicted_us:
            return None
        return self.wall_us / self.predicted_us

    def to_dict(self) -> Dict[str, Any]:
        return {"index": self.index, "name": self.name, "kind": self.kind,
                "wall_us": self.wall_us, "psums": self.psums,
                "batch": self.batch, "gops": self.gops,
                "predicted_us": self.predicted_us, "ratio": self.ratio,
                "pipelined": self.pipelined, "calibrated": self.calibrated}


@dataclass(frozen=True)
class DriftEvent:
    """One flagged layer: its measured/predicted ratio left the band."""
    name: str
    wall_us: float
    predicted_us: float
    ratio: float
    band: Tuple[float, float]

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "wall_us": self.wall_us,
                "predicted_us": self.predicted_us, "ratio": self.ratio,
                "band": list(self.band)}


@dataclass(frozen=True)
class NetworkProfile:
    """The per-layer profile of one forward pass."""
    network: str
    batch: int
    records: Tuple[LayerProfile, ...]
    calibrated: bool
    drift: Tuple[DriftEvent, ...] = ()

    @property
    def layer_names(self) -> List[str]:
        return [r.name for r in self.records]

    @property
    def total_wall_us(self) -> float:
        return sum(r.wall_us for r in self.records)

    def to_dict(self) -> Dict[str, Any]:
        return {"network": self.network, "batch": self.batch,
                "calibrated": self.calibrated,
                "total_wall_us": self.total_wall_us,
                "layers": [r.to_dict() for r in self.records],
                "drift": [d.to_dict() for d in self.drift]}


class DriftDetector:
    """Flag layers whose measured/predicted wall-time ratio leaves
    ``band``; ``min_wall_us`` suppresses noise-floor layers."""

    def __init__(self, band: Tuple[float, float] = DEFAULT_DRIFT_BAND,
                 min_wall_us: float = 0.0):
        lo, hi = band
        if not (0.0 < lo < hi):
            raise ValueError(f"drift band wants 0 < lo < hi, got {band}")
        self.band = (float(lo), float(hi))
        self.min_wall_us = float(min_wall_us)

    def check(self, records: Sequence[LayerProfile]) -> List[DriftEvent]:
        lo, hi = self.band
        events: List[DriftEvent] = []
        for r in records:
            ratio = r.ratio
            if ratio is None or r.wall_us < self.min_wall_us:
                continue
            if lo <= ratio <= hi:
                continue
            ev = DriftEvent(name=r.name, wall_us=r.wall_us,
                            predicted_us=float(r.predicted_us),
                            ratio=ratio, band=self.band)
            events.append(ev)
            obs.metrics.counter("obs.drift.events").inc()
            obs.instant("drift", layer=r.name, ratio=round(ratio, 3),
                        band=list(self.band))
        return events


def _predicted_us(psums: int, tile_plan, cfg) -> Optional[float]:
    """The §5.2 model's time for one node, priced the way the planner
    prices it (``perfmodel.pipeline_estimate`` for planned convs, compute
    cycles for GEMMs); None for nodes the model prices free."""
    from repro_torch.core import perfmodel
    if tile_plan is not None:
        est = perfmodel.pipeline_estimate(tile_plan, psums, cfg)
        cyc = est["pipelined_cycles" if tile_plan.pipelined
                  else "sequential_cycles"]
        return cyc / cfg.clock_hz * 1e6
    if not psums:
        return None
    return perfmodel.cycles(psums, cfg) / cfg.clock_hz * 1e6


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def profile_network(qnet, x: torch.Tensor, *, core_config=None,
                    tile_plans: Optional[Sequence] = None, calib=None,
                    warmup: int = 1, drift: Optional[DriftDetector] = None,
                    perf_cfg=None) -> NetworkProfile:
    """Profile one int8 forward pass layer-at-a-time.

    Runs ``network.int8_forward`` with a node hook that synchronizes the
    current stream on each node's output and clocks it, so the layer set
    matches the ``NetworkPlan`` topology exactly (one record per node).
    Each node gets a ``layer:<name>`` trace event when obs is enabled.
    ``warmup`` extra passes absorb first-call costs (kernel builds, plan
    caches).  ``calib`` must be None (ROADMAP A7)."""
    from repro_torch.core import network, perfmodel
    from repro_torch.core.convcore import ConvCoreConfig, get_backend

    if calib is not None:
        raise NotImplementedError(
            "profile_network(calib=...) needs the calibration table, not "
            "ported to the PyTorch package yet (ROADMAP A7)")
    if core_config is None:
        core_config = ConvCoreConfig(int8=True)
    plan = qnet.plan
    if tile_plans is None:
        tile_plans = network.program_tile_plans(plan, core_config)
    cfg = perf_cfg if perf_cfg is not None else perfmodel.IPCoreConfig()
    backend = get_backend(core_config.backend)
    batch = int(x.shape[0])
    psum_rows = dict(plan.psum_table())
    names = plan.node_names()

    with torch.no_grad():
        for _ in range(max(warmup, 0)):
            _sync(network.int8_forward(qnet, x, backend=backend,
                                       tile_plans=tile_plans))

        intervals: List[Tuple[int, int]] = []    # per-node (t0_ns, t1_ns)
        t_prev = [0]

        def hook(i, name, sp, h):
            _sync(h)
            t1 = time.perf_counter_ns()
            intervals.append((t_prev[0], t1))
            t_prev[0] = time.perf_counter_ns()   # exclude the hook's cost

        with obs.span("profile", network=plan.name, batch=batch):
            _sync(x)
            t_prev[0] = time.perf_counter_ns()
            network.int8_forward(qnet, x, backend=backend,
                                 tile_plans=tile_plans, node_hook=hook)

    records: List[LayerProfile] = []
    hist = obs.metrics.histogram(f"profile.layer_us.{plan.name}")
    for i, sp in enumerate(plan.layers):
        psums = psum_rows[names[i]]
        t0, t1 = intervals[i]
        wall = (t1 - t0) / 1e3
        pred = _predicted_us(psums, tile_plans[i], cfg)
        rec = LayerProfile(
            index=i, name=names[i], kind=sp.kind, wall_us=wall,
            psums=psums, batch=batch,
            gops=(psums * batch) / (wall * 1e-6) / 1e9 if wall > 0 else 0.0,
            predicted_us=pred,
            pipelined=(bool(tile_plans[i].pipelined)
                       if tile_plans[i] is not None else None),
            calibrated=False)
        records.append(rec)
        if obs.enabled():
            # the measured walk as trace events with their real intervals
            obs.tracer._record(
                f"layer:{names[i]}", t0, t1,
                {"kind": sp.kind, "psums": psums,
                 "predicted_us": None if pred is None else round(pred, 2)})
        hist.observe(wall)

    events: Tuple[DriftEvent, ...] = ()
    if drift is not None:
        events = tuple(drift.check(records))
    return NetworkProfile(network=plan.name, batch=batch,
                          records=tuple(records), calibrated=False,
                          drift=events)
