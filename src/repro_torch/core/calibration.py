"""Measurement-calibrated corrections to the §5.2 analytic cycle model
(counterpart of ``repro.core.calibration``; numpy only, no torch).

The analytic model in ``core/perfmodel.py`` is first-principles: 16 psums
per 8 cycles, 8 DMA bytes per cycle, a 16-cycle per-slab pipeline
protocol cost.  Every plan decision descends against it: the tile shapes
and the sequential/pipelined verdict of ``banking.plan_tiles``, the
autotuner's search, the scheduler mode of each routed batch.  This module
fits correction terms to measured kernel times instead:

* :class:`CalibrationTable` — the fitted per-term corrections
  (compute-overhead factor, effective DMA bytes/cycle, per-slab pipeline
  overhead, per-call overhead), JSON round-trippable and provenance
  stamped.  Its JSON is the reference's: each package reads a table the
  other wrote.  ``perfmodel`` takes it through an optional ``calib=``;
  with none every perfmodel output is bit-identical to the analytic model
  and the §5.2 anchors (0.224 / 4.48 GOPS) stay exact.
* :func:`fit_calibration` — non-negative least squares of the four terms
  onto measured samples (``core/calibration_sweep.py`` times the port's
  conv kernels on the card), with IQR-based rejection of noisy samples.

A table expresses measured wall time in model cycles at ``clock_hz``
(112 MHz by default), so on the H100 ``compute_factor`` comes out far
below 1 and ``per_call_overhead_cycles`` large: nothing here assumes a
factor near 1, and ``predicted_us`` converts back through ``clock_hz``.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core import perfmodel

# fraction of the median that the inter-quartile range may span before a
# sample is considered too noisy to constrain the fit
NOISE_IQR_FRACTION = 0.5

TERMS = ("compute_factor", "dma_bytes_per_cycle", "pipeline_overhead_cycles",
         "per_call_overhead_cycles")


@dataclass(frozen=True)
class CalibrationSample:
    """One microbenchmark observation: the analytic model's terms for the
    measured configuration (``perfmodel.cycles`` / ``tile_traffic`` /
    ``pipeline_slabs`` of its plan), the median wall time ``measured_us``
    and the inter-quartile range ``iqr_us`` of the timed calls.  ``meta``
    records what the sample ran (shape, epilogue, and on the card the
    path and launch plan that actually launched)."""
    name: str
    compute_cycles: int
    dma_bytes: int
    n_slabs: int
    pipelined: bool
    measured_us: float
    iqr_us: float = 0.0
    meta: Mapping[str, Any] = field(default_factory=dict)

    @property
    def noisy(self) -> bool:
        return self.measured_us > 0 and \
            self.iqr_us > NOISE_IQR_FRACTION * self.measured_us


@dataclass(frozen=True)
class CalibrationTable:
    """Fitted per-term corrections onto the §5.2 analytic model.

    * ``compute_factor`` — measured cycles per analytic compute cycle;
    * ``dma_bytes_per_cycle`` — effective DMA bandwidth (``None`` keeps
      ``IPCoreConfig.dma_bytes_per_cycle``);
    * ``pipeline_overhead_cycles`` — the per-slab ping-pong protocol cost;
      defaults to ``perfmodel.PIPELINE_OVERHEAD_CYCLES`` (16), so the
      crossover moves only when a fitted table says so;
    * ``per_call_overhead_cycles`` — the fixed cost of one layer pass
      (launch, host work), equal for every candidate plan of a layer, so
      it never changes a verdict but keeps the other terms unbiased;
    * ``clock_hz`` — the clock the fit expressed seconds against (model
      cycles = seconds × clock_hz).

    ``fit`` carries the fit diagnostics, ``provenance`` the run's card,
    toolchain and grid."""
    compute_factor: float = 1.0
    dma_bytes_per_cycle: Optional[float] = None
    pipeline_overhead_cycles: float = float(
        perfmodel.PIPELINE_OVERHEAD_CYCLES)
    per_call_overhead_cycles: float = 0.0
    clock_hz: float = 112e6
    fit: Mapping[str, Any] = field(default_factory=dict)
    provenance: Mapping[str, Any] = field(default_factory=dict)

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["fit"] = dict(self.fit)
        d["provenance"] = dict(self.provenance)
        return d

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CalibrationTable":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, s: str) -> "CalibrationTable":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- prediction ---------------------------------------------------------

    def predicted_cycles(self, compute_cycles: int, dma_bytes: int,
                         n_slabs: int = 1, pipelined: bool = False,
                         cfg: perfmodel.IPCoreConfig =
                         perfmodel.IPCoreConfig()) -> float:
        """The fitted four-term expression for one observation (fit
        diagnostics, measured-vs-predicted reports)."""
        bpc = self.dma_bytes_per_cycle or cfg.dma_bytes_per_cycle
        cyc = (self.compute_factor * compute_cycles
               + dma_bytes / max(bpc, 1e-9)
               + self.per_call_overhead_cycles)
        if pipelined:
            cyc += self.pipeline_overhead_cycles * n_slabs
        return cyc

    def predicted_us(self, compute_cycles: int, dma_bytes: int,
                     n_slabs: int = 1, pipelined: bool = False) -> float:
        return self.predicted_cycles(
            compute_cycles, dma_bytes, n_slabs, pipelined) \
            / self.clock_hz * 1e6


def load_table(path: Optional[str]) -> Optional[CalibrationTable]:
    """``CalibrationTable.load``, with a missing or empty path → None (no
    table: the analytic model, bit-exact)."""
    if not path:
        return None
    try:
        return CalibrationTable.load(path)
    except FileNotFoundError:
        return None


def _nnls(a: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Non-negative least squares (the fitted terms are physical rates):
    scipy's, as the reference uses where scipy is installed."""
    from scipy.optimize import nnls
    return nnls(a, y)[0]


def fit_calibration(samples: Sequence[CalibrationSample],
                    cfg: perfmodel.IPCoreConfig = perfmodel.IPCoreConfig(),
                    clock_hz: Optional[float] = None,
                    provenance: Optional[Mapping[str, Any]] = None,
                    reject_noisy: bool = True) -> CalibrationTable:
    """Fit (compute_factor, 1 / dma_bytes_per_cycle, per-slab pipeline
    overhead, per-call overhead) by non-negative least squares:

        measured_us · 1e-6 · clock_hz ≈
            compute_factor · compute_cycles
          + (1 / dma_bytes_per_cycle) · dma_bytes
          + pipeline_overhead_cycles · n_slabs·[pipelined]
          + per_call_overhead_cycles · 1

    Rows are weighted by 1/measured (relative error, the error the
    diagnostics report) and columns scaled to unit norm.  Samples whose
    IQR exceeds ``NOISE_IQR_FRACTION`` of their median are dropped first.
    A column with no nonzero entry keeps its analytic default (no
    pipelined samples → the 16-cycle constant); a DMA coefficient driven
    to zero keeps the config's bandwidth."""
    clock = cfg.clock_hz if clock_hz is None else clock_hz
    kept = [s for s in samples if not (reject_noisy and s.noisy)]
    rejected = len(samples) - len(kept)
    if not kept:
        raise ValueError("fit_calibration: no usable samples "
                         f"({rejected} rejected as noisy)")
    a = np.array([[s.compute_cycles, s.dma_bytes,
                   s.n_slabs if s.pipelined else 0.0, 1.0]
                  for s in kept], dtype=np.float64)
    y = np.array([s.measured_us * 1e-6 * clock for s in kept],
                 dtype=np.float64)
    active = [j for j in range(4) if np.any(a[:, j] > 0)]
    coef = np.array([1.0, 1.0 / cfg.dma_bytes_per_cycle,
                     float(perfmodel.PIPELINE_OVERHEAD_CYCLES), 0.0])
    if active:
        w = 1.0 / np.maximum(y, 1e-12)
        sub = a[:, active] * w[:, None]
        norms = np.linalg.norm(sub, axis=0)
        norms[norms == 0] = 1.0
        sol = _nnls(sub / norms, y * w) / norms
        for j, v in zip(active, sol):
            coef[j] = float(v)
    dma_bpc = (1.0 / coef[1]) if 1 in active and coef[1] > 1e-15 else None
    table = CalibrationTable(
        compute_factor=coef[0],
        dma_bytes_per_cycle=dma_bpc,
        pipeline_overhead_cycles=coef[2],
        per_call_overhead_cycles=coef[3],
        clock_hz=clock,
        provenance=dict(provenance or {}))
    pred = np.array([table.predicted_cycles(
        s.compute_cycles, s.dma_bytes, s.n_slabs, s.pipelined, cfg)
        for s in kept])
    err = np.abs(pred - y) / np.maximum(np.abs(y), 1e-12)
    return replace(table, fit={
        "n_samples": len(samples),
        "n_rejected_noisy": rejected,
        "n_fit": len(kept),
        "mean_abs_error_pct": float(np.mean(err) * 100.0),
        "max_abs_error_pct": float(np.max(err) * 100.0),
        "terms_fit": [TERMS[j] for j in active],
    })


def sample_from_plan(name: str, plan, psums: int, measured_us: float,
                     iqr_us: float = 0.0, pipelined: Optional[bool] = None,
                     cfg: perfmodel.IPCoreConfig = perfmodel.IPCoreConfig(),
                     **meta) -> CalibrationSample:
    """A :class:`CalibrationSample` of one ``banking.TilePlan``: its terms
    come from the perfmodel walk the calibrated model corrects."""
    return CalibrationSample(
        name=name,
        compute_cycles=perfmodel.cycles(psums, cfg) if psums else 0,
        dma_bytes=perfmodel.tile_traffic(plan)["total_bytes"],
        n_slabs=perfmodel.pipeline_slabs(plan),
        pipelined=plan.pipelined if pipelined is None else pipelined,
        measured_us=float(measured_us), iqr_us=float(iqr_us),
        meta=dict(meta))
