"""Plan autotuner (counterpart of ``repro.core.autotune``): search
(TilePlan × kernel variant × scheduler mode × core count) against the
measurement-calibrated cost model.

``banking.plan_tiles`` is a greedy descent that stops at the first plan
that fits, and its pipelined/sequential verdict trusts the crossover
model.  This module searches the reference's candidate space instead:

* :func:`autotune_layer` — every legal (h_tile, w_tile, cin_banks,
  kout_banks) state of one conv layer (pool-aligned tile halving chains ×
  divisor bank sets, pruned by ``fits_smem`` and group alignment), priced
  under both kernel variants with ``perfmodel.pipeline_estimate(...,
  calib=...)``; the cheapest wins, with a fixed tie-break.  The greedy
  ``plan_tiles(kernel="auto")`` plan is seeded into the set, so the tuned
  plan is never worse than it under the same model.
* :func:`autotune_network` — the layer search over a ``NetworkPlan``,
  then (scheduler mode × core count) for the whole network: a
  :class:`NetworkTunePlan`, whose ``tile_plans`` go to
  ``make_int8_program`` and whose verdict to
  ``MultiCoreScheduler.from_tune``.
* :func:`route_batch` — the mode one formed batch of a given size should
  run under (the continuous-batching engine's ``route=True``).

On the H100 the tile plan of an int8 layer does not shape the
tensor-core launch (``conv2d_ws.tc_plan`` sizes it from the geometry);
the plan's tiles and banks change what the model prices and what the
scalar path runs, and ``pipelined`` picks the kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.core import banking, perfmodel
from repro_torch.core.banking import TilePlan
from repro_torch.kernels.ref import check_groups, conv_out_shape, grouped_banks

SCHEDULER_MODES = ("batch", "kout", "spatial")
CORE_COUNTS = (1, 2, 4, 8, 16, 20)


# ---------------------------------------------------------------------------
# Per-layer candidate enumeration
# ---------------------------------------------------------------------------


def _tile_chain(full: int, pool: bool) -> List[int]:
    """The pool-aligned halving chain ``plan_tiles`` descends: the full
    map, then successive aligned halvings down to the minimum tile."""
    vals, v = [], max(full, 2 if pool else 1)
    while True:
        vals.append(v)
        nv = banking._align_tile(-(-v // 2), pool)
        if nv >= v or v <= (2 if pool else 1):
            return vals
        v = nv


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def candidate_states(oh: int, ow: int, cgrp: int, k: int, groups: int,
                     pool: bool) -> List[Tuple[int, int, int, int]]:
    """All legal (h_tile, w_tile, cin_banks, kout_banks) states of one
    layer: tile extents from the halving chains, cin banks any divisor of
    the per-group channel slice, kout banks any group-aligned divisor of
    K (``groups · m`` with ``m`` dividing ``K/groups``)."""
    kouts = [groups * m for m in _divisors(k // groups)]
    cins = _divisors(cgrp)
    return [(th, tw, cb, kb)
            for th in _tile_chain(oh, pool)
            for tw in _tile_chain(ow, pool)
            for cb in cins
            for kb in kouts]


@dataclass(frozen=True)
class LayerTune:
    """The tuner's verdict for one node: the chosen plan, its chosen
    variant's cycle count, and the greedy plan it beat or matched.
    ``source`` is "autotuned" where the plan differs from the greedy one,
    else "greedy"."""
    name: str
    plan: Optional[TilePlan]
    cycles: int
    greedy_plan: Optional[TilePlan] = None
    greedy_cycles: int = 0
    psums: int = 0
    k: int = 0                       # conv layers: kernel count (for the
    groups: int = 1                  # kout-shard legality rule)

    @property
    def source(self) -> str:
        if self.plan is None:
            return "greedy"
        return "greedy" if self.plan == self.greedy_plan else "autotuned"


def _variant_cost(plan: TilePlan, psums: int, cfg, calib) -> Tuple[int, int]:
    est = perfmodel.pipeline_estimate(plan, psums, cfg, calib)
    return est["sequential_cycles"], est["pipelined_cycles"]


def plan_cost(plan: TilePlan, psums: int,
              cfg: perfmodel.IPCoreConfig = perfmodel.IPCoreConfig(),
              calib=None) -> int:
    """Calibrated cycles of one layer pass under ``plan``, priced for the
    variant the plan carries (``TilePlan.pipelined``)."""
    seq, pipe = _variant_cost(plan, psums, cfg, calib)
    return pipe if plan.pipelined else seq


def autotune_layer(h: int, w: int, c: int, k: int, kh: int = 3, kw: int = 3,
                   *, stride: int = 1, padding="VALID", pool: bool = False,
                   groups: int = 1, dilation: int = 1, in_bytes: int = 1,
                   acc_bytes: int = 4,
                   out_bytes: Optional[int] = None,
                   cin_banks: int = 4, kout_banks: int = 4,
                   smem_budget: Optional[int] = banking.SMEM_BYTES,
                   cfg: perfmodel.IPCoreConfig = perfmodel.IPCoreConfig(),
                   calib=None, name: str = "conv",
                   psums: Optional[int] = None) -> LayerTune:
    """Exhaustive (TilePlan × kernel variant) search for one conv layer.

    Each candidate is built with ``plan_tiles``'s geometry, pruned by
    ``fits_smem`` and priced by ``perfmodel.pipeline_estimate`` under
    ``calib`` for both variants; the cheapest (cost, then a fixed
    structural tie-break) wins, so the result is deterministic given a
    table.  The requested bank counts are first legalised with
    ``grouped_banks`` (a count that does not divide the layer becomes the
    largest legal one; legal counts stay), so the greedy seed always
    plans.

    ``psums`` overrides the compute price (transposed layers pass their
    zero-skipping count; the eq stride-1 geometry would price the naive
    sweep)."""
    check_groups(c, k, groups)
    cgrp = c // groups
    cin_banks, kout_banks = grouped_banks(c, k, groups, want_cin=cin_banks,
                                          want_kout=kout_banks)
    out_bytes_eff = acc_bytes if out_bytes is None else out_bytes
    if psums is None:
        psums = perfmodel.psum_count(h, w, c, k, kh, kw, stride=stride,
                                     padding=padding, groups=groups,
                                     dilation=dilation)
    greedy = banking.plan_tiles(
        h, w, c, k, kh, kw, stride=stride, padding=padding, pool=pool,
        groups=groups, dilation=dilation, in_bytes=in_bytes,
        acc_bytes=acc_bytes,
        out_bytes=out_bytes, cin_banks=cin_banks, kout_banks=kout_banks,
        smem_budget=smem_budget, kernel="auto", calib=calib)
    greedy_cost = plan_cost(greedy, psums, cfg, calib)

    oh, ow = conv_out_shape(h, w, kh, kw, stride, padding, dilation)
    if pool:
        oh, ow = (oh // 2) * 2, (ow // 2) * 2
    budget = banking.SMEM_BYTES if smem_budget is None else smem_budget

    def build(th: int, tw: int, cbn: int, kbn: int) -> TilePlan:
        cb, kb = cgrp // cbn, k // kbn
        in_th = banking.halo_window(th, stride, kh, dilation)
        in_tw = banking.halo_window(tw, stride, kw, dilation)
        pth, ptw = (th // 2, tw // 2) if pool else (th, tw)
        return TilePlan(
            cin_banks=cbn, kout_banks=kbn, h_tile=th, w_tile=tw,
            n_h_tiles=-(-oh // th), n_w_tiles=-(-ow // tw),
            in_h_tile=in_th, in_w_tile=in_tw,
            image_block_bytes=in_th * in_tw * cb * in_bytes,
            weight_block_bytes=kh * kw * cb * kb * in_bytes,
            acc_block_bytes=th * tw * kb * acc_bytes,
            output_block_bytes=pth * ptw * kb * out_bytes_eff,
            stride=stride, out_h=oh, out_w=ow, pool=pool,
            in_bytes=in_bytes, budget=budget, groups=groups)

    # (cost, structural tie-break): fewer tiles, coarser banking, then the
    # sequential kernel — a total order, so equal costs resolve one way
    def key(plan: TilePlan, cost: int):
        return (cost, plan.n_tiles, plan.kout_banks, plan.cin_banks,
                plan.pipelined, plan.h_tile, plan.w_tile)

    best_plan, best_key = greedy, key(greedy, greedy_cost)
    n_cands = 0
    with obs.span("autotune.layer", layer=name, psums=psums):
        for th, tw, cbn, kbn in candidate_states(oh, ow, cgrp, k, groups,
                                                 pool):
            cand = build(th, tw, cbn, kbn)
            if smem_budget is not None and not cand.fits_smem:
                continue
            n_cands += 1
            with obs.span("autotune.candidate", layer=name, h_tile=th,
                          w_tile=tw, cin_banks=cbn, kout_banks=kbn):
                seq, pipe = _variant_cost(cand, psums, cfg, calib)
                for pipelined, cost in ((False, seq), (True, pipe)):
                    p = replace(cand, pipelined=pipelined)
                    k_ = key(p, cost)
                    if k_ < best_key:
                        best_plan, best_key = p, k_
    obs.metrics.counter("autotune.candidates").inc(n_cands)
    return LayerTune(name=name, plan=best_plan, cycles=best_key[0],
                     greedy_plan=greedy, greedy_cycles=greedy_cost,
                     psums=psums, k=k, groups=groups)


# ---------------------------------------------------------------------------
# Whole-network tuning: layers, then (scheduler mode × core count)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NetworkTunePlan:
    """A tuned recipe for one network: per-layer plans (``tile_plans`` is
    a drop-in for ``NetworkPlan.tile_plans``), the winning scheduler
    (mode, core count), and the calibrated totals of the tuned and the
    greedy plan sets."""
    network: str
    layers: Tuple[LayerTune, ...]
    scheduler_mode: str = "batch"
    n_cores: int = 1
    cycles: int = 0                 # tuned total, 1 core
    greedy_cycles: int = 0          # greedy total, 1 core
    schedule_cycles_: int = 0       # tuned total at (mode, n_cores)
    calibrated: bool = False        # a CalibrationTable priced the search

    @property
    def tile_plans(self) -> List[Optional[TilePlan]]:
        return [lt.plan for lt in self.layers]

    @property
    def greedy_tile_plans(self) -> List[Optional[TilePlan]]:
        return [lt.greedy_plan for lt in self.layers]

    @property
    def layers_differ(self) -> int:
        """How many conv layers the search moved off the greedy plan."""
        return sum(1 for lt in self.layers if lt.source == "autotuned")

    @property
    def speedup(self) -> float:
        return self.greedy_cycles / self.cycles if self.cycles else 1.0

    def scheduler_config(self):
        """The winning mode and cores as a ``SchedulerConfig``."""
        from repro_torch.core.scheduler import SchedulerConfig
        return SchedulerConfig(n_cores=self.n_cores,
                               mode=self.scheduler_mode)

    def layer_rows(self) -> List[dict]:
        """Per-layer report rows: plan source and both cycle counts."""
        return [{"name": lt.name, "plan_source": lt.source,
                 "cycles_autotuned": lt.cycles,
                 "cycles_greedy": lt.greedy_cycles,
                 "pipelined": bool(lt.plan.pipelined) if lt.plan else None}
                for lt in self.layers]


def _kout_shards(k: int, groups: int, cores: int) -> int:
    """Largest core count ≤ ``cores`` whose contiguous K/n kernel-set
    slices stay group-aligned (``KoutShardedBackend``'s rule)."""
    kg = k // groups
    for n in range(min(cores, k), 0, -1):
        if k % n:
            continue
        s = k // n
        if s % kg == 0 or kg % s == 0:
            return n
    return 1


def _spatial_shards(tp: TilePlan, cores: int) -> int:
    unit = 2 if tp.pool else 1
    return max(1, min(cores, tp.out_h // unit))


def _spatial_halo_plan(tp: TilePlan, bands: int) -> TilePlan:
    """Charge the spatial mode's halo re-read (each extra band re-reads
    ``kh − stride`` input rows, the overlap ``SpatialShardedBackend``
    cuts) as an inflated image block, which ``pipeline_estimate`` prices
    unchanged."""
    if bands <= 1:
        return tp
    kh = tp.in_h_tile - (tp.h_tile - 1) * tp.stride
    in_h = banking.halo_window(tp.out_h, tp.stride, kh)
    factor = 1.0 + (bands - 1) * max(kh - tp.stride, 0) / max(in_h, 1)
    return replace(tp,
                   image_block_bytes=math.ceil(tp.image_block_bytes * factor))


def schedule_cycles(layers: Sequence[LayerTune], mode: str, cores: int,
                    cfg: perfmodel.IPCoreConfig = perfmodel.IPCoreConfig(),
                    calib=None) -> int:
    """Calibrated whole-network cycles at one (scheduler mode, core count):

    * batch — compute divides by the core count, the shared DMA
      interface does not;
    * kout — each layer's compute divides by its largest group-aligned
      kernel-set split ≤ cores; DMA traffic is unchanged;
    * spatial — each layer's compute divides by its row-band count and
      the bands' halo re-reads are charged to DMA.

    Layers without a plan (dense GEMMs, merges) price on calibrated
    compute cycles with the same per-mode division."""
    total = 0
    for lt in layers:
        tp, p = lt.plan, lt.psums
        if tp is None:
            if not p:
                continue
            eff = cores if mode in ("batch", "kout") else 1
            total += perfmodel.calibrated_cycles(
                p, replace(cfg, ip_cores=eff), calib)
            continue
        if mode == "batch":
            eff, priced = cores, tp
        elif mode == "kout":
            eff = _kout_shards(lt.k, lt.groups, cores)
            priced = tp
        else:
            eff = _spatial_shards(tp, cores)
            priced = _spatial_halo_plan(tp, eff)
        est = perfmodel.pipeline_estimate(
            priced, p, replace(cfg, ip_cores=eff), calib)
        total += est["pipelined_cycles" if tp.pipelined
                     else "sequential_cycles"]
    return total


def route_batch(layers: Sequence[LayerTune], batch: int, n_cores: int,
                cfg: perfmodel.IPCoreConfig = perfmodel.IPCoreConfig(),
                calib=None, modes: Sequence[str] = SCHEDULER_MODES
                ) -> Tuple[str, int, int]:
    """The scheduler mode the calibrated model predicts fastest for one
    formed batch of ``batch`` images on ``n_cores`` cores →
    ``(mode, cores, predicted_cycles)``.

    Batch mode splits the formed batch over ``min(batch, n_cores)``
    cores; kout and spatial run the sharded program once per image on all
    ``n_cores``.  A single deadline-launched image therefore wants the
    cores inside the program, a full batch usually batch sharding.  The
    first mode in ``modes`` wins ties."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if n_cores < 1:
        raise ValueError(f"n_cores must be >= 1, got {n_cores}")
    best = None
    for mode in modes:
        cores = min(batch, n_cores) if mode == "batch" else n_cores
        cycles = batch * schedule_cycles(layers, mode, cores, cfg, calib)
        if best is None or cycles < best[2]:
            best = (mode, cores, cycles)
    return best


def autotune_network(plan, cin_banks: int = 4, kout_banks: int = 4,
                     in_bytes: int = 1,
                     smem_budget: Optional[int] = banking.SMEM_BYTES,
                     cfg: perfmodel.IPCoreConfig = perfmodel.IPCoreConfig(),
                     calib=None,
                     modes: Sequence[str] = SCHEDULER_MODES,
                     core_counts: Sequence[int] = CORE_COUNTS
                     ) -> NetworkTunePlan:
    """Tune every conv layer of a ``NetworkPlan`` (the walk and bank
    legalisation of ``NetworkPlan.tile_plans``, so the tuned list is a
    drop-in), then search (scheduler mode × core count) under the
    calibrated model.  Modes scan in order and core counts ascending; a
    point must be strictly cheaper to win."""
    from repro_torch.core.network import PARAM_KINDS, conv_geometry
    from repro_torch.kernels.conv2d_ws_trans import \
        transpose_eq_conv_geometry
    last_param = max((i for i, sp in enumerate(plan.layers)
                      if sp.kind in PARAM_KINDS), default=-1)
    names = plan.node_names()
    ins = plan.resolved_inputs()
    acts = plan.activation_shapes()
    psum_rows = dict(plan.psum_table())
    tunes: List[LayerTune] = []
    for i, sp in enumerate(plan.layers):
        if sp.kind not in ("conv", "conv_transpose"):
            p = psum_rows[names[i]]
            cyc = perfmodel.calibrated_cycles(p, cfg, calib) if p else 0
            tunes.append(LayerTune(name=names[i], plan=None, cycles=cyc,
                                   greedy_cycles=cyc, psums=p))
            continue
        h, w, c = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
        kh, kw = sp.kernel
        k_, g_ = conv_geometry(sp, c)
        stride, pad = sp.stride, sp.padding
        if sp.kind == "conv_transpose":
            # tune on the eq stride-1 conv the lowering launches, priced on
            # the zero-skipping psum count of the psum table
            h, w, pad = transpose_eq_conv_geometry(
                h, w, kh, kw, sp.stride, sp.padding, sp.dilation)
            stride = 1
        tunes.append(autotune_layer(
            h, w, c, k_, kh, kw, stride=stride, padding=pad,
            pool=sp.pool, groups=g_, dilation=sp.dilation,
            in_bytes=in_bytes,
            out_bytes=4 if i == last_param else in_bytes,
            cin_banks=cin_banks, kout_banks=kout_banks,
            smem_budget=smem_budget, cfg=cfg, calib=calib, name=names[i],
            psums=psum_rows[names[i]]))
    total = sum(lt.cycles for lt in tunes)
    greedy_total = sum(lt.greedy_cycles for lt in tunes)
    best = ("batch", 1, schedule_cycles(tunes, "batch", 1, cfg, calib))
    with obs.span("autotune.schedule_sweep", network=plan.name):
        for mode in modes:
            for cores in sorted(core_counts):
                with obs.span("autotune.schedule", mode=mode, cores=cores):
                    cyc = schedule_cycles(tunes, mode, cores, cfg, calib)
                if cyc < best[2]:
                    best = (mode, cores, cyc)
    return NetworkTunePlan(
        network=plan.name, layers=tuple(tunes),
        scheduler_mode=best[0], n_cores=best[1],
        cycles=total, greedy_cycles=greedy_total,
        schedule_cycles_=best[2], calibrated=calib is not None)
