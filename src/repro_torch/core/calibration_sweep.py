"""Fit a calibration table from the card's own conv kernel times.

    PYTHONPATH=src python3 -m repro_torch.core.calibration_sweep \\
        --out CALIBRATION_h100.json [--smoke]

The counterpart of the reference's ``benchmarks/calibrate.py``: the same
factorial grid (``SHAPES`` × ``BANKS`` × ``EPILOGUES`` × sequential
against pipelined; ``--smoke`` the reduced grid), each point run through
the port's ``conv2d_ws``, ``conv2d_ws_pipe`` or ``conv2d_ws_transpose``
with the point's ``banking.TilePlan``, timed on the GPU and fitted by
``calibration.fit_calibration``.  A batch-1 16×16 layer is bound by the
host on the H100, so the sweep adds the main path's own layers:
``vgg_imagenet``'s six convs at 224×224, batch ``MAIN_BATCH``, on both
kernels.  Their analytic terms are the plan's per-image terms times the
batch, the work the measured call did.

Timing: CUDA events around each of ``ITERS`` (smoke: ``SMOKE_ITERS``)
back-to-back calls after a warm-up (host work between the events
included, as a served layer pays it); the median and inter-quartile
range of the per-call times.

Each sample's ``meta`` records what launched: ``conv_path`` (read from the
wrapper's launch counts by path: "tc", "simt", "dw", "nk" or "scalar"),
the launch geometry, and the tensor-core ``TcPlan``'s ``bn`` / ``stages``
/ ``slots``, the dw ``DwPlan``'s rectangle, channel run and slots, the nk
``NkPlan``'s rectangle, run of groups, channel chunk and slots, or the
scalar path's tiles.  On the int8 tensor-core, dw and nk paths the plan's
tiles and banks do not shape the launch (``tc_plan`` / ``dw_plan`` /
``nk_plan`` size it from the geometry); only ``pipelined`` changes what
runs, so the fit
regresses many constant times against a DMA column that varies.  Its error is reported as it comes.

It needs a CUDA device.  ``run`` writes the fitted table with provenance
(card and power limit from ``nvidia-smi``, torch and CUDA versions, git
sha, ``mode: "native"`` and the grid); it refuses to write the
reference's ``CALIBRATION.json``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from dataclasses import replace
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import network, perfmodel
from repro_torch.core.banking import TilePlan, grouped_banks, plan_tiles
from repro_torch.core.calibration import (CalibrationSample,
                                          CalibrationTable, fit_calibration,
                                          sample_from_plan)
from repro_torch.kernels.conv2d_ws import (CONV_PATHS, conv2d_ws, conv_path,
                                           dw_plan, nk_plan, scalar_tiles,
                                           setup_conv, tc_plan)
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.kernels.conv2d_ws_trans import (conv2d_ws_transpose,
                                                 transpose_eq_conv_geometry)

# factorial axes, the reference's grid unchanged: (name, H, W, C, K, KH,
# groups, padding, dilation, op) × bank pairs × epilogues × {sequential,
# pipelined}; "tiledmap" plans under a 96 KiB budget (many slabs), the
# others as one tile; "transpose" upsamples by TRANSPOSE_STRIDE through
# the eq-conv lowering
SHAPES = [
    ("dense3x3",    16, 16, 16, 16, 3, 1,  "SAME",  1, "conv"),
    ("dense3x3big", 32, 32, 16, 16, 3, 1,  "SAME",  1, "conv"),
    ("pointwise",   16, 16, 32, 32, 1, 1,  "VALID", 1, "conv"),
    ("grouped",     16, 16, 32, 32, 3, 4,  "SAME",  1, "conv"),
    ("depthwise",   16, 16, 32, 32, 3, 32, "SAME",  1, "conv"),
    ("tiledmap",    64, 64, 16, 16, 3, 1,  "SAME",  1, "conv"),
    ("dilated2",    16, 16, 16, 16, 3, 1,  "SAME",  2, "conv"),
    ("transpose2x",  8,  8, 16, 16, 2, 1,  "VALID", 1, "transpose"),
]
BANKS = [(4, 4), (8, 8)]
TRANSPOSE_STRIDE = 2
TILED_BUDGET = 96 * 1024
EPILOGUES = [
    ("bare",    dict()),
    ("relu",    dict(relu=True)),
    ("relupool", dict(relu=True, pool=True)),
    ("requant", dict(out_scale=0.03125)),
]
SMOKE_SHAPES = [SHAPES[0], SHAPES[2], SHAPES[4], SHAPES[5], SHAPES[6],
                SHAPES[7]]
SMOKE_EPILOGUES = [EPILOGUES[1], EPILOGUES[3]]
ITERS, SMOKE_ITERS = 30, 10   # timed calls a point
MAIN_NET = "vgg_imagenet"
MAIN_BATCH = 8
MAIN_SCALE = 0.03125
VARIANTS = (("seq", False), ("pipe", True))


class Point(NamedTuple):
    """One grid point: what to launch (``op`` "conv" or "transpose", the
    operand shapes, the wrapper's keyword arguments) and what the model
    prices (the plan, per-image psums, the batch)."""
    label: str
    op: str
    x_shape: Tuple[int, int, int, int]
    w_shape: Tuple[int, int, int, int]
    kw: Dict[str, Any]
    out_scale: Optional[float]
    plan: TilePlan
    psums: int
    batch: int
    meta: Dict[str, Any]


def grid(smoke: bool = False) -> List[Point]:
    """The sweep's points: the reference's factorial grid (reduced with
    ``smoke``), then ``vgg_imagenet``'s six convs on both kernels."""
    shapes = SMOKE_SHAPES if smoke else SHAPES
    banks = BANKS[:1] if smoke else BANKS
    epilogues = SMOKE_EPILOGUES if smoke else EPILOGUES
    points = []
    for name, h, w, c, k, kh, groups, pad, dil, op in shapes:
        if op == "transpose":
            psums = perfmodel.conv_transpose_psum_count(
                h, w, c, k, kh, kh, stride=TRANSPOSE_STRIDE, padding=pad,
                groups=groups, dilation=dil)
            ph, pw, ppad = transpose_eq_conv_geometry(
                h, w, kh, kh, TRANSPOSE_STRIDE, pad, dil)
        else:
            psums = perfmodel.psum_count(h, w, c, k, kh, kh, padding=pad,
                                         groups=groups, dilation=dil)
            ph, pw, ppad = h, w, pad
        budget = TILED_BUDGET if name == "tiledmap" else None
        for cb, kb in banks:
            cb_n, kb_n = grouped_banks(c, k, groups, want_cin=cb,
                                       want_kout=kb)
            for ep_name, ep in epilogues:
                out_scale = ep.get("out_scale")
                for variant, pipelined in VARIANTS:
                    plan = plan_tiles(
                        ph, pw, c, k, kh, kh, padding=ppad, groups=groups,
                        dilation=dil, pool=ep.get("pool", False),
                        in_bytes=1,
                        out_bytes=1 if out_scale is not None else 4,
                        cin_banks=cb_n, kout_banks=kb_n, smem_budget=budget,
                        kernel="pipelined" if pipelined else "sequential")
                    kw = dict(stride=1, padding=pad, groups=groups,
                              dilation=dil, cin_banks=plan.cin_banks,
                              kout_banks=plan.kout_banks,
                              h_tile=plan.h_tile if plan.tiled else 0,
                              w_tile=plan.w_tile if plan.tiled else 0,
                              relu=ep.get("relu", False),
                              pool=ep.get("pool", False))
                    if op == "transpose":
                        kw.update(stride=TRANSPOSE_STRIDE,
                                  pipelined=pipelined)
                    label = (f"{name}/b{plan.cin_banks}x{plan.kout_banks}"
                             f"/{ep_name}/{variant}")
                    points.append(Point(
                        label, op, (1, h, w, c), (kh, kh, c // groups, k),
                        kw, out_scale, plan, psums, 1,
                        dict(shape=[h, w, c, k, kh], groups=groups,
                             epilogue=ep_name)))
    return points + _main_path_points()


def _main_path_points() -> List[Point]:
    plan = network.vgg_imagenet()
    acts, ins = plan.activation_shapes(), plan.resolved_inputs()
    pshapes = plan.param_shapes()
    psums = dict(plan.psum_table())
    names = plan.node_names()
    plans = {v: plan.tile_plans(in_bytes=1, kernel=kernel)
             for v, kernel in (("seq", "sequential"), ("pipe", "pipelined"))}
    points = []
    conv_i = 0
    for i, sp in enumerate(plan.layers):
        if sp.kind != "conv":
            continue
        src = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
        for variant, _ in VARIANTS:
            tp = plans[variant][i]
            kw = dict(stride=sp.stride, padding=sp.padding, groups=1,
                      dilation=sp.dilation, cin_banks=tp.cin_banks,
                      kout_banks=tp.kout_banks,
                      h_tile=tp.h_tile if tp.tiled else 0,
                      w_tile=tp.w_tile if tp.tiled else 0,
                      relu=sp.relu, pool=sp.pool)
            points.append(Point(
                f"{MAIN_NET}/conv{conv_i}/{variant}", "conv",
                (MAIN_BATCH, *src), tuple(pshapes[i]["w"]), kw, MAIN_SCALE,
                tp, psums[names[i]], MAIN_BATCH,
                dict(network=MAIN_NET, layer=names[i], conv=conv_i,
                     batch=MAIN_BATCH)))
        conv_i += 1
    return points


def launch_geometry(point: Point) -> Dict[str, Any]:
    """The geometry the point's launch runs, as ``setup_conv`` takes it:
    a transposed point's is its eq stride-1 conv on the zero-inserted
    map."""
    kw = point.kw
    x_shape, stride, padding = point.x_shape, kw["stride"], kw["padding"]
    groups = kw["groups"]
    cb, kb = kw["cin_banks"], kw["kout_banks"]
    if point.op == "transpose":
        n, h, w, c = x_shape
        kh, kwd = point.w_shape[:2]
        ph, pw, padding = transpose_eq_conv_geometry(
            h, w, kh, kwd, stride, padding, kw["dilation"])
        x_shape, stride = (n, ph, pw, c), 1
        cb, kb = grouped_banks(c, point.w_shape[3], groups, want_cin=cb,
                               want_kout=kb)
    return dict(x_shape=list(x_shape), w_shape=list(point.w_shape),
                stride=stride, padding=padding, groups=groups,
                cin_banks=cb, kout_banks=kb, h_tile=kw["h_tile"],
                w_tile=kw["w_tile"], dilation=kw["dilation"],
                pool=kw["pool"], relu=kw["relu"],
                requant=point.out_scale is not None,
                pipelined=point.plan.pipelined)


def launch_plan(geom: Dict[str, Any]) -> Dict[str, Any]:
    """What ``conv_path`` and its plans give a launch geometry: the path,
    and the tensor-core plan's N-tile, ring depth and slots, the dw plan's
    rectangle, channel run and slots, the nk plan's rectangle, run of
    groups, channel chunk and slots, or the scalar path's tiles."""
    g = setup_conv(tuple(geom["x_shape"]), tuple(geom["w_shape"]),
                   stride=geom["stride"], padding=geom["padding"],
                   groups=geom["groups"], cin_banks=geom["cin_banks"],
                   kout_banks=geom["kout_banks"], h_tile=geom["h_tile"],
                   w_tile=geom["w_tile"], pool=geom["pool"],
                   requant=geom["requant"], int_path=True,
                   dilation=geom["dilation"])
    path = conv_path(g)
    if path == "tc":
        tc = tc_plan(g, geom["relu"], geom["pipelined"])
        return dict(conv_path=path, bn=tc.bn, stages=tc.stages,
                    slots=tc.slots)
    if path == "dw":
        dw = dw_plan(g, geom["relu"], geom["pipelined"])
        return dict(conv_path=path, rh=dw.rh, rw=dw.rw, kc=dw.kc,
                    slots=dw.slots)
    if path == "nk":
        nk = nk_plan(g, geom["relu"], geom["pipelined"])
        return dict(conv_path=path, rh=nk.rh, rw=nk.rw, gr=nk.gr, cs=nk.cs,
                    slots=nk.slots)
    st = scalar_tiles(g, 2 if geom["pipelined"] else 1)
    return dict(conv_path=path, th=st.th, tw=st.tw, kb=st.kb)


def median_iqr(samples_us: Sequence[float]) -> Tuple[float, float]:
    """(median, inter-quartile range) of per-call times, as the
    reference's ``bench_util.Timing`` takes them: the mean of the two
    middle samples for an even count, quartiles at the lower ranks."""
    times = sorted(samples_us)
    n = len(times)
    if n == 0:
        raise ValueError("median_iqr needs at least one sample")
    mid = n // 2
    median = times[mid] if n % 2 else (times[mid - 1] + times[mid]) / 2.0
    q1 = times[max(0, (n - 1) // 4)]
    q3 = times[min(n - 1, (3 * (n - 1) + 2) // 4)]
    return median, q3 - q1


def time_calls(fn, iters: int, warmup: int = 2) -> Tuple[float, float]:
    """(median µs, IQR µs) of ``iters`` back-to-back calls of ``fn``, each
    between two CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return median_iqr([1e3 * s.elapsed_time(e) for s, e in events])


def _sample(point: Point, median_us: float, iqr_us: float,
            meta: Dict[str, Any]) -> CalibrationSample:
    s = sample_from_plan(point.label, point.plan, point.batch * point.psums,
                         median_us, iqr_us, pipelined=point.plan.pipelined,
                         **meta)
    if point.batch == 1:
        return s
    return replace(s, dma_bytes=point.batch * s.dma_bytes,
                   n_slabs=point.batch * s.n_slabs)


def sweep(smoke: bool = False, seed: int = 7,
          log=None) -> List[CalibrationSample]:
    """Time every grid point on the GPU → one sample each.  A point that
    fails to build or launch raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("the calibration sweep times the kernels on a "
                           "CUDA device, and none is available")
    dev = torch.device("cuda")
    iters = SMOKE_ITERS if smoke else ITERS
    gen = torch.Generator(device=dev).manual_seed(seed)
    samples = []
    for pt in grid(smoke):
        x = torch.randint(-128, 128, pt.x_shape, generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, pt.w_shape, generator=gen, device=dev,
                          dtype=torch.int8)
        scale = (None if pt.out_scale is None else
                 torch.tensor(pt.out_scale, dtype=torch.float32, device=dev))
        if pt.op == "transpose":
            fn, counted = conv2d_ws_transpose, (
                conv2d_ws_pipe if pt.plan.pipelined else conv2d_ws)
        else:
            fn = counted = conv2d_ws_pipe if pt.plan.pipelined else conv2d_ws
        paths = CONV_PATHS
        before = [counted.launches] + [getattr(counted, f"{p}_launches")
                                       for p in paths]
        fn(x, w, None, scale, **pt.kw)
        torch.cuda.synchronize()
        launched = [counted.launches - before[0]] + [
            getattr(counted, f"{p}_launches") - b
            for p, b in zip(paths, before[1:])]
        if launched[0] != 1:
            raise AssertionError(f"{pt.label}: {counted.__name__} launched "
                                 f"{launched[0]} times in one call")
        geom = launch_geometry(pt)
        meta = dict(pt.meta, kernel=counted.__name__, geometry=geom,
                    **launch_plan(geom))
        meta["conv_path"] = next(p for p, n in zip(paths, launched[1:])
                                 if n)
        med, iqr = time_calls(lambda: fn(x, w, None, scale, **pt.kw), iters)
        s = _sample(pt, med, iqr, meta)
        samples.append(s)
        if log is not None:
            log(f"  {pt.label}: {med:.2f} us (IQR {iqr:.2f}), "
                f"{meta['conv_path']} path, compute_cycles="
                f"{s.compute_cycles} dma_bytes={s.dma_bytes} "
                f"n_slabs={s.n_slabs}{' noisy' if s.noisy else ''}")
    return samples


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _git_sha() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=10,
                             cwd=Path(__file__).resolve().parent)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"


def provenance(smoke: bool, git_sha: Optional[str] = None
               ) -> Dict[str, Any]:
    shapes = SMOKE_SHAPES if smoke else SHAPES
    return {
        "card": card(),
        "device_kind": torch.cuda.get_device_name(0),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "git_sha": git_sha or _git_sha(),
        "mode": "native",
        "smoke": smoke,
        "grid": {
            "shapes": [s[0] for s in shapes],
            "banks": [list(b) for b in (BANKS[:1] if smoke else BANKS)],
            "epilogues": [e[0] for e in
                          (SMOKE_EPILOGUES if smoke else EPILOGUES)],
            "variants": [v for v, _ in VARIANTS],
            "main_path": f"{MAIN_NET} 224x224 convs at batch {MAIN_BATCH}",
            "iters": SMOKE_ITERS if smoke else ITERS,
        },
    }


def run(out_path: str, smoke: bool = False, git_sha: Optional[str] = None,
        log=None) -> Tuple[CalibrationTable, List[CalibrationSample]]:
    """Sweep, fit and write the table to ``out_path``."""
    if os.path.basename(out_path) == "CALIBRATION.json":
        raise ValueError("CALIBRATION.json is the reference's table; write "
                         "the card's to another path (CALIBRATION_h100.json)")
    samples = sweep(smoke=smoke, log=log)
    table = fit_calibration(samples, provenance=provenance(smoke, git_sha))
    table.save(out_path)
    return table, samples


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="CALIBRATION_h100.json")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced grid, fewer timed calls")
    ap.add_argument("--git-sha", default=None,
                    help="the commit the sources come from, where the "
                         "checkout has no git metadata")
    args = ap.parse_args(argv)
    table, samples = run(args.out, smoke=args.smoke, git_sha=args.git_sha,
                         log=print)
    print(table.to_json())
    print(f"{len(samples)} samples, fit {dict(table.fit)} → {args.out}")


if __name__ == "__main__":
    main()
