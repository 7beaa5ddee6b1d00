"""The paper end to end on the port: the §5.2 workload ([224×224×8] ⊛
[8×3×3×8]) through ``ConvCore`` — the float conv on the hand-written
kernel, the quantized int8 datapath, and the cycle model reproducing the
paper's 0.224 / 4.48 GOPS — then the same layer timed on the card beside
its H100 roofline, the network executor (a LeNet-style int8
``NetworkPlan`` as one program, scheduled over 4 virtual IP cores), a
residual graph served through ``ConvNetEngine``, the depthwise family,
spatially tiled maps, and a tiny LeNet trained with QAT through the
kernels' backward and dropped into the int8 pipeline.

Paper → H100 mapping of the network path:
* one FPGA IP core processing "a convolutional layer at a time"  ↔  one
  launch of ``conv2d_ws`` / ``conv2d_ws_pipe`` (the fused ReLU → pool →
  requantize epilogue is the FPGA's post-processing before writeback);
* the host sequencing layer passes through the output BRAMs  ↔  the
  int8 program chaining int8 feature maps in HBM;
* ~20 replicated IP cores on the full board  ↔  virtual cores in
  ``core/scheduler.py`` (batch, kernel-set or row-band division).

    PYTHONPATH=src python -m repro_torch.examples.conv_acceleration \
        [--device cpu]

It runs on the card unless ``--device`` names another device; ``main``
returns the printed figures as a dict.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import network, scheduler, training
from repro_torch.core.banking import plan_banks
from repro_torch.core.convcore import ConvCore, ConvCoreConfig, paper_workload
from repro_torch.core.perfmodel import (IPCoreConfig, gops_macs, gops_paper,
                                        h100_conv_roofline, psum_count,
                                        seconds)
from repro_torch.core.quantize import quantize_symmetric
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.serving.engine import ConvNetEngine

TIMED_CALLS = 50          # the §5.2 layer's timed calls on the card


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def card_name_and_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (the first card), or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def median_card_ms(fn, calls: int = TIMED_CALLS) -> float:
    """Median ms of ``calls`` calls of ``fn`` on the card, each between
    two CUDA events on the current stream, after three untimed calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def paper_layer(dev: torch.device) -> Tuple[Dict, Tuple[torch.Tensor, ...]]:
    """§4.1 banking, the float conv through ``ConvCore``, the int8
    datapath's error against the float oracle, and the §5.2 model →
    (the figures, the layer's float x, w, bias)."""
    wl = paper_workload()
    rng = np.random.default_rng(0)
    x = _tensor(rng.normal(size=wl["x"]), dev) * 0.5
    w = _tensor(rng.normal(size=wl["w"]), dev) * 0.1
    b = _tensor(rng.normal(size=wl["bias"]), dev) * 0.1
    print("=== paper workload:", wl)

    bp = plan_banks(224, 224, 8, 8, in_bytes=1)
    print(f"bank plan: {bp.cin_banks} image banks × {bp.kout_banks} kernel "
          f"banks; shared-memory working set "
          f"{bp.working_set_bytes / 1024:.0f} KiB (fits: {bp.fits_smem})")

    core = ConvCore(ConvCoreConfig())
    t0 = time.perf_counter()
    out = core.apply_layer(x, w, b)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    float_s = time.perf_counter() - t0
    print(f"float conv: out {tuple(out.shape)} in {float_s:.2f}s on {dev} "
          f"(first call)")

    got = core.apply_quantized_layer(x, w, b)
    int8_rel = _rel(got, ref.conv2d_ref(x, w, b))
    print(f"int8 datapath relative error vs float oracle: {int8_rel:.4f}")

    n = psum_count(224, 224, 8, 8)
    c20 = IPCoreConfig(ip_cores=20)
    fig = {"bank_plan": {"cin_banks": bp.cin_banks,
                         "kout_banks": bp.kout_banks,
                         "working_set_bytes": bp.working_set_bytes,
                         "fits_smem": bp.fits_smem},
           "float_out_shape": tuple(out.shape), "float_conv_s": float_s,
           "int8_rel_err": int8_rel, "psums": n,
           "seconds_1core": seconds(n), "gops_paper_1core": gops_paper(n),
           "gops_macs_1core": gops_macs(n), "seconds_20core": seconds(n, c20),
           "gops_paper_20core": gops_paper(n, c20)}
    print("\n=== §5.2 performance model")
    print(f"psums: {n:,} (paper: 3,154,176)")
    print(f"1 IP core  @112MHz: {fig['seconds_1core'] * 1e3:.3f} ms  "
          f"{fig['gops_paper_1core']:.3f} GOPS-paper  "
          f"{fig['gops_macs_1core']:.3f} GOPS-MACs")
    print(f"20 IP cores        : {fig['seconds_20core'] * 1e3:.3f} ms  "
          f"{fig['gops_paper_20core']:.2f} GOPS-paper")
    return fig, (x, w, b)


def h100_layer(dev: torch.device, x, w, b) -> Dict:
    """The same layer on the H100: its int8 roofline, and on the card the
    median time of the int8 layer through ``ConvCore(int8=True)`` beside
    the card's name and power limit and the FPGA core's time."""
    r = h100_conv_roofline(224, 224, 8, 8)
    fpga_s = seconds(psum_count(224, 224, 8, 8))
    bound = "memory" if r["t_memory"] > r["t_compute"] else "compute"
    print("\n=== the same layer on one H100 (int8 roofline)")
    print(f"bound: {bound}  time {r['seconds'] * 1e6:.2f} µs  "
          f"{r['gops_paper']:.0f} GOPS-paper  "
          f"({fpga_s / r['seconds']:.0f}× the FPGA IP core)")
    fig = {"bound_us": r["seconds"] * 1e6, "bound_by": bound,
           "bound_gops_paper": r["gops_paper"], "card_us": None,
           "card": None, "x_fpga": None}
    if dev.type != "cuda":
        print(f"no card time taken: the layer ran on {dev}")
        return fig
    xq, wq = quantize_symmetric(x), quantize_symmetric(w)
    bias = torch.round(b / (xq.scale * wq.scale)).to(torch.int32)
    core = ConvCore(ConvCoreConfig(int8=True))
    ms = median_card_ms(lambda: core.apply_layer(xq.values, wq.values, bias))
    fig.update(card_us=ms * 1e3, card=card_name_and_limit(),
               x_fpga=fpga_s / (ms * 1e-3))
    print(f"measured on {fig['card']}: {fig['card_us']:.2f} µs a call "
          f"(median of {TIMED_CALLS}, CUDA events, host work included), "
          f"{fig['card_us'] / fig['bound_us']:.1f}× the bound, "
          f"{fig['x_fpga']:.0f}× faster than the FPGA IP core")
    return fig


def lenet_program(dev: torch.device, rng: np.random.Generator) -> Dict:
    """The LeNet-style int8 program, on one core and on 4 batch-sharded
    virtual cores, and the whole-network cycle model with the board."""
    plan = network.lenet()
    print(f"\n=== network executor: {plan.name} "
          f"{plan.input_shape} → {plan.activation_shapes()[-1]}")
    params = plan.init_params(rng, device=dev)
    imgs = _tensor(rng.normal(size=(8, 28, 28, 1)), dev)
    with torch.no_grad():
        want = plan.apply_ref(params, imgs)
    qnet = network.quantize_network(plan, params, imgs)
    program = network.make_int8_program(qnet, ConvCoreConfig(int8=True))
    t0 = time.perf_counter()
    logits = program(imgs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fig = {"program_s": time.perf_counter() - t0,
           "int8_rel_err": _rel(logits, want)}
    print(f"int8 network ({len(plan.layers)} layers, all inter-layer maps "
          f"int8): {fig['program_s']:.2f}s, rel err vs float "
          f"{fig['int8_rel_err']:.4f}")
    sched = scheduler.MultiCoreScheduler(
        scheduler.SchedulerConfig(n_cores=4))
    logits_mc = sched.run(program, imgs)
    fig["multicore_max_abs"] = float(torch.max(torch.abs(logits_mc
                                                         - logits)))
    print(f"4 virtual IP cores (batch-sharded): max|Δ| = "
          f"{fig['multicore_max_abs']:.1f} (exact)")

    rep = plan.perf_report()
    print(f"\nwhole-network cycle model ({plan.name}):")
    for row in rep["layers"]:
        if row["psums"]:
            print(f"  {row['name']:<10} {row['psums']:>10,} psums  "
                  f"{row['cycles']:>8,} cycles")
    print(f"  total      {rep['psums']:>10,} psums  {rep['cycles']:>8,} "
          f"cycles = {rep['seconds'] * 1e3:.3f} ms @112MHz "
          f"({rep['gops_paper']:.3f} GOPS-paper)")
    fb = rep["full_board"]
    print(f"  full board ({fb['ip_cores']} IP cores): "
          f"{fb['seconds'] * 1e3:.3f} ms ({fb['gops_paper']:.2f} GOPS-paper)")
    fig["report"] = rep
    return fig


def resnet_engine(dev: torch.device, rng: np.random.Generator) -> Dict:
    """``resnet_small`` (skip connections as int8 merge adds) served by
    ``ConvNetEngine`` over 2 virtual cores: a ragged 6-image submit, then
    a lone async request, which must equal its row of the batch."""
    rn = network.resnet_small()
    print(f"\n=== residual graph: {rn.name} {rn.input_shape} "
          f"({sum(1 for sp in rn.layers if sp.kind == 'add')} skip adds, "
          f"{sum(1 for sp in rn.layers if sp.kind == 'conv')} convs)")
    params = rn.init_params(rng, device=dev)
    imgs = np.asarray(rng.normal(size=(6, *rn.input_shape)), np.float32)
    with torch.no_grad():
        want = rn.apply_ref(params, _tensor(imgs, dev)).cpu().numpy()
    qrn = network.quantize_network(rn, params, _tensor(imgs, dev),
                                   per_channel=True)
    engine = ConvNetEngine(qrn, batch=4, n_cores=2, device=dev)
    try:
        t0 = time.perf_counter()
        logits = engine.submit(imgs)          # ragged 6 over batch-4 pads
        fig = {"submit_s": time.perf_counter() - t0,
               "int8_rel_err": float(np.linalg.norm(logits - want)
                                     / np.linalg.norm(want)),
               "batches": engine.stats["batches"],
               "padded": engine.stats["padded"]}
        print(f"int8 resnet via ConvNetEngine (2 virtual cores, "
              f"{fig['batches']} batches, {fig['padded']} padded): "
              f"{fig['submit_s']:.2f}s, rel err vs float "
              f"{fig['int8_rel_err']:.4f}")
        rep = rn.perf_report()
        fig["model_seconds"] = rep["seconds"]
        print(f"model: {rep['seconds'] * 1e3:.3f} ms @112MHz "
              f"({rep['gops_paper']:.3f} GOPS-paper; branches serialize on "
              f"the layer-at-a-time core)")
        # a lone request launches on the deadline, not on a full batch;
        # the latency includes its queue wait
        lone = engine.submit_async(imgs[0]).result(timeout=600)
        fig["lone_equal"] = bool(np.array_equal(lone, logits[0]))
        if not fig["lone_equal"]:
            raise AssertionError("the lone async request differs from its "
                                 "row of the batch")
        pct = engine.latency_percentiles()
        fig.update(formation=engine.engine.formation_counts(),
                   p50_us=pct["p50"], requests=pct["count"])
        print(f"continuous batching: lone async request served "
              f"(formation {fig['formation']}), p50 enqueue-to-result "
              f"{pct['p50'] / 1e3:.1f} ms over {pct['count']} requests")
    finally:
        engine.close()
    return fig


def mobilenet_program(dev: torch.device, rng: np.random.Generator) -> Dict:
    """The depthwise-separable family: ``mobilenet_small`` as an int8
    program (its depthwise layers on the kernels' dw path on the card) and
    its cycle model with tile plans."""
    mb = network.mobilenet_small()
    fig = {"grouped_layers": mb.grouped_layer_count()}
    print(f"\n=== grouped conv: {mb.name} {mb.input_shape} "
          f"({fig['grouped_layers']} depthwise layers)")
    params = mb.init_params(rng, device=dev)
    imgs = _tensor(rng.normal(size=(4, *mb.input_shape)), dev)
    with torch.no_grad():
        want = mb.apply_ref(params, imgs)
    qmb = network.quantize_network(mb, params, imgs, per_channel=True)
    prog = network.make_int8_program(qmb, ConvCoreConfig(int8=True))
    fig["int8_rel_err"] = _rel(prog(imgs), want)
    print(f"int8 depthwise-separable network: rel err vs float "
          f"{fig['int8_rel_err']:.4f}")
    rep = mb.perf_report(tile_plans=mb.tile_plans())
    fig.update(priced=sum(1 for r in rep["layers"] if "dma_bound" in r),
               dma_bound_board_layers=rep["dma_bound_board_layers"],
               model_seconds=rep["seconds"])
    print(f"model: {rep['seconds'] * 1e3:.3f} ms @112MHz; on the full board "
          f"the SHARED DMA interface binds "
          f"{fig['dma_bound_board_layers']}/{fig['priced']} priced layers — "
          "the depthwise arithmetic-intensity story")
    return fig


def large_map_plans() -> Dict:
    """Maps larger than a block's shared memory stream through halo'd
    spatial tiles (the paper's fixed-size image BRAMs, generalised)."""
    lm = network.large_map()
    print(f"\n=== spatially-tiled pipeline: {lm.name} {lm.input_shape}")
    plans = []
    for sp, tp in zip(lm.layers, lm.tile_plans()):
        if tp is None:
            continue
        plans.append(tp)
        print(f"  conv K={sp.features:<4} tile {tp.h_tile}×{tp.w_tile} "
              f"({tp.n_h_tiles}×{tp.n_w_tiles} tiles, halo re-read "
              f"×{tp.halo_read_factor:.3f})  working set "
              f"{tp.working_set_bytes / 1024:.1f} KiB "
              f"(fits shared memory: {tp.fits_smem})")
    rep = lm.perf_report(tile_plans=lm.tile_plans())
    print(f"  model w/ tile+halo DMA pricing: {rep['seconds'] * 1e3:.3f} ms"
          f" @112MHz; full board {rep['full_board']['seconds'] * 1e3:.3f} ms"
          f" (shared-DDR floor keeps 20-core GOPS honest)")
    return {"tile_plans": plans, "model_seconds": rep["seconds"],
            "board_seconds": rep["full_board"]["seconds"]}


def qat_and_deploy(dev: torch.device, steps: int = 50) -> Dict:
    """QAT of ``lenet((12,12,1))`` on synthetic digits through the
    kernels' backward, then the trained weights through the int8
    pipeline."""
    tiny = network.lenet(input_shape=(12, 12, 1))
    print(f"\n=== training: {tiny.name} {tiny.input_shape} on synthetic "
          "digits (QAT float shadow)")
    rng = np.random.default_rng(11)
    x_tr, y_tr = training.synthetic_digits(rng, 384, device=dev)
    x_ev, y_ev = training.synthetic_digits(rng, 192, device=dev)
    t0 = time.perf_counter()
    state, hist = training.fit(tiny, x_tr, y_tr, steps=steps, batch=32,
                               cfg=training.TrainConfig(qat=True), seed=12,
                               device=dev)
    with torch.no_grad():
        float_acc = float(training.accuracy(
            training.float_forward(tiny, state.params, x_ev), y_ev))
    fig = {"steps": steps, "fit_s": time.perf_counter() - t0,
           "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
           "float_acc": float_acc}
    print(f"{steps} QAT steps in {fig['fit_s']:.1f}s: loss "
          f"{fig['loss_first']:.2f} → {fig['loss_last']:.3f}; float shadow "
          f"eval acc {float_acc:.3f}")
    qtiny = network.quantize_network(tiny, state.params, x_tr[:128])
    prog = network.make_int8_program(qtiny, ConvCoreConfig(int8=True))
    fig["int8_acc"] = float(training.accuracy(prog(x_ev), y_ev))
    print(f"deployed int8 eval acc {fig['int8_acc']:.3f} "
          f"(Δ {float_acc - fig['int8_acc']:+.3f} vs the float shadow)")
    rep = tiny.train_report()
    fig["train_report"] = rep
    print(f"train-step model: {rep['seconds'] * 1e3:.3f} ms @112MHz "
          f"({rep['backward']['cycles'] / rep['cycles']:.0%} backward; "
          f"≈3× forward psums — perfmodel.train_report)")
    return fig


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    paper, (x, w, b) = paper_layer(dev)
    fig = {"paper": paper, "h100": h100_layer(dev, x, w, b)}
    rng = np.random.default_rng(7)       # one stream, as the reference's
    fig["lenet"] = lenet_program(dev, rng)
    fig["resnet"] = resnet_engine(dev, rng)
    fig["mobilenet"] = mobilenet_program(dev, rng)
    fig["large_map"] = large_map_plans()
    fig["qat"] = qat_and_deploy(dev)
    return fig


if __name__ == "__main__":
    main()
