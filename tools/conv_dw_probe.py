#!/usr/bin/env python3
"""Time the port's depthwise convs on one GPU, so that two trees can be
compared in turns within one run.

    PYTHONPATH=<tree>/src python3 tools/conv_dw_probe.py [--label L]
        [--reps 50] [--out <file>.json]

Layers: ``mobilenet_small``'s three depthwise convs at 224×224 and batch 8
(d1 224² × 8, d2 224² × 16 at stride 2, d3 112² × 32; 3×3, SAME, ReLU), in
int8 as served (requantized to int8, the banks and tiles of the network's
default tile plan) and in f32 (f32 out), and ``ops.conv1d_depthwise`` at
recurrentgemma-9b's temporal conv, [1, 4096, 4096] f32 with K = 4.  Each
runs through ``conv2d_ws`` and ``conv2d_ws_pipe`` (the served one is
marked), and for each it prints:

* ``device_us``: the mean duration of the conv kernel's device events over
  ``--reps`` calls under ``torch.profiler`` (each call launches one conv
  kernel: the mean over the events that arrived, so a lost event does
  not bias it);
* ``ms``: CUDA events around ``--reps`` back-to-back calls, host work
  included;
* ``path``: the path the launch took, read from the wrapper's counters
  ("scalar" on a tree without the dw path);
* ``bound_us``: the bytes each input read once and the output written once
  over 3.35 TB/s (the operations' bound is lower in every case);
* for f32, ``library_us``: ``F.conv2d(groups=C)`` (cuDNN, TF32 off) on the
  same values laid out channels-last NCHW and padded outside the timing,
  and for the 1-D conv ``F.conv1d(groups=W)``: every device event of a
  call, summed.

beside the card's name and power limit, as one JSON line (and the file
``--out``).  ``chip_smoke.py`` times the same layers against the same
yardsticks through ``mobilenet_layers``, ``layer_bytes``,
``conv2d_library`` and ``conv1d_library``."""

import argparse
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.core import network
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.conv2d_ws import conv2d_ws
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe

HBM_BYTES_PER_S = 3.35e12
BATCH = 8


def device_us(fn, reps, names=None):
    """Device time of one call of ``fn`` over ``reps`` calls after a
    warm-up: the mean duration of the events whose name holds one of
    ``names`` (one such kernel a call), or with ``names`` None every
    device event's duration summed over the calls."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [k.end_ns() - k.start_ns()
            for k in prof.profiler.kineto_results.events()
            if k.device_type() == torch.autograd.DeviceType.CUDA
            and (names is None or any(n in k.name() for n in names))]
    if not durs:
        raise RuntimeError(f"no device event named {names}")
    return sum(durs) / (reps if names is None else len(durs)) / 1e3


def wall_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def path_of(fn, call):
    """The path one call of ``call`` took on wrapper ``fn``."""
    counts = {p: getattr(fn, f"{p}_launches", 0) for p in ("tc", "simt",
                                                           "dw")}
    n = fn.launches
    call()
    torch.cuda.synchronize()
    if fn.launches != n + 1:
        raise AssertionError(f"{fn.__name__}: not one launch")
    return next((p for p, c in counts.items()
                 if getattr(fn, f"{p}_launches", 0) != c), "scalar")


def mobilenet_layers():
    """(label, x shape, w shape, kwargs, served kernel) of
    ``mobilenet_small``'s depthwise convs at 224, batch 8, under the
    network's default tile plan."""
    plan = network.mobilenet_small(input_shape=(224, 224, 4))
    acts, ins = plan.activation_shapes(), plan.resolved_inputs()
    pshapes, geoms = plan.param_shapes(), plan.conv_geometries()
    tps = network.program_tile_plans(plan, ConvCoreConfig(int8=True))
    names = plan.node_names()
    for i, tp in enumerate(tps):
        groups = geoms[i][1] if tp is not None else 1
        if tp is None or groups == 1:
            continue
        sp = plan.layers[i]
        src = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
        yield (names[i], (BATCH, *src), pshapes[i]["w"], dict(
            stride=sp.stride, padding=sp.padding, groups=groups,
            cin_banks=tp.cin_banks, kout_banks=tp.kout_banks,
            h_tile=tp.h_tile, w_tile=tp.w_tile, relu=sp.relu, pool=sp.pool,
            dilation=sp.dilation),
            "conv2d_ws_pipe" if tp.pipelined else "conv2d_ws")


def layer_bytes(x, w, requant, out_numel, out_es):
    """Bytes a conv moves at the least: x and w read once, the bias (and
    with ``requant`` the scales) read once, the output written once."""
    es = x.element_size()
    return ((x.numel() + w.numel()) * es + 4 * w.shape[-1] * (1 + requant)
            + out_numel * out_es)


def conv2d_library(x, w, b, kw):
    """``F.conv2d(groups=...)`` (cuDNN) computing the f32 conv of ``x``
    [N,H,W,C] ⊛ ``w`` [KH,KW,C/groups,K] with ``kw``'s stride, padding,
    dilation and groups (depthwise where it names none), on the same
    values laid out channels-last NCHW and padded here, outside any
    timing → a call that returns [N,K,OH,OW]."""
    h, wd, c = x.shape[1:]
    stride, dil = kw.get("stride", 1), kw.get("dilation", 1)
    pad = ref.normalize_padding(kw.get("padding", "VALID"), w.shape[0],
                                w.shape[1], stride, h, wd, dil)
    xc = F.pad(x.permute(0, 3, 1, 2), (pad[1][0], pad[1][1], pad[0][0],
                                       pad[0][1]))
    xc = xc.contiguous(memory_format=torch.channels_last)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xc, wc, b, stride=stride, dilation=dil,
                            groups=kw.get("groups", c))


def conv1d_library(x, w, bias):
    """``F.conv1d(groups=W)`` computing ``ops.conv1d_depthwise(x, w,
    bias)`` (x [B,S,W], w [K,W], causal) on the channels-first
    [B, W, S + K − 1] layout it takes, laid out here → a call that returns
    [B,W,S]."""
    k, width = w.shape
    xt = F.pad(x.transpose(1, 2), (k - 1, 0)).contiguous()
    wt = w.t().contiguous()[:, None, :]
    return lambda: F.conv1d(xt, wt, bias, groups=width)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_dw_probe: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    rows = []
    kernel_names = ("conv_ws",)
    for label, xs, ws, kw, served in mobilenet_layers():
        n, h, wd, _ = xs
        oh, ow = ref.conv_out_shape(h, wd, ws[0], ws[1], kw["stride"],
                                    kw["padding"], kw["dilation"])
        for dtype in ("int8", "f32"):
            if dtype == "int8":
                x = torch.randint(-128, 128, xs, generator=gen, device=dev,
                                  dtype=torch.int8)
                w = torch.randint(-128, 128, ws, generator=gen, device=dev,
                                  dtype=torch.int8)
                b = torch.randint(-4000, 4000, (ws[3],), generator=gen,
                                  device=dev, dtype=torch.int32)
                scale, es_out = 0.0031, 1
            else:
                x = torch.randn(xs, generator=gen, device=dev)
                w = torch.randn(ws, generator=gen, device=dev) / 3
                b = torch.randn((ws[3],), generator=gen, device=dev)
                scale, es_out = None, 4
            nbytes = layer_bytes(x, w, scale is not None,
                                 n * oh * ow * ws[3], es_out)
            row = dict(layer=label, dtype=dtype, x=list(xs), w=list(ws),
                       served=served, bytes=nbytes,
                       bound_us=1e6 * nbytes / HBM_BYTES_PER_S)
            for fn in (conv2d_ws, conv2d_ws_pipe):
                call = (lambda fn=fn: fn(x, w, b, scale, **kw))
                row[fn.__name__] = dict(
                    path=path_of(fn, call),
                    device_us=device_us(call, args.reps, kernel_names),
                    ms=wall_ms(call, args.reps))
            if dtype == "f32":
                lib = conv2d_library(x, w, b, kw)
                row["library_us"] = device_us(lib, args.reps)
                row["library_ms"] = wall_ms(lib, args.reps)
            rows.append(row)
    # recurrentgemma-9b's temporal conv through its op
    s_len, width, k = 4096, 4096, 4
    x = torch.randn(1, s_len, width, generator=gen, device=dev)
    w = torch.randn(k, width, generator=gen, device=dev) / 2
    bias = torch.randn(width, generator=gen, device=dev)
    call = (lambda: ops.conv1d_depthwise(x, w, bias))
    nbytes = layer_bytes(x, w, False, s_len * width, 4)
    lib = conv1d_library(x, w, bias)
    rows.append(dict(
        layer="conv1d_depthwise", dtype="f32", x=[1, s_len, width],
        w=[k, width], served="conv2d_ws", bytes=nbytes,
        bound_us=1e6 * nbytes / HBM_BYTES_PER_S,
        conv2d_ws=dict(path=path_of(conv2d_ws, call),
                       device_us=device_us(call, args.reps, kernel_names),
                       ms=wall_ms(call, args.reps)),
        library_us=device_us(lib, args.reps),
        library_ms=wall_ms(lib, args.reps)))
    out = dict(label=args.label, card=card, torch=torch.__version__,
               reps=args.reps, rows=rows)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
