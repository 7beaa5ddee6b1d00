#!/usr/bin/env python3
"""Time the port's narrow-output convs (several input channels a group,
under 8 outputs) on one GPU, so that two trees can be compared in turns
within one run.

    PYTHONPATH=<tree>/src python3 tools/conv_nk_probe.py [--label L]
        [--reps 50] [--out <file>.json]

Layers (``nk_layers``, then ``CASES``' ``groups2``): ``unet_small``'s and
``dilated_context``'s 3-class heads at 224×224 and batch 8 (1×1, 8 and 16
channels to 3) in int8 as served (int32 out: the last conv dequantizes;
the banks and tiles of the network's default tile plan), ``unet_small``'s
head in f32 (its QAT forward, f32 out), and ``groups2`` in f32 ([2, 10,
10, 8] ⊛ [3, 3, 4, 8], 2 groups, SAME, ReLU).  Each runs through
``conv2d_ws`` and ``conv2d_ws_pipe``, and for each it prints:

* ``device_us``: the mean duration of the conv kernel's device events over
  ``--reps`` calls under ``torch.profiler`` (one conv kernel a call);
* ``ms``: CUDA events around ``--reps`` back-to-back calls, host work
  included;
* ``path``: the path the launch took, read from the wrapper's counters
  ("scalar" on a tree without the nk path);
* ``bound_us``: the larger of the bytes (each input read once, the output
  written once) over 3.35 TB/s and the multiply-adds over the type's peak
  (1,979 TOP/s int8, 67 TFLOP/s f32);
* for f32, ``library_us`` and ``library_ms``: ``F.conv2d(groups=...)``
  (cuDNN, TF32 off) on the same values laid out channels-last NCHW and
  padded outside the timing, every device event of a call summed;

beside the card's name and power limit, as one JSON line (and the file
``--out``).  ``chip_smoke.py`` times the same layers through
``nk_layers``."""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.core import network
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_ws import conv2d_ws
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe

sys.path.insert(0, str(Path(__file__).resolve().parent))
from conv_dw_probe import (conv2d_library, device_us,  # noqa: E402
                           layer_bytes, wall_ms)

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"int8": 1.979e15, "f32": 67e12}
BATCH = 8
GROUPS2 = ((2, 10, 10, 8), (3, 3, 4, 8),
           dict(padding="SAME", groups=2, relu=True))


def head(net):
    """(x shape, w shape, kwargs) of ``net``'s last conv, its 3-class
    head, at 224×224×4 and batch 8, under the network's default tile
    plan."""
    plan = getattr(network, net)(input_shape=(224, 224, 4), classes=3)
    acts, ins = plan.activation_shapes(), plan.resolved_inputs()
    i = max(j for j, sp in enumerate(plan.layers) if sp.kind == "conv")
    sp = plan.layers[i]
    tp = network.program_tile_plans(plan, ConvCoreConfig(int8=True))[i]
    src = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
    return (BATCH, *src), plan.param_shapes()[i]["w"], dict(
        stride=sp.stride, padding=sp.padding,
        groups=plan.conv_geometries()[i][1], cin_banks=tp.cin_banks,
        kout_banks=tp.kout_banks, h_tile=tp.h_tile, w_tile=tp.w_tile,
        relu=sp.relu, pool=sp.pool, dilation=sp.dilation)


def nk_layers():
    """(label, dtype, x shape, w shape, kwargs) of the segmentation heads
    the nk path serves: ``unet_small``'s and ``dilated_context``'s in int8
    as served, ``unet_small``'s in f32."""
    for net in ("unet_small", "dilated_context"):
        yield (f"{net} 3-class head int8", "int8", *head(net))
    yield ("unet_small 3-class head f32", "f32", *head("unet_small"))


def path_of(fn, call):
    """The path one call of ``call`` took on wrapper ``fn``."""
    paths = ("tc", "simt", "dw", "nk")
    counts = {p: getattr(fn, f"{p}_launches", 0) for p in paths}
    n = fn.launches
    call()
    torch.cuda.synchronize()
    if fn.launches != n + 1:
        raise AssertionError(f"{fn.__name__}: not one launch")
    return next((p for p, c in counts.items()
                 if getattr(fn, f"{p}_launches", 0) != c), "scalar")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_nk_probe: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    xs, ws, kw = GROUPS2
    cb, kb = ref.grouped_banks(xs[3], ws[3], kw["groups"])
    layers = list(nk_layers()) + [
        ("groups2 f32", "f32", xs, ws, dict(kw, cin_banks=cb,
                                            kout_banks=kb))]
    rows = []
    for label, dtype, xs, ws, kw in layers:
        if dtype == "int8":
            x = torch.randint(-128, 128, xs, generator=gen, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-128, 128, ws, generator=gen, device=dev,
                              dtype=torch.int8)
            b = torch.randint(-4000, 4000, (ws[3],), generator=gen,
                              device=dev, dtype=torch.int32)
        else:
            x = torch.randn(xs, generator=gen, device=dev)
            w = torch.randn(ws, generator=gen, device=dev) / 3
            b = torch.randn((ws[3],), generator=gen, device=dev)
        n, h, wd, _ = xs
        oh, ow = ref.conv_out_shape(h, wd, ws[0], ws[1], kw.get("stride", 1),
                                    kw.get("padding", "VALID"),
                                    kw.get("dilation", 1))
        out_es = 4
        nbytes = layer_bytes(x, w, False, n * oh * ow * ws[3], out_es)
        ops = 2 * n * oh * ow * ws[3] * ws[2] * ws[0] * ws[1]
        row = dict(layer=label, dtype=dtype, x=list(xs), w=list(ws),
                   bytes=nbytes, bound_us=1e6 * max(
                       nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S[dtype]))
        for fn in (conv2d_ws, conv2d_ws_pipe):
            call = (lambda fn=fn: fn(x, w, b, **kw))
            row[fn.__name__] = dict(
                path=path_of(fn, call),
                device_us=device_us(call, args.reps, ("conv_ws",)),
                ms=wall_ms(call, args.reps))
        if dtype == "f32":
            lib = conv2d_library(x, w, b, kw)
            row["library_us"] = device_us(lib, args.reps)
            row["library_ms"] = wall_ms(lib, args.reps)
        rows.append(row)
    out = dict(label=args.label, card=card, torch=torch.__version__,
               reps=args.reps, rows=rows)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
