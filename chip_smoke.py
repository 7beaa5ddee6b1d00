#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any mismatch:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (``vgg_imagenet``'s six convs at
   224×224 under their Hopper tile plans, the ``lenet`` convs, the §5.2
   layer, depthwise / stride-2 / dilation-2 / per-channel-requant layers,
   the dense heads): int paths ``torch.equal``, f32 within 1e-4; time each
   kernel and its plain version with CUDA events beside its bound;
4. run the §5.2 layer through ``ConvCore(ConvCoreConfig(int8=True))``;
5. the main path: ``vgg_imagenet`` (224×224×4, 1000 classes, random
   weights from a seed) quantized on a 16-image calibration batch, served
   to 16 requests through ``ConvNetEngine(batch=8)``: logits bit-equal to
   the plain backend, launch counts read around the run; again with
   ``kernel="sequential"``; then ``lenet``, whose card logits must also
   equal the CPU run of the same program;
6. print the per-kernel JSON line and, last, the run's device line.

It needs a CUDA device and the repository's ``src`` beside it.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BATCH = 8
REQUESTS = 16
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12      # H100 SXM data sheet, dense int8
F32_TOL = 1e-4
KERNELS = {
    "conv2d_ws": ("src/repro_torch/kernels/csrc/conv2d_ws.cu",
                  "src/repro/kernels/conv2d_ws.py:255"),
    "conv2d_ws_pipe": ("src/repro_torch/kernels/csrc/conv2d_ws_pipe.cu",
                       "src/repro/kernels/conv2d_ws_pipe.py:193"),
    "matmul_ws": ("src/repro_torch/kernels/csrc/matmul_ws.cu",
                  "src/repro/kernels/matmul_ws.py:47"),
}


def log(*parts):
    print(*parts, flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    import numpy as np
    from repro_torch.core import network, perfmodel
    from repro_torch.core.convcore import (ConvCore, ConvCoreConfig,
                                           paper_workload)
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.conv2d_ws import conv2d_ws, conv2d_ws_plain
    from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
    from repro_torch.kernels.matmul_ws import matmul_ws, matmul_ws_plain
    from repro_torch.serving.engine import ConvNetEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {"conv2d_ws": conv2d_ws, "conv2d_ws_pipe": conv2d_ws_pipe,
                "matmul_ws": matmul_ws}
    stats = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bytes=0,
                     ops=0, launches=0) for k in KERNELS}

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or ("spill" in line
                                  and " 0 bytes spill" not in line):
                log(f"  {name}: {line.strip()}")

    def elapsed_ms(fn, reps, warmup=2):
        for _ in range(warmup):
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

    def bound_ms(nbytes, ops):
        return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def rand_bias(k):
        return torch.randint(-4000, 4000, (k,), generator=gen, device=dev,
                             dtype=torch.int32)

    def compare(name, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max()) \
            if got.numel() else 0.0
        if want.is_floating_point():
            ok = torch.allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max abs err {err})")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        return err

    # -- 3. kernels against their plain versions ---------------------------
    def check_conv(label, x, w, b, scale, kw, timed=False):
        """Both conv kernels against ``conv2d_ws_plain``; ``scale`` is
        "scalar" / "per_k" (derived from the plain accumulator so the int8
        outputs span the grid) or None (int32 / f32 out)."""
        if scale is not None:
            acc = conv2d_ws_plain(x, w, b, None, **kw).double().abs()
            if scale == "per_k":
                amax = acc.reshape(-1, acc.shape[-1]).amax(0).clamp(min=1)
                scale = (100.0 / amax).float()
            else:
                scale = 100.0 / max(float(acc.max()), 1.0)
        want = conv2d_ws_plain(x, w, b, scale, **kw)
        torch.cuda.synchronize()
        row = []
        for name in ("conv2d_ws", "conv2d_ws_pipe"):
            fn = wrappers[name]
            got = fn(x, w, b, scale, **kw)
            torch.cuda.synchronize()
            compare(name, got, want)
            if timed:
                ms = elapsed_ms(lambda: fn(x, w, b, scale, **kw), reps=10)
                row.append(f"{name} {ms:.3f} ms")
                stats[name]["ms"] += ms
        if timed:
            n, h, wd, c = x.shape
            kh, kwd, cg, k = w.shape
            oh, ow = ref.conv_out_shape(h, wd, kh, kwd, kw.get("stride", 1),
                                        kw.get("padding", "VALID"),
                                        kw.get("dilation", 1))
            nbytes = (x.numel() * x.element_size() + w.numel()
                      * w.element_size() + 8 * k
                      + want.numel() * want.element_size())
            ops = 2 * n * oh * ow * k * kh * kwd * cg
            plain = elapsed_ms(lambda: conv2d_ws_plain(x, w, b, scale, **kw),
                               reps=3, warmup=1)
            for name in ("conv2d_ws", "conv2d_ws_pipe"):
                stats[name]["plain_ms"] += plain
                stats[name]["bytes"] += nbytes
                stats[name]["ops"] += ops
            row.append(f"plain {plain:.3f} ms, bound "
                       f"{bound_ms(nbytes, ops):.4f} ms")
        log(f"  {label}: x{tuple(x.shape)} w{tuple(w.shape)} {kw} "
            f"equal{'; ' + ', '.join(row) if row else ''}")

    def check_matmul(label, m, k, n, timed=False):
        x, w, b = rand_i8(m, k), rand_i8(k, n), rand_bias(n)
        compare("matmul_ws", matmul_ws(x, w, b), matmul_ws_plain(x, w, b))
        xf, wf, bf = x.float() / 64, w.float() / 64, b.float() / 100
        compare("matmul_ws", matmul_ws(xf, wf, bf),
                matmul_ws_plain(xf, wf, bf))
        row = ""
        if timed:
            ms = elapsed_ms(lambda: matmul_ws(x, w, b), reps=20)
            plain = elapsed_ms(lambda: matmul_ws_plain(x, w, b), reps=20)
            nbytes, ops = m * k + k * n + 4 * n + 4 * m * n, 2 * m * k * n
            st = stats["matmul_ws"]
            st["ms"] += ms
            st["plain_ms"] += plain
            st["bytes"] += nbytes
            st["ops"] += ops
            row = (f"; matmul_ws {ms:.4f} ms, plain {plain:.4f} ms, bound "
                   f"{bound_ms(nbytes, ops):.5f} ms")
        log(f"  {label}: [{m},{k}]@[{k},{n}] int8 and f32 equal{row}")

    def net_layers(plan):
        """(input shape, weight shape, conv kwargs) of every conv of
        ``plan`` under its default Hopper tile plan."""
        acts, ins = plan.activation_shapes(), plan.resolved_inputs()
        pshapes, geoms = plan.param_shapes(), plan.conv_geometries()
        plans = network.program_tile_plans(plan, ConvCoreConfig(int8=True))
        for i, tp in enumerate(plans):
            if tp is None:
                continue
            sp = plan.layers[i]
            src = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
            yield (BATCH, *src), pshapes[i]["w"], dict(
                stride=sp.stride, padding=sp.padding, groups=geoms[i][1],
                cin_banks=tp.cin_banks, kout_banks=tp.kout_banks,
                h_tile=tp.h_tile, w_tile=tp.w_tile, relu=sp.relu,
                pool=sp.pool, dilation=sp.dilation)

    log("phase 3: kernels against their plain versions")
    for i, (xs, ws, kw) in enumerate(net_layers(network.vgg_imagenet())):
        check_conv(f"vgg_imagenet conv{i}", rand_i8(*xs), rand_i8(*ws),
                   rand_bias(ws[3]), "scalar", kw, timed=True)
    for i, (xs, ws, kw) in enumerate(net_layers(network.lenet())):
        check_conv(f"lenet conv{i}", rand_i8(*xs), rand_i8(*ws),
                   rand_bias(ws[3]), "scalar", kw)
    shp = paper_workload()
    tp = ConvCore(ConvCoreConfig(int8=True)).plan(shp["x"], shp["w"])
    check_conv("§5.2 layer, int32 out", rand_i8(*shp["x"]), rand_i8(*shp["w"]),
               rand_bias(8), None, dict(
                   cin_banks=tp.cin_banks, kout_banks=tp.kout_banks,
                   h_tile=tp.h_tile, w_tile=tp.w_tile))
    check_conv("depthwise", rand_i8(BATCH, 56, 56, 32), rand_i8(3, 3, 1, 32),
               rand_bias(32), "scalar",
               dict(padding="SAME", groups=32, cin_banks=1, kout_banks=32,
                    relu=True, h_tile=28, w_tile=28))
    check_conv("stride 2", rand_i8(BATCH, 57, 57, 16), rand_i8(3, 3, 16, 32),
               rand_bias(32), "scalar",
               dict(stride=2, padding="SAME", relu=True))
    check_conv("dilation 2", rand_i8(BATCH, 40, 40, 16),
               rand_i8(3, 3, 16, 16), rand_bias(16), "scalar",
               dict(padding=((2, 1), (0, 3)), dilation=2, h_tile=10,
                    w_tile=20))
    check_conv("per-channel requant", rand_i8(BATCH, 28, 28, 64),
               rand_i8(3, 3, 64, 64), rand_bias(64), "per_k",
               dict(padding="SAME", relu=True, pool=True))
    xf = torch.randn(BATCH, 30, 30, 32, generator=gen, device=dev)
    wf = torch.randn(3, 3, 32, 64, generator=gen, device=dev) / 16
    check_conv("f32", xf, wf, torch.randn(64, generator=gen, device=dev),
               None, dict(padding="SAME", relu=True, pool=True, h_tile=8,
                          w_tile=10))
    check_matmul("vgg_imagenet head", BATCH, 256, 1000, timed=True)
    check_matmul("lenet dense0", BATCH, 512, 64)
    check_matmul("lenet dense1", BATCH, 64, 10)

    # -- 4. the §5.2 layer through ConvCore --------------------------------
    log("phase 4: the §5.2 layer through ConvCore(int8=True)")
    x, w, b = rand_i8(*shp["x"]), rand_i8(*shp["w"]), rand_bias(8)
    got = ConvCore(ConvCoreConfig(int8=True)).apply_layer(x, w, b)
    want = ConvCore(ConvCoreConfig(int8=True, backend="ref")).apply_layer(
        x, w, b)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("§5.2 layer: ConvCore differs from the plain "
                             "backend")
    anchors = perfmodel.paper_reference_numbers()
    log(f"  out {tuple(got.shape)} {got.dtype} equal to the plain backend; "
        f"psums {anchors['psums']:,} (paper model: "
        f"{anchors['gops_1core']:.3f} GOPS on one FPGA core)")
    if anchors["psums"] != 3_154_176:
        raise AssertionError(f"§5.2 psum count {anchors['psums']}")

    # -- 5. the main path --------------------------------------------------
    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    def serve(name, plan, seed):
        rng = np.random.default_rng(seed)
        params = plan.init_params(rng, device=dev)
        calib = torch.from_numpy(rng.normal(
            size=(REQUESTS, *plan.input_shape)).astype(np.float32)).to(dev)
        t0 = time.perf_counter()
        qnet = network.quantize_network(plan, params, calib)
        torch.cuda.synchronize()
        log(f"  {name}: quantized on {REQUESTS} calibration images in "
            f"{time.perf_counter() - t0:.2f} s")
        images = rng.normal(size=(REQUESTS, *plan.input_shape)).astype(
            np.float32)
        with torch.no_grad():
            float_logits = plan.apply_ref(
                params, torch.from_numpy(images).to(dev)).cpu().numpy()
        ref_logits = ConvNetEngine(qnet, batch=BATCH, core_config=ConvCoreConfig(
            int8=True, backend="ref")).submit(images)
        results = {}
        for kernel, expect in (("auto", "conv2d_ws_pipe"),
                               ("sequential", "conv2d_ws")):
            engine = ConvNetEngine(qnet, batch=BATCH, core_config=ConvCoreConfig(
                int8=True, kernel=kernel))
            reset_counts()
            logits = engine.submit(images)
            seen, served = counts(), engine.stats
            batches = -(-REQUESTS // BATCH)
            n_conv = sum(sp.kind == "conv" for sp in plan.layers)
            n_dense = sum(sp.kind == "dense" for sp in plan.layers)
            want = {k: 0 for k in wrappers}
            want[expect] = n_conv * batches
            want["matmul_ws"] = n_dense * batches
            if seen != want:
                raise AssertionError(f"{name} kernel={kernel}: launches "
                                     f"{seen}, expected {want}")
            if logits.shape != (REQUESTS, plan.activation_shapes()[-1][0]) \
                    or not np.isfinite(logits).all():
                raise AssertionError(f"{name}: bad logits {logits.shape}")
            if not np.array_equal(logits, ref_logits):
                raise AssertionError(f"{name} kernel={kernel}: logits differ "
                                     f"from the plain backend")
            t0 = time.perf_counter()
            reps = 3
            for _ in range(reps):
                engine.submit(images)
            wall = (time.perf_counter() - t0) / reps
            log(f"  {name} kernel={kernel}: launches {seen}; logits "
                f"{logits.shape} bit-equal to the plain backend; "
                f"{REQUESTS} requests in {1e3 * wall:.1f} ms "
                f"({REQUESTS / wall:.1f} images/s); stats {served}")
            results[kernel] = (seen, logits, wall)
        rel = np.linalg.norm(logits - float_logits) / np.linalg.norm(
            float_logits)
        log(f"  {name}: int8 logits vs the float oracle: relative error "
            f"{rel:.4f}")
        return qnet, images, results

    log("phase 5: the main path")
    _, _, results = serve("vgg_imagenet", network.vgg_imagenet(), seed=0)
    for k in ("conv2d_ws_pipe", "matmul_ws"):
        stats[k]["launches"] = results["auto"][0][k]
    stats["conv2d_ws"]["launches"] = results["sequential"][0]["conv2d_ws"]
    for kernel, conv in (("auto", "conv2d_ws_pipe"),
                         ("sequential", "conv2d_ws")):
        wall_ms = 1e3 * results[kernel][2]
        busy = (-(-REQUESTS // BATCH)
                * (stats[conv]["ms"] + stats["matmul_ws"]["ms"]))
        log(f"  vgg_imagenet kernel={kernel}: kernels {busy:.2f} ms of the "
            f"{wall_ms:.2f} ms submit (phase-3 kernel times x batches); "
            f"the rest, {wall_ms - busy:.2f} ms, is host work, plain glue "
            f"ops and launch gaps")
    lq, limages, lres = serve("lenet", network.lenet(), seed=1)
    cpu = ConvNetEngine(lq, batch=BATCH, device="cpu").submit(limages)
    if not np.array_equal(cpu, lres["auto"][1]):
        raise AssertionError("lenet: card logits differ from the CPU run")
    log("  lenet: card logits bit-equal to the CPU run of the same program")

    # -- 6. results --------------------------------------------------------
    rows = []
    for name, (source, replaces) in KERNELS.items():
        st = stats[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=st["launches"], max_abs_err=st["max_abs_err"],
            ms=st["ms"], plain_ms=st["plain_ms"],
            bound_ms=bound_ms(st["bytes"], st["ops"]),
            bound_by=("bytes" if st["bytes"] / HBM_BYTES_PER_S
                      >= st["ops"] / INT8_OPS_PER_S else "operations"),
            library_ms=None))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
