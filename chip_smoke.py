#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any mismatch:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, all started together;
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (``vgg_imagenet``'s six convs at
   224×224 under their Hopper tile plans, the ``lenet`` convs, the §5.2
   layer, depthwise / stride-2 / dilation-2 / per-channel-requant layers,
   the dense heads; llama3.2-3b's attention at S = 512, 777, 2048, 3000):
   int paths ``torch.equal``, f32 within 1e-4, bf16 within one bf16 ulp;
   time each kernel and its plain version with CUDA events beside its
   bound (and, for attention, ``scaled_dot_product_attention``);
4. run the §5.2 layer through ``ConvCore(ConvCoreConfig(int8=True))``;
5. the conv main path: ``vgg_imagenet`` (224×224×4, 1000 classes, random
   weights from a seed) quantized on a 16-image calibration batch, served
   to 16 requests through ``ConvNetEngine(batch=8)``: logits bit-equal to
   the plain backend, launch counts read around the run; again with
   ``kernel="sequential"``; then ``lenet``, whose card logits must also
   equal the CPU run of the same program;
6. the LM main path: llama3.2-3b as published (28 layers, bf16 compute,
   random weights from a seed) served to 8 requests of 64–3000 prompt
   tokens through ``ServingEngine(slots=4, max_seq=4096)`` with
   ``attn_impl="flash"``: one kernel launch per layer per prefill, 16
   tokens per request, prefill logits against the plain attention; then
   two full-width layers in f32 (logits within 1e-4, tokens equal to the
   plain attention), and the reduced model (tokens equal to the CPU run);
7. print the per-kernel JSON line and, last, the run's device line.

It needs a CUDA device and the repository's ``src`` beside it.
"""

import dataclasses
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
BF16_OPS_PER_S = 989e12       # H100 SXM data sheet, dense bf16
F32_TOL = 1e-4
LM_ARCH = "llama3p2_3b"
LM_PROMPTS = (64, 512, 777, 1024, 1536, 2048, 2500, 3000)
LM_NEW_TOKENS = 16
LM_SLOTS, LM_MAX_SEQ = 4, 4096
FLASH_SEQS = (512, 777, 2048, 3000)   # bf16 [1, S, 24, 128] checks
FLASH_ROW_SEQ = 2048                  # the S of the JSON row's numbers
KERNELS = {
    "conv2d_ws": ("src/repro_torch/kernels/csrc/conv2d_ws.cu",
                  "src/repro/kernels/conv2d_ws.py:255"),
    "conv2d_ws_pipe": ("src/repro_torch/kernels/csrc/conv2d_ws_pipe.cu",
                       "src/repro/kernels/conv2d_ws_pipe.py:193"),
    "matmul_ws": ("src/repro_torch/kernels/csrc/matmul_ws.cu",
                  "src/repro/kernels/matmul_ws.py:47"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
}


def log(*parts):
    print(*parts, flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs.base import (get_config, param_count,
                                          reduce_config)
    from repro_torch.core import network, perfmodel
    from repro_torch.core.convcore import (ConvCore, ConvCoreConfig,
                                           paper_workload)
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.conv2d_ws import conv2d_ws, conv2d_ws_plain
    from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.matmul_ws import matmul_ws, matmul_ws_plain
    from repro_torch.layers.common import materialize
    from repro_torch.models import lm
    from repro_torch.serving.engine import (ConvNetEngine, Request,
                                            ServingEngine)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    wrappers = {"conv2d_ws": conv2d_ws, "conv2d_ws_pipe": conv2d_ws_pipe,
                "matmul_ws": matmul_ws, "flash_attention": flash_attention}
    stats = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bytes=0,
                     ops=0, launches=0, library_ms=None,
                     ops_per_s=INT8_OPS_PER_S) for k in KERNELS}
    stats["flash_attention"]["ops_per_s"] = BF16_OPS_PER_S

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

    def bound_ms(nbytes, ops, ops_per_s=INT8_OPS_PER_S):
        return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)

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

    def bf16_ulp(x):
        """One bf16 ulp at each |x|: 2^(floor(log2|x|) - 7) (0 at x = 0)."""
        a = x.float().abs()
        return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                           torch.zeros_like(a))

    # bf16 attention: the kernel and the plain version each round an f32
    # result once, from sums taken in another order, so they may differ by
    # one bf16 ulp; 1e-5 more absolute covers outputs near zero, where the
    # f32 sums' own rounding (about 1e-7) can exceed an ulp
    BF16_ATOL = 1e-5
    flash_ms = {}

    def check_flash(b, s, h, d, dtype, causal, timed=False):
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, causal=causal)
        err_t = (got.float() - want.float()).abs()
        err = float(err_t.max())
        if dtype == torch.float32:
            ok, tol = torch.allclose(got, want, rtol=F32_TOL,
                                     atol=F32_TOL), f"within {F32_TOL}"
        else:
            ok = bool((err_t <= bf16_ulp(want) + BF16_ATOL).all())
            tol = f"within one bf16 ulp + {BF16_ATOL}"
        if got.dtype != dtype or not ok:
            raise AssertionError(f"flash_attention [{b},{s},{h},{d}] {dtype} "
                                 f"causal={causal} disagrees with its plain "
                                 f"version (max abs err {err})")
        st = stats["flash_attention"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        row = ""
        if timed:
            ms = elapsed_ms(lambda: flash_attention(q, k, v, causal=causal),
                            reps=10)
            plain = elapsed_ms(lambda: flash_attention_plain(
                q, k, v, causal=causal), reps=3, warmup=1)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = elapsed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), reps=10)
            pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
            ops, nbytes = 4 * d * pairs, 4 * b * s * h * d * q.element_size()
            flash_ms[s] = ms
            if s == FLASH_ROW_SEQ:
                st.update(ms=ms, plain_ms=plain, library_ms=lib,
                          bytes=nbytes, ops=ops)
            row = (f"; kernel {ms:.3f} ms, plain {plain:.3f} ms, sdpa "
                   f"{lib:.4f} ms, bound "
                   f"{bound_ms(nbytes, ops, BF16_OPS_PER_S):.4f} ms")
        log(f"  flash_attention [{b},{s},{h},{d}] {str(dtype)[6:]} "
            f"causal={causal}: max abs err {err:.3g} ({tol}){row}")

    lm_full = get_config(LM_ARCH)
    for s_len in FLASH_SEQS:
        check_flash(1, s_len, lm_full.num_heads, lm_full.head_dim,
                    torch.bfloat16, True, timed=True)
    for causal in (True, False):
        check_flash(2, 300, 4, 64, torch.float32, causal)

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

    log("phase 5: the conv main path")
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

    # -- 6. the LM main path ----------------------------------------------
    class TimedEngine(ServingEngine):
        """``ServingEngine`` with a host clock around each admit (batch-1
        prefill + cache scatter) and each decode step; both end in a
        device sync, since the sampled token is read on the host."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.admit_ms, self.step_ms = {}, []

        def admit(self, req):
            t0 = time.perf_counter()
            ok = super().admit(req)
            if ok:
                self.admit_ms[req.uid] = 1e3 * (time.perf_counter() - t0)
            return ok

        def step(self):
            busy = sum(r is not None for r in self.active)
            t0 = time.perf_counter()
            done = super().step()
            if busy:
                self.step_ms.append((busy, 1e3 * (time.perf_counter() - t0)))
            return done

    def lm_requests(cfg, lengths, new, seed):
        rng = np.random.default_rng(seed)
        return [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lengths)]

    def fresh(reqs):
        return [Request(uid=r.uid, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens) for r in reqs]

    def check_served(name, cfg, reqs):
        for r in reqs:
            if not r.done or len(r.output) != r.max_new_tokens or not all(
                    0 <= t < cfg.vocab_size for t in r.output):
                raise AssertionError(f"{name}: request {r.uid} ended with "
                                     f"{r.output}")

    def last_logits(params, cfg, prompt):
        with torch.no_grad():
            lg, _ = lm.prefill(params, {"tokens": torch.as_tensor(
                prompt, dtype=torch.long, device=dev)[None]}, cfg)
        return lg[0].float()

    log("phase 6: the LM main path")
    cfg = dataclasses.replace(lm_full, attn_impl="flash")
    plain_cfg = dataclasses.replace(cfg, attn_impl="dense")
    t0 = time.perf_counter()
    params = materialize(lm.param_specs(cfg), torch.Generator(
        device=dev).manual_seed(0), device=dev)
    engine = TimedEngine(cfg, params, slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    del params                          # the engine keeps its bf16 copy
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {param_count(cfg) / 1e9:.2f} B parameters "
        f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
        f"{cfg.vocab_size}), drawn on the card from seed 0 and cast to "
        f"{cfg.compute_dtype} in {time.perf_counter() - t0:.1f} s; "
        f"{LM_SLOTS} slots × {LM_MAX_SEQ} positions")
    reqs = lm_requests(cfg, LM_PROMPTS, LM_NEW_TOKENS, seed=0)
    last_logits(engine.params, cfg, reqs[0].prompt)    # warm-up, uncounted
    reset_counts()
    t0 = time.perf_counter()
    engine.run(reqs)
    wall = time.perf_counter() - t0
    seen = counts()
    want = {k: 0 for k in wrappers}
    want["flash_attention"] = cfg.num_layers * len(reqs)
    if seen != want:
        raise AssertionError(f"{cfg.name}: launches {seen}, expected {want}")
    check_served(cfg.name, cfg, reqs)
    stats["flash_attention"]["launches"] = seen["flash_attention"]
    log(f"  {cfg.name}: launches {seen} (one flash_attention per layer per "
        f"prefill); {len(reqs)} requests × {LM_NEW_TOKENS} tokens, all in "
        f"range")
    for r in reqs:
        n, ms = len(r.prompt), engine.admit_ms[r.uid]
        share = ""
        if n in flash_ms:
            share = (f"; flash_attention {cfg.num_layers} × "
                     f"{flash_ms[n]:.3f} ms = "
                     f"{100 * cfg.num_layers * flash_ms[n] / ms:.1f}% of it "
                     f"(phase-3 kernel time)")
        log(f"    prompt {n:5d}: admit (prefill + cache scatter) "
            f"{ms:.1f} ms{share}")
    busy_tokens = sum(b for b, _ in engine.step_ms)
    step_s = sum(ms for _, ms in engine.step_ms) / 1e3
    full = [ms for b, ms in engine.step_ms if b == LM_SLOTS]
    generated = sum(len(r.output) for r in reqs)
    steps = len(engine.step_ms)
    median_full = np.median(full) if full else float("nan")
    log(f"  decode: {steps} steps, {1e3 * step_s / steps:.2f} ms per step "
        f"on average, {median_full:.2f} ms median with all {LM_SLOTS} "
        f"slots busy; {busy_tokens / step_s:.1f} "
        f"tokens/s over the decode steps; {generated} tokens in "
        f"{wall:.2f} s of run ({generated / wall:.1f} tokens/s, prefills "
        f"included)")

    def device_busy(fn):
        """(wall ms of ``fn`` unprofiled, device ms and kernel count of
        ``fn`` under torch.profiler); device ms is None where the trace
        holds no device events."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in evs) / 1e3
        return wall, (busy if evs else None), len(evs)

    for r in reqs[:LM_SLOTS]:            # four busy slots again
        engine.admit(fresh([r])[0])
    longest = max((r.prompt for r in reqs), key=len)
    for label, fn in (("decode step, 4 slots", engine.step),
                      (f"prefill of {len(longest)} tokens",
                       lambda: last_logits(engine.params, cfg, longest))):
        wall, busy, n = device_busy(fn)
        share = ("not measured (no device events in the trace)"
                 if busy is None else
                 f"device busy {busy:.1f} ms = {100 * busy / wall:.0f}% of it")
        log(f"  {label}: {wall:.1f} ms of host clock, {n} device events "
            f"under torch.profiler; {share}")

    # each layer's attention output may move by one bf16 ulp (at most
    # 2^-7 relative) between the kernel and the plain softmax; 28 such
    # moves add at most linearly unless the network amplifies them
    logit_bound = cfg.num_layers * 2.0 ** -7
    worst = 0.0
    for r in reqs:
        a = last_logits(engine.params, cfg, r.prompt)
        b = last_logits(engine.params, plain_cfg, r.prompt)
        rel = float((a - b).norm() / b.norm())
        if not bool(torch.isfinite(a).all()) or rel > logit_bound:
            raise AssertionError(f"{cfg.name} prompt {len(r.prompt)}: "
                                 f"prefill logits off the plain attention's "
                                 f"by {rel:.4g} (bound {logit_bound:.4g})")
        worst = max(worst, rel)
    log(f"  prefill last-token logits against attn_impl='dense': relative "
        f"L2 error at most {worst:.4g} over the {len(reqs)} prompts "
        f"(bound {logit_bound:.4g})")
    plain_engine = ServingEngine(plain_cfg, engine.params, slots=LM_SLOTS,
                                 max_seq=LM_MAX_SEQ)
    preqs = fresh(reqs)
    plain_engine.run(preqs)
    check_served(f"{cfg.name} (plain attention)", cfg, preqs)
    same = sum(a == b for r, p in zip(reqs, preqs)
               for a, b in zip(r.output, p.output))
    log(f"  greedy tokens equal to a run with the plain attention: {same} "
        f"of {generated} (not required: a near tie among "
        f"{cfg.vocab_size:,} bf16-rounded logits can flip an argmax, and "
        f"the request's later tokens follow the flip)")
    del engine, plain_engine
    torch.cuda.empty_cache()

    f32 = dataclasses.replace(cfg, num_layers=2, compute_dtype="float32")
    params = materialize(lm.param_specs(f32), torch.Generator(
        device=dev).manual_seed(1), device=dev)
    reqs = lm_requests(f32, (64, 777, 1536, 3000), 8, seed=1)
    worst = 0.0
    for r in reqs:
        a = last_logits(params, f32, r.prompt)
        b = last_logits(params, dataclasses.replace(f32, attn_impl="dense"),
                        r.prompt)
        if not torch.allclose(a, b, rtol=F32_TOL, atol=F32_TOL):
            raise AssertionError(f"f32 2-layer prompt {len(r.prompt)}: "
                                 f"logits differ from the plain attention")
        worst = max(worst, float((a - b).abs().max()))
    outs = []
    for c in (f32, dataclasses.replace(f32, attn_impl="dense")):
        run = fresh(reqs)
        ServingEngine(c, params, slots=LM_SLOTS, max_seq=LM_MAX_SEQ).run(run)
        check_served("f32 2-layer", c, run)
        outs.append([r.output for r in run])
    if outs[0] != outs[1]:
        raise AssertionError("f32 2-layer: greedy tokens differ from the "
                             "plain attention")
    log(f"  full width, 2 layers, f32: prefill logits within {F32_TOL} of "
        f"the plain attention (max abs err {worst:.3g}); greedy tokens of "
        f"{len(reqs)} requests equal")
    del params
    torch.cuda.empty_cache()

    small = dataclasses.replace(reduce_config(lm_full), attn_impl="flash")
    params = materialize(lm.param_specs(small), torch.Generator().manual_seed(
        2), device="cpu")
    reqs = lm_requests(small, (5, 17, 70, 130), 8, seed=2)
    outs = []
    for d in (dev, "cpu"):
        run = fresh(reqs)
        ServingEngine(small, params, slots=2, max_seq=256, device=d).run(run)
        check_served(f"reduced on {d}", small, run)
        outs.append([r.output for r in run])
    if outs[0] != outs[1]:
        raise AssertionError("reduced llama3.2-3b: card tokens differ from "
                             "the CPU run")
    log("  reduced llama3.2-3b: card tokens equal to the CPU run of the same "
        "engine")

    # -- 7. results --------------------------------------------------------
    rows = []
    for name, (source, replaces) in KERNELS.items():
        st = stats[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=st["launches"], max_abs_err=st["max_abs_err"],
            ms=st["ms"], plain_ms=st["plain_ms"],
            bound_ms=bound_ms(st["bytes"], st["ops"], st["ops_per_s"]),
            bound_by=("bytes" if st["bytes"] / HBM_BYTES_PER_S
                      >= st["ops"] / st["ops_per_s"] else "operations"),
            library_ms=st["library_ms"]))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
