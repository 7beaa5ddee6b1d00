#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any mismatch:

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, all started together; print each instantiation's
   registers and spills (``-Xptxas -v``) and the tensor-core instructions
   in each tensor-core instantiation's SASS (``cuobjdump -sass``: ``IMMA``
   in the conv kernels, ``HGMMA`` in ``matmul_ws``'s bf16 long-M form);
   fail on a spill in either or in a ``flash_attention`` ``wgmma``
   instantiation (D = 256 included), a missing ``IMMA`` or ``HGMMA``, a
   missing compiler report or a missing ``cuobjdump``;
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (``vgg_imagenet``'s six convs at
   224×224, the ``lenet`` convs, the §5.2 layer, depthwise / stride-2 /
   dilation-2 / per-channel-requant layers, the tensor-core path's edge
   geometries (``TC_CASES`` of ``tests/test_torch_cuda.py``), the dense
   heads; every ``matmul_ws`` form at its edge shapes (M from 1 to 3000,
   K and N off the tiles, the head's N = 1000) and at the LM's MLP
   shapes; llama3.2-3b's attention at S = 512, 777,
   2048, 3000, the bf16 attention kernel's other head dims 16, 32, 64,
   and the head dims it runs padded, at D = 256 or on f32 copies — bf16
   D = 8, 96 and 256 at [1, 2048, H, D] with H·D = 3072, bf16 D = 320, f32
   D = 6 and 160, and f32 B·H = 65,600 — each asserting the variant
   ``kernel_variant`` names): int paths ``torch.equal``, f32 within 1e-4,
   bf16 attention within
   one bf16 ulp, bf16 GEMMs within the bound ``bf16_gemm_bound`` derives;
   each conv and GEMM check also asserts which path or form launched.  Time each kernel's call and its plain version with CUDA
   events around back-to-back calls (``ms``, ``plain_ms``: host work
   included), and each kernel's call again as the sum of every device
   event it issues under ``torch.profiler`` (``device_ms``: its kernel and
   whatever else it runs on the card, such as the scale fill), beside its
   bound (and, for attention, ``scaled_dot_product_attention``, for the
   bf16 GEMMs ``torch.matmul``, and the achieved TFLOP/s); print the
   ``vgg_imagenet`` per-layer table and ``matmul_ws``'s host cost a call;
4. run the §5.2 layer through ``ConvCore(ConvCoreConfig(int8=True))``;
5. the conv main path: ``vgg_imagenet`` (224×224×4, 1000 classes, random
   weights from a seed) quantized on a 16-image calibration batch, served
   to 16 requests through ``ConvNetEngine(batch=8)`` (the facade of the
   continuous-batching engine): logits bit-equal to
   the plain backend, launch counts read around the run, every conv launch
   on the tensor-core path, the device-busy share of one submit; again
   with ``kernel="sequential"``; then ``lenet``, whose card logits must
   also equal the CPU run of the same program;
6. the LM main path: llama3.2-3b as published (28 layers, bf16 compute,
   random weights from a seed) served to 8 requests of 64–3000 prompt
   tokens through ``ServingEngine(slots=4, max_seq=4096)`` with
   ``attn_impl="flash"``: one kernel launch per layer per prefill, 16
   tokens per request, prefill logits against the plain attention; the
   same requests again with ``gemm_backend="pallas_ws"`` on the same
   weights (three ``matmul_ws`` launches per layer per forward, admit
   and decode times beside the ``xla`` run's, prefill logits against
   it); then two full-width layers in f32 (logits within 1e-4, tokens
   equal to the plain attention), and the reduced model (tokens equal to
   the CPU run);
7. continuous batching: ``ContinuousBatchingEngine`` serves
   ``vgg_imagenet`` 224 at batch 8 under 4 virtual cores in each of the
   batch, kout and spatial modes, ``unet_small`` at 224×224×4 (transposed
   convs up to 112 and 224 rows) and ``lenet``, each bit-equal to the
   plain backend, with every kernel's launches, tensor-core launches and
   ``matmul_ws`` forms held to what ``conv_path`` / ``mm_path`` give the
   calls the program makes (recorded through the same scheduler); one
   batch dispatched under ``torch.cuda.set_sync_debug_mode("error")``; one
   engine with a 2-program cache serving all three models to 64 requests
   from 4 threads at both priorities (an evict and rebuild asserted,
   results bit-equal); images/s, latency percentiles, formation counts and
   the device-busy share of an open-loop load beside phase 5's
   synchronous submit;
8. print the per-kernel JSON line and, last, the run's device line.  A
   kernel timed over several shapes reports the sum of their times (each
   of ``ms``, ``plain_ms``, ``device_ms``) and the sum of their per-launch
   bounds; ``matmul_ws``'s ``library_ms`` sums ``torch.matmul`` over its
   four bf16 shapes (the int8 head has no library call), and the convs'
   and ``matmul_ws``'s ``launches`` add phase 7's to their main paths'.

It needs a CUDA device and the repository's ``src`` and ``tests`` beside
it.
"""

import ctypes
import dataclasses
import itertools
import json
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))     # the card tests' conv cases

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
FLASH_SMALL_DIMS = (16, 32, 64)       # bf16 head dims besides 128
# head dims the kernels take padded, at D = 256 or on f32 copies:
# (B, S, H, D, dtype, variant); the bf16 ones at S = 2048 with H·D = 3072,
# llama3.2-3b's attention width, so their work is comparable to its
FLASH_REPAIRED = ((1, 2048, 384, 8, "bfloat16", "wgmma_padded"),
                  (1, 2048, 32, 96, "bfloat16", "wgmma_padded"),
                  (1, 2048, 12, 256, "bfloat16", "wgmma"),
                  (1, 300, 2, 320, "bfloat16", "scalar_f32_copies"),
                  (2, 300, 4, 6, "float32", "scalar_padded"),
                  (2, 300, 4, 160, "float32", "scalar"),
                  (1, 16, 65600, 4, "float32", "scalar"))   # B·H > 65535
# matmul_ws: the shapes timed (the vgg_imagenet head; llama3.2-3b's MLP
# GEMMs in a 3000-token prefill and in a 4-slot decode step); its edge
# shapes are the card tests' MM_CASES
MM_TIMED = (("vgg_imagenet head", 8, 256, 1000, "int8"),
            ("prefill wi", 3000, 3072, 8192, "bfloat16"),
            ("prefill wo", 3000, 8192, 3072, "bfloat16"),
            ("decode wi", 4, 3072, 8192, "bfloat16"),
            ("decode wo", 4, 8192, 3072, "bfloat16"))
MM_BEFORE = (3000, 3072, 8192)        # the scalar kernel's f32 time, once
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


# mangled template arguments; in these sources the only argument that
# mangles as a back-reference (S_, S2_, ...) is __nv_bfloat16
_TEMPLATE_ARGS = {"a": "int8", "i": "int32", "f": "float",
                  "13__nv_bfloat16": "bf16"}
_ARG = r"[aif]|13__nv_bfloat16|S\d*_|L[ib]\d+E"


def kernel_name(mangled):
    """``conv_ws_tc_kernel<4, true>`` from its mangled name: the
    length-prefixed identifier that ends in "kernel", and its template
    arguments (types, ints, bools)."""
    for num in re.finditer(r"(?=(\d+))", mangled):   # every digit suffix
        end = num.start() + len(num.group(1))
        name = mangled[end:end + int(num.group(1))]
        if name.endswith("kernel") and name.isidentifier():
            rest = mangled[end + len(name):]
            args = re.match(rf"I((?:{_ARG})+)E", rest)
            if not args:
                return name
            out = []
            for tok in re.findall(_ARG, args.group(1)):
                if tok in _TEMPLATE_ARGS:
                    out.append(_TEMPLATE_ARGS[tok])
                elif tok.startswith("S"):
                    out.append("bf16")
                elif tok.startswith("Lb"):
                    out.append("true" if tok[2:-1] == "1" else "false")
                else:
                    out.append(tok[2:-1])
            return f"{name}<{', '.join(out)}>"
    return mangled


def sass_tensor_ops(lib_path):
    """{kernel name: count of IMMA / HGMMA-family instructions} in a
    library's SASS (``cuobjdump``, which comes with ``nvcc``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise FileNotFoundError("cuobjdump is not installed beside nvcc: "
                                "the tensor-core SASS cannot be read")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = kernel_name(found.group(1))
            counts[name] = 0
        elif name and re.search(r"\b(IMMA|[HIQ]GMMA)\b", line):
            counts[name] += 1
    return counts


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs.base import (get_config, param_count,
                                          reduce_config)
    from repro_torch.core import network, perfmodel
    from repro_torch.core.convcore import (ConvCore, ConvCoreConfig,
                                           get_backend, paper_workload,
                                           register_backend,
                                           unregister_backend)
    from repro_torch.core.scheduler import MultiCoreScheduler, SchedulerConfig
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.conv2d_ws import (conv2d_ws, conv2d_ws_plain,
                                               conv_path, setup_conv)
    from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
    from repro_torch.kernels.conv2d_ws_trans import transpose_eq_conv_geometry
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     kernel_variant)
    from repro_torch.kernels.matmul_ws import (PATHS, matmul_ws,
                                               matmul_ws_plain, mm_path)
    from repro_torch.layers.common import materialize
    from repro_torch.models import lm
    from repro_torch.serving.batching import (ContinuousBatchingEngine,
                                              FormedBatch, ServeRequest)
    from repro_torch.serving.engine import (ConvNetEngine, Request,
                                            ServingEngine)
    from test_torch_cuda import (MM_CASES, TC_CASES, bf16_gemm_bound,
                                 bf16_ulp, mm_case_inputs, tc_case_inputs)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    wrappers = {"conv2d_ws": conv2d_ws, "conv2d_ws_pipe": conv2d_ws_pipe,
                "matmul_ws": matmul_ws, "flash_attention": flash_attention}
    # "bound" sums the per-launch bounds of the shapes a row is timed
    # over, each credited to the side (bytes or operations) that limits it
    stats = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, device_ms=0.0,
                     launches=0,
                     bound={"bytes": 0.0, "operations": 0.0},
                     library_ms=None, ops_per_s=INT8_OPS_PER_S)
             for k in KERNELS}
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
    spilled = []
    for name in _build.SOURCES:
        entry, report = "", _build.build_log(name)
        if "Used" not in report:
            raise AssertionError(f"{name}: no -Xptxas -v report beside its "
                                 f"library")
        for line in report.splitlines():
            found = re.search(r"entry function '([^']*)'", line)
            if found:
                entry = kernel_name(found.group(1))
            elif "Used" in line or "Performance Loss" in line or re.search(
                    r"[1-9]\d* bytes spill", line) or (
                    "spill" in line and ("wgmma_kernel" in entry
                                         or "flash_bf16_kernel" in entry)):
                log(f"  {name} {entry}: {line.strip()}")
                if re.search(r"[1-9]\d* bytes spill", line) and (
                        "tc_kernel" in entry or "wgmma_kernel" in entry
                        or "flash_bf16_kernel" in entry):
                    spilled.append(entry)
    if spilled:
        raise AssertionError(f"tensor-core kernels spill: {spilled}")
    for name in ("conv2d_ws", "conv2d_ws_pipe"):
        ops = sass_tensor_ops(_build.library_path(name))
        tc = {k: v for k, v in sorted(ops.items()) if "tc_kernel" in k}
        log(f"  {name} SASS, tensor-core instructions per instantiation: "
            + ", ".join(f"{k} {v}" for k, v in tc.items()))
        if len(tc) != 4 or not all(tc.values()):
            raise AssertionError(f"{name}: an int8 tensor-core instantiation "
                                 f"holds no IMMA: {tc}")
    ops = sass_tensor_ops(_build.library_path("matmul_ws"))
    hg = {k: v for k, v in sorted(ops.items()) if "wgmma_kernel" in k}
    log("  matmul_ws SASS, HGMMA instructions per bf16 long-M "
        "instantiation: " + ", ".join(f"{k} {v}" for k, v in hg.items()))
    if len(hg) != 2 or not all(hg.values()):
        raise AssertionError(f"matmul_ws: a bf16 long-M instantiation holds "
                             f"no HGMMA: {hg}")

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

    def add_bound(name, nbytes, ops, ops_per_s=None):
        """Add one timed launch shape's bound to ``name``'s row → (bound
        ms, the side that limits it)."""
        ops_per_s = ops_per_s or stats[name]["ops_per_s"]
        side = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / ops_per_s
                else "operations")
        ms = bound_ms(nbytes, ops, ops_per_s)
        stats[name]["bound"][side] += ms
        return ms, side

    def device_ms(fn, reps, windows=3):
        """Device time of one call of ``fn``: the durations of every device
        event (kernels, copies, fills) that ``reps`` calls issue under
        ``torch.profiler`` after a warm-up, over ``reps``.  A window whose
        trace holds no device event at all (the profiler lost it, as seen
        once in 10 calls of a kernel that had just run and been checked) is
        profiled again, up to ``windows`` times, and said so; a trace with
        some but fewer than ``reps`` events raises at once."""
        fn()
        torch.cuda.synchronize()
        act = torch.profiler.ProfilerActivity
        for window in range(windows):
            with torch.profiler.profile(
                    activities=[act.CPU, act.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            if evs:
                break
            log(f"  torch.profiler window {window + 1} of {windows} held no "
                f"device event")
        if len(evs) < reps:
            raise AssertionError(f"torch.profiler saw {len(evs)} device "
                                 f"events in {reps} calls")
        return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / reps

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
    conv_rows = []

    def check_conv(label, x, w, b, scale, kw, timed=False):
        """Both conv kernels against ``conv2d_ws_plain``, each launch on the
        path ``conv_path`` rules; ``scale`` is "scalar" / "per_k" (derived
        from the plain accumulator so the int8 outputs span the grid), a
        given scale, or None (int32 / f32 out)."""
        if isinstance(scale, str):
            acc = conv2d_ws_plain(x, w, b, None, **kw).double().abs()
            if scale == "per_k":
                amax = acc.reshape(-1, acc.shape[-1]).amax(0).clamp(min=1)
                scale = (100.0 / amax).float()
            else:
                scale = 100.0 / max(float(acc.max()), 1.0)
        want = conv2d_ws_plain(x, w, b, scale, **kw)
        geo = {k: v for k, v in kw.items() if k not in ("relu", "pool")}
        path = conv_path(setup_conv(
            tuple(x.shape), tuple(w.shape), pool=kw.get("pool", False),
            requant=scale is not None, int_path=x.dtype == torch.int8,
            **geo))
        torch.cuda.synchronize()
        row = {}
        for name in ("conv2d_ws", "conv2d_ws_pipe"):
            fn = wrappers[name]
            before = (fn.launches, fn.tc_launches)
            got = fn(x, w, b, scale, **kw)
            torch.cuda.synchronize()
            if (fn.launches, fn.tc_launches) != (
                    before[0] + 1, before[1] + (path == "tc")):
                raise AssertionError(f"{label}: {name} did not launch once "
                                     f"on the {path} path")
            compare(name, got, want)
            if timed:
                call = lambda: fn(x, w, b, scale, **kw)   # noqa: E731
                row[name] = (elapsed_ms(call, reps=10), device_ms(call, 20))
                stats[name]["ms"] += row[name][0]
                stats[name]["device_ms"] += row[name][1]
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
                bound, side = add_bound(name, nbytes, ops)
            # cuDNN's fp16 channels-last conv at the same shape: a different
            # function (no int8, no fused epilogue), timed for scale only
            xh = x.permute(0, 3, 1, 2).half().contiguous(
                memory_format=torch.channels_last)
            wh = w.permute(3, 2, 0, 1).half().contiguous(
                memory_format=torch.channels_last)
            pad = ref.normalize_padding(kw.get("padding", "VALID"), kh, kwd,
                                        kw.get("stride", 1), h, wd,
                                        kw.get("dilation", 1))
            xh = F.pad(xh, (pad[1][0], pad[1][1], pad[0][0], pad[0][1]))
            cudnn = elapsed_ms(lambda: F.conv2d(
                xh, wh, stride=kw.get("stride", 1),
                dilation=kw.get("dilation", 1)), reps=20)
            conv_rows.append((label, ops, nbytes, row, plain, bound, side,
                              cudnn))
        log(f"  {label}: x{tuple(x.shape)} w{tuple(w.shape)} {kw} "
            f"equal, {path} path")

    def mm_operands(m, k, n, dtype, bias=True):
        if dtype == torch.int8:
            x, w, b = rand_i8(m, k), rand_i8(k, n), rand_bias(n)
        else:
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            w = (torch.randn(k, n, generator=gen, device=dev)
                 / k ** 0.5).to(dtype)
            b = torch.randn(n, generator=gen, device=dev)
        return x, w, b if bias else None

    def check_mm(x, w, b):
        """One ``matmul_ws`` launch on the form ``mm_path`` names, against
        ``matmul_ws_plain`` → (form, max abs err)."""
        (m, k), n = x.shape, w.shape[1]
        path = mm_path(m, k, n, x.dtype)
        before = (matmul_ws.launches, matmul_ws.path_launches[path])
        got = matmul_ws(x, w, b)
        torch.cuda.synchronize()
        if (matmul_ws.launches, matmul_ws.path_launches[path]) != (
                before[0] + 1, before[1] + 1):
            raise AssertionError(f"matmul_ws [{m},{k}]@[{k},{n}] {x.dtype}: "
                                 f"not one launch on the {path} form")
        want = matmul_ws_plain(x, w, b)
        if x.dtype != torch.bfloat16:
            return path, compare("matmul_ws", got, want)
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"matmul_ws: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err_t = (got.float() - want.float()).abs()
        err = float(err_t.max())
        if not bool((err_t <= bf16_gemm_bound(x, w, b, got, want)).all()):
            raise AssertionError(f"matmul_ws [{m},{k}]@[{k},{n}] bf16 ({path}) "
                                 f"disagrees with its plain version beyond "
                                 f"the bound (max abs err {err})")
        st = stats["matmul_ws"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        return path, err

    def check_matmuls():
        """Every form at its edge shapes, then the timed main-path shapes,
        the scalar kernel's f32 time before this form, and the wrapper's
        host cost → {timed label: device ms}."""
        forms = dict.fromkeys(PATHS, 0)
        dev_times = {}
        line = []
        for m, k, n, dname, bias in MM_CASES:
            path, err = check_mm(*(None if t is None else t.to(dev) for t in
                                   mm_case_inputs(m, k, n, dname, bias)))
            forms[path] += 1
            line.append(f"[{m},{k}]@[{k},{n}] {dname} {path} {err:.3g}")
        log(f"  matmul_ws edges (shape dtype form max-abs-err; int8 equal, "
            f"f32 within {F32_TOL}, bf16 within bf16_gemm_bound): "
            + "; ".join(line))
        if not all(forms.values()):
            raise AssertionError(f"matmul_ws: a form was never checked: "
                                 f"{forms}")
        st = stats["matmul_ws"]
        st["library_ms"] = 0.0
        for label, m, k, n, dname in MM_TIMED:
            dt = getattr(torch, dname)
            # short M reads the weights once a call, like a decode step
            # over 28 layers: rotate four copies so that the 50 MB L2
            # cannot hold them from one call to the next
            copies = 4 if m <= 16 else 1
            x, w, b = mm_operands(m, k, n, dt, bias=dt == torch.int8)
            ws = [w] + [mm_operands(m, k, n, dt)[1] for _ in range(copies - 1)]
            path, _ = check_mm(x, w, b)
            turn = itertools.count()
            call = lambda: matmul_ws(x, ws[next(turn) % copies], b)  # noqa
            ms = elapsed_ms(call, reps=20)
            dev_ms = device_ms(call, 20)
            plain = elapsed_ms(lambda: matmul_ws_plain(x, w, b), reps=3,
                               warmup=1)
            lib = lib_dev = None
            if dt == torch.bfloat16:
                lib_call = lambda: torch.matmul(  # noqa: E731
                    x, ws[next(turn) % copies])
                lib = elapsed_ms(lib_call, reps=20)
                lib_dev = device_ms(lib_call, 20)
                st["library_ms"] += lib
            out_es = 4 if dt == torch.int8 else 2
            nbytes = ((m * k + k * n) * x.element_size() + 4 * n
                      + out_es * m * n)
            ops = 2 * m * k * n
            bound, side = add_bound("matmul_ws", nbytes, ops,
                                    INT8_OPS_PER_S if dt == torch.int8
                                    else BF16_OPS_PER_S)
            st["ms"] += ms
            st["device_ms"] += dev_ms
            st["plain_ms"] += plain
            dev_times[label] = dev_ms
            lib_txt = ("none (no PyTorch call computes an int8 GEMM at "
                       "M = 8)" if lib is None else
                       f"{lib:.4f} ms ({lib_dev:.4f} ms on the device)")
            log(f"  matmul_ws {label} [{m},{k}]@[{k},{n}] {dname}, {path} "
                f"form: {ms:.4f} ms a call, {dev_ms:.4f} ms on the device "
                f"({ops / dev_ms / 1e9:.1f} TFLOP/s, "
                f"{nbytes / dev_ms / 1e6:.0f} GB/s), bound {bound:.5f} ms "
                f"({side}), plain {plain:.3f} ms, torch.matmul {lib_txt}")
        m, k, n = MM_BEFORE
        xf, wf, _ = mm_operands(m, k, n, torch.float32, bias=False)
        path, _ = check_mm(xf, wf, None)
        before = elapsed_ms(lambda: matmul_ws(xf, wf), reps=2, warmup=1)
        log(f"  matmul_ws [{m},{k}]@[{k},{n}] f32, {path} form (the first "
            f"port's kernel, the only form before this one): {before:.3f} "
            f"ms a call")

        def host_us(fn, reps):
            """Host time of one call of ``fn``, over ``reps`` calls
            enqueued without a synchronize."""
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            return 1e6 * (t1 - t0) / reps

        x, w, _ = mm_operands(4, 3072, 8192, torch.bfloat16, bias=False)
        call_us = host_us(lambda: matmul_ws(x, w), 200)
        entry = _build.load("matmul_ws").matmul_ws_stream

        def sign():                 # the first port's wrapper, every call
            entry.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            entry.restype = ctypes.c_int

        sign_us = host_us(sign, 2000)
        zeros_us = host_us(lambda: torch.zeros((8192,), dtype=torch.float32,
                                               device=dev), 200)
        log(f"  matmul_ws host cost: {call_us:.1f} us a call at "
            f"[4,3072]@[3072,8192] bf16 without bias (host clock over 200 "
            f"enqueued calls); the first port's wrapper also set the C "
            f"signature ({sign_us:.2f} us) and made a zero bias "
            f"({zeros_us:.1f} us and a fill kernel) on every call: "
            f"{sign_us + zeros_us:.1f} us a call, "
            f"{84 * (sign_us + zeros_us) / 1e3:.2f} ms of host time per "
            f"84-launch decode step")
        return dev_times

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
    log(f"  vgg_imagenet at batch {BATCH}, per layer (ms: CUDA events "
        f"around back-to-back calls, host work included; device ms: every "
        f"device event of a call under torch.profiler; TOP/s from device "
        f"ms; cudnn fp16: F.conv2d on fp16 channels-last operands, a "
        f"different function):")
    log("    layer  GOP     MB      bound us (by)        conv2d_ws ms "
        "(device)    conv2d_ws_pipe ms (device)  TOP/s seq/pipe  plain ms  "
        "cudnn fp16 ms")
    for label, ops, nbytes, row, plain, bound, side, cudnn in conv_rows:
        (sc, sd), (pc, pd) = row["conv2d_ws"], row["conv2d_ws_pipe"]
        log(f"    {label[-5:]}  {ops / 1e9:.3f}  {nbytes / 1e6:6.2f}  "
            f"{1e3 * bound:7.2f} ({side:10s})  {sc:.4f} ({sd:.4f})      "
            f"{pc:.4f} ({pd:.4f})            {ops / sd / 1e9:6.1f} / "
            f"{ops / pd / 1e9:6.1f}  {plain:.3f}     {cudnn:.4f}")
    seq, pipe = stats["conv2d_ws"], stats["conv2d_ws_pipe"]
    log(f"    sum: conv2d_ws {seq['ms']:.4f} ms ({seq['device_ms']:.4f} ms "
        f"on the device), conv2d_ws_pipe {pipe['ms']:.4f} ms "
        f"({pipe['device_ms']:.4f} ms on the device), bound "
        f"{sum(seq['bound'].values()):.4f} ms (the sum of the per-layer "
        f"bounds), plain {seq['plain_ms']:.3f} ms")
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
    for label in TC_CASES:              # the tensor-core path's edges
        x, w, b, s, kw = tc_case_inputs(label)
        check_conv(label, *(None if a is None else torch.as_tensor(
            np.array(a), device=dev) for a in (x, w, b, s)), kw)
    xf = torch.randn(BATCH, 30, 30, 32, generator=gen, device=dev)
    wf = torch.randn(3, 3, 32, 64, generator=gen, device=dev) / 16
    check_conv("f32", xf, wf, torch.randn(64, generator=gen, device=dev),
               None, dict(padding="SAME", relu=True, pool=True, h_tile=8,
                          w_tile=10))
    mm_device_ms = check_matmuls()

    # bf16 attention: the kernel and the plain version each round an f32
    # result once, from sums taken in another order, so they may differ by
    # one bf16 ulp; 1e-5 more absolute covers outputs near zero, where the
    # f32 sums' own rounding (about 1e-7) can exceed an ulp
    BF16_ATOL = 1e-5
    flash_ms = {}

    def check_flash(b, s, h, d, dtype, causal, timed=False, variant=None):
        """One ``flash_attention`` call against its plain version, on the
        kernel ``variant`` names (asserted); ``timed`` adds its times, and
        llama3.2-3b's [1, 2048, 24, 128] ones make the JSON row."""
        want_variant = variant or (
            "wgmma" if dtype == torch.bfloat16 else "scalar")
        if kernel_variant(dtype, d) != want_variant:
            raise AssertionError(f"flash_attention D = {d} {dtype}: variant "
                                 f"{kernel_variant(dtype, d)}, expected "
                                 f"{want_variant}")
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
            dev_ms = device_ms(lambda: flash_attention(q, k, v,
                                                       causal=causal), 10)
            plain = elapsed_ms(lambda: flash_attention_plain(
                q, k, v, causal=causal), reps=3, warmup=1)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = elapsed_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), reps=10)
            pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
            ops, nbytes = 4 * d * pairs, 4 * b * s * h * d * q.element_size()
            if (h, d) == (lm_full.num_heads, lm_full.head_dim):
                flash_ms[s] = dev_ms
            if (s, h, d) == (FLASH_ROW_SEQ, lm_full.num_heads,
                             lm_full.head_dim):
                st.update(ms=ms, device_ms=dev_ms, plain_ms=plain,
                          library_ms=lib)
                add_bound("flash_attention", nbytes, ops)
            row = (f"; kernel {ms:.4f} ms a call, {dev_ms:.4f} ms on the "
                   f"device ({ops / dev_ms / 1e9:.1f} TFLOP/s at "
                   f"4·D flops per pair), plain {plain:.3f} ms, sdpa "
                   f"{lib:.4f} ms, bound "
                   f"{bound_ms(nbytes, ops, BF16_OPS_PER_S):.4f} ms")
        log(f"  flash_attention [{b},{s},{h},{d}] {str(dtype)[6:]} "
            f"causal={causal}, {want_variant}: max abs err {err:.3g} "
            f"({tol}){row}")

    lm_full = get_config(LM_ARCH)
    for s_len in FLASH_SEQS:
        check_flash(1, s_len, lm_full.num_heads, lm_full.head_dim,
                    torch.bfloat16, True, timed=True)
    for d in FLASH_SMALL_DIMS:         # the tensor-core kernel's other dims
        check_flash(2, 777, 4, d, torch.bfloat16, True)
        check_flash(2, 300, 4, d, torch.bfloat16, False)
    for causal in (True, False):
        check_flash(2, 300, 4, 64, torch.float32, causal)
    for b, s_len, h, d, dname, variant in FLASH_REPAIRED:
        check_flash(b, s_len, h, d, getattr(torch, dname), True,
                    timed=s_len == FLASH_ROW_SEQ, variant=variant)

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
    convs = ("conv2d_ws", "conv2d_ws_pipe")

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        for k in convs:
            wrappers[k].tc_launches = 0
        matmul_ws.path_launches = dict.fromkeys(PATHS, 0)

    def counts():
        return {k: fn.launches for k, fn in wrappers.items()}

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
        ref_engine = ConvNetEngine(qnet, batch=BATCH, core_config=ConvCoreConfig(
            int8=True, backend="ref"))
        ref_logits = ref_engine.submit(images)
        ref_engine.close()
        results = {}
        for kernel, expect in (("auto", "conv2d_ws_pipe"),
                               ("sequential", "conv2d_ws")):
            engine = ConvNetEngine(qnet, batch=BATCH, core_config=ConvCoreConfig(
                int8=True, kernel=kernel))
            reset_counts()
            logits = engine.submit(images)
            seen, served = counts(), engine.stats
            tc = {k: wrappers[k].tc_launches for k in convs}
            batches = -(-REQUESTS // BATCH)
            n_conv = sum(sp.kind == "conv" for sp in plan.layers)
            n_dense = sum(sp.kind == "dense" for sp in plan.layers)
            want = {k: 0 for k in wrappers}
            want[expect] = n_conv * batches
            want["matmul_ws"] = n_dense * batches
            if seen != want:
                raise AssertionError(f"{name} kernel={kernel}: launches "
                                     f"{seen}, expected {want}")
            if tc != {k: seen[k] for k in convs}:
                raise AssertionError(f"{name} kernel={kernel}: conv "
                                     f"launches {seen}, of them on the "
                                     f"tensor-core path {tc}")
            forms = dict.fromkeys(PATHS, 0)
            for i, sp in enumerate(plan.layers):
                if sp.kind == "dense":
                    k_in, k_out = plan.param_shapes()[i]["w"]
                    forms[mm_path(BATCH, k_in, k_out, torch.int8)] += batches
            if matmul_ws.path_launches != forms:
                raise AssertionError(f"{name} kernel={kernel}: matmul_ws "
                                     f"forms {matmul_ws.path_launches}, "
                                     f"expected {forms}")
            if logits.shape != (REQUESTS, plan.activation_shapes()[-1][0]) \
                    or not np.isfinite(logits).all():
                raise AssertionError(f"{name}: bad logits {logits.shape}")
            if not np.array_equal(logits, ref_logits):
                raise AssertionError(f"{name} kernel={kernel}: logits differ "
                                     f"from the plain backend")
            t0 = time.perf_counter()
            reps = 5
            for _ in range(reps):
                engine.submit(images)
            wall = (time.perf_counter() - t0) / reps
            _, busy, n_ev = device_busy(lambda: engine.submit(images))
            share = ("not measured (no device events in the trace)"
                     if busy is None else
                     f"device busy {busy:.3f} ms = {100 * busy / 1e3 / wall:.0f}"
                     f"% of it over {n_ev} device events (torch.profiler)")
            log(f"  {name} kernel={kernel}: launches {seen}, all "
                f"{tc[expect]} conv launches on the tensor-core path, "
                f"matmul_ws forms {forms}; logits "
                f"{logits.shape} bit-equal to the plain backend; "
                f"{REQUESTS} requests in {1e3 * wall:.2f} ms "
                f"({REQUESTS / wall:.1f} images/s, mean of {reps}); {share}; "
                f"stats {served}")
            results[kernel] = (seen, logits, wall)
            engine.close()
        rel = np.linalg.norm(logits - float_logits) / np.linalg.norm(
            float_logits)
        log(f"  {name}: int8 logits vs the float oracle: relative error "
            f"{rel:.4f}")
        return qnet, images, results, ref_logits

    log("phase 5: the conv main path")
    vq, vimages, results, vref = serve("vgg_imagenet",
                                       network.vgg_imagenet(), seed=0)
    for k in ("conv2d_ws_pipe", "matmul_ws"):
        stats[k]["launches"] = results["auto"][0][k]
    stats["conv2d_ws"]["launches"] = results["sequential"][0]["conv2d_ws"]
    for kernel, conv in (("auto", "conv2d_ws_pipe"),
                         ("sequential", "conv2d_ws")):
        wall_ms = 1e3 * results[kernel][2]
        busy = (-(-REQUESTS // BATCH) * (
            stats[conv]["device_ms"] + mm_device_ms["vgg_imagenet head"]))
        log(f"  vgg_imagenet kernel={kernel}: kernels {busy:.3f} ms of the "
            f"{wall_ms:.3f} ms submit (phase-3 device times x batches); "
            f"the rest, {wall_ms - busy:.3f} ms, is host work, plain glue "
            f"ops and launch gaps")
    lq, limages, lres, lref = serve("lenet", network.lenet(), seed=1)
    cpu_engine = ConvNetEngine(lq, batch=BATCH, device="cpu")
    cpu = cpu_engine.submit(limages)
    cpu_engine.close()
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
                     f"(phase-3 device time)")
        log(f"    prompt {n:5d}: admit (prefill + cache scatter) "
            f"{ms:.1f} ms{share}")
    def log_decode(eng, reqs, wall):
        busy_tokens = sum(b for b, _ in eng.step_ms)
        step_s = sum(ms for _, ms in eng.step_ms) / 1e3
        full = [ms for b, ms in eng.step_ms if b == LM_SLOTS]
        generated = sum(len(r.output) for r in reqs)
        steps = len(eng.step_ms)
        median_full = np.median(full) if full else float("nan")
        log(f"  decode: {steps} steps, {1e3 * step_s / steps:.2f} ms per "
            f"step on average, {median_full:.2f} ms median with all "
            f"{LM_SLOTS} slots busy; {busy_tokens / step_s:.1f} "
            f"tokens/s over the decode steps; {generated} tokens in "
            f"{wall:.2f} s of run ({generated / wall:.1f} tokens/s, "
            f"prefills included)")
        return generated

    def log_busy(eng, c, reqs, longest):
        """Device-busy share of a 4-slot decode step and of the longest
        prompt's prefill."""
        for r in reqs[:LM_SLOTS]:            # four busy slots again
            eng.admit(fresh([r])[0])
        for label, fn in (("decode step, 4 slots", eng.step),
                          (f"prefill of {len(longest)} tokens",
                           lambda: last_logits(eng.params, c, longest))):
            wall, busy, n = device_busy(fn)
            share = ("not measured (no device events in the trace)"
                     if busy is None else
                     f"device busy {busy:.1f} ms = {100 * busy / wall:.0f}% "
                     f"of it")
            log(f"  {label}: {wall:.1f} ms of host clock, {n} device events "
                f"under torch.profiler; {share}")

    generated = log_decode(engine, reqs, wall)
    xla_admit_ms = dict(engine.admit_ms)    # before log_busy admits again
    longest = max((r.prompt for r in reqs), key=len)
    log_busy(engine, cfg, reqs, longest)

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
    del plain_engine

    # the same requests with the MLP's three GEMMs a layer on matmul_ws
    cfg_ws = dataclasses.replace(cfg, gemm_backend="pallas_ws")
    ws_engine = TimedEngine(cfg_ws, engine.params, slots=LM_SLOTS,
                            max_seq=LM_MAX_SEQ)
    last_logits(ws_engine.params, cfg_ws, reqs[0].prompt)    # warm-up
    wreqs = fresh(reqs)
    reset_counts()
    t0 = time.perf_counter()
    ws_engine.run(wreqs)
    wall = time.perf_counter() - t0
    seen, forms = counts(), dict(matmul_ws.path_launches)
    steps = len(ws_engine.step_ms)
    mlp = 3 * cfg.num_layers
    want = {k: 0 for k in wrappers}
    want["flash_attention"] = cfg.num_layers * len(wreqs)
    want["matmul_ws"] = mlp * (len(wreqs) + steps)
    # prefills run M = prompt length > 16 rows, decode steps M = 4 slots
    want_forms = {"wgmma": mlp * len(wreqs), "stream": mlp * steps,
                  "scalar": 0}
    if seen != want or forms != want_forms:
        raise AssertionError(f"{cfg_ws.name} pallas_ws: launches {seen}, "
                             f"matmul_ws forms {forms}; expected {want}, "
                             f"{want_forms}")
    check_served(f"{cfg_ws.name} pallas_ws", cfg_ws, wreqs)
    stats["matmul_ws"]["launches"] += seen["matmul_ws"]
    log(f"  gemm_backend='pallas_ws': launches {seen} (3 × "
        f"{cfg.num_layers} matmul_ws per forward over {len(wreqs)} "
        f"prefills and {steps} decode steps; forms {forms}); "
        f"{len(wreqs)} requests × {LM_NEW_TOKENS} tokens, all in range")
    for r in wreqs:
        n, ms = len(r.prompt), ws_engine.admit_ms[r.uid]
        xla_ms = xla_admit_ms[r.uid]
        log(f"    prompt {n:5d}: admit {ms:.1f} ms with pallas_ws, "
            f"{xla_ms:.1f} ms with xla ({ms / xla_ms:.2f}×)")
    log_decode(ws_engine, wreqs, wall)
    log_busy(ws_engine, cfg_ws, wreqs, longest)

    # each layer's MLP rounds three bf16 GEMM outputs, each of which may
    # move by one bf16 ulp (at most 2^-7 relative) between matmul_ws and
    # the xla backend's torch.einsum; 3 × 28 such moves add at most
    # linearly unless the network amplifies them
    ws_bound = 3 * cfg.num_layers * 2.0 ** -7
    worst = 0.0
    for r in wreqs:
        a = last_logits(ws_engine.params, cfg_ws, r.prompt)
        b = last_logits(engine.params, cfg, r.prompt)
        rel = float((a - b).norm() / b.norm())
        if not bool(torch.isfinite(a).all()) or rel > ws_bound:
            raise AssertionError(f"{cfg_ws.name} pallas_ws prompt "
                                 f"{len(r.prompt)}: prefill logits off the "
                                 f"xla backend's by {rel:.4g} (bound "
                                 f"{ws_bound:.4g})")
        worst = max(worst, rel)
    same = sum(a == b for r, w in zip(reqs, wreqs)
               for a, b in zip(r.output, w.output))
    log(f"  prefill last-token logits against gemm_backend='xla': relative "
        f"L2 error at most {worst:.4g} over the {len(wreqs)} prompts "
        f"(bound {ws_bound:.4g}); greedy tokens equal to the xla run: "
        f"{same} of {generated} (counted, not required)")
    del engine, ws_engine
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

    # -- 7. continuous batching --------------------------------------------
    log("phase 7: continuous batching and the multi-core scheduler")

    class Recorder:
        """A backend that records every conv, transposed conv and GEMM it
        is handed (shapes, arguments, tile plan) and computes it on the
        kernels: the launches a program's run must make, read back as
        paths by ``conv_path`` and forms by ``mm_path``."""

        name = "record"

        def __init__(self):
            self.calls = []
            self.inner = get_backend("cuda")

        def conv(self, x, w, bias=None, **kw):
            self.calls.append(("conv", tuple(x.shape), tuple(w.shape), kw))
            return self.inner.conv(x, w, bias, **kw)

        def conv_transpose(self, x, w, bias=None, **kw):
            self.calls.append(("conv_transpose", tuple(x.shape),
                               tuple(w.shape), kw))
            return self.inner.conv_transpose(x, w, bias, **kw)

        def matmul(self, x, w, bias=None):
            self.calls.append(("matmul", tuple(x.shape), tuple(w.shape),
                               x.dtype))
            return self.inner.matmul(x, w, bias)

    def expected_launches(qnet, mode, cores, batches):
        """(launches, tensor-core launches, matmul forms) that ``batches``
        batches of ``qnet`` make under (mode, cores): one batch runs
        through the same scheduler around ``Recorder`` and each recorded
        call becomes one kernel launch, on the conv kernel its tile plan
        names and the path ``conv_path`` gives its geometry (a transposed
        conv's: its stride-1 lowering), or on the ``mm_path`` form."""
        rec = Recorder()
        register_backend(rec)
        sched = MultiCoreScheduler(SchedulerConfig(cores, mode))
        name = rec.name
        if mode != "batch":
            sb = sched.shard_backend(rec.name)
            register_backend(sb)
            name = sb.name
        program = network.make_int8_program(qnet, ConvCoreConfig(
            int8=True, backend=name))
        sched.run(program, torch.zeros((BATCH, *qnet.plan.input_shape),
                                       device=dev))
        torch.cuda.synchronize()
        unregister_backend(name)
        unregister_backend(rec.name)
        want = {k: 0 for k in wrappers}
        tc = {k: 0 for k in convs}
        forms = dict.fromkeys(PATHS, 0)
        for kind, xs, ws, kw in rec.calls:
            if kind == "matmul":
                forms[mm_path(xs[0], xs[1], ws[1], kw)] += batches
                want["matmul_ws"] += batches
                continue
            stride, pad = kw["stride"], kw["padding"]
            if kind == "conv_transpose":
                hd, wd, pad = transpose_eq_conv_geometry(
                    xs[1], xs[2], ws[0], ws[1], stride, pad, kw["dilation"])
                xs, stride = (xs[0], hd, wd, xs[3]), 1
            groups = kw.get("groups", 1)     # a dense kout shard omits it
            g = setup_conv(xs, ws, stride=stride, padding=pad,
                           groups=groups, cin_banks=1, kout_banks=groups,
                           pool=kw["pool"],
                           requant=kw["out_scale"] is not None,
                           dilation=kw["dilation"])
            plan = kw["plan"]
            k = "conv2d_ws_pipe" if plan and plan.pipelined else "conv2d_ws"
            want[k] += batches
            tc[k] += batches * (conv_path(g) == "tc")
        return want, tc, forms

    def cbe_serve(label, qnet, images, want_logits, mode="batch", cores=1,
                  reps=3):
        """Serve ``images`` through a ContinuousBatchingEngine under (mode,
        cores): logits bit-equal to the plain backend's, launch counts per
        kernel, path and form as ``expected_launches`` works them out;
        then the mean of ``reps`` more submits → (launches, submit s)."""
        backend, n_cores = "cuda", cores
        if mode != "batch":
            sb = MultiCoreScheduler(SchedulerConfig(cores, mode)) \
                .shard_backend("cuda")
            register_backend(sb)
            backend, n_cores = sb.name, 1
        eng = ContinuousBatchingEngine(batch=BATCH, n_cores=n_cores,
                                       backend=backend, device=dev)
        eng.add_model(qnet)
        batches = -(-len(images) // BATCH)
        want, want_tc, want_forms = expected_launches(qnet, mode, cores,
                                                      batches)
        reset_counts()
        logits = eng.submit(images)
        seen = counts()
        tc = {k: wrappers[k].tc_launches for k in convs}
        forms = dict(matmul_ws.path_launches)
        if (seen, tc, forms) != (want, want_tc, want_forms):
            raise AssertionError(
                f"{label} {mode}×{cores}: launches {seen}, tensor-core "
                f"{tc}, matmul forms {forms}; expected {want}, {want_tc}, "
                f"{want_forms}")
        if logits.shape != want_logits.shape or not np.isfinite(
                logits).all() or not np.array_equal(logits, want_logits):
            raise AssertionError(f"{label} {mode}×{cores}: logits differ "
                                 f"from the plain backend")
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.submit(images)
        wall = (time.perf_counter() - t0) / reps
        log(f"  {label} {mode} × {cores} cores: launches {seen} "
            f"(tensor-core {tc}, matmul_ws forms {forms}, as conv_path / "
            f"mm_path give them); logits {logits.shape} bit-equal to the "
            f"plain backend; submit of {len(images)} in {1e3 * wall:.2f} ms "
            f"({len(images) / wall:.1f} images/s, mean of {reps}); "
            f"formation {eng.formation_counts()}")
        eng.close()
        if mode != "batch":
            unregister_backend(backend)
        return seen, wall

    cbe_launches = {k: 0 for k in wrappers}
    for mode in ("batch", "kout", "spatial"):
        seen, _ = cbe_serve("vgg_imagenet 224", vq, vimages, vref, mode, 4)
        for k in wrappers:
            cbe_launches[k] += seen[k]

    rng = np.random.default_rng(2)
    uplan = network.unet_small(input_shape=(224, 224, 4), classes=3)
    uparams = uplan.init_params(rng, device=dev)
    ucal = torch.from_numpy(rng.normal(size=(REQUESTS, *uplan.input_shape))
                            .astype(np.float32)).to(dev)
    uq = network.quantize_network(uplan, uparams, ucal)
    uimages = rng.normal(size=(REQUESTS, *uplan.input_shape)).astype(
        np.float32)
    uref_engine = ContinuousBatchingEngine(batch=BATCH, backend="ref",
                                           device=dev)
    uref_engine.add_model(uq)
    uref = uref_engine.submit(uimages)
    uref_engine.close()
    log(f"  unet_small 224×224×4, 3 classes: transposed convs up1 "
        f"{uplan.activation_shapes()[4][:2]} → "
        f"{uplan.activation_shapes()[5][:2]} and up2 → "
        f"{uplan.activation_shapes()[8][:2]}")
    seen, _ = cbe_serve("unet_small 224", uq, uimages, uref)
    for k in wrappers:
        cbe_launches[k] += seen[k]
    seen, _ = cbe_serve("lenet", lq, limages, lref)
    for k in wrappers:
        cbe_launches[k] += seen[k]

    # no hidden host sync in a dispatch: one formed batch through
    # _dispatch with torch's sync debug mode raising on any synchronizing
    # call (a fresh engine whose worker is idle after one warm batch)
    eng = ContinuousBatchingEngine(batch=BATCH, n_cores=4, device=dev)
    eng.add_model(vq)
    eng.submit(vimages[:BATCH])
    now = time.perf_counter_ns()
    fb = FormedBatch(model=vq.plan.name, reason="drain", requests=[
        ServeRequest(uid=10_000 + i, model=vq.plan.name, image=vimages[i],
                     priority="interactive", enqueue_ns=now,
                     deadline_ns=now, future=Future())
        for i in range(BATCH)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._dispatch(fb)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng._retire_one()
    got = np.stack([r.future.result(timeout=60) for r in fb.requests])
    if not np.array_equal(got, vref[:BATCH]):
        raise AssertionError("sync-debug dispatch: logits differ")
    eng.close()
    log("  one vgg_imagenet batch dispatched under "
        "torch.cuda.set_sync_debug_mode('error'): no synchronizing call, "
        "logits bit-equal")

    # one engine, three models, a 2-program cache, four submitters
    models = {"vgg_imagenet": (vq, vimages, vref),
              "unet_small": (uq, uimages, uref),
              "lenet": (lq, limages, lref)}
    eng = ContinuousBatchingEngine(batch=BATCH, n_cores=4, device=dev,
                                   cache_capacity=2, deadline_ms=2.0)
    for name, (q, _, _) in models.items():
        eng.add_model(q, name=name)
    names = list(models)
    # thread t, chunk j: 4 images of one model, the models in turn
    per_thread = [[(names[(t + j) % 3], 4 * ((t + j) % 4)) for j in range(4)]
                  for t in range(4)]
    errors, outs = [], {}

    def submitter(t):
        try:
            mine = []
            for j, (name, start) in enumerate(per_thread[t]):
                mine.append((name, start, eng.submit_async(
                    models[name][1][start:start + 4], model=name,
                    priority=("interactive", "bulk")[(t + j) % 2])))
            outs[t] = [(name, start, [f.result(timeout=300) for f in futs])
                       for name, start, futs in mine]
        except BaseException as e:      # reported below
            errors.append((t, e))

    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"multi-model submitters failed: {errors}")
    n_req = 0
    for name, start, logits in (c for chunks in outs.values()
                                for c in chunks):
        want = models[name][2][start:start + 4]
        if not np.array_equal(np.stack(logits), want):
            raise AssertionError(f"multi-model {name}[{start}:]: logits "
                                 f"differ from the plain backend")
        n_req += len(logits)
    cache = eng.cache_stats()
    if n_req < 64 or cache["evictions"] < 1 or cache["misses"] <= 3:
        raise AssertionError(f"multi-model: {n_req} requests, cache {cache}: "
                             f"no evict and rebuild")
    for k, v in counts().items():
        cbe_launches[k] += v
    log(f"  one engine, 3 models, cache capacity 2, 4 submitter threads "
        f"(interactive and bulk): {n_req} requests in {wall:.3f} s "
        f"({n_req / wall:.1f} images/s), all bit-equal to the plain "
        f"backend; cache {cache}; formation {eng.formation_counts()}; "
        f"latency {eng.latency_percentiles()}")
    eng.close()

    # throughput: the synchronous submit beside an open-loop async load
    eng = ContinuousBatchingEngine(batch=BATCH, n_cores=4, device=dev,
                                   max_inflight=2)
    eng.add_model(vq)
    eng.submit(vimages)
    n_async = 8 * REQUESTS

    def async_load():
        futs = []
        for i in range(n_async // REQUESTS):
            futs += eng.submit_async(vimages, priority="bulk")
        for f in futs:
            f.result(timeout=300)

    async_ms, busy, n_ev = device_busy(async_load)
    lat = eng.latency_percentiles()
    forms_async = eng.formation_counts()
    async_wall = async_ms / 1e3
    share = ("not measured (no device events in the trace)" if busy is None
             else f"{busy:.3f} ms = {100 * busy / async_ms:.0f}%")
    sync_wall = results["auto"][2]
    log(f"  vgg_imagenet 224 throughput (batch 8, 4 virtual cores, "
        f"max_inflight 2): open-loop {n_async} bulk requests in "
        f"{1e3 * async_wall:.1f} ms = {n_async / async_wall:.1f} images/s; "
        f"latency enqueue → result p50 {lat['p50']:.0f} us, p90 "
        f"{lat['p90']:.0f} us, p99 {lat['p99']:.0f} us over "
        f"{lat['count']} requests; formation {forms_async}; device busy "
        f"{share} of the async load (torch.profiler, {n_ev} device events); "
        f"phase 5's synchronous submit of {REQUESTS} (kernel=auto, same "
        f"run): {1e3 * sync_wall:.2f} ms = {REQUESTS / sync_wall:.1f} "
        f"images/s")
    eng.close()

    for k in wrappers:
        stats[k]["launches"] += cbe_launches[k]

    # -- 8. results --------------------------------------------------------
    rows = []
    for name, (source, replaces) in KERNELS.items():
        st = stats[name]
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=st["launches"], max_abs_err=st["max_abs_err"],
            ms=st["ms"], device_ms=st["device_ms"], plain_ms=st["plain_ms"],
            bound_ms=sum(st["bound"].values()),
            bound_by=max(st["bound"], key=st["bound"].get),
            library_ms=st["library_ms"]))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
