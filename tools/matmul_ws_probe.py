#!/usr/bin/env python3
"""Design probes of ``matmul_ws`` on one NVIDIA GPU (sm_90a).

    python3 tools/matmul_ws_probe.py

1. The ``wgmma`` form's consumer loop, as built (each K step's products
   waited for before its stage is released) against a variant that keeps
   one step's group in flight across the loop: whether ptxas serializes
   the wgmmas (its C7515 report), and the time of each at both tile widths
   (128 and 256) at llama3.2-3b's MLP prefill shapes, beside
   ``torch.matmul``.  The variant is built from the current source into
   ``build/matmul_ws_probe/`` and never used elsewhere.
2. The wrapper's host time a call at a decode shape, and its parts.

Every time is CUDA events around back-to-back calls, twice in turn; the
card's name and power limit come first.
"""

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

AS_BUILT = """      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(empty(s));
    }
"""
IN_FLIGHT = """      wgmma_wait<1>();
      if (it > 0 && t == 0) mbar_arrive(empty((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
"""
SHAPES = ((3000, 3072, 8192), (3000, 8192, 3072), (512, 3072, 8192),
          (64, 3072, 8192))


def build_variants(_build):
    src_dir = _build.CSRC
    out = ROOT / "build" / "matmul_ws_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (src_dir / "matmul_ws.cu").read_text()
    if src.count(AS_BUILT) != 1:
        raise RuntimeError("the wgmma consumer loop is not the one this "
                           "probe knows")
    variants = {"as built": src, "in flight": src.replace(AS_BUILT,
                                                         IN_FLIGHT)}
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
             str(out / f"v{i}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out / f"v{i}.so")
    fns = {}
    for name, (proc, lib) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{report}")
        print(f"{name}: ptxas C7515 (wgmma serialized) "
              f"{'reported' if 'C7515' in report else 'not reported'}",
              flush=True)
        fn = ctypes.CDLL(str(lib)).matmul_ws_wgmma
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("matmul_ws_probe: no CUDA device is available")
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul_ws as mm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def elapsed_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    fns = build_variants(_build)
    stream = torch.cuda.current_stream().cuda_stream
    for m, k, n in SHAPES:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=gen, device=dev)
             / k ** 0.5).bfloat16()
        out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        want = mm.matmul_ws_plain(x, w)
        times = {}
        for _ in range(2):
            for name, fn in fns.items():
                for bn in (128, 256):
                    def call(fn=fn, bn=bn):
                        code = fn(x.data_ptr(), w.data_ptr(), None,
                                  out.data_ptr(), m, n, k, bn, stream)
                        if code:
                            raise RuntimeError(f"launch failed: {code}")
                    call()
                    torch.cuda.synchronize()
                    err = float((out.float() - want.float()).abs().max())
                    times.setdefault((name, bn), []).append(
                        (elapsed_ms(call), err))
        lib = elapsed_ms(lambda: torch.matmul(x, w))
        flops = 2 * m * k * n
        print(f"[{m},{k}]@[{k},{n}] bf16: torch.matmul {lib:.4f} ms; "
              f"wgmma_bn picks {mm.wgmma_bn(m, n)}", flush=True)
        for (name, bn), runs in times.items():
            best = min(t for t, _ in runs)
            print(f"  {name}, BN {bn}: "
                  + ", ".join(f"{t:.4f}" for t, _ in runs)
                  + f" ms ({flops / best / 1e9:.0f} TFLOP/s), max abs err "
                  f"vs plain {max(e for _, e in runs):.3g}", flush=True)

    x = torch.randn(4, 3072, generator=gen, device=dev).bfloat16()
    w = torch.randn(3072, 8192, generator=gen, device=dev).bfloat16()
    out = torch.empty(4, 8192, dtype=torch.bfloat16, device=dev)
    split, kc = mm.stream_plan(4, 3072, 8192)
    part = torch.empty(split, 4, 8192, device=dev)
    lib = mm._library()

    def host_us(fn, reps=300):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / reps

    ptrs = (x.data_ptr(), w.data_ptr(), None, out.data_ptr())
    print("host us a call at [4,3072]@[3072,8192] bf16 (300 calls "
          "enqueued):", flush=True)
    for label, fn in (
            ("matmul_ws, the whole wrapper", lambda: mm.matmul_ws(x, w)),
            ("the C entry alone (stream + reduce kernels)",
             lambda: lib.matmul_ws_stream(*ptrs, part.data_ptr(), 4, 8192,
                                          3072, kc, split, 2, stream)),
            ("torch.empty of the output", lambda: torch.empty(
                (4, 8192), dtype=torch.bfloat16, device=dev)),
            ("torch.cuda.current_stream(device).cuda_stream",
             lambda: torch.cuda.current_stream(x.device).cuda_stream),
            ("torch._C._cuda_getCurrentRawStream",
             lambda: torch._C._cuda_getCurrentRawStream(x.get_device())),
            ("torch.matmul", lambda: torch.matmul(x, w)),
            ("torch.einsum('bsd,df->bsf'), the xla backend's call",
             lambda: torch.einsum("bsd,df->bsf", x[:, None], w))):
        print(f"  {label}: {host_us(fn):.1f}", flush=True)


if __name__ == "__main__":
    main()
