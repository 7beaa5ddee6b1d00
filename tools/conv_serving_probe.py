#!/usr/bin/env python3
"""Time the port's conv serving path on one GPU, so that two trees can be
compared in turns within one run.

    PYTHONPATH=<tree>/src python3 tools/conv_serving_probe.py [--reps 20]

For ``vgg_imagenet`` (224×224×4, 1000 classes) and ``lenet``, each
quantized from random seed-0 weights, it prints one JSON line with:

* ``submit_ms``: host clock around ``ConvNetEngine(qnet, batch=8)
  .submit`` of 16 images (median and mean of ``--reps`` after a warm-up);
* ``program_ms``: the same 16 images as two batches straight through
  ``make_int8_program``'s program (pageable upload, synchronized);
* ``async_images_per_s``: where the tree has ``ContinuousBatchingEngine``,
  an open-loop load of 128 requests through it (batch 8, 4 virtual cores,
  ``max_inflight`` 2), host clock to the last result;
* ``breakdown_ms``: there too, a synchronous submit split by the engine's
  own steps, mean over ``--reps``: from ``submit`` to the worker's first
  ``_dispatch`` (``to_first_dispatch``), inside ``_dispatch`` (staging,
  upload, launches), inside ``_retire_one`` (the wait on the batch's
  event, the copy out, the futures), from the last retire back to the
  caller (``to_return``) and the rest (the worker's loop between them);

beside the card's name and power limit.  It uses only the API both the
synchronous engine and its facade over the continuous-batching engine
share, so it runs on either.  ``--profile`` also prints, for the
open-loop load, the continuous-batching engine's worker thread under
``cProfile`` (the 25 functions with the most own time; cProfile slows
the Python it sees, so read shares, not times)."""

import argparse
import cProfile
import json
import pstats
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.core import network
from repro_torch.core.convcore import ConvCoreConfig
from repro_torch.serving.engine import ConvNetEngine

BATCH, REQUESTS = 8, 16


def qnet_and_images(plan, seed, dev):
    rng = np.random.default_rng(seed)
    params = plan.init_params(rng, device=dev)
    calib = torch.from_numpy(rng.normal(size=(REQUESTS, *plan.input_shape))
                             .astype(np.float32)).to(dev)
    qnet = network.quantize_network(plan, params, calib)
    images = rng.normal(size=(REQUESTS, *plan.input_shape)).astype(np.float32)
    return qnet, images


def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return {"median": statistics.median(out), "mean": statistics.fmean(out)}


def breakdown(engine, images, reps):
    """Mean ms of a synchronous submit's parts (see the module note)."""
    marks = []
    dispatch, retire = engine._dispatch, engine._retire_one

    def timed_dispatch(fb):
        t0 = time.perf_counter_ns()
        dispatch(fb)
        marks.append(("dispatch", t0, time.perf_counter_ns()))

    def timed_retire():
        t0 = time.perf_counter_ns()
        retire()
        marks.append(("retire", t0, time.perf_counter_ns()))

    engine._dispatch, engine._retire_one = timed_dispatch, timed_retire
    parts = dict.fromkeys(("total", "to_first_dispatch", "dispatch",
                           "retire", "to_return", "rest"), 0.0)
    try:
        for _ in range(reps):
            marks.clear()
            t0 = time.perf_counter_ns()
            engine.submit(images)
            t1 = time.perf_counter_ns()
            d = sum(b - a for k, a, b in marks if k == "dispatch")
            r = sum(b - a for k, a, b in marks if k == "retire")
            first = min(a for _, a, _ in marks) - t0
            back = t1 - max(b for _, _, b in marks)
            for key, v in (("total", t1 - t0), ("to_first_dispatch", first),
                           ("dispatch", d), ("retire", r),
                           ("to_return", back),
                           ("rest", t1 - t0 - first - d - r - back)):
                parts[key] += v / 1e6 / reps
    finally:
        del engine._dispatch, engine._retire_one
    return parts


def probe(name, plan, seed, dev, reps, profile=False):
    qnet, images = qnet_and_images(plan, seed, dev)
    engine = ConvNetEngine(qnet, batch=BATCH)
    row = {"net": name,
           "submit_ms": timed(lambda: engine.submit(images), reps)}
    if hasattr(engine, "engine"):
        row["breakdown_ms"] = breakdown(engine.engine, images, reps)
    if hasattr(engine, "close"):
        engine.close()
    program = network.make_int8_program(qnet.to(dev),
                                        ConvCoreConfig(int8=True))

    def direct():
        for i in range(0, REQUESTS, BATCH):
            program(torch.from_numpy(images[i:i + BATCH]).to(dev))

    row["program_ms"] = timed(direct, reps)
    try:
        from repro_torch.serving.batching import ContinuousBatchingEngine
    except ImportError:
        return row
    eng = ContinuousBatchingEngine(batch=BATCH, n_cores=4, max_inflight=2)
    eng.add_model(qnet)
    eng.submit(images)

    def load():
        futs = []
        for _ in range(128 // REQUESTS):
            futs += eng.submit_async(images, priority="bulk")
        for f in futs:
            f.result(timeout=300)

    ms = timed(load, max(reps // 4, 3))
    row["async_images_per_s"] = 128 / (ms["median"] / 1e3)
    eng.close()
    if profile:
        prof = cProfile.Profile()
        serve_loop = ContinuousBatchingEngine._serve_loop
        ContinuousBatchingEngine._serve_loop = \
            lambda self: prof.runcall(serve_loop, self)
        try:
            eng = ContinuousBatchingEngine(batch=BATCH, n_cores=4,
                                           max_inflight=2)
            eng.add_model(qnet)
            for _ in range(4):
                load()
            eng.close()
        finally:
            ContinuousBatchingEngine._serve_loop = serve_loop
        print(f"worker thread of {name}'s open-loop load under cProfile:")
        pstats.Stats(prof).sort_stats("tottime").print_stats(25)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_serving_probe: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    for name, plan, seed in (("vgg_imagenet", network.vgg_imagenet(), 0),
                             ("lenet", network.lenet(), 1)):
        row = probe(name, plan, seed, dev, args.reps, args.profile)
        row.update(label=args.label, card=card)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
