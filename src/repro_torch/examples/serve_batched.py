"""End-to-end serving example (the paper is an inference accelerator, so
the serving path is the headline example): a batched engine with slot
recycling serves a stream of requests against a small model, optionally
through the paper's int8 datapath (w8 weights + int8 KV cache; only the
dense decoders have a w8 path, as in ``repro_torch.launch.serve``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        [--w8] [--requests 8] [--device cpu]

It runs on the card unless ``--device`` names another device; ``main``
returns the printed figures as a dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduce_config
from repro_torch.core.quantize import quantize_weights
from repro_torch.device import resolve_device
from repro_torch.launch.serve import w8_refusal
from repro_torch.layers.common import materialize
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="llama3.2-3b")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--slots", type=int, default=3)
    p.add_argument("--max-new", type=int, default=12)
    p.add_argument("--w8", action="store_true",
                   help="serve through the paper's 8-bit datapath")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    cfg = reduce_config(get_config(args.arch))
    refusal = w8_refusal(cfg, args.arch) if args.w8 else None
    if refusal:
        p.error(refusal)
    dev = resolve_device(args.device)
    params = materialize(lm.param_specs(cfg), torch.Generator(
        device=dev).manual_seed(0), device=dev)
    if args.w8:
        params = quantize_weights(params, lm.param_specs(cfg))
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8",
                                  kv_cache_scale=0.25)
        print("serving via w8 weights + int8 KV cache")

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=int(rng.integers(4, 12)))
                    .astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]

    engine = ServingEngine(cfg, params, slots=args.slots, max_seq=128,
                           device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = engine.run(list(reqs))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {total_tokens} tokens "
          f"in {dt:.2f}s with {args.slots} slots on {dev}")
    for r in sorted(done, key=lambda r: r.uid)[:4]:
        print(f"  req {r.uid}: prompt {len(r.prompt)} toks → {r.output}")
    return {"requests": len(done), "tokens": total_tokens, "seconds": dt,
            "tokens_per_s": total_tokens / dt if dt > 0 else None,
            "outputs": {r.uid: list(r.output) for r in done},
            "max_new": args.max_new, "w8": args.w8}


if __name__ == "__main__":
    main()
