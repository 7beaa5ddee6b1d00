"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Brings up ``ServingEngine`` on the reduced variant of an architecture (as
the reference's launcher does) with random weights from seed 0, serves a
synthetic request stream, and prints the requests, tokens and seconds.
``--w8`` switches to the paper's 8-bit datapath: w8 weights
(``quantize_weights``) and an int8 KV cache at a fixed scale of 0.25, as
the reference does; the recurrent (recurrentgemma-9b, rwkv6-1.6b), MoE
(deepseek-moe-16b, qwen3-moe-30b-a3b), encoder-decoder
(seamless-m4t-medium) and VLM (internvl2-26b) families have no w8 path,
in the reference either (it fails on each), so ``--w8`` refuses them.
An encoder-decoder is not served at all (see ``ServingEngine``).  It runs
on the GPU unless ``--device`` names another device."""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (BLOCK_RGLRU, BLOCK_RWKV6, get_config,
                                      reduce_config)
from repro_torch.core.quantize import quantize_weights
from repro_torch.device import resolve_device
from repro_torch.layers.common import materialize
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServingEngine


def w8_refusal(cfg, arch: str) -> Optional[str]:
    """Why ``--w8`` cannot serve ``cfg`` (None where it can): only the
    dense decoders read every weight through ``dense``."""
    recurrent = {BLOCK_RGLRU, BLOCK_RWKV6} & set(cfg.layer_pattern)
    if recurrent:
        return (f"--w8: {arch} has {sorted(recurrent)} blocks, whose "
                f"weights are read outside dense and have no w8 path")
    if cfg.moe is not None or cfg.kind != "decoder":
        what = "MoE" if cfg.moe is not None else cfg.kind
        return (f"--w8: {arch} is a {what} model, whose weights are "
                f"read outside dense (the router, the experts, the "
                f"frontend projection) and have no w8 path")
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--w8", action="store_true",
                   help="w8 weights + int8 KV cache")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    cfg = reduce_config(get_config(args.arch))
    refusal = w8_refusal(cfg, args.arch) if args.w8 else None
    if refusal:
        p.error(refusal)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = materialize(lm.param_specs(cfg), gen, device=dev)
    if args.w8:
        params = quantize_weights(params, lm.param_specs(cfg))
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8",
                                  kv_cache_scale=0.25)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new_tokens=args.max_new) for i in range(args.requests)]
    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_seq=args.max_seq, device=dev)
    t0 = time.perf_counter()
    done = engine.run(list(reqs))
    toks = sum(len(r.output) for r in done)
    print(f"{len(done)} requests, {toks} tokens, "
          f"{time.perf_counter() - t0:.2f}s on {dev}")


if __name__ == "__main__":
    main()
