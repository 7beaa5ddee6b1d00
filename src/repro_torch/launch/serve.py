"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Brings up ``ServingEngine`` on the reduced variant of an architecture (as
the reference's launcher does) with random weights from seed 0, serves a
synthetic request stream, and prints the requests, tokens and seconds.
It runs on the GPU unless ``--device`` names another device."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduce_config
from repro_torch.device import resolve_device
from repro_torch.layers.common import materialize
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--w8", action="store_true",
                   help="w8 weights + int8 KV cache (not ported yet)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.w8:
        raise NotImplementedError("--w8 waits on the w8 serving slice of "
                                  "the port (ROADMAP A14)")

    dev = resolve_device(args.device)
    cfg = reduce_config(get_config(args.arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = materialize(lm.param_specs(cfg), gen, device=dev)

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
