"""End-to-end training example with the production loop: checkpointing,
fault-injection recovery and straggler monitoring, on a llama-family
model of configurable size.

The default is laptop scale; ``--preset 100m`` trains the reference's
"~100M" preset (8 layers, d = 768, 12 heads over 4 KV heads, a 32k
vocabulary, f32: 75.5M parameters by ``param_count``).

    PYTHONPATH=src python -m repro_torch.examples.train_llama_tiny --steps 60
    PYTHONPATH=src python -m repro_torch.examples.train_llama_tiny \
        --preset 100m --steps 300 --batch 32 --seq 512

It runs on the card unless ``--device`` names another device; ``main``
returns the first and last loss, the restarts, the straggler events and
the step times.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict

import torch

from repro_torch.configs.base import get_config, param_count, reduce_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.layers.common import materialize
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_state_specs, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_config(preset: str):
    base = get_config("llama3.2-3b")
    if preset == "tiny":
        return reduce_config(base)
    if preset == "100m":
        # 8L, d=768, 12H/4KV, ff=2048, 32k vocab: 75.5M params
        return dataclasses.replace(
            base, num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32768, attn_chunk=256,
            remat_policy="none", compute_dtype="float32")
    raise ValueError(preset)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", choices=("tiny", "100m"), default="tiny")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_example"))
    p.add_argument("--fail-at", type=int, nargs="*", default=[],
                   help="inject failures at these steps (recovery demo)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    cfg = build_config(args.preset)
    print(f"model: {cfg.num_layers}L d={cfg.d_model} "
          f"params≈{param_count(cfg) / 1e6:.1f}M")
    dev = resolve_device(args.device)

    sspecs = init_state_specs(cfg)
    state = {
        "params": materialize(sspecs["params"], torch.Generator(
            device=dev).manual_seed(0), device=dev),
        "opt": materialize(sspecs["opt"], torch.Generator(
            device=dev).manual_seed(1), device=dev),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch, seed=0))
    hp = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                     total_steps=args.steps)
    step_fn = make_train_step(cfg, hp)

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=max(args.steps // 5, 10),
                      checkpoint_dir=args.ckpt_dir, log_every=10,
                      fail_at_steps=tuple(args.fail_at)),
        step_fn, pipe, state)
    t0 = time.perf_counter()
    history = trainer.run()
    run_s = time.perf_counter() - t0
    print(f"done: loss {history[0]['loss']:.4f} → {history[-1]['loss']:.4f} "
          f"({trainer.restarts} restarts, "
          f"{len(trainer.monitor.events)} straggler events)")
    return {"params": param_count(cfg), "loss_first": history[0]["loss"],
            "loss_last": history[-1]["loss"], "restarts": trainer.restarts,
            "straggler_events": list(trainer.monitor.events),
            "steps_run": len(history), "run_s": run_s,
            "step_s": [h["dt"] for h in history],
            "tokens_per_step": args.batch * args.seq,
            "history_steps": [h["step"] for h in history]}


if __name__ == "__main__":
    main()
