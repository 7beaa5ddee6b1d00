"""Quickstart: train a tiny llama-family model on synthetic data, then
greedily generate from it — the whole public API in one page.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the card unless ``--device`` names another device; ``main``
returns the losses and the generated tokens.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

from repro_torch.configs.base import get_config, reduce_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.layers.common import materialize
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving.serve_step import greedy_sample
from repro_torch.train.train_step import init_state_specs, make_train_step

STEPS = 60


def build(dev: torch.device):
    """(the reduced llama3-8b, its train state, the data pipeline)."""
    cfg = reduce_config(get_config("llama3-8b"))
    sspecs = init_state_specs(cfg)
    state = {
        "params": materialize(sspecs["params"], torch.Generator(
            device=dev).manual_seed(0), device=dev),
        "opt": materialize(sspecs["opt"], torch.Generator(
            device=dev).manual_seed(1), device=dev),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=8, seed=0))
    return cfg, state, pipe


def train(cfg, state, pipe, steps: int = STEPS):
    """``steps`` AdamW steps (peak lr 1e-2, 5 warm-up steps, a schedule
    over 60) → (the state after them, the loss of each step)."""
    dev = state["step"].device
    step_fn = make_train_step(
        cfg, AdamWConfig(peak_lr=1e-2, warmup_steps=5, total_steps=STEPS))
    losses = []
    for s in range(steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.batch_at(s).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if s % 10 == 0:
            print(f"step {s:3d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}")
    return state, losses


@torch.no_grad()
def generate(cfg, params, pipe, dev: torch.device,
             new_tokens: int = 8) -> List[int]:
    """Prefill a 16-token prompt into a 32-position cache on ``dev``, then
    decode ``new_tokens`` steps greedily."""
    prompt = torch.as_tensor(pipe.batch_at(999)["tokens"][:1, :16],
                             device=dev)
    logits, cache = lm.prefill(params, {"tokens": prompt}, cfg, cache_len=32)
    toks = [int(greedy_sample(logits)[0])]
    for i in range(new_tokens):
        lg, cache = lm.decode_step(
            params, cfg,
            token=torch.tensor([toks[-1]], dtype=torch.int32, device=dev),
            pos=torch.tensor([16 + i], dtype=torch.int32, device=dev),
            cache=cache)
        toks.append(int(greedy_sample(lg)[0]))
    return toks


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, state, pipe = build(dev)
    print(f"arch: {cfg.name} (reduced) — {cfg.num_layers}L d={cfg.d_model}")
    t0 = time.perf_counter()
    state, losses = train(cfg, state, pipe)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    toks = generate(cfg, state["params"], pipe, dev)
    print("generated:", toks)
    return {"losses": losses, "train_s": train_s, "generated": toks}


if __name__ == "__main__":
    main()
