"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains the reduced variant of an architecture (as the reference's
launcher does: its ``--reduced`` defaults to on and cannot be turned off)
on ``SyntheticLM`` data through ``Trainer``, from params drawn from seed
0, with periodic checkpoints under ``--ckpt-dir``; ``--resume`` restores
the latest one first.  It runs on the GPU unless ``--device`` names
another device, and returns the trainer's history."""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint.checkpoint import process_index_count
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.layers.common import materialize
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_state_specs, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--reduced", action="store_true", default=True,
                   help="reduced config (always on, as the reference's)")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    dev = resolve_device(args.device)

    sspecs = init_state_specs(cfg)
    state = {
        "params": materialize(sspecs["params"], torch.Generator(
            device=dev).manual_seed(0), device=dev),
        "opt": materialize(sspecs["opt"], torch.Generator(
            device=dev).manual_seed(1), device=dev),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    rank, world = process_index_count()
    pipe = make_pipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch, seed=0),
        process_index=rank, process_count=world)
    hp = AdamWConfig(peak_lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 20, 2))
    step_fn = make_train_step(cfg, hp, accum_steps=args.accum)

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, checkpoint_dir=args.ckpt_dir,
                      checkpoint_every=max(args.steps // 5, 10)),
        step_fn, pipe, state)
    if args.resume and trainer.ckpt.latest_step() is not None:
        trainer.state, _ = trainer.ckpt.restore(trainer.state)
        print(f"resumed from step {trainer.ckpt.latest_step()}")
    return trainer.run()


if __name__ == "__main__":
    main()
