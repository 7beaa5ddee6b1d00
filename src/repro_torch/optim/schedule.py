"""Learning-rate schedules: pure functions of the step counter
(counterpart of ``repro.optim.schedule``), computed in f32 on the step's
device."""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``final_frac·peak_lr``.  The step+1 convention: the first optimizer
    step takes a non-zero rate."""
    step = _step_f32(step) + 1.0
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step <= warmup_steps,
                       torch.clamp(warm, max=peak_lr), cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(_step_f32(step), peak_lr)


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}
