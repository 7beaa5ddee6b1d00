"""Serving steps: prefill (context ingest → cache) and decode (one token),
and token sampling (counterpart of ``repro.serving.serve_step``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.common import activate_rules
from repro_torch.models import lm


def make_prefill_step(cfg: ArchConfig, act_rules: Optional[Dict] = None):
    def prefill_step(params, batch):
        with activate_rules(act_rules):
            return lm.prefill(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ArchConfig, act_rules: Optional[Dict] = None):
    """decode_step(params, cache, token [B], pos [B]) → (logits, cache);
    the cache is updated in place."""
    def decode_step(params, cache, token, pos):
        with activate_rules(act_rules):
            return lm.decode_step(params, cfg, token=token, pos=pos,
                                  cache=cache)
    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary; a tie goes to the first maximum, as
    with ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float = 1.0) -> torch.Tensor:
    if temperature == 0.0:
        return greedy_sample(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(
        torch.int32)
