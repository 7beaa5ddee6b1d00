"""Rotary position embeddings + sinusoidal absolute positions."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, D]; positions: [B, S] (int)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [half]
    angles = positions[..., None].float() * freqs              # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int):
    """Classic transformer sinusoidal table, computed on the fly.
    positions: [B, S] → [B, S, d_model]."""
    half = d_model // 2
    freqs = 1.0 / (10_000.0 ** (torch.arange(
        half, dtype=torch.float32, device=positions.device) / half))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
