"""RMSNorm / LayerNorm, computed in f32 and cast back."""

from __future__ import annotations

import torch

from repro_torch.layers.common import ParamSpec


def rmsnorm_specs(d: int, unit_offset: bool = False):
    init = "zeros" if unit_offset else "ones"
    return {"scale": ParamSpec((d,), ("embed",), init=init)}


def layernorm_specs(d: int):
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def norm_specs(cfg, d: int | None = None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return rmsnorm_specs(d, cfg.rmsnorm_unit_offset)
    return layernorm_specs(d)


def apply_norm(params, x: torch.Tensor, cfg, eps: float = 1e-6):
    orig = x.dtype
    x = x.float()
    if cfg.norm == "rmsnorm":
        var = x.square().mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + eps)
        scale = params["scale"].float()
        if cfg.rmsnorm_unit_offset:
            scale = 1.0 + scale
        return (x * scale).to(orig)
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(orig)
