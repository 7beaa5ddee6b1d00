"""Gated feed-forward (SwiGLU / GeGLU)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.layers.common import ParamSpec, dense, lconstraint


def mlp_specs(cfg, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
        "wi_up": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def apply_mlp(params, x, cfg):
    g = dense(params["wi_gate"], x, "bsd,df->bsf", backend=cfg.gemm_backend,
              compute_dtype=cfg.compute_dtype)
    u = dense(params["wi_up"], x, "bsd,df->bsf", backend=cfg.gemm_backend,
              compute_dtype=cfg.compute_dtype)
    h = _act(cfg.mlp_act)(g) * u
    h = lconstraint(h, ("batch", "seq", "mlp"))
    y = dense(params["wo"], h, "bsf,fd->bsd", backend=cfg.gemm_backend,
              compute_dtype=cfg.compute_dtype)
    return lconstraint(y, ("batch", "seq_r", "embed"))
