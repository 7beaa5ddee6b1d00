"""Token embeddings / unembedding (tied optional)."""

from __future__ import annotations

import math

import torch

from repro_torch.device import is_dtensor
from repro_torch.layers.common import ParamSpec, cast, einsum, lconstraint


def embedding_specs(cfg):
    specs = {"embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), init="normal", scale=0.02)}
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     ("embed", "vocab"), init="fan_in")
    return specs


def embed_tokens(params, tokens: torch.Tensor, cfg):
    """Token ids must lie in [0, vocab): torch indexing raises where
    ``jnp.take`` clamps.  A DTensor table is read on its local shards
    (``sharding.gather_rows``)."""
    table = params["embed"]
    if is_dtensor(table):
        from repro_torch.distributed.sharding import gather_rows
        rows = gather_rows(table, tokens)
    else:
        rows = table[tokens]
    x = cast(rows, cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return lconstraint(x, ("batch", "seq_r", "embed"))


def logits(params, x: torch.Tensor, cfg):
    """Final projection; always f32 for a stable softmax/loss.  The
    operands are rounded to the compute dtype and the product is taken in
    f32 (the reference's ``preferred_element_type=f32``): both are upcast,
    which is exact, and f32 matmuls run without TF32."""
    x = cast(x, cfg.compute_dtype).float()
    if cfg.tie_embeddings:
        w = cast(params["embed"], cfg.compute_dtype).float()
        out = einsum("bsd,vd->bsv", x, w)
    elif isinstance(params["unembed"], dict):   # w8 serving
        from repro_torch.core.quantize import w8_einsum
        out = w8_einsum("bsd,dv->bsv", x, params["unembed"]["q"],
                        params["unembed"]["s"], compute_dtype="float32")
    else:
        w = cast(params["unembed"], cfg.compute_dtype).float()
        out = einsum("bsd,dv->bsv", x, w)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = c * torch.tanh(out / c)
    return lconstraint(out, ("batch", "seq", "vocab"))
