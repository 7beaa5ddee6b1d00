"""Residual blocks: spec construction + apply, per block kind (counterpart
of ``repro.models.blocks``).

A "block" is one pre-norm residual pair: x += mixer(norm(x));
x += ffn(norm(x)).
The port has the attention kinds (``attn``, ``local_attn``) with the dense
gated MLP; RG-LRU, RWKV-6 and MoE raise ``NotImplementedError`` until their
slices, and so do encoder-decoder models, whose decoder blocks hold the
cross attention (``models.lm``; ROADMAP A14).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import BLOCK_ATTN, BLOCK_LOCAL
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.attention import KVCache
from repro_torch.layers.mlp import apply_mlp, mlp_specs
from repro_torch.layers.norms import apply_norm, norm_specs


def _check_ported(cfg, kind: str) -> None:
    if kind not in (BLOCK_ATTN, BLOCK_LOCAL):
        raise NotImplementedError(f"{kind!r} blocks are not ported yet "
                                  f"(ROADMAP A14)")
    if cfg.moe is not None:
        raise NotImplementedError("MoE feed-forward is not ported yet "
                                  "(ROADMAP A14)")


def block_specs(cfg, kind: str):
    _check_ported(cfg, kind)
    return {"norm1": norm_specs(cfg), "norm2": norm_specs(cfg),
            "attn": attn_lib.attention_specs(cfg), "mlp": mlp_specs(cfg)}


def block_cache_specs(cfg, kind: str, batch: int, seq_len: int):
    """Decode-time cache spec for one block."""
    _check_ported(cfg, kind)
    window = cfg.attention_window if kind == BLOCK_LOCAL else 0
    return {"kv": KVCache.init_specs(cfg, batch, seq_len, window=window)}


def _prime_cache(t, seq_len: int, window: int, cache_len: Optional[int]):
    """Lay out prefill K/V into decode-cache slots.

    Full attention: positions 0..S-1 land at slots 0..S-1; the cache is
    right-padded to ``cache_len`` so decode appends without wrapping.
    Sliding window: the cache is a ring of size min(cache_len, window);
    kept position p must land at slot p % ring — a roll by S when the
    prompt exceeds the ring (decode's ``slot = pos % ring`` contract)."""
    cache_len = cache_len or seq_len
    if window:
        ring = min(cache_len, window)
        kept = t[:, -min(seq_len, ring):]
        if kept.shape[1] < ring:
            pad = t.new_zeros((t.shape[0], ring - kept.shape[1],
                               *t.shape[2:]))
            kept = torch.cat([kept, pad], dim=1)
        if seq_len > ring:
            kept = torch.roll(kept, seq_len % ring, dims=1)
        return kept
    if cache_len > seq_len:
        pad = t.new_zeros((t.shape[0], cache_len - seq_len, *t.shape[2:]))
        return torch.cat([t, pad], dim=1)
    return t


def _to_cache(t, cfg):
    """Prefill K/V in the cache's dtype (an int8 cache on the fixed
    ``kv_cache_scale`` grid)."""
    return attn_lib.to_cache(t, cfg.resolved_kv_dtype, cfg.kv_cache_scale)


def apply_block_seq(params, x, cfg, kind: str, *, positions,
                    causal: bool = True, want_cache: bool = False,
                    cache_len: Optional[int] = None):
    """Returns (x, aux_loss, new_cache_or_None).

    want_cache=True (prefill) also produces the block's decode cache,
    sized ``cache_len`` (≥ prompt length) so decode can append."""
    _check_ported(cfg, kind)
    aux = torch.zeros((), device=x.device)
    new_cache: Optional[dict] = None
    h = apply_norm(params["norm1"], x, cfg)
    window = cfg.attention_window if kind == BLOCK_LOCAL else 0
    y, (k, v) = attn_lib.attention_layer(
        params["attn"], h, cfg, positions=positions, causal=causal,
        window=window)
    if want_cache:
        S = x.shape[1]
        new_cache = {"kv": KVCache(
            k=_prime_cache(_to_cache(k, cfg), S, window, cache_len),
            v=_prime_cache(_to_cache(v, cfg), S, window, cache_len))}
    x = x + y
    h = apply_norm(params["norm2"], x, cfg)
    x = x + apply_mlp(params["mlp"], h, cfg)
    return x, aux, new_cache


def apply_block_decode(params, x, cfg, kind: str, *, pos, cache: Any):
    """x: [B,1,D]; pos: [B].  Returns (x, new_cache); the KV cache is
    updated in place."""
    _check_ported(cfg, kind)
    new_cache = dict(cache)
    h = apply_norm(params["norm1"], x, cfg)
    window = cfg.attention_window if kind == BLOCK_LOCAL else 0
    y, kv = attn_lib.decode_attention_layer(
        params["attn"], h, cfg, cache=cache["kv"], pos=pos, window=window)
    new_cache["kv"] = kv
    x = x + y
    h = apply_norm(params["norm2"], x, cfg)
    return x + apply_mlp(params["mlp"], h, cfg), new_cache
