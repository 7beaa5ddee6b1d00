"""Residual blocks: spec construction + apply, per block kind (counterpart
of ``repro.models.blocks``).

A "block" is one pre-norm residual pair: x += mixer(norm(x));
x += ffn(norm(x)).  Kinds: ``attn`` and ``local_attn`` (self attention,
the latter over a sliding window with a ring-buffer cache), ``rglru``
(RecurrentGemma's recurrent block) and ``rwkv6`` (RWKV-6's time mix, with
the channel mix in place of the gated MLP).  The feed-forward is the
gated MLP, or the MoE layer where ``cfg.moe`` is set (its aux loss comes
back from ``apply_block_seq``).  An encoder-decoder's decoder blocks
(``cross=True``) hold a cross attention after the mixer: over the
encoder's output at prefill, whose projected K/V they keep as the
``cross_k`` / ``cross_v`` cache in the compute dtype, and over that cache
at decode.

Decode updates every cache in place: the attention layers write their
KV slot, and ``apply_block_decode`` ``copy_``s the recurrent states that
``rglru`` and ``rwkv6`` return (``conv``, ``h``; ``S``, ``x_att``,
``x_ffn``) into the cache tensors it was handed, which are views of the
serving pool.  The cross cache and the MoE layer write nothing.  The
reference returns new caches instead.

``apply_block_seq`` names the mixer's and the feed-forward's outputs
``attn_out`` and ``ffn_out`` (``checkpoint_name``), for the
``"save_block_outputs"`` remat policy of ``models.lm``.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from repro_torch.configs.base import (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_RGLRU,
                                      BLOCK_RWKV6)
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import rglru as rglru_lib
from repro_torch.layers import rwkv as rwkv_lib
from repro_torch.layers.attention import KVCache
from repro_torch.layers.common import ParamSpec, cast, torch_dtype
from repro_torch.layers.mlp import apply_mlp, mlp_specs
from repro_torch.layers.moe import apply_moe, moe_specs
from repro_torch.layers.norms import apply_norm, norm_specs
from repro_torch.layers.rglru import RGLRUState
from repro_torch.layers.rwkv import RWKVState

KINDS = (BLOCK_ATTN, BLOCK_LOCAL, BLOCK_RGLRU, BLOCK_RWKV6)


_NAMING = threading.local()


def checkpoint_name(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` through an ``aten.alias`` (a view, the same values) during
    which ``naming()`` returns ``name``: a remat policy reads it to save
    this tensor, as the reference's ``jax.ad_checkpoint.checkpoint_name``
    tags one."""
    _NAMING.name = name
    try:
        return torch.ops.aten.alias(t)
    finally:
        _NAMING.name = None


def naming() -> Optional[str]:
    """The name of the ``checkpoint_name`` call running on this thread."""
    return getattr(_NAMING, "name", None)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


def block_specs(cfg, kind: str, cross: bool = False):
    _check_kind(kind)
    specs = {"norm1": norm_specs(cfg), "norm2": norm_specs(cfg)}
    if kind in (BLOCK_ATTN, BLOCK_LOCAL):
        specs["attn"] = attn_lib.attention_specs(cfg)
    elif kind == BLOCK_RGLRU:
        specs["rglru"] = rglru_lib.rglru_specs(cfg)
    else:
        specs["timemix"] = rwkv_lib.timemix_specs(cfg)
    if kind == BLOCK_RWKV6:
        specs["channelmix"] = rwkv_lib.channelmix_specs(cfg)
    elif cfg.moe is not None:
        specs["moe"] = moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(cfg)
    if cross:               # an encoder-decoder's decoder block
        specs["cross_norm"] = norm_specs(cfg)
        specs["cross_attn"] = attn_lib.attention_specs(cfg, cross=True)
    return specs


def block_cache_specs(cfg, kind: str, batch: int, seq_len: int,
                      cross_len: int = 0):
    """Decode-time cache spec for one block; ``cross_len`` > 0 adds the
    cross attention's ``cross_k`` / ``cross_v`` in the compute dtype."""
    _check_kind(kind)
    if kind == BLOCK_RGLRU:
        cache = {"rglru": RGLRUState.init_specs(cfg, batch)}
    elif kind == BLOCK_RWKV6:
        cache = {"rwkv": RWKVState.init_specs(cfg, batch)}
    else:
        window = cfg.attention_window if kind == BLOCK_LOCAL else 0
        cache = {"kv": KVCache.init_specs(cfg, batch, seq_len,
                                          window=window)}
    if cross_len:
        shp = (batch, cross_len, cfg.num_kv_heads, cfg.head_dim)
        axes = ("batch", "cache_seq", "kv_heads", "qkv")
        for k in ("cross_k", "cross_v"):
            cache[k] = ParamSpec(shp, axes, dtype=cfg.compute_dtype,
                                 init="zeros")
    return cache


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


def _zero_rglru_state(cfg, batch: int, device) -> RGLRUState:
    return RGLRUState(
        conv=torch.zeros((batch, cfg.conv1d_width - 1, cfg.rnn_width),
                         dtype=torch_dtype(cfg.compute_dtype), device=device),
        h=torch.zeros((batch, cfg.rnn_width), device=device))


def apply_block_seq(params, x, cfg, kind: str, *, positions,
                    causal: bool = True, enc_out=None,
                    want_cache: bool = False,
                    cache_len: Optional[int] = None):
    """Returns (x, aux_loss, new_cache_or_None).

    want_cache=True (prefill) also produces the block's decode cache,
    sized ``cache_len`` (≥ prompt length) so decode can append; a
    recurrent block's cache is its state after the last token.
    ``enc_out`` (an encoder-decoder's encoder output) adds the cross
    attention after the mixer."""
    _check_kind(kind)
    aux = torch.zeros((), device=x.device)
    new_cache: Optional[dict] = None
    h = apply_norm(params["norm1"], x, cfg)
    if kind in (BLOCK_ATTN, BLOCK_LOCAL):
        window = cfg.attention_window if kind == BLOCK_LOCAL else 0
        y, (k, v) = attn_lib.attention_layer(
            params["attn"], h, cfg, positions=positions, causal=causal,
            window=window)
        if want_cache:
            S = x.shape[1]
            new_cache = {"kv": KVCache(
                k=_prime_cache(_to_cache(k, cfg), S, window, cache_len),
                v=_prime_cache(_to_cache(v, cfg), S, window, cache_len))}
    elif kind == BLOCK_RGLRU:
        state = (_zero_rglru_state(cfg, x.shape[0], x.device) if want_cache
                 else None)
        y, st = rglru_lib.apply_rglru(params["rglru"], h, cfg, state=state)
        if want_cache:
            new_cache = {"rglru": st}
    else:
        y, (S_fin, x_last) = rwkv_lib.apply_timemix(
            params["timemix"], h, cfg, chunked=True)
        if want_cache:
            new_cache = {"rwkv": RWKVState(S=S_fin, x_att=x_last,
                                           x_ffn=torch.zeros_like(x_last))}
    x = x + checkpoint_name(y, "attn_out")

    if enc_out is not None:
        h = apply_norm(params["cross_norm"], x, cfg)
        y, (ck, cv) = attn_lib.attention_layer(
            params["cross_attn"], h, cfg, positions=None, kv=enc_out)
        x = x + y
        if want_cache:
            new_cache["cross_k"] = cast(ck, cfg.compute_dtype)
            new_cache["cross_v"] = cast(cv, cfg.compute_dtype)

    h = apply_norm(params["norm2"], x, cfg)
    if kind == BLOCK_RWKV6:
        y, xl = rwkv_lib.apply_channelmix(params["channelmix"], h, cfg)
        if want_cache:
            new_cache["rwkv"] = new_cache["rwkv"]._replace(
                x_ffn=cast(xl, cfg.compute_dtype))
    elif cfg.moe is not None:
        y, aux = apply_moe(params["moe"], h, cfg)
    else:
        y = apply_mlp(params["mlp"], h, cfg)
    return x + checkpoint_name(y, "ffn_out"), aux, new_cache


def apply_block_decode(params, x, cfg, kind: str, *, pos, cache: Any):
    """x: [B,1,D]; pos: [B].  Returns (x, cache); the cache's tensors are
    updated in place (see the module note)."""
    _check_kind(kind)
    h = apply_norm(params["norm1"], x, cfg)
    if kind in (BLOCK_ATTN, BLOCK_LOCAL):
        window = cfg.attention_window if kind == BLOCK_LOCAL else 0
        y, _ = attn_lib.decode_attention_layer(
            params["attn"], h, cfg, cache=cache["kv"], pos=pos, window=window)
    elif kind == BLOCK_RGLRU:
        st = cache["rglru"]
        y, new = rglru_lib.decode_rglru(params["rglru"], h, cfg, state=st)
        st.conv.copy_(new.conv)
        st.h.copy_(new.h)
    else:
        st = cache["rwkv"]
        y, (S_fin, x_last) = rwkv_lib.apply_timemix(
            params["timemix"], h, cfg, state=st, chunked=False)
        st.S.copy_(S_fin)
        st.x_att.copy_(x_last)
    x = x + y

    if "cross_k" in cache:
        h = apply_norm(params["cross_norm"], x, cfg)
        y, _ = attn_lib.decode_attention_layer(
            params["cross_attn"], h, cfg, cache=None, pos=pos,
            cross_kv=(cache["cross_k"], cache["cross_v"]))
        x = x + y

    h = apply_norm(params["norm2"], x, cfg)
    if kind == BLOCK_RWKV6:
        st = cache["rwkv"]
        y, xl = rwkv_lib.apply_channelmix(params["channelmix"], h, cfg,
                                          state_x_last=st.x_ffn)
        st.x_ffn.copy_(xl)
    elif cfg.moe is not None:
        y, _ = apply_moe(params["moe"], h, cfg)
    else:
        y = apply_mlp(params["mlp"], h, cfg)
    return x + y, cache
