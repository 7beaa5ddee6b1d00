"""Decoder-only LM assembly (counterpart of ``repro.models.lm``): dense,
hybrid (RG-LRU + local attention) and attention-free (RWKV-6) stacks, by
the config's layer pattern.

The parameter and cache trees keep the reference's layout: the layers of
each pattern group stacked under ``blocks`` with a leading ``stack``
dimension, remainder layers under ``tail``.  Where the reference scans
over the stacked groups, the port loops over them in Python.  Decode
updates the cache in place: ``_index`` hands each block views of the
stacked pool, the attention layers write their KV slot into them and the
recurrent blocks ``copy_`` their new states into them
(``blocks.apply_block_decode``), so ``decode_step`` returns the cache it
was given.  Encoder-decoder and VLM models wait on later slices (ROADMAP
A14).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.common import cast, stack_specs, tree_map
from repro_torch.layers.embedding import embed_tokens, embedding_specs, logits
from repro_torch.layers.norms import apply_norm, norm_specs
from repro_torch.models.blocks import (apply_block_decode, apply_block_seq,
                                       block_cache_specs, block_specs)

PyTree = Any

# leaves that the reference casts to the compute dtype before every use
# (a GEMM, or the RG-LRU's conv taps); the RG-LRU gates, the RWKV lerps,
# decays, bonus and group norm read theirs in f32 and are not listed
_MATMUL_WEIGHTS = ("embed", "unembed", "wq", "wk", "wv", "wo", "wi_gate",
                   "wi_up", "w_gate", "w_rnn_in", "w_out", "conv_w", "wr",
                   "wg")


def _check_decoder(cfg: ArchConfig) -> None:
    if cfg.kind != "decoder":
        raise NotImplementedError(f"{cfg.kind} models are not ported yet "
                                  f"(ROADMAP A14)")


def _index(tree: PyTree, g: int) -> PyTree:
    """Group ``g`` of a stacked tree (views: writes reach the stack); a w8
    weight's per-layer scale ``s`` [G, 1, ..., N] is sliced with its
    ``q``."""
    return tree_map(lambda t: t[g], tree)


def param_specs(cfg: ArchConfig) -> PyTree:
    _check_decoder(cfg)
    specs: Dict[str, Any] = {
        "embedding": embedding_specs(cfg),
        "final_norm": norm_specs(cfg),
    }
    group = {f"b{i}": block_specs(cfg, k)
             for i, k in enumerate(cfg.layer_pattern)}
    specs["blocks"] = stack_specs(group, cfg.num_groups_scan)
    if cfg.tail_blocks:
        specs["tail"] = {f"b{i}": block_specs(cfg, k)
                         for i, k in enumerate(cfg.tail_blocks)}
    return specs


def cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> PyTree:
    """Decode cache tree (ParamSpecs) matching the stacked structure."""
    _check_decoder(cfg)
    group = {f"b{i}": block_cache_specs(cfg, k, batch, seq_len)
             for i, k in enumerate(cfg.layer_pattern)}
    out = {"blocks": stack_specs(group, cfg.num_groups_scan)}
    if cfg.tail_blocks:
        out["tail"] = {f"b{i}": block_cache_specs(cfg, k, batch, seq_len)
                       for i, k in enumerate(cfg.tail_blocks)}
    return out


def compute_params(params: PyTree, cfg: ArchConfig) -> PyTree:
    """The parameter tree with every matmul weight cast to the compute
    dtype once.  The reference casts them on every call; the values that
    reach the matmuls are the same, so serving casts once at load.  Norm
    scales stay as they are: they are read in f32.  A w8 weight's
    {"q": int8, "s": f32} dict stays as it is too (its GEMM reads int8)."""
    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return cast(tree, cfg.compute_dtype) if key in _MATMUL_WEIGHTS \
            else tree
    return walk(params)


def forward_seq(params, cfg: ArchConfig, *, tokens, want_cache: bool = False,
                cache_len: Optional[int] = None):
    """Full-sequence forward.  tokens: [B, S].
    Returns (hidden [B,S,D], aux_loss, cache_or_None)."""
    _check_decoder(cfg)
    x = embed_tokens(params["embedding"], tokens, cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), device=x.device)

    group_caches = []
    for g in range(cfg.num_groups_scan):
        gparams = _index(params["blocks"], g)
        caches = {}
        for i, kind in enumerate(cfg.layer_pattern):
            x, a, caches[f"b{i}"] = apply_block_seq(
                gparams[f"b{i}"], x, cfg, kind, positions=positions,
                causal=True, want_cache=want_cache, cache_len=cache_len)
            aux = aux + a
        group_caches.append(caches)

    tail_caches = {}
    for i, kind in enumerate(cfg.tail_blocks):
        x, a, tail_caches[f"b{i}"] = apply_block_seq(
            params["tail"][f"b{i}"], x, cfg, kind, positions=positions,
            causal=True, want_cache=want_cache, cache_len=cache_len)
        aux = aux + a

    x = apply_norm(params["final_norm"], x, cfg)
    cache = None
    if want_cache:
        cache = {"blocks": tree_map(lambda *ts: torch.stack(ts),
                                    *group_caches)}
        if cfg.tail_blocks:
            cache["tail"] = tail_caches
    return x, aux, cache


def forward_train(params, batch, cfg: ArchConfig):
    """batch → (logits [B,S,V] f32, aux_loss)."""
    x, aux, _ = forward_seq(params, cfg, tokens=batch["tokens"])
    return logits(params["embedding"], x, cfg), aux


def prefill(params, batch, cfg: ArchConfig, cache_len: Optional[int] = None):
    """Prefill: returns (last-token logits [B,V], cache).

    cache_len (≥ prompt length) sizes the decode cache so generation can
    append; defaults to the prompt length."""
    x, _, cache = forward_seq(params, cfg, tokens=batch["tokens"],
                              want_cache=True, cache_len=cache_len)
    lg = logits(params["embedding"], x[:, -1:], cfg)
    return lg[:, 0], cache


def decode_step(params, cfg: ArchConfig, *, token, pos, cache):
    """One serving step.  token: [B] int, pos: [B] int (absolute).
    Returns (logits [B,V] f32, cache); the cache is updated in place (KV
    slots and recurrent states alike; see the module note), so the
    blocks' returned caches are not collected."""
    _check_decoder(cfg)
    x = embed_tokens(params["embedding"], token[:, None], cfg)
    for g in range(cfg.num_groups_scan):
        gparams, gcache = _index(params["blocks"], g), _index(
            cache["blocks"], g)
        for i, kind in enumerate(cfg.layer_pattern):
            x, _ = apply_block_decode(gparams[f"b{i}"], x, cfg, kind,
                                      pos=pos, cache=gcache[f"b{i}"])
    for i, kind in enumerate(cfg.tail_blocks):
        x, _ = apply_block_decode(params["tail"][f"b{i}"], x, cfg, kind,
                                  pos=pos, cache=cache["tail"][f"b{i}"])
    x = apply_norm(params["final_norm"], x, cfg)
    return logits(params["embedding"], x, cfg)[:, 0], cache
