"""LM assembly (counterpart of ``repro.models.lm``): decoder-only stacks
(dense, MoE, hybrid RG-LRU + local attention, attention-free RWKV-6, by the
config's layer pattern), the VLM (a patch prefix through a stub vision
frontend) and the encoder-decoder (a stub audio frontend, an encoder and
cross attention).

The parameter and cache trees keep the reference's layout: the layers of
each pattern group stacked under ``blocks`` with a leading ``stack``
dimension, remainder layers under ``tail``, an encoder-decoder's encoder
layers stacked under ``encoder``.  Where the reference scans over the
stacked groups, the port loops over them in Python.  Decode updates the
cache in place: ``_index`` hands each block views of the stacked pool,
the attention layers write their KV slot into them and the recurrent
blocks ``copy_`` their new states into them (``blocks.apply_block_decode``),
so ``decode_step`` returns the cache it was given.  The sequence forward
takes each stacked leaf apart with one ``unbind(0)``, so its backward
stacks each leaf's gradient once.

Where autograd records the forward, ``cfg.remat_policy`` wraps each group
body and each encoder body in ``torch.utils.checkpoint`` (non-reentrant),
as the reference wraps its scan bodies in ``jax.checkpoint``:

* ``"none"``: no checkpoint, everything the backward reads is kept;
* ``"minimal"``: the outputs of dots without batch dimensions are saved
  (``aten.mm``, ``aten.addmm``, and ``aten.bmm`` of batch 1, which is how
  an einsum with no batch dimension runs), the rest is recomputed — the
  reference's ``dots_with_no_batch_dims_saveable``.  A GEMM on the
  ``matmul_ws`` kernel is no aten op and is recomputed, as the
  reference's ``pallas_call`` is;
* ``"save_block_outputs"``: the blocks' ``attn_out`` and ``ffn_out``
  (``blocks.checkpoint_name``) are saved;
* anything else (``"full"``): nothing is saved.

Recomputation changes no value.

The VLM's ``patches`` [B, P, frontend_dim] go through ``frontend_proj``
and are concatenated before the token embeddings, so the positions (and
the cache) count the patches first; ``forward_train`` slices them off
before the logits.  The encoder-decoder's ``frames`` [B, S_src,
frontend_dim] go through ``frontend_proj``, sinusoidal positions and
non-causal attention blocks; its decoder adds sinusoidal positions to the
token embeddings.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import BLOCK_ATTN, ArchConfig, ShapeConfig
from repro_torch.layers.common import (ParamSpec, cast, stack_specs,
                                       torch_dtype, tree_map)
from repro_torch.layers.embedding import embed_tokens, embedding_specs, logits
from repro_torch.layers.norms import apply_norm, norm_specs
from repro_torch.layers.rope import sinusoidal_positions
from repro_torch.models import blocks as blocks_lib
from repro_torch.models.blocks import (apply_block_decode, apply_block_seq,
                                       block_cache_specs, block_specs)

PyTree = Any

# leaves that the reference casts to the compute dtype before every use
# (a GEMM, or the RG-LRU's conv taps; the MoE's experts share the MLP's
# names); the RG-LRU gates, the RWKV lerps, decays, bonus and group norm
# and the MoE router read theirs in f32 and are not listed
_MATMUL_WEIGHTS = ("embed", "unembed", "wq", "wk", "wv", "wo", "wi_gate",
                   "wi_up", "w_gate", "w_rnn_in", "w_out", "conv_w", "wr",
                   "wg", "frontend_proj")


def _index(tree: PyTree, g: int) -> PyTree:
    """Group ``g`` of a stacked tree (views: writes reach the stack); a w8
    weight's per-layer scale ``s`` [G, 1, ..., N] is sliced with its
    ``q``."""
    return tree_map(lambda t: t[g], tree)


def _unbind(tree: PyTree, n: int) -> List[PyTree]:
    """The ``n`` groups of a stacked tree, each leaf taken apart by one
    ``unbind(0)``."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p: p[g], parts) for g in range(n)]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``"minimal"``: save the outputs of dots without batch dimensions."""
    if op in _DOTS or (op is torch.ops.aten.bmm.default
                       and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_block_outputs(ctx, op, *args, **kwargs):
    """``"save_block_outputs"``: save the tensors the blocks name
    ``attn_out`` and ``ffn_out``."""
    if op is torch.ops.aten.alias.default and blocks_lib.naming() in (
            "attn_out", "ffn_out"):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"minimal": _save_dots,
             "save_block_outputs": _save_block_outputs}


def _remat(fn, cfg: ArchConfig):
    """``fn`` under the config's remat policy (see the module note); as
    it is where autograd does not record."""
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return fn
    policy = _POLICIES.get(cfg.remat_policy)
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def param_specs(cfg: ArchConfig) -> PyTree:
    cross = cfg.kind == "encdec"
    specs: Dict[str, Any] = {
        "embedding": embedding_specs(cfg),
        "final_norm": norm_specs(cfg),
    }
    group = {f"b{i}": block_specs(cfg, k, cross=cross)
             for i, k in enumerate(cfg.layer_pattern)}
    specs["blocks"] = stack_specs(group, cfg.num_groups_scan)
    if cfg.tail_blocks:
        specs["tail"] = {f"b{i}": block_specs(cfg, k, cross=cross)
                         for i, k in enumerate(cfg.tail_blocks)}
    if cross:
        specs["encoder"] = {
            "blocks": stack_specs({"b0": block_specs(cfg, BLOCK_ATTN)},
                                  cfg.encoder_layers),
            "final_norm": norm_specs(cfg),
        }
    if cfg.frontend is not None and cfg.frontend_dim:
        specs["frontend_proj"] = ParamSpec(
            (cfg.frontend_dim, cfg.d_model), (None, "embed"))
    return specs


def cache_specs(cfg: ArchConfig, batch: int, seq_len: int) -> PyTree:
    """Decode cache tree (ParamSpecs) matching the stacked structure; an
    encoder-decoder's holds a ``seq_len``-long cross cache a layer, as the
    reference's does."""
    cross_len = seq_len if cfg.kind == "encdec" else 0
    group = {f"b{i}": block_cache_specs(cfg, k, batch, seq_len, cross_len)
             for i, k in enumerate(cfg.layer_pattern)}
    out = {"blocks": stack_specs(group, cfg.num_groups_scan)}
    if cfg.tail_blocks:
        out["tail"] = {f"b{i}": block_cache_specs(cfg, k, batch, seq_len,
                                                  cross_len)
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


def _frontend(params, t, cfg: ArchConfig):
    """Stub-frontend embeddings [B, S, frontend_dim] → [B, S, d_model],
    in the compute dtype."""
    return torch.einsum("bsf,fd->bsd", cast(t, cfg.compute_dtype),
                        cast(params["frontend_proj"], cfg.compute_dtype))


def _encoder_forward(params, frames, cfg: ArchConfig):
    """The encoder: frames [B, S, frontend_dim] → [B, S, D] through the
    frontend projection, sinusoidal positions and non-causal attention
    blocks."""
    x = _frontend(params, frames, cfg)
    B, S = x.shape[:2]
    pos = torch.arange(S, device=x.device).expand(B, S)
    x = x + cast(sinusoidal_positions(pos, cfg.d_model), x.dtype)
    enc = params["encoder"]

    def body(h, gparams):
        return apply_block_seq(gparams["b0"], h, cfg, BLOCK_ATTN,
                               positions=pos, causal=False)[0]

    body = _remat(body, cfg)
    for gparams in _unbind(enc["blocks"], cfg.encoder_layers):
        x = body(x, gparams)
    return apply_norm(enc["final_norm"], x, cfg)


def forward_seq(params, cfg: ArchConfig, *, tokens, patches=None,
                frames=None, want_cache: bool = False,
                cache_len: Optional[int] = None):
    """Full-sequence forward.  tokens: [B, S_text]; a VLM's ``patches``
    [B, P, frontend_dim] are prepended; an encoder-decoder's ``frames``
    [B, S_src, frontend_dim] go through the encoder and cross attention.
    Returns (hidden [B,S,D], aux_loss, cache_or_None)."""
    x = embed_tokens(params["embedding"], tokens, cfg)
    if cfg.kind == "vlm" and patches is not None:
        x = torch.cat([_frontend(params, patches, cfg), x], dim=1)
    enc_out = (_encoder_forward(params, frames, cfg)
               if cfg.kind == "encdec" else None)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.kind == "encdec":
        x = x + cast(sinusoidal_positions(positions, cfg.d_model), x.dtype)
    aux = torch.zeros((), device=x.device)

    def group(h, aux, gparams):
        caches = {}
        for i, kind in enumerate(cfg.layer_pattern):
            h, a, caches[f"b{i}"] = apply_block_seq(
                gparams[f"b{i}"], h, cfg, kind, positions=positions,
                causal=True, enc_out=enc_out, want_cache=want_cache,
                cache_len=cache_len)
            aux = aux + a
        return h, aux, caches

    group = _remat(group, cfg)
    group_caches = []
    for gparams in _unbind(params["blocks"], cfg.num_groups_scan):
        x, aux, caches = group(x, aux, gparams)
        group_caches.append(caches)

    tail_caches = {}
    for i, kind in enumerate(cfg.tail_blocks):
        x, a, tail_caches[f"b{i}"] = apply_block_seq(
            params["tail"][f"b{i}"], x, cfg, kind, positions=positions,
            causal=True, enc_out=enc_out, want_cache=want_cache,
            cache_len=cache_len)
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
    """batch → (logits [B,S_text,V] f32, aux_loss).  A VLM's patch prefix
    carries no loss: its hidden states are sliced off before the vocab
    projection."""
    x, aux, _ = forward_seq(params, cfg, tokens=batch["tokens"],
                            patches=batch.get("patches"),
                            frames=batch.get("frames"))
    if cfg.kind == "vlm" and batch.get("patches") is not None:
        x = x[:, batch["patches"].shape[1]:]
    return logits(params["embedding"], x, cfg), aux


def prefill(params, batch, cfg: ArchConfig, cache_len: Optional[int] = None):
    """Prefill: returns (last-token logits [B,V], cache).

    cache_len (≥ prompt length, patches included) sizes the decode cache
    so generation can append; defaults to the prompt length."""
    x, _, cache = forward_seq(params, cfg, tokens=batch["tokens"],
                              patches=batch.get("patches"),
                              frames=batch.get("frames"), want_cache=True,
                              cache_len=cache_len)
    lg = logits(params["embedding"], x[:, -1:], cfg)
    return lg[:, 0], cache


def decode_step(params, cfg: ArchConfig, *, token, pos, cache):
    """One serving step.  token: [B] int, pos: [B] int (absolute).
    Returns (logits [B,V] f32, cache); the cache is updated in place (KV
    slots and recurrent states alike; see the module note), so the
    blocks' returned caches are not collected.  A VLM's ``pos`` counts its
    patch prefix."""
    x = embed_tokens(params["embedding"], token[:, None], cfg)
    if cfg.kind == "encdec":
        x = x + cast(sinusoidal_positions(pos[:, None], cfg.d_model), x.dtype)
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


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this (arch × shape)
    cell, with the reference's keys, shapes and dtypes (the dry run's
    contract):

    train:   {"tokens", "labels" [, "patches"/"frames"]}
    prefill: {"tokens" [, "patches"/"frames"]}
    decode:  {"token", "pos"}   (the cache comes from cache_specs)
    """
    B, S = shape.global_batch, shape.seq_len
    cdt = torch_dtype(cfg.compute_dtype)

    def sd(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"token": sd((B,)), "pos": sd((B,))}
    specs: Dict[str, Any] = {}
    text = S
    if cfg.kind == "vlm":
        P = min(cfg.frontend_tokens, S // 4)
        specs["patches"] = sd((B, P, cfg.frontend_dim), cdt)
        text = S - P
    elif cfg.kind == "encdec":
        specs["frames"] = sd((B, S, cfg.frontend_dim), cdt)
    specs["tokens"] = sd((B, text))
    if shape.kind == "train":
        specs["labels"] = sd((B, text))
    return specs
