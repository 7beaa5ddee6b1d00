"""Self and cross attention: GQA, RoPE, three prefill implementations and
one-token decode against a KV cache (counterpart of
``repro.layers.attention``).

``attention_layer`` picks by ``cfg.attn_impl``: "dense" materializes the
scores, "flash" runs the ``flash_attention`` kernel (windowed attention
goes to the chunked path, as in the reference), and "chunked" is the
reference's flash-style two-level loop in plain torch, skipping KV chunks
that are wholly masked, run one key chunk at a time against all the
query chunks that see it.  On DTensors (a sharded step) "dense" and
"chunked" run on each rank's own batch rows and heads as plain tensors
(``_on_local_heads``); ``flash_attention`` refuses a DTensor.  Cross
attention (``kv=`` the encoder's output)
is full attention from the decoder's queries to the source's keys; under
"flash" it goes to the kernel too, as the reference's code routes it (its
config note promises the chunked path), so it runs where source and
target have one length and the kernel's shape check refuses it
elsewhere, where the reference's kernel fails as well.

The decode cache is written in place (the reference returns updated
arrays): a step changes one slot per row and copying the whole cache
would cost a full cache write per layer and step.  An int8 cache
(``kv_cache_dtype="int8"``) holds K/V on a fixed ``kv_cache_scale`` grid
and runs the paper's 8-bit datapath on the cache read.  The cross
attention's decode step reads the static ``cross_k`` / ``cross_v`` cache
that the prefill wrote and writes nothing.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.quantize import quantize_symmetric
from repro_torch.device import is_dtensor
from repro_torch.layers.common import (ParamSpec, cast, dense, einsum,
                                       lconstraint)
from repro_torch.layers.norms import apply_norm, rmsnorm_specs
from repro_torch.layers.rope import apply_rope

NEG_INF = -2.0e38


def attention_specs(cfg, cross: bool = False):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, dh), ("embed", "kv_heads", "qkv")),
        "wv": ParamSpec((d, kv, dh), ("embed", "kv_heads", "qkv")),
        "wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed"),
                        fan_in_axes=(0, 1)),
    }
    if cfg.qk_norm and not cross:
        specs["q_norm"] = rmsnorm_specs(dh)
        specs["k_norm"] = rmsnorm_specs(dh)
    return specs


def _mask(qpos, kpos, causal: bool, window: int):
    """Which keys at ``kpos`` [Sk] queries at ``qpos`` [..., Sq] see →
    bool [..., Sq, Sk]."""
    q = qpos[..., :, None]
    mask = torch.ones(q.shape[:-1] + kpos.shape, dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= q >= kpos
    if window > 0:
        mask &= kpos > q - window
    return mask


def _put(t, lo: int, hi: int, new):
    """``t`` with query chunks ``lo:hi`` (dim 1) replaced by ``new``."""
    if lo == 0 and hi == t.shape[1]:
        return new
    return torch.cat([t[:, :lo], new, t[:, hi:]], dim=1)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 512, q_offset: int = 0,
                      softcap: float = 0.0):
    """q: [B,Sq,H,D]; k/v: [B,Sk,H,D] (already broadcast to H heads).

    Returns [B,Sq,H,D].  ``window`` > 0 restricts each query to the last
    ``window`` keys (inclusive of itself).  ``q_offset`` is the absolute
    position of q[0] relative to k[0].  The chunk is halved until it
    divides both lengths, as in the reference.

    The reference's two-level loop (query chunks, then key chunks with an
    online softmax, skipping wholly masked pairs), run key chunk by key
    chunk: each key chunk meets every query chunk that sees any of it
    (a contiguous run) in one batched contraction.  Each query chunk
    still takes its key chunks in order with the same sums, and a layer
    issues its ops once a key chunk rather than once a chunk pair."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    c = min(chunk, Sq, Sk)
    while Sq % c or Sk % c:
        c //= 2
    n = Sq // c
    scale = 1.0 / math.sqrt(D)
    qc = (q.float() * scale).reshape(B, n, c, H, D)
    m = torch.full((B, n, H, c), NEG_INF, device=q.device)
    l = torch.zeros((B, n, H, c), device=q.device)
    acc = torch.zeros((B, n, H, c, D), device=q.device)
    ar = torch.arange(c, device=q.device)
    for j in range(Sk // c):
        # the query chunks that see key chunk j: not wholly in its past
        # (causal) nor wholly past the window
        live = [i for i in range(n)
                if not (causal and j * c > q_offset + i * c + c - 1)
                and not (window > 0 and (j + 1) * c - 1
                         < q_offset + i * c - (window - 1))]
        if not live:
            continue
        lo, hi = live[0], live[-1] + 1
        k_j = k[:, j * c:(j + 1) * c].float()
        v_j = v[:, j * c:(j + 1) * c].float()
        scores = einsum("bnqhd,bkhd->bnhqk", qc[:, lo:hi], k_j)
        if softcap:
            scores = softcap * torch.tanh(scores / softcap)
        if causal or window > 0:
            qpos = q_offset + lo * c + torch.arange(
                (hi - lo) * c, device=q.device).reshape(hi - lo, c)
            scores = scores.masked_fill(
                ~_mask(qpos, j * c + ar, causal, window)[None, :, None],
                NEG_INF)
        m_old = m[:, lo:hi]
        m_new = torch.maximum(m_old, scores.amax(dim=-1))
        alpha = torch.exp(m_old - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = _put(l, lo, hi, alpha * l[:, lo:hi] + p.sum(dim=-1))
        acc = _put(acc, lo, hi, alpha[..., None] * acc[:, lo:hi]
                   + einsum("bnhqk,bkhd->bnhqd", p, v_j))
        m = _put(m, lo, hi, m_new)
    out = acc / torch.clamp(l, min=1e-30)[..., None]         # [B,n,H,c,D]
    return out.transpose(2, 3).reshape(B, Sq, H, D).to(q.dtype)


def dense_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, softcap: float = 0.0):
    """Materialized-scores oracle (tests / tiny shapes only)."""
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    scores = einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    scores = scores.masked_fill(~_mask(qpos, kpos, causal, window), NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _on_local_heads(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)`` (an attention over [B, S, H, D]) of
    DTensors on each rank's own batch rows and heads as plain tensors:
    attention is independent per (row, head), so no sum crosses ranks.
    k and v take q's layout (its batch and head sharding, every other dim
    gathered); the output and the three gradients keep it.  DTensor's
    own rules would take each op of the chunk loop through sharding
    propagation on the host: 4096 chunk pairs a layer at 32k positions
    of full attention."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed.sharding import from_local
    mesh = q.device_mesh
    lay = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
           for p in q.placements]
    q_l, k_l, v_l = (t.redistribute(mesh, lay).to_local()
                     for t in (q, k, v))
    return from_local(attend(q_l, k_l, v_l, **kw), mesh, lay, q.shape)


class KVCache(NamedTuple):
    """Decode-time cache for one attention layer.  For sliding-window blocks
    the cache is a ring buffer of size ``window``."""
    k: torch.Tensor          # [B, S_cache, KV, D]
    v: torch.Tensor          # [B, S_cache, KV, D]

    @staticmethod
    def init_specs(cfg, batch: int, seq_len: int, window: int = 0):
        size = min(seq_len, window) if window > 0 else seq_len
        shp = (batch, size, cfg.num_kv_heads, cfg.head_dim)
        axes = ("batch", "cache_seq", "kv_heads", "qkv")
        dt = cfg.resolved_kv_dtype
        return KVCache(
            k=ParamSpec(shp, axes, dtype=dt, init="zeros"),
            v=ParamSpec(shp, axes, dtype=dt, init="zeros"),
        )


def to_cache(t: torch.Tensor, dtype, kv_scale: float) -> torch.Tensor:
    """K/V in the cache's dtype: on an int8 cache ``clip(round(t /
    kv_scale))`` (f32, round half to even), else a cast."""
    if dtype in (torch.int8, "int8"):
        return torch.round(t.to(torch.float32) / kv_scale).clamp(
            -128, 127).to(torch.int8)
    return cast(t, dtype)


def write_slots(cache: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[b, slot[b]] = new[b]`` in place for every row b (cache
    [B, S, KV, D], new [B, KV, D], slot [B]).  A DTensor cache (batch and
    ``cache_seq`` sharded) is written on its local shard: ``new`` placed
    as the cache is on its own dims, and each rank writes its block's
    batch rows, the new row where the slot falls in its block of
    positions and the row's own old value elsewhere (no mask selects the
    rows, so no shape depends on the data: the dry run's fake tensors
    take it).  DTensor has no in-place ``index_put_`` that keeps a
    sharded layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache, DTensor):
        cache[torch.arange(slot.shape[0], device=slot.device), slot] = new
        return
    from repro_torch.distributed.sharding import local_block
    mesh = cache.device_mesh
    shape, off = local_block(cache)
    # the cache's dims (B, S, KV, D) are new's (B, -, KV, D)
    new = new.redistribute(mesh, [
        Replicate() if not p.is_shard() or p.dim == 1 else
        Shard(p.dim - (p.dim > 1)) for p in cache.placements]).to_local()
    b = torch.arange(shape[0], device=slot.device)
    s = slot[off[0]:off[0] + shape[0]] - off[1]
    mine = (s >= 0) & (s < shape[1])
    s = s.clamp(0, shape[1] - 1)
    local = cache.to_local()
    local[b, s] = torch.where(mine[:, None, None], new, local[b, s])


def _int8_contract(subscripts: str, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """The int32 value of an einsum of two int8 operands, as f32.

    PyTorch has no int8 einsum with int32 accumulation on CUDA, so both
    operands are upcast to f32 and contracted there.  That is exact, in
    any summation order, while every partial sum stays under 2^24: each
    product and partial sum is then an integer that f32 holds.  The decode
    layer's two contractions do:
      q·k: |Σ_d qq·k| ≤ 128 · 128 · D ≤ 2^22 at D = 256;
      p·v: pq_s = round(127 p_s) ≤ 127 p_s + 1/2 and pq_s is non-zero only
        where p_s ≥ 1/254, so with Σ_s p_s = 1 at most 254 slots count and
        Σ_s pq_s ≤ 127 + 254/2 = 254: |Σ_s pq·v| ≤ 254 · 128 = 32,512.
    TF32 would round the operands' products, so it must be off on the
    card (PyTorch's default)."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the int8 KV cache's contractions are exact only "
                           "with TF32 off "
                           "(torch.backends.cuda.matmul.allow_tf32)")
    return einsum(subscripts, a.to(torch.float32), b.to(torch.float32))


def _project_qkv(params, x, cfg, positions):
    q = dense(params["wq"], x, "bsd,dhe->bshe", backend="xla",
              compute_dtype=cfg.compute_dtype)
    k = dense(params["wk"], x, "bsd,dke->bske", backend="xla",
              compute_dtype=cfg.compute_dtype)
    v = dense(params["wv"], x, "bsd,dke->bske", backend="xla",
              compute_dtype=cfg.compute_dtype)
    q = lconstraint(q, ("batch", "seq", "heads", "head_dim"))
    k = lconstraint(k, ("batch", "seq", "kv_heads", "qkv"))
    v = lconstraint(v, ("batch", "seq", "kv_heads", "qkv"))
    if cfg.qk_norm:
        q = apply_norm(params["q_norm"], q, cfg)
        k = apply_norm(params["k_norm"], k, cfg)
    if cfg.use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _reshape(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t.reshape(*shape)``; a DTensor keeps a dim's sharding only where
    that dim and all before it are unchanged, and is replicated on the
    other mesh dims first (DTensor cannot split or merge a sharded head
    dim across uneven groups, e.g. 8 heads over 4 ranks into [2, 4])."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t.reshape(*shape)
    same = 0
    while (same < min(t.dim(), len(shape))
           and t.shape[same] == shape[same]):
        same += 1
    keep = [p if not p.is_shard() or p.dim < same else Replicate()
            for p in t.placements]
    if keep != list(t.placements):
        t = t.redistribute(t.device_mesh, keep)
    return t.reshape(*shape)


def _broadcast_kv(t, num_heads: int):
    """[B,S,KV,D] → [B,S,H,D] by repeating each KV head H/KV times."""
    B, S, KV, D = t.shape
    g = num_heads // KV
    t = t[:, :, :, None, :].expand(B, S, KV, g, D).reshape(B, S, KV * g, D)
    return lconstraint(t, ("batch", "seq", "heads", "head_dim"))


def attention_layer(params, x, cfg, *, positions, causal=True, window=0,
                    kv=None):
    """Full attention over a sequence (train / prefill / encoder).

    ``kv``: the source hidden states [B, S_src, D] for cross attention
    (q from ``x``, k and v projected from the source, full attention, no
    q_norm / k_norm; RoPE on q only where ``positions`` is given).
    Returns (out, (k, v)) — projected k/v for cache priming."""
    if kv is None:
        q, k, v = _project_qkv(params, x, cfg, positions)
    else:
        q = dense(params["wq"], x, "bsd,dhe->bshe",
                  compute_dtype=cfg.compute_dtype)
        if cfg.use_rope and positions is not None:
            q = apply_rope(q, positions, cfg.rope_theta)
        k = dense(params["wk"], kv, "bsd,dke->bske",
                  compute_dtype=cfg.compute_dtype)
        v = dense(params["wv"], kv, "bsd,dke->bske",
                  compute_dtype=cfg.compute_dtype)
        causal = False
    kf = _broadcast_kv(k, cfg.num_heads)
    vf = _broadcast_kv(v, cfg.num_heads)
    if cfg.attn_impl == "flash" and window == 0:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, kf, vf, causal=causal,
                                   block_q=cfg.attn_chunk,
                                   block_k=cfg.attn_chunk)
    else:
        attend, kw = ((dense_attention, {}) if cfg.attn_impl == "dense"
                      else (chunked_attention, {"chunk": cfg.attn_chunk}))
        if is_dtensor(q):
            attend = functools.partial(_on_local_heads, attend)
        out = attend(q, kf, vf, causal=causal, window=window, **kw)
    out = lconstraint(out, ("batch", "seq", "heads", "head_dim"))
    y = dense(params["wo"], out, "bshe,hed->bsd",
              compute_dtype=cfg.compute_dtype)
    return lconstraint(y, ("batch", "seq_r", "embed")), (k, v)


def decode_attention_layer(params, x, cfg, *, cache: KVCache, pos,
                           window=0, cross_kv=None):
    """One-token decode.  x: [B,1,D]; pos: [B] absolute positions.

    Grouped-einsum attention against the (possibly ring-buffered) cache;
    the KV tensors are never broadcast to full heads.  Writes the new K/V
    into ``cache`` in place and returns (out [B,1,D], cache).

    ``cross_kv`` = (k, v) [B, S_src, KV, D]: cross attention against that
    static cache in f32, every source position valid; ``cache`` is not
    read and is returned as given.

    On an int8 cache both contractions run in the paper's 8-bit datapath,
    as the reference's: q quantized per tensor (over the whole
    [B, KV, G, D], idle slots included), q·k scaled by ``sq · kv_scale /
    sqrt(D)``, the masked softmax, p on a 1/127 grid (``clip(round(p ·
    127), 0, 127)``), p·v scaled by ``kv_scale / 127`` (the integer sums
    by ``_int8_contract``)."""
    B = x.shape[0]
    KV, D = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV

    if cross_kv is not None:
        q = dense(params["wq"], x, "bsd,dhe->bshe",
                  compute_dtype=cfg.compute_dtype)
        if cfg.use_rope:
            q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_all, v_all = cross_kv
        scores = einsum("bkgd,bskd->bkgs", _reshape(q, B, KV, G, D).float(),
                        k_all.float()) / math.sqrt(D)
        p = torch.softmax(scores, dim=-1)
        out = einsum("bkgs,bskd->bkgd", p, v_all.float())
        out = _reshape(cast(out, cfg.compute_dtype), B, 1, cfg.num_heads, D)
        return dense(params["wo"], out, "bshe,hed->bsd",
                     compute_dtype=cfg.compute_dtype), cache

    q, k_new, v_new = _project_qkv(params, x, cfg, pos[:, None])
    S_cache = cache.k.shape[1]
    # ring-buffer slot (== pos when the cache is not a ring); torch's % on
    # integers floors like jnp's, so negative operands below wrap the same
    slot = pos % S_cache                                          # [B]
    int8_cache = cache.k.dtype == torch.int8
    kv_scale = cfg.kv_cache_scale
    write_slots(cache.k, slot,
                to_cache(k_new[:, 0], cache.k.dtype, kv_scale))
    write_slots(cache.v, slot,
                to_cache(v_new[:, 0], cache.v.dtype, kv_scale))

    qg = _reshape(q, B, KV, G, D)
    if int8_cache:
        qq = quantize_symmetric(qg)
        acc = _int8_contract("bkgd,bskd->bkgs", qq.values, cache.k)
        scores = acc * (qq.scale * kv_scale) / math.sqrt(D)
    else:
        scores = einsum("bkgd,bskd->bkgs", qg.float(),
                        cache.k.float()) / math.sqrt(D)
    # a slot s holds absolute position p(s); valid if p(s) <= pos and
    # (window) p(s) > pos - window.  A ring filled past capacity is all
    # valid.
    slots = torch.arange(S_cache, device=x.device)
    abs_pos = pos[:, None] - ((pos[:, None] - slots[None, :]) % S_cache)
    valid = (abs_pos >= 0) & (abs_pos <= pos[:, None])
    if window > 0:
        valid &= abs_pos > pos[:, None] - window
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if int8_cache:
        pq = torch.round(p * 127.0).clamp(0, 127).to(torch.int8)
        acc = _int8_contract("bkgs,bskd->bkgd", pq, cache.v)
        out = acc * (kv_scale / 127.0)
    else:
        out = einsum("bkgs,bskd->bkgd", p, cache.v.float())
    out = _reshape(cast(out, cfg.compute_dtype), B, 1, cfg.num_heads, D)
    y = dense(params["wo"], out, "bshe,hed->bsd",
              compute_dtype=cfg.compute_dtype)
    return y, cache
