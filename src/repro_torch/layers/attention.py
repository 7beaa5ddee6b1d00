"""Self attention: GQA, RoPE, three prefill implementations and one-token
decode against a KV cache (counterpart of ``repro.layers.attention``).

``attention_layer`` picks by ``cfg.attn_impl``: "dense" materializes the
scores, "flash" runs the ``flash_attention`` kernel (windowed attention
and a ``q_offset`` go to the chunked path, as in the reference), and
"chunked" is the reference's flash-style two-level loop in plain torch,
skipping KV chunks that are wholly masked.

The decode cache is written in place (the reference returns updated
arrays): a step changes one slot per row and copying the whole cache
would cost a full cache write per layer and step.  An int8 cache
(``kv_cache_dtype="int8"``) holds K/V on a fixed ``kv_cache_scale`` grid
and runs the paper's 8-bit datapath on the cache read.  Cross attention
waits on the encoder-decoder slice (ROADMAP A14), so the reference's
``kv`` and ``cross_kv`` arguments are not taken.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.quantize import quantize_symmetric
from repro_torch.layers.common import ParamSpec, cast, dense, lconstraint
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
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 512, q_offset: int = 0,
                      softcap: float = 0.0):
    """q: [B,Sq,H,D]; k/v: [B,Sk,H,D] (already broadcast to H heads).

    Returns [B,Sq,H,D].  ``window`` > 0 restricts each query to the last
    ``window`` keys (inclusive of itself).  ``q_offset`` is the absolute
    position of q[0] relative to k[0].  The chunk is halved until it
    divides both lengths, as in the reference."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    c = min(chunk, Sq, Sk)
    while Sq % c or Sk % c:
        c //= 2
    scale = 1.0 / math.sqrt(D)
    outs = []
    for i in range(Sq // c):
        q_i = q[:, i * c:(i + 1) * c].float() * scale             # [B,c,H,D]
        q_lo = q_offset + i * c
        qpos = q_lo + torch.arange(c, device=q.device)
        m = torch.full((B, H, c), NEG_INF, device=q.device)
        l = torch.zeros((B, H, c), device=q.device)
        acc = torch.zeros((B, H, c, D), device=q.device)
        for j in range(Sk // c):
            kpos = j * c + torch.arange(c, device=q.device)
            # skip wholly masked chunks: future ones, and ones that fell
            # out of the window
            if causal and j * c > q_lo + c - 1:
                continue
            if window > 0 and (j + 1) * c - 1 < q_lo - (window - 1):
                continue
            k_j = k[:, j * c:(j + 1) * c].float()
            v_j = v[:, j * c:(j + 1) * c].float()
            scores = torch.einsum("bqhd,bkhd->bhqk", q_i, k_j)
            if softcap:
                scores = softcap * torch.tanh(scores / softcap)
            scores = scores.masked_fill(~_mask(qpos, kpos, causal, window),
                                        NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = alpha * l + p.sum(dim=-1)
            acc = alpha[..., None] * acc + torch.einsum("bhqk,bkhd->bhqd",
                                                        p, v_j)
            m = m_new
        out_i = acc / torch.clamp(l, min=1e-30)[..., None]         # [B,H,c,D]
        outs.append(out_i.transpose(1, 2))                         # [B,c,H,D]
    return torch.cat(outs, dim=1).to(q.dtype)


def dense_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, softcap: float = 0.0):
    """Materialized-scores oracle (tests / tiny shapes only)."""
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    scores = scores.masked_fill(~_mask(qpos, kpos, causal, window), NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


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
    return torch.einsum(subscripts, a.to(torch.float32),
                        b.to(torch.float32))


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


def _broadcast_kv(t, num_heads: int):
    """[B,S,KV,D] → [B,S,H,D] by repeating each KV head H/KV times."""
    B, S, KV, D = t.shape
    g = num_heads // KV
    t = t[:, :, :, None, :].expand(B, S, KV, g, D).reshape(B, S, KV * g, D)
    return lconstraint(t, ("batch", "seq", "heads", "head_dim"))


def attention_layer(params, x, cfg, *, positions, causal=True, window=0):
    """Full self attention over a sequence (train / prefill).

    Returns (out, (k, v)) — projected k/v for cache priming."""
    q, k, v = _project_qkv(params, x, cfg, positions)
    kf = _broadcast_kv(k, cfg.num_heads)
    vf = _broadcast_kv(v, cfg.num_heads)
    if cfg.attn_impl == "dense":
        out = dense_attention(q, kf, vf, causal=causal, window=window)
    elif cfg.attn_impl == "flash" and window == 0:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, kf, vf, causal=causal,
                                   block_q=cfg.attn_chunk,
                                   block_k=cfg.attn_chunk)
    else:
        out = chunked_attention(q, kf, vf, causal=causal, window=window,
                                chunk=cfg.attn_chunk)
    out = lconstraint(out, ("batch", "seq", "heads", "head_dim"))
    y = dense(params["wo"], out, "bshe,hed->bsd",
              compute_dtype=cfg.compute_dtype)
    return lconstraint(y, ("batch", "seq_r", "embed")), (k, v)


def decode_attention_layer(params, x, cfg, *, cache: KVCache, pos,
                           window=0):
    """One-token decode.  x: [B,1,D]; pos: [B] absolute positions.

    Grouped-einsum attention against the (possibly ring-buffered) cache;
    the KV tensors are never broadcast to full heads.  Writes the new K/V
    into ``cache`` in place and returns (out [B,1,D], cache).

    On an int8 cache both contractions run in the paper's 8-bit datapath,
    as the reference's: q quantized per tensor (over the whole
    [B, KV, G, D], idle slots included), q·k scaled by ``sq · kv_scale /
    sqrt(D)``, the masked softmax, p on a 1/127 grid (``clip(round(p ·
    127), 0, 127)``), p·v scaled by ``kv_scale / 127`` (the integer sums
    by ``_int8_contract``)."""
    B = x.shape[0]
    KV, D = cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KV

    q, k_new, v_new = _project_qkv(params, x, cfg, pos[:, None])
    S_cache = cache.k.shape[1]
    # ring-buffer slot (== pos when the cache is not a ring); torch's % on
    # integers floors like jnp's, so negative operands below wrap the same
    slot = pos % S_cache                                          # [B]
    bidx = torch.arange(B, device=x.device)
    int8_cache = cache.k.dtype == torch.int8
    kv_scale = cfg.kv_cache_scale
    cache.k[bidx, slot] = to_cache(k_new[:, 0], cache.k.dtype, kv_scale)
    cache.v[bidx, slot] = to_cache(v_new[:, 0], cache.v.dtype, kv_scale)

    qg = q.reshape(B, KV, G, D)
    if int8_cache:
        qq = quantize_symmetric(qg)
        acc = _int8_contract("bkgd,bskd->bkgs", qq.values, cache.k)
        scores = acc * (qq.scale * kv_scale) / math.sqrt(D)
    else:
        scores = torch.einsum("bkgd,bskd->bkgs", qg.float(),
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
        out = torch.einsum("bkgs,bskd->bkgd", p, cache.v.float())
    out = cast(out, cfg.compute_dtype).reshape(B, 1, cfg.num_heads, D)
    y = dense(params["wo"], out, "bshe,hed->bsd",
              compute_dtype=cfg.compute_dtype)
    return y, cache
