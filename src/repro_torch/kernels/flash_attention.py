"""Causal (or full) online-softmax attention as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention
.flash_attention``: q, k, v ``[B,S,H,D]`` (k/v already broadcast to H heads)
→ ``[B,S,H,D]`` in q's dtype, bf16 or f32, self-attention only.  The CUDA
source is ``csrc/flash_attention.cu`` (64×64 tiles, any S, D ≤ 128 and a
multiple of 4; its note says what bounds it on the H100).  ``block_q`` and
``block_k`` keep the reference's signature and are ignored: the TPU's
512-row blocks do not fit a Hopper block's shared memory, so the tiles are
the kernel's own.

On a CUDA tensor ``flash_attention`` launches the kernel and counts the
launch in ``flash_attention.launches``; on a CPU tensor it runs
``flash_attention_plain``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention needs q, k, v of one shape "
                         f"[B,S,H,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bfloat16 or float32 q, k, v "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_plain(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the materialized-scores softmax of
    ``dense_attention`` in f32, cast to q's dtype."""
    _check(q, k, v)
    s = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    b, s, h, d = q.shape
    if d % 4 or not 4 <= d <= 128:
        raise ValueError(f"the flash_attention kernel takes a head dim that "
                         f"is a multiple of 4 up to 128, got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check("flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        int(causal), 1.0 / math.sqrt(d), _DTYPES[q.dtype], stream))
    return out


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """q, k, v: [B,S,H,D] → [B,S,H,D] in q's dtype.  A CUDA tensor
    launches the kernel, a CPU tensor runs the plain version; ``block_q``
    and ``block_k`` are accepted and ignored (see the module note)."""
    del block_q, block_k
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if not q.is_cuda:
        raise ValueError(f"flash_attention runs on a CUDA or CPU tensor, "
                         f"got {q.device}")
    out = _launch(q, k, v, causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
