"""Causal (or full) online-softmax attention as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention
.flash_attention``: q, k, v ``[B,S,H,D]`` (k/v already broadcast to H heads)
→ ``[B,S,H,D]`` in q's dtype, bf16 or f32, self-attention only, any S.  The
CUDA source, ``csrc/flash_attention.cu``, holds two variants (its note says
more); ``kernel_variant`` picks one:

* bf16, D in {16, 32, 64, 128, 256}: the tensor-core kernel ("wgmma").
  One block per (b·h, 128 q rows): two consumer warpgroups run both
  products as ``wgmma`` from a ring of K/V tiles that one producer warp
  (a producer warpgroup at D = 256) loads with TMA.
  It is bound by operations (4·D flops per unmasked pair, 0.026 ms per
  llama3.2-3b layer at S = 2048 at the card's bf16 peak).  p enters the p·v
  product as three bf16 terms, p1 = bf16(p), p2 = bf16(p - p1),
  p3 = bf16(p - p1 - p2), which carry it to f32 precision: the reference's
  p·v product is f32, and a single bf16 p would move outputs past one bf16
  ulp of it.  That doubles the tensor work to 8·D flops per pair.
* bf16, any other D up to 256 ("wgmma_padded"): q, k and v are zero-padded
  along D to the next of those widths, the kernel runs with the scale of
  the true D, and the output is sliced back.  The zero columns add exact
  zeros to q·kᵀ and give zero output columns, so the result is the
  unpadded function's.
* f32, D a multiple of 4 ("scalar"), or zero-padded up to one
  ("scalar_padded"): the first port's scalar kernel (f32 FMAs from shared
  memory, no tensor cores), still scalar, 128 head-dim columns a block.
* bf16, D above 256 ("scalar_f32_copies"): the scalar kernel on f32
  copies of q, k and v made on the card, its output rounded once to bf16.

No head dim is refused.

``block_q`` and ``block_k`` keep the reference's signature and are ignored:
the TPU's 512-row blocks do not fit a Hopper block's shared memory, so the
tiles are the kernel's own.

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
TENSOR_CORE_HEAD_DIMS = (16, 32, 64, 128, 256)


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


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that runs head dim ``d`` in ``dtype`` on the card (see
    the module note): "wgmma", "wgmma_padded", "scalar", "scalar_padded"
    or "scalar_f32_copies".  Every head dim ≥ 1 has one."""
    if d < 1:
        raise ValueError(f"flash_attention needs a head dim >= 1, got {d}")
    if dtype == torch.bfloat16:
        if d in TENSOR_CORE_HEAD_DIMS:
            return "wgmma"
        return "wgmma_padded" if d < TENSOR_CORE_HEAD_DIMS[-1] \
            else "scalar_f32_copies"
    if dtype == torch.float32:
        return "scalar_padded" if d % 4 else "scalar"
    raise TypeError(f"flash_attention has no kernel for {dtype}")


def kernel_head_dim(dtype: torch.dtype, d: int) -> int:
    """The head dim the kernel of ``kernel_variant(dtype, d)`` runs: the
    next tensor-core width for "wgmma_padded", ``d`` rounded up to a
    multiple of 4 on the scalar kernel, ``d`` itself otherwise."""
    if kernel_variant(dtype, d) == "wgmma_padded":
        return min(w for w in TENSOR_CORE_HEAD_DIMS if w >= d)
    return -(-d // 4) * 4


def pad_head_dim(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` [B,S,H,D] zero-padded along D to ``dp``, contiguous."""
    d = t.shape[-1]
    if dp == d:
        return t.contiguous()
    return torch.nn.functional.pad(t, (0, dp - d)).contiguous()


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    b, s, h, d = q.shape
    dp = kernel_head_dim(q.dtype, d)
    run = (torch.float32 if kernel_variant(q.dtype, d) == "scalar_f32_copies"
           else q.dtype)
    qp, kp, vp = (pad_head_dim(t.to(run), dp) for t in (q, k, v))
    out = torch.empty_like(qp)
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the scale of the true head dim: padded columns add exact zeros
    _build.check("flash_attention", fn(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(), b, s, h,
        dp, int(causal), 1.0 / math.sqrt(d), _DTYPES[run], stream))
    if dp != d:
        out = out[..., :d].contiguous()
    return out.to(q.dtype)


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
