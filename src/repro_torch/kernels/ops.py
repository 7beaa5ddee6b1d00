"""Public kernel entries, forward only (counterpart of ``repro.kernels.ops``).

* ``conv2d`` adds the 8-bit datapath modes on top of the two conv kernels:
  ``out_scale`` requantize (int8 or f32 accumulator), ``wrap8`` (the Fig. 6
  waveform: the int32 result wrapped to 8 bits), ``pipelined=`` picks
  ``conv2d_ws_pipe`` over ``conv2d_ws``, and grouped layers re-legalize
  their banks through ``ref.grouped_banks``;
* ``conv2d_transpose`` is the transposed conv (the dense-prediction
  upsampling layer): the host lowering of ``conv2d_ws_trans`` onto the two
  conv kernels, int8 (with or without ``out_scale``) and f32;
* ``matmul_ws`` is the GEMM entry, the kernel wrapper itself: int8
  operands give int32, f32 and bf16 operands their own dtype (bf16 is
  accumulated in f32 and rounded once), as the reference's entry returns;
* ``flash_attention`` is the attention entry of the LM prefill, the kernel
  wrapper itself (bf16 or f32, ``[B,S,H,D]``).

The custom VJPs of the reference are not ported yet: nothing here is
differentiable.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_ws import conv2d_ws
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.kernels.conv2d_ws_trans import conv2d_ws_transpose
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul_ws import matmul_ws

__all__ = ["conv2d", "conv2d_transpose", "flash_attention", "matmul_ws"]


def conv2d(x, w, bias=None, *, stride: int = 1, padding="VALID",
           groups: int = 1, cin_banks: int = 4, kout_banks: int = 4,
           h_tile: int = 0, w_tile: int = 0, relu: bool = False,
           pool: bool = False, wrap8: bool = False, out_scale=None,
           dilation: int = 1, pipelined: bool = False) -> torch.Tensor:
    """Paper-dataflow convolution (any stride, SAME|VALID|explicit padding,
    fused ReLU → 2×2 max-pool → requantize epilogue, halo'd spatial tiles
    via h_tile/w_tile, groups, dilation).

    float in → f32 out; int8 in → int32 out; int8 out whenever
    ``out_scale`` is given (either accumulator).  ``wrap8=True`` (int8
    only) wraps the accumulator to int8 instead; it has no requantize
    stage, so combining it with ``out_scale`` is an error.
    ``pipelined=True`` runs ``conv2d_ws_pipe`` (bit-equal, a performance
    choice the planner makes per layer)."""
    if wrap8 and out_scale is not None:
        raise ValueError("wrap8 and out_scale are mutually exclusive: the "
                         "Fig. 6 wrap path has no requantize stage")
    if groups > 1:
        cin_banks, kout_banks = ref.grouped_banks(
            x.shape[3], w.shape[3], groups, want_cin=cin_banks,
            want_kout=kout_banks)
    fwd = conv2d_ws_pipe if pipelined else conv2d_ws
    out = fwd(x, w, bias, out_scale, stride=stride, padding=padding,
              groups=groups, cin_banks=cin_banks, kout_banks=kout_banks,
              h_tile=h_tile, w_tile=w_tile, relu=relu, pool=pool,
              dilation=dilation)
    if wrap8 and x.dtype == torch.int8:
        return out.to(torch.int8)
    return out


def conv2d_transpose(x, w, bias=None, *, stride: int = 1, padding="VALID",
                     groups: int = 1, cin_banks: int = 4,
                     kout_banks: int = 4, h_tile: int = 0, w_tile: int = 0,
                     relu: bool = False, pool: bool = False, out_scale=None,
                     dilation: int = 1, out_spatial=None,
                     pipelined: bool = False) -> torch.Tensor:
    """Transposed convolution through the weight-stationary kernels:
    zero-insertion by ``stride``, kernel flip, and the stride-1 conv under
    the "full"-padding equivalence (``conv2d_ws_trans``).  x: [N,H,W,C];
    w: [KH,KW,C/groups,K] (forward layout) → [N,OH,OW,K], SAME growing to
    ``H·stride``, VALID to ``(H−1)·stride + dilation·(k−1) + 1``,
    ``out_spatial`` pinning the output.  The epilogue (``relu`` / 2×2
    ``pool`` / ``out_scale``), grouped banking, tiling and ``pipelined=``
    match ``conv2d``.  Inference only: the reference's float VJP is not
    ported (ROADMAP A12)."""
    if groups > 1:
        cin_banks, kout_banks = ref.grouped_banks(
            x.shape[3], w.shape[3], groups, want_cin=cin_banks,
            want_kout=kout_banks)
    kh, kw = w.shape[0], w.shape[1]
    (oh, ow), _ = ref.conv_transpose_eq_params(
        x.shape[1], x.shape[2], kh, kw, stride, padding, dilation,
        out_spatial)
    pad = ref.normalize_padding(padding, kh, kw, stride, oh, ow, dilation)
    return conv2d_ws_transpose(
        x, w, bias, out_scale, stride=stride, padding=pad, groups=groups,
        cin_banks=cin_banks, kout_banks=kout_banks, h_tile=h_tile,
        w_tile=w_tile, relu=relu, pool=pool, dilation=dilation,
        out_spatial=(oh, ow), pipelined=pipelined)
