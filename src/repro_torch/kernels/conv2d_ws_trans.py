"""Transposed convolution on the weight-stationary dataflow (counterpart
of ``repro.kernels.conv2d_ws_trans``): the dense-prediction upsampling
layer.

A transposed conv is an ordinary stride-1 conv on a lowered input: the
input is zero-inserted by the (output-growth) stride, the kernel is
flipped spatially, and the "full" padding of the equivalence
(``ref.conv_transpose_eq_params``) frames the zero-inserted map.  This is
host lowering only: the lowered problem runs on ``conv2d_ws`` or
``conv2d_ws_pipe`` with their whole contract (tensor-core, simt or scalar
path, grouped banking, fused ReLU → pool → requantize epilogue, int8
datapath).
Negative equivalence pads (forward padding beyond the kernel extent)
become crops of the zero-inserted map, because the kernels only pad.

The flipped weights are derived once per weight tensor
(``flipped_weights``), so a served network neither flips nor repacks a
layer's weights on every batch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d_ws import conv2d_ws, derived_weights
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.kernels.ref import (check_groups, conv_transpose_eq_params,
                                     grouped_banks, zero_insert)


def transpose_eq_conv_geometry(h: int, w: int, kh: int, kw: int,
                               stride: int = 1, padding="VALID",
                               dilation: int = 1, out_spatial=None):
    """Shape-only companion of :func:`transpose_eq_conv_inputs`: the
    (h_eq, w_eq, eq_pads) of the equivalent stride-1 conv — the
    zero-inserted map after negative-pad cropping and the clipped (all
    ≥ 0) explicit pads.  The tile planner prices a transposed layer on
    exactly this geometry."""
    _, eq_pads = conv_transpose_eq_params(h, w, kh, kw, stride, padding,
                                          dilation, out_spatial)
    hd = (h - 1) * stride + 1 if stride > 1 else h
    wd = (w - 1) * stride + 1 if stride > 1 else w
    pads = [eq_pads[0][0], eq_pads[0][1], eq_pads[1][0], eq_pads[1][1]]
    hd -= max(0, -pads[0]) + max(0, -pads[1])
    wd -= max(0, -pads[2]) + max(0, -pads[3])
    pads = [max(0, p) for p in pads]
    return hd, wd, ((pads[0], pads[1]), (pads[2], pads[3]))


def transpose_eq_conv_inputs(x: torch.Tensor, kh: int, kw: int, *,
                             stride: int = 1, padding="VALID",
                             dilation: int = 1, out_spatial=None):
    """Lower a transposed conv's input to its equivalent stride-1 conv →
    ``(x_eq, eq_pads)``: ``x`` zero-inserted by ``stride``, any negative
    pad folded into a crop, ``eq_pads = ((t, b), (l, r))`` all ≥ 0."""
    n, h, w_dim, c = x.shape
    _, eq_pads = conv_transpose_eq_params(h, w_dim, kh, kw, stride,
                                          padding, dilation, out_spatial)
    xd = zero_insert(x, stride)
    pads = [eq_pads[0][0], eq_pads[0][1], eq_pads[1][0], eq_pads[1][1]]
    if min(pads) < 0:
        top, bot, left, right = (max(0, -p) for p in pads)
        xd = xd[:, top:xd.shape[1] - bot, left:xd.shape[2] - right, :]
        pads = [max(0, p) for p in pads]
    return xd, ((pads[0], pads[1]), (pads[2], pads[3]))


def _flip(w: torch.Tensor) -> torch.Tensor:
    return torch.flip(w, (0, 1))


def flipped_weights(w: torch.Tensor) -> torch.Tensor:
    """``w`` flipped spatially (the equivalent conv's kernel), derived
    once per weight tensor and version."""
    return derived_weights(w, "flip", _flip)


def conv2d_ws_transpose(x, w, bias=None, out_scale=None, *, stride: int = 1,
                        padding="VALID", groups: int = 1,
                        cin_banks: int = 4, kout_banks: int = 4,
                        h_tile: int = 0, w_tile: int = 0,
                        relu: bool = False, pool: bool = False,
                        dilation: int = 1, out_spatial=None,
                        pipelined: bool = False) -> torch.Tensor:
    """Transposed convolution through the weight-stationary kernels.

    x: [N,H,W,C]; w: [KH,KW,C/groups,K] (forward layout; the flip is
    internal); bias: [K] or None → [N,OH,OW,K] with
    ``ref.conv_transpose_out_shape`` semantics (VALID grows to
    ``(H−1)·s + ek``, SAME to ``H·s``, explicit pads crop the VALID
    extent, ``out_spatial`` pins the output).  ``h_tile``/``w_tile`` tile
    the transpose output; the epilogue, grouped banking, int8 datapath
    and ``pipelined=`` kernel choice are ``conv2d_ws``'s."""
    check_groups(x.shape[3], w.shape[3], groups)
    xd, eq_pads = transpose_eq_conv_inputs(
        x, w.shape[0], w.shape[1], stride=stride, padding=padding,
        dilation=dilation, out_spatial=out_spatial)
    cb, kb = grouped_banks(x.shape[3], w.shape[3], groups,
                           want_cin=cin_banks, want_kout=kout_banks)
    kern = conv2d_ws_pipe if pipelined else conv2d_ws
    return kern(xd, flipped_weights(w), bias, out_scale, stride=1,
                padding=eq_pads, groups=groups, cin_banks=cb,
                kout_banks=kb, h_tile=h_tile, w_tile=w_tile, relu=relu,
                pool=pool, dilation=dilation)
