"""Backward pass of the conv through the same weight-stationary kernels
(counterpart of ``repro.kernels.conv2d_ws_bwd``).

Host code only: the reference has no Pallas kernel of its own here, and
neither has the port.  Every launch below is a launch of a hand-written
kernel (``conv2d_ws`` or ``matmul_ws``):

* **input gradient** = the transposed conv of the cotangent with the
  channel-swapped weights, pinned to the forward input's extent
  (``out_spatial``), through ``conv2d_ws_transpose`` — whose stride-1
  lowering runs ``conv2d_ws``.  The cotangent's K channels play the cin
  role and the input's C channels the kout role, so a depthwise forward has
  a depthwise backward.
* **weight gradient** = KH·KW tap GEMMs on ``matmul_ws``:

      dW[dy,dx] = x_window(dy,dx)ᵀ [C, N·OH·OW] @ g [N·OH·OW, K]

  with one GEMM per group per tap when ``groups > 1``.  Each tap's window
  is gathered into one contiguous [C, N·OH·OW] copy (the strided view
  cannot feed the kernel), about 51 MB a tap at ``vgg_imagenet``'s conv 1
  in f32 at batch 8.

On CPU tensors the kernels' wrappers run their plain versions, so the same
code is the CPU path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv2d_ws_trans import conv2d_ws_transpose
from repro_torch.kernels.matmul_ws import matmul_ws
from repro_torch.kernels.ref import (check_groups, grouped_banks,
                                     grouped_swap_weights, normalize_padding)


def conv2d_ws_input_grad(g, w, x_shape, *, stride: int = 1,
                         padding="VALID", groups: int = 1,
                         cin_banks: int = 4, kout_banks: int = 4,
                         h_tile: int = 0, w_tile: int = 0,
                         dilation: int = 1) -> torch.Tensor:
    """dL/dx [N,H,W,C] from the cotangent ``g`` [N,OH,OW,K] and the
    weights ``w`` [KH,KW,C/groups,K]: the transposed conv of ``g`` with
    channel-swapped weights and ``out_spatial=(H, W)``.  The bank requests
    re-legalize against (K, C), the swapped channel roles; ``h_tile`` /
    ``w_tile`` tile the gradient map (the forward input)."""
    n, h, w_dim, c = x_shape
    kh, kw, cg, k = w.shape
    assert c == cg * groups, (c, cg, groups)
    assert g.shape[0] == n and g.shape[3] == k, (g.shape, x_shape, w.shape)
    cb_n, kb_n = grouped_banks(k, c, groups, want_cin=cin_banks,
                               want_kout=max(kout_banks, groups))
    return conv2d_ws_transpose(
        g.to(torch.float32),
        grouped_swap_weights(w, groups).to(torch.float32),
        stride=stride, padding=padding, groups=groups, dilation=dilation,
        cin_banks=cb_n, kout_banks=kb_n, h_tile=h_tile, w_tile=w_tile,
        out_spatial=(h, w_dim))


def conv2d_ws_weight_grad(x, g, kh: int, kw: int, *, stride: int = 1,
                          padding="VALID", groups: int = 1,
                          dilation: int = 1) -> torch.Tensor:
    """dL/dw [KH,KW,C/groups,K] from the input ``x`` [N,H,W,C] and the
    cotangent ``g`` [N,OH,OW,K]: KH·KW tap GEMMs ``x_window(dy,dx)ᵀ @ g``
    on ``matmul_ws``, contracting over N·OH·OW (per group for a grouped
    layer)."""
    n, h, w_dim, c = x.shape
    assert g.shape[0] == n, (x.shape, g.shape)
    oh, ow, k = g.shape[1], g.shape[2], g.shape[3]
    check_groups(c, k, groups)
    cg, kg = c // groups, k // groups
    (pt, pb), (pl_, pr) = normalize_padding(padding, kh, kw, stride, h,
                                            w_dim, dilation)
    xp = F.pad(x.to(torch.float32), (0, 0, pl_, pr, pt, pb))
    m = n * oh * ow
    gm = g.to(torch.float32).reshape(m, k)
    gms = [gm[:, i * kg:(i + 1) * kg].contiguous() for i in range(groups)]
    taps = []
    for dy in range(kh):
        for dx in range(kw):
            y0, x0 = dy * dilation, dx * dilation
            xs = xp[:, y0:y0 + (oh - 1) * stride + 1:stride,
                    x0:x0 + (ow - 1) * stride + 1:stride]
            xt = xs.permute(3, 0, 1, 2).reshape(c, m)    # [C, N·OH·OW]
            parts = [matmul_ws(xt[i * cg:(i + 1) * cg], gms[i])
                     for i in range(groups)]
            taps.append(parts[0] if groups == 1 else torch.cat(parts, 1))
    return torch.stack(taps).reshape(kh, kw, cg, k)
