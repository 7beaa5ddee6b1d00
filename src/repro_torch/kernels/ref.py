"""Plain PyTorch oracles and the shared integer conv geometry.

Counterpart of ``repro.kernels.ref``: the same shape math (the single
definition every kernel, planner and walk shares) and the same oracles,
on NHWC tensors with ``[KH,KW,C/groups,K]`` weights.

Integer contractions are exact: PyTorch's ``F.conv2d`` on int8 tensors
returns int8 (the int32 result mod 256), so the int path upcasts before
contracting — to int64 on the CPU, and to float64 on the card, where
PyTorch has no integer conv or matmul.  float64 is exact here: every
partial sum is an integer far below 2**53 (worst case about
127·128·9·256 ≈ 3.7e7), and the result is rounded before the cast back.
Rounding is half to even everywhere (``torch.round``, like ``jnp.round``).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, int, Tuple[Tuple[int, int], Tuple[int, int]]]


def dilated_extent(k: int, dilation: int = 1) -> int:
    """Spatial extent of a dilated kernel: ``dilation·(k−1)+1``."""
    return dilation * (k - 1) + 1


def normalize_padding(padding: Padding, kh: int, kw: int,
                      stride: int = 1, h: int = 0, w: int = 0,
                      dilation: int = 1
                      ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Resolve SAME/VALID/int/explicit padding to ((top,bottom),(left,right)).

    SAME follows the TF/XLA convention: output = ceil(in/stride), with the
    extra pixel (odd total pad) on the bottom/right; a dilated kernel pads
    for its effective extent."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    if isinstance(padding, (tuple, list)):
        (a, b), (c, d) = padding
        return ((int(a), int(b)), (int(c), int(d)))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        def same(dim, k):
            out = -(-dim // stride)
            total = max((out - 1) * stride + dilated_extent(k, dilation)
                        - dim, 0)
            return (total // 2, total - total // 2)
        return (same(h, kh), same(w, kw))
    raise ValueError(f"unknown padding {padding!r}")


def conv_out_shape(h: int, w: int, kh: int, kw: int, stride: int = 1,
                   padding: Padding = "VALID",
                   dilation: int = 1) -> Tuple[int, int]:
    """Spatial output shape of a conv layer."""
    (pt, pb), (pl_, pr) = normalize_padding(padding, kh, kw, stride, h, w,
                                            dilation)
    return ((h + pt + pb - dilated_extent(kh, dilation)) // stride + 1,
            (w + pl_ + pr - dilated_extent(kw, dilation)) // stride + 1)


def halo_window(tile: int, stride: int, k: int, dilation: int = 1) -> int:
    """Input extent consumed by ``tile`` contiguous conv outputs (adjacent
    windows overlap by the dilated extent minus the stride)."""
    return (tile - 1) * stride + dilated_extent(k, dilation)


def divisor_banks(dim: int, want: int) -> int:
    """Largest bank count ≤ ``want`` that divides ``dim``."""
    b = max(1, min(want, dim))
    while dim % b:
        b -= 1
    return b


def grouped_banks(c: int, k: int, groups: int = 1, want_cin: int = 4,
                  want_kout: int = 4) -> Tuple[int, int]:
    """Legal (cin_banks, kout_banks) for a grouped conv: cin banks divide
    the per-group slice C/g, kout banks split along group boundaries."""
    check_groups(c, k, groups)
    cg, kg = c // groups, k // groups
    cin = divisor_banks(cg, want_cin)
    bpg = divisor_banks(kg, max(1, want_kout // groups))
    return cin, groups * bpg


def check_groups(c: int, k: int, groups: int) -> None:
    """``groups`` must divide both the input and output channel counts."""
    if groups < 1 or c % groups or k % groups:
        raise ValueError(
            f"groups={groups} must divide both C={c} and K={k} "
            f"(groups == C is depthwise)")


def _nchw_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
               pad, groups: int, dilation: int) -> torch.Tensor:
    """NHWC x, [KH,KW,C/g,K] w → NHWC output, in the operands' dtype."""
    (pt, pb), (pl_, pr) = pad
    xt = F.pad(x.permute(0, 3, 1, 2), (pl_, pr, pt, pb))
    out = F.conv2d(xt, w.permute(3, 2, 0, 1), stride=stride,
                   dilation=dilation, groups=groups)
    return out.permute(0, 2, 3, 1)


def _exact_dtype(device: torch.device) -> torch.dtype:
    return torch.int64 if device.type == "cpu" else torch.float64


def _to_int32(acc: torch.Tensor) -> torch.Tensor:
    if acc.is_floating_point():
        acc = torch.round(acc)
    return acc.to(torch.int32)


def conv2d_ref(x, w, bias=None, *, stride: int = 1,
               padding: Padding = "VALID", groups: int = 1,
               dilation: int = 1, dtype: torch.dtype = torch.float32):
    """Float convolution oracle, accumulated in ``dtype`` (f32; float64
    where a check needs the exact sums).  x: [N,H,W,C];
    w: [KH,KW,C/groups,K] → [N,OH,OW,K].  On the card TF32 is off for the
    call, so the f32 result is a full-precision reference."""
    check_groups(x.shape[3], w.shape[3], groups)
    pad = normalize_padding(padding, w.shape[0], w.shape[1], stride,
                            x.shape[1], x.shape[2], dilation)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = _nchw_conv(x.to(dtype), w.to(dtype), stride, pad, groups,
                         dilation)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def conv2d_ref_int8(x, w, bias=None, *, stride: int = 1,
                    padding: Padding = "VALID", groups: int = 1,
                    dilation: int = 1):
    """int8 × int8 → int32 accumulation, exact (see the module note).
    Zero padding is exact for the symmetric (zero-point-0) scheme."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {x.dtype}, {w.dtype}")
    check_groups(x.shape[3], w.shape[3], groups)
    pad = normalize_padding(padding, w.shape[0], w.shape[1], stride,
                            x.shape[1], x.shape[2], dilation)
    dt = _exact_dtype(x.device)
    out = _to_int32(_nchw_conv(x.to(dt), w.to(dt), stride, pad, groups,
                               dilation))
    if bias is not None:
        out = out + bias.to(torch.int32)
    return out


def _windows(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """[N,H,W,C] → [N,OH,OW,C,size,size] floor-mode pooling windows."""
    return x.unfold(1, size, stride).unfold(2, size, stride)


def maxpool2d_ref(x, size: int = 2, stride: int = None):
    """Max pool over [N,H,W,C]; trailing rows/cols that don't fill a window
    are dropped (floor semantics, matching the fused kernel epilogue)."""
    stride = size if stride is None else stride
    return _windows(x, size, stride).amax(dim=(-2, -1))


def avgpool2d_ref(x, size: int = 2, stride: int = None):
    """Average pool over [N,H,W,C] (floor semantics).  Integer inputs sum
    exactly, divide in f32 and round the mean back onto the input grid."""
    stride = size if stride is None else stride
    win = _windows(x, size, stride)
    if not x.is_floating_point():
        s = win.sum(dim=(-2, -1), dtype=torch.int32)
        mean = torch.round(s.to(torch.float32) / float(size * size))
        info = torch.iinfo(x.dtype)
        return mean.clamp(info.min, info.max).to(x.dtype)
    s = win.to(torch.float32).sum(dim=(-2, -1))
    return (s / float(size * size)).to(x.dtype)


def global_avgpool_ref(x):
    """Global average pool [N,H,W,C] → [N,C]; integer inputs round the mean
    back onto the input dtype's grid."""
    if not x.is_floating_point():
        s = x.sum(dim=(1, 2), dtype=torch.int32)
        mean = torch.round(s.to(torch.float32) / float(x.shape[1] * x.shape[2]))
        info = torch.iinfo(x.dtype)
        return mean.clamp(info.min, info.max).to(x.dtype)
    return x.to(torch.float32).mean(dim=(1, 2)).to(x.dtype)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def requantize_ref(acc, out_scale):
    """int32/f32 accumulator × scale → int8 (round half to even,
    saturating).  out_scale: scalar or per-channel [K]."""
    scaled = torch.round(acc.to(torch.float32) * _f32(out_scale, acc.device))
    return scaled.clamp(-128, 127).to(torch.int8)


def add_requant_ref(a, b, scale_a, scale_b, *, relu: bool = False):
    """Residual merge on a shared int8 grid: each branch requantizes onto
    the merge grid (round half to even), the aligned values add, optional
    ReLU, saturate to int8."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8 branches required, got {a.dtype}, {b.dtype}")
    ya = torch.round(a.to(torch.float32) * _f32(scale_a, a.device))
    yb = torch.round(b.to(torch.float32) * _f32(scale_b, b.device))
    y = ya + yb
    if relu:
        y = torch.clamp(y, min=0)
    return y.clamp(-128, 127).to(torch.int8)


def conv2d_epilogue_ref(x, w, bias=None, *, stride: int = 1,
                        padding: Padding = "VALID", relu: bool = False,
                        pool: bool = False, out_scale=None,
                        groups: int = 1, dilation: int = 1):
    """Conv + the fused post-processing chain ReLU → 2×2 max-pool →
    requantize, in accumulator precision."""
    if x.dtype == torch.int8:
        acc = conv2d_ref_int8(x, w, bias, stride=stride, padding=padding,
                              groups=groups, dilation=dilation)
    else:
        acc = conv2d_ref(x, w, bias, stride=stride, padding=padding,
                         groups=groups, dilation=dilation)
    if relu:
        acc = torch.clamp(acc, min=0)
    if pool:
        acc = maxpool2d_ref(acc)
    if out_scale is not None:
        return requantize_ref(acc, out_scale)
    return acc


# ---------------------------------------------------------------------------
# Transposed-convolution oracles (the dense-prediction contract)
# ---------------------------------------------------------------------------


def grouped_swap_weights(w, groups: int = 1):
    """Per-group channel-axis swap [KH,KW,C/groups,K] → [KH,KW,K/groups,C]
    with the groups reassembled along the new output axis, no spatial
    flip (an involution)."""
    kh, kw, cg, k = w.shape
    kg = k // groups
    if groups == 1:
        return w.transpose(2, 3)
    return (w.reshape(kh, kw, cg, groups, kg).permute(0, 1, 4, 3, 2)
            .reshape(kh, kw, kg, groups * cg))


def grouped_transpose_weights(w, groups: int = 1):
    """Forward weights [KH,KW,C/groups,K] → transposed-conv weights
    [KH,KW,K/groups,C]: spatial flip + per-group channel-axis swap."""
    return grouped_swap_weights(torch.flip(w, (0, 1)), groups)


def conv_transpose_out_shape(h: int, w: int, kh: int, kw: int,
                             stride: int = 1, padding: Padding = "VALID",
                             dilation: int = 1) -> Tuple[int, int]:
    """Spatial output shape of ``conv2d_transpose_ref``: the padding names
    the forward conv being inverted, so VALID grows to ``(h−1)·s + ek``
    (ek the dilated kernel extent), SAME to exactly ``h·s``, explicit
    ((pt,pb),(pl,pr)) to ``(h−1)·s + ek − pt − pb``."""
    (oh, ow), _ = conv_transpose_eq_params(h, w, kh, kw, stride, padding,
                                           dilation)
    return oh, ow


def conv_transpose_eq_params(h: int, w: int, kh: int, kw: int,
                             stride: int = 1, padding: Padding = "VALID",
                             dilation: int = 1, out_spatial=None):
    """A transposed conv as its equivalent stride-1 conv → ((OH, OW),
    eq_pads): the output extent and the "full" padding of the
    zero-inserted input, ``ek−1−pt`` on top and ``OH+pt−(h−1)·s−1`` on the
    bottom (negative where the forward padding exceeded the kernel
    extent: those rows are cropped).  ``out_spatial`` pins (OH, OW), the
    stride remainder rows included."""
    ekh, ekw = dilated_extent(kh, dilation), dilated_extent(kw, dilation)
    if out_spatial is not None:
        oh, ow = out_spatial
        (pt, pb), (pl_, pr) = normalize_padding(padding, kh, kw, stride,
                                                oh, ow, dilation)
    elif isinstance(padding, (int, tuple, list)):
        (pt, pb), (pl_, pr) = normalize_padding(padding, kh, kw, stride)
        oh = (h - 1) * stride + ekh - pt - pb
        ow = (w - 1) * stride + ekw - pl_ - pr
    elif padding == "VALID":
        (pt, pb), (pl_, pr) = (0, 0), (0, 0)
        oh, ow = (h - 1) * stride + ekh, (w - 1) * stride + ekw
    elif padding == "SAME":
        oh, ow = h * stride, w * stride
        (pt, pb), (pl_, pr) = normalize_padding(padding, kh, kw, stride,
                                                oh, ow, dilation)
    else:
        raise ValueError(f"unknown padding {padding!r}")
    for dim, o, p0, p1, ek in ((h, oh, pt, pb, ekh), (w, ow, pl_, pr, ekw)):
        r = o + p0 + p1 - ek - (dim - 1) * stride
        if o < 1 or not 0 <= r < max(stride, 1):
            raise ValueError(
                f"conv_transpose geometry is not invertible: input {dim} "
                f"with stride={stride}, kernel extent {ek}, padding "
                f"({p0},{p1}) cannot produce output extent {o}")
    eq_pads = ((ekh - 1 - pt, oh + pt - (h - 1) * stride - 1),
               (ekw - 1 - pl_, ow + pl_ - (w - 1) * stride - 1))
    return (oh, ow), eq_pads


def zero_insert(x: torch.Tensor, stride: int) -> torch.Tensor:
    """[N,H,W,C] → [N,(H−1)·s+1,(W−1)·s+1,C] with the input at every
    ``stride``-th pixel and zeros between (the lhs dilation)."""
    if stride == 1:
        return x
    n, h, w, c = x.shape
    xd = x.new_zeros((n, (h - 1) * stride + 1, (w - 1) * stride + 1, c))
    xd[:, ::stride, ::stride] = x
    return xd


def conv2d_transpose_ref(x, w, bias=None, *, stride: int = 1,
                         padding: Padding = "VALID", groups: int = 1,
                         dilation: int = 1, out_spatial=None,
                         dtype: torch.dtype = torch.float32):
    """Transposed (upsampling) convolution oracle, accumulated in ``dtype``
    (f32; float64 where a check needs the exact sums).  x: [N,H,W,C];
    w: [KH,KW,C/groups,K] (the forward layout) → [N,OH,OW,K]: the input
    zero-inserted by ``stride``, the kernel flipped spatially and a
    stride-1 grouped conv under the "full" padding of
    ``conv_transpose_eq_params`` (negative pads crop)."""
    check_groups(x.shape[3], w.shape[3], groups)
    _, eq_pads = conv_transpose_eq_params(
        x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride, padding,
        dilation, out_spatial)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = _nchw_conv(zero_insert(x.to(dtype), stride),
                         torch.flip(w, (0, 1)).to(dtype), 1,
                         eq_pads, groups, dilation)
    if bias is not None:
        out = out + bias.to(dtype)
    return out


def conv2d_transpose_ref_int8(x, w, bias=None, *, stride: int = 1,
                              padding: Padding = "VALID", groups: int = 1,
                              dilation: int = 1, out_spatial=None):
    """int8 × int8 → int32 transposed conv, exact (see the module note);
    the inserted zeros are the symmetric scheme's quantized zero."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {x.dtype}, {w.dtype}")
    check_groups(x.shape[3], w.shape[3], groups)
    _, eq_pads = conv_transpose_eq_params(
        x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride, padding,
        dilation, out_spatial)
    dt = _exact_dtype(x.device)
    out = _to_int32(_nchw_conv(zero_insert(x.to(dt), stride),
                               torch.flip(w, (0, 1)).to(dt), 1, eq_pads,
                               groups, dilation))
    if bias is not None:
        out = out + bias.to(torch.int32)
    return out


def conv2d_transpose_epilogue_ref(x, w, bias=None, *, stride: int = 1,
                                  padding: Padding = "VALID",
                                  relu: bool = False, pool: bool = False,
                                  out_scale=None, groups: int = 1,
                                  dilation: int = 1):
    """Transposed conv + the fused ReLU → 2×2 max-pool → requantize chain,
    in accumulator precision."""
    if x.dtype == torch.int8:
        acc = conv2d_transpose_ref_int8(x, w, bias, stride=stride,
                                        padding=padding, groups=groups,
                                        dilation=dilation)
    else:
        acc = conv2d_transpose_ref(x, w, bias, stride=stride,
                                   padding=padding, groups=groups,
                                   dilation=dilation)
    if relu:
        acc = torch.clamp(acc, min=0)
    if pool:
        acc = maxpool2d_ref(acc)
    if out_scale is not None:
        return requantize_ref(acc, out_scale)
    return acc


# ---------------------------------------------------------------------------
# Backward-pass oracles (the training contract)
# ---------------------------------------------------------------------------


def conv2d_input_grad_ref(g, w, x_shape, *, stride: int = 1,
                          padding: Padding = "VALID", groups: int = 1,
                          dilation: int = 1,
                          dtype: torch.dtype = torch.float32):
    """dL/dx of ``conv2d_ref``: the transposed conv of the cotangent with
    per-group channel-swapped weights ([KH,KW,C/g,K] → [KH,KW,K/g,C]),
    pinned to the forward input's extent (``out_spatial``) so the rows a
    strided forward never reached come back as zeros.  Accumulated in
    ``dtype``, like the oracles below."""
    n, h, w_dim, c = x_shape
    kh, kw, cg, k = w.shape
    assert c == cg * groups, (c, cg, groups)
    return conv2d_transpose_ref(
        g, grouped_swap_weights(w, groups), stride=stride, padding=padding,
        groups=groups, dilation=dilation, out_spatial=(h, w_dim),
        dtype=dtype)


def conv2d_weight_grad_ref(x, g, kh: int, kw: int, *, stride: int = 1,
                           padding: Padding = "VALID", groups: int = 1,
                           dilation: int = 1,
                           dtype: torch.dtype = torch.float32):
    """dL/dw of ``conv2d_ref``, tap by tap:

        dW[dy,dx,c,k] = Σ_{n,i,j} x_pad[n, i·s+dy·d, j·s+dx·d, c] · g[n,i,j,k]

    with the contraction inside each group for ``groups > 1``, so dW keeps
    the forward's [KH,KW,C/g,K] layout.  TF32 stays as the caller set it
    (off by default for matmuls on the card)."""
    n, h, w_dim, c = x.shape
    oh, ow, k = g.shape[1], g.shape[2], g.shape[3]
    check_groups(c, k, groups)
    cg, kg = c // groups, k // groups
    (pt, pb), (pl_, pr) = normalize_padding(padding, kh, kw, stride, h,
                                            w_dim, dilation)
    xp = F.pad(x.to(dtype), (0, 0, pl_, pr, pt, pb))
    gf = g.to(dtype).reshape(n, oh, ow, groups, kg)
    taps = []
    for dy in range(kh):
        for dx in range(kw):
            xs = xp[:, dy * dilation:dy * dilation + (oh - 1) * stride + 1:
                    stride,
                    dx * dilation:dx * dilation + (ow - 1) * stride + 1:
                    stride]
            tap = torch.einsum("nijgc,nijgk->gck",
                               xs.reshape(n, oh, ow, groups, cg), gf)
            taps.append(tap.permute(1, 0, 2).reshape(cg, k))
    return torch.stack(taps).reshape(kh, kw, cg, k)


def conv2d_bias_grad_ref(g, dtype: torch.dtype = torch.float32):
    """dL/db of ``conv2d_ref``: the cotangent summed over (N,OH,OW)."""
    return g.to(dtype).sum(dim=(0, 1, 2))


def relu_mask_ref(acc):
    """The fused epilogue's ReLU backward mask: True where the accumulator
    was strictly positive (no gradient at exactly 0)."""
    return acc > 0


def maxpool_argmax_ref(y, size: int = 2):
    """Per-window argmax of the size×size/size max-pool, row-major within
    the window and the first maximum winning (a tie of zeros after a ReLU
    routes to the window's top-left), trailing rows and columns that fill
    no window dropped → int8 [N, H//size, W//size, C] in 0..size²−1."""
    win = _windows(y, size, size).flatten(-2)
    # the first maximum explicitly: the lowest index holding the max
    first = (win == win.amax(dim=-1, keepdim=True)).to(torch.int8)
    return first.argmax(dim=-1).to(torch.int8)


def maxpool2x2_argmax_ref(y):
    """``maxpool_argmax_ref`` of the fused epilogue's 2×2 pool: the pool
    mask the training residuals carry."""
    return maxpool_argmax_ref(y, 2)


def maxpool_first_ref(y, size: int):
    """``maxpool2d_ref`` whose gradient goes to each window's first maximum
    (``maxpool_argmax_ref``), as the reference's ``reduce_window`` max
    routes it; ``amax`` would split a tie."""
    idx = maxpool_argmax_ref(y.detach(), size).to(torch.int64)
    return _windows(y, size, size).flatten(-2).gather(
        -1, idx[..., None]).squeeze(-1)


def maxpool2x2_bwd_ref(idx, g, out_shape):
    """Backward of the 2×2/2 max-pool from its argmax mask: each window's
    cotangent goes to the position ``idx`` chose; the dropped trailing odd
    rows and columns get zero.  ``out_shape`` is the pre-pool
    [N,H,W,C]."""
    n, h, w, c = out_shape
    h2, w2 = h // 2, w // 2
    gf = g.to(torch.float32)[..., None]
    dwin = torch.zeros((*gf.shape[:-1], 4), dtype=torch.float32,
                       device=g.device).scatter_(
        -1, idx.to(torch.int64)[..., None], gf)           # [N,H2,W2,C,4]
    dy = dwin.reshape(n, h2, w2, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
    dy = dy.reshape(n, h2 * 2, w2 * 2, c)
    return F.pad(dy, (0, 0, 0, w - w2 * 2, 0, h - h2 * 2))


def conv2d_ref_wrap8(x, w, bias=None):
    """Paper-waveform mode: every accumulation wraps in 8 bits, which
    equals the int32 result mod 256."""
    return conv2d_ref_int8(x, w, bias).to(torch.int8)


def matmul_ref(x, w, bias=None):
    """x: [M,K] @ w: [K,N] + bias, in f32."""
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out


def matmul_ref_int8(x, w, bias=None):
    """int8 × int8 → int32 GEMM, exact (see the module note)."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {x.dtype}, {w.dtype}")
    dt = _exact_dtype(x.device)
    out = _to_int32(torch.matmul(x.to(dt), w.to(dt)))
    if bias is not None:
        out = out + bias.to(torch.int32)
    return out


def conv1d_depthwise_ref(x, w, bias=None):
    """Causal depthwise temporal conv (the RecurrentGemma site), summed in
    f32 tap by tap.  x: [B,S,W]; w: [K,W] → [B,S,W] in x's dtype."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + xp[:, j:j + s].to(torch.float32) * w[j].to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)
