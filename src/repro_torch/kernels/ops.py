"""Public kernel entries (counterpart of ``repro.kernels.ops``).

* ``conv2d`` adds the 8-bit datapath modes on top of the two conv kernels:
  ``out_scale`` requantize (int8 or f32 accumulator), ``wrap8`` (the Fig. 6
  waveform: the int32 result wrapped to 8 bits), ``pipelined=`` picks
  ``conv2d_ws_pipe`` over ``conv2d_ws``, and grouped layers re-legalize
  their banks through ``ref.grouped_banks``;
* ``conv2d_transpose`` is the transposed conv (the dense-prediction
  upsampling layer): the host lowering of ``conv2d_ws_trans`` onto the two
  conv kernels, int8 (with or without ``out_scale``) and f32;
* ``matmul_ws`` is the GEMM entry: int8 operands give int32, f32 and bf16
  operands their own dtype (bf16 is accumulated in f32 and rounded once),
  as the reference's entry returns;
* ``flash_attention`` is the attention entry of the LM prefill, the kernel
  wrapper itself (bf16 or f32, ``[B,S,H,D]``); it has no backward and
  raises where autograd would record it;
* ``conv1d_depthwise`` is the causal depthwise temporal conv (the
  RecurrentGemma site) as a 1×K ``conv2d`` over a height-1 map, one group
  per lane: ``conv2d_ws``'s scalar path.

The float paths of ``conv2d`` (float input, no ``out_scale``, no
``wrap8``), of ``conv2d_transpose`` (no ``out_scale``) and of ``matmul_ws``
are differentiable: where autograd records the call (grad mode on and an
operand that requires grad) it runs a ``torch.autograd.Function`` whose
backward is the reference's custom VJP, on the same kernels:

* ``matmul_ws``: dx = g @ wᵀ and dw = xᵀ @ g, two more f32 ``matmul_ws``
  launches, and db the cotangent summed in f32;
* ``conv2d``: the forward runs the kernel ``pipelined=`` picks without its
  epilogue, applies ReLU and the 2×2 pool in torch and saves only their
  masks (a bool ReLU mask and int8 pool indices), not the accumulator.  The backward routes the cotangent
  through the pool indices and the ReLU mask, then runs the input gradient
  (a transposed conv on ``conv2d_ws``) and the weight gradient (KH·KW tap
  GEMMs on ``matmul_ws``) of ``conv2d_ws_bwd``;
* ``conv2d_transpose``: the transpose duality run in reverse; dx is an
  ordinary strided ``conv2d_ws`` of the cotangent with channel-swapped
  weights, dw the swapped weight-grad GEMMs.

Each gradient is computed only where ``ctx.needs_input_grad`` asks for it
(a network's first layer computes no input gradient).  Where autograd does
not record the call, the fused kernel runs as before.

``matmul_ws`` takes DTensors too (the sharded LM's GEMMs): the matrix
product's sharding rule is applied by hand in the wrapper, mesh dim by
mesh dim (``sharding._contract_plan``), and the kernel
runs on the local shards, wrapped back with ``DTensor.from_local``:

* x sharded on M (w replicated) → the output sharded on M;
* w sharded on N (x replicated) → the output sharded on N;
* K sharded on both operands → a ``Partial`` sum;
* any other layout is redistributed to the nearest of these first (an
  FSDP weight sharded on K under an M-sharded x is all-gathered).

The bias is preloaded at K block 0, so under a K-sharded product it would
be added once per rank: there the kernel runs without it and the bias is
added after the reduction.  The local operands are taken with
``to_local(grad_placements=)`` naming the layout their local gradients
have (dw = xᵀ·g under an M-sharded x is a ``Partial`` sum over that dim,
which FSDP's redistribute back onto the weight's layout reduce-scatters),
so the same local autograd Function gives the backward on local shards: no
DTensor reaches the kernel and none is gathered whole for it.  It is done
by hand rather than with ``register_sharding`` on a ``torch.library`` op
because the kernel's launch, counts and autograd Function stay as they
are, and the rule needs the Partial-aware bias placement and the
gradients' placements, which a strategy list does not carry.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.device import is_dtensor
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_ws import conv2d_ws
from repro_torch.kernels.conv2d_ws_bwd import (conv2d_ws_input_grad,
                                               conv2d_ws_weight_grad)
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.kernels.conv2d_ws_trans import conv2d_ws_transpose
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul_ws import matmul_ws as _matmul_kernel

__all__ = ["conv1d_depthwise", "conv2d", "conv2d_transpose",
           "flash_attention", "matmul_ws", "matmul_ws_backward"]


def _recorded(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


def matmul_ws_backward(x, w, bias, g, need=(True, True, True)):
    """The VJP of ``matmul_ws`` → (dx, dw, db), each where ``need`` asks
    for it: two f32 ``matmul_ws`` launches and the cotangent summed in
    f32, each result cast to its operand's dtype.  Integer operands raise
    ``TypeError``: an int8 forward has no int8 gradient."""
    if not (x.is_floating_point() and w.is_floating_point()):
        raise TypeError(
            "matmul_ws VJP requires float operands: an int8 forward has no "
            "meaningful int8 gradient (casting the cotangent to int8 would "
            "silently truncate it) — differentiate the float path instead")
    gf = g.to(torch.float32)
    dx = dw = db = None
    if need[0]:
        dx = _matmul_kernel(gf, w.t().to(torch.float32)).to(x.dtype)
    if need[1]:
        dw = _matmul_kernel(x.t().to(torch.float32), gf).to(w.dtype)
    if need[2] and bias is not None:
        db = gf.sum(dim=0).to(bias.dtype)
    return dx, dw, db


class _MatmulWs(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return _matmul_kernel(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        return matmul_ws_backward(*ctx.saved_tensors, g,
                                  ctx.needs_input_grad)


def _matmul_ws_local(x, w, bias=None) -> torch.Tensor:
    if _recorded(x, w, bias):
        return _MatmulWs.apply(x, w, bias)
    return _matmul_kernel(x, w, bias)


def matmul_ws(x, w, bias=None) -> torch.Tensor:
    """x: [M,K] @ w: [K,N] (+bias [N]) → [M,N] on ``matmul_ws``: int32 for
    int8 operands, else the operands' dtype; differentiable for float
    operands (``matmul_ws_backward``).  DTensor operands run the sharding
    rule on their local shards (see the module note)."""
    if is_dtensor(x, w, bias):
        return _matmul_ws_dtensor(x, w, bias)
    return _matmul_ws_local(x, w, bias)


def _matmul_ws_dtensor(x, w, bias):
    """``matmul_ws`` on the local shards of x @ w (+ bias) under the
    matrix product's sharding rule (``sharding.contract_local``; see the
    module note)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import (_contract_plan,
                                                  contract_local)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_ws needs [M,K] @ [K,N], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    def unbiased(a, b):
        return _matmul_ws_local(a, b, None)
    if bias is None:
        return contract_local("mk,kn->mn", x, w, unbiased)
    mesh = next(t for t in (x, w, bias)
                if isinstance(t, DTensor)).device_mesh
    if not isinstance(bias, DTensor):
        bias = DTensor.from_local(bias, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    outs = [p[2] for p in _contract_plan(
        "mk,kn->mn", _placements(x, mesh), _placements(w, mesh))]
    if any(o.is_partial() for o in outs):
        # a K-sharded product: the bias once, after the reduction
        y = contract_local("mk,kn->mn", x, w, unbiased)
        return y.redistribute(mesh, [Replicate() if o.is_partial() else o
                                     for o in outs]) + bias
    # each rank's block of columns takes its entries of the bias: sharded
    # where the output's columns are, a partial gradient where its rows are
    r = Replicate()
    b_l = bias.redistribute(mesh, [
        Shard(0) if o == Shard(1) else r for o in outs]).to_local(
        grad_placements=[Shard(0) if o == Shard(1) else
                         Partial() if o == Shard(0) else r for o in outs])
    return contract_local("mk,kn->mn", x, w,
                          lambda a, b: _matmul_ws_local(a, b, b_l))


def _placements(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return (t.placements if isinstance(t, DTensor)
            else (Replicate(),) * mesh.ndim)


# ---------------------------------------------------------------------------
# The float conv's epilogue, forward and backward
# ---------------------------------------------------------------------------


def epilogue_masks(acc, relu: bool, pool: bool, what: str = "conv"):
    """ReLU → 2×2 max-pool on the epilogue-free accumulator, in torch (the
    same maximum operations on the same values as the fused epilogue) →
    (y, ReLU mask or None, pool indices or None)."""
    relu_mask = pool_idx = None
    y = acc
    if relu:
        relu_mask = ref.relu_mask_ref(acc)
        y = torch.clamp(y, min=0)
    if pool:
        oh, ow = acc.shape[1], acc.shape[2]
        if oh < 2 or ow < 2:
            # the epilogue-free launch skipped the kernel's own check:
            # differentiation fails exactly like the primal call
            raise ValueError(
                f"2×2 pool needs a ≥2×2 {what} output, got {oh}×{ow}")
        pool_idx = ref.maxpool2x2_argmax_ref(y)
        y = ref.maxpool2d_ref(y, 2)
    return y, relu_mask, pool_idx


def epilogue_backward(g, relu_mask, pool_idx, acc_shape):
    """The epilogue walked backwards: the cotangent routed through the pool
    indices, then gated by the ReLU mask → the accumulator's cotangent
    (f32)."""
    dacc = g.to(torch.float32)
    if pool_idx is not None:
        dacc = ref.maxpool2x2_bwd_ref(pool_idx, dacc, acc_shape)
    if relu_mask is not None:
        dacc = dacc * relu_mask
    return dacc


@dataclasses.dataclass(frozen=True, kw_only=True)
class ConvCfg:
    """Static configuration of one float conv pass; ``padding`` resolved to
    explicit form, so the backward needs no shape context."""
    stride: int
    padding: Tuple[Tuple[int, int], Tuple[int, int]]
    groups: int
    cin_banks: int
    kout_banks: int
    h_tile: int
    w_tile: int
    relu: bool
    pool: bool
    dilation: int = 1
    pipelined: bool = False


@dataclasses.dataclass(frozen=True, kw_only=True)
class ConvTransCfg(ConvCfg):
    """``ConvCfg`` of a transposed conv: ``padding`` is resolved against
    the output extent ``(out_h, out_w)``, the forward-conv frame of the
    transpose duality."""
    out_h: int
    out_w: int


class _Conv2dFloat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg: ConvCfg, x, w, bias):
        fwd = conv2d_ws_pipe if cfg.pipelined else conv2d_ws
        acc = fwd(x, w, bias, None, stride=cfg.stride, padding=cfg.padding,
                  groups=cfg.groups, cin_banks=cfg.cin_banks,
                  kout_banks=cfg.kout_banks, h_tile=cfg.h_tile,
                  w_tile=cfg.w_tile, dilation=cfg.dilation)
        y, relu_mask, pool_idx = epilogue_masks(acc, cfg.relu, cfg.pool)
        ctx.cfg, ctx.acc_shape = cfg, tuple(acc.shape)
        ctx.save_for_backward(x, w, bias, relu_mask, pool_idx)
        return y

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        x, w, bias, relu_mask, pool_idx = ctx.saved_tensors
        dacc = epilogue_backward(g, relu_mask, pool_idx, ctx.acc_shape)
        _, need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            dx = conv2d_ws_input_grad(
                dacc, w, tuple(x.shape), stride=cfg.stride,
                padding=cfg.padding, groups=cfg.groups,
                cin_banks=cfg.cin_banks, kout_banks=cfg.kout_banks,
                h_tile=cfg.h_tile, w_tile=cfg.w_tile,
                dilation=cfg.dilation).to(x.dtype)
        if need_w:
            dw = conv2d_ws_weight_grad(
                x, dacc, w.shape[0], w.shape[1], stride=cfg.stride,
                padding=cfg.padding, groups=cfg.groups,
                dilation=cfg.dilation).to(w.dtype)
        if need_b:
            db = dacc.sum(dim=(0, 1, 2)).to(bias.dtype)
        return None, dx, dw, db


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
    choice the planner makes per layer).  The float accumulator path is
    differentiable (see the module note)."""
    if wrap8 and out_scale is not None:
        raise ValueError("wrap8 and out_scale are mutually exclusive: the "
                         "Fig. 6 wrap path has no requantize stage")
    if groups > 1:
        cin_banks, kout_banks = ref.grouped_banks(
            x.shape[3], w.shape[3], groups, want_cin=cin_banks,
            want_kout=kout_banks)
    if (out_scale is None and not wrap8 and x.is_floating_point()
            and _recorded(x, w, bias)):
        pad = ref.normalize_padding(padding, w.shape[0], w.shape[1], stride,
                                    x.shape[1], x.shape[2], dilation)
        cfg = ConvCfg(stride=stride, padding=pad, groups=groups,
                      cin_banks=cin_banks, kout_banks=kout_banks,
                      h_tile=h_tile, w_tile=w_tile, relu=relu, pool=pool,
                      dilation=dilation, pipelined=pipelined)
        return _Conv2dFloat.apply(cfg, x, w, bias)
    fwd = conv2d_ws_pipe if pipelined else conv2d_ws
    out = fwd(x, w, bias, out_scale, stride=stride, padding=padding,
              groups=groups, cin_banks=cin_banks, kout_banks=kout_banks,
              h_tile=h_tile, w_tile=w_tile, relu=relu, pool=pool,
              dilation=dilation)
    if wrap8 and x.dtype == torch.int8:
        return out.to(torch.int8)
    return out


class _Conv2dTransposeFloat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg: ConvTransCfg, x, w, bias):
        acc = conv2d_ws_transpose(
            x, w, bias, None, stride=cfg.stride, padding=cfg.padding,
            groups=cfg.groups, cin_banks=cfg.cin_banks,
            kout_banks=cfg.kout_banks, h_tile=cfg.h_tile, w_tile=cfg.w_tile,
            dilation=cfg.dilation, out_spatial=(cfg.out_h, cfg.out_w),
            pipelined=cfg.pipelined)
        y, relu_mask, pool_idx = epilogue_masks(acc, cfg.relu, cfg.pool,
                                                "transpose")
        ctx.cfg, ctx.acc_shape = cfg, tuple(acc.shape)
        ctx.save_for_backward(x, w, bias, relu_mask, pool_idx)
        return y

    @staticmethod
    def backward(ctx, g):
        """dx: the ordinary strided conv of the cotangent with the
        channel-swapped weights (the transpose is that conv's adjoint); dw:
        the weight-grad GEMMs with the cotangent as the conv input and the
        primal input as its cotangent, channel-swapped back; db: the
        cotangent summed over (N, OH, OW)."""
        cfg = ctx.cfg
        x, w, bias, relu_mask, pool_idx = ctx.saved_tensors
        dacc = epilogue_backward(g, relu_mask, pool_idx, ctx.acc_shape)
        _, need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            # the dual conv contracts the transpose's K channels back to C
            cb_n, kb_n = ref.grouped_banks(
                w.shape[3], x.shape[3], cfg.groups, want_cin=cfg.cin_banks,
                want_kout=max(cfg.kout_banks, cfg.groups))
            dx = conv2d_ws(
                dacc, ref.grouped_swap_weights(w, cfg.groups).to(
                    torch.float32), None,
                stride=cfg.stride, padding=cfg.padding, groups=cfg.groups,
                cin_banks=cb_n, kout_banks=kb_n, h_tile=cfg.h_tile,
                w_tile=cfg.w_tile, dilation=cfg.dilation).to(x.dtype)
        if need_w:
            dwf = conv2d_ws_weight_grad(
                dacc, x.to(torch.float32), w.shape[0], w.shape[1],
                stride=cfg.stride, padding=cfg.padding, groups=cfg.groups,
                dilation=cfg.dilation)
            dw = ref.grouped_swap_weights(dwf, cfg.groups).to(
                w.dtype).contiguous()
        if need_b:
            db = dacc.sum(dim=(0, 1, 2)).to(bias.dtype)
        return None, dx, dw, db


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
    match ``conv2d``.  The float path (no ``out_scale``) is
    differentiable (see the module note)."""
    if groups > 1:
        cin_banks, kout_banks = ref.grouped_banks(
            x.shape[3], w.shape[3], groups, want_cin=cin_banks,
            want_kout=kout_banks)
    kh, kw = w.shape[0], w.shape[1]
    (oh, ow), _ = ref.conv_transpose_eq_params(
        x.shape[1], x.shape[2], kh, kw, stride, padding, dilation,
        out_spatial)
    pad = ref.normalize_padding(padding, kh, kw, stride, oh, ow, dilation)
    if (out_scale is None and x.is_floating_point()
            and _recorded(x, w, bias)):
        cfg = ConvTransCfg(stride=stride, padding=pad, groups=groups,
                           cin_banks=cin_banks, kout_banks=kout_banks,
                           h_tile=h_tile, w_tile=w_tile, relu=relu,
                           pool=pool, dilation=dilation, out_h=oh, out_w=ow,
                           pipelined=pipelined)
        return _Conv2dTransposeFloat.apply(cfg, x, w, bias)
    return conv2d_ws_transpose(
        x, w, bias, out_scale, stride=stride, padding=pad, groups=groups,
        cin_banks=cin_banks, kout_banks=kout_banks, h_tile=h_tile,
        w_tile=w_tile, relu=relu, pool=pool, dilation=dilation,
        out_spatial=(oh, ow), pipelined=pipelined)


def conv1d_depthwise(x, w, bias=None) -> torch.Tensor:
    """Causal depthwise temporal conv through the grouped WS conv kernel.

    x: [B,S,W], w: [K,W] (+bias [W]) → [B,S,W] in x's dtype.  The temporal
    conv is a width-grouped 1×K ``conv2d`` over a height-1 map: the
    sequence plays the spatial W axis, causality is a left padding of
    K−1, and ``groups == W`` makes every lane its own group (one cin bank,
    W kout banks: the depthwise case, ``conv2d_ws``'s scalar path).  The
    conv kernels take f32 operands, so a bf16 x is widened first (exact)
    and the f32 result cast back, as the reference's kernel sums a bf16
    window against f32 weights in f32.  Going through ``conv2d`` keeps its
    autograd Function, so the conv is differentiable as the reference's
    custom VJP makes it; ``ref.conv1d_depthwise_ref`` is the contract."""
    k, width = w.shape
    acc = conv2d(x.to(torch.float32)[:, None],
                 w.to(torch.float32)[None, :, None, :],
                 None if bias is None else bias.to(torch.float32),
                 stride=1, padding=((0, 0), (k - 1, 0)), groups=width,
                 cin_banks=1, kout_banks=width)[:, 0]
    return acc.to(x.dtype)
