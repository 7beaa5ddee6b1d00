"""Symmetric int8 quantization (counterpart of ``repro.core.quantize``):
the conv datapath, the QAT straight-through estimators, and w8a8 LM
serving (``quantize_weights``, ``w8_einsum``), whose int8 GEMMs run on
``matmul_ws``, and the error-feedback gradient compressor (``EFState``,
``ef_compress``) of ``distributed.compression``.

Every scale is a float32 tensor computed with the same f32 operations in
the same order as the reference, so scales, int8 values and biases are
bit-equal to it given bit-equal inputs."""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import torch

Axis = Optional[Union[int, Sequence[int]]]


class Quantized(NamedTuple):
    values: torch.Tensor           # int8
    scale: torch.Tensor            # f32; per-tensor [] or keepdims per-channel

    def dequantize(self) -> torch.Tensor:
        return self.values.to(torch.float32) * self.scale


def _amax_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize_symmetric(x: torch.Tensor, axis: Axis = None) -> Quantized:
    """Symmetric int8: scale = max|x| / 127 (per tensor, or per slice
    reducing over ``axis`` with kept dims)."""
    xf = x.to(torch.float32)
    if axis is None:
        scale = _amax_scale(xf.abs().amax())
    else:
        dims = (axis,) if isinstance(axis, int) else tuple(axis)
        scale = _amax_scale(xf.abs().amax(dim=dims, keepdim=True))
    q = torch.round(xf / scale).clamp(-128, 127).to(torch.int8)
    return Quantized(q, scale)


def requant_scale(in_scale, w_scale, out_scale) -> torch.Tensor:
    """Per-layer int8 chaining scale ``in_scale·w_scale / out_scale``: it
    re-expresses an int32 accumulator (units of ``in_scale·w_scale``) on
    the next layer's int8 grid."""
    return torch.as_tensor(in_scale * w_scale / out_scale,
                           dtype=torch.float32)


def branch_requant_scale(s_branch, s_out) -> torch.Tensor:
    """Merge-node branch scale ``s_branch / s_out`` aligning an int8 branch
    onto the merge node's shared output grid."""
    return torch.as_tensor(s_branch / s_out, dtype=torch.float32)


def act_scale_from_calibration(x_f32: torch.Tensor) -> torch.Tensor:
    """Activation scale from a calibration batch: max|x|/127 (symmetric)."""
    return _amax_scale(x_f32.to(torch.float32).abs().amax())


# ---------------------------------------------------------------------------
# Quantization-aware training (straight-through fake quantization)
# ---------------------------------------------------------------------------


def fake_quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize-dequantize onto the symmetric int8 grid with a
    straight-through estimator: the forward value is the int8 round trip
    (round half to even, saturate to ±127, rescale), written as
    ``x + (q − x)`` with ``q − x`` detached, so the backward is the
    identity.  ``scale`` is detached: QAT learns values on a grid, not the
    grid."""
    s = torch.as_tensor(scale, dtype=torch.float32,
                        device=x.device).detach()
    q = torch.clamp(torch.round(x / s), -127, 127) * s
    return x + (q - x).detach()


def fake_quant_weight(w: torch.Tensor,
                      per_channel: bool = False) -> torch.Tensor:
    """Fake-quantize a weight tensor on the grid ``quantize_network`` will
    lower it to: max|w|/127, per tensor or per output channel (the last
    axis, conv [KH,KW,C,K] and dense [C,K] alike)."""
    wf = w.to(torch.float32)
    if per_channel:
        amax = wf.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    else:
        amax = wf.abs().amax()
    return fake_quantize(wf, _amax_scale(amax.detach())).to(w.dtype)


def fake_quant_act(x: torch.Tensor) -> torch.Tensor:
    """Fake-quantize an activation on the current batch's symmetric scale
    (``act_scale_from_calibration``, detached): the QAT stand-in for the
    calibrated grids the int8 program chains through its requantizing
    epilogues."""
    return fake_quantize(x, act_scale_from_calibration(x.detach()))


# ---------------------------------------------------------------------------
# w8a8 serving: the paper's 8-bit datapath on the LM weights
# ---------------------------------------------------------------------------


def quantized_matmul(x: torch.Tensor, wq: Quantized,
                     use_kernel: bool = True) -> torch.Tensor:
    """w8a8 GEMM: quantize activations per tensor, int8 × int8 → int32 on
    ``matmul_ws`` (or its exact plain version), rescale to f32."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref_int8
    xq = quantize_symmetric(x.reshape(-1, x.shape[-1]))
    mm = ops.matmul_ws if use_kernel else matmul_ref_int8
    acc = mm(xq.values, wq.values)
    out = acc.to(torch.float32) * xq.scale * wq.scale.reshape(1, -1)
    return out.reshape(*x.shape[:-1], wq.values.shape[-1])


def quantize_params_for_serving(params, axis: int = 0):
    """Per-output-channel int8 quantization of every 2-D weight matrix."""
    from repro_torch.layers.common import tree_map
    return tree_map(lambda p: quantize_symmetric(p, axis=axis)
                    if p.dim() == 2 else p, params)


def _stacked(spec) -> bool:
    return spec is not None and bool(spec.axes) and spec.axes[0] == "stack"


def quantize_weight_specs(pspecs, exclude: tuple = ("embedding",)):
    """ParamSpec tree → w8 spec tree: every ≥2-D f32 weight (not counting
    a leading ``stack`` dimension) becomes {"q": int8 spec, "s": f32 scale
    spec}.  The scale varies along the last dimension only, which the
    consuming einsum never contracts, so rescaling after the int8 dot is
    exact; stacked weights keep their ``stack`` dimension in the scale
    (per-layer scales).  Subtrees named in ``exclude`` stay as they are
    (the embedding table's last dimension is contracted by the tied
    logits)."""
    from repro_torch.layers.common import ParamSpec, tree_map

    def f(s: ParamSpec):
        if len(s.shape) - _stacked(s) < 2 or s.dtype != "float32":
            return s
        lead = s.shape[0] if _stacked(s) else 1
        lead_ax = s.axes[0] if lead != 1 else None
        mid = len(s.shape) - 2
        return {"q": ParamSpec(s.shape, s.axes, dtype="int8"),
                "s": ParamSpec((lead,) + (1,) * mid + (s.shape[-1],),
                               (lead_ax,) + (None,) * mid + (s.axes[-1],),
                               dtype="float32")}

    return {k: (v if k in exclude else tree_map(f, v))
            for k, v in pspecs.items()}


def quantize_weights(params, pspecs=None, exclude: tuple = ("embedding",)):
    """Materialized f32 (or bf16) params → the w8 tree: every ≥2-D float
    weight becomes {"q": int8, "s": f32 scale over the last dimension}.

    With ``pspecs`` (the unquantized ParamSpec tree), a leaf whose spec
    leads with the ``stack`` dimension is quantized layer by layer: its
    scale has shape [G, 1, ..., 1, last], as ``quantize_weight_specs``
    declares, and each layer's values are what ``quantize_symmetric``
    gives that layer alone.  The reference's ``quantize_weights`` reduces
    over the stack dimension too, which gives one scale of leading size 1
    for all G layers: equal to this wherever G = 1, and at G > 1 a tree
    its own ``lm.prefill`` cannot scan.  Stacked 1-D tensors (norm scales)
    stay as they are.  Without ``pspecs`` every float tensor of ≥ 2 dims
    is quantized over all but its last dimension."""
    from repro_torch.layers.common import tree_map

    def decide(p: torch.Tensor, spec=None) -> Any:
        if p.dtype not in (torch.float32, torch.bfloat16):
            return p
        if p.dim() - _stacked(spec) < 2:
            return p
        if not _stacked(spec):
            q = quantize_symmetric(p, axis=tuple(range(p.dim() - 1)))
            return {"q": q.values, "s": q.scale.to(torch.float32)}
        # one layer at a time: the temporaries stay one layer's size
        values = torch.empty(p.shape, dtype=torch.int8, device=p.device)
        scale = torch.empty((p.shape[0],) + (1,) * (p.dim() - 2)
                            + (p.shape[-1],), dtype=torch.float32,
                            device=p.device)
        for g in range(p.shape[0]):
            q = quantize_symmetric(p[g], axis=tuple(range(p.dim() - 2)))
            values[g], scale[g] = q.values, q.scale
        return {"q": values, "s": scale}

    out = {}
    for k, v in params.items():
        if k in exclude:
            out[k] = v
        elif pspecs is not None:
            out[k] = tree_map(decide, v, pspecs[k])
        else:
            out[k] = tree_map(decide, v)
    return out


def _gemm_split(subscripts: str, x_ndim: int, w_ndim: int):
    """The number of contracted dimensions of ``subscripts`` (x,w->out),
    whose x is [batch..., contracted...] and w [contracted..., free...]
    with out [batch..., free...]; anything else raises."""
    lhs, out = subscripts.replace(" ", "").split("->")
    xs, ws = lhs.split(",")
    nc = len(set(xs) & set(ws))
    if (len(xs), len(ws)) != (x_ndim, w_ndim) or nc == 0 or \
            xs[len(xs) - nc:] != ws[:nc] or out != xs[:len(xs) - nc] + ws[nc:]:
        raise ValueError(f"w8 einsum {subscripts!r} is not a GEMM over x's "
                         f"trailing and w's leading dimensions")
    return nc


def w8_einsum(subscripts: str, x: torch.Tensor, w_q: torch.Tensor,
              w_s: torch.Tensor, compute_dtype="bfloat16") -> torch.Tensor:
    """True int8 × int8 GEMM (the paper's datapath): per-tensor dynamic
    activation quantization, the int8 product with int32 accumulation on
    ``matmul_ws`` (x flattened to [M, K], w to [K, N]; on a CPU tensor its
    exact plain version), then ``acc·sx·w_s`` in f32 and one cast, in the
    reference's order.  The activation scale stays on the device: nothing
    here synchronises."""
    from repro_torch.kernels import ops
    from repro_torch.layers.common import torch_dtype
    nc = _gemm_split(subscripts, x.dim(), w_q.dim())
    lead, free = x.shape[:x.dim() - nc], w_q.shape[nc:]
    k = math.prod(w_q.shape[:nc])
    xq = quantize_symmetric(x)
    acc = ops.matmul_ws(xq.values.reshape(-1, k), w_q.reshape(k, -1))
    out = (acc.reshape(*lead, *free).to(torch.float32) * xq.scale
           * w_s.reshape(-1).to(torch.float32))
    return out.to(torch_dtype(compute_dtype))


# ---------------------------------------------------------------------------
# Error-feedback compressor (for gradient all-reduce compression)
# ---------------------------------------------------------------------------


class EFState(NamedTuple):
    residual: torch.Tensor         # f32 carry of quantization error


def ef_compress(g: torch.Tensor,
                state: Optional[EFState]) -> Tuple[Quantized, EFState]:
    """int8-compress a gradient with error feedback: the quantization error
    is carried into the next step so compression noise is unbiased over
    time (Seide et al. 1-bit SGD lineage)."""
    gf = g.to(torch.float32)
    if state is not None:
        gf = gf + state.residual
    q = quantize_symmetric(gf)
    err = gf - q.dequantize()
    return q, EFState(residual=err)


def ef_decompress(q: Quantized) -> torch.Tensor:
    return q.dequantize()
