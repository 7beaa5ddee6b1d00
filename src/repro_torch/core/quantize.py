"""Symmetric int8 quantization for the conv datapath and the QAT
straight-through estimators (counterpart of the conv-path half of
``repro.core.quantize``).

Every scale is a float32 tensor computed with the same f32 operations in
the same order as the reference, so scales, int8 values and biases are
bit-equal to it given bit-equal inputs."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

Axis = Optional[Union[int, Sequence[int]]]


class Quantized(NamedTuple):
    values: torch.Tensor           # int8
    scale: torch.Tensor            # f32; per-tensor [] or keepdims per-channel


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
