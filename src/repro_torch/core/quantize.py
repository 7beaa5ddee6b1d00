"""Symmetric int8 quantization for the conv datapath (counterpart of the
conv-path half of ``repro.core.quantize``).

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
