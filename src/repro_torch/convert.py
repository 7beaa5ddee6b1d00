"""Carry weights and quantized networks across from the reference package.

Inputs are plain numpy (``np.asarray`` of the reference's arrays), so this
module needs no JAX: ``params_to_torch`` takes a float ``params`` list (one
``{"w", "b"}`` dict or None per node), ``train_state_to_torch`` a trainer's
state (params, AdamW moments, step), ``quantized_network`` the arrays of a
reference ``QuantizedNetwork`` and ``lm_params_to_torch`` an LM parameter
tree, and all return the port's objects on a device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.network import NetworkPlan, QuantizedNetwork
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.layers.common import tree_map


def _tensor(a, device: torch.device, dtype=None) -> Optional[torch.Tensor]:
    if a is None:
        return None
    arr = np.array(a, copy=True)
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def params_to_torch(params: Sequence[Optional[dict]],
                    device: DeviceLike = None) -> List[Optional[dict]]:
    """Float parameters (numpy ``{"w", "b"}`` per node, None elsewhere) →
    float32 tensors on ``device``."""
    dev = resolve_device(device)
    return [None if p is None else
            {k: _tensor(v, dev, torch.float32) for k, v in p.items()}
            for p in params]


def train_state_to_torch(state, device: DeviceLike = None):
    """A reference ``TrainState`` as numpy (``params``, ``opt_state`` with
    its ``m`` and ``v`` lists mirroring the params, the int32 ``step``) →
    the port's ``training.TrainState`` on ``device``, so one step runs from
    the same state in both packages."""
    from repro_torch.core.training import TrainState
    dev = resolve_device(device)
    return TrainState(
        params=params_to_torch(state.params, dev),
        opt_state={k: params_to_torch(state.opt_state[k], dev)
                   for k in ("m", "v")},
        step=_tensor(np.asarray(state.step), dev, torch.int32))


def quantized_network(plan: NetworkPlan, *, weights, biases, requants,
                      in_scale, out_dequant, merge_scales=(),
                      per_channel: bool = False,
                      device: DeviceLike = None) -> QuantizedNetwork:
    """The port's ``QuantizedNetwork`` for ``plan`` from a reference
    qnet's arrays (int8 weights, int32 biases, f32 requant / merge scales,
    ``in_scale`` and ``out_dequant``), on ``device``."""
    dev = resolve_device(device)
    if len(weights) != len(plan.layers):
        raise ValueError(f"weights needs one entry per node "
                         f"({len(plan.layers)}), got {len(weights)}")
    return QuantizedNetwork(
        plan,
        tuple(_tensor(w, dev, torch.int8) for w in weights),
        tuple(_tensor(b, dev, torch.int32) for b in biases),
        tuple(_tensor(r, dev, torch.float32) for r in requants),
        _tensor(in_scale, dev, torch.float32),
        _tensor(out_dequant, dev, torch.float32),
        per_channel=per_channel,
        merge_scales=tuple(
            None if ms is None else
            tuple(_tensor(s, dev, torch.float32) for s in ms)
            for ms in merge_scales))


def lm_params_to_torch(tree: Any, device: DeviceLike = None) -> Any:
    """An LM parameter tree of numpy arrays (the reference's
    ``materialize``d params through ``np.asarray``, nested dicts with the
    stacked ``blocks``) → the same tree of tensors on ``device``, leaf for
    leaf, dtypes kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)
