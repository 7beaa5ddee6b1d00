"""Gradient all-reduce compression (int8 + error feedback; counterpart of
``repro.distributed.compression``).

The paper's 8-bit datapath, applied to the distributed-optimization layer:
the data-parallel gradient reduction is int8-compressed and the
quantization error carried into the next step (error feedback keeps the
noise unbiased over time).

Two integration modes:
* value-level (``compress_grads``): compress→decompress around the
  optimizer, leaf by leaf, bit-equal to the reference's;
* wire-level (``compressed_psum``): the int8 payload summed as int32 and
  the per-tensor scale maxed over one mesh dim's process group, the
  reference's ``psum`` / ``pmax`` inside ``shard_map``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.quantize import EFState, ef_compress, quantize_symmetric
from repro_torch.layers.common import active_mesh, tree_map
from repro_torch.optim.adamw import tree_leaves

PyTree = Any


def init_ef_state(params: PyTree) -> PyTree:
    """A zero f32 residual per leaf of ``params``."""
    return tree_map(lambda p: EFState(residual=torch.zeros(
        p.shape, dtype=torch.float32, device=p.device)), params)


def compress_grads(grads: PyTree,
                   ef: Optional[PyTree]) -> Tuple[PyTree, PyTree]:
    """int8-round-trip every gradient leaf with error feedback.
    Returns (decompressed_grads, new_ef_state)."""
    leaves = tree_leaves(grads)
    states = ([s for s in _ef_leaves(ef)] if ef is not None
              else [None] * len(leaves))
    outs, new = [], []
    for g, s in zip(leaves, states):
        q, ns = ef_compress(g, s)
        outs.append(q.dequantize().to(g.dtype))
        new.append(ns)
    it_g, it_s = iter(outs), iter(new)
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_s), grads))


def _ef_leaves(ef: PyTree):
    """The ``EFState`` leaves of ``ef`` in flatten order."""
    if isinstance(ef, EFState):
        return [ef]
    if isinstance(ef, dict):
        return [s for k in sorted(ef) for s in _ef_leaves(ef[k])]
    if isinstance(ef, (list, tuple)):
        return [s for v in ef for s in _ef_leaves(v)]
    raise TypeError(f"not an EFState tree: {type(ef)}")


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Wire-level hook (call it under ``use_mesh``, as the reference's
    under ``shard_map``): quantize this rank's ``x`` to int8, sum the int8
    payload as int32 and take the largest scale over mesh dim
    ``axis_name``'s group, dequantize.  Sum of int8 shards fits int32;
    the max scale keeps the reconstruction conservative."""
    mesh = active_mesh()
    if mesh is None:
        raise ValueError("compressed_psum runs under use_mesh(mesh)")
    group = mesh.get_group(axis_name)
    q = quantize_symmetric(x)
    acc = q.values.to(torch.int32)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    scale = q.scale.clone()
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    return acc.to(torch.float32) * scale
