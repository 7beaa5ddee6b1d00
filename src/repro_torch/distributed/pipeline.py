"""GPipe-style pipeline parallelism over a mesh dim (counterpart of
``repro.distributed.pipeline``): explicit point-to-point sends in place of
``shard_map`` + ``ppermute``.

The layer stack is split into ``n_stages`` groups laid out along a mesh
dim; each rank holds its own stage's params.  Schedule: classic GPipe.
``n_micro`` microbatches flow through ``n_stages + n_micro - 1`` ticks; at
tick t, stage s computes microbatch ``t - s`` if it is in range, then
passes its activation to stage s+1 (``ppermute``, every rank sending and
receiving once a tick).  The last stage collects the outputs, and a sum
over the dim hands them to every rank.  Bubble fraction =
(n_stages-1)/(n_stages+n_micro-1), reported by ``bubble_fraction``.

Everything is differentiable: ``ppermute``'s backward sends the cotangent
the other way round the ring, and the closing sum's backward is the
identity (every rank computes its loss from the same summed output, so
each stage's own output receives that loss's cotangent once).  The
backward's sends pair up only if every rank runs the same ``ppermute``
backwards in the same order, so every rank builds the same graph: as in
the reference, each tick runs the stage on every rank and selects with
``where`` (input stream or wire, active or zero, collect or keep), which
routes zero cotangents to the branch not taken.  The gradient with
respect to ``x`` arrives on stage 0, the only stage that reads it; the
others get zeros.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.layers.common import tree_map


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages + n_micro - 1)


def _ring_exchange(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``t`` to the rank ``shift`` steps round ``group``'s ring and
    receive the tensor coming from ``shift`` steps back: one
    ``all_to_all_single`` whose only non-empty splits are those two (gloo
    carries it on CUDA tensors where it aborts on point-to-point sends;
    ``tools/collectives_probe.py``)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst, src = (me + shift) % n, (me - shift) % n
    flat = t.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    size = flat.numel()
    dist.all_to_all_single(
        out, flat, output_split_sizes=[size if r == src else 0
                                       for r in range(n)],
        input_split_sizes=[size if r == dst else 0 for r in range(n)],
        group=group)
    return out.reshape(t.shape)


class _PPermute(torch.autograd.Function):
    """``jax.lax.ppermute`` with the ring permutation i → i+1."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _ring_exchange(t, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring_exchange(g, ctx.group, -1), None


class _PSum(torch.autograd.Function):
    """The sum over ``group`` of a per-rank value whose result every rank
    then uses alike (see the module note on its backward)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def ppermute(t: torch.Tensor, group) -> torch.Tensor:
    return _PPermute.apply(t, group)


def _stage_params(stage_params, mesh, axis: str):
    """This rank's stage of a tree whose leaves are DTensors sharded over
    mesh dim ``axis`` on their leading (stage) axis: each local slice
    [1, ...] without its stage axis."""
    from torch.distributed.tensor import DTensor
    dim = list(mesh.mesh_dim_names).index(axis)

    def one(t):
        if not (isinstance(t, DTensor) and t.placements[dim].is_shard(0)
                and t.to_local().shape[0] == 1):
            raise TypeError(
                f"pipeline_apply takes stage params sharded one stage a "
                f"rank over mesh dim {axis!r} (sharding.device_put with "
                f"NamedSharding(mesh, P({axis!r})))")
        return t.to_local()[0]
    return tree_map(one, stage_params)


def pipeline_apply(stage_fn: Callable, stage_params, x, *, mesh, axis: str,
                   n_micro: int):
    """Run ``stage_fn`` as a pipeline over mesh dim ``axis``.

    stage_fn(params_one_stage, x_mb) → y_mb  (same shape as x_mb)
    stage_params: tree with a leading stage axis == the dim's size, its
      DTensor leaves sharded over it (each rank holds its own stage)
    x: [B, ...] with B divisible by n_micro, the same on every rank.
    Returns y: [B, ...] (the last stage's outputs, on every rank).
    """
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    s = dist.get_rank(group)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    x_mb = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    params = _stage_params(stage_params, mesh, axis)
    flag = lambda b: torch.tensor(b, device=x.device)  # noqa: E731
    first = flag(s == 0)
    buf = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        mb = t - s
        active = 0 <= mb < n_micro
        # stage 0 reads from the input stream; others from the wire
        y = stage_fn(params, torch.where(first, x_mb[min(t, n_micro - 1)],
                                         buf))
        y = torch.where(flag(active), y, torch.zeros_like(y))
        # last stage collects; everyone else forwards
        j = min(max(mb, 0), n_micro - 1)
        outs[j] = torch.where(flag(active and s == n_stages - 1), y, outs[j])
        buf = ppermute(y, group)
    y_mb = _PSum.apply(torch.stack(outs), group)
    return y_mb.reshape(B, *x.shape[1:])
