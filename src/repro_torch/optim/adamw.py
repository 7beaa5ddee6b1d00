"""AdamW as plain tensor functions (counterpart of the update half of
``repro.optim.adamw``).

A parameter tree is nested lists, tuples and dicts of tensors with None
for parameter-free entries (the conv trainer's ``[{"w", "b"} or None, ...]``);
its leaves are visited in the reference's flatten order (dict keys
sorted, None skipped), so norms sum in the same order.  The update is the
reference's, in its order: clip by the global norm, then the
bias-corrected moments, then ``p − lr·(m̂/(√v̂ + eps) + wd·p)``.
``torch.optim.AdamW`` decays the weights before the moment step, which is
another update.

Two forms of the update share its per-leaf arithmetic (``_upd``):

* ``adamw_update`` returns new params and moments (the conv trainer's);
* ``adamw_update_`` writes them into the state's own tensors, for the LM
  state, where a second copy does not fit beside the first (llama3.2-3b's
  f32 params, grads, m and v take 51.4 GB).  The clip scales the grads in
  place, and each leaf is updated in row blocks of at most ``UPDATE_ROWS``
  elements (one layer's slice of a stacked leaf), so the update's
  transient memory is one block's temporaries.  The arithmetic is
  elementwise, so the values are ``adamw_update``'s.

``opt_state_specs`` gives the LM's m and v as f32 zero specs mirroring
the parameter specs.

Sharded state (DTensor leaves, ``distributed.sharding``): the global norm
is taken by DTensor's ops, which reduce it over the mesh, and the update
runs on each leaf's local shard, its gradient first placed as the
parameter is (an FSDP weight's partial gradient is reduce-scattered
there).  The update is elementwise, so a shard's values are the whole
leaf's; on a one-rank mesh every local shard is the whole tensor and the
update is bit-equal to the unsharded one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch

from repro_torch.layers.common import ParamSpec, spec_map
from repro_torch.optim.schedule import SCHEDULES

PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "warmup_cosine"


def opt_state_specs(param_specs: PyTree) -> Dict[str, PyTree]:
    """m and v mirror the parameter specs (same shapes and logical axes),
    as f32 zeros."""
    def f32(s: ParamSpec):
        return ParamSpec(s.shape, s.axes, dtype="float32", init="zeros")
    return {"m": spec_map(f32, param_specs), "v": spec_map(f32, param_specs)}


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` leaf by leaf over trees of one structure; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree: PyTree) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in f32."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: PyTree, max_norm: float):
    """``tree`` scaled to a global norm of at most ``max_norm`` → (tree,
    its norm before clipping)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, tree), norm


def _schedule(step: torch.Tensor, hp: AdamWConfig):
    """→ (lr, c1, c2): the step's rate and bias corrections."""
    lr = SCHEDULES[hp.schedule](step, peak_lr=hp.peak_lr,
                                warmup_steps=hp.warmup_steps,
                                total_steps=hp.total_steps)
    t = step.to(torch.float32) + 1.0
    return lr, 1.0 - hp.b1 ** t, 1.0 - hp.b2 ** t


def _upd(p, g, m, v, lr, c1, c2, hp: AdamWConfig):
    """One leaf's update → (new p, new m, new v)."""
    m_new = hp.b1 * m + (1 - hp.b1) * g
    v_new = hp.b2 * v + (1 - hp.b2) * torch.square(g)
    mhat = m_new / c1
    vhat = v_new / c2
    delta = mhat / (torch.sqrt(vhat) + hp.eps)
    p32 = p.to(torch.float32)
    p_new = p32 - lr * (delta + hp.weight_decay * p32)
    return p_new.to(p.dtype), m_new, v_new


def adamw_update(params: PyTree, grads: PyTree, opt_state: Dict[str, PyTree],
                 step: torch.Tensor, hp: AdamWConfig):
    """One AdamW step → (new params, new {"m", "v"}, {"lr", "grad_norm"}).
    ``step`` is the int32 count of steps taken so far."""
    lr, c1, c2 = _schedule(step, hp)
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if hp.grad_clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, hp.grad_clip_norm)
    else:
        gnorm = global_norm(grads)
    out = tree_map(lambda p, g, m, v: _upd(p, g, m, v, lr, c1, c2, hp),
                   params, grads, opt_state["m"], opt_state["v"])
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return (pick(0), {"m": pick(1), "v": pick(2)},
            {"lr": lr, "grad_norm": gnorm})


def _local(t: torch.Tensor, like=None) -> torch.Tensor:
    """A DTensor's local shard (placed as ``like`` first, where given); a
    plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    if like is not None:
        from repro_torch.distributed.sharding import place
        t = place(t, like)
    return t.to_local()


def full_value(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


# the most elements ``adamw_update_`` updates at once: a layer's slice of
# llama3.2-3b's stacked MLP weights (3072 × 8192) is one block
UPDATE_ROWS = 1 << 25


def _row_blocks(t: torch.Tensor):
    """Views of ``t`` along its leading axis, each of at most
    ``UPDATE_ROWS`` elements (at least one row)."""
    if t.dim() == 0:
        return [t]
    rows = max(1, UPDATE_ROWS // max(t[0].numel(), 1))
    return t.split(rows)


@torch.no_grad()
def adamw_update_(params: PyTree, grads: PyTree,
                  opt_state: Dict[str, PyTree], step: torch.Tensor,
                  hp: AdamWConfig) -> Dict[str, torch.Tensor]:
    """``adamw_update`` in place → {"lr", "grad_norm"}: the new params, m
    and v are written into ``params`` and ``opt_state``'s tensors and the
    clip scales f32 ``grads`` in place (see the module note); DTensor
    leaves are updated on their local shards."""
    lr, c1, c2 = _schedule(_local(step), hp)
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    gnorm = full_value(global_norm(grads))
    leaves = [tree_leaves(t) for t in (params, grads, opt_state["m"],
                                       opt_state["v"])]
    local = [[_local(t, like) for t, like in zip(ts, leaves[0])]
             for ts in leaves]
    if hp.grad_clip_norm > 0:
        scale = _clip_scale(gnorm, hp.grad_clip_norm)
        for g in local[1]:
            g.mul_(scale)
    for p, g, m, v in zip(*local):
        for blocks in zip(*(_row_blocks(t) for t in (p, g, m, v))):
            for dst, new in zip((blocks[0], blocks[2], blocks[3]),
                                _upd(*blocks, lr, c1, c2, hp)):
                dst.copy_(new)
    return {"lr": lr, "grad_norm": gnorm}
