"""AdamW as plain tensor functions (counterpart of the update half of
``repro.optim.adamw``).

A parameter tree is nested lists, tuples and dicts of tensors with None
for parameter-free entries (the conv trainer's ``[{"w", "b"} or None, ...]``);
its leaves are visited in the reference's flatten order (dict keys
sorted, None skipped), so norms sum in the same order.  The update is the
reference's, in its order: clip by the global norm, then the
bias-corrected moments, then ``p − lr·(m̂/(√v̂ + eps) + wd·p)``.
``torch.optim.AdamW`` decays the weights before the moment step, which is
another update.  ``opt_state_specs`` (the LM's sharded state) is not
ported (ROADMAP A14.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch

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


def clip_by_global_norm(tree: PyTree, max_norm: float):
    """``tree`` scaled to a global norm of at most ``max_norm`` → (tree,
    its norm before clipping)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def adamw_update(params: PyTree, grads: PyTree, opt_state: Dict[str, PyTree],
                 step: torch.Tensor, hp: AdamWConfig):
    """One AdamW step → (new params, new {"m", "v"}, {"lr", "grad_norm"}).
    ``step`` is the int32 count of steps taken so far."""
    lr = SCHEDULES[hp.schedule](step, peak_lr=hp.peak_lr,
                                warmup_steps=hp.warmup_steps,
                                total_steps=hp.total_steps)
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if hp.grad_clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, hp.grad_clip_norm)
    else:
        gnorm = global_norm(grads)
    t = step.to(torch.float32) + 1.0
    c1 = 1.0 - hp.b1 ** t
    c2 = 1.0 - hp.b2 ** t

    def upd(p, g, m, v):
        m_new = hp.b1 * m + (1 - hp.b1) * g
        v_new = hp.b2 * v + (1 - hp.b2) * torch.square(g)
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + hp.eps)
        p32 = p.to(torch.float32)
        p_new = p32 - lr * (delta + hp.weight_decay * p32)
        return p_new.to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return (pick(0), {"m": pick(1), "v": pick(2)},
            {"lr": lr, "grad_norm": gnorm})
