"""The LM train step: loss, gradients, AdamW update (counterpart of
``repro.train.train_step``).

``make_train_step`` returns ``train_step(state, batch) → (state,
metrics)`` with state = {"params", "opt": {"m", "v"}, "step"}, ``step``
an int32 0-d tensor on the state's device.  The gradients come from
``torch.autograd.grad`` over the parameter leaves (detached aliases that
require grad, so the state's own tensors never do), and the update is
``adamw_update_``: params, m and v are written in place, and the returned
state holds the same tensors with ``step`` one higher.  A caller that
needs the state before the step keeps a copy.

``accum_steps`` > 1 runs the microbatches in the reference's order: the
batch split along its leading axis, each microbatch's gradients added to
f32 sums that start at zero, the sums and the losses scaled by
1/accum_steps at the end.  The live activations are one microbatch's.

Sharded: with ``act_rules`` (``ShardingPlan.acts``) under ``use_mesh``,
the state's leaves are DTensors (``sharding.device_put`` on
``ShardingPlan.param_shardings``), the batch is placed batch-sharded
(``lconstraint``, as ``jax.jit``'s in_shardings place it), each gradient
is placed as its parameter is (a reduce-scatter under FSDP), the update
runs on local shards (``adamw_update_``) and the metrics come back as
whole values on every rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import is_dtensor
from repro_torch.layers.common import activate_rules, lconstraint, tree_map
from repro_torch.models import lm
from repro_torch.optim.adamw import (AdamWConfig, adamw_update_, full_value,
                                     opt_state_specs, tree_leaves)

PyTree = Any


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token NLL in f32.  logits: [B,S,V]; labels: [B,S]; a label
    equal to ``ignore_id`` carries no loss."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    take = torch.gather(logp, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    mask = (labels != ignore_id).to(torch.float32)
    return -torch.sum(take * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _loss_fn(params, batch, cfg: ArchConfig):
    logits, aux = lm.forward_train(params, batch, cfg)
    # (a VLM's logits already cover only the text suffix: forward_train)
    loss = cross_entropy(logits, batch["labels"])
    return loss + aux, (loss, aux)


def _unflatten(like: PyTree, leaves) -> PyTree:
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _grads(params, batch, cfg: ArchConfig):
    """→ (total, loss, aux, gradient leaves in ``tree_leaves`` order)."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    total, (loss, aux) = _loss_fn(_unflatten(params, live), batch, cfg)
    grads = torch.autograd.grad(total, live, allow_unused=True,
                                materialize_grads=True)
    if is_dtensor(*grads):
        # each gradient on its parameter's layout (FSDP: a reduce-scatter)
        from repro_torch.distributed.sharding import place
        grads = [place(g, p) for g, p in zip(grads, live)]
    return total.detach(), loss.detach(), aux.detach(), list(grads)


def _constrain_batch(batch):
    return {k: lconstraint(t, ("batch",) + (None,) * (t.dim() - 1))
            for k, t in batch.items()}


def make_train_step(cfg: ArchConfig, hp: AdamWConfig,
                    act_rules: Optional[Dict] = None,
                    accum_steps: int = 1):
    """Returns train_step(state, batch) → (state, metrics); metrics are
    0-d f32 tensors: ``loss``, ``aux_loss``, ``total_loss``, ``lr``,
    ``grad_norm``."""

    def train_step(state, batch):
        params = state["params"]
        with activate_rules(act_rules):
            if accum_steps == 1:
                total, loss, aux, grads = _grads(
                    params, _constrain_batch(batch), cfg)
            else:
                # a batch-sharded DTensor is taken whole first: each
                # microbatch is then placed over the batch axes by
                # _constrain_batch, as jax.jit reshards the reshape
                mb = {k: full_value(t).reshape(
                    accum_steps, t.shape[0] // accum_steps, *t.shape[1:])
                    for k, t in batch.items()}
                grads = [torch.zeros_like(p, dtype=torch.float32)
                         for p in tree_leaves(params)]
                zero = torch.zeros((), dtype=torch.float32,
                                   device=state["step"].device)
                total = loss = aux = zero
                for i in range(accum_steps):
                    tt, ll, aa, g = _grads(params, _constrain_batch(
                        {k: t[i] for k, t in mb.items()}), cfg)
                    for acc, gi in zip(grads, g):
                        acc.add_(gi.to(torch.float32))
                    del g
                    total, loss, aux = total + tt, loss + ll, aux + aa
                scale = 1.0 / accum_steps
                for acc in grads:
                    acc.mul_(scale)
                total, loss, aux = total * scale, loss * scale, aux * scale
            om = adamw_update_(params, _unflatten(params, grads),
                               state["opt"], state["step"], hp)
        metrics = {k: full_value(v) for k, v in (
            ("loss", loss), ("aux_loss", aux), ("total_loss", total),
            *om.items())}
        return ({"params": params, "opt": state["opt"],
                 "step": state["step"] + 1}, metrics)

    return train_step


def make_eval_step(cfg: ArchConfig, act_rules: Optional[Dict] = None):
    """Returns eval_step(params, batch) → {"loss", "aux_loss"}, run
    without autograd."""

    @torch.no_grad()
    def eval_step(params, batch):
        with activate_rules(act_rules):
            _, (loss, aux) = _loss_fn(params, batch, cfg)
        return {"loss": loss, "aux_loss": aux}
    return eval_step


def init_state_specs(cfg: ArchConfig):
    """ParamSpec tree of the train state's params and AdamW moments."""
    pspecs = lm.param_specs(cfg)
    return {"params": pspecs, "opt": opt_state_specs(pspecs)}
