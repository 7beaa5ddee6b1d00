"""Mixture-of-Experts feed-forward (counterpart of ``repro.layers.moe``):
GShard-style capacity and a scatter-min dispatch map.

Dataflow, step for step the reference's:

1. router logits in f32 → softmax → the top-k experts of each token,
   their gates renormalised (:func:`route`);
2. position-in-expert by a per-group exclusive cumulative count (groups
   are the batch rows unless ``num_groups`` says otherwise), and
   ``keep = pos < C`` with ``C = _capacity(...)``: overflow choices are
   dropped;
3. a scatter-min of the kept choices' row numbers into a ``[G, E·C]``
   index map (``scatter_reduce_(..., "amin")``, the reference's
   ``.at[].min(mode="drop")``), then one gather of the tokens into a
   ``[G, E, C, D]`` buffer whose empty slots read a zero pad row;
4. the three expert GEMMs as batched einsums in the compute dtype (the
   reference's ``jnp.einsum``: no ``matmul_ws`` on this path);
5. the gather back, masked by ``keep``, and the gate-weighted sum over
   the k choices in f32; the shared experts (DeepSeekMoE) through
   ``apply_mlp``, which ``gemm_backend="pallas_ws"`` puts on ``matmul_ws``.

Ties in the router's top-k go to the lower expert index, as
``jax.lax.top_k`` breaks them: a stable descending sort, where
``torch.topk`` promises no order.  ``lconstraint`` keeps the reference's
annotations and does nothing (see ``layers.common``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.layers.common import (ParamSpec, cast, lconstraint,
                                       torch_dtype)
from repro_torch.layers.mlp import _act, apply_mlp, mlp_specs


def moe_specs(cfg):
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_ff, m.num_experts
    specs = {
        "router": ParamSpec((d, e), ("embed", "experts"), init="fan_in"),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "mlp"),
                             fan_in_axes=(1,)),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "mlp"),
                           fan_in_axes=(1,)),
        "wo": ParamSpec((e, f, d), ("experts", "mlp", "embed"),
                        fan_in_axes=(1,)),
    }
    if m.num_shared:
        # DeepSeekMoE: shared experts form one dense gated MLP
        specs["shared"] = mlp_specs(cfg, d_ff=m.num_shared * f)
    return specs


def _capacity(tokens_per_group: int, m) -> int:
    """Slots an expert holds in a group: the expected count times the
    capacity factor, truncated, rounded up to 8 and at least 8."""
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One MoE call's routing: f32 gates and their experts [G, Tg, K],
    the Switch aux loss, and per flattened choice [G, Tg·K] the buffer
    slot (``expert·C + pos``, pos 0 where dropped) and whether it was
    kept (``pos < C``)."""
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    aux: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor


def route(router: torch.Tensor, xg: torch.Tensor, m, capacity: int, *,
          train: bool = False,
          rng: Optional[torch.Generator] = None) -> Routing:
    """The router of ``apply_moe`` for tokens ``xg`` [G, Tg, D]."""
    E, K = m.num_experts, m.top_k
    G, Tg = xg.shape[:2]
    logits = torch.einsum("gtd,de->gte", cast(xg, torch.float32),
                          cast(router, torch.float32))
    if train and m.router_jitter and rng is not None:
        logits = logits + m.router_jitter * torch.randn(
            logits.shape, generator=rng, device=logits.device)
    probs = torch.softmax(logits, dim=-1)                       # [G,Tg,E]
    # top-k with ties to the lower index (jax.lax.top_k's order)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :K], gate_idx[..., :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # load-balancing auxiliary loss (Switch/GShard form)
    me = probs.mean(dim=1)                                      # [G,E]
    ce = torch.nn.functional.one_hot(gate_idx[..., 0], E).float().mean(1)
    aux = (me * ce).sum(-1).mean() * E * m.aux_loss_weight

    # position in the expert: the choices of the same expert before this
    # one in the group, in (token, k) order.  The one-hot is laid out
    # [G, E, TK] so that the count runs along the innermost dimension: a
    # CUDA scan along an outer one gives each of the E columns one thread
    # that walks all TK rows (9 ms a layer at TK = 32,768)
    flat_idx = gate_idx.reshape(G, Tg * K)                      # [G,TK]
    onehot = torch.nn.functional.one_hot(flat_idx, E).to(
        torch.int32).transpose(1, 2).contiguous()               # [G,E,TK]
    pos_all = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    pos = torch.gather(pos_all, 1, flat_idx[:, None, :])[:, 0]
    keep = pos < capacity
    slot = flat_idx * capacity + torch.where(keep, pos, 0)
    return Routing(gate_vals, gate_idx, aux, slot, keep)


def apply_moe(params, x: torch.Tensor, cfg, *, train: bool = False,
              rng: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] → (out [B, S, D] in the compute dtype, aux_loss f32
    scalar).  ``rng`` draws the router jitter, which only a training call
    (``train=True``) with ``router_jitter`` set adds."""
    m = cfg.moe
    B, S, D = x.shape
    G = m.num_groups or B
    Tg = (B * S) // G
    E, K = m.num_experts, m.top_k
    C = _capacity(Tg, m)
    dt = cfg.compute_dtype

    xg = lconstraint(x.reshape(G, Tg, D), ("batch", None, "embed"))
    r = route(params["router"], xg, m, C, train=train, rng=rng)

    # dispatch: scatter only the int index map; the activations move by
    # gathers (the reference's design for sharding, kept for parity)
    TK = Tg * K
    sentinel = TK                                   # → the zero pad row
    rows = torch.where(r.keep, torch.arange(TK, device=x.device)[None, :],
                       sentinel)
    slot_to_row = torch.full((G, E * C), sentinel, dtype=rows.dtype,
                             device=x.device)
    slot_to_row.scatter_reduce_(1, r.slot, rows, reduce="amin",
                                include_self=True)
    token_of_slot = torch.where(slot_to_row < sentinel,
                                torch.div(slot_to_row, K,
                                          rounding_mode="floor"), Tg)
    xpad = torch.cat([cast(xg, dt), xg.new_zeros((G, 1, D),
                                                 dtype=torch_dtype(dt))],
                     dim=1)
    buf = torch.gather(xpad, 1, token_of_slot[..., None].expand(G, E * C, D))
    buf = lconstraint(buf.reshape(G, E, C, D),
                      ("batch", "experts", None, "embed"))

    # the expert GEMMs (expert parallel in the reference's sharding)
    wg, wu, wo = (cast(params[k], dt) for k in ("wi_gate", "wi_up", "wo"))
    h = _act(cfg.mlp_act)(torch.einsum("gecd,edf->gecf", buf, wg))
    h = h * torch.einsum("gecd,edf->gecf", buf, wu)
    h = lconstraint(h, ("batch", "experts", None, "mlp"))
    yb = torch.einsum("gecf,efd->gecd", h, wo)                  # [G,E,C,D]

    # combine: gather back, drop the overflow, gate-weighted sum over K
    yfl = yb.reshape(G, E * C, D)
    got = torch.gather(yfl, 1, r.slot[..., None].expand(G, TK, D))
    got = torch.where(r.keep[..., None], got, 0).reshape(G, Tg, K, D)
    y = torch.einsum("gtkd,gtk->gtd", got.float(), r.gate_vals.float())
    y = cast(y, dt).reshape(B, S, D)

    if m.num_shared:                                # always-on experts
        y = y + apply_mlp(params["shared"], x, cfg)
    return lconstraint(y, ("batch", "seq_r", "embed")), r.aux
