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
annotations (see ``layers.common``).

Sharded (``x`` a DTensor under ``use_mesh``): each rank routes its own
groups (the batch rows it holds; routing is per group) against the whole
router, dispatches to the experts it holds (the expert weights'
``experts`` dim sharded over ``model``, the expert parallelism of the
reference's rules) and combines their outputs into a partial sum that
one all-reduce over the expert-holding mesh dims completes.  The
dispatch map is data-dependent (``scatter_reduce_``), which DTensor has
no rule for, so the layer runs on local tensors, and autograd runs
through them: each boundary names the placements of its gradient.  The
rows' gradient is partial over the experts' dims (a rank's experts add
their share), an expert's weight gradient sums this rank's rows and is
partial over the rows' dims (the FSDP reduce-scatter completes it), and
the router, taken whole, gets a gradient partial over both, which
returns to its own placement.  The aux loss is each rank's mean over
its rows as a share of the rows' ranks' sum; every rank holding the same
rows computes the same value, so its gradient is scaled by one over the
experts' ranks and counted once.  Routing, gates and drops are the
unsharded layer's; a jitter draw is the unsharded one's, this rank's
rows of it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.layers.common import (ParamSpec, cast, lconstraint,
                                       torch_dtype, use_mesh)
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
          train: bool = False, rng: Optional[torch.Generator] = None,
          noise: Optional[torch.Tensor] = None) -> Routing:
    """The router of ``apply_moe`` for tokens ``xg`` [G, Tg, D]; the
    jitter is drawn from ``rng`` (``train`` set), or given as ``noise``
    [G, Tg, E] (the sharded layer's rows of the unsharded draw)."""
    E, K = m.num_experts, m.top_k
    G, Tg = xg.shape[:2]
    logits = torch.einsum("gtd,de->gte", cast(xg, torch.float32),
                          cast(router, torch.float32))
    if train and m.router_jitter and rng is not None:
        noise = torch.randn(logits.shape, generator=rng,
                            device=logits.device)
    if noise is not None:
        logits = logits + m.router_jitter * noise
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
    from repro_torch.device import is_dtensor
    if is_dtensor(x):
        return _apply_moe_sharded(params, x, cfg, train=train, rng=rng)
    m = cfg.moe
    B, S, D = x.shape
    G = m.num_groups or B
    Tg = (B * S) // G
    E, K = m.num_experts, m.top_k
    C = _capacity(Tg, m)
    dt = cfg.compute_dtype

    xg = lconstraint(x.reshape(G, Tg, D), ("batch", None, "embed"))
    r = route(params["router"], xg, m, C, train=train, rng=rng)

    y = _dispatch_experts(params, xg, r, cfg, C, 0, E)
    y = cast(y, dt).reshape(B, S, D)

    if m.num_shared:                                # always-on experts
        y = y + apply_mlp(params["shared"], x, cfg)
    return lconstraint(y, ("batch", "seq_r", "embed")), r.aux


def _dispatch_experts(params, xg, r: Routing, cfg, C: int, e0: int,
                      n_local: int) -> torch.Tensor:
    """The routed experts' output [G, Tg, D] in f32 for tokens ``xg``
    [G, Tg, D] under routing ``r``, from experts ``e0 .. e0 + n_local``
    (their weights the leading ``n_local`` of ``params``'s expert dim):
    every expert's on one device, a rank's own under a mesh, where the
    other experts' choices add zero."""
    m = cfg.moe
    G, Tg, D = xg.shape
    E, K = m.num_experts, m.top_k
    dt = cfg.compute_dtype
    # dispatch: scatter only the int index map; the activations move by
    # gathers (the reference's design for sharding, kept for parity)
    TK = Tg * K
    sentinel = TK                                   # → the zero pad row
    rows = torch.where(r.keep, torch.arange(TK, device=xg.device)[None, :],
                       sentinel)
    slot_to_row = torch.full((G, E * C), sentinel, dtype=rows.dtype,
                             device=xg.device)
    slot_to_row.scatter_reduce_(1, r.slot, rows, reduce="amin",
                                include_self=True)
    token_of_slot = torch.where(slot_to_row < sentinel,
                                torch.div(slot_to_row, K,
                                          rounding_mode="floor"), Tg)
    if n_local < E:
        token_of_slot = token_of_slot[:, e0 * C:(e0 + n_local) * C]
    xpad = torch.cat([cast(xg, dt), xg.new_zeros((G, 1, D),
                                                 dtype=torch_dtype(dt))],
                     dim=1)
    buf = torch.gather(xpad, 1, token_of_slot[..., None].expand(
        G, n_local * C, D))
    buf = lconstraint(buf.reshape(G, n_local, C, D),
                      ("batch", "experts", None, "embed"))

    # the expert GEMMs (expert parallel in the reference's sharding)
    wg, wu, wo = (cast(params[k], dt) for k in ("wi_gate", "wi_up", "wo"))
    h = _act(cfg.mlp_act)(torch.einsum("gecd,edf->gecf", buf, wg))
    h = h * torch.einsum("gecd,edf->gecf", buf, wu)
    h = lconstraint(h, ("batch", "experts", None, "mlp"))
    yb = torch.einsum("gecf,efd->gecd", h, wo)                  # [G,E,C,D]

    # combine: gather back, drop the overflow and other ranks' experts,
    # gate-weighted sum over K
    yfl = yb.reshape(G, n_local * C, D)
    slot, keep = r.slot, r.keep
    if n_local < E:
        mine = (slot >= e0 * C) & (slot < (e0 + n_local) * C)
        slot, keep = torch.where(mine, slot - e0 * C, 0), keep & mine
    got = torch.gather(yfl, 1, slot[..., None].expand(G, TK, D))
    got = torch.where(keep[..., None], got, 0).reshape(G, Tg, K, D)
    return torch.einsum("gtkd,gtk->gtd", got.float(), r.gate_vals.float())


def _apply_moe_sharded(params, x, cfg, train: bool = False,
                       rng: Optional[torch.Generator] = None):
    """``apply_moe`` of a DTensor ``x`` on local shards (see the module
    note) → (out, aux) as DTensors, differentiable: each boundary between
    DTensors and local tensors names the placements of its gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import from_local, local_block
    m = cfg.moe
    B, S, D = x.shape
    if m.num_groups not in (0, B):
        raise NotImplementedError(
            f"sharded MoE routes by batch row; num_groups={m.num_groups} "
            f"groups rows across ranks")
    mesh = x.device_mesh
    r, nd = Replicate(), mesh.ndim
    # the batch rows stay where they are; every other dim is gathered
    tok = [p if p.is_shard(0) else r for p in x.placements]
    weights = {}
    for k in ("wi_gate", "wi_up", "wo"):
        w = params[k]
        if not isinstance(w, DTensor):
            w = DTensor.from_local(w, mesh, [r] * nd, run_check=False)
        weights[k] = w.redistribute(mesh, [p if p.is_shard(0) else r
                                           for p in w.placements])
    rows = [p.is_shard(0) for p in tok]
    experts = [p.is_shard(0) for p in weights["wi_gate"].placements]
    if any(experts != [p.is_shard(0) for p in w.placements]
           for w in weights.values()) or any(a and b for a, b in
                                             zip(rows, experts)):
        raise NotImplementedError(
            f"sharded MoE: the experts' placements "
            f"{[w.placements for w in weights.values()]} against the rows' "
            f"{tok}: each mesh dim must split the rows, the experts or "
            f"neither")
    # gradients: a rank's experts add a partial sum to its rows' gradient
    # (and the router's); an expert's weight gradient sums this rank's
    # rows, partial over the dims that split them
    x_tok = x.redistribute(mesh, tok)
    x_l = x_tok.to_local(grad_placements=[
        p if p.is_shard(0) else Partial() if e else r
        for p, e in zip(tok, experts)])
    w_l = {k: w.to_local(grad_placements=[
        Shard(0) if e else Partial() if b else r
        for b, e in zip(rows, experts)]) for k, w in weights.items()}
    (n_local, *_), (e0, *_) = local_block(weights["wi_gate"])
    router = params["router"]
    if not isinstance(router, DTensor):
        router = DTensor.from_local(router, mesh, [r] * nd, run_check=False)
    router_l = router.redistribute(mesh, [r] * nd).to_local(
        grad_placements=[Partial() if b or e else r
                         for b, e in zip(rows, experts)])
    C = _capacity(S, m)
    noise = None
    if train and m.router_jitter and rng is not None:
        # the unsharded step's draw over every row; this rank's rows of it
        (b_l, *_), (b0, *_) = local_block(x_tok)
        noise = torch.randn((B, S, m.num_experts), generator=rng,
                            device=x_l.device)[b0:b0 + b_l]
    with use_mesh(None):                    # plain tensors from here on
        rt = route(router_l, x_l, m, C, noise=noise)
        y = _dispatch_experts(w_l, x_l, rt, cfg, C, e0, n_local)
    n_rows = math.prod(mesh.size(i) for i in range(nd) if rows[i])
    n_exp = math.prod(mesh.size(i) for i in range(nd) if experts[i])
    # partial over the dims that split the experts; the batch rows kept
    y_place = [Shard(0) if b else Partial() if e else r
               for b, e in zip(rows, experts)]
    y = from_local(cast(y, cfg.compute_dtype), mesh, y_place, x.shape)
    y = y.redistribute(mesh, [Shard(0) if b else r for b in rows])
    # the aux loss: the mean over the rows' ranks as a sum of each rank's
    # share; every rank that holds the same rows computes the same value,
    # so its gradient, partial over the experts' dims with the rest, is
    # counted once there
    aux_l = rt.aux / n_rows
    aux_l = aux_l.detach() + (aux_l - aux_l.detach()) / n_exp
    aux = DTensor.from_local(aux_l, mesh, [Partial() if b else r
                                           for b in rows],
                             run_check=False).redistribute(mesh, [r] * nd)
    if m.num_shared:
        y = y + apply_mlp(params["shared"], x, cfg)
    return lconstraint(y, ("batch", "seq_r", "embed")), aux
