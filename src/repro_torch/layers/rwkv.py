"""RWKV-6 ("Finch"): attention-free time mix with data-dependent
per-channel decay, plus the RWKV channel-mix FFN (counterpart of
``repro.layers.rwkv``).

Two execution forms of the wkv6 core, held against each other in tests:

* ``wkv6_recurrent``: the O(S) sequential oracle and the decode step
  (state [B,H,N,N]);
* ``wkv6_chunked``: the chunk-parallel form of train / prefill.  Every
  decay exponential is exp(logP_i − logP_j) with i ≥ j, which is ≤ 0
  because log-decays are negative, so nothing overflows.  Within a chunk
  the work is an [L,L] pairwise per-channel contraction; the state runs
  across chunks in a loop (the reference's ``lax.scan``).

Every GEMM is a ``dense`` with no backend, as in the reference, so none
runs a kernel.  The decode state (``S``, ``x_att``, ``x_ffn``) is written
in place by ``models.blocks.apply_block_decode`` from what these functions
return.

Sharded (DTensor activations under ``use_mesh``): the ddlerp and LoRA
einsums contract their local shards (``common.einsum``), so the mix's
dim of 5 is never split; the mix and decay vectors meet the activations
whole.  The wkv core and the group norm are independent per (batch row,
head), so each rank runs its own rows (the mesh dims of "batch") and
heads ("heads", over ``model`` where the head count divides) on plain
tensors (``_wkv_sharded``): no sum crosses ranks there, r / k / v / the
decay and the state keep their placements in the backward, and the
gradients of ``u`` and the group norm's scale and bias are partial over
the rows' dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor
from repro_torch.layers.common import (ParamSpec, cast, dense, einsum,
                                       lconstraint)
from repro_torch.layers.norms import groupnorm_heads

MIX_NAMES = ("w", "k", "v", "r", "g")


class RWKVState(NamedTuple):
    S: torch.Tensor       # [B, H, N, N] wkv state (f32)
    x_att: torch.Tensor   # [B, D] last input to time-mix (token shift)
    x_ffn: torch.Tensor   # [B, D] last input to channel-mix

    @staticmethod
    def init_specs(cfg, batch: int):
        H = cfg.d_model // cfg.rwkv_head_size
        N = cfg.rwkv_head_size
        return RWKVState(
            S=ParamSpec((batch, H, N, N), ("batch", "heads", None, None),
                        dtype="float32", init="zeros"),
            x_att=ParamSpec((batch, cfg.d_model), ("batch", "embed"),
                            dtype=cfg.compute_dtype, init="zeros"),
            x_ffn=ParamSpec((batch, cfg.d_model), ("batch", "embed"),
                            dtype=cfg.compute_dtype, init="zeros"),
        )


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def timemix_specs(cfg):
    d = cfg.d_model
    r = cfg.rwkv_lora_rank
    H = d // cfg.rwkv_head_size
    N = cfg.rwkv_head_size
    return {
        "mu_base": ParamSpec((d,), ("embed",), init="zeros"),
        "mu": ParamSpec((5, d), (None, "embed"), init="zeros"),
        "ddlerp_a": ParamSpec((d, 5, r), ("embed", None, None), init="fan_in"),
        "ddlerp_b": ParamSpec((5, r, d), (None, None, "embed"), init="zeros"),
        "w0": ParamSpec((d,), ("embed",), init="constant", scale=-2.0),
        "w_lora_a": ParamSpec((d, r), ("embed", None), init="fan_in"),
        "w_lora_b": ParamSpec((r, d), (None, "embed"), init="zeros"),
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "wo": ParamSpec((d, d), ("heads", "embed")),
        "u": ParamSpec((H, N), ("heads", None), init="normal", scale=0.5),
        "gn_scale": ParamSpec((H, N), ("heads", None), init="ones"),
        "gn_bias": ParamSpec((H, N), ("heads", None), init="zeros"),
    }


def channelmix_specs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), ("embed",), init="zeros"),
        "mu_r": ParamSpec((d,), ("embed",), init="zeros"),
        "wk": ParamSpec((d, f), ("embed", "mlp")),
        "wv": ParamSpec((f, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", "heads")),
    }


# ---------------------------------------------------------------------------
# wkv6 cores
# ---------------------------------------------------------------------------


def wkv6_recurrent(r, k, v, logw, u, S0=None):
    """Sequential oracle.  r,k,v,logw: [B,S,H,N] f32; u: [H,N].
    Returns (o [B,S,H,N], S_final [B,H,N,N])."""
    B, S, H, N = r.shape
    Sc = r.new_zeros((B, H, N, N)) if S0 is None else S0
    outs = []
    for t in range(S):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], logw[:, t]   # [B,H,N]
        bonus = torch.einsum("bhn,bhn->bh", rt, u[None] * kt)
        outs.append(torch.einsum("bhn,bhnm->bhm", rt, Sc)
                    + bonus[..., None] * vt)
        Sc = torch.exp(lwt)[..., None] * Sc + kt[..., None] * vt[..., None, :]
    return torch.stack(outs, dim=1), Sc


def wkv6_chunked(r, k, v, logw, u, S0=None, chunk: int = 32):
    """Chunk-parallel wkv6 (see the module note).  Same signature and
    returns as :func:`wkv6_recurrent`; the chunk is halved until it
    divides S, as in the reference."""
    B, S, H, N = r.shape
    L = min(chunk, S)
    while S % L:
        L //= 2
    Sc = r.new_zeros((B, H, N, N)) if S0 is None else S0
    tri_strict = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=r.device), diagonal=-1)
    mask = tri_strict[None, :, :, None, None]
    outs = []
    for c0 in range(0, S, L):
        rc, kc, vc, lwc = (t[:, c0:c0 + L] for t in (r, k, v, logw))
        lp = torch.cumsum(lwc, dim=1)                    # inclusive logP_i
        lp_prev = lp - lwc                               # exclusive logP_{i-1}
        lp_last = lp[:, -1]                              # [B,H,N]
        # intra-chunk pairwise decays D[b,i,j,h,n] = exp(lp_prev_i - lp_j):
        # the exponent is <= 0 for j <= i-1, the rest is masked to exp(-inf)
        expo = lp_prev[:, :, None] - lp[:, None]         # [B,L,L,H,N]
        D = torch.exp(torch.where(mask, expo, float("-inf")))
        A = torch.einsum("blhn,bmhn,blmhn->bhlm", rc, kc, D)
        bonus = torch.einsum("blhn,blhn->blh", rc, u[None, None] * kc)
        o = torch.einsum("bhlm,bmhn->blhn", A, vc) + bonus[..., None] * vc
        o = o + torch.einsum("blhn,bhnm->blhm", rc * torch.exp(lp_prev), Sc)
        # state to the chunk's end: S0 decayed fully, each k_j to the end
        k_dec = kc * torch.exp(lp_last[:, None] - lp)
        Sc = (torch.exp(lp_last)[..., None] * Sc
              + torch.einsum("blhn,blhm->bhnm", k_dec, vc))
        outs.append(o)
    return torch.cat(outs, dim=1), Sc


# ---------------------------------------------------------------------------
# Layer assembly
# ---------------------------------------------------------------------------


def _token_shift(x, x_prev_last=None):
    """x_{t-1} with a zero (or carried) state at t=0.  x: [B,S,D]."""
    if x_prev_last is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = cast(x_prev_last[:, None], x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _whole(t):
    """A DTensor parameter replicated (differentiably: its gradient
    returns to its own placements), a plain tensor as it is: the mix and
    decay vectors meet the batch-sharded activations whole, so that the
    activations keep their layout (FSDP shards the vectors' ``embed``
    dim over the rows' mesh dims)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _wkv_heads(r, k, v, logw, params, N: int, S0, core):
    """The wkv core and the per-head group norm: r, k, v, logw [B,S,D]
    (plain tensors) → (o [B,S,D] f32, S_fin [B,H,N,N])."""
    B, S, D = r.shape
    H = D // N

    def heads(t):
        return t.float().reshape(B, S, H, N)
    o, S_fin = core(heads(r), heads(k), heads(v), heads(logw),
                    params["u"].float(), S0=S0)
    o = groupnorm_heads(o, params["gn_scale"], params["gn_bias"])
    return o.reshape(B, S, D), S_fin


def _wkv_sharded(r, k, v, logw, params, N: int, S0, core):
    """``_wkv_heads`` of DTensors r, k, v, logw [B,S,D] (and a DTensor
    state ``S0``) on local shards: the recurrence is independent per
    (batch row, head), so each rank runs its rows (the mesh dims of the
    active rules' "batch") and its heads ("heads", where the head count
    divides) as plain tensors, which DTensor's einsum and view rules
    would redistribute or refuse (a head dim split into a
    ``_StridedShard``).  Nothing is summed across ranks: the outputs' and
    the inputs' gradients keep their placements, and those of ``u`` and
    the group norm's scale and bias are partial over the rows' dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import (from_local,
                                                  rule_placements)
    B, S, D = r.shape
    H = D // N
    mesh = r.device_mesh
    seq = rule_placements(mesh, (B, S, H), ("batch", None, "heads"))
    rows = [p.is_shard(0) for p in seq]
    cut = [p.is_shard(2) for p in seq]
    rep = Replicate()
    lay_seq = [Shard(0) if b else Shard(2) if h else rep
               for b, h in zip(rows, cut)]
    lay_state = [Shard(0) if b else Shard(1) if h else rep
                 for b, h in zip(rows, cut)]
    loc = [t.redistribute(mesh, lay_seq).to_local()
           for t in (r, k, v, logw)]
    if S0 is not None:
        S0 = S0.redistribute(mesh, lay_state).to_local()
    head_params = {}
    for name in ("u", "gn_scale", "gn_bias"):
        t = params[name]
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [rep] * mesh.ndim,
                                   run_check=False)
        head_params[name] = t.redistribute(mesh, [
            Shard(0) if h else rep for h in cut]).to_local(grad_placements=[
                Shard(0) if h else Partial() if b else rep
                for b, h in zip(rows, cut)])
    o, S_fin = _wkv_heads(*loc, head_params, N, S0, core)
    return (from_local(o, mesh, lay_seq, (B, S, D)),
            from_local(S_fin, mesh, lay_state, (B, H, N, N)))


def apply_timemix(params, x, cfg, state: RWKVState | None = None,
                  chunked: bool = True):
    """RWKV6 time mix.  x: [B,S,D] → (y, (S_fin, x_last)).  A DTensor
    ``x`` contracts its ddlerp and LoRA einsums on local shards
    (``common.einsum``: the mix's dim of 5 stays whole) and runs the wkv
    core on this rank's rows and heads (``_wkv_sharded``)."""
    B, S, D = x.shape
    N = cfg.rwkv_head_size

    xf = x.float()
    xprev = _token_shift(x, state.x_att if state is not None else None
                         ).float()
    sx = xprev - xf

    # data-dependent lerp (ddlerp): 5 mixed inputs for w, k, v, r, g
    z = xf + sx * _whole(params["mu_base"]).float()
    tan = torch.tanh(einsum("bsd,dpr->bspr", z,
                            params["ddlerp_a"].float()))
    dyn = einsum("bspr,prd->bspd", tan,
                 params["ddlerp_b"].float())                     # [B,S,5,D]
    # each mixed input on its own [B,S,D], the same sums as a [B,S,5,D]
    # mix: DTensor's pointwise rule may shard such a mix's dim of 5 (over
    # ``model``, where the rows split unevenly), which unbind refuses
    mu = _whole(params["mu"]).float()
    xw, xk, xv, xr, xg = (xf + sx * (mu[i] + dyn[:, :, i])
                          for i in range(len(MIX_NAMES)))

    # decay (per channel, data dependent): logw = -exp(w0 + lora_w(xw))
    wlo = einsum("bsr,rd->bsd", torch.tanh(einsum(
        "bsd,dr->bsr", xw, params["w_lora_a"].float())),
        params["w_lora_b"].float())
    logw = -torch.exp(torch.clamp(_whole(params["w0"]).float() + wlo,
                                  -20.0, 8.0))

    cd = cfg.compute_dtype
    rr = dense(params["wr"], cast(xr, cd), "bsd,de->bse", compute_dtype=cd)
    kk = dense(params["wk"], cast(xk, cd), "bsd,de->bse", compute_dtype=cd)
    vv = dense(params["wv"], cast(xv, cd), "bsd,de->bse", compute_dtype=cd)
    gg = dense(params["wg"], cast(xg, cd), "bsd,de->bse", compute_dtype=cd)

    S0 = state.S if state is not None else None
    core = wkv6_chunked if (chunked and S > 1) else wkv6_recurrent
    wkv = _wkv_sharded if is_dtensor(x) else _wkv_heads
    o, S_fin = wkv(rr, kk, vv, logw, params, N, S0, core)

    y = cast(o, cd) * F.silu(gg)
    y = dense(params["wo"], y, "bse,ed->bsd", compute_dtype=cd)
    return lconstraint(y, ("batch", "seq_r", "embed")), (S_fin, x[:, -1])


def apply_channelmix(params, x, cfg, state_x_last=None):
    """RWKV channel mix.  Returns (y, x_last)."""
    cd = cfg.compute_dtype
    xf = x.float()
    sx = _token_shift(x, state_x_last).float() - xf
    xk = cast(xf + sx * params["mu_k"].float(), cd)
    xr = cast(xf + sx * params["mu_r"].float(), cd)
    kk = dense(params["wk"], xk, "bsd,df->bsf", compute_dtype=cd)
    kk = lconstraint(torch.square(torch.relu(kk)), ("batch", "seq", "mlp"))
    vv = dense(params["wv"], kk, "bsf,fd->bsd", compute_dtype=cd)
    rr = torch.sigmoid(dense(params["wr"], xr, "bsd,de->bse",
                             compute_dtype=cd))
    return lconstraint(rr * vv, ("batch", "seq_r", "embed")), x[:, -1]
