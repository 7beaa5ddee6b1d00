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
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.layers.common import ParamSpec, cast, dense, lconstraint
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


def apply_timemix(params, x, cfg, state: RWKVState | None = None,
                  chunked: bool = True):
    """RWKV6 time mix.  x: [B,S,D] → (y, (S_fin, x_last))."""
    B, S, D = x.shape
    N = cfg.rwkv_head_size
    H = D // N

    xf = x.float()
    xprev = _token_shift(x, state.x_att if state is not None else None
                         ).float()
    sx = xprev - xf

    # data-dependent lerp (ddlerp): 5 mixed inputs for w, k, v, r, g
    z = xf + sx * params["mu_base"].float()
    tan = torch.tanh(torch.einsum("bsd,dpr->bspr", z,
                                  params["ddlerp_a"].float()))
    dyn = torch.einsum("bspr,prd->bspd", tan,
                       params["ddlerp_b"].float())                # [B,S,5,D]
    mixed = xf[:, :, None] + sx[:, :, None] * (
        params["mu"].float()[None, None] + dyn)                  # [B,S,5,D]
    xw, xk, xv, xr, xg = mixed.unbind(dim=2)

    # decay (per channel, data dependent): logw = -exp(w0 + lora_w(xw))
    wlo = torch.tanh(xw @ params["w_lora_a"].float()) \
        @ params["w_lora_b"].float()
    logw = -torch.exp(torch.clamp(params["w0"].float() + wlo, -20.0, 8.0))

    cd = cfg.compute_dtype
    rr = dense(params["wr"], cast(xr, cd), "bsd,de->bse", compute_dtype=cd)
    kk = dense(params["wk"], cast(xk, cd), "bsd,de->bse", compute_dtype=cd)
    vv = dense(params["wv"], cast(xv, cd), "bsd,de->bse", compute_dtype=cd)
    gg = dense(params["wg"], cast(xg, cd), "bsd,de->bse", compute_dtype=cd)

    def heads(t):
        return t.float().reshape(B, S, H, N)

    S0 = state.S if state is not None else None
    core = wkv6_chunked if (chunked and S > 1) else wkv6_recurrent
    o, S_fin = core(heads(rr), heads(kk), heads(vv), logw.reshape(B, S, H, N),
                    params["u"].float(), S0=S0)

    o = groupnorm_heads(o, params["gn_scale"], params["gn_bias"])
    y = cast(o.reshape(B, S, D), cd) * F.silu(gg)
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
