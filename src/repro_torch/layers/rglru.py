"""RecurrentGemma / Griffin recurrent block: temporal conv1d (width 4) +
RG-LRU gated linear recurrence (counterpart of ``repro.layers.rglru``).

The block's temporal conv runs the shift-based ``causal_conv1d``, as the
reference's ``apply_rglru`` does on every backend; the kernel route of the
same function is ``kernels.ops.conv1d_depthwise`` (``conv2d_ws``'s dw
path), which the reference's block does not take either.  The block's
``dense`` calls pass no backend, so its GEMMs stay on ``torch.einsum``.

Prefill runs the recurrence as a log-depth scan over the sequence (the
reference's ``lax.associative_scan``); decode carries an O(1) state.  The
decode state is written in place by ``models.blocks.apply_block_decode``
(``conv`` and ``h`` ``copy_``'d from the state ``apply_rglru`` returns),
as the attention blocks write their KV cache.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.layers.common import (ParamSpec, cast, dense, einsum,
                                       lconstraint)

_C = 8.0  # RG-LRU sharpness constant (Griffin §2.4)


class RGLRUState(NamedTuple):
    conv: torch.Tensor   # [B, conv_width-1, W] — last inputs for the conv1d
    h: torch.Tensor      # [B, W] — recurrence carry (f32)

    @staticmethod
    def init_specs(cfg, batch: int):
        w = cfg.rnn_width
        return RGLRUState(
            conv=ParamSpec((batch, cfg.conv1d_width - 1, w),
                           ("batch", None, "rnn"),
                           dtype=cfg.compute_dtype, init="zeros"),
            h=ParamSpec((batch, w), ("batch", "rnn"),
                        dtype="float32", init="zeros"),
        )


def rglru_specs(cfg):
    d, w = cfg.d_model, cfg.rnn_width
    return {
        "w_gate": ParamSpec((d, w), ("embed", "rnn")),
        "w_rnn_in": ParamSpec((d, w), ("embed", "rnn")),
        "conv_w": ParamSpec((cfg.conv1d_width, w), (None, "rnn"),
                            init="fan_in", fan_in_axes=(0,)),
        "conv_b": ParamSpec((w,), ("rnn",), init="zeros"),
        "w_a": ParamSpec((w, w), ("rnn", "rnn")),       # recurrence gate
        "b_a": ParamSpec((w,), ("rnn",), init="zeros"),
        "w_x": ParamSpec((w, w), ("rnn", "rnn")),       # input gate
        "b_x": ParamSpec((w,), ("rnn",), init="zeros"),
        "lam": ParamSpec((w,), ("rnn",), init="constant", scale=0.7),
        "w_out": ParamSpec((w, d), ("rnn", "embed")),
    }


def causal_conv1d(u, conv_w, conv_b, prefix=None):
    """Depthwise causal temporal conv.  u: [B,S,W]; conv_w: [K,W].

    prefix: [B,K-1,W] carried state (decode); zeros otherwise.  K shifted
    multiply-adds in u's dtype, the bias first, as the reference."""
    k = conv_w.shape[0]
    if prefix is None:
        prefix = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    xp = torch.cat([cast(prefix, u.dtype), u], dim=1)       # [B,S+K-1,W]
    s = u.shape[1]
    y = conv_b.to(u.dtype)[None, None]
    for j in range(k):
        y = y + xp[:, j:j + s] * conv_w[j][None, None]
    return y


def _gates(params, u):
    """RG-LRU gate computation in f32.  u: [B,S,W] → (log_a, b_input).
    On DTensors each gate's product contracts local shards
    (``common.einsum``) and is placed as ``u`` is before its bias is
    added: with ``rnn`` over ``model`` on both sides the product is a
    partial sum, which DTensor would otherwise meet the sharded bias with
    by a redistribute that some torch versions refuse (``Shard`` to
    ``Partial``)."""
    uf = u.float()

    def gate(w, b):
        y = einsum("bsw,wv->bsv", uf, params[w].float())
        y = lconstraint(y, ("batch", "seq", "rnn"))
        return torch.sigmoid(y + params[b].float())
    r = gate("w_a", "b_a")
    i = gate("w_x", "b_x")
    log_a = -_C * F.softplus(params["lam"].float()) * r
    gated = i * uf
    # multiplier sqrt(1 - a^2) = sqrt(1 - exp(2 log_a)), computed stably
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    return log_a, mult * gated


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t (h_{-1} = 0) over axis 1,
    in log2(S) doubling steps (Hillis–Steele) of the reference's combine
    (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2): step d combines every
    element with the one d before it.  The combine order differs from
    XLA's ``associative_scan``, so the f32 sums differ in rounding."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:               # the last step needs no products of a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(params, u, h0=None):
    """Associative linear recurrence h_t = a_t h_{t-1} + b_t over axis 1."""
    log_a, b = _gates(params, u)
    a = torch.exp(log_a)
    if h0 is not None:
        # fold the carried state into the first step
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return linear_scan(a, b)  # f32 [B,S,W]


def apply_rglru(params, x, cfg, state: RGLRUState | None = None):
    """Full recurrent block.  x: [B,S,D] → (y, new_state or None)."""
    gate = F.gelu(dense(params["w_gate"], x, "bsd,dw->bsw",
                        compute_dtype=cfg.compute_dtype),
                  approximate="tanh")      # jax.nn.gelu's default
    u_raw = dense(params["w_rnn_in"], x, "bsd,dw->bsw",
                  compute_dtype=cfg.compute_dtype)
    u_raw = lconstraint(u_raw, ("batch", "seq", "rnn"))
    prefix = state.conv if state is not None else None
    u = causal_conv1d(u_raw, cast(params["conv_w"], u_raw.dtype),
                      params["conv_b"], prefix=prefix)
    h0 = state.h if state is not None else None
    h = rglru_scan(params, u, h0=h0)
    y = cast(h, cfg.compute_dtype) * gate
    y = dense(params["w_out"], y, "bsw,wd->bsd",
              compute_dtype=cfg.compute_dtype)
    y = lconstraint(y, ("batch", "seq_r", "embed"))
    if state is None:
        return y, None
    k = cfg.conv1d_width
    # carry the last K-1 conv inputs and the last recurrence state
    xp = torch.cat([cast(state.conv, u_raw.dtype), u_raw], dim=1)
    return y, RGLRUState(conv=xp[:, -(k - 1):], h=h[:, -1])


def decode_rglru(params, x, cfg, state: RGLRUState):
    """Single-token step.  x: [B,1,D]."""
    return apply_rglru(params, x, cfg, state=state)
