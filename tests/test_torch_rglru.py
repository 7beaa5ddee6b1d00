"""The port's RG-LRU recurrent block and its conv kernel route against the
JAX package on the CPU.

Each case feeds the same seeded numpy inputs (and the reference's own
``materialize``d weights, carried across with ``convert.lm_params_to_torch``)
to a JAX function and its port.  f32 outputs agree within rtol = atol =
1e-4: the two sum in another order, and the port's log-depth scan
combines the recurrence's terms in another order than XLA's
``associative_scan`` (each h_t is a sum of products of |a| < 1 factors,
so a reordering moves it by a few f32 ulps of its magnitude, far below
1e-4 at these sizes).  ``ops.conv1d_depthwise`` runs the JAX package's
Pallas conv kernel in interpret mode, as ``tests/test_grouped_conv.py``
runs it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers import common as jcommon
from repro.layers import rglru as jrglru
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.kernels import ops, ref
from repro_torch.kernels.conv2d_ws import (SMEM_BYTES, conv_path, dw_plan,
                                           setup_conv)
from repro_torch.layers import common, rglru

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(**kw):
    arch = "recurrentgemma_9b"
    jcfg = dataclasses.replace(jbase.reduce_config(jbase.get_config(arch)),
                               **kw)
    cfg = dataclasses.replace(base.reduce_config(base.get_config(arch)), **kw)
    return jcfg, cfg


def _weights(seed=0, **kw):
    jcfg, cfg = _configs(**kw)
    jp = jcommon.materialize(jrglru.rglru_specs(jcfg),
                             jax.random.PRNGKey(seed))
    # random gate biases and lam, so every term of the gates is exercised
    rng = np.random.default_rng(seed + 100)
    for name in ("b_a", "b_x", "conv_b"):
        jp[name] = jnp.asarray(rng.normal(size=jp[name].shape), jnp.float32)
    jp["lam"] = jnp.asarray(rng.uniform(-1, 2, size=jp["lam"].shape),
                            jnp.float32)
    tp = convert.lm_params_to_torch(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return jcfg, cfg, jp, tp


def _normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _state(conv, h):
    return (jrglru.RGLRUState(jnp.asarray(conv), jnp.asarray(h)),
            rglru.RGLRUState(torch.from_numpy(conv), torch.from_numpy(h)))


def test_specs_equal_the_reference():
    jcfg, cfg = _configs()

    def flat(tree, is_leaf):
        return [(s.shape, s.axes, s.dtype, s.init, s.scale, s.fan_in_axes)
                for s in jax.tree.leaves(tree, is_leaf=is_leaf)]
    assert (flat(rglru.rglru_specs(cfg), common.is_spec)
            == flat(jrglru.rglru_specs(jcfg), jcommon.is_spec))
    assert (flat(rglru.RGLRUState.init_specs(cfg, 3), common.is_spec)
            == flat(jrglru.RGLRUState.init_specs(jcfg, 3), jcommon.is_spec))
    assert rglru.RGLRUState._fields == jrglru.RGLRUState._fields


@pytest.mark.parametrize("with_prefix", [False, True])
def test_causal_conv1d(with_prefix):
    u, w, b = _normal(2, 9, 64, seed=1), _normal(4, 64, seed=2), \
        _normal(64, seed=3)
    prefix = _normal(2, 3, 64, seed=4) if with_prefix else None
    want = jrglru.causal_conv1d(
        jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
        prefix=None if prefix is None else jnp.asarray(prefix))
    got = rglru.causal_conv1d(
        torch.from_numpy(u), torch.from_numpy(w), torch.from_numpy(b),
        prefix=None if prefix is None else torch.from_numpy(prefix))
    _close(got, want)


def test_gates():
    _, _, jp, tp = _weights()
    u = _normal(2, 7, 64, seed=5) * 2
    jl, jb = jrglru._gates(jp, jnp.asarray(u))
    tl, tb = rglru._gates(tp, torch.from_numpy(u))
    assert tl.dtype == torch.float32 and tb.dtype == torch.float32
    _close(tl, jl)
    _close(tb, jb)


@pytest.mark.parametrize("seq", [1, 7, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan(seq, with_h0):
    """The log-depth scan at odd, non-power-of-two and power-of-two
    lengths, with and without a carried state, against the reference's
    associative scan and against the plain sequential recurrence."""
    _, _, jp, tp = _weights(seed=1)
    u = _normal(2, seq, 64, seed=6)
    h0 = _normal(2, 64, seed=7) if with_h0 else None
    want = jrglru.rglru_scan(jp, jnp.asarray(u),
                             h0=None if h0 is None else jnp.asarray(h0))
    got = rglru.rglru_scan(tp, torch.from_numpy(u),
                           h0=None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == torch.float32 and got.shape == (2, seq, 64)
    _close(got, want)
    log_a, b = rglru._gates(tp, torch.from_numpy(u))
    a = torch.exp(log_a)
    h = torch.zeros(2, 64) if h0 is None else torch.from_numpy(h0)
    sequential = []
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        sequential.append(h)
    _close(got, torch.stack(sequential, dim=1))


@pytest.mark.parametrize("seq", [2, 3, 5, 31, 33, 100])
def test_linear_scan_any_length(seq):
    a = torch.from_numpy(np.random.default_rng(seq).uniform(
        0, 1, (3, seq, 5)).astype(np.float32))
    b = torch.from_numpy(_normal(3, seq, 5, seed=seq))
    h, want = torch.zeros(3, 5), []
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(rglru.linear_scan(a, b), torch.stack(want, dim=1))


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_rglru(with_state):
    jcfg, cfg, jp, tp = _weights(seed=2)
    x = _normal(2, 11, 64, seed=8)
    jstate = tstate = None
    if with_state:
        jstate, tstate = _state(_normal(2, 3, 64, seed=9),
                                _normal(2, 64, seed=10))
    jy, jst = jrglru.apply_rglru(jp, jnp.asarray(x), jcfg, state=jstate)
    ty, tst = rglru.apply_rglru(tp, torch.from_numpy(x), cfg, state=tstate)
    _close(ty, jy)
    if not with_state:
        assert jst is None and tst is None
        return
    _close(tst.conv, jst.conv)
    _close(tst.h, jst.h)
    assert tst.h.dtype == torch.float32


def test_decode_rglru_continues_the_prefill():
    """One decode step after a prefill equals the reference's, and equals
    the same token inside a longer prefill."""
    jcfg, cfg, jp, tp = _weights(seed=3)
    x = _normal(2, 12, 64, seed=11)
    zero = np.zeros((2, 3, 64), np.float32), np.zeros((2, 64), np.float32)
    jz, tz = _state(*zero)
    _, jst = jrglru.apply_rglru(jp, jnp.asarray(x[:, :11]), jcfg, state=jz)
    _, tst = rglru.apply_rglru(tp, torch.from_numpy(x[:, :11]), cfg,
                               state=tz)
    jy, jst2 = jrglru.decode_rglru(jp, jnp.asarray(x[:, 11:]), jcfg, jst)
    ty, tst2 = rglru.decode_rglru(tp, torch.from_numpy(x[:, 11:]), cfg, tst)
    _close(ty, jy)
    _close(tst2.conv, jst2.conv)
    _close(tst2.h, jst2.h)
    full, fst = rglru.apply_rglru(tp, torch.from_numpy(x), cfg, state=tz)
    _close(ty, full[:, 11:])
    _close(tst2.h, fst.h)


# -- ops.conv1d_depthwise: the kernel route of the temporal conv -------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_conv1d_depthwise_equals_the_jax_kernel(dtype, bias):
    """Against the JAX ``ops.conv1d_depthwise`` (the Pallas conv kernel in
    interpret mode) and both packages' ``conv1d_depthwise_ref``.  f32
    within 1e-4; bf16 outputs are each one rounding of an f32 sum taken
    in another order, so they agree within one bf16 ulp (2^-7 of the
    magnitude) plus 1e-6."""
    x = _normal(2, 12, 8, seed=12)
    w, b = _normal(4, 8, seed=13), _normal(8, seed=14) if bias else None
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    want = jops.conv1d_depthwise(jx, jnp.asarray(w), jb)
    got = ops.conv1d_depthwise(tx, torch.from_numpy(w), tb)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    oracle = ref.conv1d_depthwise_ref(tx, torch.from_numpy(w), tb)
    joracle = jref.conv1d_depthwise_ref(jx, jnp.asarray(w), jb)
    want_f = np.asarray(want, np.float32)
    for other in (got.float().numpy(), oracle.float().numpy(),
                  np.asarray(joracle, np.float32)):
        if dtype == "float32":
            _close(other, want_f)
        else:
            ulp = 2.0 ** -7 * np.abs(want_f)
            assert (np.abs(other - want_f) <= ulp + 1e-6).all()


def test_conv1d_depthwise_gradient_equals_the_jax_vjp():
    """Through ``ops.conv2d``'s autograd Function (the kernels' backward):
    dx, dw and db against ``jax.grad`` of the JAX op, whose custom VJP
    runs the Pallas backward in interpret mode."""
    x, w, b = _normal(1, 6, 4, seed=15), _normal(3, 4, seed=16), \
        _normal(4, seed=17)
    probe = _normal(1, 6, 4, seed=18)
    want = jax.grad(lambda x, w, b: jnp.sum(
        jops.conv1d_depthwise(x, w, b) * probe), (0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    (ops.conv1d_depthwise(tx, tw, tb) * torch.from_numpy(probe)).sum() \
        .backward()
    for got, wn in zip((tx.grad, tw.grad, tb.grad), want):
        _close(got, wn)


def test_conv1d_depthwise_is_causal_and_equals_the_block_conv():
    x, w, b = _normal(2, 10, 8, seed=19), _normal(4, 8, seed=20), \
        _normal(8, seed=21)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    full = ops.conv1d_depthwise(tx, tw, tb)
    cut = tx.clone()
    cut[:, 7:] = 0.0
    _close(ops.conv1d_depthwise(cut, tw, tb)[:, :7], full[:, :7])
    _close(full, rglru.causal_conv1d(tx, tw, tb))


@pytest.mark.parametrize("seq", [64, 4096])
def test_conv1d_depthwise_launch_plan_at_the_model_width(seq):
    """recurrentgemma-9b's conv at rnn_width 4096: the 1×4 conv over a
    [B, 1, S, 4096] map with 4096 one-channel groups.  ``grouped_banks``
    keeps one cin bank and 4096 kout banks (one lane each), and the
    geometry takes the dw path: runs of 128 lanes, each block a row of 32
    positions of one run (its window, 35 positions × 128 lanes, and
    weights fit a block's shared memory twice over), so the launch runs
    S/32 × 32 blocks, the map's tiles and banks shaping none."""
    width, k = base.get_config("recurrentgemma_9b").rnn_width, 4
    cin, kout = ref.grouped_banks(width, width, width, want_cin=1,
                                  want_kout=width)
    assert (cin, kout) == (1, width)
    g = setup_conv((1, 1, seq, width), (1, k, 1, width), padding=(
        (0, 0), (k - 1, 0)), groups=width, cin_banks=cin, kout_banks=kout,
        int_path=False)
    assert conv_path(g) == "dw"
    assert (g.th, g.tw, g.kb, g.cb, g.in_tw) == (1, seq, 1, 1, seq + k - 1)
    for pipelined in (False, True):
        p = dw_plan(g, False, pipelined)
        assert (p.kc, p.rh, p.rw, p.win_w) == (128, 1, 32, 32 + k - 1)
        assert p.n_rect == (seq // 32) * (width // 128)
        assert p.smem == (2 if pipelined else 1) * p.slot_bytes <= \
            SMEM_BYTES
