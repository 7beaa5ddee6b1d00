"""The port's RWKV-6 layers against the JAX package on the CPU.

Each case feeds the same seeded numpy inputs (and the reference's own
``materialize``d weights, carried across with
``convert.lm_params_to_torch``, with the zero-initialised lerp, LoRA and
gate parameters redrawn so that every term is exercised) to a JAX
function and its port.  f32 outputs agree within rtol = atol = 1e-4: the
two sum in another order.  The port's chunked wkv6 is also held to its
own sequential form, as the reference's tests hold theirs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.layers import common as jcommon
from repro.layers import norms as jnorms
from repro.layers import rwkv as jrwkv
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.layers import common, norms, rwkv

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(**kw):
    arch = "rwkv6_1p6b"
    jcfg = dataclasses.replace(jbase.reduce_config(jbase.get_config(arch)),
                               rwkv_head_size=16, **kw)
    cfg = dataclasses.replace(base.reduce_config(base.get_config(arch)),
                              rwkv_head_size=16, **kw)
    return jcfg, cfg


def _weights(specs_fn, seed=0):
    """Both packages' weights of one layer: the reference's materialized
    ones with every zero- or constant-initialised leaf redrawn (small, so
    the decays stay in a plausible range)."""
    jcfg, cfg = _configs()
    jp = jcommon.materialize(specs_fn(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    for name in ("mu_base", "mu", "ddlerp_b", "w_lora_b", "gn_bias",
                 "mu_k", "mu_r"):
        if name in jp:
            jp[name] = jnp.asarray(0.3 * rng.normal(size=jp[name].shape),
                                   jnp.float32)
    if "w0" in jp:
        jp["w0"] = jnp.asarray(rng.uniform(-3, 1, size=jp["w0"].shape),
                               jnp.float32)
    tp = convert.lm_params_to_torch(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return jcfg, cfg, jp, tp


def _normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _wkv_inputs(s, seed, b=2, h=2, n=8):
    r, k, v = (_normal(b, s, h, n, seed=seed + i) for i in range(3))
    # log-decays: negative, from mild to strong
    logw = -np.exp(_normal(b, s, h, n, seed=seed + 3))
    u = _normal(h, n, seed=seed + 4)
    return r, k, v, logw.astype(np.float32), u


def test_specs_equal_the_reference():
    jcfg, cfg = _configs()

    def flat(tree, is_leaf):
        return [(s.shape, s.axes, s.dtype, s.init, s.scale, s.fan_in_axes)
                for s in jax.tree.leaves(tree, is_leaf=is_leaf)]
    for port, ref_ in ((rwkv.timemix_specs, jrwkv.timemix_specs),
                       (rwkv.channelmix_specs, jrwkv.channelmix_specs)):
        assert (flat(port(cfg), common.is_spec)
                == flat(ref_(jcfg), jcommon.is_spec))
    assert (flat(rwkv.RWKVState.init_specs(cfg, 3), common.is_spec)
            == flat(jrwkv.RWKVState.init_specs(jcfg, 3), jcommon.is_spec))
    assert rwkv.RWKVState._fields == jrwkv.RWKVState._fields
    assert rwkv.MIX_NAMES == jrwkv.MIX_NAMES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_heads(dtype):
    """Its eps is 64e-5 (RWKV's), which a near-constant head shows."""
    x = _normal(2, 5, 4, 16, seed=1) * 3 + 1
    x[0, 0, 0] = 0.01 * x[0, 0, 0] + 2.0          # variance far below eps
    scale, bias = _normal(4, 16, seed=2), _normal(4, 16, seed=3)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jnorms.groupnorm_heads(jx, jnp.asarray(scale), jnp.asarray(bias))
    got = norms.groupnorm_heads(tx, torch.from_numpy(scale),
                                torch.from_numpy(bias))
    assert got.dtype == tx.dtype
    if dtype == "float32":
        _close(got, want)
    else:   # one rounding of an f32 result: within one bf16 ulp
        w = np.asarray(want, np.float32)
        assert (np.abs(got.float().numpy() - w)
                <= 2.0 ** -7 * np.abs(w) + 1e-6).all()
    eps1e6 = norms.groupnorm_heads(tx, torch.from_numpy(scale),
                                   torch.from_numpy(bias), eps=1e-6)
    assert not torch.allclose(eps1e6[0, 0, 0].float(),
                              got[0, 0, 0].float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("seq", [1, 32, 40])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_cores(seq, with_state):
    """Both forms against the reference's at S = 1, one whole chunk (32)
    and 40 (the chunk halved to 8), with and without a carried state; the
    port's chunked form against its own sequential one."""
    r, k, v, logw, u = _wkv_inputs(seq, seed=4)
    S0 = _normal(2, 2, 8, 8, seed=9) if with_state else None
    jargs = [jnp.asarray(a) for a in (r, k, v, logw, u)]
    targs = [torch.from_numpy(a) for a in (r, k, v, logw, u)]
    jS0 = None if S0 is None else jnp.asarray(S0)
    tS0 = None if S0 is None else torch.from_numpy(S0)
    outs = {}
    for form in ("wkv6_recurrent", "wkv6_chunked"):
        jo, js = getattr(jrwkv, form)(*jargs, S0=jS0)
        to, ts = getattr(rwkv, form)(*targs, S0=tS0)
        assert to.shape == (2, seq, 2, 8) and ts.shape == (2, 2, 8, 8)
        _close(to, jo)
        _close(ts, js)
        outs[form] = to, ts
    for a, b in zip(outs["wkv6_chunked"], outs["wkv6_recurrent"]):
        _close(a, b)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_wkv6_chunked_any_chunk_and_strong_decay(chunk):
    r, k, v, logw, u = (torch.from_numpy(a) for a in _wkv_inputs(64, 10))
    o1, s1 = rwkv.wkv6_recurrent(r, k, v, logw, u)
    o2, s2 = rwkv.wkv6_chunked(r, k, v, logw, u, chunk=chunk)
    _close(o2, o1)
    _close(s2, s1)
    o3, s3 = rwkv.wkv6_chunked(r, k, v, logw * 50.0, u, chunk=chunk)
    assert bool(torch.isfinite(o3).all()) and bool(torch.isfinite(s3).all())


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_apply_timemix(chunked, with_state):
    jcfg, cfg, jp, tp = _weights(jrwkv.timemix_specs, seed=1)
    x = _normal(2, 40, 64, seed=11)
    jstate = tstate = None
    if with_state:
        arrays = (_normal(2, 4, 16, 16, seed=12), _normal(2, 64, seed=13),
                  _normal(2, 64, seed=14))
        jstate = jrwkv.RWKVState(*map(jnp.asarray, arrays))
        tstate = rwkv.RWKVState(*map(torch.from_numpy, arrays))
    jy, (jS, jx) = jrwkv.apply_timemix(jp, jnp.asarray(x), jcfg,
                                       state=jstate, chunked=chunked)
    ty, (tS, tx) = rwkv.apply_timemix(tp, torch.from_numpy(x), cfg,
                                      state=tstate, chunked=chunked)
    _close(ty, jy)
    _close(tS, jS)
    _close(tx, jx)


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_channelmix(with_state):
    jcfg, cfg, jp, tp = _weights(jrwkv.channelmix_specs, seed=2)
    x = _normal(2, 7, 64, seed=15)
    last = _normal(2, 64, seed=16) if with_state else None
    jy, jl = jrwkv.apply_channelmix(
        jp, jnp.asarray(x), jcfg,
        state_x_last=None if last is None else jnp.asarray(last))
    ty, tl = rwkv.apply_channelmix(
        tp, torch.from_numpy(x), cfg,
        state_x_last=None if last is None else torch.from_numpy(last))
    _close(ty, jy)
    _close(tl, jl)


def test_token_shift():
    x = _normal(2, 5, 8, seed=17)
    last = _normal(2, 8, seed=18)
    for prev in (None, last):
        _close(rwkv._token_shift(torch.from_numpy(x), None if prev is None
                                 else torch.from_numpy(prev)),
               jrwkv._token_shift(jnp.asarray(x), None if prev is None
                                  else jnp.asarray(prev)))
