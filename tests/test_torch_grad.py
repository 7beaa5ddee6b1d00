"""The port's gradients against the JAX reference on the CPU.

* The backward oracles (``relu_mask_ref``, ``maxpool2x2_argmax_ref`` on
  tied windows, ``maxpool2x2_bwd_ref``, the input / weight / bias gradient
  oracles) equal the reference's (masks exactly, gradients within 1e-5).
* ``ops.conv2d``, ``ops.conv2d_transpose`` and ``ops.matmul_ws``
  differentiated by autograd through the port's Functions (the wrappers'
  plain versions on CPU tensors) equal ``jax.vjp`` through the reference's
  ``ops`` (Pallas in interpret mode, whole-map tiles) within rtol = atol =
  1e-4, the reference's own tolerance (``tests/test_grad_conv.py``).
* The int8 ``matmul_ws`` backward raises ``TypeError``, a sub-2×2 pooled
  output raises ``ValueError`` under autograd as in the primal, and a
  network's first layer computes no input gradient.
* The scalar conv path's own tiles (``scalar_tiles``) for whole-map f32
  layers: each fits a block's shared memory, is pool-aligned and keeps
  the caller's cin banks; a geometry no tile fits still raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import network as tnet
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.conv2d_ws import (SMEM_BYTES, scalar_tiles,
                                           setup_conv, smem_bytes)
from repro_torch.kernels.conv2d_ws_trans import transpose_eq_conv_geometry

TOL = dict(rtol=1e-4, atol=1e-4)


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# the backward oracles
# ---------------------------------------------------------------------------


def test_masks_equal_reference_with_tied_pool_windows():
    rng = np.random.default_rng(0)
    y = np.maximum(_f32(rng, 2, 7, 9, 3) - 1, 0)  # ReLU: zero ties
    y[0, 0:2, 0:2, 0] = 1.5                        # a four-way tie
    y[1, 2, 3, 1] = y[1, 3, 2, 1] = 2.0            # a diagonal tie
    want = np.asarray(jref.maxpool2x2_argmax_ref(jnp.asarray(y)))
    got = tref.maxpool2x2_argmax_ref(torch.from_numpy(y))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    tied = (y[:, :6, :8] == 0).reshape(2, 3, 2, 4, 2, 3).all(axis=(2, 4))
    assert tied.sum() > want.size // 4             # many all-zero windows
    acc = np.array([-1.0, 0.0, 2.0, -0.0], np.float32)
    np.testing.assert_array_equal(
        tref.relu_mask_ref(torch.from_numpy(acc)).numpy(),
        np.asarray(jref.relu_mask_ref(jnp.asarray(acc))))
    g = _f32(rng, *want.shape)
    np.testing.assert_array_equal(
        tref.maxpool2x2_bwd_ref(got, torch.from_numpy(g), y.shape).numpy(),
        np.asarray(jref.maxpool2x2_bwd_ref(jnp.asarray(want), jnp.asarray(g),
                                           y.shape)))


# h, w, c, k, groups, kh, stride, padding, dilation
ORACLE_CASES = [
    (8, 8, 4, 4, 1, 3, 1, "VALID", 1),
    (9, 10, 4, 8, 1, 3, 2, "SAME", 1),
    (10, 7, 2, 4, 1, 5, 2, "VALID", 1),
    (6, 6, 4, 4, 1, 3, 1, ((2, 1), (0, 2)), 1),
    (8, 8, 4, 4, 1, 3, 3, ((4, 4), (4, 4)), 1),
    (9, 10, 8, 16, 4, 3, 2, "SAME", 1),
    (8, 8, 8, 8, 8, 3, 1, "VALID", 1),
    (10, 9, 6, 12, 3, 3, 1, "SAME", 2),
]


@pytest.mark.parametrize("h,w,c,k,groups,kh,stride,padding,dilation",
                         ORACLE_CASES)
def test_grad_oracles_equal_reference(h, w, c, k, groups, kh, stride,
                                      padding, dilation):
    rng = np.random.default_rng(h * w + c + k + groups)
    x = _f32(rng, 2, h, w, c)
    wgt = _f32(rng, kh, kh, c // groups, k)
    oh, ow = jref.conv_out_shape(h, w, kh, kh, stride, padding, dilation)
    g = _f32(rng, 2, oh, ow, k)
    geo = dict(stride=stride, padding=padding, groups=groups,
               dilation=dilation)
    np.testing.assert_allclose(
        tref.conv2d_input_grad_ref(_t(g), _t(wgt), x.shape, **geo).numpy(),
        np.asarray(jref.conv2d_input_grad_ref(jnp.asarray(g),
                                              jnp.asarray(wgt), x.shape,
                                              **geo)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tref.conv2d_weight_grad_ref(_t(x), _t(g), kh, kh, **geo).numpy(),
        np.asarray(jref.conv2d_weight_grad_ref(jnp.asarray(x),
                                               jnp.asarray(g), kh, kh,
                                               **geo)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tref.conv2d_bias_grad_ref(_t(g)).numpy(),
        np.asarray(jref.conv2d_bias_grad_ref(jnp.asarray(g))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# ops gradients against jax.vjp through the reference's ops
# ---------------------------------------------------------------------------


def _check_vjp(jfn, tfn, arrays, rng):
    out, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    probe = _f32(rng, *out.shape)
    want = vjp(jnp.asarray(probe))
    ts = [_t(a, True) for a in arrays]
    got = tfn(*ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(probe))
    for g, wgt in zip(grads, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wgt), **TOL)


# (x shape, w shape, kwargs, bias)
CONV_CASES = {
    "s1_same_relu_pool": ((2, 8, 8, 4), (3, 3, 4, 8),
                          dict(padding="SAME", relu=True, pool=True), True),
    "s1_valid": ((2, 8, 9, 4), (3, 3, 4, 4), dict(), True),
    "s2_same_relu": ((2, 9, 8, 4), (3, 3, 4, 8),
                     dict(stride=2, padding="SAME", relu=True), True),
    "s2_explicit_relu_pool": ((2, 12, 11, 4), (3, 3, 4, 4),
                              dict(stride=2, padding=((1, 0), (0, 1)),
                                   relu=True, pool=True), True),
    "s1_explicit": ((1, 7, 8, 8), (3, 3, 8, 4),
                    dict(padding=((2, 1), (0, 2))), True),
    "odd_map_pool": ((1, 11, 9, 4), (3, 3, 4, 4),
                     dict(relu=True, pool=True), True),
    "groups2": ((2, 8, 8, 8), (3, 3, 4, 8),
                dict(padding="SAME", groups=2, relu=True, pool=True), True),
    "depthwise_s2": ((2, 9, 9, 8), (3, 3, 1, 8),
                     dict(stride=2, padding="SAME", groups=8, relu=True),
                     True),
    "dilation2": ((2, 10, 9, 4), (3, 3, 4, 8),
                  dict(padding="SAME", dilation=2, relu=True), True),
    "bias_none": ((1, 8, 8, 4), (3, 3, 4, 4),
                  dict(padding="SAME", relu=True), False),
    "pipelined_relu_pool": ((2, 8, 8, 4), (3, 3, 4, 8),
                            dict(padding="SAME", relu=True, pool=True,
                                 pipelined=True), True),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_grads_equal_reference(case):
    xs, ws, kw, bias = CONV_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    arrays = [_f32(rng, *xs), _f32(rng, *ws)]
    if bias:
        arrays.append(_f32(rng, ws[3]))
    _check_vjp(lambda *a: jops.conv2d(*a, **kw),
               lambda *a: tops.conv2d(*a, **kw), arrays, rng)


# (x shape, w shape, kwargs)
TRANSPOSE_CASES = {
    "s2_valid_k2": ((2, 5, 6, 4), (2, 2, 4, 8), dict(stride=2)),
    "s2_same_relu_pool": ((2, 5, 6, 4), (3, 3, 4, 4),
                          dict(stride=2, padding="SAME", relu=True,
                               pool=True)),
    "s3_same_groups4": ((1, 4, 5, 4), (2, 2, 1, 4),
                        dict(stride=3, padding="SAME", groups=4)),
    "s2_out_spatial": ((1, 5, 5, 4), (3, 3, 4, 4),
                       dict(stride=2, padding="SAME", out_spatial=(10, 9),
                            relu=True)),
    "s2_pipelined_relu": ((2, 5, 6, 4), (2, 2, 4, 8),
                          dict(stride=2, relu=True, pipelined=True)),
}


@pytest.mark.parametrize("case", sorted(TRANSPOSE_CASES))
def test_conv2d_transpose_grads_equal_reference(case):
    xs, ws, kw = TRANSPOSE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    arrays = [_f32(rng, *xs), _f32(rng, *ws), _f32(rng, ws[3])]
    _check_vjp(lambda *a: jops.conv2d_transpose(*a, **kw),
               lambda *a: tops.conv2d_transpose(*a, **kw), arrays, rng)


@pytest.mark.parametrize("transpose", [False, True])
def test_pipelined_primal_runs_the_pipelined_kernel(monkeypatch, transpose):
    """Under autograd the forward runs the kernel ``pipelined=`` picks
    (epilogue-free), as the reference's primal does; the backward's
    kernels are ``pipelined``-blind."""
    from repro_torch.kernels import conv2d_ws_trans
    mod = conv2d_ws_trans if transpose else tops
    calls = []
    for name in ("conv2d_ws", "conv2d_ws_pipe"):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(9)
    x, w = _t(_f32(rng, 1, 6, 6, 4), True), _t(_f32(rng, 3, 3, 4, 4), True)
    fn = tops.conv2d_transpose if transpose else tops.conv2d
    for pipelined in (False, True):
        calls.clear()
        y = fn(x, w, padding="SAME", relu=True, pipelined=pipelined)
        assert y.grad_fn is not None and y.grad_fn.cfg.pipelined == pipelined
        assert calls == ["conv2d_ws_pipe" if pipelined else "conv2d_ws"]


@pytest.mark.parametrize("size", [2, 3])
def test_maxpool_first_routes_ties_like_reduce_window(size):
    """The trainer's max-pool node: values equal ``maxpool2d_ref``, and
    the gradient of a tied window goes to its first maximum, as
    ``jax.vjp`` of the reference's ``reduce_window`` max routes it."""
    rng = np.random.default_rng(10 + size)
    y = np.maximum(_f32(rng, 2, 7, 8, 3) - 1, 0)  # ReLU: zero ties
    y[0, 0:size, 0:size, 0] = 1.5                  # a whole-window tie
    out, vjp = jax.vjp(lambda a: jref.maxpool2d_ref(a, size), jnp.asarray(y))
    probe = _f32(rng, *out.shape)
    yt = _t(y, True)
    got = tref.maxpool_first_ref(yt, size)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    (grad,) = torch.autograd.grad(got, yt, torch.from_numpy(probe))
    np.testing.assert_array_equal(grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(probe))[0]))


@pytest.mark.parametrize("bias", [True, False])
def test_matmul_ws_grads_equal_reference(bias):
    rng = np.random.default_rng(3 + bias)
    arrays = [_f32(rng, 16, 12), _f32(rng, 12, 8)]
    if bias:
        arrays.append(_f32(rng, 8))
    _check_vjp(jops.matmul_ws, tops.matmul_ws, arrays, rng)


def test_matmul_ws_int8_backward_raises():
    rng = np.random.default_rng(4)
    xi = torch.from_numpy(rng.integers(-128, 128, (4, 5)).astype(np.int8))
    wi = torch.from_numpy(rng.integers(-128, 128, (5, 3)).astype(np.int8))
    with pytest.raises(TypeError, match="float"):
        tops.matmul_ws_backward(xi, wi, None, torch.ones(4, 3))
    xb, wb = torch.randn(4, 5).bfloat16(), torch.randn(5, 3).bfloat16()
    dx, dw, db = tops.matmul_ws_backward(xb, wb, torch.zeros(3),
                                         torch.ones(4, 3))
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert db.dtype == torch.float32 and db.shape == (3,)


def test_sub2x2_pool_raises_under_autograd_like_the_primal():
    rng = np.random.default_rng(5)
    x, w = _t(_f32(rng, 1, 3, 3, 4), True), _t(_f32(rng, 3, 3, 4, 4), True)
    with pytest.raises(ValueError, match="2×2 pool"):
        with torch.no_grad():
            tops.conv2d(x, w, relu=True, pool=True)
    with pytest.raises(ValueError, match="2×2 pool"):
        tops.conv2d(x, w, relu=True, pool=True)


def test_first_layer_computes_no_input_grad(monkeypatch):
    """``needs_input_grad``: a conv whose input needs no gradient runs no
    input-gradient conv; its weight and bias still get theirs."""
    calls = []
    real = tops.conv2d_ws_input_grad
    monkeypatch.setattr(tops, "conv2d_ws_input_grad",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(6)
    x = _t(_f32(rng, 1, 6, 6, 4))
    w, b = _t(_f32(rng, 3, 3, 4, 4), True), _t(_f32(rng, 4), True)
    y = tops.conv2d(x, w, b, padding="SAME", relu=True)
    y2 = tops.conv2d(y, w, b, padding="SAME")
    dw, db = torch.autograd.grad(y2.sum(), (w, b))
    assert len(calls) == 1 and dw.shape == w.shape and db.shape == b.shape


def test_inference_runs_the_fused_kernel_path():
    """Without autograd recording, ``ops.conv2d`` returns the fused
    result with no graph attached."""
    rng = np.random.default_rng(7)
    x, w = _t(_f32(rng, 1, 6, 6, 4)), _t(_f32(rng, 3, 3, 4, 4), True)
    with torch.no_grad():
        y = tops.conv2d(x, w, relu=True, pool=True)
    assert y.grad_fn is None and y.shape == (1, 2, 2, 4)


# ---------------------------------------------------------------------------
# Part of the scalar conv path: tiles for whole-map f32 layers
# ---------------------------------------------------------------------------


def _zoo_f32_geometries():
    """(label, ConvGeom) of every f32 conv ``float_forward`` launches for
    ``vgg_imagenet`` at 224 and ``unet_small`` at 224×224×4, forward and
    input gradient (the transposed lowering), batch 8, whole map."""
    out = []
    for plan in (tnet.vgg_imagenet(),
                 tnet.unet_small(input_shape=(224, 224, 4))):
        acts, ins = plan.activation_shapes(), plan.resolved_inputs()
        shapes, geoms = plan.param_shapes(), plan.conv_geometries()
        for i, sp in enumerate(plan.layers):
            if sp.kind not in ("conv", "conv_transpose"):
                continue
            h, w, c = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
            kh, kw, cg, k = shapes[i]["w"]
            cb, kb = tref.grouped_banks(c, k, geoms[i][1])
            if sp.kind == "conv":
                fwd = ((8, h, w, c), (kh, kw, cg, k), sp.stride, sp.padding)
                oh, ow = tref.conv_out_shape(h, w, kh, kw, sp.stride,
                                             sp.padding)
                bwd_in = transpose_eq_conv_geometry(
                    oh, ow, kh, kw, sp.stride, sp.padding, 1, (h, w))
            else:
                eh, ew, pad = transpose_eq_conv_geometry(
                    h, w, kh, kw, sp.stride, sp.padding)
                fwd = ((8, eh, ew, c), (kh, kw, cg, k), 1, pad)
                bwd_in = None
            out.append((f"{plan.name}.{i} fwd", setup_conv(
                fwd[0], fwd[1], stride=fwd[2], padding=fwd[3], pool=sp.pool,
                cin_banks=cb, kout_banks=kb, int_path=False)))
            if bwd_in is not None:
                eh, ew, pad = bwd_in
                cb2, kb2 = tref.grouped_banks(k, c, geoms[i][1])
                out.append((f"{plan.name}.{i} dx", setup_conv(
                    (8, eh, ew, k), (kh, kw, k, c), padding=pad,
                    cin_banks=cb2, kout_banks=kb2, int_path=False)))
    return out


@pytest.mark.parametrize("slots", [1, 2])
def test_scalar_tiles_fit_keep_cin_banks_and_pool_alignment(slots):
    geoms = _zoo_f32_geometries()
    refits = 0
    for label, g in geoms:
        f = scalar_tiles(g, slots)
        assert smem_bytes(f, slots) <= SMEM_BYTES, label
        assert (f.cin_banks, f.cb, f.poh, f.pow_) == (
            g.cin_banks, g.cb, g.poh, g.pow_), label
        assert f.k % f.kout_banks == 0 and f.kout_banks % g.kout_banks == 0
        assert f.kb * f.kout_banks == f.k and f.bpg * (f.c // f.cgrp) == \
            f.kout_banks
        pool = g.pth != g.th
        if pool:
            assert f.th % 2 == 0 and f.tw % 2 == 0 and f.pth == f.th // 2
        assert f.n_th == -(-(2 * f.poh if pool else f.poh) // f.th)
        refits += f != g
    names = [lb for lb, _ in geoms]
    assert "vgg_imagenet.0 fwd" in names and "unet_small.8 fwd" in names
    # all six vgg_imagenet convs overflow whole-map (1.8 MB at conv 0)
    assert smem_bytes(geoms[0][1], 1) == 1_810_224
    assert refits >= 6


def test_scalar_tiles_keep_a_plan_that_fits_and_refuse_the_impossible():
    g = setup_conv((8, 30, 30, 32), (3, 3, 32, 64), padding="SAME",
                   h_tile=8, w_tile=10, pool=True, int_path=False)
    assert scalar_tiles(g, 2) is g
    # one 1×1 output of one kernel already needs a 3×3×4096 f32 window
    big = setup_conv((1, 4, 4, 4096), (3, 3, 4096, 8), cin_banks=1,
                     kout_banks=8, int_path=False)
    with pytest.raises(ValueError, match=r"\[1,4,4,4096\]"):
        scalar_tiles(big, 1)
