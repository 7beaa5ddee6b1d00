"""Transposed convolution in the port against the JAX reference.

The shape math (``conv_transpose_out_shape``, ``conv_transpose_eq_params``,
``transpose_eq_conv_geometry``) and the weight transforms are equal to the
reference's; the int8 oracle and the lowering (``conv2d_ws_transpose``,
``ops.conv2d_transpose``, on CPU tensors through the conv kernels' plain
versions) are bit-equal to the reference's ``ops.conv2d_transpose`` run
through the Pallas kernels in interpret mode over the whole map (int8
paths have no tolerance; the f32 path agrees within rtol = atol = 1e-4,
sums taken in another order).  The zoo's transposed-conv net
(``unet_small``) and the dilated one (``dilated_context``) give int8
logits bit-equal to the JAX program."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv2d_ws_trans as jtrans
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import conv2d_ws_trans as ttrans
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_program import check_logits_bit_equal

# (x shape, w shape, kwargs): stride 1/2/3, SAME/VALID/explicit (with a
# pad past the kernel extent, which crops), dilation, groups, out_spatial
CASES = {
    "s2_valid_k2": ((2, 5, 6, 8), (2, 2, 8, 16), dict(stride=2)),
    "s2_same_k3": ((1, 6, 5, 4), (3, 3, 4, 8),
                   dict(stride=2, padding="SAME")),
    "s3_valid_k3": ((1, 4, 4, 8), (3, 3, 8, 8), dict(stride=3)),
    "s1_same_dil2": ((2, 7, 7, 8), (3, 3, 8, 8),
                     dict(padding="SAME", dilation=2)),
    "s2_explicit": ((1, 5, 5, 8), (3, 3, 8, 8),
                    dict(stride=2, padding=((1, 2), (0, 1)))),
    "s2_explicit_crop": ((1, 6, 6, 4), (2, 2, 4, 8),
                         dict(stride=2, padding=((3, 0), (0, 3)))),
    "s2_groups2": ((2, 4, 4, 8), (2, 2, 4, 16),
                   dict(stride=2, groups=2)),
    "s2_depthwise": ((1, 5, 5, 8), (3, 3, 1, 8),
                     dict(stride=2, padding="SAME", groups=8)),
    "s2_out_spatial": ((1, 5, 5, 8), (3, 3, 8, 8),
                       dict(stride=2, padding="SAME", out_spatial=(10, 9))),
}


def _operands(xs, ws, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=xs).astype(np.int8)
    w = rng.integers(-128, 128, size=ws).astype(np.int8)
    b = rng.integers(-3000, 3000, size=(ws[3],)).astype(np.int32)
    return x, w, b


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_shape_math_matches_reference(case):
    xs, ws, kw = CASES[case]
    stride, padding = kw.get("stride", 1), kw.get("padding", "VALID")
    dil, out_sp = kw.get("dilation", 1), kw.get("out_spatial")
    args = (xs[1], xs[2], ws[0], ws[1], stride, padding, dil)
    assert tref.conv_transpose_eq_params(*args, out_sp) == \
        jref.conv_transpose_eq_params(*args, out_sp)
    assert ttrans.transpose_eq_conv_geometry(*args, out_sp) == \
        jtrans.transpose_eq_conv_geometry(*args, out_sp)
    if out_sp is None:
        assert tref.conv_transpose_out_shape(*args) == \
            jref.conv_transpose_out_shape(*args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_oracle_and_lowering_bit_equal_reference(case):
    """The port's int8 oracle, its lowering with an int32 result and with
    a per-channel requantize, against the reference's Pallas path."""
    xs, ws, kw = CASES[case]
    x, w, b = _operands(xs, ws, seed=len(case))
    geo = {k: v for k, v in kw.items() if k != "out_spatial"}
    want = np.asarray(jops.conv2d_transpose(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))
    assert np.array_equal(
        np.asarray(jref.conv2d_transpose_ref_int8(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)), want)
    tx, tw, tb = _t(x, w, b)
    got = tref.conv2d_transpose_ref_int8(tx, tw, tb, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.conv2d_transpose(tx, tw, tb, **kw).numpy(), want)
    scale = (60.0 / np.maximum(np.abs(want).reshape(-1, ws[3]).max(0), 1)
             ).astype(np.float32)
    want_q = np.asarray(jops.conv2d_transpose(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=True,
        out_scale=jnp.asarray(scale), **kw))
    for pipelined in (False, True):
        got_q = tops.conv2d_transpose(tx, tw, tb, relu=True,
                                      out_scale=torch.from_numpy(scale),
                                      pipelined=pipelined, **kw)
        assert got_q.dtype == torch.int8
        np.testing.assert_array_equal(got_q.numpy(), want_q)
    if "out_spatial" not in kw:
        np.testing.assert_array_equal(
            tref.conv2d_transpose_epilogue_ref(
                tx, tw, tb, relu=True, out_scale=torch.from_numpy(scale),
                **geo).numpy(), want_q)


def test_pooled_transpose_and_f32_path():
    """The fused 2×2 pool on a transposed conv (int8, bit-equal), and the
    f32 path within 1e-4."""
    x, w, b = _operands((2, 6, 6, 8), (3, 3, 8, 8), seed=4)
    kw = dict(stride=2, padding="SAME")
    want = np.asarray(jops.conv2d_transpose(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=True,
        pool=True, out_scale=0.01, **kw))
    tx, tw, tb = _t(x, w, b)
    got = ttrans.conv2d_ws_transpose(tx, tw, tb, 0.01, relu=True, pool=True,
                                     **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(5)
    xf = rng.normal(size=(2, 5, 5, 8)).astype(np.float32)
    wf = (rng.normal(size=(3, 3, 4, 8)) / 8).astype(np.float32)
    bf = rng.normal(size=(8,)).astype(np.float32)
    kw = dict(stride=2, padding="VALID", groups=2, dilation=2)
    want = np.asarray(jops.conv2d_transpose(
        jnp.asarray(xf), jnp.asarray(wf), jnp.asarray(bf), **kw))
    for fn in (tops.conv2d_transpose, tref.conv2d_transpose_ref):
        got = fn(*_t(xf, wf, bf), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_weight_transforms_match_reference(groups):
    rng = np.random.default_rng(groups)
    w = rng.normal(size=(3, 2, 8 // groups, 12)).astype(np.float32)
    for name in ("grouped_swap_weights", "grouped_transpose_weights"):
        np.testing.assert_array_equal(
            getattr(tref, name)(torch.from_numpy(w), groups).numpy(),
            np.asarray(getattr(jref, name)(jnp.asarray(w), groups)))


def test_lowering_rejects_what_the_reference_rejects():
    x, w, _ = _t(*_operands((1, 4, 4, 8), (3, 3, 8, 8), seed=0))
    with pytest.raises(ValueError, match="not invertible"):
        tops.conv2d_transpose(x, w, stride=2, out_spatial=(20, 9))
    with pytest.raises(ValueError, match="groups=3"):
        tops.conv2d_transpose(x, w, groups=3)


def test_flipped_weights_are_derived_once():
    w = torch.arange(2 * 2 * 4 * 8, dtype=torch.float32).reshape(2, 2, 4, 8)
    f = ttrans.flipped_weights(w)
    assert torch.equal(f, torch.flip(w, (0, 1)))
    assert ttrans.flipped_weights(w) is f        # per tensor ...
    w[0, 0, 0, 0] = -1.0                         # ... and version
    g = ttrans.flipped_weights(w)
    assert g is not f and g[1, 1, 0, 0] == -1.0


@pytest.mark.parametrize("net", ["unet_small", "dilated_context"])
def test_int8_logits_bit_equal_to_reference(net):
    check_logits_bit_equal(net)
