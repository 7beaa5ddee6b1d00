"""The PyTorch port's integer geometry and plain oracles against the JAX
reference (``repro_torch.kernels.ref`` vs ``repro.kernels.ref``).

Inputs are made with numpy from a seed and handed to both packages; integer
results must be bit-equal, f32 results agree within rtol = atol = 1e-4."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

PADDINGS = ("SAME", "VALID", 1, ((0, 2), (1, 0)))


def _i8(rng, shape):
    return rng.integers(-128, 128, size=shape).astype(np.int8)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert np.asarray(j).dtype == t.numpy().dtype


# ---------------------------------------------------------------------------
# integer geometry
# ---------------------------------------------------------------------------

GEOM_SWEEP = list(itertools.product(
    (1, 5, 12, 16), (1, 2, 3), (1, 3, 5), (1, 2, 4), PADDINGS))


@pytest.mark.parametrize("fn", ["normalize_padding", "conv_out_shape"])
def test_padding_and_out_shape_match_reference(fn):
    for h, stride, k, dil, pad in GEOM_SWEEP:
        if fn == "normalize_padding":
            args = (pad, k, k, stride, h, h + 1, dil)
        else:
            args = (h, h + 1, k, k, stride, pad, dil)
        assert getattr(tref, fn)(*args) == getattr(jref, fn)(*args), args


def test_halo_and_extent_match_reference():
    for tile, stride, k, dil in itertools.product(
            (1, 2, 7, 16), (1, 2, 3), (1, 3, 5), (1, 2, 4)):
        assert tref.halo_window(tile, stride, k, dil) == \
            jref.halo_window(tile, stride, k, dil)
        assert tref.dilated_extent(k, dil) == jref.dilated_extent(k, dil)


def test_bank_degradation_matches_reference():
    for dim, want in itertools.product(range(1, 33), (1, 2, 4, 8)):
        assert tref.divisor_banks(dim, want) == jref.divisor_banks(dim, want)
    for c, k, g in itertools.product((1, 4, 8, 12, 16, 32), (4, 8, 16, 32),
                                     (1, 2, 4, 8, 16)):
        if c % g or k % g:
            with pytest.raises(ValueError, match="must divide both"):
                tref.grouped_banks(c, k, g)
            continue
        for want in ((4, 4), (2, 8), (8, 16)):
            assert tref.grouped_banks(c, k, g, *want) == \
                jref.grouped_banks(c, k, g, *want), (c, k, g, want)


# ---------------------------------------------------------------------------
# conv oracles
# ---------------------------------------------------------------------------

CONV_CASES = [
    dict(stride=1, padding="SAME", groups=1, dilation=1),
    dict(stride=2, padding="VALID", groups=1, dilation=1),
    dict(stride=1, padding=((1, 2), (0, 1)), groups=2, dilation=2),
    dict(stride=2, padding="SAME", groups=8, dilation=1),
]


@pytest.mark.parametrize("case", CONV_CASES)
def test_int8_conv_oracle_bit_equal(case):
    rng = np.random.default_rng(1)
    x = _i8(rng, (2, 11, 9, 8))
    w = _i8(rng, (3, 3, 8 // case["groups"], 16))
    b = rng.integers(-5000, 5000, size=(16,)).astype(np.int32)
    want = jref.conv2d_ref_int8(*map(jnp.asarray, (x, w, b)), **case)
    got = tref.conv2d_ref_int8(*(torch.from_numpy(a) for a in (x, w, b)),
                               **case)
    _eq(want, got)


def test_int8_conv_oracle_is_exact_where_int8_conv_wraps():
    """``F.conv2d`` on int8 tensors returns the result mod 256; the oracle
    upcasts first, so it stays exact (and the wrap8 oracle wraps)."""
    x = np.full((1, 4, 4, 4), 127, np.int8)
    w = np.full((3, 3, 4, 2), 127, np.int8)
    jx, tx = _both(x)
    jw, tw = _both(w)
    got = tref.conv2d_ref_int8(tx, tw)
    _eq(jref.conv2d_ref_int8(jx, jw), got)
    assert int(got.max()) == 127 * 127 * 9 * 4
    wrapped = F.conv2d(tx.permute(0, 3, 1, 2), tw.permute(3, 2, 0, 1))
    assert wrapped.dtype == torch.int8
    assert not torch.equal(wrapped.permute(0, 2, 3, 1).to(torch.int32), got)
    _eq(jref.conv2d_ref_wrap8(jx, jw), tref.conv2d_ref_wrap8(tx, tw))


@pytest.mark.parametrize("case", CONV_CASES)
def test_float_conv_oracle_matches(case):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 10, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8 // case["groups"], 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    want = jref.conv2d_ref(*map(jnp.asarray, (x, w, b)), **case)
    got = tref.conv2d_ref(*(torch.from_numpy(a) for a in (x, w, b)), **case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("relu,pool,scale", [
    (True, True, 0.013), (False, True, None), (True, False, "per_k")])
def test_epilogue_oracle_bit_equal(relu, pool, scale):
    rng = np.random.default_rng(3)
    x = _i8(rng, (2, 9, 10, 4))
    w = _i8(rng, (3, 3, 4, 8))
    b = rng.integers(-3000, 3000, size=(8,)).astype(np.int32)
    if scale == "per_k":
        scale = (rng.random(8) * 0.02).astype(np.float32)
    kw = dict(stride=1, padding="SAME", relu=relu, pool=pool)
    want = jref.conv2d_epilogue_ref(
        *map(jnp.asarray, (x, w, b)),
        out_scale=None if scale is None else jnp.asarray(scale), **kw)
    got = tref.conv2d_epilogue_ref(
        *(torch.from_numpy(a) for a in (x, w, b)),
        out_scale=None if scale is None else torch.as_tensor(scale), **kw)
    _eq(want, got)


# ---------------------------------------------------------------------------
# pools, requantize, merges, GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.float32])
def test_pools_bit_equal(dtype):
    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, size=(2, 7, 9, 5)).astype(dtype)
    if dtype == np.float32:
        x = x * np.float32(0.37)
    jx, tx = _both(x)
    _eq(jref.maxpool2d_ref(jx), tref.maxpool2d_ref(tx))
    _eq(jref.maxpool2d_ref(jx, 3), tref.maxpool2d_ref(tx, 3))
    for fn in ("avgpool2d_ref", "global_avgpool_ref"):
        want, got = getattr(jref, fn)(jx), getattr(tref, fn)(tx)
        if dtype == np.float32:        # f32 sums in another order
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
        else:
            _eq(want, got)


def test_int_avgpool_rounds_half_to_even():
    # window sums 2 and 6 over 4 cells: means 0.5 → 0 and 1.5 → 2
    x = np.array([[1, 1, 3, 3], [0, 0, 0, 0]], np.int8).reshape(1, 2, 4, 1)
    jx, tx = _both(x)
    got = tref.avgpool2d_ref(tx, 2)
    _eq(jref.avgpool2d_ref(jx, 2), got)
    assert got.flatten().tolist() == [0, 2]
    g = np.array([[1, 3]], np.int8).reshape(1, 1, 2, 1)
    _eq(jref.global_avgpool_ref(jnp.asarray(g)),
        tref.global_avgpool_ref(torch.from_numpy(g)))
    assert int(tref.global_avgpool_ref(torch.from_numpy(g))) == 2


def test_requantize_bit_equal_with_half_even_ties():
    acc = np.array([1, 3, 5, -1, -3, 255, 257, -257, 10 ** 6, -10 ** 6,
                    0, 7], np.int32)
    for scale in (np.float32(0.5), (np.arange(12) % 3 * 0.25 + 0.5)
                  .astype(np.float32)):
        want = jref.requantize_ref(jnp.asarray(acc), jnp.asarray(scale))
        got = tref.requantize_ref(torch.from_numpy(acc),
                                  torch.as_tensor(scale))
        _eq(want, got)
    ties = tref.requantize_ref(torch.tensor([1, 3, 5, -1]), 0.5)
    assert ties.tolist() == [0, 2, 2, 0]                # half to even
    fa = np.linspace(-300, 300, 50).astype(np.float32)
    _eq(jref.requantize_ref(jnp.asarray(fa), 0.37),
        tref.requantize_ref(torch.from_numpy(fa), 0.37))


@pytest.mark.parametrize("relu", [False, True])
def test_add_requant_bit_equal(relu):
    rng = np.random.default_rng(5)
    a = _i8(rng, (3, 4, 4, 6))
    b = _i8(rng, (3, 4, 4, 6))
    a[0, 0, 0, :2] = (1, 3)                      # × 0.5: ties at .5 and 1.5
    for sa, sb in ((0.5, 0.5), (0.731, 1.37), (1.0, 1.0)):
        want = jref.add_requant_ref(jnp.asarray(a), jnp.asarray(b), sa, sb,
                                    relu=relu)
        got = tref.add_requant_ref(torch.from_numpy(a), torch.from_numpy(b),
                                   sa, sb, relu=relu)
        _eq(want, got)


def test_matmul_oracles():
    rng = np.random.default_rng(6)
    x, w = _i8(rng, (5, 70)), _i8(rng, (70, 9))
    b = rng.integers(-1000, 1000, size=(9,)).astype(np.int32)
    _eq(jref.matmul_ref_int8(*map(jnp.asarray, (x, w, b))),
        tref.matmul_ref_int8(*(torch.from_numpy(a) for a in (x, w, b))))
    xf, wf = x.astype(np.float32) / 7, w.astype(np.float32) / 11
    bf = b.astype(np.float32) / 13
    np.testing.assert_allclose(
        tref.matmul_ref(*(torch.from_numpy(a) for a in (xf, wf, bf))).numpy(),
        np.asarray(jref.matmul_ref(*map(jnp.asarray, (xf, wf, bf)))),
        rtol=1e-4, atol=1e-4)
