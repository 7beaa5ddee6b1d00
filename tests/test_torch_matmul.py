"""``matmul_ws`` of the port on the CPU: its bf16 plain version against the
reference's ``ops.matmul_ws`` (Pallas in interpret mode), the form rule
``mm_path``, the stream and simt forms' K splits and their CPU emulations
(``matmul_ws_stream_emulate`` and ``matmul_ws_simt_emulate``, against the
plain version and the reference), int8 at long M with ragged K and N, and
the C entries' signatures.

A bf16 result is f32 products and sums plus the bias, rounded once to bf16,
on both sides, from sums taken in another order.  So two results may differ
by the two roundings, at most one bf16 ulp of the larger magnitude, plus the
two f32 sums' own rounding, (K + 1)·2^-23·(|x|·|w| + |b|)
(``test_torch_cuda.bf16_gemm_bound``, by which the card tests hold each form)."""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import matmul_ws as mm
from repro_torch.kernels import ops
from repro_torch.core import network as tnet
from repro_torch.kernels import ref as tref
from test_torch_cuda import (LM_BWD_SHAPES, MM_CASES, bf16_gemm_bound,
                             f32_sum_bound, mm_case_inputs)

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def _bf16_operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    return x.bfloat16(), w.bfloat16(), b


def _to_jax(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("m", [1, 4, 8, 65])
@pytest.mark.parametrize("k,n", [(70, 33), (200, 264)])
@pytest.mark.parametrize("bias", [True, False])
def test_bf16_plain_matches_reference(m, k, n, bias):
    x, w, b = _bf16_operands(m, k, n, seed=m * k + n)
    b = b if bias else None
    want = jops.matmul_ws(_to_jax(x), _to_jax(w),
                          None if b is None else _to_jax(b))
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    before = mm.matmul_ws.launches
    for got in (ops.matmul_ws(x, w, b), mm.matmul_ws_plain(x, w, b)):
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        err = (got.float() - want).abs()
        assert bool((err <= bf16_gemm_bound(x, w, b, got, want)).all()), \
            float(err.max())
    assert mm.matmul_ws.launches == before       # CPU tensors: plain


@pytest.mark.parametrize("dtype,m,k,n,path", [
    (torch.bfloat16, 3000, 3072, 8192, "wgmma"),
    (torch.bfloat16, 17, 8192, 3072, "wgmma"),
    (torch.bfloat16, 16, 3072, 8192, "stream"),
    (torch.bfloat16, 4, 8192, 3072, "stream"),
    (torch.bfloat16, 1, 200, 264, "stream"),
    (torch.bfloat16, 4, 70, 264, "scalar"),      # K·2 bytes not a 16-multiple
    (torch.bfloat16, 64, 200, 33, "scalar"),     # nor N·2
    (torch.bfloat16, 3000, 3076, 8192, "scalar"),
    (torch.int8, 8, 256, 1000, "stream"),       # the vgg_imagenet head
    (torch.int8, 8, 64, 10, "scalar"),          # N not a multiple of 8
    (torch.int8, 16, 70, 64, "stream"),
    (torch.int8, 17, 256, 1000, "mma"),         # a head at batch 17
    (torch.float32, 4, 3072, 8192, "simt"),
    (torch.float32, 3000, 3072, 8192, "simt"),
    (torch.int8, 3000, 3072, 8192, "mma"),      # w8 prefill
    (torch.int8, 65, 70, 264, "scalar"),        # K not a multiple of 4
    (torch.int8, 17, 200, 266, "scalar"),       # nor N
    (torch.int8, 8, 64, 12, "mma"),             # N a 4- but not 8-multiple
    (torch.float32, 65, 27, 1000, "simt"),      # every f32 GEMM
    (torch.float32, 3, 70, 33, "simt"),
])
def test_mm_path_by_geometry(dtype, m, k, n, path):
    assert mm.mm_path(m, k, n, dtype) == path


@pytest.mark.parametrize("m,n,bn", [(64, 8192, 128), (256, 8192, 128),
                                    (512, 8192, 256), (3000, 8192, 256),
                                    (512, 3072, 128), (3000, 3072, 256),
                                    (17, 264, 128)])
def test_wgmma_tile_width_fills_the_card(m, n, bn):
    assert mm.wgmma_bn(m, n) == bn


def test_mm_path_refuses_other_dtypes():
    with pytest.raises(TypeError, match="no kernel"):
        mm.mm_path(4, 8, 8, torch.float16)
    with pytest.raises(TypeError, match="one type"):
        mm.matmul_ws(torch.zeros((2, 8), dtype=torch.bfloat16),
                     torch.zeros((8, 8)))


@pytest.mark.parametrize("m,k,n", [(4, 3072, 8192), (4, 8192, 3072),
                                   (8, 256, 1000), (8, 512, 64),
                                   (16, 200, 264), (1, 100_000, 8),
                                   (2, 8, 65_536)])
def test_stream_plan_slices_cover_k(m, k, n):
    split, kc = mm.stream_plan(m, k, n)
    assert kc % 32 == 0 and kc <= mm.STREAM_MAX_KC
    assert (split - 1) * kc < k <= split * kc


def test_stream_plan_at_the_main_paths_shapes():
    # decode: 384 blocks of 256 rows; the head: one slice, one launch
    assert mm.stream_plan(4, 3072, 8192) == (12, 256)
    assert mm.stream_plan(4, 8192, 3072) == (32, 256)
    assert mm.stream_plan(8, 256, 1000) == (1, 256)
    # recurrentgemma-9b's decode: K in 11 and in 32 slices of 384 rows
    assert mm.stream_plan(4, 4096, 12288) == (11, 384)
    assert mm.stream_plan(4, 12288, 4096) == (32, 384)


def _vgg_tap_shapes(batch=8):
    """The (M, K, N) of ``vgg_imagenet``'s weight-gradient taps at 224 and
    ``batch``: [C/g, batch·OH·OW] @ [batch·OH·OW, K/g], KH·KW·g of each
    conv (``conv2d_ws_bwd``)."""
    plan = tnet.vgg_imagenet()
    acts, ins = plan.activation_shapes(), plan.resolved_inputs()
    shapes, geoms = plan.param_shapes(), plan.conv_geometries()
    out = []
    for i, sp in enumerate(plan.layers):
        if sp.kind != "conv":
            continue
        h, w, _ = plan.input_shape if ins[i][0] < 0 else acts[ins[i][0]]
        kh, kw, cg, k = shapes[i]["w"]
        oh, ow = tref.conv_out_shape(h, w, kh, kw, sp.stride, sp.padding)
        out.append((cg, batch * oh * ow, k // geoms[i][1]))
    return out


def test_vgg_tap_shapes():
    assert _vgg_tap_shapes() == [(4, 401408, 32), (32, 401408, 32),
                                 (32, 100352, 64), (64, 25088, 128),
                                 (128, 6272, 256), (256, 1568, 256)]


def _lm_bwd_gemms():
    """The f32 GEMMs of ``matmul_ws``'s VJP at ``LM_BWD_SHAPES``: dx =
    g @ wᵀ and dw = xᵀ @ g."""
    return sorted({s for m, k, n in LM_BWD_SHAPES
                   for s in ((m, n, k), (k, m, n))})


@pytest.mark.parametrize("m,k,n", [(4, 401408, 32), (32, 401408, 32),
                                   (32, 100352, 64), (64, 25088, 128),
                                   (128, 6272, 256), (256, 1568, 256),
                                   (4096, 3072, 8192), (3072, 4096, 8192),
                                   (8, 256, 1000), (256, 8, 1000),
                                   (3, 70, 33), (65, 27, 1000), (1, 1, 1),
                                   (4, 3000, 32), (33, 1000, 20)])
def test_simt_plan_slices_cover_k(m, k, n):
    tile, split, kc = mm.simt_plan(m, k, n)
    assert tile in mm.SIMT_TILES
    assert kc % mm.SIMT_BK == 0 and 1 <= split <= 65535
    assert (split - 1) * kc < k <= split * kc


def test_simt_plan_at_the_main_paths_shapes():
    """The LM backward's GEMMs fill the card with their tiles and take K
    whole; every ``vgg_imagenet`` tap (M of 4-256 against K to 401,408)
    splits it."""
    for m, k, n in _lm_bwd_gemms() + list(LM_BWD_SHAPES):
        tile, split, _ = mm.simt_plan(m, k, n)
        assert (tile.bm, split) == (128, 1), (m, k, n)
    for m, k, n in _vgg_tap_shapes():
        tile, split, kc = mm.simt_plan(m, k, n)
        assert split > 1 and tile.bm <= max(8, m), (m, k, n)
        tiles = -(-m // tile.bm) * -(-n // tile.bn)
        assert tiles < mm.SIMT_SPLIT_BELOW and kc >= mm.SIMT_MIN_KC, \
            (m, k, n)


def test_simt_tiles_match_the_source():
    """Each tile fills a block of 256 threads with whole thread groups that
    share a stage's K rows, and the source instantiates the same tiles."""
    src = (CSRC / "matmul_ws.cu").read_text()
    found = re.findall(r"using T\d+ = Tile<(\d+), (\d+), (\d+), (\d+)>;",
                       src)
    assert [tuple(map(int, f)) for f in found] == [
        (t.bm, t.bn, t.tm, t.tn) for t in mm.SIMT_TILES]
    assert re.search(rf"constexpr int BK = {mm.SIMT_BK};", src)
    for t in mm.SIMT_TILES:
        assert (t.bm // t.tm) * (t.bn // t.tn) * t.groups == 256
        assert mm.SIMT_BK % t.groups == 0 and t.tm % 4 == 0 == t.tn % 4


def _np_f32(m, k, n, seed, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if bias else None
    return x, w, b


SIMT_CASES = [(3, 70, 33, True), (8, 256, 1000, True), (65, 27, 1000, False),
              (4, 3000, 32, True), (33, 1000, 20, True), (40, 72, 96, False),
              (130, 200, 136, True)]


@pytest.mark.parametrize("m,k,n,bias", SIMT_CASES)
def test_simt_form_emulation_equals_plain_and_reference(m, k, n, bias):
    """``matmul_ws_simt_emulate`` (K in ``simt_plan``'s slices, partials
    added after the bias in slice order) within ``f32_sum_bound`` of the
    float64 product, and within 1e-4 of ``matmul_ws_plain`` and of the
    reference's f32 ``ops.matmul_ws`` (Pallas in interpret mode), on the
    same numpy operands."""
    xn, wn, bn = _np_f32(m, k, n, seed=m * k + n, bias=bias)
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    b = None if bn is None else torch.from_numpy(bn)
    assert mm.mm_path(m, k, n, torch.float32) == "simt"
    got = mm.matmul_ws_simt_emulate(x, w, b)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    x64, w64 = x.double(), w.double()
    want64 = x64 @ w64 + (0 if b is None else b.double())
    s = x64.abs() @ w64.abs() + (0 if b is None else b.double().abs())
    err = (got.double() - want64).abs()
    assert bool((err <= f32_sum_bound(k + 1, s)).all()), float(err.max())
    torch.testing.assert_close(got, mm.matmul_ws_plain(x, w, b), rtol=1e-4,
                               atol=1e-4)
    ref = jops.matmul_ws(jnp.asarray(xn), jnp.asarray(wn),
                         None if bn is None else jnp.asarray(bn))
    assert ref.dtype == jnp.float32
    torch.testing.assert_close(got, torch.from_numpy(np.array(ref)),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, mm.matmul_ws_simt_emulate(x, w, b))


def test_simt_form_emulation_sums_in_the_kernels_order():
    """Where K splits, the bias comes first and each slice's partial is
    added in slice order: the result equals that order spelled out, and
    a tap-like shape does split."""
    m, k, n = 4, 3000, 32
    tile, split, kc = mm.simt_plan(m, k, n)
    assert split > 1 and tile.bm == 8
    xn, wn, bn = _np_f32(m, k, n, seed=5)
    x, w, b = (torch.from_numpy(t) for t in (xn, wn, bn))
    out = b.expand(m, n).clone()
    for s_ in range(split):
        lo, hi = s_ * kc, min((s_ + 1) * kc, k)
        out += x[:, lo:hi] @ w[lo:hi]
    assert torch.equal(mm.matmul_ws_simt_emulate(x, w, b), out)
    # another order of the same partials is another result
    parts = [x[:, s_ * kc:(s_ + 1) * kc] @ w[s_ * kc:(s_ + 1) * kc]
             for s_ in range(split)]
    rev = b.expand(m, n).clone()
    for p_ in reversed(parts):
        rev += p_
    assert not torch.equal(rev, out)


@pytest.mark.parametrize("m,k,n,dtype", [(3000, 3072, 8192, torch.bfloat16),
                                         (17, 200, 264, torch.int8),
                                         (4, 64, 64, torch.bfloat16)])
def test_simt_form_emulation_refuses_other_forms(m, k, n, dtype):
    x = torch.zeros((m, k), dtype=dtype)
    w = torch.zeros((k, n), dtype=dtype)
    with pytest.raises(ValueError, match="not the simt form"):
        mm.matmul_ws_simt_emulate(x, w)


@pytest.mark.parametrize("m,k,n,bias,form", [
    (17, 200, 264, True, "mma"), (65, 70, 264, True, "scalar"),
    (33, 68, 100, False, "mma"), (40, 256, 1000, True, "mma"),
    (24, 36, 30, True, "scalar")])
def test_int8_plain_at_long_m_equals_reference(m, k, n, bias, form):
    """int8 at M > 16 with K and N off the tiles: ``matmul_ws_plain``
    (what the mma and scalar forms must equal on the card) equal to the
    reference's int32 ``ops.matmul_ws``, on the form ``mm_path`` names."""
    assert mm.mm_path(m, k, n, torch.int8) == form
    rng = np.random.default_rng(m + k + n)
    xn = rng.integers(-128, 128, (m, k), dtype=np.int8)
    wn = rng.integers(-128, 128, (k, n), dtype=np.int8)
    bn = rng.integers(-4000, 4000, (n,), dtype=np.int32) if bias else None
    got = mm.matmul_ws_plain(torch.from_numpy(xn), torch.from_numpy(wn),
                             None if bn is None else torch.from_numpy(bn))
    ref = jops.matmul_ws(jnp.asarray(xn), jnp.asarray(wn),
                         None if bn is None else jnp.asarray(bn))
    assert got.dtype == torch.int32 and ref.dtype == jnp.int32
    assert torch.equal(got, torch.from_numpy(np.array(ref)))


STREAM_CASES = sorted({c for c in MM_CASES
                       if c[3] != "float32"
                       and mm.mm_path(c[0], c[1], c[2],
                                      getattr(torch, c[3])) == "stream"})


def _ref_matmul(x, w, b):
    """The reference's ``ops.matmul_ws`` (Pallas in interpret mode) on the
    same operands → a torch tensor (int32, or bf16 values as f32)."""
    def j(t):
        if t is None:
            return None
        dt = {torch.int8: jnp.int8, torch.int32: jnp.int32,
              torch.bfloat16: jnp.bfloat16}.get(t.dtype, jnp.float32)
        return jnp.asarray(t.float().numpy()).astype(dt)
    out = jops.matmul_ws(j(x), j(w), j(b))
    if out.dtype == jnp.bfloat16:
        out = out.astype(jnp.float32)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("m,k,n,dtype,bias", STREAM_CASES)
def test_stream_form_emulation_equals_plain_and_reference(m, k, n, dtype,
                                                          bias):
    """``matmul_ws_stream_emulate`` replays the stream form's split-K
    slices and fixed-order reduce on CPU tensors: int8 equal to
    ``matmul_ws_plain`` and to the reference, bf16 within
    ``bf16_gemm_bound`` of each."""
    x, w, b = mm_case_inputs(m, k, n, dtype, bias)
    got = mm.matmul_ws_stream_emulate(x, w, b)
    want = mm.matmul_ws_plain(x, w, b)
    ref = _ref_matmul(x, w, b)
    assert got.dtype == want.dtype and got.shape == (m, n)
    if dtype == "int8":
        assert torch.equal(got, want) and torch.equal(got, ref)
        return
    for other in (want, ref.bfloat16()):
        err = (got.float() - other.float()).abs()
        assert bool((err <= bf16_gemm_bound(x, w, b, got, other)).all()), \
            float(err.max())
    assert torch.equal(got, mm.matmul_ws_stream_emulate(x, w, b))


def test_stream_form_emulation_sums_in_the_kernels_order():
    """Where K splits, the slices' partials meet in slice order after each
    slice's eight warps meet in warp order: the result equals that order
    spelled out in float32, and the decode shapes do split."""
    assert mm.stream_plan(4, 3072, 8192)[0] == 12
    g = torch.Generator().manual_seed(3)
    m, k, n = 4, 2048, 64
    x = torch.randn((m, k), generator=g).bfloat16()
    w = torch.randn((k, n), generator=g).bfloat16()
    b = torch.randn((n,), generator=g)
    split, kc = mm.stream_plan(m, k, n)
    assert split > 1
    xf, wf = x.float(), w.float()
    out = b.expand(m, n).clone()
    for s_ in range(split):
        part = torch.zeros((m, n))
        for warp in range(mm.STREAM_WARPS):
            acc = torch.zeros((m, n))
            for r in range(s_ * kc + warp, min((s_ + 1) * kc, k),
                           mm.STREAM_WARPS):
                acc += xf[:, r:r + 1] * wf[r:r + 1]
            part += acc
        out += part
    assert torch.equal(mm.matmul_ws_stream_emulate(x, w, b), out.bfloat16())


@pytest.mark.parametrize("m,k,n,dtype", [(3000, 3072, 8192, torch.bfloat16),
                                         (17, 200, 264, torch.int8),
                                         (3, 70, 33, torch.bfloat16),
                                         (4, 64, 64, torch.float32)])
def test_stream_form_emulation_refuses_other_forms(m, k, n, dtype):
    x = torch.zeros((m, k), dtype=dtype)
    w = torch.zeros((k, n), dtype=dtype)
    with pytest.raises(ValueError, match="not the stream form"):
        mm.matmul_ws_stream_emulate(x, w)


def _c_params(src: str, name: str):
    sig = re.search(rf"int {name}\((.*?)\)\s*\{{", src, re.S).group(1)
    kinds = []
    for p in sig.split(","):
        p = p.strip()
        kinds.append(ctypes.c_void_p if "*" in p else ctypes.c_int)
    return kinds


def test_library_signatures_match_the_c_entries(monkeypatch):
    """``_library`` sets each entry's argtypes once; they must list the C
    parameters in order (a pointer passed as c_int would be cut)."""
    src = (CSRC / "matmul_ws.cu").read_text()

    class Fn:
        pass

    class Lib:
        matmul_ws_scalar, matmul_ws_stream, matmul_ws_wgmma = Fn(), Fn(), Fn()
        matmul_ws_simt, matmul_ws_mma = Fn(), Fn()

    monkeypatch.setattr(mm._build, "load", lambda name: Lib)
    mm._library.cache_clear()
    try:
        lib = mm._library()
    finally:
        mm._library.cache_clear()
    for name in ("matmul_ws_scalar", "matmul_ws_stream", "matmul_ws_wgmma",
                 "matmul_ws_simt", "matmul_ws_mma"):
        fn = getattr(lib, name)
        assert fn.argtypes == _c_params(src, name), name
        assert fn.restype is ctypes.c_int
