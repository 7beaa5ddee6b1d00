"""The CUDA kernels against their plain versions, on the card, and the LM
serving path on the card against the same path on the CPU.

The conv kernels take the int8 tensor-core path or the scalar path by
geometry (``conv2d_ws.conv_path``); every conv case asserts which one
launched.  ``TC_CASES`` are the tensor-core path's edges: narrow channel
counts (C = 1, 4, 8, 12; byte-gathered C = 6), eight outputs a group,
output widths that are not a multiple of the N-tile or of four (the
epilogue's one-channel form), partial rectangles at stride 2, several
K-chunks, int32 outputs, per-channel requantization, an all −128 layer
at 3×3×256 (signedness and int32 range) and a 5×5 layer whose
``conv2d_ws_pipe`` ring has one slot (a second would cost a block per SM).

Every test here launches a kernel of ``repro_torch`` and skips where no
NVIDIA GPU is present.  The file imports no JAX, so it also runs on a
machine without it::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The case table is shared with ``test_torch_kernels.py``, which holds the
plain versions against the JAX reference on the CPU.  Int paths are
``torch.equal``; f32 agrees within rtol = atol = 1e-4 (the kernels sum in
another order than cuDNN); bf16 attention outputs, each rounded once from
f32 sums taken in another order, agree within one bf16 ulp; bf16 GEMMs
within one bf16 ulp plus their f32 sums' rounding (``bf16_gemm_bound``).
``MM_CASES`` hold each ``matmul_ws`` form (``mm_path``) at its edges: M
from 1 to 3000 across the stream / wgmma boundary at 16, K and N off the
tiles, the head's N = 1000, and rows that are not 16-byte multiples;
``RG_MLP_CASES`` hold the stream and wgmma forms at recurrentgemma-9b's
gated-MLP shapes, where K reaches 12,288, and ``LM_MLP_CASES`` at
deepseek-moe-16b's shared experts', internvl2-26b's (K to 16,384) and
seamless-m4t-medium's.
``W8_SHAPES`` hold the int8 forms at w8 serving's GEMM shapes, and the
int8 KV cache's decode contractions are held to the CPU's int64 sums.
LM training: ``LM_BWD_SHAPES`` hold ``matmul_ws``'s f32 VJP at
llama3.2-3b's MLP backward shapes, ``flash_attention`` refuses autograd
on the card, and ``lm_train_step_card_vs_cpu`` (also run by
``chip_smoke.py``) holds one train step of a reduced model to the CPU's."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_ws import (conv2d_ws, conv2d_ws_plain,
                                           conv_path, setup_conv)
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.matmul_ws import matmul_ws, matmul_ws_plain, mm_path

# (x shape, w shape, conv2d kwargs, scale: None | "scalar" | "per_k")
CASES = {
    "same_relu_pool_requant": ((2, 12, 12, 8), (3, 3, 8, 8),
                               dict(padding="SAME", relu=True, pool=True),
                               "scalar"),
    "stride2_valid_int32": ((2, 13, 11, 8), (3, 3, 8, 16),
                            dict(stride=2, padding="VALID"), None),
    "explicit_dilation2_per_k": ((1, 12, 14, 4), (3, 3, 4, 8),
                                 dict(padding=((1, 2), (0, 3)), dilation=2,
                                      relu=True), "per_k"),
    "groups2": ((2, 10, 10, 8), (3, 3, 4, 8),
                dict(padding="SAME", groups=2, relu=True), "scalar"),
    "depthwise_stride2": ((2, 11, 11, 8), (3, 3, 1, 8),
                          dict(stride=2, padding="SAME", groups=8,
                               relu=True), "scalar"),
    "narrow_c1_pool": ((2, 12, 12, 1), (3, 3, 1, 8),
                       dict(padding="SAME", relu=True, pool=True,
                            cin_banks=1), "scalar"),
    "tiled_pool_requant": ((2, 14, 16, 8), (3, 3, 8, 8),
                           dict(padding="SAME", relu=True, pool=True,
                                h_tile=4, w_tile=6), "per_k"),
    "tiled_stride2_dilated": ((1, 15, 13, 8), (3, 3, 8, 8),
                              dict(stride=2, padding=((2, 1), (1, 2)),
                                   dilation=2, h_tile=3, w_tile=2), None),
    "tiled_depthwise": ((1, 12, 12, 8), (3, 3, 1, 8),
                        dict(padding="SAME", groups=8, h_tile=5, w_tile=4,
                             relu=True), "scalar"),
}


# tensor-core path edges: (x shape, w shape, conv2d kwargs, scale)
TC_CASES = {
    "c1_pool": ((2, 20, 20, 1), (3, 3, 1, 8),
                dict(padding="SAME", relu=True, pool=True, cin_banks=1),
                "scalar"),
    "c4_k32": ((2, 40, 36, 4), (3, 3, 4, 32),
               dict(padding="SAME", relu=True), "scalar"),
    "c8_kg8_int32": ((2, 18, 18, 8), (3, 3, 8, 8), dict(padding="SAME"),
                     None),
    "c6_bytes_1x1": ((2, 9, 11, 6), (1, 1, 6, 16), dict(cin_banks=1),
                     "scalar"),
    "groups2_kg8": ((2, 16, 16, 32), (3, 3, 16, 16),
                    dict(padding="SAME", groups=2, relu=True), "scalar"),
    "k40_stride2_57": ((2, 57, 57, 16), (3, 3, 16, 40),
                       dict(stride=2, padding="SAME", relu=True), "per_k"),
    "c96_chunks_pool": ((2, 20, 26, 96), (3, 3, 96, 64),
                        dict(padding="SAME", relu=True, pool=True), "per_k"),
    "c64_dilated_k72": ((1, 30, 30, 64), (3, 3, 64, 72),
                        dict(padding=((2, 1), (0, 3)), dilation=2), None),
    "c12_k10_pool": ((2, 15, 13, 12), (3, 3, 12, 10),
                     dict(padding="SAME", relu=True, pool=True,
                          kout_banks=2), "per_k"),
    "extreme_c256": ((1, 14, 14, 256), (3, 3, 256, 256),
                     dict(padding="SAME"), None),
    "c64_5x5_one_slot": ((2, 20, 20, 64), (5, 5, 64, 32),
                         dict(padding="SAME", relu=True), "scalar"),
}


def tc_case_inputs(name):
    """The inputs of ``TC_CASES[name]``, from a seed; the extreme case is
    all −128 (every product +16,384, 37.7M a full 3×3×256 window) with the
    largest positive bias."""
    xs, ws, kw, scale = TC_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("extreme"):
        x = np.full(xs, -128, np.int8)
        w = np.full(ws, -128, np.int8)
        b = np.full((ws[3],), 2 ** 31 - 1 - 9 * 256 * 16384, np.int32)
    else:
        x = rng.integers(-128, 128, size=xs).astype(np.int8)
        w = rng.integers(-128, 128, size=ws).astype(np.int8)
        b = rng.integers(-4000, 4000, size=(ws[3],)).astype(np.int32)
    s = None
    if scale == "scalar":
        s = np.float32(0.0031)
    elif scale == "per_k":
        s = (rng.random(ws[3]) * 0.006).astype(np.float32)
    return legal_banks(x, w, b, s, dict(kw))


def expected_path(x, w, s, kw):
    """What ``conv_path`` rules for these operands and kwargs."""
    geo = {k: v for k, v in kw.items() if k not in ("relu", "pool")}
    return conv_path(setup_conv(tuple(x.shape), tuple(w.shape),
                                pool=kw.get("pool", False),
                                requant=s is not None,
                                int_path=x.dtype == torch.int8, **geo))


def is_tiled(kw):
    return bool(kw.get("h_tile") or kw.get("w_tile"))


def case_inputs(name, *, f32=False):
    xs, ws, kw, scale = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.integers(-128, 128, size=xs).astype(np.int8)
    w = rng.integers(-128, 128, size=ws).astype(np.int8)
    b = rng.integers(-4000, 4000, size=(ws[3],)).astype(np.int32)
    s = None
    if scale == "scalar":
        s = np.float32(0.0031)
    elif scale == "per_k":
        s = (rng.random(ws[3]) * 0.006).astype(np.float32)
    if f32:
        x, w = x.astype(np.float32) / 64, w.astype(np.float32) / 64
        b, s = b.astype(np.float32) / 100, None
    return x, w, b, s, dict(kw)


def legal_banks(x, w, b, s, kw):
    """The bank counts ``ops.conv2d`` re-legalizes a grouped layer to,
    for calling the kernel wrappers directly."""
    if kw.get("groups", 1) > 1:
        kw["cin_banks"], kw["kout_banks"] = ref.grouped_banks(
            x.shape[3], w.shape[3], kw["groups"])
    return x, w, b, s, kw


def as_torch(*arrays, device="cpu"):
    return [None if a is None else torch.as_tensor(np.array(a),
                                                   device=device)
            for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc to build the "
                    "CUDA kernels")
    return torch.device("cuda")


def launch_both(args, kw, want, path):
    """Both conv kernels on ``args``: one launch each, on ``path``, and
    equal to ``want``."""
    for fn in (conv2d_ws, conv2d_ws_pipe):
        before = (fn.launches, fn.tc_launches)
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert (fn.launches, fn.tc_launches) == (
            before[0] + 1, before[1] + (path == "tc")), (fn.__name__, path)
        if want.is_floating_point():
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert torch.equal(got, want), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_conv_kernels_equal_plain(cuda, name):
    x, w, b, s, kw = legal_banks(*case_inputs(name))
    args = as_torch(x, w, b, s, device=cuda)
    path = expected_path(args[0], args[1], s, kw)
    assert path == ("tc" if w.shape[3] // kw.get("groups", 1) >= 8
                    else "scalar")
    launch_both(args, kw, conv2d_ws_plain(*args, **kw), path)
    fx, fw, fb, _, _ = case_inputs(name, f32=True)
    args = as_torch(fx, fw, fb, None, device=cuda)
    launch_both(args, kw, conv2d_ws_plain(*args, **kw), "scalar")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TC_CASES))
def test_cuda_conv_tensor_core_edges_equal_plain(cuda, name):
    x, w, b, s, kw = tc_case_inputs(name)
    args = as_torch(x, w, b, s, device=cuda)
    assert expected_path(args[0], args[1], s, kw) == "tc"
    launch_both(args, kw, conv2d_ws_plain(*args, **kw), "tc")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(3, 70, 33), (8, 256, 1000)])
def test_cuda_matmul_kernel_equals_plain(cuda, m, k, n):
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
    b = torch.randint(-1000, 1000, (n,), generator=g, dtype=torch.int32)
    x, w, b = x.to(cuda), w.to(cuda), b.to(cuda)
    got = matmul_ws(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(got, matmul_ws_plain(x, w, b))
    assert not torch.backends.cuda.matmul.allow_tf32
    # operands scaled so outputs are O(10): f32 sums in another order
    # than cuBLAS stay well inside 1e-4
    xf, wf, bf = x.float() / 64, w.float() / 64, b.float() / 100
    torch.testing.assert_close(matmul_ws(xf, wf, bf),
                               matmul_ws_plain(xf, wf, bf),
                               rtol=1e-4, atol=1e-4)
    # at larger operands each sum is held to the rounding-error bound of
    # a K-term f32 dot product in any order: K·eps·(Σ|x||w| + |b|)
    xf, wf, bf = x.float() / 9, w.float() / 7, b.float()
    bound = (k * torch.finfo(torch.float32).eps
             * (xf.double().abs() @ wf.double().abs() + bf.double().abs()))
    err = (matmul_ws(xf, wf, bf).double()
           - matmul_ws_plain(xf, wf, bf).double()).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def bf16_ulp(x):
    """One bf16 ulp at each |x|: 2^(floor(log2|x|) - 7), at most
    2^-7·|x| (0 where x is 0)."""
    x = x.float().abs()
    return torch.where(x > 0, torch.exp2(torch.floor(torch.log2(x)) - 7),
                       torch.zeros_like(x))


def bf16_gemm_bound(x, w, b, got, want):
    """Two bf16 GEMMs that take exact bf16 products, sum them in f32 in
    different orders (each within (K + 1)·2^-24·S of the exact sum,
    S = |x|·|w| + |b|) and round once to bf16 (half an ulp each) differ by
    at most one bf16 ulp of the larger magnitude plus (K + 1)·2^-23·S."""
    s = x.float().abs() @ w.float().abs()
    if b is not None:
        s = s + b.float().abs()
    mag = torch.maximum(got.float().abs(), want.float().abs())
    return bf16_ulp(mag) + (x.shape[1] + 1) * 2.0 ** -23 * s


# recurrentgemma-9b's gated-MLP GEMMs (d_model 4096, d_ff 12288) at a
# 4-slot decode step (the stream form, K = 12288 in 32 slices) and at a
# 4096-token prefill (the wgmma form): (m, k, n, dtype, bias)
RG_MLP_CASES = [(m, k, n, "bfloat16", False) for m in (4, 4096)
                for k, n in ((4096, 12288), (12288, 4096))]

# the MoE, VLM and encoder-decoder families' gated-MLP GEMMs under
# pallas_ws, (m, d_model, d_ff): deepseek-moe-16b's shared experts (2 ×
# 1408) and internvl2-26b's MLP at a 4-slot decode step (the stream form)
# and a 4096-position prefill (wgmma), seamless-m4t-medium's at a 1-row
# decode step and a 2048-position prefill; both directions of each
LM_MLP_SHAPES = ((4, 2048, 2816), (4096, 2048, 2816), (4, 6144, 16384),
                 (4096, 6144, 16384), (1, 1024, 4096), (2048, 1024, 4096))
LM_MLP_CASES = [(m, k, n, "bfloat16", False) for m, d, f in LM_MLP_SHAPES
                for k, n in ((d, f), (f, d))]

# matmul_ws edges and main-path shapes: (m, k, n, dtype, bias)
MM_CASES = ([(m, 200, 264, "bfloat16", m != 64)
             for m in (1, 4, 8, 16, 17, 63, 64, 65, 3000)]
            + [(m, 200, 264, "int8", m != 4) for m in (1, 4, 16, 17, 65)]
            + [(8, 256, 1000, "int8", True), (8, 256, 1000, "bfloat16", True),
               (3000, 256, 1000, "bfloat16", True),
               (4, 3072, 8192, "bfloat16", False),
               (4, 8192, 3072, "bfloat16", False),
               (3000, 3072, 8192, "bfloat16", False),
               # a 4096-token training microbatch's MLP, up and down
               (4096, 3072, 8192, "bfloat16", False),
               (4096, 8192, 3072, "bfloat16", False),
               (3, 70, 33, "bfloat16", True), (65, 70, 264, "bfloat16", True),
               (3, 70, 33, "float32", True), (8, 512, 64, "int8", True),
               (8, 64, 10, "int8", True)]
            + RG_MLP_CASES + LM_MLP_CASES)


def mm_case_inputs(m, k, n, dtype, bias):
    """Seeded CPU operands of one ``MM_CASES`` entry: x, w, bias or
    None."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(m + k + n)
    if dt == torch.int8:
        x = torch.randint(-128, 128, (m, k), generator=g, dtype=dt)
        w = torch.randint(-128, 128, (k, n), generator=g, dtype=dt)
        b = torch.randint(-4000, 4000, (n,), generator=g, dtype=torch.int32)
    else:
        x = torch.randn((m, k), generator=g).to(dt)
        w = (torch.randn((k, n), generator=g) / k ** 0.5).to(dt)
        b = torch.randn((n,), generator=g)
    return x, w, b if bias else None


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype,bias", MM_CASES)
def test_cuda_matmul_forms_equal_plain(cuda, m, k, n, dtype, bias):
    x, w, b = (None if t is None else t.to(cuda)
               for t in mm_case_inputs(m, k, n, dtype, bias))
    dt = x.dtype
    path = mm_path(m, k, n, dt)
    before = dict(matmul_ws.path_launches)
    got = matmul_ws(x, w, b)
    torch.cuda.synchronize()
    assert matmul_ws.path_launches == {**before, path: before[path] + 1}
    want = matmul_ws_plain(x, w, b)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dt == torch.int8:
        assert torch.equal(got, want)
    elif dt == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= bf16_gemm_bound(x, w, b, got, want)).all()), \
            float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal", [
    ((2, 300, 4, 64), torch.float32, True),
    ((2, 300, 4, 64), torch.float32, False),
    ((1, 777, 3, 16), torch.float32, True),
    ((2, 96, 2, 32), torch.float32, False),
    ((1, 777, 24, 128), torch.bfloat16, True),
    ((2, 130, 4, 128), torch.bfloat16, False),
    ((2, 300, 4, 16), torch.bfloat16, True),
    ((2, 300, 4, 32), torch.bfloat16, True),
    ((2, 300, 4, 64), torch.bfloat16, False),
    ((1, 3000, 24, 128), torch.bfloat16, True),
    # seamless-m4t-medium's encoder and cross attention (full) and its
    # decoder's self attention at 2048 positions, 16 heads of 64; full
    # attention at D = 128
    ((1, 2048, 16, 64), torch.bfloat16, False),
    ((1, 2048, 16, 64), torch.bfloat16, True),
    ((1, 2048, 16, 128), torch.bfloat16, False),
    # head dims run padded (8, 96, 6), at D = 256, wider than one scalar
    # block's 128 columns (160), on f32 copies (bf16 320), and B·H above
    # the 65,535 blocks a grid's y axis holds
    ((1, 300, 2, 8), torch.bfloat16, True),
    ((1, 300, 2, 96), torch.bfloat16, False),
    ((1, 300, 2, 256), torch.bfloat16, True),
    ((1, 130, 2, 320), torch.bfloat16, True),
    ((1, 300, 2, 6), torch.float32, True),
    ((1, 300, 2, 160), torch.float32, False),
    ((1, 16, 65600, 4), torch.float32, True),
])
def test_cuda_flash_attention_equals_plain(cuda, shape, dtype, causal):
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
               for _ in range(3))
    assert not torch.backends.cuda.matmul.allow_tf32
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= bf16_ulp(want) + 1e-6).all()), float(err.max())


@pytest.mark.cuda
def test_cuda_lm_engine_tokens_equal_the_cpu(cuda):
    """The reduced llama3.2-3b served on the card through the flash
    kernel gives the CPU run's greedy tokens."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.layers.common import materialize
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(reduce_config(get_config("llama3p2_3b")),
                              num_layers=2, attn_impl="flash")
    params = materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 70)]
    outs = []
    for dev in ("cpu", cuda):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        before = flash_attention.launches
        ServingEngine(cfg, params, slots=2, max_seq=96, device=dev).run(reqs)
        launched = flash_attention.launches - before
        assert launched == (0 if dev == "cpu" else 2 * len(prompts))
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# w8a8 serving: matmul_ws's int8 forms and the int8 KV cache
# ---------------------------------------------------------------------------

# the w8 GEMMs' (K, N) of llama3.2-3b, yi-34b and gemma-7b: wq / wo, wk /
# wv (gemma-7b's as wide as wq), the MLP's up and down projections
W8_SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
             (7168, 7168), (7168, 1024), (7168, 20480), (20480, 7168),
             (3072, 4096), (4096, 3072), (3072, 24576), (24576, 3072)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", W8_SHAPES)
def test_cuda_w8_gemm_shapes_equal_plain(cuda, k, n):
    """int8 ``matmul_ws`` at the w8 GEMM shapes: the stream form at a
    4-slot decode's M, the scalar form at a prefill's, each equal to the
    plain version."""
    for m, form in ((4, "stream"), (300, "scalar")):
        x, w, _ = (t.to(cuda) for t in mm_case_inputs(m, k, n, "int8", True))
        assert mm_path(m, k, n, torch.int8) == form
        before = dict(matmul_ws.path_launches)
        got = matmul_ws(x, w)
        torch.cuda.synchronize()
        assert matmul_ws.path_launches == {**before, form: before[form] + 1}
        assert torch.equal(got, matmul_ws_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("kv,g,d", [(8, 3, 128), (16, 1, 256)])
def test_cuda_int8_decode_contractions_exact(cuda, kv, g, d):
    """The int8 cache's decode contractions, f32 of the upcast operands on
    the card, equal the CPU's int64 sums at a 4-slot, 4096-position cache:
    random q and k, every entry −128, and pq from a softmax against v."""
    from repro_torch.layers.attention import _int8_contract

    gen = torch.Generator().manual_seed(kv * g * d)
    b, s = 4, 4096
    q = torch.randint(-128, 128, (b, kv, g, d), generator=gen,
                      dtype=torch.int8)
    k = torch.randint(-128, 128, (b, s, kv, d), generator=gen,
                      dtype=torch.int8)
    p = torch.softmax(3 * torch.randn((b, kv, g, s), generator=gen), -1)
    pq = torch.round(p * 127.0).clamp(0, 127).to(torch.int8)
    minus = torch.full_like(k, -128)
    for sub, a, c in (("bkgd,bskd->bkgs", q, k),
                      ("bkgd,bskd->bkgs", torch.full_like(q, -128), minus),
                      ("bkgs,bskd->bkgd", pq, k),
                      ("bkgs,bskd->bkgd", pq, minus)):
        got = _int8_contract(sub, a.to(cuda), c.to(cuda))
        assert got.dtype == torch.float32
        assert torch.equal(got.cpu().long(),
                           torch.einsum(sub, a.long(), c.long()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3p2_3b", "gemma_7b", "yi_34b"])
def test_cuda_w8_engine_tokens_equal_the_cpu(cuda, arch):
    """The reduced model in w8 with the int8 KV cache: the card (int8
    GEMMs on matmul_ws, 7 a layer a forward) gives the CPU run's greedy
    tokens."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.core.quantize import quantize_weights
    from repro_torch.layers.common import materialize
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(reduce_config(get_config(arch)), num_layers=2,
                              attn_impl="flash", kv_cache_dtype="int8",
                              kv_cache_scale=0.25)
    params = quantize_weights(materialize(
        lm.param_specs(cfg), torch.Generator().manual_seed(0),
        device="cpu"), lm.param_specs(cfg))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 70)]
    outs = []
    for dev in ("cpu", cuda):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        before = matmul_ws.launches
        ServingEngine(cfg, params, slots=2, max_seq=96, device=dev).run(reqs)
        assert (matmul_ws.launches > before) == (dev != "cpu")
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# training: the scalar path's own tiles and the backward on the kernels
# ---------------------------------------------------------------------------


def f32_sum_bound(terms, s):
    """Two sums of the same ``terms`` products, each taken in f32 in any
    order (each within terms·2^-24·S of the exact sum, S = Σ|products|,
    the rounding-error bound of a dot product), differ by at most
    (terms + 1)·2^-23·S.  The plain side is summed in float64, so this
    also bounds the kernel's error alone twice over."""
    return (terms + 1) * 2.0 ** -23 * s


# The norm-wise limit on an f32 gradient, ‖got − want‖₂ / ‖want‖₂ against
# the float64 oracle.  The elementwise ``f32_sum_bound`` is a worst case
# that grows with the contraction, so at 4·10⁵ terms it would pass a zero
# or wrong-tap gradient; a sum of random-signed products in f32 is off by
# about 2^-24·√terms of its size (about 1e-5 sequentially at 4·10⁵ terms),
# while TF32 operands (10 mantissa bits) are off by about 2e-4 at any
# length, and a zero gradient by 1.  Each check also computes that TF32
# control and asserts it fails this limit.
GRAD_REL_L2 = 5e-5


def tf32_round(t):
    """``t`` in f32 rounded to TF32 (10 mantissa bits, to nearest even), as
    a tensor-core GEMM with TF32 on rounds its operands."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0xFFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


def rel_l2(got, want):
    """‖got − want‖₂ / ‖want‖₂ in float64."""
    return float((got.double() - want).norm() / want.norm())


def check_grad(name, got, want, s, terms, control):
    """One f32 gradient against its float64 oracle ``want``: every element
    within ``f32_sum_bound(terms, s)``, the whole within ``GRAD_REL_L2``,
    and the ``control`` (the oracle of TF32-rounded operands) outside it →
    (max abs err, rel L2, control's rel L2)."""
    assert got.dtype == torch.float32 and got.shape == want.shape, name
    err = (got.double() - want).abs()
    bad = err > f32_sum_bound(terms, s)
    assert not bool(bad.any()), (name, float(err.max()),
                                 float(f32_sum_bound(terms, s)[bad][0]))
    rel, ctl = rel_l2(got, want), rel_l2(control, want)
    assert rel <= GRAD_REL_L2 < ctl, (name, rel, ctl)
    return float(err.max()), rel, ctl


def _windows2x2(t):
    return t.unfold(1, 2, 2).unfold(2, 2, 2).flatten(-2)


def check_masks(acc64, r, relu_mask, pool_idx, relu):
    """The Function's saved masks against masks of the float64 accumulator
    ``acc64``, whose f32 value lies within ``r`` of it: a ReLU mask may
    differ only where |acc| ≤ r, a pool index only where another position
    of its window could hold the maximum within ``r`` (a tie of values
    that are 0 for certain resolves by order on both sides) → the number
    of such positions by mask."""
    near = {}
    if relu_mask is not None:
        amb = acc64.abs() <= r
        assert not bool(((relu_mask != (acc64 > 0)) & ~amb).any()), "relu"
        near["relu"] = int(amb.sum())
    if pool_idx is not None:
        v, lo, hi = acc64, acc64 - r, acc64 + r
        if relu:
            v, lo, hi = (t.clamp(min=0) for t in (v, lo, hi))
        want = ref.maxpool2x2_argmax_ref(v)
        k = want.to(torch.int64)[..., None]
        lo_w, hi_w = _windows2x2(lo), _windows2x2(hi)
        lo_k, hi_k = lo_w.gather(-1, k), hi_w.gather(-1, k)
        other = torch.ones_like(hi_w, dtype=torch.bool).scatter_(-1, k, False)
        rival = other & (hi_w >= lo_k) & ~((hi_w == 0) & (hi_k == 0))
        amb = rival.any(-1)
        assert not bool(((pool_idx != want) & ~amb).any()), "pool"
        near["pool"] = int(amb.sum())
    return near


def check_conv_vjp(x, w, b, g, kw, transpose=False):
    """``ops.conv2d`` (or ``ops.conv2d_transpose``) differentiated by
    autograd on the card against the plain gradient oracles in float64.
    The forward runs the kernel ``pipelined=`` picks, within 1e-4 of the
    plain version; its saved ReLU mask and pool indices equal those of
    the float64 accumulator except within rounding of 0 or of a tie
    (``check_masks``).  The oracles take the accumulator's cotangent the
    Function routed through those masks (near a tie another subgradient
    is as right), and each gradient passes ``check_grad``.  Asserts the
    backward's launches: one ``conv2d_ws`` for dx where x needs a
    gradient, KH·KW·groups scalar ``matmul_ws`` GEMMs for dw → {"y", "dx",
    "dw", "db": max abs err, "rel": {name: (rel L2, TF32 control's)},
    "near": positions within rounding of a mask's decision}."""
    from repro_torch.kernels import ops
    groups = kw.get("groups", 1)
    f64 = torch.float64
    fwd = (conv2d_ws_pipe if kw.get("pipelined") else conv2d_ws)
    idle = conv2d_ws if kw.get("pipelined") else conv2d_ws_pipe
    before = fwd.launches, idle.launches
    y = (ops.conv2d_transpose if transpose else ops.conv2d)(x, w, b, **kw)
    if x.is_cuda:
        torch.cuda.synchronize()
        assert fwd.launches > before[0] and idle.launches == before[1]
    node = y.grad_fn
    cfg = node.cfg
    *_, relu_mask, pool_idx = node.saved_tensors
    dacc = ops.epilogue_backward(g, relu_mask, pool_idx, node.acc_shape)
    before = (conv2d_ws.launches, conv2d_ws.tc_launches,
              matmul_ws.launches, matmul_ws.path_launches["scalar"])
    wants = [t for t in (x, w, b) if t is not None and t.requires_grad]
    grads = dict(zip([id(t) for t in wants],
                     torch.autograd.grad(y, wants, g)))
    kh, kwd = w.shape[0], w.shape[1]
    taps = kh * kwd * groups
    if x.is_cuda:           # a CPU tensor runs the plain versions
        torch.cuda.synchronize()
        assert (conv2d_ws.launches, conv2d_ws.tc_launches,
                matmul_ws.launches, matmul_ws.path_launches["scalar"]) == (
            before[0] + x.requires_grad, before[1], before[2] + taps,
            before[3] + taps)
    geo = dict(stride=cfg.stride, padding=cfg.padding, groups=groups,
               dilation=cfg.dilation)
    errs = {"rel": {}}
    xd, wd = x.detach(), w.detach()
    bd = None if b is None else b.detach()
    if transpose:
        want_y = ref.conv2d_transpose_epilogue_ref(
            xd, wd, bd, relu=cfg.relu, pool=cfg.pool, stride=cfg.stride,
            padding=kw.get("padding", "VALID"), groups=groups,
            dilation=cfg.dilation)
        tgeo = dict(stride=cfg.stride, padding=kw.get("padding", "VALID"),
                    groups=groups, dilation=cfg.dilation,
                    out_spatial=kw.get("out_spatial"), dtype=f64)
        acc64 = ref.conv2d_transpose_ref(xd, wd, bd, **tgeo)
        acc_s = ref.conv2d_transpose_ref(
            xd.abs(), wd.abs(), None if bd is None else bd.abs(), **tgeo)
    else:
        want_y = conv2d_ws_plain(xd, wd, bd, relu=cfg.relu, pool=cfg.pool,
                                 cin_banks=cfg.cin_banks,
                                 kout_banks=cfg.kout_banks, **geo)
        acc64 = ref.conv2d_ref(xd, wd, bd, **geo, dtype=f64)
        acc_s = ref.conv2d_ref(xd.abs(), wd.abs(),
                               None if bd is None else bd.abs(), **geo,
                               dtype=f64)
    torch.testing.assert_close(y.detach(), want_y, rtol=1e-4, atol=1e-4)
    errs["y"] = float((y.detach() - want_y).abs().max())
    fwd_terms = kh * kwd * w.shape[2] + 1
    errs["near"] = check_masks(acc64, f32_sum_bound(fwd_terms, acc_s) / 2,
                               relu_mask, pool_idx, cfg.relu)
    del acc64, acc_s
    t32 = tf32_round
    if transpose:
        ws = ref.grouped_swap_weights(wd, groups)
        dual = dict(stride=cfg.stride, padding=cfg.padding, groups=groups,
                    dilation=cfg.dilation, dtype=f64)
        swapped_wgrad = lambda a, c: ref.grouped_swap_weights(  # noqa: E731
            ref.conv2d_weight_grad_ref(a, c, kh, kwd, **dual), groups)
        cases = {
            "dx": (x, lambda a, c: ref.conv2d_ref(a, c, **dual), dacc, ws,
                   kh * kwd * w.shape[3] // groups),
            "dw": (w, swapped_wgrad, dacc, xd,
                   x.shape[0] * x.shape[1] * x.shape[2])}
    else:
        cases = {
            "dx": (x, lambda a, c: ref.conv2d_input_grad_ref(
                       a, c, x.shape, **geo, dtype=f64), dacc, wd,
                   kh * kwd * w.shape[3] // groups),
            "dw": (w, lambda a, c: ref.conv2d_weight_grad_ref(
                       a, c, kh, kwd, **geo, dtype=f64), xd, dacc,
                   dacc.shape[0] * dacc.shape[1] * dacc.shape[2])}
    if b is not None:
        cases["db"] = (b, lambda a, _: ref.conv2d_bias_grad_ref(a, f64),
                       dacc, None, dacc.shape[0] * dacc.shape[1] *
                       dacc.shape[2])
    for name, (t, oracle, a, c, terms) in cases.items():
        if id(t) not in grads:
            continue
        err, rel, ctl = check_grad(
            name, grads[id(t)], oracle(a, c),
            oracle(a.abs(), None if c is None else c.abs()), terms,
            oracle(t32(a), None if c is None else t32(c)))
        errs[name], errs["rel"][name] = err, (rel, ctl)
    return errs


def check_matmul_vjp(x, w, b, g):
    """``ops.matmul_ws`` differentiated on the card: dx, dw and db against
    the float64 products, each through ``check_grad``, two scalar
    ``matmul_ws`` launches → {name: (max abs err, rel L2, TF32 control's
    rel L2)}."""
    from repro_torch.kernels import ops
    y = ops.matmul_ws(x, w, b)
    before = matmul_ws.path_launches["scalar"]
    dx, dw, db = torch.autograd.grad(y, (x, w, b), g)
    if x.is_cuda:
        torch.cuda.synchronize()
        assert matmul_ws.path_launches["scalar"] == before + 2
    gd, xd, wd = g.double(), x.detach().double(), w.detach().double()
    gt, xt, wt = (tf32_round(t.detach()).double() for t in (g, x, w))
    return {name: check_grad(name, got, want, s, terms, ctl)
            for name, got, want, s, terms, ctl in (
                ("dx", dx, gd @ wd.T, gd.abs() @ wd.abs().T, w.shape[1],
                 gt @ wt.T),
                ("dw", dw, xd.T @ gd, xd.abs().T @ gd.abs(), x.shape[0],
                 xt.T @ gt),
                ("db", db, gd.sum(0), gd.abs().sum(0), x.shape[0],
                 gt.sum(0)))}


def vgg_f32_layer(i, batch=8, device="cuda", seed=0):
    """x, He-initialized w, b and the conv kwargs (whole map, the
    trainer's banks) of ``vgg_imagenet``'s conv ``i`` in f32."""
    from repro_torch.core import network
    plan = network.vgg_imagenet()
    convs = [j for j, sp in enumerate(plan.layers) if sp.kind == "conv"]
    j = convs[i]
    sp = plan.layers[j]
    src = plan.input_shape if j == 0 else plan.activation_shapes()[j - 1]
    ws = plan.param_shapes()[j]["w"]
    g = torch.Generator(device=device).manual_seed(seed + i)
    x = torch.randn((batch, *src), generator=g, device=device)
    w = torch.randn(ws, generator=g, device=device) * (
        2.0 / (ws[0] * ws[1] * ws[2])) ** 0.5
    b = torch.randn((ws[3],), generator=g, device=device) * 0.05
    cb, kb = ref.grouped_banks(ws[2], ws[3])
    return x, w, b, dict(stride=sp.stride, padding=sp.padding,
                         cin_banks=cb, kout_banks=kb, relu=sp.relu,
                         pool=sp.pool)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [1, 5])
def test_cuda_whole_map_f32_conv_equals_tiled(cuda, layer):
    """A whole-map f32 conv overflows a block's shared memory; the scalar
    launch picks its own tiles and gives the value the same call with
    explicit tiles gives, bit for bit."""
    x, w, b, kw = vgg_f32_layer(layer)
    want = conv2d_ws_plain(x, w, b, **kw)
    for fn in (conv2d_ws, conv2d_ws_pipe):
        whole = fn(x, w, b, **kw)
        tiled = fn(x, w, b, h_tile=8, w_tile=16, **kw)
        torch.cuda.synchronize()
        assert torch.equal(whole, tiled), fn.__name__
        torch.testing.assert_close(whole, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_backward_pieces_within_the_bound(cuda):
    x, w, b, kw = vgg_f32_layer(2)
    x.requires_grad_(), w.requires_grad_(), b.requires_grad_()
    kw["pool"] = True
    g = torch.randn((8, 56, 56, 64), device=cuda)
    for pipelined in (False, True):
        errs = check_conv_vjp(x, w, b, g, dict(kw, pipelined=pipelined))
        assert set(errs["rel"]) == {"dx", "dw", "db"}
    # the head: [8, 256] @ [256, 1000]
    hx = torch.randn((8, 256), device=cuda).requires_grad_()
    hw = (torch.randn((256, 1000), device=cuda) / 16).requires_grad_()
    hb = torch.randn((1000,), device=cuda).requires_grad_()
    check_matmul_vjp(hx, hw, hb, torch.randn((8, 1000), device=cuda))
    # unet_small's first upsampling, at a 32×32 map
    ux = torch.randn((2, 16, 16, 32), device=cuda).requires_grad_()
    uw = (torch.randn((2, 2, 32, 16), device=cuda) / 8).requires_grad_()
    ub = torch.randn((16,), device=cuda).requires_grad_()
    check_conv_vjp(ux, uw, ub, torch.randn((2, 32, 32, 16), device=cuda),
                   dict(stride=2, relu=True), transpose=True)


@pytest.mark.cuda
def test_cuda_lenet_fit_step_launches(cuda):
    """One ``fit`` step of ``lenet`` on the card: 3 forward convs, 2 input
    gradients (none for the input layer), 27 weight-gradient taps and the
    two dense layers' 2 + 4 GEMMs, all on the scalar path and form."""
    from repro_torch.core import network, training
    plan = network.lenet(input_shape=(12, 12, 1))
    x, y = training.synthetic_digits(np.random.default_rng(0), 64,
                                     device=cuda)
    counts = (conv2d_ws.launches, conv2d_ws.tc_launches,
              conv2d_ws_pipe.launches, matmul_ws.launches,
              matmul_ws.path_launches["scalar"])
    state, hist = training.fit(plan, x, y, steps=1, batch=32,
                               cfg=training.TrainConfig(qat=True))
    assert state.step.device.type == "cuda" and np.isfinite(hist[0]["loss"])
    assert (conv2d_ws.launches - counts[0], conv2d_ws.tc_launches - counts[1],
            conv2d_ws_pipe.launches - counts[2],
            matmul_ws.launches - counts[3],
            matmul_ws.path_launches["scalar"] - counts[4]) == (5, 0, 0, 33, 33)


# ---------------------------------------------------------------------------
# The hybrid and attention-free LMs: the temporal conv's kernel route and
# the reduced engines
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,width,dtype", [(2, 37, 8, torch.float32),
                                             (1, 512, 4096, torch.float32),
                                             (1, 64, 4096, torch.bfloat16)])
def test_cuda_conv1d_depthwise_equals_plain(cuda, b, s, width, dtype):
    """``ops.conv1d_depthwise`` on the card: one ``conv2d_ws`` launch on
    the scalar path (one group a lane), within 1e-4 of the f32 oracle and
    of the recurrent block's shifted multiply-adds (bf16: the kernel's f32
    sum and the oracle's each rounded once, one bf16 ulp apart at most)."""
    from repro_torch.kernels import ops
    from repro_torch.layers.rglru import causal_conv1d

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, s, width, generator=gen, device=cuda).to(dtype)
    w = torch.randn(4, width, generator=gen, device=cuda) / 2
    bias = torch.randn(width, generator=gen, device=cuda)
    before = (conv2d_ws.launches, conv2d_ws.tc_launches)
    got = ops.conv1d_depthwise(x, w, bias)
    torch.cuda.synchronize()
    assert (conv2d_ws.launches, conv2d_ws.tc_launches) == (before[0] + 1,
                                                           before[1])
    want = ref.conv1d_depthwise_ref(x, w, bias)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got, causal_conv1d(x, w, bias),
                                   rtol=1e-4, atol=1e-4)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= bf16_ulp(want) + 1e-6).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,backend", [("recurrentgemma_9b", "pallas_ws"),
                                          ("rwkv6_1p6b", "xla")])
def test_cuda_hybrid_engine_tokens_equal_the_cpu(cuda, arch, backend):
    """The reduced recurrentgemma-9b (its MLPs on matmul_ws, no
    flash_attention launch: its attention is windowed) and rwkv6-1.6b at
    2 layers, served on the card, give the CPU run's greedy tokens."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.layers.common import materialize
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = reduce_config(get_config(arch))
    cfg = dataclasses.replace(cfg, num_layers=max(cfg.num_layers, 2),
                              attn_impl="flash", gemm_backend=backend)
    params = materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 70)]
    outs = []
    for dev in ("cpu", cuda):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        before = (flash_attention.launches, matmul_ws.launches)
        ServingEngine(cfg, params, slots=2, max_seq=96, device=dev).run(reqs)
        assert flash_attention.launches == before[0]
        assert (matmul_ws.launches > before[1]) == (
            dev != "cpu" and backend == "pallas_ws")
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_cuda_moe_engine_tokens_equal_the_cpu(cuda):
    """The reduced deepseek-moe-16b (2 layers, f32) with its shared
    experts on matmul_ws and its attention on the flash kernel, served on
    the card, gives the CPU run's greedy tokens; the routed experts are
    batched einsums on both."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.layers.common import materialize
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(reduce_config(get_config("deepseek_moe_16b")),
                              num_layers=2, attn_impl="flash",
                              gemm_backend="pallas_ws")
    params = materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 70)]
    outs = []
    for dev in ("cpu", cuda):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        before = (flash_attention.launches, matmul_ws.launches)
        ServingEngine(cfg, params, slots=2, max_seq=96, device=dev).run(reqs)
        on_card = dev != "cpu"
        assert flash_attention.launches - before[0] == (
            2 * len(prompts) if on_card else 0)
        assert (matmul_ws.launches > before[1]) == on_card
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_cuda_encdec_prefill_and_decode_equal_the_cpu(cuda):
    """The reduced seamless-m4t-medium (2 + 2 layers, f32) on the card:
    frames and tokens of one length, so the encoder's and the cross
    attention's full attention run the flash kernel, the MLPs matmul_ws;
    the prefill and 3 decode steps against the cross cache within 1e-4 of
    the CPU's."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.layers.common import materialize, tree_map
    from repro_torch.models import lm

    cfg = dataclasses.replace(
        reduce_config(get_config("seamless_m4t_medium")), attn_impl="flash",
        gemm_backend="pallas_ws")
    params = materialize(lm.param_specs(cfg), torch.Generator().manual_seed(1),
                         device="cpu")
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 48), generator=g),
             "frames": torch.randn((2, 48, cfg.frontend_dim), generator=g)}
    runs = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        before = (flash_attention.launches, matmul_ws.launches)
        with torch.no_grad():
            lg, cache = lm.prefill(p, {k: v.to(dev) for k, v in
                                       batch.items()}, cfg, cache_len=56)
            out = [lg]
            for j in range(3):
                lg, cache = lm.decode_step(
                    p, cfg, token=torch.tensor([3 + j, 7 + j], device=dev),
                    pos=torch.full((2,), 48 + j, device=dev), cache=cache)
                out.append(lg)
        if dev != "cpu":
            # the prefill: every layer's MLP, a flash launch a layer of
            # the encoder and two a decoder layer; a decode step: the
            # decoder's MLPs
            layers = cfg.encoder_layers + cfg.num_layers
            assert flash_attention.launches - before[0] == \
                cfg.encoder_layers + 2 * cfg.num_layers
            assert matmul_ws.launches - before[1] == 3 * (
                layers + 3 * cfg.num_layers)
        runs.append([t.cpu() for t in out])
    for a, b in zip(*runs):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# LM training: matmul_ws's f32 backward at the LM's shapes, the flash
# kernel's refusal, one train step card == CPU
# ---------------------------------------------------------------------------

# llama3.2-3b's MLP GEMMs at a 4096-token microbatch, (M, K, N): the up
# and gate projections and the down projection; their VJPs run dx as
# [4096, 8192] @ [8192, 3072] and [4096, 3072] @ [3072, 8192], and dw as
# [3072, 4096] @ [4096, 8192] and [8192, 4096] @ [4096, 3072]
LM_BWD_SHAPES = ((4096, 3072, 8192), (4096, 8192, 3072))


def lm_bwd_inputs(m, k, n, device, seed=0):
    """f32 x [m, k], w [k, n] at the fan-in scale, a zero bias and a
    cotangent g [m, n], the operands requiring grad."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device)
    w = torch.randn((k, n), generator=gen, device=device) * k ** -0.5
    g = torch.randn((m, n), generator=gen, device=device)
    b = torch.zeros(n, device=device)
    return (*(t.requires_grad_() for t in (x, w, b)), g)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", LM_BWD_SHAPES)
def test_cuda_matmul_vjp_at_the_lm_backward_shapes(cuda, m, k, n):
    errs = check_matmul_vjp(*lm_bwd_inputs(m, k, n, cuda))
    assert set(errs) == {"dx", "dw", "db"}


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_autograd(cuda):
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, 64, 2, 16), generator=gen, device=cuda)
               for _ in range(3))
    for fn in (flash_attention, ops.flash_attention):
        before = flash_attention.launches
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q.clone().requires_grad_(), k, v)
        assert flash_attention.launches == before
        with torch.no_grad():
            got = fn(q.clone().requires_grad_(), k, v)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        torch.testing.assert_close(got, flash_attention_plain(q, k, v),
                                   rtol=1e-4, atol=1e-4)


# the CPU tests' AdamW hyperparameters: step 0 runs at lr = 5e-4, so a
# skipped or wrong update moves a param past the 1e-4 tolerance
LM_STEP_HP = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)

# how far the two gradients of a param may move its step-0 update before
# the param is held to 2·lr (see ``lm_train_step_card_vs_cpu``): a tenth
# of the tolerance
NEAR_ZERO_MOVE = 1e-5


def lm_train_step_card_vs_cpu(arch, card, backend="xla", seed=0,
                              seq=32, batch=2):
    """One f32 train step of the reduced ``arch`` (``gemm_backend=
    backend``, TF32 off, ``LM_STEP_HP``) from one state drawn on the CPU,
    on the CPU and on ``card``: the loss, every gradient and every updated
    param, m and v within rtol = atol = 1e-4 → {"loss", "grads", "state":
    max abs err (outside the near-zero elements), "near_zero": the param
    elements held to 2·lr, "matmul_ws": the card step's launches}.

    The first AdamW step moves a param by lr·ĝ/(|ĝ| + eps) plus the
    weight decay (ĝ the clipped gradient: m̂ = ĝ, v̂ = ĝ²), so by ±lr
    wherever |ĝ| ≫ eps.  Two gradients ĝ₁, ĝ₂ of one sign move it by
    amounts lr·eps·|ĝ₁ − ĝ₂| / ((|ĝ₁| + eps)(|ĝ₂| + eps)) apart, of
    opposite signs by up to 2·lr.  A param whose two gradients may move
    its update by more than ``NEAR_ZERO_MOVE`` (one gradient near zero)
    is held to 2·lr plus the tolerance; every other to the tolerance."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.layers.common import materialize, tree_map
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(reduce_config(get_config(arch)),
                              compute_dtype="float32", gemm_backend=backend)
    hp = AdamWConfig(**LM_STEP_HP)
    specs = ts.init_state_specs(cfg)
    gen = torch.Generator().manual_seed(seed)
    state = {"params": materialize(specs["params"], gen, device="cpu"),
             "opt": materialize(specs["opt"], gen, device="cpu"),
             "step": torch.zeros((), dtype=torch.int32)}
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed)).batch_at(0)
    step = ts.make_train_step(cfg, hp)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    try:
        for dev in ("cpu", card):
            st = tree_map(lambda t: t.to(dev, copy=True), state)
            b = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
            before = matmul_ws.launches
            grads = ts._grads(st["params"], b, cfg)[3]
            new, m = step(st, b)
            if dev != "cpu":
                torch.cuda.synchronize()
            runs.append(({k: float(v) for k, v in m.items()},
                         [t.cpu() for t in grads],
                         {k: [t.cpu() for t in tree_leaves(v)] for k, v in (
                             ("params", new["params"]),
                             ("m", new["opt"]["m"]),
                             ("v", new["opt"]["v"]))},
                         int(new["step"]), matmul_ws.launches - before))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cm, cg, cs, cstep, _), (m, g, s, gstep, launches) = runs
    assert cstep == gstep == 1
    assert abs(m["loss"] - cm["loss"]) <= 1e-4 + 1e-4 * abs(cm["loss"])
    for a, w in zip(g, cg):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)
    lr = cm["lr"]
    assert lr == m["lr"] > 1e-4
    clip = min(1.0, hp.grad_clip_norm / cm["grad_norm"])
    near, errs = 0, []
    for name in ("params", "m", "v"):
        for i, (a, w) in enumerate(zip(s[name], cs[name])):
            tol = 1e-4 + 1e-4 * w.abs()
            if name == "params":
                ga, gw = g[i] * clip, cg[i] * clip
                eps = hp.eps
                move = lr * eps * (ga - gw).abs() / (
                    (ga.abs() + eps) * (gw.abs() + eps))
                loose = (torch.sign(ga) != torch.sign(gw)) | (
                    move > NEAR_ZERO_MOVE)
                near += int(loose.sum())
                tol = torch.where(loose, tol + 2 * lr, tol)
            err = (a - w).abs()
            assert bool((err <= tol).all()), (name, i, float(err.max()))
            if name == "params":
                err = torch.where(loose, 0.0, err)
            errs.append(float(err.max()))
    return {"loss": abs(m["loss"] - cm["loss"]),
            "grads": max(float((a - w).abs().max()) for a, w in zip(g, cg)),
            "state": max(errs), "near_zero": near, "matmul_ws": launches}


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["xla", "pallas_ws"])
def test_cuda_lm_train_step_equals_the_cpu(cuda, backend):
    """One train step of the reduced llama3.2-3b: the card equals the CPU
    within 1e-4; under ``pallas_ws`` each MLP GEMM launches ``matmul_ws``
    once forward and twice backward (the reduced config's remat policy is
    ``"none"``: nothing is recomputed)."""
    from repro_torch.configs.base import get_config, reduce_config
    out = lm_train_step_card_vs_cpu("llama3p2_3b", cuda, backend)
    cfg = reduce_config(get_config("llama3p2_3b"))
    assert cfg.remat_policy == "none"
    # the helper runs the gradients once, then the step
    assert out["matmul_ws"] == (0 if backend == "xla" else
                                2 * 3 * cfg.num_layers * (1 + 2))


# ---------------------------------------------------------------------------
# distribution: matmul_ws on DTensor shards; a one-rank sharded step
# ---------------------------------------------------------------------------

# llama3.2-3b's MLP GEMMs split over 2 ranks on N (up / gate) and on K
# (down): at a 4-slot decode step (stream), a 512-token prefill (wgmma)
# and in f32 (scalar): (split, m, k, n, dtype)
DT_MM_CASES = [(split, m, k, n, dname)
               for split, k, n in (("N", 3072, 8192), ("K", 8192, 3072))
               for m, dname in ((4, "bfloat16"), (512, "bfloat16"),
                                (512, "float32"))]


@pytest.mark.cuda
def test_cuda_matmul_ws_dtensor_local_shards(cuda):
    """``ops.matmul_ws`` on DTensors runs the kernel on each rank's local
    shard (N/2 and K/2 of the MLP's GEMMs, every form), 2 ranks sharing
    the card (gloo; no collective runs)."""
    import torch_dist_checks as dc
    out, backend = dc.spawn_ranks(dc.card_matmul_local, 2, DT_MM_CASES,
                                  device="cuda", timeout_s=300)
    assert backend == ("nccl" if torch.cuda.device_count() >= 2
                       else "gloo")
    forms = {case: path for case, path, _ in out}
    assert len(forms) == len(DT_MM_CASES)
    assert set(forms.values()) == {"stream", "wgmma", "scalar"}


@pytest.mark.cuda
def test_cuda_one_rank_sharded_step_is_bit_equal(cuda):
    """Phase 11(a) at one full-width layer: llama3.2-3b (bf16 compute,
    remat ``"minimal"``, ``pallas_ws``) on a one-rank NCCL mesh, one step
    of 2 × 512 tokens in two microbatches, bit-equal to the unsharded
    step (deterministic algorithms), ``matmul_ws`` calls by form equal."""
    import collections
    import dataclasses

    import torch.distributed as dist

    import torch_dist_checks as dc
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import (ShardingPlan, device_put,
                                                  use_mesh)
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    from repro_torch.layers.common import tree_map
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import train_step as ts
    cfg = dataclasses.replace(get_config("llama3p2_3b"), num_layers=1,
                              remat_policy="minimal", attn_impl="chunked",
                              gemm_backend="pallas_ws")
    assert init_world(0, 1, f"tcp://localhost:{dc.free_port()}",
                      device=cuda) == "nccl"
    try:
        mesh = make_debug_mesh(1, 1, device=cuda)
        plan = ShardingPlan(mesh=mesh, fsdp=True, mode="train")
        hp = AdamWConfig(**dc.STEP_HP)
        state, specs = dc.draw_state(cfg, 3, cuda)
        sharded = device_put(tree_map(torch.clone, state),
                             dc.full_shardings(plan, specs))
        batch = dc.draw_batch(cfg.vocab_size, 2, 512, 4, cuda)
        kernel = kops._matmul_kernel
        outs, forms = [], []
        torch.use_deterministic_algorithms(True)
        try:
            for st, rules, scope in ((state, None, None),
                                     (sharded, plan.acts, mesh)):
                seen = collections.Counter()

                def counted(x, w, b=None, _seen=seen):
                    _seen[mm_path(x.shape[0], x.shape[1], w.shape[1],
                                  x.dtype)] += 1
                    return kernel(x, w, b)
                kops._matmul_kernel = counted
                fn = ts.make_train_step(cfg, hp, act_rules=rules,
                                        accum_steps=2)
                if scope is None:
                    outs.append(dc.captured_step(fn, st, batch)[0])
                else:
                    with use_mesh(scope):
                        outs.append(dc.captured_step(fn, st, batch)[0])
                forms.append(dict(seen))
        finally:
            kops._matmul_kernel = kernel
            torch.use_deterministic_algorithms(False)
        assert dc.outputs_equal(outs[1], outs[0]) == []
        assert forms[0] == forms[1] == {"wgmma": 12, "scalar": 12}
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_one_rank_sharded_decode_is_bit_equal(cuda):
    """Phase 11(a)'s decode at one full-width layer: a ``mode="decode"``
    step (cache_seq over model) of 4 slots × 1024 positions after a
    600-token prefill, two steps, logits and cache bit-equal to the
    unsharded decode; ``matmul_ws`` on the stream form."""
    import dataclasses

    import torch.distributed as dist

    import torch_dist_checks as dc
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import ShardingPlan
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    from repro_torch.layers.common import materialize, tree_map
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves
    cfg = dataclasses.replace(get_config("llama3p2_3b"), num_layers=1,
                              gemm_backend="pallas_ws")
    assert init_world(0, 1, f"tcp://localhost:{dc.free_port()}",
                      device=cuda) == "nccl"
    try:
        plan = ShardingPlan(mesh=make_debug_mesh(1, 1, device=cuda),
                            fsdp=False, mode="decode")
        gen = torch.Generator(device=cuda).manual_seed(5)
        params = lm.compute_params(materialize(lm.param_specs(cfg), gen,
                                               device=cuda), cfg)
        cache, tok, pos = dc.prefilled_cache(
            params, dataclasses.replace(cfg, attn_impl="dense"), 4, 1024,
            600)
        before = matmul_ws.path_launches["stream"]
        got = dc.sharded_decode(params, tree_map(torch.clone, cache), cfg,
                                plan, lm.param_specs(cfg),
                                lm.cache_specs(cfg, 4, 1024), tok, pos, 2)
        assert matmul_ws.path_launches["stream"] == before + 2 * 3
        want = dc.plain_decode(params, cache, cfg, tok, pos, 2)
        for a, b in zip(got[0] + tree_leaves(got[1]),
                        want[0] + tree_leaves(want[1])):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_four_rank_checks_on_nccl(cuda):
    """Phase 11(b) with a card per rank: every check of
    ``torch_dist_checks.card_scenarios`` at 4 ranks over NCCL, 2
    full-width llama3.2-3b layers: ``compressed_psum`` bit-equal,
    ``pipeline_apply`` against the sequential stack, the sharded f32
    train step within its derived gradient bound (``card_train``) and the
    sharded decode within phase 6's bf16 bound (``card_decode``)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards, one a rank: NCCL refuses two ranks on "
                    "one card and gloo cannot all-gather DTensors there")
    import torch_dist_checks as dc
    out, backend = dc.spawn_ranks(dc.card_scenarios, 4,
                                  tuple(dc.CARD_CHECKS), "llama3p2_3b", 8,
                                  device="cuda", timeout_s=900)
    print(out)
    assert backend == "nccl"
    assert set(out) == set(dc.CARD_CHECKS)
    assert out["compressed_psum"]["equal"]
    pp = out["pipeline_apply"]
    assert pp["forward_equal"] and pp["grad_rel"] <= 1e-5
    st = out["sharded_train_step"]
    assert st["grad_rel"] <= st["bound"] < st["ctl"]
    assert out["sharded_decode_step"]["rel"] <= \
        out["sharded_decode_step"]["bound"]
