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
tiles, the head's N = 1000, and rows that are not 16-byte multiples."""

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


# matmul_ws edges: (m, k, n, dtype, bias)
MM_CASES = ([(m, 200, 264, "bfloat16", m != 64)
             for m in (1, 4, 8, 16, 17, 63, 64, 65, 3000)]
            + [(m, 200, 264, "int8", m != 4) for m in (1, 4, 16, 17, 65)]
            + [(8, 256, 1000, "int8", True), (8, 256, 1000, "bfloat16", True),
               (3000, 256, 1000, "bfloat16", True),
               (4, 3072, 8192, "bfloat16", False),
               (4, 8192, 3072, "bfloat16", False),
               (3000, 3072, 8192, "bfloat16", False),
               (3, 70, 33, "bfloat16", True), (65, 70, 264, "bfloat16", True),
               (3, 70, 33, "float32", True), (8, 512, 64, "int8", True),
               (8, 64, 10, "int8", True)])


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
