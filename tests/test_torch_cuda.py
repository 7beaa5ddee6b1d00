"""The CUDA kernels against their plain versions, on the card, and the LM
serving path on the card against the same path on the CPU.

Every test here launches a kernel of ``repro_torch`` and skips where no
NVIDIA GPU is present.  The file imports no JAX, so it also runs on a
machine without it::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The case table is shared with ``test_torch_kernels.py``, which holds the
plain versions against the JAX reference on the CPU.  Int paths are
``torch.equal``; f32 agrees within rtol = atol = 1e-4 (the kernels sum in
another order than cuDNN); bf16 attention outputs, each rounded once from
f32 sums taken in another order, agree within one bf16 ulp."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_ws import conv2d_ws, conv2d_ws_plain
from repro_torch.kernels.conv2d_ws_pipe import conv2d_ws_pipe
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.matmul_ws import matmul_ws, matmul_ws_plain

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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_conv_kernels_equal_plain(cuda, name):
    x, w, b, s, kw = legal_banks(*case_inputs(name))
    args = as_torch(x, w, b, s, device=cuda)
    want = conv2d_ws_plain(*args, **kw)
    for fn in (conv2d_ws, conv2d_ws_pipe):
        before = fn.launches
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(got, want), (fn.__name__, name)
    fx, fw, fb, _, _ = case_inputs(name, f32=True)
    args = as_torch(fx, fw, fb, None, device=cuda)
    want = conv2d_ws_plain(*args, **kw)
    for fn in (conv2d_ws, conv2d_ws_pipe):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal", [
    ((2, 300, 4, 64), torch.float32, True),
    ((2, 300, 4, 64), torch.float32, False),
    ((1, 777, 3, 16), torch.float32, True),
    ((2, 96, 2, 32), torch.float32, False),
    ((1, 777, 24, 128), torch.bfloat16, True),
    ((2, 130, 4, 128), torch.bfloat16, False),
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
