"""The port's ``flash_attention`` (on CPU tensors: its plain version)
against the JAX Pallas kernel in interpret mode, on the same numpy inputs.

The sweep is ``tests/test_flash_kernel.py``'s (shapes, blocks, causal and
full) plus S = 777, which no power-of-two block divides: there the JAX
kernel runs blocks that divide 777, and the port takes it whole.  f32
agrees within rtol = atol = 1e-4; bf16 outputs are each rounded once from
f32 sums taken in another order, so they agree within one bf16 ulp,
2^(floor(log2|x|) - 7).

The bf16 card kernel cannot run here, so its arithmetic is emulated in
plain torch (``_emulate_bf16_kernel``) and held to the same Pallas kernel
under the same rule.  Head dims the kernels do not take as they are run
zero-padded (``kernel_head_dim``, ``pad_head_dim``) with the scale of the
true D; the emulation runs them padded in the same way."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_plain,
                                                 kernel_head_dim,
                                                 kernel_variant, pad_head_dim)

SWEEP = [(64, (16, 16)), (128, (32, 64)), (128, (128, 128)), (96, (32, 32)),
         (777, (111, 111)), (777, (259, 37))]


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax(q, k, v, causal, blocks, dtype=jnp.float32):
    bq, bk = blocks
    out = jax_flash(*(jnp.asarray(t, dtype) for t in (q, k, v)),
                    causal=causal, block_q=bq, block_k=bk, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("s,blocks", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_and_wrapper_match_the_pallas_kernel(s, blocks, causal):
    q, k, v = _qkv(2 if s < 512 else 1, s, 2, 32, seed=s)
    want = _jax(q, k, v, causal, blocks)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = flash_attention.launches
    for fn in (flash_attention_plain, flash_attention, ops.flash_attention):
        got = fn(tq, tk, tv, causal=causal)
        assert got.dtype == torch.float32 and got.shape == tq.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert flash_attention.launches == before


def _within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of want + 1e-6, elementwise."""
    err = np.abs(got - want)
    ulp = np.exp2(np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
    return err <= ulp + 1e-6, err


def test_bf16_within_one_ulp_of_the_pallas_kernel():
    q, k, v = _qkv(1, 96, 2, 32, seed=5)
    want = _jax(q, k, v, True, (32, 32), jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    ok, err = _within_one_bf16_ulp(got.float().numpy(), want)
    assert ok.all(), err.max()


def _emulate_bf16_kernel(q, k, v, causal, terms=3, scale=None):
    """The bf16 card kernel's arithmetic in plain torch: bf16 q, k, v; f32
    scores scaled after the product (by ``scale``, 1/sqrt(D) unless the
    caller passes the true D's of padded inputs); online softmax over
    64-column tiles against the running max; l summed from the f32 p; p
    enters p·v as ``terms`` bf16 terms (p1 = bf16(p), p2 = bf16(p - p1),
    ...) with f32 accumulation; acc / max(l, 1e-30) rounded once to
    bf16."""
    b, s, h, d = q.shape
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B,H,S,D]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, s, 1), NEG_INF)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, 64):
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        sc = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])
            sc = sc.masked_fill(kpos > qpos, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc
        rest = p
        for _ in range(terms):
            term = rest.to(torch.bfloat16).float()
            acc = acc + term @ vt
            rest = rest - term
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("s,d", [(300, 128), (130, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_emulation_within_one_ulp_of_the_pallas_kernel(s, d,
                                                                  causal):
    q, k, v = _qkv(1, s, 2, d, seed=s + d)
    want = _jax(q, k, v, causal, (512, 512), jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = _emulate_bf16_kernel(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    ok, err = _within_one_bf16_ulp(got.float().numpy(), want)
    assert ok.all(), err.max()


def test_one_bf16_term_of_p_would_miss_the_rule():
    """Why the kernel carries p in three terms: with p rounded once to
    bf16 before p·v, outputs leave one bf16 ulp of the reference."""
    q, k, v = _qkv(1, 300, 2, 128, seed=428)
    want = _jax(q, k, v, True, (512, 512), jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = _emulate_bf16_kernel(tq, tk, tv, True, terms=1)
    ok, _ = _within_one_bf16_ulp(got.float().numpy(), want)
    assert not ok.all()


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_bf16_head_dims_run_on_the_tensor_core_kernel(d):
    assert kernel_variant(torch.bfloat16, d) == "wgmma"
    assert kernel_head_dim(torch.bfloat16, d) == d


@pytest.mark.parametrize("d", [8, 96, 256])
def test_other_bf16_head_dims_raise(d):
    """No bf16 head dim is refused: D = 8, 96 and 256 compute.
    The wrapper on the CPU (the plain version) and the card kernel's
    arithmetic on q, k, v padded as ``_launch`` pads them (to
    ``kernel_head_dim``, with the true D's scale, the output sliced back)
    are each within one bf16 ulp of the Pallas kernel in interpret mode."""
    dp = kernel_head_dim(torch.bfloat16, d)
    assert kernel_variant(torch.bfloat16, d) == (
        "wgmma" if d == 256 else "wgmma_padded")
    assert dp == {8: 16, 96: 128, 256: 256}[d]
    q, k, v = _qkv(1, 130, 2, d, seed=d)
    want = _jax(q, k, v, True, (512, 512), jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    emulated = _emulate_bf16_kernel(
        *(pad_head_dim(t, dp) for t in (tq, tk, tv)), True,
        scale=1.0 / math.sqrt(d))[..., :d]
    for out in (got, emulated):
        assert out.dtype == torch.bfloat16 and out.shape == tq.shape
        ok, err = _within_one_bf16_ulp(out.float().numpy(), want)
        assert ok.all(), err.max()


def test_bf16_head_dims_above_256_run_on_f32_copies():
    assert kernel_variant(torch.bfloat16, 320) == "scalar_f32_copies"
    assert kernel_head_dim(torch.bfloat16, 322) == 324
    with pytest.raises(ValueError, match="head dim >= 1"):
        kernel_variant(torch.bfloat16, 0)


def test_f32_head_dims_stay_on_the_scalar_kernel():
    """Every f32 head dim runs the scalar kernel: a multiple of 4 as it is
    (wider than 128 in 128-column slices), any other D zero-padded up to
    one.  The padded computation with the true D's scale, sliced back,
    agrees with the Pallas kernel within 1e-4, as the wrapper does."""
    assert kernel_variant(torch.float32, 96) == "scalar"
    assert kernel_variant(torch.float32, 16) == "scalar"
    assert kernel_variant(torch.float32, 160) == "scalar"
    assert kernel_variant(torch.float32, 130) == "scalar_padded"
    assert kernel_variant(torch.float32, 6) == "scalar_padded"
    assert kernel_head_dim(torch.float32, 6) == 8
    assert kernel_head_dim(torch.float32, 160) == 160
    for d in (6, 160):
        q, k, v = _qkv(2, 96, 2, d, seed=d)
        want = _jax(q, k, v, True, (32, 32))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        np.testing.assert_allclose(
            flash_attention(tq, tk, tv, causal=True).numpy(), want,
            rtol=1e-4, atol=1e-4)
        dp = kernel_head_dim(torch.float32, d)
        qp, kp, vp = (pad_head_dim(t, dp) for t in (tq, tk, tv))
        scores = torch.einsum("bqhd,bkhd->bhqk", qp / math.sqrt(d), kp)
        mask = torch.ones(96, 96, dtype=torch.bool).tril()
        p = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
        padded = torch.einsum("bhqk,bkhd->bqhd", p, vp)
        assert torch.equal(padded[..., d:], torch.zeros_like(padded[..., d:]))
        np.testing.assert_allclose(padded[..., :d].numpy(), want,
                                   rtol=1e-4, atol=1e-4)


def test_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="of one type"):
        flash_attention(x, x, x.bfloat16())
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(x, x[:, :4], x)
    m = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU tensor"):
        flash_attention(m, m, m)
