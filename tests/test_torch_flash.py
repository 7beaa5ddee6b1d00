"""The port's ``flash_attention`` (on CPU tensors: its plain version)
against the JAX Pallas kernel in interpret mode, on the same numpy inputs.

The sweep is ``tests/test_flash_kernel.py``'s (shapes, blocks, causal and
full) plus S = 777, which no power-of-two block divides: there the JAX
kernel runs blocks that divide 777, and the port takes it whole.  f32
agrees within rtol = atol = 1e-4; bf16 outputs are each rounded once from
f32 sums taken in another order, so they agree within one bf16 ulp,
2^(floor(log2|x|) - 7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

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


def test_bf16_within_one_ulp_of_the_pallas_kernel():
    q, k, v = _qkv(1, 96, 2, 32, seed=5)
    want = _jax(q, k, v, True, (32, 32), jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    ulp = np.exp2(np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
    assert (err <= ulp + 1e-6).all(), err.max()


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
