"""The port's LM data pipeline against the JAX package's, and the
refusal of ``flash_attention`` under autograd, on the CPU.

``SyntheticLM`` and ``TextFile`` batches are array-equal to the
reference's at steps 0-4, for one process and for each of two; the
``fingerprint`` digests are equal.

The flash kernel has no backward in either package: the reference's
``jax.grad`` through its Pallas kernel (interpret mode) fails inside
JAX's Pallas AD, and the port raises ``RuntimeError`` on the same call
(on CUDA tensors too: ``tests/test_torch_cuda.py``) instead of returning
a result no gradient flows through.  Without autograd it is unchanged."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.layers import common
from repro_torch.train import train_step as ts

STEPS = range(5)


def _cfg(mod, **kw):
    base_kw = dict(vocab_size=300, seq_len=24, global_batch=6, seed=7)
    base_kw.update(kw)
    return mod.DataConfig(**base_kw)


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(range(256)) * 3 + b"a tiny corpus " * 50)
    return str(path)


@pytest.mark.parametrize("count", [1, 2])
@pytest.mark.parametrize("kind", ["synthetic", "textfile"])
def test_batches_equal_the_reference(kind, count, corpus):
    kw = dict(kind=kind, path=corpus if kind == "textfile" else None)
    for index in range(count):
        got = pipeline.make_pipeline(_cfg(pipeline, **kw), index, count)
        want = jpipe.make_pipeline(_cfg(jpipe, **kw), index, count)
        assert type(got).__name__ == type(want).__name__
        assert got.local_batch == want.local_batch == 6 // count
        for step in STEPS:
            a, b = got.batch_at(step), want.batch_at(step)
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            assert pipeline.fingerprint(a) == jpipe.fingerprint(b)


def test_short_textfile_is_tiled_as_the_reference(tmp_path):
    path = tmp_path / "short.txt"
    path.write_bytes(b"abc")
    cfg = dict(kind="textfile", path=str(path), seq_len=10)
    got = pipeline.make_pipeline(_cfg(pipeline, **cfg)).batch_at(3)
    want = jpipe.make_pipeline(_cfg(jpipe, **cfg)).batch_at(3)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_fingerprint_equals_the_reference_and_sees_each_key():
    b = pipeline.SyntheticLM(_cfg(pipeline)).batch_at(0)
    assert pipeline.fingerprint(b) == jpipe.fingerprint(b)
    other = dict(b, labels=b["labels"] + 1)
    assert pipeline.fingerprint(other) != pipeline.fingerprint(b)
    with pytest.raises(ValueError):
        pipeline.make_pipeline(_cfg(pipeline, kind="parquet"))


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
            for _ in range(3)]


def test_flash_attention_has_no_gradient_in_either_package():
    q, k, v = _qkv()

    def loss(tq):
        return jnp.sum(jops.flash_attention(tq, jnp.asarray(k),
                                            jnp.asarray(v), block_q=32,
                                            block_k=32))
    with pytest.raises(AssertionError):
        jax.grad(loss)(jnp.asarray(q))

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for fn in (flash_attention, ops.flash_attention):
        for grads in ((True, False, False), (False, False, True)):
            args = [t.clone().requires_grad_(g)
                    for t, g in zip((tq, tk, tv), grads)]
            with pytest.raises(RuntimeError, match="no backward"):
                fn(*args, block_q=32, block_k=32)


def test_training_through_flash_attention_raises():
    """A train step of the reduced llama3.2-3b under ``attn_impl="flash"``
    raises naming the attention to train with; ``"chunked"`` trains."""
    cfg = dataclasses.replace(base.reduce_config(
        base.get_config("llama3p2_3b")), attn_impl="flash")
    params = common.materialize(ts.init_state_specs(cfg)["params"],
                                torch.Generator().manual_seed(0),
                                device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    with pytest.raises(RuntimeError, match="chunked"):
        ts._grads(params, batch, cfg)
    ok = dataclasses.replace(cfg, attn_impl="chunked")
    assert all(bool(torch.isfinite(g).all())
               for g in ts._grads(params, batch, ok)[3])
    # evaluation records nothing, so the kernel's path runs
    assert torch.isfinite(ts.make_eval_step(cfg)(params, batch)["loss"])


def test_flash_attention_unchanged_without_autograd():
    """Under ``torch.no_grad()``, and on operands that do not require
    grad, both entries equal the plain version and count no launch."""
    tq, tk, tv = map(torch.from_numpy, _qkv(1))
    want = flash_attention_plain(tq, tk, tv, causal=True)
    before = flash_attention.launches
    needs = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    with torch.no_grad():
        for fn in (flash_attention, ops.flash_attention):
            assert torch.equal(fn(*needs), want)
    for fn in (flash_attention, ops.flash_attention):
        assert torch.equal(fn(tq, tk, tv), want)
    assert flash_attention.launches == before
