"""The encoder-decoder (seamless-m4t-medium) and the VLM (internvl2-26b),
reduced, against the JAX package on the CPU.

seamless-m4t-medium: a 2-layer encoder over stub frame embeddings
(``frontend_proj``, sinusoidal positions, non-causal attention), a
decoder with cross attention over its output, and decode steps against
the static cross cache.  internvl2-26b: a patch prefix through
``frontend_proj`` before the tokens.  Weights are the reference's
``materialize``d ones carried across with ``convert.lm_params_to_torch``;
the reference's functions run under one ``jax.jit`` each; f32 logits and
cache leaves agree within rtol = atol = 1e-4.

The reference routes cross attention to its flash kernel under
``attn_impl="flash"`` whatever the lengths, and the kernel fails where
source and target differ in length; the port follows the code: its
kernel's shape check refuses that case, and the flash path is held at
one length."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.layers import common as jcommon
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.layers import common
from repro_torch.models import lm
from repro_torch.serving import engine

TOL = dict(rtol=1e-4, atol=1e-4)
SEAMLESS, INTERNVL = "seamless_m4t_medium", "internvl2_26b"


def _model(arch, seed=0, **kw):
    jcfg = dataclasses.replace(jbase.reduce_config(jbase.get_config(arch)),
                               **kw)
    cfg = dataclasses.replace(base.reduce_config(base.get_config(arch)), **kw)
    jp = jcommon.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(seed))
    tp = convert.lm_params_to_torch(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    return jcfg, cfg, jp, tp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _leaves(tree):
    out = []
    common.tree_map(out.append, tree)
    return out


def _batch(cfg, b, s_text, s_src=0, patches=0, seed=0):
    """Seeded numpy inputs: tokens, and frames or patches."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s_text))
           .astype(np.int32)}
    if s_src:
        out["frames"] = rng.normal(size=(b, s_src, cfg.frontend_dim)).astype(
            np.float32)
    if patches:
        out["patches"] = rng.normal(size=(b, patches, cfg.frontend_dim)
                                    ).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _prefill_and_decode(jcfg, cfg, jp, tp, batch, cache_len, pos0, steps=3):
    """The reference's and the port's prefill, then ``steps`` decode
    steps from ``pos0``: logits and every cache leaf held each time."""
    jl, jcache = jax.jit(lambda p, b: jlm.prefill(p, b, jcfg,
                                                  cache_len=cache_len))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, cache = lm.prefill(tp, _torch_batch(batch), cfg, cache_len=cache_len)
    _close(tl, jl)
    jleaves = jax.tree.leaves(jcache)
    assert len(_leaves(cache)) == len(jleaves)
    for got, want in zip(_leaves(cache), jleaves):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    pool = _leaves(cache)
    jdecode = jax.jit(lambda p, c, t, q: jlm.decode_step(p, jcfg, token=t,
                                                         pos=q, cache=c))
    b = batch["tokens"].shape[0]
    tok = np.arange(3, 3 + b, dtype=np.int32)
    pos = np.full((b,), pos0, np.int32)
    for _ in range(steps):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, out = lm.decode_step(tp, cfg, token=torch.from_numpy(tok).long(),
                                 pos=torch.from_numpy(pos).long(),
                                 cache=cache)
        assert out is cache
        _close(tl, jl)
        for t, got, want in zip(pool, _leaves(cache),
                                jax.tree.leaves(jcache)):
            assert got is t
            _close(got, want)
        tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), pos + 1
    return cache


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash"])
def test_seamless_prefill_and_decode_at_one_length(impl):
    """Frames and tokens of one length (32): the encoder's non-causal
    attention and the cross attention take the flash kernel under
    "flash"; 3 decode steps read the cross cache, which stays as the
    prefill wrote it."""
    jcfg, cfg, jp, tp = _model(SEAMLESS, seed=1, attn_impl=impl)
    batch = _batch(cfg, 2, 32, s_src=32, seed=2)
    cache = _prefill_and_decode(jcfg, cfg, jp, tp, batch, 40, 32)
    ck = cache["blocks"]["b0"]["cross_k"]
    assert ck.shape == (cfg.num_layers, 2, 32, cfg.num_kv_heads,
                        cfg.head_dim) and ck.dtype == torch.float32


def test_seamless_prefill_and_decode_at_different_lengths():
    """Under "chunked" (and "dense") the source and target lengths may
    differ: 24 frames, 16 tokens; the decode steps attend to all 24
    source positions."""
    for impl in ("chunked", "dense"):
        jcfg, cfg, jp, tp = _model(SEAMLESS, seed=3, attn_impl=impl)
        batch = _batch(cfg, 2, 16, s_src=24, seed=4)
        cache = _prefill_and_decode(jcfg, cfg, jp, tp, batch, 24, 16)
        assert cache["blocks"]["b0"]["cross_v"].shape[2] == 24


def test_flash_cross_attention_refuses_different_lengths_as_the_reference():
    """The reference's flash kernel fails on 24 frames against 16 tokens
    (``TypeError`` from a reshape); the port's kernel wrapper refuses the
    unequal shapes by name (``ValueError``)."""
    jcfg, cfg, jp, tp = _model(SEAMLESS, seed=5, attn_impl="flash")
    batch = _batch(cfg, 1, 16, s_src=24, seed=6)
    with pytest.raises(TypeError):
        jlm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with pytest.raises(ValueError, match="one shape"):
        lm.prefill(tp, _torch_batch(batch), cfg)


def test_seamless_pallas_ws_and_flash_launches(monkeypatch):
    """gemm_backend='pallas_ws' with attn_impl='flash': the gated MLPs of
    both stacks run matmul_ws (3 × (2 + 2) calls a forward) and the
    attention calls the flash kernel once a layer in the encoder
    (non-causal) and twice a layer in the decoder (causal self, non-causal
    cross); the logits match the reference's."""
    jcfg, cfg, jp, tp = _model(SEAMLESS, seed=7, gemm_backend="pallas_ws",
                               attn_impl="flash")
    mm, flash = [], []
    real_mm, real_flash = kops._matmul_kernel, kops.flash_attention
    monkeypatch.setattr(kops, "_matmul_kernel", lambda *a, **k: (
        mm.append(tuple(a[1].shape)) or real_mm(*a, **k)))
    monkeypatch.setattr(kops, "flash_attention", lambda *a, **k: (
        flash.append(k["causal"]) or real_flash(*a, **k)))
    batch = _batch(cfg, 1, 32, s_src=32, seed=8)
    jl, _ = jlm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                        jcfg)
    tl, _ = lm.prefill(tp, _torch_batch(batch), cfg)
    _close(tl, jl)
    layers = cfg.encoder_layers + cfg.num_layers
    assert mm == [(64, 128), (64, 128), (128, 64)] * layers
    assert flash == [False] * cfg.encoder_layers + [True, False] * \
        cfg.num_layers


def test_internvl2_prefill_with_patches_and_decode_after_them():
    """8 patches before 24 tokens: positions and the cache count the
    patches first; decode steps at pos = P + S."""
    jcfg, cfg, jp, tp = _model(INTERNVL, seed=9, attn_impl="flash")
    assert cfg.frontend_tokens == 8 and cfg.frontend_dim == 32
    batch = _batch(cfg, 2, 24, patches=8, seed=10)
    cache = _prefill_and_decode(jcfg, cfg, jp, tp, batch, 40, 8 + 24)
    assert cache["blocks"]["b0"]["kv"].k.shape[2] == 40


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_internvl2_forward_train_slices_the_prefix_off(impl):
    jcfg, cfg, jp, tp = _model(INTERNVL, seed=11, attn_impl=impl)
    batch = _batch(cfg, 2, 24, patches=8, seed=12)
    want, _ = jax.jit(lambda p, b: jlm.forward_train(p, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = lm.forward_train(tp, _torch_batch(batch), cfg)
    assert tuple(got.shape) == (2, 24, cfg.vocab_size) == want.shape
    assert float(aux) == 0.0
    _close(got, want)


def test_internvl2_engine_serves_tokens_as_the_jax_engine():
    """The engine serves a VLM from token prompts alone, as the
    reference's does: greedy tokens equal the JAX engine's."""
    jcfg, cfg, jp, tp = _model(INTERNVL, seed=13)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 20, 9, 20)]
    news = (6, 3, 5, 4)
    jreqs = [jengine.Request(uid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, news))]
    jengine.ServingEngine(jcfg, jp, slots=2, max_seq=32).run(list(jreqs))
    reqs = [engine.Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, news))]
    engine.ServingEngine(cfg, tp, slots=2, max_seq=32, device="cpu").run(
        list(reqs))
    for got, want in zip(reqs, jreqs):
        assert got.done and got.output == want.output, got.uid


def test_engine_and_launcher_refuse_the_encoder_decoder(capsys):
    """The reference's engine prefills token prompts and its encoder
    fails on the missing frames; the port's refuses up front."""
    jcfg, cfg, jp, tp = _model(SEAMLESS, seed=15)
    with pytest.raises(AttributeError, match="NoneType"):
        jengine.ServingEngine(jcfg, jp, slots=1, max_seq=16).run(
            [jengine.Request(uid=0, prompt=np.arange(4, dtype=np.int32))])
    with pytest.raises(NotImplementedError, match="frames"):
        engine.ServingEngine(cfg, tp, slots=1, max_seq=16, device="cpu")
    with pytest.raises(NotImplementedError, match="frames"):
        serve.main(["--arch", "seamless-m4t-medium", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "seamless-m4t-medium", "--device", "cpu",
                    "--w8"])
    assert "encdec model" in capsys.readouterr().err


def test_launcher_serves_internvl2_and_refuses_w8(capsys):
    serve.main(["--arch", "internvl2-26b", "--device", "cpu",
                "--requests", "3", "--max-new", "4"])
    assert capsys.readouterr().out.startswith("3 requests, 12 tokens")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "internvl2-26b", "--device", "cpu", "--w8"])
    assert "vlm model" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "qwen3_moe_30b_a3b",
                                  SEAMLESS, INTERNVL])
def test_weights_carry_across_leaf_for_leaf(arch):
    """``lm_params_to_torch`` carries the reduced trees as they are: the
    reference's flatten order, shapes and values, and the port's spec
    tree has the same leaves in the same order."""
    jcfg, cfg, jp, tp = _model(arch)
    jleaves, tleaves = jax.tree.leaves(jp), _leaves(tp)
    assert len(jleaves) == len(tleaves) == len(_leaves(lm.param_specs(cfg)))
    for j, t, s in zip(jleaves, tleaves, _leaves(lm.param_specs(cfg))):
        assert tuple(t.shape) == j.shape == s.shape
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
