"""The hybrid and attention-free LMs, recurrentgemma-9b and rwkv6-1.6b,
reduced, against the JAX package on the CPU.

recurrentgemma-9b runs at the reference's reduced size (5 layers: one
R,R,A group and an R,R tail; d_model 64, rnn_width 64, window 64) and
rwkv6-1.6b at 2 layers, so its stack has two groups.  The reference's
``materialize``d weights (with the zero-initialised recurrent parameters
redrawn, so every term counts) are carried across with
``convert.lm_params_to_torch``.  f32 logits agree within rtol = atol =
1e-4 (the two sum in another order); the engines' greedy tokens are
equal."""

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
from repro_torch.models import blocks, lm
from repro_torch.serving import engine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {"recurrentgemma_9b": {}, "rwkv6_1p6b": dict(num_layers=2)}
# leaves the reference initialises to zeros or a constant, redrawn so that
# every term of the recurrent blocks reaches the logits
REDRAWN = ("b_a", "b_x", "conv_b", "mu_base", "mu", "ddlerp_b", "w_lora_b",
           "gn_bias", "mu_k", "mu_r")


def _configs(arch, **kw):
    kw = {**ARCHS[arch], **kw}
    jcfg = dataclasses.replace(jbase.reduce_config(jbase.get_config(arch)),
                               **kw)
    cfg = dataclasses.replace(base.reduce_config(base.get_config(arch)), **kw)
    return jcfg, cfg


def _redraw(tree, rng):
    if isinstance(tree, dict):
        return {k: (jnp.asarray(0.3 * rng.normal(size=v.shape), v.dtype)
                    if k in REDRAWN and not isinstance(v, dict)
                    else _redraw(v, rng)) for k, v in tree.items()}
    return tree


def _model(arch, seed=0, **kw):
    jcfg, cfg = _configs(arch, **kw)
    jp = _redraw(jcommon.materialize(jlm.param_specs(jcfg),
                                     jax.random.PRNGKey(seed)),
                 np.random.default_rng(seed))
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


def test_reduced_sizes_are_the_reference_s():
    rg = base.reduce_config(base.get_config("recurrentgemma_9b"))
    assert (rg.num_layers, rg.d_model, rg.rnn_width, rg.attention_window,
            rg.num_groups_scan, rg.tail_blocks) == (
        5, 64, 64, 64, 1, ("rglru", "rglru"))
    rw = base.reduce_config(base.get_config("rwkv6_1p6b"))
    assert (rw.num_layers, rw.d_model, rw.layer_pattern) == (1, 64,
                                                             ("rwkv6",))
    full = base.get_config("recurrentgemma_9b")
    assert full.block_kinds().count("rglru") == 26
    assert round(base.param_count(full) / 1e9, 2) == 9.40


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_weights_carry_across_leaf_for_leaf(arch):
    """``lm_params_to_torch`` keeps the reference's tree and flatten order,
    and the port's spec tree has the same leaves in the same order."""
    jcfg, cfg, jp, tp = _model(arch)
    jleaves = jax.tree.leaves(jp)
    tleaves = _leaves(tp)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    specs = _leaves(lm.param_specs(cfg))
    assert [s.shape for s in specs] == [j.shape for j in jleaves]
    cspecs = jax.tree.leaves(jlm.cache_specs(jcfg, 4, 40),
                             is_leaf=jcommon.is_spec)
    assert [(s.shape, s.dtype, s.axes) for s in cspecs] == [
        (s.shape, s.dtype, s.axes) for s in _leaves(lm.cache_specs(cfg, 4,
                                                                   40))]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_four_decode_steps_past_the_window(arch):
    """A 96-token prompt (past recurrentgemma's reduced window of 64) and
    4 decode steps at different positions per row: logits and every
    cache leaf against the reference's."""
    jcfg, cfg, jp, tp = _model(arch, seed=1)
    tokens = np.random.default_rng(2).integers(0, 512, (2, 96)).astype(
        np.int32)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                             cache_len=128)
    tl, cache = lm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()},
                           cfg, cache_len=128)
    _close(tl, jl)
    for got, want in zip(_leaves(cache), jax.tree.leaves(jcache)):
        _close(got, want)
    pool = _leaves(cache)
    tok, pos = np.array([5, 300], np.int32), np.array([96, 96], np.int32)
    for _ in range(4):
        jl, jcache = jlm.decode_step(jp, jcfg, token=jnp.asarray(tok),
                                     pos=jnp.asarray(pos), cache=jcache)
        tl, out = lm.decode_step(tp, cfg, token=torch.from_numpy(tok).long(),
                                 pos=torch.from_numpy(pos).long(),
                                 cache=cache)
        assert out is cache
        _close(tl, jl)
        # every leaf was written in place, and equals the reference's
        for t, got, want in zip(pool, _leaves(cache),
                                jax.tree.leaves(jcache)):
            assert got is t
            _close(got, want)
        tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), pos + 1


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_train_equals_the_reference(arch):
    jcfg, cfg, jp, tp = _model(arch, seed=3)
    tokens = np.random.default_rng(4).integers(0, 512, (2, 80)).astype(
        np.int32)
    want, _ = jlm.forward_train(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    got, aux = lm.forward_train(tp, {"tokens": torch.from_numpy(tokens)
                                     .long()}, cfg)
    assert float(aux) == 0.0
    _close(got, want)


def test_recurrentgemma_pallas_ws_runs_its_mlps_on_matmul_ws(monkeypatch):
    """gemm_backend='pallas_ws': the gated MLP's three GEMMs a layer go to
    matmul_ws (3 × 5 calls a forward at the reduced depth; the recurrent
    blocks' and attention's GEMMs pass no backend) and the logits match
    the reference's, whose MLPs run the Pallas kernel in interpret mode.
    attn_impl='flash' takes no flash_attention call: the local-attention
    layers have a window, which goes to the chunked attention."""
    jcfg, cfg, jp, tp = _model("recurrentgemma_9b", seed=5,
                               gemm_backend="pallas_ws", attn_impl="flash")
    calls = []
    real = kops._matmul_kernel
    monkeypatch.setattr(kops, "_matmul_kernel", lambda *a, **k: (
        calls.append(a[0].shape) or real(*a, **k)))

    def no_flash(*a, **k):
        raise AssertionError("flash_attention called for a windowed layer")
    monkeypatch.setattr(kops, "flash_attention", no_flash)
    tokens = np.random.default_rng(6).integers(0, 512, (1, 40)).astype(
        np.int32)
    jl, _ = jlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                        cache_len=48)
    tl, _ = lm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()}, cfg,
                       cache_len=48)
    _close(tl, jl)
    assert len(calls) == 3 * cfg.num_layers
    assert all(s == (40, 64) or s == (40, 128) for s in calls)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_tokens_equal_the_jax_engine_with_slot_reuse(arch):
    """4 slots, 6 requests of mixed prompt lengths (one past the reduced
    window) and lengths, so slots are reused after a finished request;
    every request's greedy tokens equal the JAX engine's."""
    jcfg, cfg, jp, tp = _model(arch, seed=7)
    rng = np.random.default_rng(8)
    lengths = (5, 70, 9, 100, 12, 33)
    news = (6, 3, 9, 5, 7, 4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    jreqs = [jengine.Request(uid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, news))]
    jdone = jengine.ServingEngine(jcfg, jp, slots=4, max_seq=128).run(
        list(jreqs))
    reqs = [engine.Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, news))]
    eng = engine.ServingEngine(cfg, tp, slots=4, max_seq=128, device="cpu")
    done = eng.run(list(reqs))
    assert [r.uid for r in done] == [r.uid for r in jdone]
    for got, want in zip(reqs, jreqs):
        assert got.done and len(got.output) == want.max_new_tokens
        assert got.output == want.output, (got.uid, got.output, want.output)
    assert eng.active == [None] * 4


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_admit_overwrites_a_used_slot_whole(arch):
    """Admitting into a slot whose previous request left non-zero state
    (recurrent conv / h, or S / x_att / x_ffn, and the local attention's
    ring) puts the new request's prefill cache there whole, leaf for leaf
    as the reference's ``_scatter_slot`` does, and leaves the other slots
    alone."""
    _, cfg, _, tp = _model(arch, seed=9)
    eng = engine.ServingEngine(cfg, tp, slots=4, max_seq=96, device="cpu")
    rng = np.random.default_rng(10)
    first = [engine.Request(uid=i, prompt=rng.integers(0, 512, size=n),
                            max_new_tokens=3) for i, n in enumerate(
        (80, 7, 30, 11))]
    eng.run(first)                          # four slots, all left dirty
    # stacked leaves [G, B, ...] hold the batch on axis 1, tail ones on 0
    parts = [(1, "blocks")] + ([(0, "tail")] if "tail" in eng.cache else [])
    before = {k: [t.clone() for t in _leaves(eng.cache[k])] for _, k in parts}
    assert all(bool(t.abs().sum() > 0) for ts in before.values() for t in ts)
    prompt = rng.integers(0, 512, size=21)
    assert eng.admit(engine.Request(uid=9, prompt=prompt))
    slot = next(i for i, r in enumerate(eng.active) if r is not None)
    _, one = lm.prefill(eng.params, {"tokens": torch.as_tensor(
        prompt)[None].long()}, cfg, cache_len=96)
    keep = torch.tensor([s for s in range(4) if s != slot])
    for axis, part in parts:
        for old, pool, new in zip(before[part], _leaves(eng.cache[part]),
                                  _leaves(one[part])):
            assert torch.equal(pool.select(axis, slot),
                               new.select(axis, 0).to(pool.dtype))
            assert torch.equal(pool.index_select(axis, keep),
                               old.index_select(axis, keep))
            want = jengine._scatter_slot(jnp.asarray(old.numpy()),
                                         jnp.asarray(new.numpy()), slot)
            np.testing.assert_array_equal(pool.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_launcher_serves_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    assert capsys.readouterr().out.startswith("3 requests, 12 tokens")
    # the reference has no w8 path for these blocks: refused, by name
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--device", "cpu", "--w8"])
    assert "no w8 path" in capsys.readouterr().err


def test_unknown_block_kind_raises():
    _, cfg = _configs("rwkv6_1p6b")
    with pytest.raises(ValueError):
        blocks.block_specs(cfg, "mamba")
