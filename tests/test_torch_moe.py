"""The MoE feed-forward and the MoE decoders (deepseek-moe-16b,
qwen3-moe-30b-a3b), reduced, against the JAX package on the CPU.

Weights are the reference's ``materialize``d ones carried across with
``convert.lm_params_to_torch``; the reference's functions run under one
``jax.jit`` each.  f32 outputs and aux losses agree within rtol = atol =
1e-4 (the two sum in another order); the routing (each token's top-k
experts, in order, and which choices the capacity keeps) is identical,
including a router that sends every token to one expert, so that the
capacity drops choices and the scatter-min picks among them, and a
router whose top experts tie exactly, where ``jax.lax.top_k`` takes the
lower index first."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.layers import common as jcommon
from repro.layers import moe as jmoe
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.layers import common, moe
from repro_torch.models import lm
from repro_torch.serving import engine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("deepseek_moe_16b", "qwen3_moe_30b_a3b")


def _configs(arch, **kw):
    jcfg = dataclasses.replace(jbase.reduce_config(jbase.get_config(arch)),
                               **kw)
    cfg = dataclasses.replace(base.reduce_config(base.get_config(arch)), **kw)
    return jcfg, cfg


def _carry(jp):
    return convert.lm_params_to_torch(jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _moe_params(jcfg, seed=0):
    return jcommon.materialize(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed))


def _jax_routing(jp, x, jcfg):
    """The reference's router steps (``apply_moe``'s first lines): the
    top-k experts of each token by ``jax.lax.top_k``."""
    G = jcfg.moe.num_groups or x.shape[0]
    xg = x.reshape(G, -1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg.astype(jnp.float32),
                                      jp["router"].astype(jnp.float32)), -1)
    return probs, jax.lax.top_k(probs, jcfg.moe.top_k)[1]


def _keep_oracle(gate_idx, capacity):
    """Which flattened (token, k) choices the capacity keeps: a choice's
    position is the count of earlier choices of its expert in its
    group."""
    G = gate_idx.shape[0]
    flat = gate_idx.reshape(G, -1)
    keep = np.zeros(flat.shape, bool)
    for g in range(G):
        seen = {}
        for i, e in enumerate(flat[g]):
            keep[g, i] = seen.get(int(e), 0) < capacity
            seen[int(e)] = seen.get(int(e), 0) + 1
    return keep


def _check_moe(jcfg, cfg, jp, x):
    """apply_moe in both packages on ``x``: output and aux loss within
    the tolerance, the routing identical → the port's Routing."""
    want, want_aux = jax.jit(lambda p, v: jmoe.apply_moe(p, v, jcfg))(
        jp, jnp.asarray(x))
    seen = []
    real = moe.route

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]
    moe.route = spy
    try:
        got, aux = moe.apply_moe(_carry(jp), torch.from_numpy(x), cfg)
    finally:
        moe.route = real
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)
    _close(aux, want_aux)
    r, = seen
    _, jidx = _jax_routing(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(jidx))
    B, S = x.shape[:2]
    G = cfg.moe.num_groups or B
    C = moe._capacity(B * S // G, cfg.moe)
    np.testing.assert_array_equal(r.keep.numpy(),
                                  _keep_oracle(np.asarray(jidx), C))
    return r


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_specs_and_capacity_equal_the_reference(arch):
    jcfg, cfg = _configs(arch)
    for full in (False, True):
        j = jbase.get_config(arch) if full else jcfg
        t = base.get_config(arch) if full else cfg
        assert moe.moe_specs(t) == {
            k: (common.ParamSpec(*dataclasses.astuple(v))
                if isinstance(v, jcommon.ParamSpec) else
                {kk: common.ParamSpec(*dataclasses.astuple(vv))
                 for kk, vv in v.items()})
            for k, v in jmoe.moe_specs(j).items()}
        for tg in (1, 4, 7, 33, 64, 100, 512, 4096, 4097):
            assert moe._capacity(tg, t.moe) == jmoe._capacity(tg, j.moe)
    # the published configs: 4096 tokens in one group
    assert moe._capacity(4096, base.get_config(arch).moe) == (
        480 if arch == "deepseek_moe_16b" else 320)


@pytest.mark.parametrize("shape", [(1, 64), (4, 1), (2, 24)],
                         ids=["prefill_G1", "decode_G4", "G2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_the_reference(arch, shape):
    """A prefill-shaped call (one group of 64 tokens), a 4-slot
    decode-shaped one (four groups of one token, C = 8) and two groups
    of 24."""
    jcfg, cfg = _configs(arch)
    jp = _moe_params(jcfg, seed=1)
    x = np.random.default_rng(2).normal(size=(*shape, 64)).astype(
        np.float32)
    r = _check_moe(jcfg, cfg, jp, x)
    assert r.gate_vals.shape == (shape[0], shape[1], cfg.moe.top_k)
    torch.testing.assert_close(r.gate_vals.sum(-1),
                               torch.ones(shape), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_overflow_drops_and_scatters_as_the_reference(arch):
    """A router that sends every token's first choice to expert 0: 64
    tokens in one group against C = 24 (K = 2, E = 8, factor 1.25), so
    40 first choices overflow and are dropped.  The other experts'
    probabilities underflow to exactly 0, a tie that sends every second
    choice to expert 1, where 40 more overflow."""
    jcfg, cfg = _configs(arch)
    jp = _moe_params(jcfg, seed=3)
    router = np.array(jp["router"])
    router[0, :] = 0.0
    router[0, 0] = 100.0
    jp = {**jp, "router": jnp.asarray(router)}
    x = np.random.default_rng(4).normal(size=(1, 64, 64)).astype(np.float32)
    x[..., 0] = 10.0
    r = _check_moe(jcfg, cfg, jp, x)
    assert bool((r.gate_idx[..., 0] == 0).all())
    C = moe._capacity(64, cfg.moe)
    assert C == 24
    first = r.keep.reshape(1, 64, cfg.moe.top_k)[..., 0]
    assert int(first.sum()) == C and bool(first[0, :C].all())
    assert bool((r.gate_idx[..., 1] == 1).all())
    assert int((~r.keep).sum()) == 2 * (64 - C)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_tie_takes_the_lower_expert_first(arch):
    """Experts 1, 3 and 5 have one router column and lead every token's
    probabilities, tied exactly: both packages take 1 then 3 (top-2)."""
    jcfg, cfg = _configs(arch)
    jp = _moe_params(jcfg, seed=5)
    router = np.array(jp["router"])
    router[0, :] = 0.0
    router[0, 1] = 5.0
    router[:, 3] = router[:, 1]
    router[:, 5] = router[:, 1]
    jp = {**jp, "router": jnp.asarray(router)}
    x = np.random.default_rng(6).normal(size=(2, 16, 64)).astype(np.float32)
    x[..., 0] = 10.0
    probs, _ = _jax_routing(jp, jnp.asarray(x), jcfg)
    probs = np.asarray(probs)
    assert np.array_equal(probs[..., 1], probs[..., 3])
    assert np.array_equal(probs[..., 1], probs[..., 5])
    r = _check_moe(jcfg, cfg, jp, x)
    assert bool((r.gate_idx[..., 0] == 1).all())
    assert bool((r.gate_idx[..., 1] == 3).all())


def test_router_jitter_draws_from_the_generator_in_training_only():
    """``router_jitter`` adds noise from ``rng`` when ``train=True``: the
    same seed gives the same routing, and without training (or without a
    generator) the call equals the jitter-free one."""
    _, cfg = _configs("deepseek_moe_16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_jitter=0.5))
    p = common.materialize(moe.moe_specs(cfg), torch.Generator()
                           .manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 16, 64)).astype(np.float32))
    plain, _ = moe.apply_moe(p, x, cfg)
    for kw in ({}, dict(train=True),
               dict(rng=torch.Generator().manual_seed(1))):
        assert torch.equal(moe.apply_moe(p, x, cfg, **kw)[0], plain)
    a, _ = moe.apply_moe(p, x, cfg, train=True,
                         rng=torch.Generator().manual_seed(1))
    b, _ = moe.apply_moe(p, x, cfg, train=True,
                         rng=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, plain)


def _model(arch, seed=0, **kw):
    jcfg, cfg = _configs(arch, **kw)
    jp = jcommon.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, _carry(jp)


def _leaves(tree):
    out = []
    common.tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_equal_the_reference(arch, impl):
    """A 40-token prefill of two rows (one group each) and 3 decode steps
    of both rows (two groups of one token): logits and every cache leaf
    against the reference's, the cache written in place."""
    jcfg, cfg, jp, tp = _model(arch, seed=1, num_layers=2, attn_impl=impl)
    tokens = np.random.default_rng(8).integers(0, 512, (2, 40)).astype(
        np.int32)
    jl, jcache = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t}, jcfg,
                                                  cache_len=48))(
        jp, jnp.asarray(tokens))
    tl, cache = lm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()},
                           cfg, cache_len=48)
    _close(tl, jl)
    pool = _leaves(cache)
    jdecode = jax.jit(lambda p, c, t, q: jlm.decode_step(p, jcfg, token=t,
                                                         pos=q, cache=c))
    tok, pos = np.array([5, 300], np.int32), np.array([40, 40], np.int32)
    for _ in range(3):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_sums_the_aux_loss_as_the_reference(arch):
    jcfg, cfg, jp, tp = _model(arch, seed=2, num_layers=3)
    tokens = np.random.default_rng(9).integers(0, 512, (2, 32)).astype(
        np.int32)
    want, want_aux = jax.jit(lambda p, t: jlm.forward_train(
        p, {"tokens": t}, jcfg))(jp, jnp.asarray(tokens))
    got, aux = lm.forward_train(tp, {"tokens": torch.from_numpy(tokens)
                                     .long()}, cfg)
    _close(got, want)
    assert float(aux) > 0.0
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_pallas_ws_runs_only_the_shared_experts_on_matmul_ws(arch,
                                                             monkeypatch):
    """gemm_backend='pallas_ws': deepseek's shared experts (a gated MLP)
    make 3 matmul_ws calls a layer a forward; the routed experts are
    batched einsums and qwen3 has no shared expert, so it makes none.
    The logits match the reference's, whose shared experts run the Pallas
    kernel in interpret mode."""
    jcfg, cfg, jp, tp = _model(arch, seed=3, num_layers=2,
                               gemm_backend="pallas_ws")
    calls = []
    real = kops._matmul_kernel
    monkeypatch.setattr(kops, "_matmul_kernel", lambda *a, **k: (
        calls.append(tuple(a[1].shape)) or real(*a, **k)))
    tokens = np.random.default_rng(10).integers(0, 512, (1, 24)).astype(
        np.int32)
    jl, _ = jlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                        cache_len=32)
    tl, _ = lm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()}, cfg,
                       cache_len=32)
    _close(tl, jl)
    shared = cfg.moe.num_shared * cfg.moe.expert_ff
    want = ([(64, shared)] * 2 + [(shared, 64)]) * cfg.num_layers \
        if cfg.moe.num_shared else []
    assert calls == want


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_jax_engine(arch):
    """4 slots, 6 requests of mixed lengths, so slots are reused; every
    request's greedy tokens equal the JAX engine's."""
    jcfg, cfg, jp, tp = _model(arch, seed=4, num_layers=2)
    rng = np.random.default_rng(11)
    lengths, news = (5, 33, 9, 33, 5, 17), (6, 3, 9, 5, 7, 4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    jreqs = [jengine.Request(uid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, news))]
    jdone = jengine.ServingEngine(jcfg, jp, slots=4, max_seq=64).run(
        list(jreqs))
    reqs = [engine.Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, news))]
    eng = engine.ServingEngine(cfg, tp, slots=4, max_seq=64, device="cpu")
    done = eng.run(list(reqs))
    assert [r.uid for r in done] == [r.uid for r in jdone]
    for got, want in zip(reqs, jreqs):
        assert got.done and got.output == want.output, got.uid
    assert eng.active == [None] * 4


def test_launcher_serves_a_moe_model_and_refuses_w8(capsys):
    serve.main(["--arch", "deepseek-moe-16b", "--device", "cpu",
                "--requests", "3", "--max-new", "4"])
    assert capsys.readouterr().out.startswith("3 requests, 12 tokens")
    for arch in ("deepseek-moe-16b", "qwen3-moe-30b-a3b"):
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch, "--device", "cpu", "--w8"])
        assert "MoE model" in capsys.readouterr().err
