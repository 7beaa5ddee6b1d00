"""w8a8 LM serving with the int8 KV cache: the port against the JAX
package on the CPU.

The same seeded inputs, and the reference's own weights carried across
with ``convert.lm_params_to_torch``, go through the JAX function and its
port.  The integer paths (the int8 GEMMs of ``w8_einsum``, the int8
cache's two contractions) are exact in both, so their results and
everything computed from them by the same f32 operations are compared
for equality; where an f32 einsum of another summation order follows,
the test states the bound it holds the difference to."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import quantize as jquant
from repro.layers import attention as jattn
from repro.layers import common as jcommon
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import quantize as quant
from repro_torch.layers import attention, common
from repro_torch.models import lm
from repro_torch.serving import engine

LM_ARCHS = ["llama3p2_3b", "gemma_7b", "yi_34b"]
KV_SCALE = 0.25          # the launchers' fixed int8 cache scale


def _configs(arch="llama3p2_3b", **kw):
    jcfg = dataclasses.replace(jbase.reduce_config(jbase.get_config(arch)),
                               **kw)
    cfg = dataclasses.replace(base.reduce_config(base.get_config(arch)), **kw)
    return jcfg, cfg


def _to_torch(tree):
    return convert.lm_params_to_torch(jax.tree.map(np.asarray, tree),
                                      device="cpu")


def _normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- w8_einsum and the weight quantizer ------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sub,xs,ws", [
    ("bsd,dhe->bshe", (2, 3, 64), (64, 4, 16)),
    ("bshe,hed->bsd", (2, 3, 4, 16), (4, 16, 64)),
    ("bsd,df->bsf", (1, 5, 64), (64, 48)),
    ("bsd,dv->bsv", (4, 1, 64), (64, 512))])
def test_w8_einsum_equals_the_reference(sub, xs, ws, dtype):
    """Per-tensor activation quantization (round half to even), the
    int8 × int8 → int32 GEMM on matmul_ws's plain version, the rescale in
    the reference's order: equal bit for bit, in f32 and in bf16."""
    x = _normal(*xs, seed=1) * 3
    w = _normal(*ws, seed=2)
    jw = jquant.quantize_weights({"m": {"w": jnp.asarray(w)}})["m"]["w"]
    tw = _to_torch(jw)
    want = jquant.w8_einsum(sub, jnp.asarray(x), jw["q"], jw["s"],
                            compute_dtype=jnp.dtype(dtype))
    got = quant.w8_einsum(sub, torch.from_numpy(x), tw["q"], tw["s"],
                          compute_dtype=dtype)
    assert got.dtype == common.torch_dtype(dtype)
    assert got.shape == want.shape
    _equal(got.float(), want.astype(jnp.float32))


def test_w8_einsum_refuses_what_is_not_a_flattened_gemm():
    q = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="not a GEMM"):
        quant.w8_einsum("bsd,fd->bsf", torch.zeros(1, 2, 8), q.t(),
                        torch.ones(1, 4))


def test_quantized_matmul_equals_the_reference():
    x = _normal(6, 64, seed=3)
    w = _normal(64, 40, seed=4)
    jq = jquant.quantize_symmetric(jnp.asarray(w), axis=0)
    tq = quant.quantize_symmetric(torch.from_numpy(w), axis=0)
    _equal(tq.values, jq.values)
    want = jquant.quantized_matmul(jnp.asarray(x), jq, use_kernel=False)
    for use_kernel in (True, False):
        got = quant.quantized_matmul(torch.from_numpy(x), tq,
                                     use_kernel=use_kernel)
        _equal(got, want)
    served = quant.quantize_params_for_serving(
        {"a": {"w": torch.from_numpy(w)}, "n": torch.ones(4)})
    assert isinstance(served["a"]["w"], quant.Quantized)
    _equal(served["a"]["w"].scale, jq.scale)
    assert torch.equal(served["n"], torch.ones(4))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_quantize_weights_equals_the_reference_at_one_group(arch):
    """One layer group (the reduced config): the port's per-layer scales
    are the reference's one scale, leaf for leaf, with the specs' shapes;
    ``exclude=()`` quantizes the untied unembedding too."""
    jcfg, cfg = _configs(arch)
    assert cfg.num_groups_scan == 1
    jp = jcommon.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(0))
    tp = _to_torch(jp)
    for exclude in (("embedding",), ()):
        want = jquant.quantize_weights(jp, jlm.param_specs(jcfg),
                                       exclude=exclude)
        got = quant.quantize_weights(tp, lm.param_specs(cfg),
                                     exclude=exclude)
        wl, gl = jax.tree.leaves(want), jax.tree.leaves(got)
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(np.asarray, got))
        for g, w in zip(gl, wl):
            assert str(g.dtype)[6:] == str(w.dtype)
            _equal(g, w)
    assert isinstance(got["embedding"].get("unembed", {}), dict)


def _spec_shapes(tree):
    return [(s.shape, s.dtype) for s in jax.tree.leaves(
        tree, is_leaf=jcommon.is_spec)]


def _jax_per_layer_w8(jp, jspecs):
    """The reference's w8 tree with per-layer scales, built with its own
    ``quantize_symmetric`` on each layer of every stacked ≥2-D weight."""
    def per_layer(p, s):
        if s.dtype != "float32" or len(s.shape) - 1 < 2:
            return p
        qs = [jquant.quantize_symmetric(p[g], axis=tuple(range(p.ndim - 2)))
              for g in range(p.shape[0])]
        return {"q": jnp.stack([q.values for q in qs]),
                "s": jnp.stack([q.scale for q in qs])}
    return dict(jp, blocks=jax.tree.map(per_layer, jp["blocks"],
                                        jspecs["blocks"]))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_quantize_weights_is_per_layer_at_three_groups(arch):
    """Three layer groups: each stacked weight's values and scale equal
    the reference's ``quantize_symmetric`` of each layer alone, stacked,
    with the shapes the reference's ``quantize_weight_specs`` declares
    (and the port's specs equal the reference's)."""
    jcfg, cfg = _configs(arch, num_layers=3)
    jspecs = jlm.param_specs(jcfg)
    jp = jcommon.materialize(jspecs, jax.random.PRNGKey(1))
    got = quant.quantize_weights(_to_torch(jp), lm.param_specs(cfg))
    want = _jax_per_layer_w8(jp, jspecs)
    wl, gl = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        _equal(g, w)
    jqspecs = jquant.quantize_weight_specs(jspecs)
    assert _spec_shapes(quant.quantize_weight_specs(lm.param_specs(cfg))) \
        == _spec_shapes(jqspecs)
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in gl] == \
        _spec_shapes(jqspecs)
    assert got["blocks"]["b0"]["attn"]["wq"]["s"].shape == (3, 1, 1, 16)


def test_reference_quantize_weights_shares_one_scale_over_the_stack():
    """The reference caveat the port departs from: at more than one layer
    group, the reference's ``quantize_weights`` reduces over the stack
    dimension too, so one scale (leading size 1) serves all layers, while
    its ``quantize_weight_specs`` declares per-layer scales [G, ...], and
    its own ``lm.prefill`` cannot scan the tree."""
    jcfg, _ = _configs(num_layers=3)
    jspecs = jlm.param_specs(jcfg)
    jp = jcommon.materialize(jspecs, jax.random.PRNGKey(1))
    jq = jquant.quantize_weights(jp, jspecs)
    declared = jquant.quantize_weight_specs(jspecs)
    assert jq["blocks"]["b0"]["attn"]["wq"]["s"].shape == (1, 1, 1, 16)
    assert declared["blocks"]["b0"]["attn"]["wq"]["s"].shape == (3, 1, 1, 16)
    with pytest.raises(ValueError, match="leading axis sizes"):
        jlm.prefill(jq, {"tokens": jnp.zeros((1, 4), jnp.int32)}, jcfg)


def test_convert_carries_a_w8_tree_with_its_dtypes():
    jcfg, _ = _configs()
    jq = jquant.quantize_weights(
        jcommon.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(2)),
        jlm.param_specs(jcfg))
    tq = _to_torch(jq)
    wo = tq["blocks"]["b0"]["mlp"]["wo"]
    assert wo["q"].dtype == torch.int8 and wo["s"].dtype == torch.float32
    assert tq["embedding"]["embed"].dtype == torch.float32
    _equal(wo["q"], jq["blocks"]["b0"]["mlp"]["wo"]["q"])


# -- the int8 KV cache -------------------------------------------------

class _Recorder:
    """The reference attention module's ``jnp``, recording every int8
    einsum (its operands and int32 result) on the way through."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, sub, a, b, **kw):
        out = jnp.einsum(sub, a, b, **kw)
        if kw.get("preferred_element_type") == jnp.int32:
            self.calls.append((sub, np.asarray(a), np.asarray(b),
                               np.asarray(out)))
        return out


def _record_port(monkeypatch):
    calls = []
    real = attention._int8_contract

    def rec(sub, a, b):
        out = real(sub, a, b)
        calls.append((sub, a.numpy().copy(), b.numpy().copy(),
                      out.numpy().copy()))
        return out
    monkeypatch.setattr(attention, "_int8_contract", rec)
    return calls


@pytest.mark.parametrize("window", [0, 8])
def test_int8_cache_decode_equals_the_reference(window, monkeypatch):
    """A full cache, and a ring of 8 slots (window 8) filled past its
    capacity, with rows at different positions: the new K/V written on the
    int8 grid, the quantized q, the q·k sums, pq and the p·v sums equal the
    reference's.  What follows the p·v sums is the same f32 rescale and
    the wo einsum (f32 weights here), whose two summation orders each
    stay within γ_K = K·2^-24 of Σ|out·wo| (K = 64 terms), so the outputs
    differ by at most 2·γ_K·Σ|out·wo|."""
    jcfg, cfg = _configs(kv_cache_dtype="int8", kv_cache_scale=KV_SCALE)
    jp = jcommon.materialize(jattn.attention_specs(jcfg),
                             jax.random.PRNGKey(3))
    tp = _to_torch(jp)
    s_cache = 8 if window else 24
    rng = np.random.default_rng(13)
    kc = rng.integers(-128, 128, (3, s_cache, 2, 16)).astype(np.int8)
    vc = rng.integers(-128, 128, (3, s_cache, 2, 16)).astype(np.int8)
    x = _normal(3, 1, 64, seed=15) * 4
    pos = np.array([3, 11, 21], np.int32)
    rec = _Recorder()
    monkeypatch.setattr(jattn, "jnp", rec)
    jy, jcache = jattn.decode_attention_layer(
        jp, jnp.asarray(x), jcfg, cache=jattn.KVCache(jnp.asarray(kc),
                                                      jnp.asarray(vc)),
        pos=jnp.asarray(pos), window=window)
    monkeypatch.undo()
    calls = _record_port(monkeypatch)
    cache = attention.KVCache(torch.from_numpy(kc.copy()),
                              torch.from_numpy(vc.copy()))
    y, out = attention.decode_attention_layer(
        tp, torch.from_numpy(x), cfg, cache=cache,
        pos=torch.from_numpy(pos).long(), window=window)
    assert out.k.dtype == torch.int8 and out.k is cache.k
    _equal(out.k, jcache.k)
    _equal(out.v, jcache.v)
    assert [c[0] for c in calls] == [c[0] for c in rec.calls] == [
        "bkgd,bskd->bkgs", "bkgs,bskd->bkgd"]
    for (_, a, b, acc), (_, ja, jb, jacc) in zip(calls, rec.calls):
        np.testing.assert_array_equal(a, ja)          # qq, then pq
        np.testing.assert_array_equal(b, jb)          # the cache
        assert np.array_equal(acc, acc.round())       # integers in f32
        np.testing.assert_array_equal(acc.astype(np.int32), jacc)
    pq = calls[1][1]
    assert pq.min() >= 0 and pq.max() <= 127 and pq.sum(-1).max() <= 254
    # the wo einsum's operand: the rescaled p·v sums in the compute dtype
    o = (calls[1][3] * np.float32(KV_SCALE / 127.0)).reshape(3, 1, -1)
    wo = np.asarray(jp["wo"]).reshape(-1, 64)
    bound = 2 * 64 * 2.0 ** -24 * (np.abs(o) @ np.abs(wo))
    assert (np.abs(y.numpy() - np.asarray(jy)) <= bound).all()


def test_int8_contractions_are_exact_at_their_bounds():
    """The f32 contractions give the exact int32 sums at the worst cases:
    q·k with every entry −128 at D = 256 (2^22), and p·v at the largest
    Σ pq a softmax can give (each pq a round-up of p just over 1/254)
    against v = −128."""
    q = torch.full((1, 1, 1, 256), -128, dtype=torch.int8)
    k = torch.full((1, 4096, 1, 256), -128, dtype=torch.int8)
    acc = attention._int8_contract("bkgd,bskd->bkgs", q, k)
    assert acc.dtype == torch.float32
    assert torch.equal(acc, torch.full((1, 1, 1, 4096), 2.0 ** 22))
    # 253 slots at p = 0.501/127 (each rounds up to 1), the rest on one
    p = torch.full((1, 1, 1, 4096), 0.0)
    p[..., :253] = 0.501 / 127
    p[..., 253] = 1 - 253 * 0.501 / 127
    assert float(p.min()) >= 0 and abs(float(p.sum()) - 1) < 1e-6
    pq = torch.round(p * 127.0).clamp(0, 127).to(torch.int8)
    assert int(pq.to(torch.int32).sum()) == 253
    v = torch.full((1, 4096, 1, 256), -128, dtype=torch.int8)
    acc = attention._int8_contract("bkgs,bskd->bkgd", pq, v)
    want = torch.einsum("bkgs,bskd->bkgd", pq.long(), v.long())
    assert torch.equal(acc.long(), want)
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-128, 128, (4, 8, 3, 256))
                         .astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (4, 300, 8, 256))
                         .astype(np.int8))
    got = attention._int8_contract("bkgd,bskd->bkgs", a, b)
    assert torch.equal(got.long(), torch.einsum("bkgd,bskd->bkgs",
                                                a.long(), b.long()))


# -- the reduced engines ---------------------------------------------------

def _serve_both(jcfg, jp, cfg, tp):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 3)]
    lengths = (6, 4, 6, 5, 6)
    jreqs = [jengine.Request(uid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, lengths))]
    jdone = jengine.ServingEngine(jcfg, jp, slots=2, max_seq=32).run(
        list(jreqs))
    reqs = [engine.Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, lengths))]
    eng = engine.ServingEngine(cfg, tp, slots=2, max_seq=32, device="cpu")
    done = eng.run(list(reqs))
    return eng, done, jdone, reqs, jreqs


@pytest.mark.parametrize("mode", ["float", "w8"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_engine_tokens_equal_the_jax_engine(arch, mode):
    """The reduced model at 2 layers (f32 compute, as ``reduce_config``
    sets it), 2 slots and 5 requests, so slots are reused: greedy tokens
    equal the JAX ``ServingEngine``'s, with float weights and with w8
    weights and the int8 KV cache (each side's own per-layer quantization
    of the same f32 weights: the port's ``quantize_weights``, the
    reference's ``quantize_symmetric`` layer by layer)."""
    kw = dict(num_layers=2)
    if mode == "w8":
        kw.update(kv_cache_dtype="int8", kv_cache_scale=KV_SCALE)
    jcfg, cfg = _configs(arch, **kw)
    jspecs = jlm.param_specs(jcfg)
    jp = jcommon.materialize(jspecs, jax.random.PRNGKey(4))
    tp = _to_torch(jp)
    if mode == "w8":
        tp = quant.quantize_weights(tp, lm.param_specs(cfg))
        jp = _jax_per_layer_w8(jp, jspecs)
    eng, done, jdone, reqs, jreqs = _serve_both(jcfg, jp, cfg, tp)
    assert [r.uid for r in done] == [r.uid for r in jdone]
    for got, want in zip(reqs, jreqs):
        assert got.done and len(got.output) == want.max_new_tokens
        assert got.output == want.output, (got.uid, got.output, want.output)
    assert eng.active == [None, None]
    want_dt = torch.int8 if mode == "w8" else torch.float32
    assert eng.cache["blocks"]["b0"]["kv"].k.dtype == want_dt


# each layer's bf16 results may differ by one bf16 ulp (2^-7 relative at
# most) between the two frameworks, which round at different points (the
# reference's silu, for one, rounds its sigmoid before the product); over
# two layers that is 2^-6 of relative L2 at most unless the network
# amplifies it (as test_torch_lm.BF16_REL_L2)
BF16_REL_L2 = 2 * 2.0 ** -7


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("arch,mode", [
    *(pytest.param(a, "float", id=a) for a in LM_ARCHS),
    *(pytest.param(a, "w8", id=f"{a}-w8") for a in LM_ARCHS)])
def test_bf16_prefill_close_to_the_reference(arch, mode):
    """bf16 compute, the reduced model at 2 layers: the prefill's
    last-token logits (which give a request's first token) against the
    reference's; greedy tokens are not compared, since a near tie among
    bf16-rounded logits can flip an argmax.

    Float weights and a bf16 cache agree within ``BF16_REL_L2``.  w8
    weights with the int8 KV cache (each side's own per-layer
    quantization of the same f32 weights, as in
    ``test_engine_tokens_equal_the_jax_engine``) are held to the
    reference's own bf16 noise: no farther from the reference's bf16
    logits than those are from the reference's f32 logits of the same
    weights and prompt.  ``BF16_REL_L2`` cannot hold there, since
    ``w8_einsum`` rounds each activation to a step of amax/127: a
    one-ulp difference at a rounding point moves that int8 value by a
    whole step, several bf16 ulps, so the two frameworks' rounding
    differences come out about 2–3× larger (already at f32 compute one
    such flip moves the 5-token llama3.2-3b logits by 1.5%)."""
    kw = dict(num_layers=2, compute_dtype="bfloat16")
    if mode == "w8":
        kw.update(kv_cache_dtype="int8", kv_cache_scale=KV_SCALE)
    jcfg, cfg = _configs(arch, **kw)
    jspecs = jlm.param_specs(jcfg)
    jp = jcommon.materialize(jspecs, jax.random.PRNGKey(4))
    tp = _to_torch(jp)
    if mode == "w8":
        tp = quant.quantize_weights(tp, lm.param_specs(cfg))
        jp = _jax_per_layer_w8(jp, jspecs)
    tp = lm.compute_params(tp, cfg)
    want_dt = torch.int8 if mode == "w8" else torch.bfloat16
    rng = np.random.default_rng(0)
    for n in (5, 9, 12):
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        tokens = {"tokens": jnp.asarray(prompt)[None]}
        want, _ = jlm.prefill(jp, tokens, jcfg, cache_len=32)
        got, cache = lm.prefill(tp, {"tokens": torch.from_numpy(prompt)
                                     .long()[None]}, cfg, cache_len=32)
        assert cache["blocks"]["b0"]["kv"].k.dtype == want_dt
        got = got.double().numpy()
        assert np.isfinite(got).all()
        if mode == "float":
            limit = BF16_REL_L2
        else:
            want_f32, _ = jlm.prefill(jp, tokens, dataclasses.replace(
                jcfg, compute_dtype="float32"), cache_len=32)
            limit = _rel_l2(want, want_f32)
        assert _rel_l2(got, want) < limit, (n, limit)


def test_int8_pool_scatter_matches_the_reference():
    """The engine scatters a request's int8 prefill cache into the int8
    pool at its slot, as the reference does, dtype kept."""
    rng = np.random.default_rng(6)
    pool = rng.integers(-128, 128, (2, 3, 10, 2, 4)).astype(np.int8)
    one = rng.integers(-128, 128, (2, 1, 6, 2, 4)).astype(np.int8)
    want = jengine._scatter_slot(jnp.asarray(pool), jnp.asarray(one), 2)
    got = engine._scatter_slot(torch.from_numpy(pool.copy()),
                               torch.from_numpy(one), 2)
    assert got.dtype == torch.int8
    _equal(got, want)
