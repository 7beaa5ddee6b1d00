"""The port's LM layers and model against the JAX package on the CPU.

Each case feeds the same seeded numpy inputs, and the reference's own
``materialize``d weights carried across with
``convert.lm_params_to_torch``, to a JAX function and its port; f32
outputs agree within rtol = atol = 1e-4 (the two sum in another order)."""

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
from repro.layers import embedding as jemb
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.layers import rope as jrope
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.serving import serve_step as jserve
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.core import quantize as quant
from repro_torch.layers import attention, common, embedding, mlp, norms, rope
from repro_torch.models import blocks, lm
from repro_torch.serving import serve_step
from test_torch_cuda import bf16_gemm_bound

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(arch="llama3p2_3b", **kw):
    jcfg = dataclasses.replace(jbase.reduce_config(jbase.get_config(arch)),
                               **kw)
    cfg = dataclasses.replace(base.reduce_config(base.get_config(arch)), **kw)
    return jcfg, cfg


def _weights(jspecs, seed=0):
    """The reference's materialized weights, and the same as tensors."""
    jp = jcommon.materialize(jspecs, jax.random.PRNGKey(seed))
    return jp, convert.lm_params_to_torch(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- configs ---------------------------------------------------------------

ARCHS = ["llama3p2_3b", "llama3_8b", "yi_34b", "gemma_7b",
         "recurrentgemma_9b", "rwkv6_1p6b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    full, jfull = base.get_config(arch), jbase.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    red = base.reduce_config(full)
    assert dataclasses.asdict(red) == dataclasses.asdict(
        jbase.reduce_config(jfull))
    assert base.param_count(full) == jbase.param_count(jfull)
    assert base.param_count(red) == jbase.param_count(
        jbase.reduce_config(jfull))
    assert base.get_config(full.name) == full       # by its CLI alias


def test_unported_architectures_raise_naming_the_roadmap():
    for name in base.ARCH_NAMES:
        if name not in base.PORTED:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                base.get_config(name)
    with pytest.raises(KeyError, match="unknown architecture"):
        base.get_config("gpt-17")


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_the_reference(arch, kv):
    jcfg, cfg = _configs(arch, num_layers=3, kv_cache_dtype=kv)

    def flat(tree, is_leaf):
        return [(s.shape, s.axes, s.dtype, s.init, s.scale, s.fan_in_axes)
                for s in jax.tree.leaves(tree, is_leaf=is_leaf)]
    assert (flat(lm.param_specs(cfg), common.is_spec)
            == flat(jlm.param_specs(jcfg), jcommon.is_spec))
    assert (flat(lm.cache_specs(cfg, 3, 40), common.is_spec)
            == flat(jlm.cache_specs(jcfg, 3, 40), jcommon.is_spec))
    # the attention layers' K/V leaves (a recurrent block's state keeps its
    # own dtypes; rwkv6 has no K/V)
    kv_dt = {s.dtype for s in jax.tree.leaves(lm.cache_specs(cfg, 3, 40),
                                              is_leaf=common.is_spec)
             if s.axes[-1] == "qkv"}
    attends = any(k in ("attn", "local_attn") for k in cfg.layer_pattern)
    assert kv_dt == ({"int8" if kv == "int8" else "float32"} if attends
                     else set())


def test_materialize_follows_the_specs_on_a_generator():
    _, cfg = _configs(num_layers=2)
    specs = lm.param_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    p = common.materialize(specs, gen, device="cpu")
    leaves = list(zip(jax.tree.leaves(specs, is_leaf=common.is_spec),
                      jax.tree.leaves(p)))
    assert len(leaves) == 11          # embed, final norm, 9 per block
    for s, t in leaves:
        assert tuple(t.shape) == s.shape and t.dtype == torch.float32
    assert torch.equal(p["final_norm"]["scale"], torch.ones(64))
    wq = p["blocks"]["b0"]["attn"]["wq"]
    assert abs(float(wq.std()) - 64 ** -0.5) < 0.01     # fan-in scaled
    again = common.materialize(specs, torch.Generator().manual_seed(0),
                               device="cpu")
    assert torch.equal(again["embedding"]["embed"], p["embedding"]["embed"])
    bf = common.materialize(specs, gen, device="cpu",
                            dtype_override="bfloat16")
    assert bf["blocks"]["b0"]["mlp"]["wo"].dtype == torch.bfloat16


# -- layers ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "rmsnorm_offset", "layernorm"])
def test_norms(kind):
    jcfg, cfg = _configs(norm="layernorm" if kind == "layernorm"
                         else "rmsnorm",
                         rmsnorm_unit_offset=kind == "rmsnorm_offset")
    x = _normal(2, 5, 64, seed=1) * 3 + 1
    scale = _normal(64, seed=2)
    params = {"scale": scale, "bias": _normal(64, seed=3)}
    want = jnorms.apply_norm(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), jcfg)
    got = norms.apply_norm({k: torch.from_numpy(v) for k, v in
                            params.items()}, torch.from_numpy(x), cfg)
    _close(got, want)
    assert norms.norm_specs(cfg) == {
        k: common.ParamSpec(*dataclasses.astuple(v))
        for k, v in jnorms.norm_specs(jcfg).items()}


def test_rope_and_sinusoidal_positions():
    x = _normal(2, 7, 3, 16, seed=4)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    _close(rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           500_000.0),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0))
    _close(rope.rope_freqs(16, 1e4), jrope.rope_freqs(16, 1e4))
    _close(rope.sinusoidal_positions(torch.from_numpy(pos), 32),
           jrope.sinusoidal_positions(jnp.asarray(pos), 32))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(act):
    jcfg, cfg = _configs(mlp_act=act)
    jp, tp = _weights(jmlp.mlp_specs(jcfg))
    x = _normal(2, 5, 64, seed=5)
    _close(mlp.apply_mlp(tp, torch.from_numpy(x), cfg),
           jmlp.apply_mlp(jp, jnp.asarray(x), jcfg))


def test_dense_backends_and_dtypes():
    w = _normal(64, 48, seed=6)
    x = _normal(2, 3, 64, seed=7)
    want = jcommon.dense(jnp.asarray(w), jnp.asarray(x), "bsd,df->bsf",
                         compute_dtype=jnp.float32)
    for backend in ("xla", "pallas_ws"):
        got = common.dense(torch.from_numpy(w), torch.from_numpy(x),
                           "bsd,df->bsf", backend=backend,
                           compute_dtype="float32")
        assert got.dtype == torch.float32
        _close(got, want)
    y = common.dense(torch.from_numpy(w), torch.from_numpy(x),
                     "bsd,df->bsf", compute_dtype="bfloat16")
    assert y.dtype == torch.bfloat16       # the output in the compute dtype
    # bf16 through matmul_ws, as the reference routes it: both round f32
    # sums once, so they agree within one bf16 ulp of the larger magnitude
    # plus the f32 sums' rounding (bf16_gemm_bound)
    want = jcommon.dense(jnp.asarray(w), jnp.asarray(x), "bsd,df->bsf",
                         backend="pallas_ws", compute_dtype=jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    got = common.dense(torch.from_numpy(w), torch.from_numpy(x),
                       "bsd,df->bsf", backend="pallas_ws",
                       compute_dtype="bfloat16")
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 48)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    xb = torch.from_numpy(x).bfloat16().reshape(6, 64)
    bound = bf16_gemm_bound(xb, torch.from_numpy(w).bfloat16(), None,
                            got.reshape(6, 48), want.reshape(6, 48))
    assert bool(((got.float() - want).abs().reshape(6, 48) <= bound).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sub,xs,ws,bias", [
    ("bsd,dhe->bshe", (2, 3, 64), (64, 4, 16), False),
    ("bshe,hed->bsd", (2, 3, 4, 16), (4, 16, 64), False),
    ("bsd,df->bsf", (2, 3, 64), (64, 48), False),
    ("bsd,df->bsf", (2, 3, 64), (64, 48), True)])
def test_dense_w8_equals_the_reference(sub, xs, ws, bias, dtype):
    """A w8 weight (the reference's ``quantize_weights`` of it, carried
    across) runs the int8 GEMM on matmul_ws, whatever the backend, and the
    output equals the reference's bit for bit: the int32 sums are exact
    and the rescale is the same f32 operations in the same order."""
    w = _normal(*ws, seed=6)
    x = _normal(*xs, seed=7)
    b = _normal(ws[-1], seed=8) if bias else None
    jw = jquant.quantize_weights({"m": {"w": jnp.asarray(w)}})["m"]["w"]
    tw = convert.lm_params_to_torch(jax.tree.map(np.asarray, jw),
                                    device="cpu")
    assert tw["q"].dtype == torch.int8 and tw["s"].dtype == torch.float32
    want = jcommon.dense(jw, jnp.asarray(x), sub, compute_dtype=dtype,
                         bias=None if b is None else jnp.asarray(b))
    for backend in ("xla", "pallas_ws"):
        got = common.dense(tw, torch.from_numpy(x), sub, backend=backend,
                           compute_dtype=dtype,
                           bias=None if b is None else torch.from_numpy(b))
        # an f32 bias promotes a bf16 product to f32 in both
        assert str(got.dtype)[6:] == str(want.dtype)
        assert torch.equal(got.float(), torch.from_numpy(
            np.array(want.astype(jnp.float32))))


@pytest.mark.parametrize("tied", [True, False])
def test_embedding_and_logits(tied):
    jcfg, cfg = _configs(tie_embeddings=tied, embed_scale=not tied,
                         logit_softcap=0.0 if tied else 30.0)
    jp, tp = _weights(jemb.embedding_specs(jcfg))
    tokens = np.random.default_rng(8).integers(0, 512, (2, 6)).astype(
        np.int32)
    h = jemb.embed_tokens(jp, jnp.asarray(tokens), jcfg)
    got = embedding.embed_tokens(tp, torch.from_numpy(tokens).long(), cfg)
    _close(got, h)
    lg = embedding.logits(tp, got, cfg)
    assert lg.dtype == torch.float32
    _close(lg, jemb.logits(jp, h, jcfg))


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash"])
def test_attention_layer_all_three_impls(impl):
    jcfg, cfg = _configs(attn_impl=impl, attn_chunk=16)
    jp, tp = _weights(jattn.attention_specs(jcfg))
    x = _normal(2, 48, 64, seed=9)
    pos = np.broadcast_to(np.arange(48), (2, 48)).astype(np.int32)
    jy, (jk, jv) = jattn.attention_layer(jp, jnp.asarray(x), jcfg,
                                         positions=jnp.asarray(pos))
    y, (k, v) = attention.attention_layer(tp, torch.from_numpy(x), cfg,
                                          positions=torch.from_numpy(pos))
    _close(y, jy)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("window,q_offset,softcap", [(0, 0, 0.0),
                                                     (24, 0, 0.0),
                                                     (0, 16, 20.0),
                                                     (16, 8, 0.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_and_dense_attention(window, q_offset, softcap, causal):
    q = _normal(2, 32, 3, 8, seed=10)
    k, v = _normal(2, 48, 3, 8, seed=11), _normal(2, 48, 3, 8, seed=12)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              softcap=softcap)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(attention.dense_attention(tq, tk, tv, **kw),
           jattn.dense_attention(jq, jk, jv, **kw))
    _close(attention.chunked_attention(tq, tk, tv, chunk=8, **kw),
           jattn.chunked_attention(jq, jk, jv, chunk=8, **kw))


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_on_a_ring_cache(window):
    """A ring of 8 slots (window 8) filled past capacity, and a full
    cache, with rows at different positions (the slot arithmetic floors
    on negative operands)."""
    jcfg, cfg = _configs()
    jp, tp = _weights(jattn.attention_specs(jcfg))
    s_cache = 8 if window else 24
    kc = _normal(3, s_cache, 2, 16, seed=13)
    vc = _normal(3, s_cache, 2, 16, seed=14)
    x = _normal(3, 1, 64, seed=15)
    pos = np.array([3, 11, 21], np.int32)
    jy, jcache = jattn.decode_attention_layer(
        jp, jnp.asarray(x), jcfg, cache=jattn.KVCache(jnp.asarray(kc),
                                                      jnp.asarray(vc)),
        pos=jnp.asarray(pos), window=window)
    cache = attention.KVCache(torch.from_numpy(kc.copy()),
                              torch.from_numpy(vc.copy()))
    y, out = attention.decode_attention_layer(
        tp, torch.from_numpy(x), cfg, cache=cache,
        pos=torch.from_numpy(pos).long(), window=window)
    _close(y, jy)
    assert out.k is cache.k                 # written in place
    _close(out.k, jcache.k)
    _close(out.v, jcache.v)


@pytest.mark.parametrize("seq_len,window,cache_len", [(5, 0, 12), (5, 8, 12),
                                                       (13, 8, 12),
                                                       (12, 0, None)])
def test_prime_cache_layout(seq_len, window, cache_len):
    t = _normal(2, seq_len, 2, 4, seed=16)
    _close(blocks._prime_cache(torch.from_numpy(t), seq_len, window,
                               cache_len),
           jblocks._prime_cache(jnp.asarray(t), seq_len, window, cache_len))


def test_unported_blocks_raise():
    """MoE feed-forward and encoder-decoder models wait on later slices;
    the recurrent kinds build."""
    jcfg, cfg = _configs()
    for kind in ("rglru", "rwkv6"):
        assert blocks.block_specs(cfg, kind)
    moe = dataclasses.replace(cfg, moe=base.MoEConfig(8, 2, 64))
    for kind in ("attn", "rglru"):
        with pytest.raises(NotImplementedError, match="MoE"):
            blocks.block_specs(moe, kind)
    with pytest.raises(NotImplementedError, match="MoE"):
        lm.param_specs(moe)
    with pytest.raises(NotImplementedError, match="encdec"):
        lm.param_specs(dataclasses.replace(cfg, kind="encdec"))


@pytest.mark.parametrize("kind,window", [("attn", 0), ("local_attn", 8)])
def test_int8_prefill_cache_equals_the_reference(kind, window):
    """``_to_cache`` / ``_prime_cache`` on an int8 cache: the prefill K/V
    on the ``kv_cache_scale`` grid, laid out in the decode slots (a ring
    rolled past its capacity), equal to the reference's."""
    jcfg, cfg = _configs(kv_cache_dtype="int8", kv_cache_scale=0.25,
                         attention_window=window)
    jp, tp = _weights(jblocks.block_specs(jcfg, kind))
    x = _normal(2, 13, 64, seed=20)
    pos = np.broadcast_to(np.arange(13), (2, 13))
    _, _, jc = jblocks.apply_block_seq(jp, jnp.asarray(x), jcfg, kind,
                                       positions=jnp.asarray(pos),
                                       want_cache=True, cache_len=16)
    _, _, tc = blocks.apply_block_seq(tp, torch.from_numpy(x), cfg, kind,
                                      positions=torch.from_numpy(
                                          pos.copy()).long(),
                                      want_cache=True, cache_len=16)
    for g in ("k", "v"):
        got, want = getattr(tc["kv"], g), getattr(jc["kv"], g)
        assert got.dtype == torch.int8 and want.dtype == jnp.int8
        assert got.shape == (2, 8 if window else 16, 2, 16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t = _normal(2, 5, 2, 4, seed=21) * 40     # saturates at ±128 / 127
    got = blocks._to_cache(torch.from_numpy(t), cfg)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.clip(
        np.round(t / 0.25), -128, 127).astype(np.int8))


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_prefill_and_decode_step_two_layers(impl):
    jcfg, cfg = _configs(num_layers=2, attn_impl=impl)
    jp, tp = _weights(jlm.param_specs(jcfg))
    tokens = np.random.default_rng(17).integers(0, 512, (2, 40)).astype(
        np.int32)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                             cache_len=64)
    tl, cache = lm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()},
                           cfg, cache_len=64)
    _close(tl, jl)
    for g in ("k", "v"):
        _close(getattr(cache["blocks"]["b0"]["kv"], g),
               getattr(jcache["blocks"]["b0"]["kv"], g))
    tok, pos = np.array([5, 300], np.int32), np.array([40, 40], np.int32)
    for _ in range(3):
        jl, jcache = jlm.decode_step(jp, jcfg, token=jnp.asarray(tok),
                                     pos=jnp.asarray(pos), cache=jcache)
        tl, cache = lm.decode_step(tp, cfg, token=torch.from_numpy(tok).long(),
                                   pos=torch.from_numpy(pos).long(),
                                   cache=cache)
        _close(tl, jl)
        tok, pos = np.array(jserve.greedy_sample(jl)), pos + 1
        assert np.array_equal(serve_step.greedy_sample(tl).numpy(), tok)


# each layer's bf16 results may differ by one bf16 ulp (2^-7 relative at
# most) between the two frameworks; over two layers that is 2^-6 of
# relative L2 at most, unless the network amplifies it (chip_smoke.py's
# phase 6 bounds the full model's logits the same way)
BF16_REL_L2 = 2 * 2.0 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_pallas_ws_two_layers(dtype):
    """The reduced llama3.2-3b with gemm_backend='pallas_ws': the MLP's
    GEMMs run matmul_ws (its plain version on the CPU) and the prefill
    logits match the JAX model's, whose GEMMs run the Pallas kernel."""
    jcfg, cfg = _configs(num_layers=2, gemm_backend="pallas_ws",
                         compute_dtype=dtype)
    jp, tp = _weights(jlm.param_specs(jcfg))
    tokens = np.random.default_rng(19).integers(0, 512, (2, 24)).astype(
        np.int32)
    jl, _ = jlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                        cache_len=32)
    tl, _ = lm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()}, cfg,
                       cache_len=32)
    if dtype == "float32":
        _close(tl, jl)
        return
    got, want = tl.double().numpy(), np.asarray(jl, np.float64)
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL_L2


def test_flash_through_the_model_llama3_8b():
    """cfg.attn_impl='flash' reproduces the reference end to end."""
    jcfg, cfg = _configs("llama3_8b", attn_impl="flash")
    jp, tp = _weights(jlm.param_specs(jcfg))
    tokens = np.random.default_rng(18).integers(0, 512, (2, 32)).astype(
        np.int32)
    want, _ = jlm.forward_train(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    got, aux = lm.forward_train(tp, {"tokens": torch.from_numpy(tokens)
                                     .long()}, cfg)
    assert float(aux) == 0.0
    _close(got, want)
    chunked, _ = lm.forward_train(tp, {"tokens": torch.from_numpy(tokens)
                                       .long()},
                                  dataclasses.replace(cfg,
                                                      attn_impl="chunked"))
    _close(got, chunked)


def test_compute_params_casts_matmul_weights_only():
    jcfg, cfg = _configs(num_layers=2)
    _, tp = _weights(jlm.param_specs(jcfg))
    bf = lm.compute_params(tp, dataclasses.replace(cfg,
                                                   compute_dtype="bfloat16"))
    assert bf["embedding"]["embed"].dtype == torch.bfloat16
    assert bf["blocks"]["b0"]["attn"]["wo"].dtype == torch.bfloat16
    assert bf["blocks"]["b0"]["mlp"]["wi_up"].dtype == torch.bfloat16
    assert bf["blocks"]["b0"]["norm1"]["scale"].dtype == torch.float32
    assert bf["final_norm"]["scale"].dtype == torch.float32
    assert lm.compute_params(tp, cfg)["embedding"]["embed"] is \
        tp["embedding"]["embed"]


def test_compute_params_leaves_w8_weights_untouched():
    _, cfg = _configs(num_layers=2)
    tp = common.materialize(lm.param_specs(cfg), torch.Generator()
                            .manual_seed(0), device="cpu")
    q = quant.quantize_weights(tp, lm.param_specs(cfg))
    bf = lm.compute_params(q, dataclasses.replace(cfg,
                                                  compute_dtype="bfloat16"))
    wq = bf["blocks"]["b0"]["attn"]["wq"]
    assert wq["q"] is q["blocks"]["b0"]["attn"]["wq"]["q"]
    assert wq["s"] is q["blocks"]["b0"]["attn"]["wq"]["s"]
    assert wq["q"].dtype == torch.int8 and wq["s"].dtype == torch.float32
    assert bf["embedding"]["embed"].dtype == torch.bfloat16   # excluded
    assert bf["blocks"]["b0"]["norm1"]["scale"].dtype == torch.float32


def test_index_slices_the_per_layer_scale_with_its_values():
    _, cfg = _configs(num_layers=3)
    tp = common.materialize(lm.param_specs(cfg), torch.Generator()
                            .manual_seed(0), device="cpu")
    q = quant.quantize_weights(tp, lm.param_specs(cfg))
    for g in range(3):
        wo = lm._index(q["blocks"], g)["b0"]["mlp"]["wo"]
        full = q["blocks"]["b0"]["mlp"]["wo"]
        assert wo["s"].shape == (1, 64)
        assert torch.equal(wo["q"], full["q"][g])
        assert torch.equal(wo["s"], full["s"][g])
    cache = common.tree_map(
        lambda s: torch.zeros(s.shape, dtype=common.torch_dtype(s.dtype)),
        lm.cache_specs(dataclasses.replace(cfg, kv_cache_dtype="int8"), 2,
                       8))
    one = lm._index(cache["blocks"], 1)["b0"]["kv"]
    assert one.k.dtype == torch.int8 and one.k.shape == (2, 8, 2, 16)
    one.k[0, 0, 0, 0] = 5                       # a view into the stack
    assert int(cache["blocks"]["b0"]["kv"].k[1, 0, 0, 0, 0]) == 5


def test_sampling():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 5.0, 5.0]])
    assert serve_step.greedy_sample(logits).tolist() == [1, 0]
    assert np.asarray(jserve.greedy_sample(jnp.asarray(
        logits.numpy()))).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(serve_step.sample(logits, gen, temperature=0.0),
                       serve_step.greedy_sample(logits))
    peaked = torch.tensor([[0.0, 80.0, 0.0]] * 4)
    assert serve_step.sample(peaked, gen).tolist() == [1, 1, 1, 1]
    prefill = serve_step.make_prefill_step(_configs(num_layers=1)[1])
    decode = serve_step.make_decode_step(_configs(num_layers=1)[1])
    assert callable(prefill) and callable(decode)
