"""The roofline slice against the reference: the dry run's shapes and the
configs' analytic accounting, the report and its ring model, the leftovers
of the conv stack (``plan_banks``, ``network_cycles``), and the
dispatcher's count (``roofline.counts``) of the reduced steps against the
HLO parser's count (``repro.roofline.hlo``) of the same steps, each
compiled once under one ``jax.jit``.

The counts differ in one place, by a stated formula: the reference's
chunked attention skips the KV chunks above the diagonal with a
``lax.cond`` at run time (``repro/layers/attention.py:96``), and
``hlo._account`` counts every branch of a conditional; the port skips
those chunks in its Python loop and counts what runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import banking as jbanking
from repro.core import perfmodel as jperf
from repro.layers import common as jcommon
from repro.models import lm as jlm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import opt_state_specs as j_opt_specs
from repro.roofline import analysis as janalysis
from repro.roofline import hlo
from repro.serving import serve_step as jserve
from repro.train import train_step as jtrain
from repro_torch.configs import base
from repro_torch.core import banking, perfmodel
from repro_torch.layers import common
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, opt_state_specs
from repro_torch.roofline import analysis, counts
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
from repro_torch.train import train_step as ts

B, S = 2, 128          # the reduced steps' batch and length


@pytest.mark.parametrize("arch", base.ARCH_NAMES)
def test_shapes_and_config_accounting_match(arch):
    """``SHAPES``, ``shape_applicable`` (the verdict, and the reason up to
    its last clause, which names the reference's design note),
    ``active_param_count`` and ``config_summary``."""
    assert base.ARCH_NAMES == jbase.ARCH_NAMES
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    for name in base.SHAPES:
        ok, why = base.shape_applicable(cfg, base.SHAPES[name])
        jok, jwhy = jbase.shape_applicable(jcfg, jbase.SHAPES[name])
        assert ok == jok
        assert why.rsplit(";", 1)[0] == jwhy.rsplit(";", 1)[0]
    assert base.active_param_count(cfg) == jbase.active_param_count(jcfg)
    assert base.config_summary(cfg) == jbase.config_summary(jcfg)
    assert cfg.sub_quadratic == jcfg.sub_quadratic


@pytest.mark.parametrize("arch", base.ARCH_NAMES)
def test_input_specs_and_spec_totals_match(arch):
    """``input_specs`` keys, shapes and dtypes at every shape, and
    ``param_bytes`` / ``param_count_tree`` of the full config's param,
    AdamW and decode-cache specs; ``shape_structs`` holds no storage."""
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    for name in base.SHAPES:
        got = lm.input_specs(cfg, base.SHAPES[name])
        want = jlm.input_specs(jcfg, jbase.SHAPES[name])
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).removeprefix("torch.") == \
                want[k].dtype.name
    for tree, jtree in (
            (lm.param_specs(cfg), jlm.param_specs(jcfg)),
            (opt_state_specs(lm.param_specs(cfg)),
             j_opt_specs(jlm.param_specs(jcfg))),
            (lm.cache_specs(cfg, 4, 4096), jlm.cache_specs(jcfg, 4, 4096))):
        assert common.param_bytes(tree) == jcommon.param_bytes(jtree)
        assert common.param_count_tree(tree) == \
            jcommon.param_count_tree(jtree)
    structs = common.shape_structs(lm.param_specs(cfg),
                                   dtype_override="bfloat16")
    leaves = []
    common.tree_map(leaves.append, structs)
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in leaves)


@pytest.mark.parametrize("arch", base.ARCH_NAMES)
def test_model_flops_match(arch):
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    for name in base.SHAPES:
        assert analysis.model_flops(cfg, base.SHAPES[name]) == \
            janalysis.model_flops(jcfg, jbase.SHAPES[name])


def test_build_report_on_the_same_costs():
    """Given the reference's costs and its ``V5E`` peaks the report is the
    reference's field for field; against ``H100`` with bf16 FLOPs alone
    the terms are the same formula at the H100's rates."""
    costs = hlo.ModuleCosts(flops=3.7e15, traffic=4.1e11, coll_wire=2.9e9)
    for arch, shape in (("llama3p2_3b", "train_4k"),
                        ("deepseek_moe_16b", "prefill_32k"),
                        ("rwkv6_1p6b", "long_500k")):
        got = analysis.build_report(
            arch, shape, "single", 256, costs, base.get_config(arch),
            base.SHAPES[shape], xla_flops=1.0, peaks=janalysis.V5E)
        want = janalysis.build_report(
            arch, shape, "single", 256, costs, jbase.get_config(arch),
            jbase.SHAPES[shape], xla_flops=1.0)
        assert got.as_dict() == want.as_dict()
    mine = counts.ModuleCosts(flops=3.7e15, traffic=4.1e11, coll_wire=2.9e9)
    mine.flops_by_dtype["bfloat16"] = 3.7e15
    t = analysis.terms(mine)
    assert t == {"compute": 3.7e15 / 989e12, "memory": 4.1e11 / 3.35e12,
                 "collective": 2.9e9 / 50e9}
    mine.coll_wire_node = 2.9e9          # every group inside one node
    mine.flops_by_dtype["float32"] = 6.7e12
    t = analysis.terms(mine)
    assert t["collective"] == 2.9e9 / 450e9
    assert t["compute"] == 3.7e15 / 989e12 + 6.7e12 / 67e12


def test_wire_bytes_match():
    for kind in hlo.COLLECTIVES + ("broadcast",):
        for group in (1, 2, 4, 16, 256):
            for size in (0.0, 1.0, 3072.0 * 8192 * 2):
                assert counts._wire_bytes(kind, size, group) == \
                    hlo._wire_bytes(kind, size, group)


# ---------------------------------------------------------------------------
# tests/test_hlo_parser.py's cases, on the dispatcher
# ---------------------------------------------------------------------------


def _jit_flops(fn, *shapes):
    compiled = jax.jit(fn).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                                   for s in shapes)).compile()
    return hlo.analyze(compiled.as_text()).flops


def test_single_dot_flops_exact():
    m, k, n = 64, 128, 32
    _, c = counts.analyze(lambda a, b: a @ b, torch.ones(m, k),
                          torch.ones(k, n))
    assert c.flops == 2 * m * k * n == _jit_flops(lambda a, b: a @ b,
                                                  (m, k), (k, n))
    assert c.flops_by_dtype == {"float32": 2 * m * k * n}
    assert c.traffic == 4 * (m * k + k * n + m * n)
    assert c.op_counts == {"aten.mm": 1}


def test_loop_of_n_counts_n_times():
    """A loop of L matmuls counts L× the body (the reference needs the
    while loop's trip count for that; eager execution runs every
    iteration)."""
    L, d = 7, 32

    def f(w, x):
        for i in range(L):
            x = torch.tanh(x @ w[i])
        return x

    def jf(w, x):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        return jax.lax.scan(body, x, w)[0]

    _, c = counts.analyze(f, torch.ones(L, d, d), torch.ones(4, d))
    assert c.flops == L * 2 * 4 * d * d == _jit_flops(jf, (L, d, d), (4, d))
    assert c.transcendentals == L * 4 * d


def test_nested_loops_multiply():
    Lo, Li, d = 3, 5, 16

    def f(w, x):
        for _ in range(Lo):
            for _ in range(Li):
                x = torch.tanh(x @ w)
        return x

    def jf(w, x):
        def outer(c, _):
            def inner(ci, _):
                return jnp.tanh(ci @ w), None
            return jax.lax.scan(inner, c, None, length=Li)[0], None
        return jax.lax.scan(outer, x, None, length=Lo)[0]

    _, c = counts.analyze(f, torch.ones(d, d), torch.ones(2, d))
    assert c.flops == Lo * Li * 2 * 2 * d * d == _jit_flops(jf, (d, d),
                                                            (2, d))


# ---------------------------------------------------------------------------
# the reduced steps: dispatcher count against the HLO count
# ---------------------------------------------------------------------------


def _reference_flops(arch: str, kind: str) -> float:
    """``hlo.analyze`` of the reference's reduced step, compiled once."""
    c = jbase.reduce_config(jbase.get_config(arch))
    sds, i32 = jax.ShapeDtypeStruct, jnp.int32
    pspecs = jlm.param_specs(c)
    if kind == "prefill":
        fn = jserve.make_prefill_step(c)
        args = (jcommon.shape_structs(pspecs), {"tokens": sds((B, S), i32)})
    elif kind == "decode":
        fn = jserve.make_decode_step(c)
        args = (jcommon.shape_structs(pspecs),
                jcommon.shape_structs(jlm.cache_specs(c, B, S)),
                sds((B,), i32), sds((B,), i32))
    else:
        fn = jtrain.make_train_step(c, JAdamWConfig())
        state = {"params": jcommon.shape_structs(pspecs),
                 "opt": jcommon.shape_structs(j_opt_specs(pspecs)),
                 "step": sds((), i32)}
        args = (state, {"tokens": sds((B, S), i32),
                        "labels": sds((B, S), i32)})
    return hlo.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _port_step(arch: str, kind: str, backend: str = "xla"):
    """(step, args) of the port's reduced step on CPU tensors."""
    c = dataclasses.replace(base.reduce_config(base.get_config(arch)),
                            gemm_backend=backend)
    gen = torch.Generator().manual_seed(0)
    params = common.materialize(lm.param_specs(c), gen, device="cpu")
    if kind == "prefill":
        return torch.no_grad()(make_prefill_step(c)), (
            params, {"tokens": torch.zeros((B, S), dtype=torch.int32)})
    if kind == "decode":
        cache = common.materialize(lm.cache_specs(c, B, S), gen,
                                   device="cpu")
        return torch.no_grad()(make_decode_step(c)), (
            params, cache, torch.zeros(B, dtype=torch.int32),
            torch.full((B,), S - 1, dtype=torch.int32))
    state = {"params": params,
             "opt": common.materialize(ts.init_state_specs(c)["opt"], gen,
                                       device="cpu"),
             "step": torch.zeros((), dtype=torch.int32)}
    return ts.make_train_step(c, AdamWConfig()), (
        state, {k: torch.zeros((B, S), dtype=torch.int32)
                for k in ("tokens", "labels")})


def _skipped_pair_flops(arch: str) -> int:
    """The FLOPs of the chunk pairs wholly above the diagonal, forward:
    4·B·H·dh·c² each, n(n-1)/2 of them for n chunks."""
    c = base.reduce_config(base.get_config(arch))
    n = S // c.attn_chunk
    return n * (n - 1) // 2 * 4 * B * c.num_heads * c.head_dim \
        * c.attn_chunk ** 2


@pytest.mark.parametrize("arch,kind,skipped", [
    ("rwkv6_1p6b", "prefill", 0), ("rwkv6_1p6b", "decode", 0),
    ("llama3p2_3b", "decode", 0),
    # the 6 of 16 chunk pairs above the diagonal, forward once
    ("llama3p2_3b", "prefill", 1),
    # and in the train step forward once, backward twice (dq and dk of
    # the scores, dp and dv of p·v)
    ("llama3p2_3b", "train", 3)])
def test_reduced_step_count_matches_the_hlo_count(arch, kind, skipped):
    step, args = _port_step(arch, kind)
    _, c = counts.analyze(step, *args)
    gap = skipped * _skipped_pair_flops(arch)
    assert c.flops == _reference_flops(arch, kind) - gap
    if (arch, kind) == ("llama3p2_3b", "prefill"):
        assert gap == 4_718_592 and c.flops == 28_966_912
    assert c.flops_by_dtype == {"float32": c.flops}


def test_fake_and_pallas_ws_counts_equal_the_eager_count():
    """The reduced llama3.2-3b prefill counts the same FLOPs on fake
    tensors as on real ones, and with the MLP on ``matmul_ws`` (one
    ``repro_torch::matmul_ws`` op a GEMM, its own formula) as on
    ``torch.einsum``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    step, args = _port_step("llama3p2_3b", "prefill")
    want = counts.analyze(step, *args)[1]
    ws_step, ws_args = _port_step("llama3p2_3b", "prefill", "pallas_ws")
    ws = counts.analyze(ws_step, *ws_args)[1]
    assert ws.flops == want.flops
    layers = base.reduce_config(base.get_config("llama3p2_3b")).num_layers
    assert ws.op_counts["repro_torch.matmul_ws"] == 3 * layers
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = [common.tree_map(mode.from_tensor, a) for a in args]
        fake = counts.analyze(step, *fake_args)[1]
    assert fake.as_dict() == want.as_dict()


# ---------------------------------------------------------------------------
# the conv stack's leftovers
# ---------------------------------------------------------------------------


def test_plan_banks_matches_the_reference():
    """``plan_banks`` field for field on a grid of layers and budgets
    (passed to both: the defaults differ, the card's shared memory
    against the v5e's VMEM)."""
    n = 0
    for (h, w), (c, k), kh, stride, pad, in_b, out_b, budget in [
            (hw, ck, kh, s, p, ib, ob, b)
            for hw in ((8, 8), (28, 28), (224, 224), (13, 17))
            for ck in ((4, 4), (8, 16), (64, 64), (256, 512))
            for kh in (1, 3, 5) for s in (1, 2)
            for p in ("VALID", "SAME") for ib in (1, 4)
            for ob in (None, 1) for b in (banking.SMEM_BYTES, 16 << 20)]:
        got = banking.plan_banks(h, w, c, k, kh, kh, in_bytes=in_b,
                                 out_bytes=out_b, stride=stride, padding=pad,
                                 vmem_budget=budget)
        want = jbanking.plan_banks(h, w, c, k, kh, kh, in_bytes=in_b,
                                   out_bytes=out_b, stride=stride,
                                   padding=pad, vmem_budget=budget)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.working_set_bytes == want.working_set_bytes
        assert got.fits_smem == want.fits_vmem
        n += 1
    assert n == 4 * 4 * 3 * 2 * 2 * 2 * 2 * 2
    assert banking.plan_banks(28, 28, 64, 64).budget == banking.SMEM_BYTES
    with pytest.raises(ValueError, match="banks"):
        banking.plan_banks(8, 8, 6, 8)


def test_network_cycles_match():
    rng = np.random.default_rng(0)
    for _ in range(20):
        psums = [int(p) for p in rng.integers(0, 10 ** 7, size=6)] + [0]
        for cores in (1, 4, 20):
            cfg = perfmodel.IPCoreConfig(ip_cores=cores)
            jcfg = jperf.IPCoreConfig(ip_cores=cores)
            assert perfmodel.network_cycles(psums, cfg) == \
                jperf.network_cycles(psums, jcfg)
