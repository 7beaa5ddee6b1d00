"""The port's sharding rules against the reference's, spec for spec.

``param_rules`` / ``act_rules`` (every mode, ``seq_shard``), ``resolve_pspec``,
``_fits`` and ``spec_shardings`` over every config's param, optimizer and
cache spec trees on the debug (2, 4), production (16, 16) and multi-pod
(2, 16, 16) meshes, the reference's side on a ``jax.sharding.AbstractMesh``
and the port's on its own ``AbstractMesh`` (no ranks behind either).  Also
the DTensor placements of tuple entries, and ``lconstraint`` / ``dense``
doing nothing without rules or without a mesh.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import ARCH_NAMES as J_ARCH_NAMES
from repro.configs.base import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.layers import common as jcommon
from repro.models import lm as jlm
from repro.train.train_step import init_state_specs as j_init_state_specs
from repro_torch.configs.base import ARCH_NAMES, get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.layers import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.train.train_step import init_state_specs

MESHES = {"debug": ((2, 4), ("data", "model")),
          "production": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
PLANS = [(fsdp, mode, seq) for fsdp in (False, True)
         for mode in ("train", "prefill", "decode") for seq in (False, True)]
# a decode cache of 4 slots × 4096 positions, as the serving cells hold
CACHE = (4, 4096)


def _meshes(name):
    sizes, names = MESHES[name]
    return JAbstractMesh(sizes, names), tsh.AbstractMesh(sizes, names)


def _jspecs(tree):
    return [tuple(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JNamedSharding))]


def _tspecs(tree):
    out = []
    tcommon.tree_map(lambda s: out.append(tuple(s.spec)), tree)
    return out


def test_configs_match():
    assert tuple(ARCH_NAMES) == tuple(J_ARCH_NAMES)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_equal_the_reference(mesh):
    jm, tm = _meshes(mesh)
    for fsdp in (False, True):
        assert tsh.param_rules(tm, fsdp) == jsh.param_rules(jm, fsdp)
    for mode, seq in itertools.product(("train", "prefill", "decode"),
                                       (False, True)):
        assert tsh.act_rules(tm, mode, seq) == jsh.act_rules(jm, mode, seq)
    assert tsh._dp_axes(tm) == jsh._dp_axes(jm)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_shardings_equal_the_reference(arch, mesh):
    """Param, opt and cache spec trees, every plan: the same spec leaf for
    leaf (the cache under the reference's cache_specs, decode-sized)."""
    jm, tm = _meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jstate, tstate = j_init_state_specs(jcfg), init_state_specs(cfg)
    jcache = jlm.cache_specs(jcfg, *CACHE)
    tcache = tlm.cache_specs(cfg, *CACHE)
    n = 0
    for fsdp, mode, seq in PLANS:
        jplan = jsh.ShardingPlan(mesh=jm, fsdp=fsdp, mode=mode,
                                 seq_shard=seq)
        tplan = tsh.ShardingPlan(mesh=tm, fsdp=fsdp, mode=mode,
                                 seq_shard=seq)
        for jt, tt in ((jstate["params"], tstate["params"]),
                       (jstate["opt"], tstate["opt"])):
            want = _jspecs(jplan.param_shardings(jt))
            got = _tspecs(tplan.param_shardings(tt))
            assert got == want, (arch, mesh, fsdp, mode, seq)
            n += len(got)
        want = _jspecs(jplan.cache_shardings(jcache))
        got = _tspecs(tplan.cache_shardings(tcache))
        assert got == want, (arch, mesh, mode, "cache")
        n += len(got)
    assert n > 0


def test_resolve_pspec_and_fits_equal_the_reference():
    """Every logical-axis tuple of up to three names drawn from the
    glossary, under every rule set, and ``_fits`` on shapes that do and
    do not divide."""
    jm, tm = _meshes("multi_pod")
    names = (None, "batch", "embed", "heads", "kv_heads", "qkv", "mlp",
             "vocab", "experts", "cache_seq", "seq_r", "stack")
    rule_sets = [jsh.param_rules(jm, f) for f in (False, True)] + [
        jsh.act_rules(jm, m, s) for m in ("train", "decode")
        for s in (False, True)]
    for rules in rule_sets:
        for axes in itertools.product(names, repeat=3):
            want = jcommon.resolve_pspec(axes, rules)
            got = tcommon.resolve_pspec(axes, rules)
            assert tuple(got) == tuple(want), axes
            for shape in ((64, 48, 32), (6, 5, 32), (2, 32, 3)):
                assert tuple(tsh._fits(shape, got, tm)) == tuple(
                    jsh._fits(shape, want, jm)), (axes, shape)


def test_named_fallback_and_conflict():
    """yi-34b's 56 heads do not divide model=16, so its q / o projections
    shard head_dim (``_FALLBACKS``); the MoE experts [experts, embed, mlp]
    give ``model`` to experts, first come, and leave mlp unsharded."""
    _, tm = _meshes("production")
    plan = tsh.ShardingPlan(mesh=tm, fsdp=True, mode="train")
    yi = plan.param_shardings(tlm.param_specs(get_config("yi-34b")))
    attn = yi["blocks"]["b0"]["attn"]
    assert tuple(attn["wq"].spec) == (None, "data", None, "model")
    assert tuple(attn["wo"].spec) == (None, None, "model", "data")
    moe = plan.param_shardings(tlm.param_specs(
        get_config("deepseek-moe-16b")))["blocks"]["b0"]["moe"]
    assert tuple(moe["wi_gate"].spec) == (None, "model", "data", None)


def test_placements_of_tuple_entries():
    _, tm = _meshes("multi_pod")
    s = tsh.NamedSharding(tm, tsh.P(("pod", "data"), None, "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    s = tsh.NamedSharding(tm, tsh.P(None, "data"))
    assert s.placements == (Replicate(), Shard(1), Replicate())
    assert tsh.replicated(tm).placements == (Replicate(),) * 3
    assert tsh.batch_sharding(tm, 3).placements == (Shard(0), Shard(0),
                                                    Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        tsh.NamedSharding(tm, tsh.P(("data", "pod"))).placements


def test_input_shardings_drop_what_does_not_divide():
    jm, tm = _meshes("debug")
    tree = {"tokens": torch.zeros((4, 32), dtype=torch.int32),
            "odd": torch.zeros((3, 5))}
    got = tsh.input_shardings(tree, tm)
    want = jsh.input_shardings(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
         for k, v in tree.items()}, jm)
    for k in tree:
        assert tuple(got[k].spec) == tuple(want[k].spec), k


def test_lconstraint_is_a_no_op_without_rules_or_mesh():
    x = torch.randn(4, 8)
    assert tcommon.lconstraint(x, ("batch", "embed")) is x
    _, tm = _meshes("debug")
    rules = tsh.act_rules(tm, "train")
    with tcommon.activate_rules(rules) as r:
        assert r.rules is rules and tcommon._ACTIVE_RULES is rules
        # rules but no mesh: as the single-device path
        assert tcommon.lconstraint(x, ("batch", "embed")) is x
        w = torch.randn(8, 3)
        assert torch.equal(tcommon.dense(w, x, "bd,dk->bk",
                                         compute_dtype="float32"),
                           torch.einsum("bd,dk->bk", x, w))
    assert tcommon._ACTIVE_RULES is None
    with tcommon.activate_rules(None):
        assert tcommon.lconstraint(x, ("batch",)) is x
    assert tcommon.active_mesh() is None


def test_contract_plan_roles():
    """The sharding rule of a two-operand contraction, mesh dim by mesh
    dim: M, N, K (a Partial sum) and a shared batch letter."""
    from torch.distributed.tensor import Partial
    plan = tsh._contract_plan
    r = Replicate()
    m = plan("mk,kn->mn", [Shard(0)], [Shard(0)])[0]
    assert m == (Shard(0), r, Shard(0), Shard(0), Partial())
    n = plan("mk,kn->mn", [r], [Shard(1)])[0]
    assert n == (r, Shard(1), Shard(1), Partial(), Shard(1))
    k = plan("mk,kn->mn", [Shard(1)], [r])[0]
    assert k == (Shard(1), Shard(0), Partial(), Shard(1), Shard(0))
    b = plan("bqhd,bkhd->bhqk", [Shard(2)], [Shard(2)])[0]
    assert b == (Shard(2), Shard(2), Shard(1), Shard(2), Shard(2))
    assert plan("mk,kn->mn", [Partial()], [r])[0] == (r,) * 5
