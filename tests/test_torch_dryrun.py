"""The dry run (``repro_torch.launch.dryrun``) on fake tensors over a fake
process group: the per-rank argument bytes of a cell against the
reference's ``NamedSharding(AbstractMesh).shard_shape``s, the layer-group
extrapolation against a run at full depth, and the launcher's cell JSON.

The reference's own dry run fails under jax 0.9 in every cell (its
``lconstraint`` meets explicit mesh axes: ROADMAP C), so it is held piece
by piece: the shard shapes here, the counts in ``test_torch_roofline.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import base as jbase
from repro.distributed import sharding as jsh
from repro.layers import common as jcommon
from repro.models import lm as jlm
from repro.optim.adamw import opt_state_specs as j_opt_specs
from repro_torch.configs.base import ShapeConfig, get_config, reduce_config
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
TINY_TRAIN = ShapeConfig("tiny_train", 64, 8, "train")


@pytest.fixture(scope="module")
def mesh():
    """A (data=2, model=4) CPU mesh on a fake process group of 8 ranks,
    torn down after the module."""
    from torch.distributed.device_mesh import DeviceMesh
    dryrun.fake_world(8)
    yield DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                     mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _reduced(arch: str, **kw) -> dict:
    """``lower_cell`` overrides that make ``arch`` its reduced config
    (the dry run's remat policy kept)."""
    red = dataclasses.replace(reduce_config(get_config(arch)), **kw)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name != "remat_policy"}


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, (jax.ShapeDtypeStruct, jsh.NamedSharding)))


def _shard_bytes(structs, shardings) -> int:
    """Bytes of one device's shards of a tree of the reference's
    ``ShapeDtypeStruct``s."""
    return sum(int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
               for s, sh in zip(_leaves(structs), _leaves(shardings)))


def test_argument_bytes_of_a_reduced_train_cell(mesh):
    """Rank 0's local shards of the reduced llama3.2-3b train cell (state
    and batch, FSDP, sequence-sharded plan) on the (2, 4) mesh hold as
    many bytes as one device's shards of the reference's plan on an
    ``AbstractMesh`` of that shape."""
    cell, cfg, shape, _, plan = dryrun.lower_cell(
        "llama3p2_3b", TINY_TRAIN, "single", device="cpu", mesh=mesh,
        overrides=_reduced("llama3p2_3b"))
    assert (plan.fsdp, plan.mode, plan.seq_shard) == (True, "train", True)
    jcfg = jbase.reduce_config(jbase.get_config("llama3p2_3b"))
    jplan = jsh.ShardingPlan(mesh=JAbstractMesh((2, 4), ("data", "model")),
                             fsdp=True, mode="train", seq_shard=True)
    pspecs = jlm.param_specs(jcfg)
    state = {"params": pspecs, "opt": j_opt_specs(pspecs),
             "step": jcommon.ParamSpec((), (), dtype="int32",
                                       init="zeros")}
    structs = jcommon.shape_structs(state)
    batch = jlm.input_specs(jcfg, jbase.ShapeConfig(*dataclasses.astuple(
        TINY_TRAIN)))
    want = (_shard_bytes(structs, jplan.param_shardings(state))
            + _shard_bytes(batch, jplan.input_shardings(batch)))
    assert cell.argument_bytes == want
    # the whole state is 8× a rank's on this mesh for the FSDP-sharded
    # leaves: nothing was gathered whole
    whole = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                for s in _leaves(structs))
    assert cell.argument_bytes < whole / 4


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_group_extrapolation_equals_full_depth(mesh, kind):
    """Three layer groups counted from runs at one and two groups equal
    a run at three, every field of the costs, the output bytes and the
    peak: identical groups do identical work."""
    shape = TINY_TRAIN if kind == "train" else ShapeConfig(
        "tiny_decode", 64, 8, "decode")
    kw = dict(device="cpu", mesh=mesh,
              overrides=_reduced("llama3p2_3b", num_layers=3))
    got = dryrun.count_cell("llama3p2_3b", shape, "single", **kw)
    full = dryrun.lower_cell("llama3p2_3b", shape, "single", **kw)[0]
    want = full.run()                        # all three groups, eager
    assert got[3]                            # extrapolated
    assert got[0].as_dict() == want[0].as_dict()
    assert got[1:3] == want[1:3]
    assert got[0].flops > 0 and got[0].coll_wire > 0
    assert got[4].argument_bytes == full.argument_bytes


def _dtensor_op_costs(mesh, fake: bool):
    """Three DTensor ops on the (data=2, model=4) mesh, each under its own
    counter (on fake tensors or on real CPU ones): a column-sharded
    matmul [24, 40] @ [40, 56], a Shard(0)→Replicate redistribute of a
    [64, 32] f32 tensor over ``model`` and a Partial→Replicate one of a
    [16, 8] f32 tensor.  The shapes are this test's own, so the matmul is
    the first DTensor meets at them and its shape propagation runs."""
    from contextlib import nullcontext

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)

    from repro_torch.roofline.counts import CostCounter
    g = torch.Generator().manual_seed(0)
    x, w, t = (torch.randn(*s, generator=g)
               for s in ((24, 40), (40, 56), (64, 32)))
    part = torch.randn(16, 8, generator=g)
    rep = [Replicate(), Replicate()]
    out = []
    with FakeTensorMode() if fake else nullcontext() as mode:
        if fake:
            x, w, t, part = (mode.from_tensor(a) for a in (x, w, t, part))
        x = distribute_tensor(x, mesh, rep)
        w = distribute_tensor(w, mesh, [Replicate(), Shard(1)])
        t = distribute_tensor(t, mesh, [Replicate(), Shard(0)])
        part = DTensor.from_local(part, mesh, [Replicate(), Partial()],
                                  run_check=False)
        for fn in (lambda: x @ w, lambda: t.redistribute(mesh, rep),
                   lambda: part.redistribute(mesh, rep)):
            with CostCounter() as counter:
                fn()
            out.append(counter.costs)
    return out


@pytest.mark.parametrize("fake", [True, False], ids=["fake", "real"])
def test_dtensor_ops_are_counted_once_on_local_shards(mesh, fake):
    """On DTensors the counter tallies rank 0's local ops, each once: the
    column-sharded matmul's FLOPs are a quarter of the global product's
    (its shape-propagation run on global-shaped tensors is skipped), the
    Shard→Replicate redistribute is one all-gather over the 4-rank
    ``model`` group (output bytes, ring wire bytes × 3/4, inside one
    node) and the Partial→Replicate one is one all-reduce (wire bytes
    2 × 3/4 of its bytes)."""
    mm, gather, reduce = _dtensor_op_costs(mesh, fake)

    assert dict(mm.op_counts) == {"aten.mm": 1}
    assert mm.flops == 2 * 24 * 40 * 56 / 4
    assert dict(mm.flops_by_dtype) == {"float32": mm.flops}
    assert mm.traffic == 4 * (24 * 40 + 40 * 14 + 24 * 14)
    assert not mm.coll_counts and mm.coll_wire == 0

    n = 64 * 32 * 4
    assert dict(gather.coll_counts) == {"all-gather": 1}
    assert dict(gather.coll_bytes) == {"all-gather": n}
    assert gather.coll_wire == gather.coll_wire_node == n * 3 / 4
    assert gather.traffic == n and gather.flops == 0

    n = 16 * 8 * 4
    assert dict(reduce.coll_counts) == {"all-reduce": 1}
    assert dict(reduce.coll_bytes) == {"all-reduce": n}
    assert reduce.coll_wire == reduce.coll_wire_node == 2 * n * 3 / 4
    assert reduce.traffic == n and reduce.flops == 0


def test_launcher_writes_a_decode_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape
    decode_32k --mesh single --device cpu`` writes its cell: 256 chips,
    per-rank terms, a named bottleneck and ``argument_bytes`` equal to one
    device's shards of the reference's decode plan (bf16 params, the
    cache) plus the token and position vectors, which the port's decode
    step takes whole on every rank (the reference shards them over
    ``data``); the model is never allocated (the process's peak RSS stays
    under one rank's shards)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    argv = ["dryrun", "--arch", "llama3.2-3b", "--shape", "decode_32k",
            "--mesh", "single", "--device", "cpu", "--out", str(tmp_path)]
    # the peak resident set of the process's own image (VmHWM; getrusage's
    # ru_maxrss would also count the forking parent's pages)
    code = ("import runpy, sys\n"
            f"sys.argv = {argv!r}\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "print(open('/proc/self/status').read())\n")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    rss = 1024 * int(run.stdout.split("VmHWM:")[1].split()[0])     # kB
    cell = json.loads((tmp_path / "llama3p2_3b__decode_32k__single.json")
                      .read_text())
    assert cell["chips"] == 256 and cell["mode"] == "decode"
    assert cell["depth"] == {"groups": 28, "counted_groups": [1, 2],
                             "extrapolated": True}
    roof = cell["roofline"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert roof["bottleneck"] == max(
        ("compute", "memory", "collective"), key=lambda k: roof["t_" + k])
    assert roof["hlo_flops_dev"] == cell["cost_analysis"]["flops"] > 0
    jcfg = jbase.get_config("llama3p2_3b")
    jplan = jsh.ShardingPlan(mesh=JAbstractMesh((16, 16), ("data", "model")),
                             fsdp=False, mode="decode")
    shape = jbase.SHAPES["decode_32k"]
    pspecs = jlm.param_specs(jcfg)
    cspecs = jlm.cache_specs(jcfg, shape.global_batch, shape.seq_len)
    want = (_shard_bytes(jcommon.shape_structs(pspecs, "bfloat16"),
                         jplan.param_shardings(pspecs))
            + _shard_bytes(jcommon.shape_structs(cspecs),
                           jplan.cache_shardings(cspecs))
            + 2 * shape.global_batch * jnp.dtype(jnp.int32).itemsize)
    mem = cell["memory_analysis"]
    assert mem["argument_bytes"] == want
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["peak_extrapolated"] and mem["fits_80GB"]
    assert rss < mem["argument_bytes"], rss
