"""Multi-pod dry run: build every (architecture × shape × mesh) cell on
fake tensors over a fake process group of the production mesh's size,
run its step once under the roofline's counter, and write the roofline
terms and the memory it needs per rank (counterpart of
``repro.launch.dryrun``, which lowers and compiles each cell from
``ShapeDtypeStruct``s on 512 fake XLA devices).

    python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape decode_32k --mesh single [--device cpu]
    python -m repro_torch.launch.dryrun --all

Nothing is allocated.  The process group is
``torch.testing._internal.distributed.fake_pg``'s ``"fake"`` backend
(256 ranks for ``single``, 512 for ``multi``; this process is rank 0 and
its collectives return at once; ``one`` is one card, unsharded, with no
process group); the state comes from ``shape_structs``
as fake tensors on the card's device type (``--device cpu`` on a CPU
mesh, as the tests run it), laid out by ``ShardingPlan`` as the
reference's ``lower_cell`` lays it out, as DTensors whose local shards
are rank 0's.  The port's own ``make_train_step`` / ``make_prefill_step``
/ ``make_decode_step`` then run once under ``roofline.counts.CostCounter``
(FLOPs, traffic, collectives of rank 0's local ops, and the bytes of
its live tensors).

Depth: eager fake execution costs host time for every op, so a cell of
more than two layer groups runs at one and at two groups and the counts
of its G groups are ``counts.extrapolate``-d (exact: identical groups do
identical work; the embedding, head, tail and encoder are in both runs).
An encoder-decoder's encoder is counted at its full depth in both runs,
so it enters the extrapolated counts once.  Its host cost is the chunked
attention's: a 32k-position prefill's full (encoder, cross) attention
meets 64 key chunks a layer, which ``layers.attention.chunked_attention``
takes one key chunk at a time, on local shards (``_on_local_heads``).
``peak_bytes`` is extrapolated the same way and marked so
(``depth.extrapolated``); ``argument_bytes`` is exact, from the local
shards of the full-depth state.

The per-cell JSON keeps the reference's layout: ``memory_analysis`` is
{argument_bytes, output_bytes, peak_bytes, fits_80GB} per rank,
``cost_analysis`` the counter's totals (there is no compiler estimate),
``collectives`` / ``collective_counts`` by kind, ``roofline`` the
``RooflineReport`` against ``analysis.H100``.  ``--all`` builds every
runnable cell of ``iter_cells`` (10 architectures × 4 shapes × 2 meshes:
64 cells, and the reference's 16 skips, which it writes to
``skips.json``), one subprocess per cell, and exits 1 if any cell
failed.  The environment knobs are
the reference's: ``REPRO_ACCUM``, ``REPRO_SEQ_SHARD``, ``REPRO_REMAT``,
``REPRO_W8``, ``REPRO_KV8``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import (ALIASES, ARCH_NAMES, BLOCK_ATTN,
                                      BLOCK_LOCAL, SHAPES, get_config,
                                      shape_applicable)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (ShardingPlan, device_put,
                                              use_mesh)
from repro_torch.layers.common import ParamSpec, shape_structs, tree_map
from repro_torch.models import lm
from repro_torch.optim.adamw import (AdamWConfig, opt_state_specs,
                                     tree_leaves)
from repro_torch.roofline import counts
from repro_torch.roofline.analysis import build_report

HBM_BYTES = 80e9          # one H100's HBM3


def _state_specs(cfg):
    pspecs = lm.param_specs(cfg)
    return {
        "params": pspecs,
        "opt": opt_state_specs(pspecs),
        "step": ParamSpec((), (), dtype="int32", init="zeros"),
    }


DEFAULT_ACCUM = 4   # microbatches for train cells (memory fit)

# per-arch microbatches, the reference's: the smaller dense models fit at
# accum 2 under SP + selective remat
ACCUM_BY_ARCH = {
    "llama3_8b": 2,
    "llama3p2_3b": 2,
    "gemma_7b": 2,
    "seamless_m4t_medium": 2,
    "deepseek_moe_16b": 2,
}


def fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (collectives return at once), unless one is running."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is running; the cell needs {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh_for(mesh_kind: str, device):
    from repro_torch.launch.mesh import make_production_mesh
    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device=device)


def _locals(tree):
    """This rank's local tensors of a tree of (D)Tensors."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local_bytes(tree) -> int:
    """Bytes of this rank's local shards of a tree of (D)Tensors."""
    return sum(t.nbytes for t in _locals(tree))


@dataclasses.dataclass
class LoweredCell:
    """One cell's step and its fake, placed inputs (the port's counterpart
    of a ``jax.stages.Lowered``)."""
    step: object
    args: tuple
    fake_mode: object
    mesh: object
    argument_bytes: int

    def run(self):
        """The step once under the counter, which follows the live bytes
        from the arguments' own → (costs, output_bytes, peak_bytes)."""
        seen = {t.untyped_storage()._cdata for t in _locals(self.args)}
        with self.fake_mode, use_mesh(self.mesh), counts.CostCounter(
                base_bytes=self.argument_bytes) as counter:
            out = self.step(*self.args)
        new = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
               for t in _locals(out)}
        return (counter.costs,
                sum(n for k, n in new.items() if k not in seen),
                counter.peak_bytes)


def lower_cell(arch: str, shape_name, mesh_kind: str,
               serve_dtype: str = "bfloat16", accum_steps: int = None,
               overrides: dict = None, device: DeviceLike = None,
               mesh=None):
    """Builds one cell on fake tensors; returns (lowered, cfg, shape, mesh,
    plan), ``lowered`` a :class:`LoweredCell`.  ``shape_name`` names one
    of ``SHAPES`` or is a ``ShapeConfig``; ``mesh`` (a ``DeviceMesh`` on
    the running process group) replaces the production mesh.  Mesh kind
    ``"one"`` is one card holding everything: plain fake tensors, no
    process group, no plan (mesh and plan None)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.serving.serve_step import (make_decode_step,
                                                make_prefill_step)
    from repro_torch.train.train_step import make_train_step
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SystemExit(f"SKIP {arch}×{shape_name}: {why}")
    if accum_steps is None:
        default = ACCUM_BY_ARCH.get(ALIASES.get(arch, arch), DEFAULT_ACCUM)
        accum_steps = int(os.environ.get("REPRO_ACCUM", default)) \
            if shape.kind == "train" else 1
    dev = resolve_device(device)
    if mesh is None and mesh_kind != "one":
        mesh = _mesh_for(mesh_kind, dev)
    # residual-stream sequence sharding: valid only when no block mixes
    # along time sequentially (recurrent archs keep seq local)
    seq_shard = (os.environ.get("REPRO_SEQ_SHARD", "1") == "1"
                 and shape.kind == "train"
                 and all(b in (BLOCK_ATTN, BLOCK_LOCAL)
                         for b in cfg.layer_pattern))
    plan = None if mesh is None else ShardingPlan(
        mesh=mesh, fsdp=(shape.kind == "train"), mode=shape.kind,
        seq_shard=seq_shard)
    acts = None if plan is None else plan.acts

    def put(tree, shardings):
        return tree if plan is None else device_put(tree, shardings(tree))
    if shape.kind == "train":
        default_remat = "save_block_outputs" if seq_shard else "full"
        cfg = dataclasses.replace(
            cfg, remat_policy=os.environ.get("REPRO_REMAT", default_remat))
    else:
        cfg = dataclasses.replace(cfg, param_dtype=serve_dtype,
                                  remat_policy="none")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(tree):
        return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                              device=dev), tree)

    with fake_mode, use_mesh(mesh):
        if shape.kind == "train":
            sspecs = _state_specs(cfg)
            state = put(fake(shape_structs(sspecs)),
                        lambda _: plan.param_shardings(sspecs))
            batch = put(fake(lm.input_specs(cfg, shape)),
                        lambda b: plan.input_shardings(b))
            step = make_train_step(cfg, AdamWConfig(), act_rules=acts,
                                   accum_steps=accum_steps)
            args = (state, batch)
        elif shape.kind == "prefill":
            pspecs = lm.param_specs(cfg)
            params = put(fake(shape_structs(pspecs,
                                            dtype_override=serve_dtype)),
                         lambda _: plan.param_shardings(pspecs))
            batch = put(fake(lm.input_specs(cfg, shape)),
                        lambda b: plan.input_shardings(b))
            step = torch.no_grad()(make_prefill_step(cfg, act_rules=acts))
            args = (params, batch)
        else:
            # the paper's 8-bit datapath applied to serving: w8 weights
            # (REPRO_W8=1) and the int8 KV cache (REPRO_KV8=1)
            w8 = (os.environ.get("REPRO_W8") == "1" and cfg.moe is None
                  and all(b in (BLOCK_ATTN, BLOCK_LOCAL)
                          for b in cfg.layer_pattern))
            if os.environ.get("REPRO_KV8") == "1":
                cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
            pspecs = lm.param_specs(cfg)
            if w8:
                from repro_torch.core.quantize import quantize_weight_specs
                pspecs = quantize_weight_specs(pspecs)
                params = fake(shape_structs(pspecs))
            else:
                params = fake(shape_structs(pspecs,
                                            dtype_override=serve_dtype))
            params = put(params, lambda _: plan.param_shardings(pspecs))
            cspecs = lm.cache_specs(cfg, shape.global_batch, shape.seq_len)
            cache = put(fake(shape_structs(cspecs)),
                        lambda _: plan.cache_shardings(cspecs))
            # the token and position vectors go whole to every rank: the
            # decode step writes its cache slots from plain positions
            inp = fake(lm.input_specs(cfg, shape))
            step = torch.no_grad()(make_decode_step(cfg, act_rules=acts))
            args = (params, cache, inp["token"], inp["pos"])
    lowered = LoweredCell(step, args, fake_mode, mesh, _local_bytes(args))
    return lowered, cfg, shape, mesh, plan


def count_cell(arch: str, shape_name, mesh_kind: str,
               device: DeviceLike = None,
               overrides: Optional[dict] = None, mesh=None, **kw):
    """One cell's step run under the counter → (costs, output_bytes,
    peak_bytes, extrapolated, lowered, cfg, shape, mesh, plan): at full
    depth where the config has at most two layer groups, else
    at one and at two groups, extrapolated to all of them
    (``counts.extrapolate``; the bytes the same way).  ``lowered`` is
    the full-depth cell, whose ``argument_bytes`` are exact; ``kw`` goes
    to ``lower_cell``."""
    kw.update(device=device, mesh=mesh)
    full, cfg, shape, mesh, plan = lower_cell(arch, shape_name, mesh_kind,
                                              overrides=overrides, **kw)
    kw["mesh"] = mesh
    groups = cfg.num_groups_scan
    if groups <= 2:
        costs, out_bytes, peak = full.run()
        return costs, out_bytes, peak, False, full, cfg, shape, mesh, plan
    runs = []
    for g in (1, 2):
        depth = {"num_layers": g * len(cfg.layer_pattern)
                 + len(cfg.tail_blocks)}
        runs.append(lower_cell(arch, shape_name, mesh_kind,
                               overrides={**(overrides or {}), **depth},
                               **kw)[0].run())
    costs = counts.extrapolate(runs[0][0], runs[1][0], groups)
    out_bytes, peak = (a + (groups - 1) * (b - a)
                       for a, b in zip(runs[0][1:], runs[1][1:]))
    return costs, out_bytes, peak, True, full, cfg, shape, mesh, plan


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             device: DeviceLike = None) -> dict:
    """One cell counted (``count_cell``) and its JSON written to
    ``out_dir``; returns it."""
    t0 = time.time()
    costs, out_bytes, peak, extrapolated, full, cfg, shape, mesh, plan = \
        count_cell(arch, shape_name, mesh_kind, device)
    t_run = time.time() - t0
    groups = cfg.num_groups_scan

    chips = 1 if mesh is None else mesh.size()
    report = build_report(arch, shape_name, mesh_kind, chips, costs, cfg,
                          shape)
    cell = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": chips, "fsdp": plan is not None and plan.fsdp,
        "mode": shape.kind,
        "device": str(resolve_device(device)),
        "counted_by": "roofline.counts.CostCounter on fake tensors",
        "depth": {"groups": groups,
                  "counted_groups": [1, 2] if extrapolated else [groups],
                  "extrapolated": extrapolated},
        "run_s": round(t_run, 2),
        "memory_analysis": {
            "argument_bytes": full.argument_bytes,
            "output_bytes": int(out_bytes),
            "peak_bytes": int(peak),
            "peak_extrapolated": extrapolated,
            "fits_80GB": bool(peak <= HBM_BYTES)},
        "cost_analysis": {"flops": costs.flops,
                          "transcendentals": costs.transcendentals,
                          "bytes accessed": costs.traffic},
        "flops_by_dtype": dict(costs.flops_by_dtype),
        "op_counts": dict(costs.op_counts),
        "collectives": {k: float(v) for k, v in costs.coll_bytes.items()},
        "collective_counts": {k: int(v)
                              for k, v in costs.coll_counts.items()},
        "wire_bytes_in_node": costs.coll_wire_node,
        "roofline": report.as_dict(),
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    with open(path, "w") as f:
        json.dump(cell, f, indent=1)
    print(f"OK {arch} × {shape_name} × {mesh_kind}: "
          f"run {t_run:.1f}s  "
          f"bottleneck={report.bottleneck}  "
          f"terms(c/m/x)=({report.t_compute:.4f}/{report.t_memory:.4f}/"
          f"{report.t_collective:.4f})s  "
          f"mfu@roofline={report.mfu_at_roofline:.3f}")
    return cell


def iter_cells(meshes=("single", "multi")):
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            for mesh_kind in meshes:
                yield arch, shape_name, mesh_kind, ok, why


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(
        description="Dry run of (architecture × shape × mesh) cells on fake "
                    "tensors over a fake process group: per-rank roofline "
                    "terms against the H100 and memory, nothing allocated.")
    p.add_argument("--arch", default=None,
                   help="architecture id (see configs)")
    p.add_argument("--shape", choices=sorted(SHAPES), default=None)
    p.add_argument("--mesh", choices=("single", "multi", "one"),
                   default="single",
                   help="single: (data=16, model=16), 256 ranks; multi: "
                        "(pod=2, data=16, model=16), 512 ranks; one: one "
                        "card, unsharded")
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--device", default=None,
                   help="the fake tensors' device type (default: the card; "
                        "cpu for a CPU mesh)")
    p.add_argument("--all", action="store_true",
                   help="run every runnable cell (subprocess per cell, "
                        "resumable via existing JSONs)")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)

    if args.all:
        failures, skips = [], []
        for arch, shape_name, mesh_kind, ok, why in iter_cells():
            path = os.path.join(args.out,
                                f"{arch}__{shape_name}__{mesh_kind}.json")
            if not ok:
                skips.append((arch, shape_name, mesh_kind, why))
                continue
            if os.path.exists(path) and not args.force:
                print(f"cached {path}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--mesh", mesh_kind, "--out", args.out]
            if args.device:
                cmd += ["--device", args.device]
            if subprocess.run(cmd).returncode != 0:
                failures.append((arch, shape_name, mesh_kind))
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "skips.json"), "w") as f:
            json.dump([{"arch": a, "shape": s, "mesh": m, "reason": w}
                       for a, s, m, w in skips], f, indent=1)
        print(f"done; {len(failures)} failures, {len(skips)} skips")
        if failures:
            for f_ in failures:
                print("FAILED:", f_)
            sys.exit(1)
        return

    if args.arch is None or args.shape is None:
        p.error("--arch and --shape name a cell (or pass --all)")
    arch = ALIASES.get(args.arch, args.arch)
    try:
        run_cell(arch, args.shape, args.mesh, args.out, device=args.device)
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
