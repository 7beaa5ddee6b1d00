"""Logical-axis sharding rules → PartitionSpecs / NamedShardings
(counterpart of ``repro.distributed.sharding``) on ``torch.distributed``'s
DTensor.

Axis semantics (see layers/common.py for the logical-name glossary):

* Parameters: TP axes ("heads", "mlp", "vocab", "experts", "rnn", "qkv")
  map to the "model" mesh axis; with FSDP on, the "embed" axis is
  additionally sharded over the FSDP axes (ZeRO-style — parameters,
  gradients and optimizer state all follow the same spec, so the
  backward's weight gradients leave their products as partial sums that
  are reduce-scattered onto the parameters' layout).
* Activations: "batch" maps to the DP axes (("pod","data") on the
  multi-pod mesh); "cache_seq" maps to "model" in *decode* mode only.

Conflicts (a tensor whose logical axes map to the same mesh axis twice,
e.g. MoE weights [experts, embed, mlp] with experts→model and mlp→model)
are resolved first-come-first-served along dimensions, matching MaxText.

The rules and specs need only a mesh's axis names and sizes: every
function that computes them takes a ``DeviceMesh`` or an
:class:`AbstractMesh`, so the production meshes' specs come out without
their 256 ranks.  Placing tensors (``place``, ``device_put``) needs a
``DeviceMesh``.  A :class:`NamedSharding` turns its spec into DTensor
placements, one per mesh dim: ``Shard(d)`` where the dim's name appears in
tensor dim d's entry, else ``Replicate()``.  A tuple entry such as
``("pod", "data")`` shards one tensor dim over both mesh dims, the first
outermost, as JAX lays it out; DTensor shards in mesh order, so a tuple
must name its mesh dims in that order.

The JAX constructs map as follows: ``jax.device_put`` → ``device_put``
(``distribute_tensor`` from each rank's own value, no broadcast);
``jax.jit``'s in/out shardings → DTensor's sharding propagation;
``with_sharding_constraint`` → ``DTensor.redistribute``
(``layers.common.lconstraint``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.layers.common import (PartitionSpec, ParamSpec, active_mesh,
                                       resolve_pspec, spec_map, tree_map,
                                       use_mesh)

P = PartitionSpec
__all__ = ["AbstractMesh", "NamedSharding", "P", "PartitionSpec",
           "ShardingPlan", "act_rules", "active_mesh", "axes_to_pspec",
           "batch_sharding", "contract_local", "device_put",
           "flatten_rows", "from_local", "gather_rows", "input_shardings",
           "local_block", "mesh_shape", "param_rules", "place",
           "replicated", "rule_placements", "spec_shardings",
           "unflatten_rows", "use_mesh"]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no ranks behind it (JAX's
    ``AbstractMesh``)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def param_rules(mesh, fsdp: bool) -> Dict[str, Any]:
    return {
        "heads": "model",
        "qkv": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "rnn": "model",
        "kv_heads": None,
        "head_dim": None,
        "stack": None,
        "embed": _dp_axes(mesh) if fsdp else None,
    }


def act_rules(mesh, mode: str, seq_shard: bool = False) -> Dict[str, Any]:
    """mode: train | prefill | decode.

    seq_shard: Megatron-SP-style residual-stream sequence sharding ("seq_r"
    is the residual sequence axis, used only on between-block
    constraints); only valid when no block mixes along time sequentially
    (recurrent archs keep seq local)."""
    return {
        "batch": _dp_axes(mesh),
        "seq": None,
        "seq_r": "model" if seq_shard else None,
        "embed": None,
        "heads": "model",
        "kv_heads": None,
        "qkv": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "rnn": "model",
        "cache_seq": "model" if mode == "decode" else None,
    }


def axes_to_pspec(axes: Tuple[Optional[str], ...],
                  rules: Dict[str, Any]) -> PartitionSpec:
    """Map logical axes to a PartitionSpec, dropping mesh-axis reuse."""
    return resolve_pspec(axes, rules)


def _entries(spec: PartitionSpec, ndim: int) -> Tuple[Any, ...]:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _fits(shape, spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop sharding on dims not divisible by their mesh-axis size."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, _entries(spec, len(shape))):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        size = 1
        for a in axes:
            size *= sizes[a]
        out.append(entry if dim % size == 0 else None)
    return P(*out)


# when a logical axis cannot take its mesh axis (divisibility), try moving
# the mesh axis to one of these sibling dims instead (yi-34b: 56 heads don't
# divide model=16, so q/o projections shard head_dim — without this they
# would silently replicate, +12 GB/device)
_FALLBACKS = {"heads": ("head_dim",)}


@dataclass(frozen=True)
class NamedSharding:
    """A PartitionSpec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        """One DTensor placement per mesh dim (see the module note)."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(mesh_shape(self.mesh))
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"{self.spec}: tensor dim {d} names mesh axes {axes} "
                    f"out of the mesh's order {tuple(names)}; DTensor "
                    f"shards a dim over several mesh dims in mesh order")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)


def spec_shardings(spec_tree, mesh, rules: Dict[str, Any]):
    """ParamSpec tree → NamedSharding tree (divisibility-safe, with
    per-axis fallbacks)."""
    sizes = mesh_shape(mesh)

    def f(s: ParamSpec):
        raw = axes_to_pspec(s.axes, rules)
        entries = list(_entries(_fits(s.shape, raw, mesh), len(s.shape)))
        # re-place dropped mesh axes on fallback dims
        raw_entries = _entries(raw, len(s.shape))
        for i, (want, got) in enumerate(zip(raw_entries, entries)):
            if want is None or got is not None:
                continue
            for fb in _FALLBACKS.get(s.axes[i], ()):
                for j, ax_name in enumerate(s.axes):
                    if ax_name != fb or entries[j] is not None:
                        continue
                    size = sizes[want] if isinstance(want, str) else 0
                    if size and s.shape[j] % size == 0:
                        entries[j] = want
                        break
                else:
                    continue
                break
        return NamedSharding(mesh, P(*entries))
    return spec_map(f, spec_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh, ndim: int = 2) -> NamedSharding:
    """Inputs: [B, ...] sharded over the DP axes."""
    return NamedSharding(mesh, P(_dp_axes(mesh), *([None] * (ndim - 1))))


def input_shardings(input_tree, mesh):
    """A tree of tensors (or anything with a ``shape``) → batch-sharded
    NamedShardings (dim 0 = batch), dropping the constraint when the batch
    dim does not divide."""
    sizes = mesh_shape(mesh)
    dp = _dp_axes(mesh)
    size = 1
    for a in dp:
        size *= sizes[a]

    def f(s):
        shape = tuple(s.shape)
        if shape and shape[0] % size == 0:
            return NamedSharding(mesh, P(dp, *([None] * (len(shape) - 1))))
        return NamedSharding(mesh, P())
    return tree_map(f, input_tree)


def place(x: torch.Tensor, sharding) -> torch.Tensor:
    """``x`` on ``sharding``'s layout (a NamedSharding, or a DTensor's): a
    DTensor redistributed (a no-op where it is there already;
    differentiable), a plain tensor distributed from this rank's own value
    with no collective, so every rank must hold the same value
    (``jax.device_put`` of a host array)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh = (sharding.device_mesh if isinstance(sharding, DTensor)
            else sharding.mesh)
    placements = tuple(sharding.placements)
    if isinstance(x, DTensor):
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(mesh, placements)
    d = distribute_tensor(x, mesh, placements, src_data_rank=None)
    local = d.to_local()
    if local.numel() < x.numel() and (local.untyped_storage()._cdata
                                      == x.untyped_storage()._cdata):
        # a shard that is a view of the whole would keep the whole alive
        d = DTensor.from_local(local.clone(), mesh, placements,
                               run_check=False, shape=d.shape,
                               stride=d.stride())
    return d


def device_put(tree, shardings):
    """``jax.device_put`` of a tree: each tensor placed on the
    NamedSharding at its position in ``shardings`` (a tree of the same
    structure; a None sharding leaves its leaf as it is).  A local shard
    that is the whole tensor (a one-rank mesh, a replicated leaf) shares
    its storage, so keep a copy of a state that a later step updates in
    place; a smaller shard is a copy of its block."""
    return tree_map(lambda t, s: t if s is None else place(t, s), tree,
                    shardings)


@dataclass
class ShardingPlan:
    """Everything a step builder needs to place one (arch × shape) cell."""
    mesh: Any
    fsdp: bool
    mode: str                       # train | prefill | decode
    seq_shard: bool = False         # residual-stream SP (see act_rules)

    @property
    def params(self) -> Dict[str, Any]:
        return param_rules(self.mesh, self.fsdp)

    @property
    def acts(self) -> Dict[str, Any]:
        return act_rules(self.mesh, self.mode, self.seq_shard)

    def param_shardings(self, spec_tree):
        return spec_shardings(spec_tree, self.mesh, self.params)

    def cache_shardings(self, cache_spec_tree):
        # caches are activations: batch + cache_seq rules apply
        return spec_shardings(cache_spec_tree, self.mesh, self.acts)

    def input_shardings(self, input_tree):
        return input_shardings(input_tree, self.mesh)


# ---------------------------------------------------------------------------
# Local-shard counterparts of ops DTensor would redistribute or refuse
# ---------------------------------------------------------------------------


def _stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= n
    return tuple(reversed(out))


def from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) from this rank's
    ``local`` shard on ``placements``, with no collective; its gradient
    comes back on ``placements`` (a ``Partial`` one replicated)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=_stride(shape))


def rule_placements(mesh, shape, axes):
    """The placements the active rules give a tensor of ``shape`` with
    logical ``axes`` on ``mesh``, a dim that its mesh axes do not divide
    left replicated (as ``spec_shardings`` lays out parameters and
    caches); all replicated without rules."""
    from repro_torch.layers.common import active_rules
    spec = resolve_pspec(axes, active_rules() or {})
    return NamedSharding(mesh, _fits(shape, spec, mesh)).placements


def flatten_rows(x):
    """A DTensor [..., K] → [M, K] through its local shard: sharded on its
    leading dim (where that dim divides evenly, so its blocks of rows are
    the flattened tensor's) stays sharded on the rows, on its last on the
    columns; any other sharded dim is replicated first.  DTensor's own
    view rule refuses a sharded leading dim of size 1 (one microbatch row
    on a one-rank mesh)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, last = x.device_mesh, x.dim() - 1
    rows = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(0):
            rows *= mesh.size(i)
    even = x.shape[0] % rows == 0
    pre = [p if (p.is_shard(0) and even) or p.is_shard(last)
           or not p.is_shard() else Replicate() for p in x.placements]
    post = [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(last)
            else p for p in pre]
    local = x.redistribute(mesh, pre).to_local()
    return from_local(local.reshape(-1, local.shape[-1]), mesh, post,
                      (math.prod(x.shape[:-1]), x.shape[-1]))


def unflatten_rows(y, lead):
    """``flatten_rows`` undone on the product: a DTensor [M, N] →
    [*lead, N] through its local shard."""
    from torch.distributed.tensor import Shard
    last = len(lead)
    post = [Shard(0) if p.is_shard(0) else Shard(last) if p.is_shard(1)
            else p for p in y.placements]
    local = y.to_local()
    return from_local(local.reshape(-1, *lead[1:], local.shape[-1]),
                      y.device_mesh, post, (*lead, y.shape[-1]))


def local_block(t):
    """(shape, global offset) of this rank's local shard of DTensor
    ``t``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    # DTensor computes the offset from a host tensor that it reads back,
    # which a fake tensor (the dry run's) cannot give
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                     t.placements)


def gather_rows(table, ids):
    """``table[ids]`` for a DTensor table [V, D] on local shards, mesh dim
    by mesh dim: a dim that shards V looks each id up in its own block of
    rows, zero outside it (a ``Partial`` sum; the ids replicated there:
    Megatron's vocab-parallel embedding); a dim that shards the ids keeps
    them so and gathers the table there (FSDP); a dim that shards D keeps
    it.  The table's local gradient carries the matching placements.
    DTensor's own index rule fails in the backward on some versions
    (``aten.index_put`` under torch 2.11)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    r, nd = Replicate(), ids.dim()
    tp, ip, op, gp = [], [], [], []
    for pt, pi in zip(table.placements, ids.placements):
        if pt.is_shard(0):
            tp.append(pt), ip.append(r), op.append(Partial()), gp.append(pt)
        elif pi.is_shard():
            tp.append(r), ip.append(pi), op.append(pi), gp.append(Partial())
        elif pt.is_shard(1):
            tp.append(pt), ip.append(r), op.append(Shard(nd)), gp.append(pt)
        else:
            tp.append(r), ip.append(r), op.append(r), gp.append(r)
    table = table.redistribute(mesh, tp)
    shape, off = local_block(table)
    t_l = table.to_local(grad_placements=gp)
    i_l = ids.redistribute(mesh, ip).to_local().long()
    if any(p.is_shard(0) for p in tp):
        mine = (i_l >= off[0]) & (i_l < off[0] + shape[0])
        rows = t_l[torch.where(mine, i_l - off[0], 0)]
        rows = torch.where(mine[..., None], rows, 0)
    else:
        rows = t_l[i_l]
    return from_local(rows, mesh, op, (*ids.shape, table.shape[1]))


# ---------------------------------------------------------------------------
# Two-operand contractions on local shards
# ---------------------------------------------------------------------------


def _contract_plan(subscripts: str, xp, wp):
    """Per mesh dim of ``x, w → out`` (einsum ``subscripts``, operand
    placements ``xp``, ``wp``): (x placement, w placement, out placement,
    dx placement, dw placement) that let each rank contract its local
    shards alone:

    * x sharded on a letter of x and the output only → kept, w replicated,
      the output sharded there; w's gradient is a partial sum;
    * else w sharded on a letter of w and the output only → the mirror;
    * else either sharded on a contracted letter → both sharded on it, the
      output a ``Partial`` sum;
    * else either sharded on a letter of all three → both sharded on it;
    * else both replicated (a ``Partial`` operand reduced first)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    lhs, out = subscripts.replace(" ", "").split("->")
    xs, ws = lhs.split(",")
    r = Replicate()
    plan = []
    for px, pw in zip(xp, wp):
        lx = xs[px.dim] if px.is_shard() else None
        lw = ws[pw.dim] if pw.is_shard() else None
        if lx and lx in out and lx not in ws:
            o = Shard(out.index(lx))
            plan.append((px, r, o, px, Partial()))
        elif lw and lw in out and lw not in xs:
            plan.append((r, pw, Shard(out.index(lw)), Partial(), pw))
        elif (lx and lx not in out) or (lw and lw not in out and lw in xs):
            c = lx if lx and lx not in out else lw
            sx, sw = Shard(xs.index(c)), Shard(ws.index(c))
            plan.append((sx, sw, Partial(), sx, sw))
        elif lx or lw:
            b = lx or lw
            sx, sw = Shard(xs.index(b)), Shard(ws.index(b))
            plan.append((sx, sw, Shard(out.index(b)), sx, sw))
        else:
            plan.append((r, r, r, r, r))
    return plan


def contract_local(subscripts: str, x, w, local):
    """``local(x_local, w_local)`` (an einsum or a kernel computing
    ``subscripts`` on plain tensors) over DTensors ``x`` and ``w`` on one
    mesh: each operand redistributed to ``_contract_plan``'s layout, the
    local shards contracted, the result wrapped back as a DTensor.  The
    local operands carry the placements of their gradients, so autograd
    through ``local`` gives the backward on local shards too.  A plain
    operand is taken as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = (x if isinstance(x, DTensor) else w).device_mesh

    def as_dtensor(t):
        if isinstance(t, DTensor):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    x, w = as_dtensor(x), as_dtensor(w)
    plan = _contract_plan(subscripts, x.placements, w.placements)
    pick = lambda i: [p[i] for p in plan]  # noqa: E731
    x_l = x.redistribute(mesh, pick(0)).to_local(grad_placements=pick(3))
    w_l = w.redistribute(mesh, pick(1)).to_local(grad_placements=pick(4))
    lhs, out = subscripts.replace(" ", "").split("->")
    sizes = dict(zip(lhs.split(",")[0], x.shape))
    sizes.update(zip(lhs.split(",")[1], w.shape))
    return from_local(local(x_l, w_l), mesh, pick(2),
                      [sizes[c] for c in out])
