"""Parameter specs, parameter trees and the linear-layer core (counterpart
of ``repro.layers.common``).

A model is described once as a tree (nested dicts, with ``KVCache`` named
tuples for caches) of :class:`ParamSpec`; :func:`materialize` turns it into
tensors drawn from a ``torch.Generator``, :func:`shape_structs` into
``meta`` stand-ins that hold no storage (the dry run's inputs).  The
trees keep the reference's layout leaf for leaf, stacked ``stack``
dimension included, so weights carry across with
``convert.lm_params_to_torch``.

Sharding: ``activate_rules`` installs logical-axis → mesh-axis rules
(``repro_torch.distributed.sharding``) and ``use_mesh`` an ambient
``DeviceMesh``.  With both set, ``lconstraint`` places an activation on the
resolved layout, as the reference's ``with_sharding_constraint`` does: a
DTensor is redistributed, a plain tensor is distributed from its value
(which every rank must hold, as a host value that ``jax.jit`` shards),
and plain tensors that meet DTensors in an op are taken as replicated
(DTensor's ``implicit_replication``).  Without rules or without a mesh it
returns its input, so every single-device path is unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, is_dtensor, resolve_device

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int32": torch.int32}


def torch_dtype(dtype) -> torch.dtype:
    """A dtype name of the configs ("bfloat16", ...) or a torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) else _DTYPES[dtype]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "float32"
    init: str = "fan_in"        # fan_in | normal | zeros | ones | constant
    scale: float = 1.0
    fan_in_axes: Tuple[int, ...] = (0,)   # which dims form fan-in for scaling

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves (specs, tensors, arrays) of nested dicts and
    named tuples, and leaf for leaf over trees of the same structure in
    ``rest``, visited in the reference's flatten order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    return fn(tree, *rest)


def spec_map(fn: Callable[[ParamSpec], Any], tree: PyTree) -> PyTree:
    """``fn`` over the :class:`ParamSpec` leaves of ``tree``."""
    return tree_map(fn, tree)


def shape_structs(tree: PyTree,
                  dtype_override: Optional[str] = None) -> PyTree:
    """Stand-ins with each spec's shape and dtype and no storage: ``meta``
    tensors (the reference's ``jax.ShapeDtypeStruct``), which the dry run
    turns into fake tensors on its device."""
    return spec_map(lambda s: torch.empty(
        s.shape, dtype=torch_dtype(dtype_override or s.dtype),
        device="meta"), tree)


def axes_tree(tree: PyTree) -> PyTree:
    return spec_map(lambda s: s.axes, tree)


def _leaves(tree: PyTree):
    out = []
    spec_map(out.append, tree)
    return out


def param_bytes(tree: PyTree) -> int:
    return sum(math.prod(s.shape) * torch_dtype(s.dtype).itemsize
               for s in _leaves(tree))


def param_count_tree(tree: PyTree) -> int:
    return sum(math.prod(s.shape) for s in _leaves(tree))


# a leaf with more elements than this is drawn one index of its leading
# axis at a time (see ``materialize``); every leaf of the dense, hybrid
# and attention-free models is smaller (the largest, gemma-7b's stacked
# MLP weights, has 2.11e9)
DRAW_WHOLE_MAX = 2 ** 31


def materialize(tree: PyTree, generator: torch.Generator, *,
                device: DeviceLike = None,
                dtype_override: Optional[str] = None) -> PyTree:
    """Real parameters on ``device`` (default: the GPU), drawn from
    ``generator`` (which must live on that device) leaf by leaf in the
    reference's flatten order.  The numbers differ from ``jax.random``'s
    for the same seed; tests carry weights across instead.

    Each value is drawn in f32 and scaled there, then cast to the leaf's
    dtype.  A leaf of more than ``DRAW_WHOLE_MAX`` elements (the MoE
    models' stacked experts: 9.66e9 in qwen3-moe-30b-a3b's, 38.7 GB as
    f32) is drawn into its allocated tensor one index of its leading axis
    at a time, so the f32 scratch is one slice; its numbers then differ
    from a whole draw's."""
    dev = resolve_device(device)

    def draw(shape, std, dt):
        return torch.randn(shape, generator=generator,
                           device=dev).mul_(std).to(dt)

    def one(s: ParamSpec):
        dt = torch_dtype(dtype_override or s.dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        if s.init == "constant":
            return torch.full(s.shape, s.scale, dtype=dt, device=dev)
        std = s.scale
        if s.init == "fan_in":
            fan = max(math.prod(s.shape[a] for a in s.fan_in_axes), 1)
            std = s.scale / math.sqrt(fan)
        elif s.init != "normal":
            raise ValueError(s.init)
        if math.prod(s.shape) <= DRAW_WHOLE_MAX:
            return draw(s.shape, std, dt)
        out = torch.empty(s.shape, dtype=dt, device=dev)
        for i in range(s.shape[0]):
            out[i] = draw(s.shape[1:], std, dt)
        return out

    return tree_map(one, tree)


def stack_specs(tree: PyTree, n: int) -> PyTree:
    """Prepend a scanned ``stack`` dimension of size n to every spec."""
    def f(s: ParamSpec):
        return ParamSpec((n,) + s.shape, ("stack",) + s.axes, s.dtype,
                         s.init, s.scale,
                         tuple(a + 1 for a in s.fan_in_axes))
    return tree_map(f, tree)


# ---------------------------------------------------------------------------
# Logical sharding constraints (no-op outside an active rule context)
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: per tensor dim ``None``, a mesh-axis name,
    or a tuple of names (the dim split over all of them, the first
    outermost); a one-name tuple is that name, as JAX writes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


_ACTIVE_RULES: Optional[dict] = None
_ACTIVE_MESH = None


class _Scoped:
    """Sets a module global for the length of a ``with`` block."""
    _name = ""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self._prev = globals()[self._name]
        globals()[self._name] = self.value
        self._implicit = None
        if _ACTIVE_RULES is not None and _ACTIVE_MESH is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            self._implicit = implicit_replication()
            self._implicit.__enter__()
        return self

    def __exit__(self, *exc):
        if self._implicit is not None:
            self._implicit.__exit__(*exc)
        globals()[self._name] = self._prev
        return False


class activate_rules(_Scoped):
    """Context manager installing logical-axis → mesh-axis rules; while
    active under ``use_mesh``, :func:`lconstraint` places activations."""
    _name = "_ACTIVE_RULES"

    @property
    def rules(self) -> Optional[dict]:
        return self.value


class use_mesh(_Scoped):
    """Context manager making a ``torch.distributed`` ``DeviceMesh`` the
    ambient mesh (``jax.set_mesh``'s counterpart)."""
    _name = "_ACTIVE_MESH"


def active_mesh():
    """The ``DeviceMesh`` of the innermost ``use_mesh``, or None."""
    return _ACTIVE_MESH


def resolve_pspec(axes: Tuple[Optional[str], ...],
                  rules: dict) -> PartitionSpec:
    """Logical axes → PartitionSpec with first-come-first-served mesh-axis
    conflict resolution (a mesh axis may shard at most one dimension)."""
    used: set = set()
    out = []
    for name in axes:
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None:
            out.append(None)
            continue
        flat = (mesh_axis,) if isinstance(mesh_axis, str) else tuple(
            mesh_axis)
        if not flat or any(a in used for a in flat):
            out.append(None)
            continue
        used.update(flat)
        out.append(mesh_axis if isinstance(mesh_axis, str) else flat)
    return PartitionSpec(*out)


def lconstraint(x: torch.Tensor, axes: Tuple[Optional[str], ...]):
    """Constrain an activation's layout by logical axis names: under
    rules and a mesh, a DTensor redistributed to the resolved placements,
    a plain tensor distributed from its value; else ``x`` itself."""
    if _ACTIVE_RULES is None or _ACTIVE_MESH is None:
        return x
    from repro_torch.distributed.sharding import NamedSharding, place
    return place(x, NamedSharding(_ACTIVE_MESH,
                                  resolve_pspec(axes, _ACTIVE_RULES)))


def einsum(subscripts: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands; DTensors under ``use_mesh``
    contract their local shards (``sharding.contract_local``) rather than
    go through DTensor's decomposition of the einsum into views and a
    ``bmm``, which redistributes more and plans each step on the host."""
    if _ACTIVE_MESH is not None and is_dtensor(a, b):
        from repro_torch.distributed.sharding import contract_local
        return contract_local(subscripts, a, b,
                              lambda x, y: torch.einsum(subscripts, x, y))
    return torch.einsum(subscripts, a, b)


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    dt = torch_dtype(dtype)
    return x.to(dt) if x.dtype != dt else x


def dense(w, x: torch.Tensor, subscripts: str, *, backend: str = "xla",
          bias: Optional[torch.Tensor] = None,
          compute_dtype="bfloat16") -> torch.Tensor:
    """Linear layer core.  ``subscripts`` is the einsum string x,w->y.

    Both operands are cast to ``compute_dtype`` and the product comes out
    in it (the reference's ``preferred_element_type``: f32 accumulation,
    one rounding of the output).  ``backend="pallas_ws"`` routes 2-D
    weights through the ``matmul_ws`` kernel (bf16 or f32), as the
    reference does.

    w8a8 serving: a {"q": int8, "s": scale} weight of any rank runs the
    paper's 8-bit datapath (``core.quantize.w8_einsum``: the int8 GEMM on
    ``matmul_ws`` whatever ``backend`` says; in the reference too this
    branch comes before the backend is read), the bias added after the
    rescale."""
    if isinstance(w, dict):
        from repro_torch.core.quantize import w8_einsum
        y = w8_einsum(subscripts, x, w["q"], w["s"],
                      compute_dtype=compute_dtype)
        if bias is not None:
            y = y + bias
        return y
    x = cast(x, compute_dtype)
    w = cast(w, compute_dtype)
    if backend == "pallas_ws" and w.dim() == 2:
        from repro_torch.kernels import ops as kops
        lead = x.shape[:-1]
        if is_dtensor(x):
            from repro_torch.distributed.sharding import (flatten_rows,
                                                          unflatten_rows)
            return unflatten_rows(kops.matmul_ws(flatten_rows(x), w,
                                                 bias=bias), lead)
        y = kops.matmul_ws(x.reshape(-1, x.shape[-1]), w, bias=bias)
        return y.reshape(*lead, w.shape[-1])
    y = einsum(subscripts, x, w)
    if bias is not None:
        y = y + bias
    return y
