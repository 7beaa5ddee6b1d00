"""Parameter specs, parameter trees and the linear-layer core (counterpart
of ``repro.layers.common``).

A model is described once as a tree (nested dicts, with ``KVCache`` named
tuples for caches) of :class:`ParamSpec`; :func:`materialize` turns it into
tensors drawn from a ``torch.Generator``.  The trees keep the reference's
layout leaf for leaf, stacked ``stack`` dimension included, so weights carry
across with ``convert.lm_params_to_torch``.

Sharding is a later slice of the port: ``activate_rules`` and
``lconstraint`` keep the reference's logical-axis annotations at the same
points and do nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


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


def materialize(tree: PyTree, generator: torch.Generator, *,
                device: DeviceLike = None,
                dtype_override: Optional[str] = None) -> PyTree:
    """Real parameters on ``device`` (default: the GPU), drawn from
    ``generator`` (which must live on that device) leaf by leaf in the
    reference's flatten order.  The numbers differ from ``jax.random``'s
    for the same seed; tests carry weights across instead."""
    dev = resolve_device(device)

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
        return (torch.randn(s.shape, generator=generator, device=dev)
                * std).to(dt)

    return tree_map(one, tree)


def stack_specs(tree: PyTree, n: int) -> PyTree:
    """Prepend a scanned ``stack`` dimension of size n to every spec."""
    def f(s: ParamSpec):
        return ParamSpec((n,) + s.shape, ("stack",) + s.axes, s.dtype,
                         s.init, s.scale,
                         tuple(a + 1 for a in s.fan_in_axes))
    return tree_map(f, tree)


class activate_rules:
    """Logical-axis → mesh-axis rules: a no-op until the sharding slice."""

    def __init__(self, rules: Optional[dict]):
        self.rules = rules

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def lconstraint(x: torch.Tensor, axes: Tuple[Optional[str], ...]):
    """Logical sharding annotation: a no-op until the sharding slice."""
    del axes
    return x


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
        y = kops.matmul_ws(x.reshape(-1, x.shape[-1]), w, bias=bias)
        return y.reshape(*lead, w.shape[-1])
    y = torch.einsum(subscripts, x, w)
    if bias is not None:
        y = y + bias
    return y
