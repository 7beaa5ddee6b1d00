"""Per-rank FLOP / traffic / collective accounting of eager PyTorch, read
off the dispatcher (counterpart of ``repro.roofline.hlo``, which reads the
same numbers off post-SPMD HLO text).

:class:`CostCounter` is a ``TorchDispatchMode``.  Around a step it tallies,
op by op, what ``hlo._account`` tallies per HLO instruction:

* FLOPs of every matmul-class op (those with a formula in
  ``torch.utils.flop_counter``'s registry: ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolution, ...; ``_int_mm``; and the port's kernels
  ``repro_torch::matmul_ws`` and ``repro_torch::flash_attention``, which
  register their own formulas), by the dtype of their first operand;
* traffic: the bytes of the operands and outputs of those ops, and the
  output bytes of collectives (an HBM-traffic model, as the reference's);
* transcendentals: the output elements of exp, log, tanh, rsqrt, ...;
* collectives (``_c10d_functional`` and ``c10d`` ops): bytes, counts and
  ring-model wire bytes (``_wire_bytes``, the reference's), the group
  size read from the op's process group; ``coll_wire_node`` keeps the
  wire bytes of groups whose ranks share one node (NVLink), the rest
  cross the network.

A DTensor op is not counted itself: the mode defers to DTensor, whose
local ops and collectives then pass through it, so every number is what
one rank runs on its local shards (per device, like post-SPMD HLO).  Eager
execution runs every loop iteration, so no trip-count multiplier exists:
a loop of n counts n times, and a ``lax.cond``-skipped block that the
port skips in Python is not counted at all (the reference's parser counts
every branch).  Under ``FakeTensorMode`` nothing is computed or
allocated and the counts are the same.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils.flop_counter as flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

CARDS_PER_NODE = 8      # H100 cards in one NVLink domain (an HGX node)

aten = torch.ops.aten


def _int_mm_flops(a_shape, b_shape, *args, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


FLOP_FORMULAS: Dict = {aten._int_mm: flop_counter.shape_wrapper(
    _int_mm_flops)}

TRANSCENDENTAL = {aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p,
                  aten.log2, aten.tanh, aten.rsqrt, aten.sqrt, aten.pow,
                  aten.sigmoid, aten.sin, aten.cos, aten.erf, aten.silu,
                  aten.gelu, aten._softmax, aten._log_softmax}


def _collectives() -> Dict:
    """op overload packet → (HLO collective kind, as ``hlo.COLLECTIVES``
    names it; whether the op writes into its first argument, as the
    ``c10d`` ops do, rather than return its result)."""
    out = {}
    for ns, names in (
            ("_c10d_functional", {
                "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}),
            ("c10d", {
                "allreduce_": "all-reduce",
                "allreduce_coalesced_": "all-reduce",
                "allgather_": "all-gather", "_allgather_base_": "all-gather",
                "allgather_into_tensor_coalesced_": "all-gather",
                "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter",
                "reduce_scatter_tensor_coalesced_": "reduce-scatter",
                "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                "send": "collective-permute", "recv_": "collective-permute",
                "broadcast_": "broadcast"})):
        space = getattr(torch.ops, ns)
        for name, kind in names.items():
            if hasattr(space, name):
                out[getattr(space, name)] = (kind, ns == "c10d")
    return out


COLLECTIVES = _collectives()


def _wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Ring-model bytes per device through its ICI links."""
    if kind == "all-reduce":
        return 2.0 * out_bytes * (group - 1) / group
    if kind == "all-gather":
        return out_bytes * (group - 1) / group
    if kind == "reduce-scatter":
        return out_bytes * (group - 1)        # input = out × group
    if kind == "all-to-all":
        return out_bytes * (group - 1) / group
    if kind == "collective-permute":
        return out_bytes
    return out_bytes


@dataclass
class ModuleCosts:
    flops: float = 0.0
    transcendentals: float = 0.0
    traffic: float = 0.0
    coll_wire: float = 0.0
    coll_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    coll_counts: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    # the port's additions: FLOPs by operand dtype, the wire bytes of
    # groups inside one node, and the calls of each matmul-class op
    flops_by_dtype: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    coll_wire_node: float = 0.0
    op_counts: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))

    def as_dict(self) -> Dict:
        return {k: dict(v) if isinstance(v, dict) else v
                for k, v in self.__dict__.items()}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _group(func, args) -> Tuple[int, bool]:
    """(size, whether its ranks share one node) of a collective's group:
    a ``ProcessGroup`` argument (``c10d``) or a group name (the last
    string argument, ``_c10d_functional``)."""
    pg = next((a for a in args if isinstance(a, dist.ProcessGroup)), None)
    if pg is None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = [a for a in args if isinstance(a, str)][-1]
        pg = _resolve_process_group(name)
    ranks = dist.get_process_group_ranks(pg)
    return len(ranks), len({r // CARDS_PER_NODE for r in ranks}) == 1


def _sharding_propagator():
    """DTensor's ``ShardingPropagator`` class and the name of its method
    that runs an op on fake global-shaped tensors to learn the output's
    shape, or (None, None) where this torch has no DTensor.  Raises where
    it has DTensor but neither method: the counter would then count each
    op's first call at each shape twice."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
    except ImportError:
        return None, None
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        if hasattr(ShardingPropagator, name):
            return ShardingPropagator, name
    raise RuntimeError(
        "torch.distributed.tensor's ShardingPropagator has neither "
        "_propagate_tensor_meta_non_cached nor _propagate_tensor_meta: "
        "CostCounter cannot tell its shape-propagation runs from a rank's "
        "own ops")


class CostCounter(TorchDispatchMode):
    """Tallies :class:`ModuleCosts` of the ops run under it (see the
    module note); ``.costs`` holds them.

    DTensor learns an op's output shape, the first time it meets the op
    at those shapes and placements, by running it once on global-shaped
    fake tensors; those runs are no rank's work, and the counter skips
    every op inside them.  With ``base_bytes`` given it also follows the
    bytes of the live tensors its ops make, on top of ``base_bytes``
    (what the caller holds already): ``.peak_bytes`` is the most that
    was live at once (views share their base's storage; a storage counts
    until its last tensor is freed)."""

    def __init__(self, base_bytes: Optional[int] = None):
        super().__init__()
        self.costs = ModuleCosts()
        self._flops = {**flop_counter.flop_registry, **FLOP_FORMULAS}
        self._shadow = 0
        self.memory = base_bytes is not None
        self.live_bytes = self.peak_bytes = base_bytes or 0
        self._live: Dict[int, object] = {}

    def __enter__(self):
        cls, name = _sharding_propagator()
        self._patched = None
        if cls is not None:
            orig = getattr(cls, name)

            def shadowed(prop, *args, **kwargs):
                self._shadow += 1
                try:
                    return orig(prop, *args, **kwargs)
                finally:
                    self._shadow -= 1
            setattr(cls, name, shadowed)
            self._patched = (cls, name, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._patched is not None:
            cls, name, orig = self._patched
            setattr(cls, name, orig)
        return super().__exit__(*exc)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = weakref.ref(
                st, lambda _, key=key, n=n: self._free(key, n))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        if self.memory:
            self._track(out)
        packet = func.overloadpacket
        c = self.costs
        if packet in self._flops:
            n = self._flops[packet](*args, **kwargs, out_val=out)
            first = next(t for t in tree_leaves(args)
                         if isinstance(t, torch.Tensor))
            c.flops += n
            c.flops_by_dtype[str(first.dtype).removeprefix("torch.")] += n
            c.traffic += _nbytes(args) + _nbytes(out)
            c.op_counts[str(packet)] += 1
        elif packet in TRANSCENDENTAL:
            c.transcendentals += sum(t.numel() for t in tree_leaves(out)
                                     if isinstance(t, torch.Tensor))
        elif packet in COLLECTIVES:
            kind, in_place = COLLECTIVES[packet]
            size = _nbytes(args[0] if in_place else out)
            group, in_node = _group(func, args)
            wire = _wire_bytes(kind, size, group)
            c.coll_bytes[kind] += size
            c.coll_counts[kind] += 1
            c.coll_wire += wire
            c.coll_wire_node += wire if in_node else 0.0
            c.traffic += size
        return out


def analyze(fn: Callable, *args, **kwargs) -> Tuple[object, ModuleCosts]:
    """``fn(*args, **kwargs)`` under a :class:`CostCounter` → (its
    result, the costs)."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.costs


def extrapolate(one: ModuleCosts, two: ModuleCosts,
                groups: int) -> ModuleCosts:
    """The costs of ``groups`` identical layer groups from the runs with
    one and with two: ``one + (groups - 1) × (two - one)``.  Exact where
    every count is affine in the number of groups (identical groups do
    identical work; what is done once per stacked leaf does not
    change)."""
    def lin(a, b):
        return a + (groups - 1) * (b - a)

    out = ModuleCosts()
    for k, a in one.__dict__.items():
        b = two.__dict__[k]
        if isinstance(a, dict):
            d = getattr(out, k)
            for key in set(a) | set(b):
                d[key] = lin(a.get(key, 0), b.get(key, 0))
        else:
            setattr(out, k, lin(a, b))
    return out
