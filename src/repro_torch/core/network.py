"""Network-level executor: whole CNNs through the layer-at-a-time IP core
(counterpart of ``repro.core.network``).

A ``NetworkPlan`` is a topologically ordered DAG of conv /
conv_transpose / pool / flatten / dense ``LayerSpec`` nodes plus
``add``/``concat`` merges.
``quantize_network`` calibrates per-layer activation scales with a float
forward pass and lowers every parametric layer to int8;
``make_int8_program`` turns the result into a callable x_f32 [N,H,W,C] →
logits [N,classes] that keeps every inter-layer map in int8: each conv
runs the fused ReLU → pool → requantize epilogue on the backend under its
per-layer ``TilePlan`` (a transposed conv through its stride-1 lowering,
planned on that geometry), dense heads run ``matmul_ws``.  PyTorch runs
eagerly, so the program is a plain function (no compile step).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields, replace
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import banking, perfmodel
from repro_torch.core.convcore import ConvCoreConfig, get_backend
from repro_torch.core.quantize import (act_scale_from_calibration,
                                       branch_requant_scale,
                                       quantize_symmetric, requant_scale)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.conv2d_ws_trans import transpose_eq_conv_geometry

# ---------------------------------------------------------------------------
# Layer graph
# ---------------------------------------------------------------------------

INPUT = "input"          # reserved node name: the network input
DEPTHWISE = -1           # LayerSpec.groups sentinel: groups = cin
PARAM_KINDS = ("conv", "conv_transpose", "dense")   # nodes that own weights


@dataclass(frozen=True)
class LayerSpec:
    """One node of a CNN graph.

    kind: "conv" | "conv_transpose" | "pool" | "avgpool" | "globalpool" |
    "flatten" | "dense" | "add" | "concat".  ``pool=True`` on a conv fuses
    the 2×2/2 max-pool into the kernel epilogue; ``groups`` is 1 (dense),
    ``DEPTHWISE`` (resolves to the input width) or any divisor; ``name``
    labels the node and ``inputs`` names its producers (empty: the
    previous layer; "input": the network input)."""
    kind: str
    features: int = 0                      # conv: K; dense: output dim
    kernel: Tuple[int, int] = (3, 3)
    stride: int = 1
    padding: ref.Padding = "SAME"
    relu: bool = False
    pool: bool = False                     # conv only: fused 2×2 max-pool
    size: int = 2                          # "pool"/"avgpool": window/stride
    groups: int = 1                        # conv only: 1=dense, −1=depthwise
    dilation: int = 1                      # conv kinds: kernel-tap spacing
    name: Optional[str] = None             # node label for skip references
    inputs: Tuple[str, ...] = ()           # () → previous layer


def conv_geometry(sp: LayerSpec, cin: int,
                  name: str = "?") -> Tuple[int, int]:
    """Resolve a conv node's (features, groups) given its input width."""
    groups = cin if sp.groups == DEPTHWISE else sp.groups
    features = sp.features if sp.features else (
        cin if sp.groups == DEPTHWISE else 0)
    if features <= 0:
        raise ValueError(f"node {name!r}: conv needs features > 0")
    if groups < 1 or cin % groups or features % groups:
        raise ValueError(
            f"node {name!r}: groups={groups} must divide both the input "
            f"channels C={cin} and the kernels K={features} "
            f"(groups == C is depthwise)")
    return features, groups


def _single(input: Optional[str]) -> Tuple[str, ...]:
    return () if input is None else (input,)


def conv(features: int, kernel: int = 3, stride: int = 1,
         padding: ref.Padding = "SAME", relu: bool = True,
         pool: bool = False, groups: int = 1, dilation: int = 1,
         name: Optional[str] = None,
         input: Optional[str] = None) -> LayerSpec:
    return LayerSpec("conv", features=features, kernel=(kernel, kernel),
                     stride=stride, padding=padding, relu=relu, pool=pool,
                     groups=groups, dilation=dilation, name=name,
                     inputs=_single(input))


def conv_transpose(features: int, kernel: int = 2, stride: int = 2,
                   padding: ref.Padding = "VALID", relu: bool = True,
                   pool: bool = False, groups: int = 1, dilation: int = 1,
                   name: Optional[str] = None,
                   input: Optional[str] = None) -> LayerSpec:
    """Transposed-conv (learned upsampling) node: ``stride`` is the output
    growth factor and ``padding`` names the forward conv it inverts."""
    return LayerSpec("conv_transpose", features=features,
                     kernel=(kernel, kernel), stride=stride, padding=padding,
                     relu=relu, pool=pool, groups=groups, dilation=dilation,
                     name=name, inputs=_single(input))


def depthwise(kernel: int = 3, stride: int = 1,
              padding: ref.Padding = "SAME", relu: bool = True,
              pool: bool = False, features: int = 0,
              name: Optional[str] = None,
              input: Optional[str] = None) -> LayerSpec:
    """Depthwise conv node (groups == input channels)."""
    return LayerSpec("conv", features=features, kernel=(kernel, kernel),
                     stride=stride, padding=padding, relu=relu, pool=pool,
                     groups=DEPTHWISE, name=name, inputs=_single(input))


def maxpool(size: int = 2, name: Optional[str] = None,
            input: Optional[str] = None) -> LayerSpec:
    return LayerSpec("pool", size=size, name=name, inputs=_single(input))


def avgpool(size: int = 2, name: Optional[str] = None,
            input: Optional[str] = None) -> LayerSpec:
    return LayerSpec("avgpool", size=size, name=name, inputs=_single(input))


def global_pool(name: Optional[str] = None,
                input: Optional[str] = None) -> LayerSpec:
    return LayerSpec("globalpool", name=name, inputs=_single(input))


def flatten(name: Optional[str] = None,
            input: Optional[str] = None) -> LayerSpec:
    return LayerSpec("flatten", name=name, inputs=_single(input))


def dense(features: int, relu: bool = False, name: Optional[str] = None,
          input: Optional[str] = None) -> LayerSpec:
    return LayerSpec("dense", features=features, relu=relu, name=name,
                     inputs=_single(input))


def add(a: str, b: str, relu: bool = False,
        name: Optional[str] = None) -> LayerSpec:
    """Residual merge of two same-shape branches."""
    return LayerSpec("add", relu=relu, name=name, inputs=(a, b))


def concat(*inputs: str, name: Optional[str] = None) -> LayerSpec:
    """Channel concat of ≥2 branches."""
    return LayerSpec("concat", name=name, inputs=tuple(inputs))


@dataclass(frozen=True)
class NetworkPlan:
    """A CNN graph over [H, W, C] inputs; ``layers`` is topologically
    ordered (every node's inputs are earlier nodes or the input)."""
    name: str
    input_shape: Tuple[int, int, int]          # (H, W, C)
    layers: Tuple[LayerSpec, ...]

    # -- graph resolution ---------------------------------------------------

    @functools.cached_property
    def _graph(self) -> Tuple[Tuple[str, ...], Tuple[Tuple[int, ...], ...]]:
        """(node names, resolved input indices), validated once."""
        explicit = {sp.name for sp in self.layers if sp.name}
        names: List[str] = []
        for i, sp in enumerate(self.layers):
            if sp.name:
                if sp.name == INPUT or sp.name in names:
                    raise ValueError(
                        f"duplicate or reserved node name {sp.name!r}")
                names.append(sp.name)
                continue
            nm = f"{sp.kind}{i}"
            while nm == INPUT or nm in explicit:
                nm += "_"
            names.append(nm)
        index = {nm: i for i, nm in enumerate(names)}
        out: List[Tuple[int, ...]] = []
        for i, sp in enumerate(self.layers):
            if sp.inputs:
                idxs = []
                for nm in sp.inputs:
                    if nm == INPUT:
                        idxs.append(-1)
                        continue
                    j = index.get(nm)
                    if j is None:
                        raise ValueError(
                            f"node {names[i]!r}: unknown input {nm!r}")
                    if j >= i:
                        raise ValueError(
                            f"node {names[i]!r}: input {nm!r} does not "
                            "precede it — layers must be topologically "
                            "ordered")
                    idxs.append(j)
                resolved = tuple(idxs)
            else:
                resolved = (i - 1,)
            if sp.kind == "add" and len(resolved) != 2:
                raise ValueError(f"node {names[i]!r}: add takes exactly two "
                                 f"inputs, got {len(resolved)}")
            if sp.kind == "concat" and len(resolved) < 2:
                raise ValueError(f"node {names[i]!r}: concat needs ≥2 inputs")
            if sp.kind not in ("add", "concat") and len(resolved) != 1:
                raise ValueError(f"node {names[i]!r}: {sp.kind} takes one "
                                 f"input, got {len(resolved)}")
            out.append(resolved)
        return tuple(names), tuple(out)

    def node_names(self) -> List[str]:
        return list(self._graph[0])

    def resolved_inputs(self) -> List[Tuple[int, ...]]:
        """Per-node input indices (−1 = the network input)."""
        return list(self._graph[1])

    # -- static shape / cost walks -----------------------------------------

    def activation_shapes(self) -> List[Tuple[int, ...]]:
        """Per-node output shapes (without the batch dim)."""
        names = self.node_names()
        ins = self.resolved_inputs()
        shapes: List[Tuple[int, ...]] = []

        def src(j: int) -> Tuple[int, ...]:
            return self.input_shape if j < 0 else shapes[j]

        for i, sp in enumerate(self.layers):
            s0 = src(ins[i][0])
            if sp.kind in ("conv", "conv_transpose"):
                if len(s0) != 3:
                    raise ValueError(f"node {names[i]!r}: conv after flatten")
                kh, kw = sp.kernel
                k_, _ = conv_geometry(sp, s0[2], names[i])
                shape_of = (ref.conv_transpose_out_shape
                            if sp.kind == "conv_transpose"
                            else ref.conv_out_shape)
                h, w = shape_of(s0[0], s0[1], kh, kw, sp.stride, sp.padding,
                                sp.dilation)
                if sp.pool:
                    if h < 2 or w < 2:
                        raise ValueError(
                            f"node {names[i]!r}: 2×2 pool needs a ≥2×2 "
                            f"conv output, got {h}×{w}")
                    h, w = h // 2, w // 2
                shapes.append((h, w, k_))
            elif sp.kind in ("pool", "avgpool", "globalpool", "flatten"):
                if len(s0) != 3:
                    raise ValueError(f"node {names[i]!r}: {sp.kind} needs "
                                     f"an [H,W,C] input, got shape {s0}")
                h, w, c = s0
                if sp.kind == "globalpool":
                    shapes.append((c,))
                elif sp.kind == "flatten":
                    shapes.append((h * w * c,))
                else:
                    shapes.append(((h - sp.size) // sp.size + 1,
                                   (w - sp.size) // sp.size + 1, c))
            elif sp.kind == "dense":
                if len(s0) != 1:
                    raise ValueError(f"node {names[i]!r}: dense before "
                                     "flatten/globalpool")
                shapes.append((sp.features,))
            elif sp.kind == "add":
                branches = [src(j) for j in ins[i]]
                if len(set(branches)) != 1:
                    raise ValueError(f"node {names[i]!r}: add branches "
                                     f"disagree on shape: {branches}")
                shapes.append(branches[0])
            elif sp.kind == "concat":
                branches = [src(j) for j in ins[i]]
                if any(len(b) != 3 for b in branches) or \
                        len({b[:2] for b in branches}) != 1:
                    raise ValueError(f"node {names[i]!r}: concat branches "
                                     f"must share H×W: {branches}")
                shapes.append((*branches[0][:2],
                               sum(b[2] for b in branches)))
            else:
                raise ValueError(f"unknown layer kind {sp.kind!r}")
        return shapes

    def _input_shape_of(self, i: int, acts) -> Tuple[int, ...]:
        j = self.resolved_inputs()[i][0]
        return self.input_shape if j < 0 else acts[j]

    def param_shapes(self) -> List[Optional[dict]]:
        """Per-node {"w": ..., "b": ...} shapes (None for parameter-free
        nodes); grouped convs carry the per-group channel slice."""
        acts = self.activation_shapes()
        shapes: List[Optional[dict]] = []
        for i, sp in enumerate(self.layers):
            s0 = self._input_shape_of(i, acts)
            if sp.kind in ("conv", "conv_transpose"):
                kh, kw = sp.kernel
                k_, g_ = conv_geometry(sp, s0[2])
                shapes.append({"w": (kh, kw, s0[2] // g_, k_),
                               "b": (k_,)})
            elif sp.kind == "dense":
                shapes.append({"w": (s0[0], sp.features),
                               "b": (sp.features,)})
            else:
                shapes.append(None)
        return shapes

    def init_params(self, rng: np.random.Generator,
                    device: DeviceLike = None) -> List[Optional[dict]]:
        """He-initialized float32 parameters drawn from ``rng`` — the same
        draws, in the same order, as the reference's ``init_params``."""
        dev = resolve_device(device)
        params: List[Optional[dict]] = []
        for shp in self.param_shapes():
            if shp is None:
                params.append(None)
                continue
            fan_in = int(np.prod(shp["w"][:-1]))
            std = math.sqrt(2.0 / fan_in)
            w = (rng.normal(size=shp["w"]) * std).astype(np.float32)
            b = (rng.normal(size=shp["b"]) * 0.05).astype(np.float32)
            params.append({"w": torch.from_numpy(w).to(dev),
                           "b": torch.from_numpy(b).to(dev)})
        return params

    def psum_table(self) -> List[Tuple[str, int]]:
        """Per-node psum counts in the paper's accounting (conv: output
        pixels × kernels × group channels; transposed conv: the
        zero-skipping count, input pixels × kernels × group channels;
        dense: in × out; others 0)."""
        names = self.node_names()
        acts = self.activation_shapes()
        rows: List[Tuple[str, int]] = []
        for i, sp in enumerate(self.layers):
            s0 = self._input_shape_of(i, acts)
            if sp.kind == "conv":
                kh, kw = sp.kernel
                k_, g_ = conv_geometry(sp, s0[2], names[i])
                rows.append((names[i], perfmodel.psum_count(
                    s0[0], s0[1], s0[2], k_, kh, kw, sp.stride,
                    sp.padding, groups=g_, dilation=sp.dilation)))
            elif sp.kind == "conv_transpose":
                kh, kw = sp.kernel
                k_, g_ = conv_geometry(sp, s0[2], names[i])
                rows.append((names[i], perfmodel.conv_transpose_psum_count(
                    s0[0], s0[1], s0[2], k_, kh, kw, sp.stride,
                    sp.padding, groups=g_, dilation=sp.dilation)))
            elif sp.kind == "dense":
                rows.append((names[i], s0[0] * sp.features))
            else:
                rows.append((names[i], 0))
        return rows

    def tile_plans(self, cin_banks: int = 4, kout_banks: int = 4,
                   in_bytes: int = 1,
                   smem_budget: Optional[int] = banking.SMEM_BYTES,
                   kernel: str = "auto"
                   ) -> List[Optional[banking.TilePlan]]:
        """Per-node tile × bank plans (None for nodes without a conv); the
        final parametric layer keeps a 4-byte epilogue output, every other
        conv writes int8 (at ``in_bytes``).  A transposed conv is planned
        on its equivalent stride-1 conv (``transpose_eq_conv_geometry``),
        the geometry its lowering launches."""
        last_param = max((i for i, sp in enumerate(self.layers)
                          if sp.kind in PARAM_KINDS), default=-1)
        acts = self.activation_shapes()
        plans: List[Optional[banking.TilePlan]] = []
        for i, sp in enumerate(self.layers):
            if sp.kind not in ("conv", "conv_transpose"):
                plans.append(None)
                continue
            h, w, c = self._input_shape_of(i, acts)
            kh, kw = sp.kernel
            k_, g_ = conv_geometry(sp, c)
            cb_n, kb_n = banking.grouped_banks(
                c, k_, g_, want_cin=cin_banks, want_kout=kout_banks)
            stride, pad = sp.stride, sp.padding
            if sp.kind == "conv_transpose":
                h, w, pad = transpose_eq_conv_geometry(
                    h, w, kh, kw, sp.stride, sp.padding, sp.dilation)
                stride = 1
            plans.append(banking.plan_tiles(
                h, w, c, k_, kh, kw, stride=stride,
                padding=pad, pool=sp.pool, groups=g_,
                dilation=sp.dilation, in_bytes=in_bytes,
                out_bytes=4 if i == last_param else in_bytes,
                cin_banks=cb_n, kout_banks=kb_n,
                smem_budget=smem_budget, kernel=kernel))
        return plans

    def conv_geometries(self) -> List[Optional[Tuple[int, int]]]:
        """Per-node resolved (features, groups) for conv and transposed
        conv nodes."""
        names = self.node_names()
        acts = self.activation_shapes()
        out: List[Optional[Tuple[int, int]]] = []
        for i, sp in enumerate(self.layers):
            if sp.kind not in ("conv", "conv_transpose"):
                out.append(None)
                continue
            s0 = self._input_shape_of(i, acts)
            out.append(conv_geometry(sp, s0[2], names[i]))
        return out

    # -- execution ----------------------------------------------------------

    def forward_activations(self, params: Sequence[Optional[dict]],
                            x: torch.Tensor):
        """Yield (index, spec, layer_params, activation) through the float
        oracle in graph order; each activation is released after its last
        consumer."""
        self.activation_shapes()               # validates the graph
        ins = self.resolved_inputs()
        last_use = {}
        for i, idxs in enumerate(ins):
            for j in idxs:
                if j >= 0:
                    last_use[j] = i
        acts: List[Optional[torch.Tensor]] = []
        for i, (sp, p) in enumerate(zip(self.layers, params)):
            src = [x if j < 0 else acts[j] for j in ins[i]]
            h = src[0]
            if sp.kind == "conv":
                _, g_ = conv_geometry(sp, h.shape[-1])
                h = ref.conv2d_epilogue_ref(
                    h, p["w"], p["b"], stride=sp.stride, padding=sp.padding,
                    relu=sp.relu, pool=sp.pool, groups=g_,
                    dilation=sp.dilation)
            elif sp.kind == "conv_transpose":
                _, g_ = conv_geometry(sp, h.shape[-1])
                h = ref.conv2d_transpose_epilogue_ref(
                    h, p["w"], p["b"], stride=sp.stride, padding=sp.padding,
                    relu=sp.relu, pool=sp.pool, groups=g_,
                    dilation=sp.dilation)
            elif sp.kind == "pool":
                h = ref.maxpool2d_ref(h, sp.size)
            elif sp.kind == "avgpool":
                h = ref.avgpool2d_ref(h, sp.size)
            elif sp.kind == "globalpool":
                h = ref.global_avgpool_ref(h)
            elif sp.kind == "flatten":
                h = h.reshape(h.shape[0], -1)
            elif sp.kind == "dense":
                h = ref.matmul_ref(h, p["w"], p["b"])
                if sp.relu:
                    h = torch.clamp(h, min=0)
            elif sp.kind == "add":
                h = src[0] + src[1]
                if sp.relu:
                    h = torch.clamp(h, min=0)
            elif sp.kind == "concat":
                h = torch.cat(src, dim=-1)
            acts.append(h)
            for j in ins[i]:
                if j >= 0 and last_use[j] == i:
                    acts[j] = None               # last consumer passed
            yield i, sp, p, h

    def apply_ref(self, params: Sequence[Optional[dict]],
                  x: torch.Tensor) -> torch.Tensor:
        """Float oracle forward pass."""
        for _, _, _, x in self.forward_activations(params, x):
            pass
        return x


# ---------------------------------------------------------------------------
# int8 network quantization + compilation
# ---------------------------------------------------------------------------


def program_tile_plans(plan: NetworkPlan, core_config) -> List:
    """The per-layer TilePlans a ``make_int8_program`` build runs under."""
    return plan.tile_plans(
        cin_banks=core_config.cin_banks,
        kout_banks=core_config.kout_banks, in_bytes=1,
        smem_budget=core_config.smem_budget,
        kernel=core_config.kernel)


@dataclass(frozen=True)
class QuantizedNetwork:
    """A NetworkPlan lowered to the 8-bit datapath: per parametric layer
    int8 weights, an int32 bias at scale ``s_in·s_w`` and the requant
    scale onto the next layer's grid (None for the final parametric
    layer, whose accumulator dequantizes with ``out_dequant``); per merge
    node the per-branch requant scales.  Per-channel weight scales make
    the bias / requant / dequant entries [K] vectors."""
    plan: NetworkPlan
    weights: Tuple[Optional[torch.Tensor], ...]       # int8
    biases: Tuple[Optional[torch.Tensor], ...]        # int32
    requants: Tuple[Optional[torch.Tensor], ...]      # f32 scalar or [K]
    in_scale: torch.Tensor                            # input activation scale
    out_dequant: torch.Tensor                         # final accumulator scale
    per_channel: bool = False
    merge_scales: Tuple[Optional[Tuple[torch.Tensor, ...]], ...] = ()

    def to(self, device: DeviceLike) -> "QuantizedNetwork":
        """A copy with every tensor on ``device``."""
        dev = resolve_device(device)

        def mv(v):
            if isinstance(v, torch.Tensor):
                return v.to(dev)
            if isinstance(v, tuple):
                return tuple(mv(e) for e in v)
            return v

        return replace(self, **{f.name: mv(getattr(self, f.name))
                                for f in fields(self) if f.name != "plan"})


def quantize_network(plan: NetworkPlan, params: Sequence[Optional[dict]],
                     calib_x: torch.Tensor,
                     per_channel: bool = False) -> QuantizedNetwork:
    """Calibrate activation scales with a float forward pass over
    ``calib_x`` and lower every parametric layer to int8 (symmetric
    weights, per tensor or per output channel).  Merge nodes calibrate a
    shared output scale and carry per-branch requant scales.  The result
    lives on ``calib_x``'s device."""
    last_param = max(i for i, sp in enumerate(plan.layers)
                     if sp.kind in PARAM_KINDS)
    ins = plan.resolved_inputs()
    in_scale = act_scale_from_calibration(calib_x)
    node_scale: List[Optional[torch.Tensor]] = []

    def scale_of(j: int) -> torch.Tensor:
        s = in_scale if j < 0 else node_scale[j]
        if s is None:
            raise ValueError("graph consumes the dequantized float output "
                             "of the final parametric layer")
        return s

    weights, biases, requants, merges = [], [], [], []
    out_dequant = torch.tensor(1.0, dtype=torch.float32,
                               device=calib_x.device)
    for i, sp, p, x in plan.forward_activations(params, calib_x):
        w_ = b_ = rq = ms = None
        if sp.kind in PARAM_KINDS:
            s_act = scale_of(ins[i][0])
            if per_channel:
                wq = quantize_symmetric(p["w"],
                                        axis=tuple(range(p["w"].dim() - 1)))
                w_scale = wq.scale.reshape(-1)
            else:
                wq = quantize_symmetric(p["w"])
                w_scale = wq.scale
            acc_scale = s_act * w_scale               # int32 psum units
            w_ = wq.values
            b_ = torch.round(p["b"].to(torch.float32) / acc_scale).to(
                torch.int32)
            if i == last_param:
                out_dequant = acc_scale
                node_scale.append(None)
            else:
                s_next = act_scale_from_calibration(x)
                rq = requant_scale(s_act, w_scale, s_next)
                node_scale.append(s_next)
        elif sp.kind in ("add", "concat"):
            s_out = act_scale_from_calibration(x)
            ms = tuple(branch_requant_scale(scale_of(j), s_out)
                       for j in ins[i])
            node_scale.append(s_out)
        else:
            # pooling / flatten keep their input's int8 grid
            node_scale.append(in_scale if ins[i][0] < 0
                              else node_scale[ins[i][0]])
        weights.append(w_)
        biases.append(b_)
        requants.append(rq)
        merges.append(ms)
    return QuantizedNetwork(plan, tuple(weights), tuple(biases),
                            tuple(requants), in_scale, out_dequant,
                            per_channel=per_channel,
                            merge_scales=tuple(merges))


def int8_forward(qnet: QuantizedNetwork, x: torch.Tensor, *, backend,
                 tile_plans: Sequence, node_hook=None) -> torch.Tensor:
    """The int8 forward walk: quantize the input onto the calibrated grid
    (f32 division, round half to even), run every node in topological
    order through ``backend``, return the final activation.
    ``node_hook(i, name, spec, activation)`` is called after each node
    (the per-layer profiler synchronizes and clocks there)."""
    plan = qnet.plan
    ins = plan.resolved_inputs()
    geoms = plan.conv_geometries()
    merges = qnet.merge_scales or (None,) * len(plan.layers)
    names = plan.node_names() if node_hook is not None else None
    qin = torch.round(x.to(torch.float32) / qnet.in_scale).clamp(
        -128, 127).to(torch.int8)
    acts: List[torch.Tensor] = []
    for i, (sp, w, b, rq, ms, tp) in enumerate(zip(
            plan.layers, qnet.weights, qnet.biases, qnet.requants,
            merges, tile_plans)):
        src = [qin if j < 0 else acts[j] for j in ins[i]]
        h = src[0]
        if sp.kind in ("conv", "conv_transpose"):
            op = (backend.conv_transpose if sp.kind == "conv_transpose"
                  else backend.conv)
            h = op(h, w, b, stride=sp.stride, padding=sp.padding,
                   groups=geoms[i][1], dilation=sp.dilation, relu=sp.relu,
                   pool=sp.pool, out_scale=rq, plan=tp)
            if rq is None:                       # final conv: dequantize
                h = h.to(torch.float32) * qnet.out_dequant
        elif sp.kind == "pool":
            h = ref.maxpool2d_ref(h, sp.size)     # commutes with the grid
        elif sp.kind == "avgpool":
            h = ref.avgpool2d_ref(h, sp.size)     # mean rounds onto the grid
        elif sp.kind == "globalpool":
            h = ref.global_avgpool_ref(h)
        elif sp.kind == "flatten":
            h = h.reshape(h.shape[0], -1)
        elif sp.kind == "dense":
            acc = backend.matmul(h, w, b)        # int32
            if sp.relu:
                acc = torch.clamp(acc, min=0)
            if rq is None:
                h = acc.to(torch.float32) * qnet.out_dequant
            else:
                h = ref.requantize_ref(acc, rq)
        elif sp.kind == "add":
            h = ref.add_requant_ref(src[0], src[1], ms[0], ms[1],
                                    relu=sp.relu)
        elif sp.kind == "concat":
            h = torch.cat([ref.requantize_ref(s, m) for s, m in zip(src, ms)],
                          dim=-1)
        acts.append(h)
        if node_hook is not None:
            node_hook(i, names[i], sp, h)
    return acts[-1]


def make_int8_program(qnet: QuantizedNetwork,
                      core_config: ConvCoreConfig = ConvCoreConfig(int8=True),
                      tile_plans: Optional[Sequence] = None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The quantized network as a callable x_f32 [N,H,W,C] → logits
    [N,classes] on the qnet's device.  ``tile_plans`` overrides the
    per-layer plans (one entry per node, None for non-conv nodes)."""
    backend = get_backend(core_config.backend)
    plan = qnet.plan
    merges = qnet.merge_scales or (None,) * len(plan.layers)
    if tile_plans is None:
        tile_plans = program_tile_plans(plan, core_config)
    if len(tile_plans) != len(plan.layers):
        raise ValueError(f"tile_plans needs one entry per node "
                         f"({len(plan.layers)}), got {len(tile_plans)}")
    if len(merges) != len(plan.layers):
        raise ValueError(f"merge_scales needs one entry per node "
                         f"({len(plan.layers)}), got {len(merges)}")

    def program(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return int8_forward(qnet, x, backend=backend,
                                tile_plans=tile_plans)

    return program


# ---------------------------------------------------------------------------
# Reference network zoo (the reference's shapes, unchanged)
# ---------------------------------------------------------------------------


def lenet(input_shape: Tuple[int, int, int] = (28, 28, 1),
          classes: int = 10) -> NetworkPlan:
    """LeNet-style grayscale classifier: SAME padding, fused conv+pool
    epilogues, a stride-2 conv and int8 dense layers."""
    return NetworkPlan(
        name="lenet", input_shape=input_shape,
        layers=(
            conv(8, kernel=3, padding="SAME", relu=True, pool=True),
            conv(16, kernel=3, padding="SAME", relu=True, pool=True),
            conv(32, kernel=3, stride=2, padding="SAME", relu=True),
            flatten(),
            dense(64, relu=True),
            dense(classes),
        ))


def vgg_small(input_shape: Tuple[int, int, int] = (32, 32, 4),
              classes: int = 10) -> NetworkPlan:
    """VGG-style stacked 3×3 blocks (conv-conv-pool)."""
    return NetworkPlan(
        name="vgg_small", input_shape=input_shape,
        layers=(
            conv(16, relu=True), conv(16, relu=True, pool=True),
            conv(32, relu=True), conv(32, relu=True, pool=True),
            conv(64, relu=True, pool=True),
            flatten(),
            dense(128, relu=True),
            dense(classes),
        ))


def vgg_imagenet(input_shape: Tuple[int, int, int] = (224, 224, 4),
                 classes: int = 1000) -> NetworkPlan:
    """ImageNet-scale VGG-style pyramid over 224×224 inputs with a global
    average pool + one dense head; the early layers stream through halo'd
    spatial tiles."""
    return NetworkPlan(
        name="vgg_imagenet", input_shape=input_shape,
        layers=(
            conv(32, relu=True), conv(32, relu=True, pool=True),   # 112
            conv(64, relu=True, pool=True),                        # 56
            conv(128, relu=True, pool=True),                       # 28
            conv(256, relu=True, pool=True),                       # 14
            conv(256, relu=True),
            global_pool(),
            dense(classes),
        ))


def large_map(input_shape: Tuple[int, int, int] = (512, 512, 16),
              classes: int = 4) -> NetworkPlan:
    """Segmentation-scale feature maps that only run tiled."""
    return NetworkPlan(
        name="large_map", input_shape=input_shape,
        layers=(
            conv(64, relu=True, pool=True),                        # 256
            conv(32, stride=2, relu=True, pool=True),              # 64
            conv(32, stride=2, relu=True),                         # 32
            avgpool(2),                                            # 16
            global_pool(),
            dense(classes),
        ))


def _basic_block(i: int, src: str, k: int, stride: int,
                 project: Optional[bool] = None) -> List[LayerSpec]:
    """ResNet basic block: conv-conv plus an identity or 1×1 projection
    skip."""
    if project is None:
        project = stride != 1
    blk = [
        conv(k, stride=stride, relu=True, name=f"b{i}c1", input=src),
        conv(k, relu=False, name=f"b{i}c2"),
    ]
    skip = src
    if project:
        blk.append(conv(k, kernel=1, stride=stride, relu=False,
                        name=f"b{i}p", input=src))
        skip = f"b{i}p"
    blk.append(add(skip, f"b{i}c2", relu=True, name=f"b{i}"))
    return blk


def resnet_small(input_shape: Tuple[int, int, int] = (32, 32, 4),
                 classes: int = 10) -> NetworkPlan:
    """ResNet-style residual classifier (identity + projection skips)."""
    layers: List[LayerSpec] = [conv(16, relu=True, name="stem")]
    layers += _basic_block(1, "stem", 16, 1)
    layers += _basic_block(2, "b1", 32, 2)                      # 16×16
    layers += _basic_block(3, "b2", 64, 2)                      # 8×8
    layers += [global_pool(), dense(classes)]
    return NetworkPlan(name="resnet_small", input_shape=input_shape,
                       layers=tuple(layers))


def _ds_block(i: int, k: int, stride: int = 1) -> List[LayerSpec]:
    """MobileNet-v1 depthwise-separable block: 3×3 depthwise + 1×1."""
    return [
        depthwise(stride=stride, relu=True, name=f"d{i}"),
        conv(k, kernel=1, relu=True, name=f"p{i}"),
    ]


def mobilenet_small(input_shape: Tuple[int, int, int] = (16, 16, 4),
                    classes: int = 10) -> NetworkPlan:
    """MobileNet-v1-style depthwise-separable classifier."""
    layers: List[LayerSpec] = [conv(8, relu=True, name="stem")]
    layers += _ds_block(1, 16)
    layers += _ds_block(2, 32, stride=2)                        # 8×8
    layers += _ds_block(3, 32)
    layers += [global_pool(), dense(classes)]
    return NetworkPlan(name="mobilenet_small", input_shape=input_shape,
                       layers=tuple(layers))


def _inverted_residual(i: int, src: str, cin: int, out: int, stride: int,
                       expand: int = 2) -> List[LayerSpec]:
    """MobileNet-v2 inverted residual: 1×1 expand → 3×3 depthwise → linear
    1×1 project, with an identity skip when the block keeps shape."""
    blk = [
        conv(cin * expand, kernel=1, relu=True, name=f"m{i}e", input=src),
        depthwise(stride=stride, relu=True, name=f"m{i}d"),
        conv(out, kernel=1, relu=False, name=f"m{i}p"),
    ]
    if stride == 1 and cin == out:
        blk.append(add(src, f"m{i}p", name=f"m{i}"))
    return blk


def mobilenet_v2ish(input_shape: Tuple[int, int, int] = (16, 16, 4),
                    classes: int = 10) -> NetworkPlan:
    """MobileNet-v2-style inverted-residual classifier."""
    layers: List[LayerSpec] = [conv(8, relu=True, name="stem")]
    layers += _inverted_residual(1, "stem", 8, 8, 1)            # skip add
    layers += _inverted_residual(2, "m1", 8, 16, 2)             # 8×8
    layers += _inverted_residual(3, "m2p", 16, 16, 1)           # skip add
    layers += [global_pool(), dense(classes)]
    return NetworkPlan(name="mobilenet_v2ish", input_shape=input_shape,
                       layers=tuple(layers))


def resnet_bottleneck(input_shape: Tuple[int, int, int] = (32, 32, 8),
                      classes: int = 10) -> NetworkPlan:
    """Bottleneck-residual variant: 1×1 reduce → 3×3 → 1×1 expand with
    projection shortcuts."""
    def bottleneck(i: int, src: str, mid: int, out: int,
                   stride: int) -> List[LayerSpec]:
        return [
            conv(mid, kernel=1, stride=stride, relu=True, name=f"b{i}r",
                 input=src),
            conv(mid, relu=True, name=f"b{i}c"),
            conv(out, kernel=1, relu=False, name=f"b{i}e"),
            conv(out, kernel=1, stride=stride, relu=False, name=f"b{i}p",
                 input=src),
            add(f"b{i}p", f"b{i}e", relu=True, name=f"b{i}"),
        ]

    layers: List[LayerSpec] = [conv(16, relu=True, name="stem")]
    layers += bottleneck(1, "stem", 8, 32, 1)
    layers += bottleneck(2, "b1", 16, 64, 2)                    # 16×16
    layers += [global_pool(), dense(classes)]
    return NetworkPlan(name="resnet_bottleneck", input_shape=input_shape,
                       layers=tuple(layers))


def unet_small(input_shape: Tuple[int, int, int] = (16, 16, 4),
               classes: int = 3) -> NetworkPlan:
    """U-Net-style encoder–decoder segmenter: conv_transpose upsampling
    and skip concats, per-pixel logits."""
    return NetworkPlan(
        name="unet_small", input_shape=input_shape,
        layers=(
            conv(8, relu=True, name="enc1"),                       # 16×16
            conv(16, stride=2, relu=True, name="down1"),           # 8×8
            conv(16, relu=True, name="enc2"),
            conv(32, stride=2, relu=True, name="down2"),           # 4×4
            conv(32, relu=True, name="bott"),
            conv_transpose(16, kernel=2, stride=2, relu=True,
                           name="up1"),                            # 8×8
            concat("up1", "enc2", name="cat1"),
            conv(16, relu=True, name="dec1"),
            conv_transpose(8, kernel=2, stride=2, relu=True,
                           name="up2"),                            # 16×16
            concat("up2", "enc1", name="cat2"),
            conv(8, relu=True, name="dec2"),
            conv(classes, kernel=1, relu=False, name="head"),
        ))


def dilated_context(input_shape: Tuple[int, int, int] = (16, 16, 4),
                    classes: int = 3) -> NetworkPlan:
    """Dilated-context segmenter: SAME 3×3 convs at dilation 1 → 2 → 4 and
    a 1×1 per-pixel head."""
    return NetworkPlan(
        name="dilated_context", input_shape=input_shape,
        layers=(
            conv(8, relu=True, name="stem"),
            conv(8, relu=True, dilation=2, name="ctx2"),
            conv(16, relu=True, dilation=4, name="ctx4"),
            conv(16, relu=True, name="fuse"),
            conv(classes, kernel=1, relu=False, name="head"),
        ))
