"""ConvCore — the paper's IP core as a PyTorch module (counterpart of
``repro.core.convcore``).

The core processes one convolutional layer at a time: a C-channel feature
map and K kernels in, a K-channel map out, with the bias preloaded into
the accumulator and the fused ReLU → 2×2 max-pool → requantize epilogue.
``ConvCore.plan`` returns the joint ``banking.TilePlan`` the layer runs
under, sized for Hopper shared memory.

Backends implement ``Backend`` and live in a registry
(``register_backend`` adds the scheduler's sharded backends under their
names):

* ``"cuda"`` — the hand-written kernels through ``kernels.ops``; it
  dispatches each conv and transposed conv on ``TilePlan.pipelined``
  (``conv2d_ws_pipe`` or ``conv2d_ws``).  On CPU tensors the kernels'
  plain versions run;
* ``"ref"``  — the plain PyTorch oracles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Protocol

import torch

from repro_torch.core import banking
from repro_torch.core.quantize import quantize_symmetric
from repro_torch.kernels import ops, ref


class Backend(Protocol):
    """One implementation of the IP-core ops (conv, transposed conv and
    the dense GEMM).  ``plan`` is a ``banking.TilePlan`` (None → whole map
    under the paper's 4×4 banking, degraded to legal divisors); a
    transposed conv's plan is sized on its equivalent stride-1 conv."""

    name: str

    def conv(self, x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None, *, stride: int = 1,
             padding="VALID", groups: int = 1, dilation: int = 1,
             relu: bool = False, pool: bool = False, out_scale=None,
             wrap8: bool = False,
             plan: Optional[banking.TilePlan] = None) -> torch.Tensor:
        ...

    def conv_transpose(self, x: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *,
                       stride: int = 1, padding="VALID", groups: int = 1,
                       dilation: int = 1, relu: bool = False,
                       pool: bool = False, out_scale=None,
                       plan: Optional[banking.TilePlan] = None
                       ) -> torch.Tensor:
        ...

    def matmul(self, x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        ...


class RefBackend:
    """Plain PyTorch oracles — the correctness contract for the kernels."""

    name = "ref"

    def conv(self, x, w, bias=None, *, stride=1, padding="VALID",
             groups=1, dilation=1, relu=False, pool=False, out_scale=None,
             wrap8=False, plan=None):
        if wrap8:
            # the epilogue runs on the int32 accumulator, then the result
            # wraps to 8 bits, as ops.conv2d does after the kernel
            if out_scale is not None:
                raise ValueError("wrap8 and out_scale are mutually "
                                 "exclusive: the Fig. 6 wrap path has no "
                                 "requantize stage")
            if x.dtype != torch.int8:
                raise TypeError(f"wrap8 takes int8 operands, got {x.dtype}")
            return ref.conv2d_epilogue_ref(
                x, w, bias, stride=stride, padding=padding, relu=relu,
                pool=pool, groups=groups, dilation=dilation).to(torch.int8)
        return ref.conv2d_epilogue_ref(x, w, bias, stride=stride,
                                       padding=padding, relu=relu,
                                       pool=pool, out_scale=out_scale,
                                       groups=groups, dilation=dilation)

    def conv_transpose(self, x, w, bias=None, *, stride=1, padding="VALID",
                       groups=1, dilation=1, relu=False, pool=False,
                       out_scale=None, plan=None):
        return ref.conv2d_transpose_epilogue_ref(
            x, w, bias, stride=stride, padding=padding, relu=relu,
            pool=pool, out_scale=out_scale, groups=groups,
            dilation=dilation)

    def matmul(self, x, w, bias=None):
        if x.dtype == torch.int8:
            return ref.matmul_ref_int8(x, w, bias)
        return ref.matmul_ref(x, w, bias)


class CudaBackend:
    """The hand-written Hopper kernels (counterpart of ``PallasBackend``)."""

    name = "cuda"

    @staticmethod
    def _plan_args(x, w, groups, plan) -> dict:
        if plan is not None:
            cin_banks, kout_banks = plan.cin_banks, plan.kout_banks
        else:
            cin_banks, kout_banks = ref.grouped_banks(
                x.shape[-1], w.shape[-1], groups)
        return dict(cin_banks=cin_banks, kout_banks=kout_banks,
                    h_tile=plan.h_tile if plan else 0,
                    w_tile=plan.w_tile if plan else 0,
                    pipelined=plan.pipelined if plan else False)

    def conv(self, x, w, bias=None, *, stride=1, padding="VALID",
             groups=1, dilation=1, relu=False, pool=False, out_scale=None,
             wrap8=False, plan=None):
        return ops.conv2d(x, w, bias, stride=stride, padding=padding,
                          groups=groups, relu=relu, pool=pool,
                          out_scale=out_scale, wrap8=wrap8,
                          dilation=dilation,
                          **self._plan_args(x, w, groups, plan))

    def conv_transpose(self, x, w, bias=None, *, stride=1, padding="VALID",
                       groups=1, dilation=1, relu=False, pool=False,
                       out_scale=None, plan=None):
        return ops.conv2d_transpose(
            x, w, bias, stride=stride, padding=padding, groups=groups,
            relu=relu, pool=pool, out_scale=out_scale, dilation=dilation,
            **self._plan_args(x, w, groups, plan))

    def matmul(self, x, w, bias=None):
        return ops.matmul_ws(x, w, bias)


BACKENDS: Dict[str, Backend] = {"ref": RefBackend(), "cuda": CudaBackend()}


def get_backend(name: str) -> Backend:
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; have {sorted(BACKENDS)}") from None


def register_backend(backend: Backend) -> None:
    """Add ``backend`` to the registry under ``backend.name`` (the
    scheduler's sharded backends, e.g. ``"cuda@kout4"``)."""
    BACKENDS[backend.name] = backend


def unregister_backend(name: str) -> None:
    """Remove a registered backend (no-op if absent); tests that register
    sharded backends remove them again."""
    BACKENDS.pop(name, None)


@dataclass(frozen=True)
class ConvCoreConfig:
    cin_banks: int = 4            # paper: 4 image BMGs / computing cores (M1)
    kout_banks: int = 4           # paper: 4 PCOREs per core (M2)
    backend: str = "cuda"         # a BACKENDS registry key
    int8: bool = False            # the paper's 8-bit datapath
    wrap8: bool = False           # bit-faithful 8-bit psum wrap (Fig. 6)
    auto_bank: bool = True        # fit spatial tiles + banks to smem_budget;
                                  # False: the whole map as one tile
    smem_budget: int = banking.SMEM_BYTES   # per-block shared memory
    kernel: str = "auto"          # per layer: "auto" (crossover model),
                                  # "pipelined" or "sequential"
    calib: Optional[object] = None  # core.calibration.CalibrationTable:
                                  # fitted terms for the "auto" crossover;
                                  # None: the analytic §5.2 model


class ConvCore:
    """One paper IP core.  Use ``apply_layer`` per convolutional layer."""

    def __init__(self, config: ConvCoreConfig = ConvCoreConfig()):
        self.config = config

    def plan(self, x_shape, w_shape, stride: int = 1, padding="VALID",
             *, pool: bool = False, groups: int = 1,
             out_bytes: Optional[int] = None) -> banking.TilePlan:
        """Joint spatial-tile × channel-bank plan for one layer.  With
        ``auto_bank`` tiles shrink / banks grow until the working set fits
        ``smem_budget``; without it the whole map is one tile under the
        configured banking (the seed dataflow; the kernels size their own
        blocks, so it runs all the same)."""
        n, h, w_, c = x_shape
        kh, kw, _, k = w_shape
        cfg = self.config
        cb_n, kb_n = banking.grouped_banks(
            c, k, groups, want_cin=cfg.cin_banks, want_kout=cfg.kout_banks)
        return banking.plan_tiles(
            h, w_, c, k, kh, kw, stride=stride, padding=padding, pool=pool,
            groups=groups, in_bytes=1 if cfg.int8 else 4, acc_bytes=4,
            out_bytes=out_bytes, cin_banks=cb_n, kout_banks=kb_n,
            smem_budget=cfg.smem_budget if cfg.auto_bank else None,
            kernel=cfg.kernel, calib=cfg.calib)

    def apply_layer(self, x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    out_scale=None, *, stride: int = 1, padding="VALID",
                    groups: int = 1, relu: bool = False,
                    pool: bool = False) -> torch.Tensor:
        """x: [N,H,W,C] ⊛ w: [KH,KW,C/groups,K] (+bias [K]) → [N,OH,OW,K];
        fused epilogue order ReLU → 2×2 max-pool → requantize(out_scale)."""
        cfg = self.config
        plan = self.plan(tuple(x.shape), tuple(w.shape), stride, padding,
                         pool=pool, groups=groups,
                         out_bytes=1 if out_scale is not None else None)
        if cfg.int8 and (x.dtype != torch.int8 or w.dtype != torch.int8):
            raise TypeError(f"an int8 core takes int8 operands, got "
                            f"{x.dtype}, {w.dtype}")
        return get_backend(cfg.backend).conv(
            x, w, bias, stride=stride, padding=padding, groups=groups,
            relu=relu, pool=pool, out_scale=out_scale, wrap8=cfg.wrap8,
            plan=plan)

    def apply_quantized_layer(self, x_f32: torch.Tensor, w_f32: torch.Tensor,
                              bias_f32: Optional[torch.Tensor] = None, *,
                              stride: int = 1, padding="VALID",
                              relu: bool = False, pool: bool = False):
        """Float in / float out: symmetric int8 quantization of activations
        and weights, int32 accumulate, dequantize."""
        xq = quantize_symmetric(x_f32)
        wq = quantize_symmetric(w_f32)
        bias_i32 = None
        if bias_f32 is not None:
            bias_i32 = torch.round(bias_f32.to(torch.float32)
                                   / (xq.scale * wq.scale)).to(torch.int32)
        core = ConvCore(ConvCoreConfig(
            cin_banks=self.config.cin_banks,
            kout_banks=self.config.kout_banks,
            backend=self.config.backend, int8=True))
        acc = core.apply_layer(xq.values, wq.values, bias_i32,
                               stride=stride, padding=padding, relu=relu,
                               pool=pool)
        return acc.to(torch.float32) * (xq.scale * wq.scale)


def paper_workload():
    """The exact §5.2 simulation workload shapes."""
    return {"x": (1, 224, 224, 8), "w": (3, 3, 8, 8), "bias": (8,)}
