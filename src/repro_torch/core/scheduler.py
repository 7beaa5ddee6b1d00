"""Multi-core network scheduler — the paper's replicated-IP-core mode
(counterpart of ``repro.core.scheduler``).

§5.2: one IP core reaches 0.224 GOPS; the fully used board, ~20
replicated cores, 4.48 GOPS.  Replication takes three forms:

* **batch sharding** ("each IP core processes its own image"): the batch
  splits across cores.  On one card the cores are virtual: the batch,
  zero-padded to a multiple of the core count, goes through the program
  as one batched launch sequence, where the reference vmaps the program
  over core shards.  Every node of a program is per image, so the two are
  bit-equal.  The reference's one-device-per-core branch is not ported
  (ROADMAP A14.5): with more GPUs the cores stay virtual on the engine's
  device.
* **kout sharding** ("the kernel sets are divided among the cores"):
  every conv / transposed conv / GEMM splits its K output channels across
  cores, each core convolves the same map with its kernel slice, and the
  slices concatenate (``KoutShardedBackend``).
* **spatial sharding**: every conv's output rows split into halo'd,
  pool-aligned horizontal bands, one per core, each convolved with the
  full kernel set (``SpatialShardedBackend``).

Both sharded backends are ``Backend`` decorators, so a program compiles
against them unchanged; they register under names like ``"cuda@kout4"``.
A kout shard's weights are sliced once per weight tensor
(``conv2d_ws.derived_weights``) and kept while the weights live, so the
shards' packed weights are cached too and nothing is repacked per batch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch import obs
from repro_torch.core.banking import divisor_banks
from repro_torch.core.convcore import Backend, get_backend
from repro_torch.kernels.conv2d_ws import derived_weights
from repro_torch.kernels.conv2d_ws_trans import (flipped_weights,
                                                 transpose_eq_conv_inputs)
from repro_torch.kernels.ref import (conv_out_shape, halo_window,
                                     normalize_padding)

MODES = ("batch", "kout", "spatial")


@dataclass(frozen=True)
class SchedulerConfig:
    n_cores: int = 1
    mode: str = "batch"                 # "batch" | "kout" | "spatial"

    @classmethod
    def for_tune(cls, tune) -> "SchedulerConfig":
        """The config of an autotuned plan's (mode × cores) verdict: any
        object with ``n_cores`` and ``scheduler_mode`` attributes."""
        return cls(n_cores=int(tune.n_cores), mode=str(tune.scheduler_mode))


def _split_last(n: int):
    """``w`` → the n contiguous equal slices of its last axis, as
    copies."""
    def split(w: torch.Tensor):
        s = w.shape[-1] // n
        return tuple(w[..., i * s:(i + 1) * s].clone(
            memory_format=torch.contiguous_format) for i in range(n))
    return split


def _slice(v, sl):
    """A per-channel [K] vector's slice; a scalar (or None) as it is."""
    if v is None or not isinstance(v, torch.Tensor) or v.dim() == 0:
        return v
    return v[sl]


class KoutShardedBackend:
    """Backend decorator: split every conv / transposed conv / GEMM's
    output channels across ``n_cores`` virtual IP cores and concatenate.

    Grouped convs shard along group boundaries: a core's contiguous
    kernel-set slice tiles one group (a dense conv over that group's cin
    slice) or covers whole groups (a narrower grouped conv over their cin
    slices).  A core count that would cut through a group raises
    ``ValueError``; a dense layer whose K the core count does not divide
    runs on the largest core count that divides it (``_shards``)."""

    def __init__(self, inner: Backend, n_cores: int):
        self.inner = inner
        self.n_cores = n_cores
        self.name = f"{inner.name}@kout{n_cores}"

    def _shards(self, k: int) -> int:
        n = min(self.n_cores, k)
        while k % n:
            n -= 1
        return n

    def conv(self, x, w, bias=None, *, groups=1, out_scale=None, plan=None,
             **kw):
        return self._sharded(self.inner.conv, x, w, bias, groups=groups,
                             out_scale=out_scale, plan=plan, **kw)

    def conv_transpose(self, x, w, bias=None, *, groups=1, out_scale=None,
                       plan=None, **kw):
        """Kernel-set division of a transposed conv: its K output channels
        split the same way; each core upsamples the same map with its
        slice."""
        return self._sharded(self.inner.conv_transpose, x, w, bias,
                             groups=groups, out_scale=out_scale, plan=plan,
                             **kw)

    def _sharded(self, op, x, w, bias, *, groups, out_scale, plan, **kw):
        k = w.shape[-1]
        if groups > 1:
            return self._conv_grouped(op, x, w, bias, groups=groups,
                                      out_scale=out_scale, plan=plan, **kw)
        n = self._shards(k)
        if n == 1:
            return op(x, w, bias, out_scale=out_scale, plan=plan, **kw)
        if plan is not None:
            # re-bank for the per-core kernel slice (K/n output channels)
            plan = replace(plan, kout_banks=divisor_banks(
                k // n, plan.kout_banks))
        shards = derived_weights(w, ("kout", n), _split_last(n))
        outs = []
        for i in range(n):                 # one iteration per fabric core
            sl = slice(i * (k // n), (i + 1) * (k // n))
            outs.append(op(x, shards[i], _slice(bias, sl),
                           out_scale=_slice(out_scale, sl), plan=plan, **kw))
        return torch.cat(outs, dim=-1)

    def _conv_grouped(self, op, x, w, bias, *, groups, out_scale, plan,
                      **kw):
        """Kernel-set division of a grouped conv: each core's contiguous
        K/n slice stays group-aligned and reads only its cin slice."""
        k = w.shape[-1]
        kg = k // groups                     # kernels per group
        cgrp = x.shape[-1] // groups         # cin channels per group
        n = min(self.n_cores, k)
        if n == 1:
            return op(x, w, bias, groups=groups, out_scale=out_scale,
                      plan=plan, **kw)
        s = k // n                           # kernel sets per core
        if k % n or (kg % s and s % kg):
            raise ValueError(
                f"kout sharding cannot split K={k} kernels "
                f"(groups={groups}, {kg} kernels/group) across "
                f"{self.n_cores} cores: each core's slice of {k}/{n} "
                f"kernel sets must tile a group or cover whole groups")
        shards = derived_weights(w, ("kout", n), _split_last(n))
        outs = []
        for i in range(n):                   # one iteration per fabric core
            sl = slice(i * s, (i + 1) * s)
            gi0, gi1 = (i * s) // kg, ((i + 1) * s - 1) // kg + 1
            g_s = gi1 - gi0 if s >= kg else 1    # shard's group count
            shard_plan = plan
            if plan is not None:
                if s >= kg:                  # whole groups: keep banks/group
                    kb_n = g_s * max(1, plan.kout_banks // groups)
                else:                        # within one group: dense shard
                    kb_n = divisor_banks(s, plan.kout_banks)
                shard_plan = replace(plan, kout_banks=kb_n, groups=g_s)
            outs.append(op(
                x[..., gi0 * cgrp:gi1 * cgrp], shards[i], _slice(bias, sl),
                groups=g_s, out_scale=_slice(out_scale, sl),
                plan=shard_plan, **kw))
        return torch.cat(outs, dim=-1)

    def matmul(self, x, w, bias=None):
        k = w.shape[-1]
        n = self._shards(k)
        if n == 1:
            return self.inner.matmul(x, w, bias)
        shards = derived_weights(w, ("kout", n), _split_last(n))
        outs = [self.inner.matmul(
            x, shards[i], _slice(bias, slice(i * (k // n), (i + 1) * (k // n))))
            for i in range(n)]
        return torch.cat(outs, dim=-1)


class SpatialShardedBackend:
    """Backend decorator: split every conv's output rows into ``n_cores``
    halo'd horizontal bands, one per virtual IP core, and concatenate.

    Band i computing conv-output rows [oy0, oy1) reads padded-input rows
    [oy0·s, (oy1−1)·s + ek); the margins outside the map become that
    band's explicit (and so possibly asymmetric) padding, so each band is
    an ordinary conv under the inner backend and its tile plan.  Bands are
    pool-aligned: with the fused 2×2 pool, band edges sit on even output
    rows."""

    def __init__(self, inner: Backend, n_cores: int):
        self.inner = inner
        self.n_cores = n_cores
        self.name = f"{inner.name}@spatial{n_cores}"

    def conv(self, x, w, bias=None, *, stride=1, padding="VALID",
             dilation=1, pool=False, plan=None, **kw):
        n, h, w_dim, c = x.shape
        kh, kw_ = w.shape[:2]
        (pt, pb), (pl_, pr) = normalize_padding(padding, kh, kw_, stride,
                                                h, w_dim, dilation)
        oh, _ = conv_out_shape(h, w_dim, kh, kw_, stride, padding, dilation)
        if pool:
            oh = (oh // 2) * 2           # floor semantics, like the kernel
        unit = 2 if pool else 1          # pool-aligned band boundaries
        rows = oh // unit
        shards = min(self.n_cores, rows)
        if shards <= 1:
            return self.inner.conv(x, w, bias, stride=stride,
                                   padding=padding, dilation=dilation,
                                   pool=pool, plan=plan, **kw)
        # balanced unit split: the first (rows % shards) bands get one more
        base, rem = divmod(rows, shards)
        outs, oy0 = [], 0
        for i in range(shards):
            oy1 = oy0 + (base + (1 if i < rem else 0)) * unit
            a = oy0 * stride - pt        # input rows, unpadded coordinates
            b_ = a + halo_window(oy1 - oy0, stride, kh, dilation)
            lo, hi = max(a, 0), min(b_, h)
            outs.append(self.inner.conv(
                x[:, lo:hi], w, bias, stride=stride,
                padding=((lo - a, b_ - hi), (pl_, pr)), dilation=dilation,
                pool=pool, plan=plan, **kw))
            oy0 = oy1
        return torch.cat(outs, dim=1)

    def conv_transpose(self, x, w, bias=None, *, stride=1, padding="VALID",
                       dilation=1, **kw):
        """Row-band a transposed conv by lowering it to its equivalent
        stride-1 conv first (zero-inserted map, flipped kernel, "full"
        padding) and banding that through ``self.conv``: the same
        lowering ``conv2d_ws_transpose`` performs, so bit-equal to it."""
        xd, eq_pads = transpose_eq_conv_inputs(
            x, w.shape[0], w.shape[1], stride=stride, padding=padding,
            dilation=dilation)
        return self.conv(xd, flipped_weights(w), bias, stride=1,
                         padding=eq_pads, dilation=dilation, **kw)

    def matmul(self, x, w, bias=None):
        return self.inner.matmul(x, w, bias)


class MultiCoreScheduler:
    """Run a network program as if on ``n_cores`` replicated IP cores."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        if config.mode not in MODES:
            raise ValueError(f"unknown scheduler mode {config.mode!r}; "
                             f"have {MODES}")
        if config.n_cores < 1:
            raise ValueError(f"n_cores must be >= 1, got {config.n_cores}")
        self.config = config

    @classmethod
    def from_tune(cls, tune) -> "MultiCoreScheduler":
        """The scheduler of an autotuned plan's (mode × cores) verdict."""
        return cls(SchedulerConfig.for_tune(tune))

    def shard_backend(self, backend_name: str) -> Backend:
        """kout / spatial modes: a Backend whose every conv layer is
        kernel-set- or row-band-sharded across the virtual cores."""
        inner = get_backend(backend_name)
        if self.config.mode == "spatial":
            return SpatialShardedBackend(inner, self.config.n_cores)
        return KoutShardedBackend(inner, self.config.n_cores)

    def run(self, program, x: torch.Tensor) -> torch.Tensor:
        """batch mode: split the batch over the cores, zero-padding a
        ragged batch to a multiple of the core count and slicing the
        padding off again.  kout / spatial modes: pass through (the cores
        divide kernels or row bands inside the program, compiled against
        ``shard_backend``).  Each run is a ``sched.run`` span when obs is
        enabled."""
        cores = self.config.n_cores
        n = x.shape[0]
        if cores == 1 or self.config.mode in ("kout", "spatial"):
            with obs.span("sched.run", mode=self.config.mode, cores=cores,
                          batch=n):
                return program(x)
        pad = -n % cores
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        with obs.span("sched.run", mode="batch", cores=cores, batch=n,
                      padded=pad, virtual=True):
            return program(x)[:n]
