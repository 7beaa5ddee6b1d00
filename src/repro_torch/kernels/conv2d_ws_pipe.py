"""Pipelined variant of the weight-stationary conv as a hand-written
Hopper kernel.

Replaces the Pallas TPU kernel ``repro.kernels.conv2d_ws_pipe.
conv2d_ws_pipe``.  Same function, signature, geometry and path rule
(``conv2d_ws.conv_path``) as ``conv2d_ws.conv2d_ws``; the CUDA source
``csrc/conv2d_ws_pipe.cu`` streams its K-chunks through a multi-stage
``cp.async`` ring on the tensor-core and simt paths (up to 4 stages, as
deep as the blocks per SM that ``conv2d_ws`` runs allow, one where two
would cost a block: ``conv2d_ws.tc_plan``, ``conv2d_ws.simt_plan``), runs
persistent blocks that prefetch the next rectangle's window into a
2-slot ring on the dw path (``conv2d_ws.dw_plan``), streams a group's
channel chunks through a 2-slot ring on the nk path
(``conv2d_ws.nk_plan``), and streams its cin-bank slabs through a 2-stage
ring on the scalar path.  It shares its
compute and epilogue with ``csrc/conv2d_ws.cu``, so the two kernels are
bit-equal.

``conv2d_ws_pipe`` calls the ``torch.library`` op
``repro_torch::conv2d_ws_pipe``, defined as ``repro_torch::conv2d_ws`` is
(``conv2d_ws.define_conv_op``: the same schema, fake kernel and FLOP
formula).  On a CUDA tensor the op launches the kernel and counts the
launch in ``conv2d_ws_pipe.launches`` (and in
``conv2d_ws_pipe.<path>_launches``, ``tc``, ``simt``, ``dw``, ``nk`` or
``scalar``, by path); on a CPU tensor it runs the plain version, which is
``conv2d_ws_plain`` — the function both kernels compute.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv2d_ws import (conv2d_ws_plain, define_conv_op,
                                           reset_launches, run_conv)

# the plain PyTorch version: one function, computed by both conv kernels
conv2d_ws_pipe_plain = conv2d_ws_plain


def conv2d_ws_pipe(x, w, bias=None, out_scale=None, *, stride: int = 1,
                   padding="VALID", groups: int = 1, cin_banks: int = 4,
                   kout_banks: int = 4, h_tile: int = 0, w_tile: int = 0,
                   relu: bool = False, pool: bool = False,
                   dilation: int = 1) -> torch.Tensor:
    """Drop-in replacement for ``conv2d_ws`` with the slab loads streamed
    through a shared-memory ring; same contracts, same results bit for
    bit.  ``banking.plan_tiles`` decides per layer which one runs
    (``TilePlan.pipelined``)."""
    return run_conv(
        "conv2d_ws_pipe", True, conv2d_ws_pipe_plain, x, w, bias, out_scale,
        relu=relu, pool=pool, stride=stride, padding=padding, groups=groups,
        cin_banks=cin_banks, kout_banks=kout_banks, h_tile=h_tile,
        w_tile=w_tile, dilation=dilation)


reset_launches(conv2d_ws_pipe)
define_conv_op("conv2d_ws_pipe", True, conv2d_ws_pipe)
