"""PyTorch/CUDA port of the paper's convolution IP core for NVIDIA Hopper.

The package mirrors ``src/repro`` module for module (same NHWC layouts,
``[KH,KW,C/groups,K]`` weights, scalar or ``[K]`` scales) and holds each
hand-written CUDA kernel beside a plain PyTorch version of the same
function:

* ``kernels``  — geometry + oracles (``ref``), the ``conv2d_ws``,
  ``conv2d_ws_pipe``, ``matmul_ws`` and ``flash_attention`` kernels, the
  transposed-conv lowering (``conv2d_ws_trans``) and the ``ops`` entries;
* ``core``     — quantization, the §5.2 cycle model, the tile planner,
  ``ConvCore``, the int8 network compiler and the multi-core scheduler;
* ``serving``  — the continuous-batching engine (``batching``), its
  single-model facade ``ConvNetEngine`` and the LM ``ServingEngine``;
* ``obs``      — trace spans, metrics and the per-layer profile;
* ``convert``  — carries weights and quantized networks across as numpy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
