"""Hand-written Hopper kernels with their plain PyTorch versions (see
``ops`` for the public entries and ``ref`` for the oracles).

* conv2d_ws       — the paper's IP core: channel-banked, weight-stationary,
                    bias-preloaded conv with the fused epilogue
                    (csrc/conv2d_ws.cu);
* conv2d_ws_pipe  — the same function with its slabs streamed through a
                    cp.async ring (csrc/conv2d_ws_pipe.cu);
* matmul_ws       — the bias-preloaded GEMM of the dense heads
                    (csrc/matmul_ws.cu).
"""
