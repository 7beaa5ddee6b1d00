"""Hand-written Hopper kernels with their plain PyTorch versions (see
``ops`` for the public entries and ``ref`` for the oracles).

* conv2d_ws       — the paper's IP core: channel-banked, weight-stationary,
                    bias-preloaded conv with the fused epilogue
                    (csrc/conv2d_ws.cu);
* conv2d_ws_pipe  — the same function with its slabs streamed through a
                    cp.async ring (csrc/conv2d_ws_pipe.cu);
* matmul_ws       — the bias-preloaded GEMM of the dense heads and of the
                    LM's MLP under gemm_backend="pallas_ws"
                    (csrc/matmul_ws.cu; the Hopper helpers it shares with
                    flash_attention are in csrc/hopper_common.cuh);
* flash_attention — causal online-softmax attention of the LM prefill
                    (csrc/flash_attention.cu).
"""
