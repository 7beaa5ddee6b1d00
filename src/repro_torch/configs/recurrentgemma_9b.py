"""RecurrentGemma 9B (Griffin) — RG-LRU recurrent blocks + local attention,
pattern (recurrent, recurrent, attention), MQA, window 2048.
[arXiv:2402.19427]

The one ported architecture with a real in-model convolution: the temporal
conv1d (width 4) inside every recurrent block.  The block runs it as shifted
multiply-adds (``layers.rglru.causal_conv1d``), as the reference does; its
kernel route through the paper's dataflow is ``kernels.ops.conv1d_depthwise``
(``conv2d_ws``'s depthwise direct conv, the dw path).
"""
from repro_torch.configs.base import ArchConfig, BLOCK_RGLRU, BLOCK_LOCAL

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    kind="decoder",
    num_layers=38,                       # 12 × (R,R,A) + (R,R) tail
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,                      # MQA
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=(BLOCK_RGLRU, BLOCK_RGLRU, BLOCK_LOCAL),
    attention_window=2048,
    rope_theta=10_000.0,
    mlp_act="gelu",                      # GeGLU
    norm="rmsnorm",
    rmsnorm_unit_offset=True,
    embed_scale=True,
    tie_embeddings=True,
    rnn_width=4096,
    conv1d_width=4,
)
