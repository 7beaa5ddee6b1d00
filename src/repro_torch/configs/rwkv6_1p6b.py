"""RWKV-6 (Finch) 1.6B — attention-free, data-dependent decay linear
recurrence; head size 64. [arXiv:2404.05892]"""
from repro_torch.configs.base import ArchConfig, BLOCK_RWKV6

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    kind="decoder",
    num_layers=24,
    d_model=2048,
    num_heads=32,             # d_model / rwkv_head_size
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,                # channel-mix width (3.5x)
    vocab_size=65536,
    layer_pattern=(BLOCK_RWKV6,),
    use_rope=False,
    norm="layernorm",
    tie_embeddings=False,
    rwkv_head_size=64,
    rwkv_lora_rank=64,
)
