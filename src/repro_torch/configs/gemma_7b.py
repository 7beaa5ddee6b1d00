"""Gemma 7B — GeGLU MLP, head_dim 256, scaled embeddings, 256k vocab.
[arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    kind="decoder",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,   # 7b is MHA (the 2b variant is MQA)
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    rope_theta=10_000.0,
    mlp_act="gelu",    # GeGLU
    norm="rmsnorm",
    rmsnorm_unit_offset=True,
    embed_scale=True,
    tie_embeddings=True,
)
