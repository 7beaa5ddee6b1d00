"""Llama-3 8B — dense GQA decoder, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    kind="decoder",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
)
