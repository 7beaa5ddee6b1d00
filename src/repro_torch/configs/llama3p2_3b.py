"""Llama-3.2 3B — small llama3, tied embeddings. [hf:meta-llama/Llama-3.2-3B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    kind="decoder",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)
