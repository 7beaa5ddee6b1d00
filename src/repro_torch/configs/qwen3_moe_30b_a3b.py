"""Qwen3-30B-A3B — 128 experts top-8, QK-norm, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    kind="decoder",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,            # the per-expert ff width
    vocab_size=151936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=128,
        top_k=8,
        num_shared=0,
        expert_ff=768,
        capacity_factor=1.25,
    ),
)
