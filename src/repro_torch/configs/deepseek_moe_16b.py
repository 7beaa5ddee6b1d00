"""DeepSeekMoE 16B — fine-grained experts: 64 routed top-6 + 2 shared,
expert_ff 1408. [arXiv:2401.06066]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    kind="decoder",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,     # MHA
    head_dim=128,
    d_ff=1408,           # the per-expert ff width
    vocab_size=102400,
    rope_theta=10_000.0,
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared=2,
        expert_ff=1408,
        capacity_factor=1.25,
    ),
)
