"""InternVL2-26B — InternViT-6B vision frontend (a stub) +
InternLM2-20B language backbone. [arXiv:2404.16821]

The config is the transformer backbone only: the caller passes precomputed
patch embeddings (the InternViT + MLP projector output, ``patches``) as a
prefix of up to ``frontend_tokens`` positions in ``frontend_dim`` = the ViT
output width, which ``frontend_proj`` maps to d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    kind="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=1024,   # (448/14)^2 patches with pixel-unshuffle x4 = 256/img, 4 tiles
    frontend_dim=3200,      # InternViT-6B width (projector input)
)
