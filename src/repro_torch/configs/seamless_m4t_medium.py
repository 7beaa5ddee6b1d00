"""SeamlessM4T-medium — encoder-decoder, multimodal (speech/text); the audio
conformer frontend is a stub: the caller passes precomputed frame
embeddings (``frames``), which ``frontend_proj`` maps to d_model.
[arXiv:2308.11596]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    kind="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    use_rope=False,           # learned/sinusoidal positions in m4t; we use sinusoidal
    mlp_act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    frontend="audio",
    frontend_dim=1024,        # post-subsampler frame embedding width
)
