"""Architecture configuration (counterpart of ``repro.configs.base``).

Every architecture is an :class:`ArchConfig`, a frozen dataclass with the
reference's fields and defaults, so a config compares field for field with
the JAX package's.  ``get_config`` returns every architecture the reference
defines: the dense decoders llama3.2-3b, llama3-8b, yi-34b and gemma-7b,
the hybrid recurrentgemma-9b, the attention-free rwkv6-1.6b, the MoE
decoders deepseek-moe-16b and qwen3-moe-30b-a3b, the encoder-decoder
seamless-m4t-medium and the VLM internvl2-26b.
:func:`reduce_config` derives the CPU-sized variant the tests run.
``SHAPES`` holds the dry run's four input shapes (``ShapeConfig``) and
``shape_applicable`` says which (architecture × shape) cells run;
``active_param_count`` and ``config_summary`` are the roofline's.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts feed-forward configuration (GShard-style
    capacity)."""

    num_experts: int
    top_k: int
    expert_ff: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    num_groups: int = 0
    aux_loss_weight: float = 0.01


# Block kinds a decoder stack can be built from.
BLOCK_ATTN = "attn"          # global self attention
BLOCK_LOCAL = "local_attn"   # sliding-window self attention
BLOCK_RGLRU = "rglru"        # RecurrentGemma recurrent block (conv1d + RG-LRU)
BLOCK_RWKV6 = "rwkv6"        # RWKV-v6 time-mix block (attention free)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    kind: str                    # decoder | encdec | vlm

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention / mixer details -------------------------------------
    # repeating unit of block kinds; tiles over num_layers, remainder layers
    # take the pattern prefix
    layer_pattern: Tuple[str, ...] = (BLOCK_ATTN,)
    attention_window: int = 0            # for local_attn blocks
    rope_theta: float = 500_000.0
    use_rope: bool = True
    qk_norm: bool = False                # qwen3 style
    logit_softcap: float = 0.0           # gemma style final-logit softcap

    # --- ffn ------------------------------------------------------------
    mlp_act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU)
    moe: Optional[MoEConfig] = None

    # --- norms / embeddings ----------------------------------------------
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    rmsnorm_unit_offset: bool = False    # gemma: weight = 1 + w
    embed_scale: bool = False            # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = False

    # --- rglru (hybrid) ---------------------------------------------------
    rnn_width: int = 0
    conv1d_width: int = 4

    # --- rwkv -------------------------------------------------------------
    rwkv_head_size: int = 64
    rwkv_lora_rank: int = 64

    # --- enc-dec / multimodal frontends ------------------------------------
    encoder_layers: int = 0
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    frontend_dim: int = 0

    # --- numerics / backend -----------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # "auto" follows compute_dtype; "int8" waits on the w8 slice
    kv_cache_dtype: str = "auto"
    kv_cache_scale: float = 0.05
    remat_policy: str = "minimal"        # none | minimal | full
    # "xla": torch.einsum / matmul; "pallas_ws": the matmul_ws kernel
    gemm_backend: str = "xla"
    # "chunked" (online softmax over chunks, plain torch), "flash" (the
    # flash_attention kernel; chunked for windowed attention) or "dense"
    # (materialized scores)
    attn_impl: str = "chunked"
    attn_chunk: int = 512

    @property
    def resolved_kv_dtype(self) -> str:
        return (self.compute_dtype if self.kv_cache_dtype == "auto"
                else self.kv_cache_dtype)

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends to unbounded history (long_500k
        eligible)."""
        return all(b in (BLOCK_RGLRU, BLOCK_RWKV6, BLOCK_LOCAL)
                   for b in self.layer_pattern)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def num_groups_scan(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def tail_blocks(self) -> Tuple[str, ...]:
        """Remainder layers that do not fill a whole pattern group."""
        rem = self.num_layers % len(self.layer_pattern)
        return self.layer_pattern[:rem]

    def block_kinds(self) -> Tuple[str, ...]:
        """The full, ordered list of block kinds (length == num_layers)."""
        reps = self.num_layers // len(self.layer_pattern)
        return self.layer_pattern * reps + self.tail_blocks

    def validate(self) -> None:
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: {self.num_heads} heads do not "
                             f"group over {self.num_kv_heads} KV heads")


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry run's (architecture × shape) cells."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable; returns (ok, reason)."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("pure full-attention architecture: 500k-token decode "
                       "is architecturally quadratic-history; skipped")
    return True, ""


ARCH_NAMES = (
    "llama3_8b",
    "llama3p2_3b",
    "yi_34b",
    "gemma_7b",
    "internvl2_26b",
    "recurrentgemma_9b",
    "deepseek_moe_16b",
    "qwen3_moe_30b_a3b",
    "seamless_m4t_medium",
    "rwkv6_1p6b",
)

# CLI aliases (published names → module names)
ALIASES = {
    "llama3-8b": "llama3_8b",
    "llama3.2-3b": "llama3p2_3b",
    "yi-34b": "yi_34b",
    "gemma-7b": "gemma_7b",
    "internvl2-26b": "internvl2_26b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "rwkv6-1.6b": "rwkv6_1p6b",
}


def get_config(name: str) -> ArchConfig:
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCH_NAMES:
        raise KeyError(f"unknown architecture {name!r}; "
                       f"have {sorted(ALIASES)}")
    cfg: ArchConfig = importlib.import_module(
        f"repro_torch.configs.{mod_name}").CONFIG
    cfg.validate()
    return cfg


def all_configs():
    return {n: get_config(n) for n in ARCH_NAMES}


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Shrink a full architecture to a CPU-smoke size, preserving the family
    structure (layer pattern, GQA ratio, MoE routing, frontends)."""
    group = len(cfg.layer_pattern)
    layers = group + (1 if cfg.tail_blocks else 0) * len(cfg.tail_blocks)
    kv = max(1, min(cfg.num_kv_heads, 2))
    ratio = cfg.num_heads // cfg.num_kv_heads
    heads = kv * ratio
    moe = None
    if cfg.moe is not None:
        moe = replace(cfg.moe, num_experts=8,
                      top_k=min(cfg.moe.top_k, 2),
                      num_shared=min(cfg.moe.num_shared, 1),
                      expert_ff=64)
    return replace(
        cfg,
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        moe=moe,
        rnn_width=64 if cfg.rnn_width else 0,
        rwkv_lora_rank=8,
        attention_window=(min(cfg.attention_window, 64)
                          if cfg.attention_window else 0),
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_tokens=min(cfg.frontend_tokens, 8),
        frontend_dim=min(cfg.frontend_dim, 32) if cfg.frontend_dim else 0,
        attn_chunk=32,
        remat_policy="none",
        param_dtype="float32",
        compute_dtype="float32",
    )


def _per_block_params(cfg: ArchConfig, kind: str) -> int:
    d = cfg.d_model
    attn = (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d)
    if kind in (BLOCK_ATTN, BLOCK_LOCAL):
        mix = attn
    elif kind == BLOCK_RGLRU:
        w = cfg.rnn_width
        mix = d * w * 2 + w * d + cfg.conv1d_width * w + 2 * w * w // 1 + w
    elif kind == BLOCK_RWKV6:
        mix = 5 * d * d + d * d + 5 * cfg.rwkv_lora_rank * 2 * d
    else:
        raise ValueError(kind)
    if cfg.moe is not None and kind != BLOCK_RWKV6:
        m = cfg.moe
        ffn = ((m.num_experts + m.num_shared) * 3 * d * m.expert_ff
               + d * m.num_experts)
    elif kind == BLOCK_RWKV6:
        ffn = 2 * d * cfg.d_ff
    else:
        ffn = 3 * d * cfg.d_ff   # gated mlps: up, gate, down
    return mix + ffn + 2 * d     # two norms


def param_count(cfg: ArchConfig) -> int:
    total = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    for kind in cfg.block_kinds():
        total += _per_block_params(cfg, kind)
    if cfg.kind == "encdec":
        d = cfg.d_model
        enc = cfg.encoder_layers * _per_block_params(cfg, BLOCK_ATTN)
        cross = cfg.num_layers * (d * cfg.q_dim + 2 * d * cfg.kv_dim
                                  + cfg.q_dim * d + d)
        total += enc + cross
    if cfg.frontend is not None and cfg.frontend_dim:
        total += cfg.frontend_dim * cfg.d_model
    total += cfg.d_model  # final norm
    return total


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: only routed top-k + shared)."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    per_layer_all = (m.num_experts + m.num_shared) * 3 * cfg.d_model \
        * m.expert_ff
    per_layer_act = (m.top_k + m.num_shared) * 3 * cfg.d_model * m.expert_ff
    n_moe_layers = sum(1 for k in cfg.block_kinds() if k != BLOCK_RWKV6)
    return param_count(cfg) - n_moe_layers * (per_layer_all - per_layer_act)


def config_summary(cfg: ArchConfig) -> str:
    n = param_count(cfg)
    return (f"{cfg.name}: {cfg.num_layers}L d={cfg.d_model} H={cfg.num_heads} "
            f"kv={cfg.num_kv_heads} dh={cfg.head_dim} ff={cfg.d_ff} "
            f"V={cfg.vocab_size} params={n/1e9:.2f}B")
