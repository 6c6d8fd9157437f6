"""Model and tuning configuration, kept as the port's own copy of the
reference's dataclasses (same fields, same defaults), so that a config
built in either package describes the same model."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (GShard-style dispatch)."""
    num_experts: int = 0                 # routed experts; 0 => dense FFN
    top_k: int = 2
    num_shared_experts: int = 0          # always-on experts (DeepSeek-style)
    d_ff_expert: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_loss_weight: float = 0.001
    # first N layers use a dense FFN instead of MoE (DeepSeek/Kimi style)
    first_dense_layers: int = 1


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-attention configuration."""
    kind: str = "rwkv6"                  # "rwkv6" | "mamba2"
    state_size: int = 64                 # per-head state dim
    num_heads: int = 0                   # 0 => derived d_model // state_size
    chunk_size: int = 128                # chunked-scan block length
    expand: int = 2                      # mamba2 inner expansion
    conv_width: int = 4                  # mamba2 short conv


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + shared attention block."""
    attn_every: int = 6
    shared_attn: bool = True


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (Seamless-M4T style)."""
    num_encoder_layers: int = 12
    encoder_seq_len: int = 1024
    cross_attention: bool = True


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub: precomputed embeddings of the right shape."""
    kind: str = "none"                   # "none" | "audio" | "vision"
    num_embeddings: int = 0
    embed_dim: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"             # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                    # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 4096

    attention: str = "gqa"               # "gqa" | "mla" | "none"
    mla: Optional[MLAConfig] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0              # 0 => full attention
    activation: str = "swiglu"           # "swiglu" | "gelu"
    norm: str = "rmsnorm"                # "rmsnorm" | "layernorm"
    parallel_block: bool = False         # command-r style parallel attn+ffn
    tie_embeddings: bool = True
    logit_soft_cap: float = 0.0

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)

    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    seq_shard: bool = False

    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TuneConfig:
    """LPT algorithm hyperparameters (Table 3 'Hyperparam')."""
    algorithm: str = "soft_prompt"       # "soft_prompt" | "prefix"
    prompt_len: int = 16                 # tunable virtual tokens
    lr: float = 0.3
    weight_decay: float = 0.0
    optimizer: str = "adam"
    batch_size: int = 8
    max_iters: int = 400
    eval_every: int = 10
    eval_samples: int = 16               # Eqn-1 evaluation set size
    seed: int = 0
