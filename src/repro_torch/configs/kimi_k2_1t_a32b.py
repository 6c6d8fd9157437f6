"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2]."""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig


def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        arch_type="moe",
        source="Kimi K2 — trillion-param MoE, DeepSeek-V3-style MLA "
               "(kv_lora=512, 64 heads) [arXiv:2501.kimi2]",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=64,         # MLA: one latent head decompressed per head
        head_dim=128,
        d_ff=2048,               # per-expert hidden dim
        vocab_size=163840,
        max_seq_len=131072,
        attention="mla",
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=384,
            top_k=8,
            num_shared_experts=1,
            d_ff_expert=2048,
            first_dense_layers=1,
        ),
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=False,
    )
