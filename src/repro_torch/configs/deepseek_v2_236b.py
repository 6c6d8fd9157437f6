"""DeepSeek-V2 236B — MLA + fine-grained MoE [arXiv:2405.04434]."""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig


def deepseek_v2_236b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        arch_type="moe",
        source="MLA kv_lora=512, 2 shared+160 routed top-6 [arXiv:2405.04434]",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=1536,               # per-expert hidden dim
        vocab_size=102400,
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
            num_experts=160,
            top_k=6,
            num_shared_experts=2,
            d_ff_expert=1536,
            first_dense_layers=1,
        ),
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=False,
    )
