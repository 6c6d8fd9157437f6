"""Vicuna-7B — the paper's own evaluation model (§6.1) [24], LLaMA
architecture: RMSNorm, SwiGLU, untied output embedding."""
from repro_torch.config import ModelConfig


def vicuna_7b() -> ModelConfig:
    return ModelConfig(
        name="vicuna-7b",
        arch_type="dense",
        source="[24] Vicuna (LLaMA arch); paper §6.1",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=11008,
        vocab_size=32000,
        max_seq_len=4096,
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=False,
    )
