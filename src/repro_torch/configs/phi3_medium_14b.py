"""Phi-3-medium 14B — dense, RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.config import ModelConfig


def phi3_medium_14b() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        arch_type="dense",
        source="RoPE SwiGLU GQA [arXiv:2404.14219]",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        max_seq_len=131072,
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=False,
    )
