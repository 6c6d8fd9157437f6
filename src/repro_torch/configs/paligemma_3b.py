"""PaliGemma-3B — SigLIP + Gemma VLM [arXiv:2407.07726].

Backbone only: the SigLIP vision tower is a stub, and the caller passes
precomputed patch embeddings (B, 256, 1152) that the model projects and
prepends to the text sequence."""
from repro_torch.config import FrontendConfig, ModelConfig


def paligemma_3b() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        arch_type="vlm",
        source="SigLIP + gemma [arXiv:2407.07726]",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        max_seq_len=8192,
        norm="rmsnorm",
        activation="gelu",
        frontend=FrontendConfig(kind="vision", num_embeddings=256, embed_dim=1152),
        tie_embeddings=True,
    )
