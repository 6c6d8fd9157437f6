"""SeamlessM4T-medium — enc-dec multimodal (audio) [arXiv:2308.11596].

Backbone only: the mel-spectrogram + conv feature extractor is a stub, and
the caller passes precomputed frame embeddings (B, frames, 1024)."""
from repro_torch.config import EncDecConfig, FrontendConfig, ModelConfig


def seamless_m4t_medium() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        arch_type="audio",
        source="enc-dec, multimodal [arXiv:2308.11596]",
        num_layers=12,            # decoder layers
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        max_seq_len=4096,
        norm="layernorm",
        activation="gelu",
        encdec=EncDecConfig(num_encoder_layers=12, encoder_seq_len=1024),
        frontend=FrontendConfig(kind="audio", num_embeddings=1024, embed_dim=1024),
        tie_embeddings=True,
    )
