"""InternLM2-20B — dense GQA [arXiv:2403.17297]."""
from repro_torch.config import ModelConfig


def internlm2_20b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        arch_type="dense",
        source="GQA [arXiv:2403.17297]",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=92544,
        max_seq_len=32768,
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=False,
    )
