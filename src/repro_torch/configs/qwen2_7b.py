"""Qwen2-7B — dense GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.config import ModelConfig


def qwen2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        arch_type="dense",
        source="GQA, QKV bias [arXiv:2407.10671]",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        max_seq_len=131072,
        norm="rmsnorm",
        activation="swiglu",
        qkv_bias=True,
        tie_embeddings=False,
    )
