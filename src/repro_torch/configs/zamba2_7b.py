"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.config import HybridConfig, ModelConfig, SSMConfig


def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        arch_type="hybrid",
        source="Mamba2 + shared attn blocks [arXiv:2411.15242]",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,              # shared block MLP width
        vocab_size=32000,
        max_seq_len=1 << 20,
        ssm=SSMConfig(kind="mamba2", state_size=64, chunk_size=128, expand=2),
        hybrid=HybridConfig(attn_every=6, shared_attn=True),
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=True,
    )
