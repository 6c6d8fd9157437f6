"""GPT2-Base — the paper's own evaluation model [Radford et al.].

As in the reference package, positions are RoPE, not GPT-2's learned table."""
from repro_torch.config import ModelConfig


def gpt2_base() -> ModelConfig:
    return ModelConfig(
        name="gpt2-base",
        arch_type="dense",
        source="[18] GPT-2; paper §6.1",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=50257,
        max_seq_len=1024,
        norm="layernorm",
        activation="gelu",
        qkv_bias=True,
        tie_embeddings=True,
    )
