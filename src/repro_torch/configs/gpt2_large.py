"""GPT2-Large — the paper's own evaluation model (§6.1).

As in the reference package, positions are RoPE, not GPT-2's learned table."""
from repro_torch.config import ModelConfig


def gpt2_large() -> ModelConfig:
    return ModelConfig(
        name="gpt2-large",
        arch_type="dense",
        source="[18] GPT-2; paper §6.1",
        num_layers=36,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=50257,
        max_seq_len=1024,
        norm="layernorm",
        activation="gelu",
        qkv_bias=True,
        tie_embeddings=True,
    )
