"""Command R+ 104B — dense GQA, no-bias, parallel block
[hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.config import ModelConfig


def command_r_plus_104b() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        arch_type="dense",
        source="GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        max_seq_len=131072,
        norm="layernorm",
        activation="swiglu",
        parallel_block=True,
        qkv_bias=False,
        tie_embeddings=True,
    )
