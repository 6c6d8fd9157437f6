"""Configurations of the dense models the port runs so far.

``get_config(arch)`` returns the full configuration, ``smoke_config(arch)``
the reduced variant the CPU tests use (2 layers, d_model 256), and
``testbed_config(name)`` the tiny CPU-trained stand-ins whose artifact the
reference package writes under ``artifacts/``. Each mirrors the reference
registry, so a name means the same model in both packages.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.config import ModelConfig
from repro_torch.configs.gpt2_base import gpt2_base
from repro_torch.configs.qwen2_7b import qwen2_7b

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "gpt2-base": gpt2_base,
    "qwen2-7b": qwen2_7b,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch]()


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model 256, f32.

    Only the dense families are registered here; the reduction rules for
    MoE, SSM, hybrid, encoder-decoder and MLA come with those families."""
    cfg = get_config(arch)
    return cfg.with_overrides(
        d_model=256,
        num_heads=4,
        num_kv_heads=min(cfg.kv_heads(), 2),
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        max_seq_len=256,
        num_layers=2,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )


def testbed_config(name: str = "gpt2-base") -> ModelConfig:
    """Tiny CPU-trainable stand-ins for the paper's three LLMs, ordered
    like GPT2-Base < GPT2-Large < Vicuna-7B."""
    base = dict(
        arch_type="dense", num_kv_heads=2, head_dim=32, vocab_size=48,
        max_seq_len=128, norm="rmsnorm", activation="swiglu",
        dtype="float32", param_dtype="float32", remat=False,
    )
    sizes = {
        "gpt2-base": dict(num_layers=2, d_model=128, num_heads=4, d_ff=256),
        "gpt2-large": dict(num_layers=3, d_model=160, num_heads=4, d_ff=320),
        "vicuna-7b": dict(num_layers=4, d_model=192, num_heads=4, d_ff=384),
    }
    return ModelConfig(name=f"testbed-{name}", **base, **sizes[name])


__all__ = ["get_config", "smoke_config", "testbed_config"]
