"""Configurations of the models the port runs so far: dense GQA decoders
(the paper's gpt2-base, gpt2-large and vicuna-7b among them, and
command-r-plus-104b's parallel LayerNorm block), the RWKV6
family, the MLA + MoE family, the Zamba2 hybrid (Mamba2 + shared
attention), the encoder-decoder seamless-m4t-medium (audio frontend stub)
and the VLM paligemma-3b (vision frontend stub).

``get_config(arch)`` returns the full configuration, ``smoke_config(arch)``
the reduced variant the CPU tests use (2 layers, d_model 256), and
``testbed_config(name)`` the tiny CPU-trained stand-ins whose artifact the
reference package writes under ``artifacts/``. Each mirrors the reference
registry, so a name means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.config import ModelConfig
from repro_torch.configs.command_r_plus_104b import command_r_plus_104b
from repro_torch.configs.deepseek_v2_236b import deepseek_v2_236b
from repro_torch.configs.gpt2_base import gpt2_base
from repro_torch.configs.gpt2_large import gpt2_large
from repro_torch.configs.internlm2_20b import internlm2_20b
from repro_torch.configs.kimi_k2_1t_a32b import kimi_k2_1t_a32b
from repro_torch.configs.paligemma_3b import paligemma_3b
from repro_torch.configs.phi3_medium_14b import phi3_medium_14b
from repro_torch.configs.qwen2_7b import qwen2_7b
from repro_torch.configs.rwkv6_7b import rwkv6_7b
from repro_torch.configs.seamless_m4t_medium import seamless_m4t_medium
from repro_torch.configs.vicuna_7b import vicuna_7b
from repro_torch.configs.zamba2_7b import zamba2_7b

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    """Adds a config function under the name of the config it returns."""
    _REGISTRY[fn().name] = fn
    return fn


for _fn in (command_r_plus_104b, deepseek_v2_236b, gpt2_base, gpt2_large, internlm2_20b,
            kimi_k2_1t_a32b, paligemma_3b, phi3_medium_14b, qwen2_7b, rwkv6_7b,
            seamless_m4t_medium, vicuna_7b, zamba2_7b):
    register(_fn)


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch]()


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model 256, f32. A MoE model
    gets 3 layers (1 dense + 2 MoE), 4 experts, top-2, at most 1 shared
    expert of width 128; MLA gets ranks (kv 64, q 48) and head dims (nope
    32, rope 16, v 32); an SSM gets state 32, chunk 16 and (RWKV: d_model /
    state) 8 heads, a hybrid 4 attention heads, 5 layers and shared
    attention every 2 (three Mamba2 segments, two applications); an
    encoder-decoder 2 encoder layers and a 16-row cross cache, and a
    frontend 8 frames of width 48. The cross cache then has more rows
    than the encoder's output, as in the reference's cut."""
    cfg = get_config(arch)
    kw: dict = dict(
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
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1), d_ff_expert=128,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
        kw["num_layers"] = 3                                  # 1 dense + 2 MoE
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, state_size=32, num_heads=0, chunk_size=16, expand=2)
        kw["num_heads"] = 8 if cfg.arch_type == "ssm" else 4   # rwkv: d / state
    if cfg.hybrid is not None:
        kw["num_layers"] = 5
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, attn_every=2)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, num_encoder_layers=2, encoder_seq_len=16)
    if cfg.frontend.kind != "none":
        kw["frontend"] = dataclasses.replace(cfg.frontend, num_embeddings=8, embed_dim=48)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=64, q_lora_rank=48, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32)
    return cfg.with_overrides(**kw)


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


__all__ = ["get_config", "list_archs", "register", "smoke_config", "testbed_config"]
