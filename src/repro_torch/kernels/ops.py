"""The kernels in model layouts: the counterparts of the reference's
``kernels/ops.py`` adapters, with their signatures.

Unlike the TPU adapters these do no padding: the CUDA kernels mask the
ragged token, vocabulary, query and KV edges themselves, so the vocabulary
is never shrunk to one tile and the KV length is never padded to 128.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.score_ce import score_ce

MAX_HEAD_DIM = 256   # the reference adapters' head-dim limit, kept as its error contract


def fused_score_ce(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eqn-1 scoring in model layout: hidden (B, S, d), emb (V, d),
    labels/mask (B, S). Returns (mean over masked tokens, per-example (B,))."""
    B, S, d = hidden.shape
    nll = score_ce(hidden.reshape(B * S, d).contiguous(), emb,
                   labels.reshape(-1).to(torch.int32).contiguous())
    nll = nll.reshape(B, S) * mask
    per_ex = nll.sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)
    mean = nll.sum() / mask.sum().clamp_min(1.0)
    return mean, per_ex


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              kv_len: Optional[int] = None) -> torch.Tensor:
    """Model layout adapter: q (B, S, H, hd), k/v (B, L, Hkv, hd) ->
    (B, S, H, hd). The kernel reads the transposed views in place."""
    hd = q.shape[-1]
    if hd > MAX_HEAD_DIM:
        raise ValueError(
            f"gqa_flash: head_dim={hd} exceeds the flash kernel's limit "
            f"({MAX_HEAD_DIM})")
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=window, q_offset=q_offset,
                          kv_len=kv_len)
    return out.transpose(1, 2)
