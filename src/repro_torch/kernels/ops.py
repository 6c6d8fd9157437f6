"""The kernels in model layouts: the counterparts of the reference's
``kernels/ops.py`` adapters, with their signatures.

Unlike the TPU adapters these do no padding: the CUDA kernels mask the
ragged token, vocabulary, query and KV edges themselves, so the vocabulary
is never shrunk to one tile, the KV length is never padded to 128 and a
decode group is never padded to 8 rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.kernels.rwkv_wkv import rwkv6_wkv
from repro_torch.kernels.score_ce import score_ce

MAX_HEAD_DIM = 256   # the reference adapters' head-dim limit, kept as its error contract


def fused_token_nll(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Per-token NLL in model layout, zero where ``mask`` is: hidden (B, S, d),
    emb (V, d), labels/mask (B, S) -> (B, S) f32. Under autograd ``score_ce``
    takes its gradient through its backward kernel."""
    B, S, d = hidden.shape
    nll = score_ce(hidden.reshape(B * S, d).contiguous(), emb,
                   labels.reshape(-1).to(torch.int32).contiguous())
    return nll.reshape(B, S) * mask


def fused_score_ce(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eqn-1 scoring in model layout: hidden (B, S, d), emb (V, d),
    labels/mask (B, S). Returns (mean over masked tokens, per-example (B,))."""
    nll = fused_token_nll(hidden, emb, labels, mask)
    per_ex = nll.sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)
    mean = nll.sum() / mask.sum().clamp_min(1.0)
    return mean, per_ex


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              kv_len: Optional[int] = None) -> torch.Tensor:
    """Model layout adapter: q (B, S, H, hd), k/v (B, L, Hkv, hd) ->
    (B, S, H, hd). The kernel reads the transposed views in place. Under
    autograd the call goes through ``FlashAttention``, whose backward is the
    hand-written dQ/dK/dV kernel."""
    hd = q.shape[-1]
    if hd > MAX_HEAD_DIM:
        raise ValueError(
            f"gqa_flash: head_dim={hd} exceeds the flash kernel's limit "
            f"({MAX_HEAD_DIM})")
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=window, q_offset=q_offset,
                          kv_len=kv_len)
    return out.transpose(1, 2)


def gqa_flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: int, q_pos: int, window: int = 0,
                     splits: Optional[int] = None) -> torch.Tensor:
    """Single-token decode adapter: q (B, 1, H, hd) or (B, H, hd), k/v
    (B, L, Hkv, hd) -> the rank of q. The cache is read in place through
    transposed views. ``kv_len`` and ``q_pos`` are Python ints (the
    contiguous-prefix cache convention), so a decode step reads nothing
    back from the device. ``splits`` None sizes the grid to the card
    (``flash_decode.auto_splits``; 8 on the CPU): at qwen2-7b's serve shape
    (B = 16, Hkv = 4, 132 SMs) 2 splits make 128 blocks, one an SM."""
    squeeze = q.dim() == 4
    if squeeze:
        if q.shape[1] != 1:
            raise ValueError(f"gqa_flash_decode: decode takes one query token, got {q.shape[1]}")
        q = q[:, 0]
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(
            f"gqa_flash_decode: head_dim={q.shape[-1]} exceeds the flash kernel's limit "
            f"({MAX_HEAD_DIM})")
    out = flash_decode(q, k.transpose(1, 2), v.transpose(1, 2), kv_len=int(kv_len),
                       q_pos=int(q_pos), window=window, splits=splits)
    return out[:, None] if squeeze else out


def mla_flash_decode(q_lat: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
                     kpe: torch.Tensor, *, scale: float, kv_len: Optional[int] = None,
                     q_pos: Optional[int] = None, splits: Optional[int] = None) -> torch.Tensor:
    """Absorbed-MLA decode adapter: q_lat (B, 1, H, r) or (B, H, r), q_pe
    likewise with rd, ckv (B, L, r), kpe (B, L, rd) -> the latent output in
    the rank of q_lat. ``scale`` is 1/sqrt(qk_nope_head_dim +
    qk_rope_head_dim), the head dim before absorption. The reference's
    ``bk`` (its TPU tile) has no counterpart: the CUDA kernel's tile is
    fixed, and ``splits`` None lets the wrapper size the grid to the card."""
    squeeze = q_lat.dim() == 4
    if squeeze:
        if q_lat.shape[1] != 1:
            raise ValueError(f"mla_flash_decode: decode takes one query token, got {q_lat.shape[1]}")
        q_lat, q_pe = q_lat[:, 0], q_pe[:, 0]
    out = mla_decode(q_lat, q_pe, ckv, kpe, scale=float(scale), kv_len=kv_len, q_pos=q_pos,
                     splits=splits)
    return out[:, None] if squeeze else out


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
        u: torch.Tensor, state: Optional[torch.Tensor]
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout adapter: r/k/v/logw (B, H, T, hd), u (H, hd), state
    (B, H, hd, hd) f32 or None -> (y (B, H, T, hd) f32, state'). Unlike the
    reference no reshape to (B·H, T, hd) is needed: the kernel takes the
    strides of the views it is given. Under autograd the call goes through
    ``RWKV6WKV``, whose backward is the hand-written ``rwkv6_wkv_bwd``
    kernel: gradients reach r, k, v, logw, the start state and (when it
    requires grad) u."""
    return rwkv6_wkv(r, k, v, logw, u, state)
