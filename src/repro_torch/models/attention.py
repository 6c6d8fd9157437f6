"""Dense GQA attention: projections, rotary embedding and the flash kernel.

Weight layouts are the reference's, so a JAX checkpoint loads without
transposes: ``wq`` (d, H, hd), ``wk``/``wv`` (d, Hkv, hd), ``wo`` (H, hd, d),
biases (H, hd) and (Hkv, hd).

Attention always goes through ``ops.gqa_flash``: on CUDA tensors that is the
Hopper kernel, on CPU tensors its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope


class GQAAttention(nn.Module):
    """Parameters of one GQA attention layer (the reference's gqa_params)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads(), cfg.resolved_head_dim()
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.empty(d, H, hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, Hkv, hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, Hkv, hd, **kw))
        self.wo = nn.Parameter(torch.empty(H, hd, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.empty(H, hd, **kw))
            self.bk = nn.Parameter(torch.empty(Hkv, hd, **kw))
            self.bv = nn.Parameter(torch.empty(Hkv, hd, **kw))


def _qkv(cfg: ModelConfig, p: GQAAttention, x: torch.Tensor,
         positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(cfg: ModelConfig, p: GQAAttention, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence attention (scoring / prefill). ``positions`` must be
    0..S-1 on every row, as ``Model.embed_inputs`` numbers them: the kernel
    masks by index, so its ``q_offset`` is 0."""
    q, k, v = _qkv(cfg, p, x, positions)
    w = cfg.sliding_window if window is None else window
    out = ops.gqa_flash(q, k, v, causal=causal, window=w)
    return torch.einsum("bshd,hdk->bsk", out, p.wo)
