"""Norms, rotary embedding, FFN, token embedding and unembedding.

Plain functions on tensors, each the counterpart of the function of the
same name in the reference's ``models/common.py``, and the ``Norm`` and
``FFN`` modules that hold their parameters, with the reference's numerics:
norms and rotary angles in f32, the result cast back to the input dtype,
and GELU in its tanh form (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)   # population variance
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, gamma: torch.Tensor, beta: Optional[torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, gamma, beta)
    return rms_norm(x, gamma)


class Norm(nn.Module):
    """LayerNorm (gamma, beta) or RMSNorm (gamma); parameters always f32."""

    def __init__(self, cfg: ModelConfig, d: int, *, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.gamma = nn.Parameter(torch.ones(d, device=device, dtype=torch.float32))
        if cfg.norm == "layernorm":
            self.beta = nn.Parameter(torch.zeros(d, device=device, dtype=torch.float32))
        else:
            self.register_parameter("beta", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.cfg, self.gamma, self.beta, x)


def rope_frequencies(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.
    Rotates split halves [x1, x2] with f32 angles."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_ffn(cfg: ModelConfig, w_up: torch.Tensor, w_down: torch.Tensor,
              w_gate: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    up = x @ w_up
    if cfg.activation == "swiglu":
        act = F.silu(x @ w_gate) * up
    else:
        act = F.gelu(up, approximate="tanh")
    return act @ w_down


class FFN(nn.Module):
    """A dense feed-forward of width ``d_ff`` (the config's by default)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype,
                 d_ff: int = 0):
        super().__init__()
        self.cfg = cfg
        d_ff = d_ff or cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.w_up = nn.Parameter(torch.empty(cfg.d_model, d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(d_ff, cfg.d_model, **kw))
        if cfg.activation == "swiglu":
            self.w_gate = nn.Parameter(torch.empty(cfg.d_model, d_ff, **kw))
        else:
            self.register_parameter("w_gate", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_ffn(self.cfg, self.w_up, self.w_down, self.w_gate, x)


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return embedding[tokens.long()].to(dtype)


def unembed(cfg: ModelConfig, embedding: torch.Tensor,
            unembed_w: Optional[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """Logits in f32: ``h @ embedding.T`` when tied, ``h @ unembed`` when
    not, rounded to the weights' dtype before the f32 cast as the
    reference does, then soft-capped where the config asks."""
    if cfg.tie_embeddings:
        logits = (h @ embedding.T).float()
    else:
        logits = (h @ unembed_w).float()
    if cfg.logit_soft_cap > 0:
        c = cfg.logit_soft_cap
        logits = c * torch.tanh(logits / c)
    return logits
