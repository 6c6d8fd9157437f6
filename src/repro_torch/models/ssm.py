"""RWKV6 (Finch) time mixing: the attention-free block of the RWKV6 family.

Counterpart of the RWKV6 half of the reference's ``models/ssm.py``, with its
parameter names, shapes and numerics. The reference runs the WKV recurrence
of a full sequence as a chunked scan (its TPU kernel ``rwkv6_wkv`` is the
fused twin of that scan); here ``rwkv6_forward`` calls ``ops.wkv``: the
Hopper kernel on CUDA tensors, the sequential recurrence on CPU tensors. The
one-token ``rwkv6_decode`` is plain tensor code on both devices, as the
reference's is XLA. Under autograd (prompt tuning) ``ops.wkv`` goes through
``RWKV6WKV``, whose backward is the hand-written ``rwkv6_wkv_bwd`` kernel
on the card; the gradient reaches the prompt through ``_rwkv6_inputs``
(token shift, ddlerp, LoRAs, the decay clamp), as XLA's does in the
reference.

State: ``s`` (B, H, hd, hd) f32 [key dim x value dim] and the token-shift
``x_prev`` (B, d_model) in the activation dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import torch_dtype
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import rms_norm

TIME_MIX_DIM = 32
DECAY_LORA_DIM = 64


def rwkv6_dims(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.ssm.state_size
    H = cfg.ssm.num_heads or cfg.d_model // hd
    return H, hd


class RWKV6TimeMix(nn.Module):
    """Parameters of one time-mixing layer (the reference's rwkv6_params).
    ``w0``, ``u`` and ``ln_out`` are f32 whatever the parameter dtype."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        H, hd = rwkv6_dims(cfg)

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dt))

        # data-dependent token-shift (ddlerp) mixing
        self.mu_x = param(d)
        self.mu_rkvwg = param(5, d)
        self.tm_w1 = param(d, 5 * TIME_MIX_DIM)
        self.tm_w2 = param(5, TIME_MIX_DIM, d)
        # projections
        self.wr = param(d, H, hd)
        self.wk = param(d, H, hd)
        self.wv = param(d, H, hd)
        self.wg = param(d, H * hd)
        self.wo = param(H, hd, d)
        # data-dependent decay
        self.w0 = param(H, hd, dt=torch.float32)
        self.decay_w1 = param(d, DECAY_LORA_DIM)
        self.decay_w2 = param(DECAY_LORA_DIM, H, hd)
        # per-channel current-token bonus
        self.u = param(H, hd, dt=torch.float32)
        self.ln_out = param(H, hd, dt=torch.float32)


def _rwkv6_inputs(cfg: ModelConfig, p: RWKV6TimeMix, x: torch.Tensor,
                  x_prev: torch.Tensor):
    """ddlerp token shift -> r, k, v, g (B, S, H, hd) and logw (B, S, H, hd)
    f32 <= 0, clamped at -12. x: (B, S, d); x_prev: (B, d)."""
    B, S, d = x.shape
    H, hd = rwkv6_dims(cfg)
    shifted = torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    xx = shifted - x
    xxx = x + xx * p.mu_x
    lora = torch.tanh(xxx @ p.tm_w1).reshape(B, S, 5, TIME_MIX_DIM)
    mixes = p.mu_rkvwg + torch.einsum("bstm,tmd->bstd", lora, p.tm_w2)
    xr, xk, xv, xw, xg = (x + xx * mixes[:, :, i] for i in range(5))
    r = torch.einsum("bsd,dhk->bshk", xr, p.wr)
    k = torch.einsum("bsd,dhk->bshk", xk, p.wk)
    v = torch.einsum("bsd,dhk->bshk", xv, p.wv)
    g = F.silu(xg @ p.wg).reshape(B, S, H, hd)
    dw = torch.einsum("bsl,lhk->bshk", torch.tanh(xw @ p.decay_w1), p.decay_w2)
    logw = -torch.exp((p.w0 + dw).float())                         # (B, S, H, hd) <= 0
    logw = logw.clamp_min(-12.0)
    return r, k, v, g, logw


def _rwkv6_output(cfg: ModelConfig, p: RWKV6TimeMix, y: torch.Tensor, g: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Per-head group norm, ``ln_out``, the gate and ``wo``. y: (B, S, H, hd) f32."""
    hd = y.shape[-1]
    y = rms_norm(y, torch.ones(hd, dtype=torch.float32, device=y.device)) * p.ln_out
    y = (y * g.float()).to(dtype)
    return torch.einsum("bshk,hkd->bsd", y, p.wo)


def rwkv6_init_state(cfg: ModelConfig, batch: int, device: torch.device) -> Dict[str, torch.Tensor]:
    H, hd = rwkv6_dims(cfg)
    return {
        "s": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "x_prev": torch.zeros((batch, cfg.d_model), dtype=torch_dtype(cfg.dtype), device=device),
    }


def rwkv6_forward(cfg: ModelConfig, p: RWKV6TimeMix, x: torch.Tensor,
                  state: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d). Returns (y (B, S, d), new state). A ``None`` state is
    the zero state, and the kernel then skips reading it. A final state
    that the caller does not use (``lpt_loss``) hands the backward no
    gradient, which then starts from zeros without a launch for it."""
    x_prev = (torch.zeros_like(x[:, 0]) if state is None else state["x_prev"])
    r, k, v, g, logw = _rwkv6_inputs(cfg, p, x, x_prev)
    y, s = ops.wkv(r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   logw.transpose(1, 2), p.u, None if state is None else state["s"])
    out = _rwkv6_output(cfg, p, y.transpose(1, 2), g, x.dtype)
    return out, {"s": s, "x_prev": x[:, -1, :]}


def rwkv6_decode(cfg: ModelConfig, p: RWKV6TimeMix, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step, x: (B, 1, d). Returns (y (B, 1, d), new state)."""
    r, k, v, g, logw = _rwkv6_inputs(cfg, p, x, state["x_prev"])
    r_, k_, v_ = (t[:, 0].float() for t in (r, k, v))              # (B, H, hd)
    w = torch.exp(logw[:, 0])
    s = state["s"]
    kv = torch.einsum("bhd,bhe->bhde", k_, v_)
    u = p.u.float()
    y = torch.einsum("bhd,bhde->bhe", r_, s + u[None, :, :, None] * kv)
    s_new = w[..., None] * s + kv
    out = _rwkv6_output(cfg, p, y[:, None], g, x.dtype)
    return out, {"s": s_new, "x_prev": x[:, -1, :]}
