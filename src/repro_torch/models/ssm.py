"""RWKV6 (Finch) time mixing, the attention-free block of the RWKV6 family,
and the Mamba2 (SSD) mixer of the Zamba2 hybrid.

Counterpart of the reference's ``models/ssm.py``, with its parameter names,
shapes and numerics. The reference runs the WKV recurrence
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

Mamba2: the reference runs its chunked SSD scan in ``jnp`` outside any
Pallas kernel, and so this is plain PyTorch on both devices (a fused SSD
kernel is speed work for later). The chunks' intra-chunk products run for
all chunks at once; only the carry of the state from chunk to chunk is a
loop. ``B`` and ``C`` are one group shared by every head, so they are
contracted without the reference's broadcast to (B, H, S, state): at
zamba2-7b's 112 heads and 16 x 513 positions that broadcast is about 300 MB
a tensor in f32. State: ``h`` (B, H, state, 64) f32 and the conv tail
``conv`` (B, conv_width - 1, d_inner + 2·state) in the activation dtype.
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


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

MAMBA2_HEAD_DIM = 64    # fixed, as in the reference


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head dim) of the Mamba2 mixer."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // MAMBA2_HEAD_DIM, MAMBA2_HEAD_DIM


class Mamba2Mixer(nn.Module):
    """Parameters of one Mamba2 mixer (the reference's mamba2_params).
    ``dt_bias``, ``a_log``, ``d_skip`` and ``norm_g`` are f32 whatever the
    parameter dtype."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d, ds = cfg.d_model, cfg.ssm.state_size
        d_inner, H, _ = mamba2_dims(cfg)

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dt))

        self.in_z = param(d, d_inner)
        self.in_x = param(d, d_inner)
        self.in_B = param(d, ds)
        self.in_C = param(d, ds)
        self.in_dt = param(d, H)
        self.dt_bias = param(H, dt=torch.float32)
        self.conv_w = param(cfg.ssm.conv_width, d_inner + 2 * ds)
        self.conv_b = param(d_inner + 2 * ds)
        self.a_log = param(H, dt=torch.float32)
        self.d_skip = param(H, dt=torch.float32)
        self.norm_g = param(d_inner, dt=torch.float32)
        self.out = param(d_inner, d)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, then SiLU. xBC (B, S, C); w (W, C); init_state
    (B, W - 1, C), zeros when None. Returns (out (B, S, C), the last W - 1
    inputs (B, W - 1, C), the next call's init_state)."""
    W, S = w.shape[0], xBC.shape[1]
    if init_state is None:
        init_state = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[-1]))
    xp = torch.cat([init_state.to(xBC.dtype), xBC], dim=1)
    out = xp[:, :S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out + b), xp[:, -(W - 1):]


def mamba2_init_state(cfg: ModelConfig, batch: int, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    ds = cfg.ssm.state_size
    d_inner, H, hd = mamba2_dims(cfg)
    return {
        "h": torch.zeros((batch, H, ds, hd), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, d_inner + 2 * ds),
                            dtype=torch_dtype(cfg.dtype), device=device),
    }


def _mamba2_proj(p: Mamba2Mixer, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """z (B, S, d_inner), xBC (B, S, d_inner + 2·state) and dt (B, S, H) f32."""
    z = x @ p.in_z
    xBC = torch.cat([x @ p.in_x, x @ p.in_B, x @ p.in_C], dim=-1)
    dt = F.softplus((x @ p.in_dt).float() + p.dt_bias)
    return z, xBC, dt


def _mamba2_split(cfg: ModelConfig, xBC: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    ds = cfg.ssm.state_size
    d_inner = mamba2_dims(cfg)[0]
    return xBC[..., :d_inner], xBC[..., d_inner:d_inner + ds], xBC[..., d_inner + ds:]


def _mamba2_output(p: Mamba2Mixer, y: torch.Tensor, z: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The gate, the f32 rms norm with ``norm_g`` and ``out``. y (B, S, d_inner) f32."""
    return rms_norm(y * F.silu(z.float()), p.norm_g).to(dtype) @ p.out


def mamba2_forward(cfg: ModelConfig, p: Mamba2Mixer, x: torch.Tensor,
                   state: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d). Returns (y (B, S, d), the state after the last token).

    The reference's chunked scan with its numerics: x, B, C and dt in f32,
    chunks of ``Lc = min(chunk_size, S)``, a last chunk padded with zeros
    (dt = 0 and log-decay 0 carry the state through it unchanged), and
    within a chunk the decay matrix ``exp(min(cum_i - cum_j, 0))`` on and
    below the diagonal."""
    B, S, _ = x.shape
    ds = cfg.ssm.state_size
    d_inner, H, hd = mamba2_dims(cfg)
    Lc = min(cfg.ssm.chunk_size, S)
    z, xBC, dt = _mamba2_proj(p, x)
    xBC, conv_state = _causal_conv(xBC, p.conv_w, p.conv_b,
                                   None if state is None else state["conv"])
    xh, Bm, C = _mamba2_split(cfg, xBC)
    loglam = dt * -torch.exp(p.a_log)                              # (B, S, H) <= 0

    n = -(-S // Lc)
    pad = n * Lc - S
    xf = xh.float().reshape(B, S, H, hd).transpose(1, 2)           # (B, H, S, hd)
    Bf, Cf = Bm.float(), C.float()                                 # (B, S, ds)
    dt3, ll3 = dt.transpose(1, 2), loglam.transpose(1, 2)          # (B, H, S)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        Bf, Cf = F.pad(Bf, (0, 0, 0, pad)), F.pad(Cf, (0, 0, 0, pad))
        dt3, ll3 = F.pad(dt3, (0, pad)), F.pad(ll3, (0, pad))
    xc = xf.reshape(B, H, n, Lc, hd)
    Bc, Cc = Bf.reshape(B, n, Lc, ds), Cf.reshape(B, n, Lc, ds)
    dtc, cum = dt3.reshape(B, H, n, Lc), ll3.reshape(B, H, n, Lc).cumsum(-1)

    # within each chunk: y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    tri = torch.ones(Lc, Lc, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri, torch.exp((cum[..., :, None] - cum[..., None, :]).clamp_max(0.0)),
                        0.0)                                       # (B, H, n, Lc, Lc)
    score = torch.einsum("bnis,bnjs->bnij", Cc, Bc)[:, None] * decay * dtc[..., None, :]
    y = torch.einsum("bhnij,bhnjd->bhnid", score, xc)
    # each chunk's own contribution to the state at its end, then the carry
    w = dtc * torch.exp(cum[..., -1:] - cum)
    dh = torch.einsum("bnjs,bhnjd->bhnsd", Bc, xc * w[..., None])  # (B, H, n, ds, hd)
    lam = torch.exp(cum[..., -1])                                  # (B, H, n)
    h = (torch.zeros((B, H, ds, hd), dtype=torch.float32, device=x.device)
         if state is None else state["h"])
    starts = []
    for c in range(n):
        starts.append(h)
        h = lam[:, :, c, None, None] * h + dh[:, :, c]
    y = y + torch.einsum("bnis,bhnsd->bhnid", Cc, torch.stack(starts, dim=2)) \
        * torch.exp(cum)[..., None]

    y = y.reshape(B, H, n * Lc, hd)[:, :, :S] + p.d_skip[None, :, None, None] * xf[:, :, :S]
    y = y.transpose(1, 2).reshape(B, S, d_inner)
    return _mamba2_output(p, y, z, x.dtype), {"h": h, "conv": conv_state}


def mamba2_decode(cfg: ModelConfig, p: Mamba2Mixer, x: torch.Tensor,
                  state: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step, x: (B, 1, d). Returns (y (B, 1, d), new state)."""
    B = x.shape[0]
    d_inner, H, hd = mamba2_dims(cfg)
    z, xBC, dt = _mamba2_proj(p, x)
    xBC, conv_state = _causal_conv(xBC, p.conv_w, p.conv_b, state["conv"])
    xh, Bm, C = _mamba2_split(cfg, xBC)
    xh = xh[:, 0].float().reshape(B, H, hd)
    Bm, C, dt1 = Bm[:, 0].float(), C[:, 0].float(), dt[:, 0]       # (B, ds), (B, H)
    lam = torch.exp(dt1 * -torch.exp(p.a_log))
    h = state["h"] * lam[..., None, None] + torch.einsum("bn,bhd->bhnd", Bm,
                                                          xh * dt1[..., None])
    y = torch.einsum("bn,bhnd->bhd", C, h) + p.d_skip[None, :, None] * xh
    return (_mamba2_output(p, y.reshape(B, 1, d_inner), z, x.dtype),
            {"h": h, "conv": conv_state})
