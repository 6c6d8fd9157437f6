"""Attention families: dense GQA, DeepSeek-V2's multi-head latent
attention (MLA) with its absorbed decode, and an encoder-decoder's cross
attention; projections, rotary embedding, the flash kernels and the decode
step against a cache.

Weight layouts are the reference's, so a JAX checkpoint loads without
transposes: GQA ``wq`` (d, H, hd), ``wk``/``wv`` (d, Hkv, hd), ``wo`` (H, hd,
d), biases (H, hd) and (Hkv, hd); MLA ``wq_a`` (d, q_lora), ``wq_b`` (q_lora,
H, nope + rope) or ``wq`` (d, H, nope + rope), ``wkv_a`` (d, r + rope),
``wkv_b_k`` (r, H, nope), ``wkv_b_v`` (r, H, v), ``wo`` (H, v, d).

GQA attention over a full sequence always goes through ``ops.gqa_flash``,
and decode against a contiguous cache prefix through
``ops.gqa_flash_decode``; MLA decode against a contiguous prefix goes through
``ops.mla_flash_decode``: on CUDA tensors the Hopper kernels, on CPU tensors
their plain PyTorch versions. Cross attention goes through
``ops.gqa_flash`` with ``causal=False`` over several queries and through
``ops.gqa_flash_decode`` with every encoder row live for one query. MLA
over a full sequence is the reference's decompressed form through a plain
masked attention, as the reference's is.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import _build, ops
from repro_torch.models.common import Norm, apply_rope

NEG_INF = -1e30


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


def gqa_init_cache(cfg: ModelConfig, batch: int, length: int, dtype: torch.dtype,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """Empty KV cache: roped keys and values (B, L, Hkv, hd) and the
    absolute position of each slot, -1 where the slot is empty."""
    Hkv, hd = cfg.kv_heads(), cfg.resolved_head_dim()
    return {
        "k": torch.zeros((batch, length, Hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, Hkv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def _masked_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             pos: torch.Tensor, q_pos: int, window: int) -> torch.Tensor:
    """One query against every slot of a (possibly wrapped) ring buffer,
    masked by the slots' positions: the counterpart of the reference's XLA
    path (``scaled_attention`` with ``kv_valid``). q (B, 1, H, hd), k/v
    (B, L, Hkv, hd), pos (B, L) -> (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd)
    scores = torch.einsum("bshgd,blhd->bhgsl", qg, k).float() * (1.0 / hd ** 0.5)
    live = (pos >= 0) & (pos <= q_pos)
    if window and window > 0:
        live = live & (pos > q_pos - window)
    scores = scores.masked_fill(~live[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgsl,blhd->bshgd", probs, v).reshape(B, 1, H, hd)


def gqa_decode(cfg: ModelConfig, p: GQAAttention, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], cache_len: int, *,
               window: Optional[int] = None, use_flash: Optional[bool] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of x (B, 1, d) at position ``cache_len`` (a Python
    int: the tokens already cached) against a KV cache from
    ``gqa_init_cache``. With a sliding window the buffer holds ``window``
    slots and insertion wraps at slot ``cache_len % L``.

    Unlike the reference, which returns an updated copy, the new key, value
    and position are written into ``cache`` in place (a serve-size cache is
    tens of GB and cannot be copied every step); ``cache`` is returned.

    The gate follows the reference: with no window and a contiguous prefix
    (``cache_len < L``) attention is ``ops.gqa_flash_decode``, the kernel on
    CUDA and its plain version on the CPU. With a window it is the plain
    position-masked attention, as the reference's is its XLA path. On CUDA
    with no window and ``cache_len >= L`` the prefix has wrapped, so this
    raises rather than leaving the kernel; on the CPU that case takes the
    masked path, as the reference's CPU run does."""
    B = x.shape[0]
    L = cache["k"].shape[1]
    w = cfg.sliding_window if window is None else window
    contiguous = cache_len < L
    if use_flash is None:
        if not w and not contiguous and _build.device_kind(x) == "cuda":
            raise ValueError(
                f"gqa_decode: cache_len={cache_len} has wrapped the {L}-slot cache; the "
                "flash decode kernel needs a contiguous prefix (size the cache to the "
                "sequence, or configure a sliding window)")
        use_flash = not w and contiguous
    elif use_flash and not contiguous:
        raise ValueError(f"gqa_decode: use_flash needs cache_len < {L}, got {cache_len}")
    positions = torch.full((B, 1), cache_len, dtype=torch.long, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    slot = cache_len % L
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][:, slot] = cache_len
    if use_flash:
        out = ops.gqa_flash_decode(q, cache["k"], cache["v"], kv_len=cache_len + 1,
                                   q_pos=cache_len, window=w or 0)
    else:
        out = _masked_decode_attention(q, cache["k"], cache["v"], cache["pos"], cache_len, w)
    return torch.einsum("bshd,hdk->bsk", out, p.wo), cache


# -- MLA (DeepSeek-V2) -------------------------------------------------------------

class MLAAttention(nn.Module):
    """Parameters of one MLA layer (the reference's mla_params); its two
    norms are f32 like every norm."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device, dtype: torch.dtype):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(device=device, dtype=dtype)
        self.wkv_a = nn.Parameter(torch.empty(d, m.kv_lora_rank + m.qk_rope_head_dim, **kw))
        self.kv_norm = Norm(cfg, m.kv_lora_rank, device=device)
        self.wkv_b_k = nn.Parameter(torch.empty(m.kv_lora_rank, H, m.qk_nope_head_dim, **kw))
        self.wkv_b_v = nn.Parameter(torch.empty(m.kv_lora_rank, H, m.v_head_dim, **kw))
        self.wo = nn.Parameter(torch.empty(H, m.v_head_dim, d, **kw))
        if m.q_lora_rank > 0:
            self.wq_a = nn.Parameter(torch.empty(d, m.q_lora_rank, **kw))
            self.q_norm = Norm(cfg, m.q_lora_rank, device=device)
            self.wq_b = nn.Parameter(torch.empty(m.q_lora_rank, H, qk, **kw))
        else:
            self.wq = nn.Parameter(torch.empty(d, H, qk, **kw))


def mla_scale(cfg: ModelConfig) -> float:
    """1/sqrt(nope + rope): the head dim before absorption, not the rank."""
    return 1.0 / (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** 0.5


def _mla_q(cfg: ModelConfig, p: MLAAttention, x: torch.Tensor,
           positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.mla
    if m.q_lora_rank > 0:
        q = torch.einsum("bsr,rhk->bshk", p.q_norm(x @ p.wq_a), p.wq_b)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q[..., :m.qk_nope_head_dim], q_rope


def _mla_latent(cfg: ModelConfig, p: MLAAttention, x: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent row of each position: c_kv (B, S, r) and the roped key
    (B, S, rd) shared by all heads."""
    r = cfg.mla.kv_lora_rank
    kv = x @ p.wkv_a
    c_kv = p.kv_norm(kv[..., :r])
    k_rope = apply_rope(kv[..., r:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_forward(cfg: ModelConfig, p: MLAAttention, x: torch.Tensor, positions: torch.Tensor,
                *, causal: bool = True) -> torch.Tensor:
    """Full-sequence MLA (scoring / prefill) in the decompressed form: K and
    V per head from the latent, then a plain masked attention with qk dim
    nope + rope and v dim v_head_dim, as the reference's
    ``scaled_attention`` computes it (its blockwise branch above 4096 keys
    is the same function up to rounding). ``positions`` (B, S) are absolute."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p.wkv_b_k)
    v = torch.einsum("bsr,rhk->bshk", c_kv, p.wkv_b_v)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    scores = torch.einsum("bshd,blhd->bhsl", q, k).float() * mla_scale(cfg)
    mask = torch.ones((B, S, S), dtype=torch.bool, device=x.device)
    if causal:
        mask = positions[:, None, :] <= positions[:, :, None]
    if cfg.sliding_window and cfg.sliding_window > 0:
        mask = mask & (positions[:, None, :] > positions[:, :, None] - cfg.sliding_window)
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhsl,blhd->bshd", probs, v)
    return torch.einsum("bshv,hvd->bsd", out, p.wo)


def mla_init_cache(cfg: ModelConfig, batch: int, length: int, dtype: torch.dtype,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """Empty latent cache: c_kv (B, L, r), k_rope (B, L, rd) and the absolute
    position of each slot, -1 where the slot is empty."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, length, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, length, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def mla_decode(cfg: ModelConfig, p: MLAAttention, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], cache_len: int, *,
               use_flash: Optional[bool] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed MLA decode of x (B, 1, d) at position ``cache_len`` (a Python
    int) against a latent cache from ``mla_init_cache``: ``wkv_b_k`` is
    absorbed into the query, attention runs over the latent rows
    (``ops.mla_flash_decode``), its output is decompressed through
    ``wkv_b_v`` and projected by ``wo``. The new latent row and position go
    to slot ``cache_len % L``, written into ``cache`` in place (the
    reference returns an updated copy); ``cache`` is returned.

    The gate follows ``gqa_decode``: on a contiguous prefix (``cache_len <
    L``) the kernel, on CUDA, or its plain version on the CPU. A wrapped
    cache raises on CUDA rather than leaving the kernel, and takes the
    position-masked path on the CPU, as the reference's CPU run does."""
    B = x.shape[0]
    L = cache["c_kv"].shape[1]
    contiguous = cache_len < L
    if use_flash is None:
        if not contiguous and _build.device_kind(x) == "cuda":
            raise ValueError(
                f"mla_decode: cache_len={cache_len} has wrapped the {L}-slot cache; the "
                "latent decode kernel needs a contiguous prefix (size the cache to the "
                "sequence)")
        use_flash = contiguous
    elif use_flash and not contiguous:
        raise ValueError(f"mla_decode: use_flash needs cache_len < {L}, got {cache_len}")
    positions = torch.full((B, 1), cache_len, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions)                   # (B, 1, H, *)
    c_new, kr_new = _mla_latent(cfg, p, x, positions)
    slot = cache_len % L
    cache["c_kv"][:, slot] = c_new[:, 0]
    cache["k_rope"][:, slot] = kr_new[:, 0]
    cache["pos"][:, slot] = cache_len
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p.wkv_b_k)       # (B, 1, H, r)
    scale = mla_scale(cfg)
    if use_flash:
        out_lat = ops.mla_flash_decode(q_lat.contiguous(), q_rope.contiguous(), cache["c_kv"],
                                       cache["k_rope"], scale=scale, kv_len=cache_len + 1,
                                       q_pos=cache_len)
    else:
        c_kv = cache["c_kv"]
        scores = (torch.einsum("bshr,blr->bhsl", q_lat, c_kv)
                  + torch.einsum("bshk,blk->bhsl", q_rope, cache["k_rope"])).float()
        live = (cache["pos"] >= 0) & (cache["pos"] <= cache_len)
        scores = torch.where(live[:, None, None, :], scores * scale,
                             torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
        out_lat = torch.einsum("bhsl,blr->bshr", probs, c_kv)
    out = torch.einsum("bshr,rhv->bshv", out_lat, p.wkv_b_v)
    return torch.einsum("bshv,hvd->bsd", out, p.wo), cache


# -- cross attention (encoder-decoder) ---------------------------------------------

def cross_attention(cfg: ModelConfig, p: GQAAttention, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """x (B, S, d) against the encoder's keys and values ``enc_kv``, each
    (B, Lenc, Hkv, hd) from ``encode_cross_kv``; ``p`` is a
    ``GQAAttention``, as the reference's ``cross_attention_params`` are
    ``gqa_params``. No rotary embedding and no mask: every encoder row is
    live. S > 1 (a forward) runs ``ops.gqa_flash`` with ``causal=False``;
    S = 1 (a decode step) runs ``ops.gqa_flash_decode`` with ``kv_len =
    q_pos + 1 = Lenc``, since one query needs no 64-row query tile. The
    reference's ``enc_valid`` mask has no caller there and is not taken."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    if cfg.qkv_bias:
        q = q + p.bq
    k, v = enc_kv
    if x.shape[1] == 1:
        Lenc = k.shape[1]
        out = ops.gqa_flash_decode(q, k, v, kv_len=Lenc, q_pos=Lenc - 1)
    else:
        out = ops.gqa_flash(q, k, v, causal=False)
    return torch.einsum("bshd,hdk->bsk", out, p.wo)


def encode_cross_kv(cfg: ModelConfig, p: GQAAttention, enc_out: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross keys and values from the encoder's output
    (B, Lenc, d): each (B, Lenc, Hkv, hd), unroped."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p.wk)
    v = torch.einsum("bsd,dhk->bshk", enc_out, p.wv)
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return k, v
