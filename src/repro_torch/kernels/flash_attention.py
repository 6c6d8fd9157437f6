"""Flash attention (GQA, causal / sliding-window, KV-length aware) on the H100.

Counterpart of the TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``; the CUDA source and the note on its design and bounds
are in ``csrc/flash_attention.cu``.

Layout (head-major): q ``(B, H, S, hd)``, k and v ``(B, Hkv, L, hd)``; the
KV head of query head h is ``h // (H // Hkv)``. Query row i sits at
position ``q_offset + i``; column j is live iff ``j < kv_len``,
``j <= q_offset + i`` when causal and ``j > q_offset + i - window`` when
``window > 0``. A row with no live column gives 0.

``flash_attention`` launches the kernel for CUDA tensors and uses
``flash_attention_plain`` only for CPU tensors. ``flash_attention.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)        # head dims the CUDA kernel is instantiated for


def _live_mask(S: int, L: int, *, causal: bool, window: int, q_offset: int,
               kv_len: Optional[int], device: torch.device) -> torch.Tensor:
    qpos = q_offset + torch.arange(S, device=device)
    kpos = torch.arange(L, device=device)
    live = (kpos < (L if kv_len is None else kv_len))[None, :].expand(S, L)
    if causal:
        live = live & (kpos[None, :] <= qpos[:, None])
    if window and window > 0:
        live = live & (kpos[None, :] > qpos[:, None] - window)
    return live


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0, q_offset: int = 0,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """The same function written out: full f32 scores, masked with -1e30,
    softmax, then P·V. Returns (B, H, S, hd) in q's dtype."""
    B, H, S, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, S, hd)
    scores = torch.einsum("bhgsd,bhld->bhgsl", qf, k.float()) * (1.0 / hd ** 0.5)
    live = _live_mask(S, L, causal=causal, window=window, q_offset=q_offset,
                      kv_len=kv_len, device=q.device)
    scores = scores.masked_fill(~live, NEG_INF)
    probs = torch.softmax(scores, dim=-1) * live      # a row with no live column gives 0
    out = torch.einsum("bhgsl,bhld->bhgsd", probs, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, H, S, hd), k/v (B, Hkv, L, hd) -> (B, H, S, hd) in q's dtype.

    Inputs may be strided views (the model passes its (B, S, H, hd)
    tensors transposed) as long as the head dim is contiguous."""
    if _build.device_kind(q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, kv_len=kv_len)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: expects q (B,H,S,hd), k/v (B,Hkv,L,hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim, or H % Hkv != 0")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim={hd} has no CUDA kernel; "
                         f"supported: {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype, float32 "
                         f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    vec = 16 // q.element_size()
    for t in (q, k, v):
        if any(s % vec for s in t.stride()[:3]):
            raise ValueError("flash_attention: batch, head and sequence strides "
                             f"must be multiples of {vec} elements")
    _build.check_launchable("flash_attention", q, k, v)

    out = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0 or S == 0:
        return out
    kv = L if kv_len is None else int(kv_len)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        B, H, Hkv, S, L, kv, int(q_offset), int(bool(causal)), int(window or 0),
        hd, int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5,
        _build.stream_ptr(q.device))
    if rc:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
