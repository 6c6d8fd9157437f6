"""Split-KV flash decode (one-token GQA attention against a KV cache) on the H100.

Counterpart of the TPU kernel ``repro/kernels/flash_decode.py:flash_decode``
and its ``combine_partials``; the CUDA source and the note on its design and
bounds are in ``csrc/flash_decode.cu``.

Layout: q ``(B, H, hd)``, k and v ``(B, Hkv, L, hd)`` (any strides with hd
contiguous, so the model's ``(B, L, Hkv, hd)`` cache is read in place through
a transposed view); query head h reads kv-head ``h // (H // Hkv)``. Column j
is live iff ``j < kv_len``, ``j <= q_pos`` (default ``kv_len - 1``) and, with
a window, ``j > q_pos - window``. The live rows ``[lo, hi)`` are cut into
``splits`` equal partitions; each yields an output normalised by its own
softmax sum and its log-sum-exp (-1e30 when empty), and the partitions are
merged exactly by an LSE-weighted sum. ``splits=None`` sizes the grid to the
card (``auto_splits``) on CUDA and takes the reference's 8 on the CPU; the
split count changes only the order of f32 sums.

``flash_decode`` launches the kernels (partial pass and combine, counted as
one launch in ``flash_decode.launches``) for CUDA tensors and uses
``flash_decode_plain`` only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 112, 128, 256)   # head dims the CUDA kernel is instantiated for
G_TILES = (1, 2, 4, 8)       # query heads one f32 block handles, instantiated
HEADS_PER_BLOCK = 8          # query heads one bf16 block handles (its mma rows)
ROWS_PER_TILE = 64           # cache rows a bf16 block takes per step: 4 warps x 16
DEFAULT_SPLITS = 8           # the reference's split count, used on the CPU


def live_range(L: int, kv_len: Optional[int], q_pos: Optional[int],
               window: int) -> Tuple[int, int]:
    """The live cache rows ``[lo, hi)`` of one decode query."""
    kv = L if kv_len is None else int(kv_len)
    qp = kv - 1 if q_pos is None else int(q_pos)
    hi = min(kv, L, qp + 1)
    lo = max(0, qp - window + 1) if window and window > 0 else 0
    return lo, max(lo, hi)


def rows_per_split(lo: int, hi: int, splits: int) -> int:
    return max(1, -(-(hi - lo) // splits))


def auto_splits(B: int, Hkv: int, G: int, live: int, sms: int) -> int:
    """Partitions of ``live`` rows for one call on a card with ``sms`` SMs:
    as many as give every SM one block, rounded down, and none shorter than
    one tile (``ROWS_PER_TILE``) unless all the live rows are. One block an
    SM already keeps more bytes in flight than the memory needs, and fewer
    partitions leave less to combine. At qwen2-7b's serve shape (B = 16,
    Hkv = 4, G = 7, 132 SMs) that is 2 splits of 16384 rows: 128 blocks."""
    groups = -(-G // HEADS_PER_BLOCK)
    want = sms // max(1, B * Hkv * groups)
    splits = max(1, min(want, live // ROWS_PER_TILE))
    while splits > 1 and live - (splits - 1) * rows_per_split(0, live, splits) < ROWS_PER_TILE:
        splits -= 1
    return splits


def combine_partials_plain(o_part: torch.Tensor, lse: torch.Tensor,
                           dim: int = 2) -> torch.Tensor:
    """Exact LSE combine across split-KV partitions: weights
    ``exp(lse_i - max lse)``, an lse of -1e30 (empty partition) weighted 0;
    a row whose partitions are all empty combines to 0. ``o_part`` is
    ``(..., splits, ..., hd)``, ``lse`` the same without hd."""
    m = lse.amax(dim=dim, keepdim=True)
    w = torch.exp(lse - m.clamp_min(NEG_INF))
    w = torch.where(lse > NEG_INF / 2, w, torch.zeros_like(w))
    denom = w.sum(dim=dim).clamp_min(1e-30)
    return ((o_part * w.unsqueeze(-1)).sum(dim=dim) / denom.unsqueeze(-1)).to(o_part.dtype)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       kv_len: Optional[int] = None, q_pos: Optional[int] = None,
                       window: int = 0, splits: int = DEFAULT_SPLITS) -> torch.Tensor:
    """The same function written out, partition by partition as the kernel
    cuts it: per partition a full f32 softmax over its rows, then the
    combine. Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    G = H // Hkv
    lo, hi = live_range(L, kv_len, q_pos, window)
    per = rows_per_split(lo, hi, splits)
    qf = q.float().reshape(B, Hkv, G, hd)
    o_part = torch.zeros((B, Hkv, splits, G, hd), dtype=torch.float32, device=q.device)
    lse = torch.full((B, Hkv, splits, G), NEG_INF, dtype=torch.float32, device=q.device)
    for s in range(splits):
        r0 = lo + s * per
        r1 = min(r0 + per, hi)
        if r1 <= r0:
            continue                                # an empty partition
        scores = torch.einsum("bhgd,bhld->bhgl", qf, k[:, :, r0:r1].float()) * (1.0 / hd ** 0.5)
        m = scores.amax(dim=-1)
        p = torch.exp(scores - m.unsqueeze(-1))
        den = p.sum(dim=-1)
        o_part[:, :, s] = torch.einsum("bhgl,bhld->bhgd", p, v[:, :, r0:r1].float()) \
            / den.unsqueeze(-1)
        lse[:, :, s] = m + torch.log(den)
    return combine_partials_plain(o_part, lse, dim=2).reshape(B, H, hd).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 8
                   + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def g_tile(G: int) -> int:
    """Query heads per f32 block: the smallest instantiated tile holding
    the group, at most 8 (a larger group takes several blocks)."""
    return next(t for t in G_TILES if t >= min(G, G_TILES[-1]))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_len: Optional[int] = None, q_pos: Optional[int] = None,
                 window: int = 0, splits: Optional[int] = None) -> torch.Tensor:
    """q (B, H, hd), k/v (B, Hkv, L, hd) -> (B, H, hd) in q's dtype.
    ``kv_len`` and ``q_pos`` are Python ints shared across the batch;
    ``splits`` None: ``auto_splits`` on CUDA, 8 on the CPU."""
    if _build.device_kind(q, k, v) == "cpu":
        return flash_decode_plain(q, k, v, kv_len=kv_len, q_pos=q_pos, window=window,
                                  splits=DEFAULT_SPLITS if splits is None else splits)
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_decode: expects q (B,H,hd), k/v (B,Hkv,L,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hkv:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim, or H % Hkv != 0")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim={hd} has no CUDA kernel; "
                         f"supported: {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_decode: q, k, v must share one dtype, float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (splits is not None and splits < 1) or B > 65535:
        raise ValueError(f"flash_decode: needs splits >= 1 and B <= 65535, got "
                         f"splits={splits}, B={B}")
    vec = 16 // q.element_size()
    if any(s % vec for s in (*q.stride()[:2], *k.stride()[:3], *v.stride()[:3])):
        raise ValueError("flash_decode: batch, head and row strides must be "
                         f"multiples of {vec} elements")
    _build.check_launchable("flash_decode", q, k, v)

    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0:
        return out
    lo, hi = live_range(L, kv_len, q_pos, window)
    if splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = auto_splits(B, Hkv, H // Hkv, hi - lo, sms)
    per = rows_per_split(lo, hi, splits)
    o_part = torch.empty((B, H, splits, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, splits), dtype=torch.float32, device=q.device)
    rc = _lib().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o_part.data_ptr(), lse.data_ptr(),
        out.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(2), k.stride(1),
        v.stride(0), v.stride(2), v.stride(1), B, H, Hkv, lo, hi, per, splits, hd,
        int(q.dtype == torch.bfloat16), g_tile(H // Hkv), 1.0 / hd ** 0.5,
        _build.stream_ptr(q.device))
    if rc:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA error {rc}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
