"""Absorbed multi-head latent attention (DeepSeek-V2 MLA) for one decode
token, split over the latent cache, on the H100.

Counterpart of the TPU kernel ``repro/kernels/mla_decode.py:mla_decode``;
the CUDA source and the note on its design and bounds are in
``csrc/mla_decode.cu``.

Layout: q_lat ``(B, H, r)``, q_pe ``(B, H, rd)``, ckv ``(B, L, r)``, kpe
``(B, L, rd)`` -> ``(B, H, r)`` in q_lat's dtype; every head reads the one
latent row of each position, and ckv doubles as the value. Column j is live
iff ``j < kv_len`` and ``j <= q_pos`` (default ``kv_len - 1``); ``scale`` is
1/sqrt(nope + rope), the head dim before absorption, not r. The live rows
are cut into ``splits`` equal partitions; each yields an output normalised
by its own softmax sum and its log-sum-exp (-1e30 when empty), merged
exactly by the LSE combine that ``flash_decode`` uses.

``mla_decode`` launches the kernels (partial pass and combine, counted as
one launch in ``mla_decode.launches``) for CUDA tensors and uses
``mla_decode_plain`` only for CPU tensors. The CUDA kernel is instantiated
for (r, rd) = (512, 64), the dims of deepseek-v2 and kimi-k2.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import (DEFAULT_SPLITS, NEG_INF, combine_partials_plain,
                                              live_range, rows_per_split)

DIMS = (512, 64)          # (kv_lora_rank, rope dim) the CUDA kernel is instantiated for
HEADS_PER_BLOCK = {torch.bfloat16: 64, torch.float32: 32}   # query heads one block handles
ROWS_PER_TILE = {torch.bfloat16: 64, torch.float32: 32}     # cache rows a block takes per step
WAVES = {torch.bfloat16: 1, torch.float32: 2}   # blocks of one call fill the card (one an SM)
                                                # at most this many times


def mla_decode_plain(q_lat: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
                     kpe: torch.Tensor, *, scale: float, kv_len: Optional[int] = None,
                     q_pos: Optional[int] = None, splits: int = DEFAULT_SPLITS) -> torch.Tensor:
    """The same function written out, partition by partition as the kernel
    cuts it: per partition a full f32 softmax over its rows, then the LSE
    combine. Returns (B, H, r) in q_lat's dtype."""
    B, H, r = q_lat.shape
    lo, hi = live_range(ckv.shape[1], kv_len, q_pos, 0)
    per = rows_per_split(lo, hi, splits)
    ql, qp = q_lat.float(), q_pe.float()
    o_part = torch.zeros((B, H, splits, r), dtype=torch.float32, device=q_lat.device)
    lse = torch.full((B, H, splits), NEG_INF, dtype=torch.float32, device=q_lat.device)
    for s in range(splits):
        r0 = lo + s * per
        r1 = min(r0 + per, hi)
        if r1 <= r0:
            continue                                # an empty partition
        c = ckv[:, r0:r1].float()
        scores = (torch.einsum("bhr,blr->bhl", ql, c)
                  + torch.einsum("bhp,blp->bhl", qp, kpe[:, r0:r1].float())) * scale
        m = scores.amax(dim=-1)
        p = torch.exp(scores - m.unsqueeze(-1))
        den = p.sum(dim=-1)
        o_part[:, :, s] = torch.einsum("bhl,blr->bhr", p, c) / den.unsqueeze(-1)
        lse[:, :, s] = m + torch.log(den)
    return combine_partials_plain(o_part, lse, dim=2).to(q_lat.dtype)


def auto_splits(B: int, H: int, live: int, sms: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """Partitions of the live rows for one call on a card with ``sms`` SMs:
    as many as fill the SMs at most ``WAVES`` times (rounding down, so that
    no last wave runs a few blocks alone), and none shorter than one tile
    unless all the live rows are. Fewer, longer partitions leave fewer f32
    partials to write and combine. At deepseek-v2's serve shape in bf16
    (B = 16, two groups of 64 heads, 132 SMs) that is 4 splits of 8192 rows:
    128 blocks; at long_500k's (B = 1) 66 splits: 132 blocks."""
    groups = -(-H // HEADS_PER_BLOCK[dtype])
    want = WAVES[dtype] * sms // max(1, B * groups)
    return max(1, min(want, live // ROWS_PER_TILE[dtype]))


def _tma_strides(t: torch.Tensor) -> tuple:
    """(batch stride, row stride) of a 3-d input in elements, with any dim of
    size 1 given the packed stride: TMA reads no stride of a size-1 dim, but
    takes only strides that are positive multiples of 16 bytes."""
    row = t.stride(1) if t.shape[1] > 1 else t.shape[2]
    return (t.stride(0) if t.shape[0] > 1 else t.shape[1] * row), row


def _lib() -> ctypes.CDLL:
    lib = _build.load("mla_decode")
    fn = lib.mla_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def mla_decode(q_lat: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
               kpe: torch.Tensor, *, scale: float, kv_len: Optional[int] = None,
               q_pos: Optional[int] = None, splits: Optional[int] = None) -> torch.Tensor:
    """q_lat (B, H, r), q_pe (B, H, rd), ckv (B, L, r), kpe (B, L, rd) ->
    (B, H, r) in q_lat's dtype. ``kv_len`` and ``q_pos`` are Python ints
    shared across the batch; ``splits`` None lets the kernel's wrapper
    choose from B, H, the live length and the SM count (8 on the CPU). The
    split count changes only the order of f32 sums."""
    if _build.device_kind(q_lat, q_pe, ckv, kpe) == "cpu":
        return mla_decode_plain(q_lat, q_pe, ckv, kpe, scale=scale, kv_len=kv_len,
                                q_pos=q_pos, splits=splits or DEFAULT_SPLITS)
    if q_lat.dim() != 3 or q_pe.dim() != 3 or ckv.dim() != 3 or kpe.dim() != 3:
        raise ValueError("mla_decode: expects q_lat (B,H,r), q_pe (B,H,rd), ckv (B,L,r), kpe "
                         f"(B,L,rd), got {tuple(q_lat.shape)}, {tuple(q_pe.shape)}, "
                         f"{tuple(ckv.shape)}, {tuple(kpe.shape)}")
    B, H, r = q_lat.shape
    L, rd = ckv.shape[1], kpe.shape[2]
    if (q_pe.shape[:2] != (B, H) or ckv.shape[0] != B or ckv.shape[2] != r
            or kpe.shape[:2] != (B, L) or q_pe.shape[2] != rd):
        raise ValueError(f"mla_decode: shapes disagree: q_lat {tuple(q_lat.shape)}, q_pe "
                         f"{tuple(q_pe.shape)}, ckv {tuple(ckv.shape)}, kpe {tuple(kpe.shape)}")
    if (r, rd) != DIMS:
        raise ValueError(f"mla_decode: (kv_lora_rank, rope dim) = ({r}, {rd}) has no CUDA "
                         f"kernel; supported: {DIMS}")
    dtype = q_lat.dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dtype for t in (q_pe, ckv, kpe)):
        raise ValueError("mla_decode: q_lat, q_pe, ckv, kpe must share one dtype, float32 or "
                         f"bfloat16, got {[t.dtype for t in (q_lat, q_pe, ckv, kpe)]}")
    if (splits is not None and splits < 1) or B > 65535:
        raise ValueError(f"mla_decode: needs splits >= 1 and B <= 65535, got splits={splits}, "
                         f"B={B}")
    out = torch.empty((B, H, r), dtype=dtype, device=q_lat.device)
    if B == 0 or H == 0:
        return out
    for name, t in (("q_lat", q_lat), ("q_pe", q_pe), ("ckv", ckv), ("kpe", kpe)):
        if t.data_ptr() % 16:
            raise ValueError(f"mla_decode: {name} starts {t.data_ptr() % 16} bytes past a 16-byte "
                             "boundary; the kernel's TMA loads need 16-byte aligned bases (a view "
                             f"offset by a multiple of {16 // t.element_size()} elements is taken)")
    _build.check_launchable("mla_decode", q_lat, q_pe, ckv, kpe)
    vec = 16 // q_lat.element_size()
    strides = [s for t in (q_lat, q_pe, ckv, kpe) for s in _tma_strides(t)]
    if any(s <= 0 or s % vec for s in strides):
        raise ValueError(f"mla_decode: batch, head and row strides must be positive multiples "
                         f"of {vec} elements (16 bytes), got {strides}")

    lo, hi = live_range(L, kv_len, q_pos, 0)
    if splits is None:
        splits = auto_splits(B, H, hi - lo,
                             torch.cuda.get_device_properties(q_lat.device).multi_processor_count,
                             dtype)
    splits = min(splits, 65535)
    per = rows_per_split(lo, hi, splits)
    o_part = torch.empty((B, H, splits, r), dtype=torch.float32, device=q_lat.device)
    lse = torch.empty((B, H, splits), dtype=torch.float32, device=q_lat.device)
    rc = _lib().mla_decode_launch(
        q_lat.data_ptr(), q_pe.data_ptr(), ckv.data_ptr(), kpe.data_ptr(), o_part.data_ptr(),
        lse.data_ptr(), out.data_ptr(), *strides, B, H, hi, per, splits, r, rd,
        int(dtype == torch.bfloat16), float(scale),
        _build.stream_ptr(q_lat.device))
    if rc:
        raise RuntimeError(f"mla_decode: kernel launch failed with CUDA error {rc}")
    mla_decode.launches += 1
    return out


mla_decode.launches = 0
