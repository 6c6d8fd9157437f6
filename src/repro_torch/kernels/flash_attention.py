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

Under autograd (grad enabled and an input that requires it) the call goes
through ``FlashAttention``: its forward also keeps each row's log-sum-exp,
and its backward is ``flash_attention_bwd``, the CUDA kernels of
``csrc/flash_attention_bwd.cu`` for CUDA tensors and
``flash_attention_bwd_plain`` for CPU tensors (``flash_attention_bwd.
launches`` counts the kernel's launches). The reference has no such
kernel: it differentiates its attention through XLA.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 112, 128, 256)   # head dims the CUDA forward kernels are built for
BWD_HEAD_DIMS = (64, 112, 128)    # and the backward's: at 256 its bf16 tiles pass 227 KB


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


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool, window: int, q_offset: int,
            kv_len: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scaled f32 scores (B, Hkv, G, S, L), masked with -1e30, and the
    live mask (S, L)."""
    B, H, S, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, H // Hkv, S, hd)
    scores = torch.einsum("bhgsd,bhld->bhgsl", qf, k.float()) * (1.0 / hd ** 0.5)
    live = _live_mask(S, L, causal=causal, window=window, q_offset=q_offset,
                      kv_len=kv_len, device=q.device)
    return scores.masked_fill(~live, NEG_INF), live


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0, q_offset: int = 0,
                          kv_len: Optional[int] = None, return_lse: bool = False):
    """The same function written out: full f32 scores, masked with -1e30,
    softmax, then P·V. Returns (B, H, S, hd) in q's dtype, and with
    ``return_lse`` also each row's log-sum-exp (B, H, S) f32 (about -1e30
    for a row with no live column)."""
    B, H, S, hd = q.shape
    scores, live = _scores(q, k, causal=causal, window=window, q_offset=q_offset,
                           kv_len=kv_len)
    probs = torch.softmax(scores, dim=-1) * live      # a row with no live column gives 0
    out = torch.einsum("bhgsl,bhld->bhgsd", probs, v.float()).reshape(B, H, S, hd).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).reshape(B, H, S)
    return out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True, window: int = 0, q_offset: int = 0,
                              kv_len: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward written out in f32, as the kernel computes it: P from the
    saved log-sum-exp, D = rowsum(dout ∘ out), dS = P ∘ (dout·Vᵀ − D);
    dq = scale·dS·K, dk = scale·dSᵀ·Q and dv = Pᵀ·dout, dk and dv summed
    over each KV head's query heads. Each in its input's dtype."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    G, scale = H // Hkv, 1.0 / hd ** 0.5
    scores, live = _scores(q, k, causal=causal, window=window, q_offset=q_offset,
                           kv_len=kv_len)
    p = torch.exp(scores - lse.float().reshape(B, Hkv, G, S)[..., None]) * live
    do = dout.float().reshape(B, Hkv, G, S, hd)
    delta = (do * out.float().reshape(B, Hkv, G, S, hd)).sum(dim=-1)
    dp = torch.einsum("bhgsd,bhld->bhgsl", do, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgsl,bhld->bhgsd", ds, k.float()) * scale
    dk = torch.einsum("bhgsl,bhgsd->bhld", ds, q.float().reshape(B, Hkv, G, S, hd)) * scale
    dv = torch.einsum("bhgsl,bhgsd->bhld", p, do)
    return dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 24
                   + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str,
           head_dims: Tuple[int, ...], *others) -> None:
    """What the CUDA kernels take: shapes, the head dims of the calling
    direction's kernels (``HEAD_DIMS`` or ``BWD_HEAD_DIMS``), dtypes and
    strides."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: expects q (B,H,S,hd), k/v (B,Hkv,L,hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim, or H % Hkv != 0")
    if hd not in head_dims:
        raise ValueError(f"{name}: head_dim={hd} has no CUDA kernel; "
                         f"supported: {head_dims}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype, float32 "
                         f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    vec = 16 // q.element_size()
    for t in (q, k, v, *others):
        if any(s % vec for s in t.stride()[:3]):
            raise ValueError("flash_attention: batch, head and sequence strides "
                             f"must be multiples of {vec} elements")
    _build.check_launchable(name, q, k, v, *others)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
             window: int, q_offset: int, kv_len: Optional[int], with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel (CUDA tensors) or the plain version (CPU tensors); the
    log-sum-exp too when ``with_lse``."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    if _build.device_kind(q, k, v) == "cpu":
        if with_lse:
            return flash_attention_plain(q, k, v, return_lse=True, **kw)
        return flash_attention_plain(q, k, v, **kw), None
    _check(q, k, v, "flash_attention", HEAD_DIMS)
    B, H, S, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    out = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or H == 0 or S == 0:
        return out, lse
    kv = L if kv_len is None else int(kv_len)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    rc = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, *strides,
        B, H, Hkv, S, L, kv, int(q_offset), int(bool(causal)), int(window or 0),
        hd, int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5,
        _build.stream_ptr(q.device))
    if rc:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_len: Optional[int] = None, return_lse: bool = False):
    """q (B, H, S, hd), k/v (B, Hkv, L, hd) -> (B, H, S, hd) in q's dtype,
    and with ``return_lse`` also each row's log-sum-exp (B, H, S) f32.

    Inputs may be strided views (the model passes its (B, S, H, hd)
    tensors transposed) as long as the head dim is contiguous. Under
    autograd the call goes through ``FlashAttention``."""
    kw = dict(causal=causal, window=window or 0, q_offset=q_offset, kv_len=kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if return_lse:
            raise ValueError("flash_attention: return_lse is not differentiable")
        return FlashAttention.apply(q, k, v, kw)
    out, lse = _forward(q, k, v, with_lse=return_lse, **kw)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


# Query rows of one step of the bf16 backward (csrc/flash_attention_bwd.cu):
# its f32 scratch is padded to a multiple of it. Its tiles are whole 64-column
# blocks: head dim 112 runs padded to 128.
BWD_QUERY_TILE = 64
BWD_COLUMN_BLOCK = 64


def bwd_padded_head_dim(hd: int) -> int:
    """The bf16 backward's tile width for head dim ``hd``: ``hd`` rounded up
    to whole 64-column blocks (112 -> 128)."""
    return -(-hd // BWD_COLUMN_BLOCK) * BWD_COLUMN_BLOCK


def bwd_work_floats(B: int, H: int, S: int, hd: int, dtype: torch.dtype) -> int:
    """f32 scratch of one backward call: bf16 keeps each padded query row's
    log-sum-exp (log2 units), D and its f32 dQ sums at the padded width;
    f32 keeps D."""
    if dtype == torch.bfloat16:
        return (B * H * (-(-S // BWD_QUERY_TILE) * BWD_QUERY_TILE)
                * (2 + bwd_padded_head_dim(hd)))
    return B * H * S


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0, kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` given the forward's inputs, its
    output, the output's gradient and the saved log-sum-exp: the kernels of
    ``csrc/flash_attention_bwd.cu`` for CUDA tensors, the plain version for
    CPU tensors. dq has q's shape, dk and dv k's; all contiguous. In bf16 dq
    is summed over KV tiles by atomic adds, in an order that changes from
    run to run (f32 rounding); dk, dv and the f32 path are deterministic.
    On CUDA a head dim with no backward kernel (``BWD_HEAD_DIMS``; 256 has
    a forward only) raises ``ValueError`` before any launch."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    if _build.device_kind(q, k, v, out, dout, lse) == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    vec = 16 // q.element_size()
    if dout.stride(-1) != 1 or any(s % vec for s in dout.stride()[:3]):
        dout = dout.contiguous()
    _check(q, k, v, "flash_attention_bwd", BWD_HEAD_DIMS, out, dout)
    B, H, S, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be ({B}, {H}, {S}) f32 contiguous")
    dq = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, L, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Hkv, L, hd), dtype=v.dtype, device=q.device)
    if B == 0 or H == 0 or S == 0 or L == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    work = torch.empty(bwd_work_floats(B, H, S, hd, q.dtype), dtype=torch.float32,
                       device=q.device)
    kv = L if kv_len is None else int(kv_len)
    strides = [s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]]
    rc = _bwd_lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), work.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *strides, B, H, Hkv, S, L, kv, int(q_offset), int(bool(causal)), int(window or 0),
        hd, int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5, _build.stream_ptr(q.device))
    if rc:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward keeps q, k, v, the
    output and the log-sum-exp; the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = _forward(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.kw)
        return dq, dk, dv, None
