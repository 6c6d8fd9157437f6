"""RWKV6 WKV (data-dependent decay linear attention) on the H100.

Per head, key dim i and value dim j::

    y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
    S[i][j] <- exp(logw_t[i]) S[i][j] + k_t[i] v_t[j]

Counterpart of the TPU kernel ``repro/kernels/rwkv_wkv.py:rwkv6_wkv`` (and
so of the chunked scan ``repro/models/ssm.py:_rwkv6_chunk``); the CUDA source
and the note on its design and bounds are in ``csrc/rwkv_wkv.cu``.

Layout (model layout of the reference's ``ops.wkv``): r, k, v, logw
``(B, H, T, hd)``, any strides with hd contiguous, so the projections'
``(B, T, H, hd)`` tensors are read in place; u ``(H, hd)``; state
``(B, H, hd, hd)`` f32, key dim first. r, k and v are f32 or bf16; logw, u
and the state are f32. Returns y ``(B, H, T, hd)`` f32 and the final state.

``rwkv6_wkv`` launches the kernel for CUDA tensors and uses
``rwkv6_wkv_plain`` only for CPU tensors. ``rwkv6_wkv.launches`` counts the
kernel's launches.

Under autograd (grad enabled and an input requiring it) the call goes
through ``RWKV6WKV``, whose backward is ``rwkv6_wkv_bwd``: the hand-written
kernel of ``csrc/rwkv_wkv_bwd.cu`` for CUDA tensors (counted by
``rwkv6_wkv_bwd.launches``), ``rwkv6_wkv_bwd_plain`` for CPU tensors. The
reference has no such kernel: XLA differentiates its chunked scan.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64,)            # Finch's head size, the one the CUDA kernel is instantiated for


def rwkv6_wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                    u: torch.Tensor, state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence written out in f32, one token at a time
    (the reference's ``kernels/ref.py:rwkv6_wkv_ref``)."""
    B, H, T, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    uu = u.float()[None, :, :, None]                              # (1, H, hd, 1)
    ys = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]          # (B, H, hd, hd)
        ys.append(torch.einsum("bhd,bhde->bhe", rf[:, :, t], s + uu * kv))
        s = w[:, :, t, :, None] * s + kv
    y = (torch.stack(ys, dim=2) if ys
         else torch.zeros((B, H, 0, hd), dtype=torch.float32, device=r.device))
    return y, s


def rwkv6_wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                        u: torch.Tensor, state: Optional[torch.Tensor], dy: torch.Tensor,
                        ds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The reverse-time recurrence written out in f32: every state of a
    forward walk kept, then, with G = dL/dS after token t (dS_T, or zeros,
    at the end), per token t from the last:
    dr_t = S_{t-1} dy_t + u k_t (v_t·dy_t), dk_t = G v_t + r_t u (v_t·dy_t),
    dv_t = Gᵀ k_t + (r_t·(u k_t)) dy_t, dlogw_t = w_t (G ⊙ S_{t-1}) summed
    over the value dim, du += r_t k_t (v_t·dy_t), G <- diag(w_t) G + r_t dy_tᵀ.
    Returns (dr, dk, dv, dlogw, du (H, hd), dS_0), all f32."""
    B, H, T, hd = r.shape
    rf, kf, vf, dyf = r.float(), k.float(), v.float(), dy.float()
    w = torch.exp(logw.float())
    uu = u.float()[None]                                            # (1, H, hd)
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    states = []
    for t in range(T):
        states.append(s)
        s = w[:, :, t, :, None] * s + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    vdy = (vf * dyf).sum(-1)                                       # (B, H, T)
    a = (rf * uu[:, :, None] * kf).sum(-1)                         # (B, H, T)
    G = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if ds is None else ds.float())
    dr, dk, dv, dlogw = (torch.zeros((B, H, T, hd), dtype=torch.float32, device=r.device)
                         for _ in range(4))
    for t in reversed(range(T)):
        p = states[t]
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", p, dyf[:, :, t]) \
            + uu * kf[:, :, t] * vdy[:, :, t, None]
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", G, vf[:, :, t]) \
            + rf[:, :, t] * uu * vdy[:, :, t, None]
        dv[:, :, t] = torch.einsum("bhij,bhi->bhj", G, kf[:, :, t]) \
            + a[:, :, t, None] * dyf[:, :, t]
        dlogw[:, :, t] = w[:, :, t] * (G * p).sum(-1)
        G = w[:, :, t, :, None] * G + rf[:, :, t, :, None] * dyf[:, :, t, None, :]
    du = (rf * kf * vdy[..., None]).sum(dim=(0, 2))
    return dr, dk, dv, dlogw, du, G


def _lib() -> ctypes.CDLL:
    lib = _build.load("rwkv_wkv")
    fn = lib.rwkv6_wkv_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 15
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(name: str, r, k, v, logw, u, state) -> None:
    """What the CUDA kernels take: shapes, dtypes, the head dim."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"{name}: r, k, v, logw must share one (B,H,T,hd) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, H, T, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim={hd} has no CUDA kernel; supported: {HEAD_DIMS}")
    if r.dtype not in (torch.float32, torch.bfloat16) or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"{name}: r, k, v must share one dtype, float32 or bfloat16, "
                         f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"{name}: logw and u must be float32, got {logw.dtype}, {u.dtype}")
    if u.shape != (H, hd) or not u.is_contiguous():
        raise ValueError(f"{name}: u must be a contiguous (H, hd) = {(H, hd)}, "
                         f"got {tuple(u.shape)}")
    if state is not None and (state.shape != (B, H, hd, hd) or state.dtype != torch.float32
                              or not state.is_contiguous()):
        raise ValueError(f"{name}: state must be a contiguous float32 (B, H, hd, hd) = "
                         f"{(B, H, hd, hd)}, got {tuple(state.shape)} {state.dtype}")


def _forward(r, k, v, logw, u, state):
    """(y, final state): the kernel (CUDA tensors) or the plain version."""
    extra = () if state is None else (state,)
    if _build.device_kind(r, k, v, logw, u, *extra) == "cpu":
        return rwkv6_wkv_plain(r, k, v, logw, u, state)
    _check("rwkv6_wkv", r, k, v, logw, u, state)
    _build.check_launchable("rwkv6_wkv", r, k, v, logw, u, *extra)
    B, H, T, hd = r.shape
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device).transpose(1, 2)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return y, s_out
    if T == 0:
        return y, (s_out.zero_() if state is None else s_out.copy_(state))
    strides = [s for t in (r, k, v, logw, y) for s in t.stride()[:3]]
    rc = _lib().rwkv6_wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        *strides, B, H, T, hd, int(r.dtype == torch.bfloat16), _build.stream_ptr(r.device))
    if rc:
        raise RuntimeError(f"rwkv6_wkv: kernel launch failed with CUDA error {rc}")
    rwkv6_wkv.launches += 1
    return y, s_out


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
              u: torch.Tensor, state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw (B, H, T, hd), u (H, hd), state (B, H, hd, hd) f32 or
    None (zeros) -> (y (B, H, T, hd) f32, final state (B, H, hd, hd) f32).
    y is laid out (B, T, H, hd) in memory, as the model reads it back.
    Under autograd the call goes through ``RWKV6WKV``."""
    extra = () if state is None else (state,)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, logw, u, *extra)):
        return RWKV6WKV.apply(r, k, v, logw, u, state)
    return _forward(r, k, v, logw, u, state)


rwkv6_wkv.launches = 0


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("rwkv_wkv_bwd")
    fn = lib.rwkv6_wkv_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_longlong] * 27
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


# Tokens between two of the backward kernels' kept states: the bf16 chunked
# kernel's sub-chunk (csrc/rwkv_wkv_bwd.cu kSub) and the f32 sequential
# kernel's interval (kL). The scratch holds B·H·ceil(T / n) states.
BWD_CHECKPOINT = 16
BWD_CHECKPOINT_F32 = 8


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                  u: torch.Tensor, state: Optional[torch.Tensor], dy: torch.Tensor,
                  ds: Optional[torch.Tensor] = None, *, need_du: bool = True,
                  need_ds0: bool = True) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``rwkv6_wkv`` given its inputs, dL/dy (any strides) and
    dL/d(final state) ``ds`` (None: the final state is unused, and nothing
    is launched for it): (dr, dk, dv in r's dtype and layout (B, T, H, hd)
    in memory, dlogw f32, du (H, hd) f32 summed over batch and time or
    None, dS_0 (B, H, hd, hd) f32 or None). ``need_du`` / ``need_ds0``
    False skip those outputs (dS_0 is also None without a start state).
    The kernels of ``csrc/rwkv_wkv_bwd.cu`` for CUDA tensors (bf16: the
    chunked form on the tensor cores; f32: the sequential recurrence),
    deterministic; ``rwkv6_wkv_bwd_plain`` for CPU tensors."""
    extra = tuple(t for t in (state, ds) if t is not None)
    need_ds0 = need_ds0 and state is not None
    if _build.device_kind(r, k, v, logw, u, dy, *extra) == "cpu":
        dr, dk, dv, dlogw, du, ds0 = rwkv6_wkv_bwd_plain(r, k, v, logw, u, state, dy, ds)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlogw,
                du if need_du else None, ds0 if need_ds0 else None)
    _check("rwkv6_wkv_bwd", r, k, v, logw, u, state)
    B, H, T, hd = r.shape
    if dy.shape != r.shape:
        raise ValueError(f"rwkv6_wkv_bwd: dy must be {tuple(r.shape)}, got {tuple(dy.shape)}")
    dy = dy.float()
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if ds is not None and (ds.shape != (B, H, hd, hd) or ds.dtype != torch.float32):
        raise ValueError("rwkv6_wkv_bwd: ds must be a float32 (B, H, hd, hd)")
    if ds is not None:
        ds = ds.contiguous()
    # the bf16 kernel reads the end states 8 and 16 bytes at a time
    state, ds = (t.clone() if t is not None and t.data_ptr() % 16 else t for t in (state, ds))
    for t in (r, k, v, logw):
        if t.stride(-1) != 1:
            raise ValueError("rwkv6_wkv_bwd: the last dim of every input must be contiguous")
    dev = r.device
    grads = [torch.empty((B, T, H, hd), dtype=dt, device=dev).transpose(1, 2)
             for dt in (r.dtype, r.dtype, r.dtype, torch.float32)]
    du = torch.zeros((H, hd), dtype=torch.float32, device=dev) if need_du else None
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev) if need_ds0 else None
    if B * H == 0 or T == 0:
        for g in grads:
            g.zero_()
        return (*grads, du, None if ds0 is None else
                (ds0.zero_() if ds is None else ds0.copy_(ds)))
    du_part = torch.empty((B, H, hd), dtype=torch.float32, device=dev) if need_du else None
    every = BWD_CHECKPOINT if r.dtype == torch.bfloat16 else BWD_CHECKPOINT_F32
    ckpt = torch.empty(B * H * -(-T // every) * hd * hd, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    strides = [s for t in (r, k, v, logw, dy, *grads) for s in t.stride()[:3]]
    rc = _bwd_lib().rwkv6_wkv_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), ptr(state),
        dy.data_ptr(), ptr(ds), *(g.data_ptr() for g in grads), ptr(du_part), ptr(du), ptr(ds0),
        ckpt.data_ptr(), *strides, B, H, T, hd, int(r.dtype == torch.bfloat16),
        _build.stream_ptr(dev))
    if rc:
        raise RuntimeError(f"rwkv6_wkv_bwd: kernel launch failed with CUDA error {rc}")
    rwkv6_wkv_bwd.launches += 1
    return (*grads, du, ds0)


rwkv6_wkv_bwd.launches = 0


class RWKV6WKV(torch.autograd.Function):
    """``rwkv6_wkv`` with its backward: the forward keeps its inputs (no
    state beyond them: the backward recomputes what it needs); the backward
    is ``rwkv6_wkv_bwd``. An unused final state hands back no gradient, and
    the backward then starts from zeros without a launch for it."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, state)
        return _forward(r, k, v, logw, u, state)

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, logw, u, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dlogw, du, ds0 = rwkv6_wkv_bwd(
            r, k, v, logw, u, state, dy, ds, need_du=ctx.needs_input_grad[4],
            need_ds0=ctx.needs_input_grad[5])
        return dr, dk, dv, dlogw, du, ds0
