"""Fused prompt-score cross-entropy: the Prompt Bank hot spot on the H100.

Per-token NLL ``(T,)`` f32 of ``softmax(hidden @ emb.T)`` at ``labels``,
without materialising the ``(T, V)`` logits. Counterpart of the TPU kernel
``repro/kernels/score_ce.py:score_ce``; the CUDA source and the note on its
design and bounds are in ``csrc/score_ce.cu``.

``score_ce`` launches the kernel for CUDA tensors and uses
``score_ce_plain`` only for CPU tensors. ``score_ce.launches`` counts the
kernel's launches (the main kernel and its combine pass count as one).

Under autograd (grad enabled and ``hidden`` or ``emb`` requiring it) the
call goes through ``ScoreCE``: its forward also keeps each token's
log-sum-exp, and its backward is ``score_ce_bwd``: dL/dhidden and, when
``emb`` requires grad (pretraining's tied embedding; prompt tuning keeps
the model frozen, and then nothing is launched for it), dL/demb from the
dE kernel (``score_ce_de``). The reference has no such kernels: it takes
these gradients through XLA.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# A block's token rows, the vocabulary columns of one of its tiles, and the
# blocks an SM holds, by element type (csrc/score_ce.cu): vocabulary splits
# are added until the card holds that many blocks.
TILES = {torch.bfloat16: (128, 256, 1), torch.float32: (64, 64, 4)}


def score_ce_plain(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                   return_lse: bool = False):
    """Full-logits log-softmax gather in f32: the same function written out.
    With ``return_lse`` also each token's log-sum-exp (T,) f32."""
    logits = hidden.float() @ emb.float().T
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - gold, lse) if return_lse else lse - gold


def score_ce_bwd_plain(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                       lse: torch.Tensor, grad: torch.Tensor, with_emb: bool = False):
    """dL/dhidden written out in f32 with the whole (T, V) logits:
    G @ emb with G = grad · (softmax − onehot(labels)), in hidden's dtype;
    with ``with_emb`` also dL/demb = Gᵀ @ hidden in emb's dtype."""
    logits = hidden.float() @ emb.float().T
    g = torch.exp(logits - lse.float()[:, None])
    g[torch.arange(len(labels), device=g.device), labels.long()] -= 1.0
    g = grad.float()[:, None] * g
    dh = (g @ emb.float()).to(hidden.dtype)
    return (dh, (g.T @ hidden.float()).to(emb.dtype)) if with_emb else dh


def _lib() -> ctypes.CDLL:
    lib = _build.load("score_ce")
    fn = lib.score_ce_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.score_ce_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.score_ce_de_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def num_splits(n_tok: int, vocab: int, sms: int, dtype: torch.dtype) -> int:
    """Vocabulary splits per row tile: as many blocks as the card holds at
    once (never a partial second wave), never more splits than there are
    vocabulary tiles."""
    rows, cols, per_sm = TILES[dtype]
    row_tiles = -(-n_tok // rows)
    return max(1, min(-(-vocab // cols), per_sm * sms // row_tiles))


def _check(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor, name: str,
           *others) -> None:
    """What the CUDA kernels take: shapes, dtypes, contiguity."""
    if hidden.dim() != 2 or emb.dim() != 2 or labels.shape != hidden.shape[:1]:
        raise ValueError("score_ce: expects hidden (T, D), emb (V, D), labels (T,), "
                         f"got {tuple(hidden.shape)}, {tuple(emb.shape)}, "
                         f"{tuple(labels.shape)}")
    T, D = hidden.shape
    V = emb.shape[0]
    if emb.shape[1] != D:
        raise ValueError(f"score_ce: hidden has D={D}, emb has {emb.shape[1]}")
    if hidden.dtype not in (torch.float32, torch.bfloat16) or emb.dtype != hidden.dtype:
        raise ValueError("score_ce: hidden and emb must both be float32 or both "
                         f"bfloat16, got {hidden.dtype} and {emb.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError(f"score_ce: labels must be int32, got {labels.dtype}")
    if D % 8:
        raise ValueError(f"score_ce: D={D} must be a multiple of 8")
    if T == 0 or V == 0:
        raise ValueError("score_ce: empty input")
    for t in (hidden, emb, labels, *others):
        if not t.is_contiguous():
            raise ValueError("score_ce: inputs must be contiguous")
    _build.check_launchable(name, hidden, emb, labels, *others)


def _forward(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor, with_lse: bool):
    """(nll, lse or None): the kernel (CUDA tensors) or the plain version."""
    if _build.device_kind(hidden, emb, labels) == "cpu":
        if with_lse:
            return score_ce_plain(hidden, emb, labels, return_lse=True)
        return score_ce_plain(hidden, emb, labels), None
    _check(hidden, emb, labels, "score_ce")
    T, D = hidden.shape
    V = emb.shape[0]
    n_split = num_splits(T, V, torch.cuda.get_device_properties(hidden.device).multi_processor_count,
                         hidden.dtype)
    part = torch.empty((3, n_split, T), dtype=torch.float32, device=hidden.device)
    nll = torch.empty((T,), dtype=torch.float32, device=hidden.device)
    lse = torch.empty((T,), dtype=torch.float32, device=hidden.device) if with_lse else None
    rc = _lib().score_ce_launch(
        hidden.data_ptr(), emb.data_ptr(), labels.data_ptr(), part.data_ptr(),
        nll.data_ptr(), lse.data_ptr() if with_lse else None, T, D, V, n_split,
        int(hidden.dtype == torch.bfloat16), _build.stream_ptr(hidden.device))
    if rc:
        raise RuntimeError(f"score_ce: kernel launch failed with CUDA error {rc}")
    score_ce.launches += 1
    return nll, lse


def score_ce(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
             return_lse: bool = False):
    """hidden (T, D) and emb (V, D) in f32 or bf16, labels (T,) int32 ->
    nll (T,) f32, and with ``return_lse`` also the log-sum-exp (T,) f32.
    Under autograd the call goes through ``ScoreCE``."""
    if torch.is_grad_enabled() and (hidden.requires_grad or emb.requires_grad):
        if return_lse:
            raise ValueError("score_ce: return_lse is not differentiable")
        return ScoreCE.apply(hidden, emb, labels)
    nll, lse = _forward(hidden, emb, labels, return_lse)
    return (nll, lse) if return_lse else nll


score_ce.launches = 0

# Bytes of one (T, chunk) slice of the backward's logits gradient.
BWD_CHUNK_BYTES = 1 << 28


def bwd_chunk(n_tok: int, vocab: int, dtype: torch.dtype) -> int:
    """Vocabulary columns per backward chunk: a multiple of the bf16 tile
    (256) whose (T, chunk) slice stays within BWD_CHUNK_BYTES, at least one
    tile, at most the vocabulary rounded up to a tile."""
    elt = torch.tensor([], dtype=dtype).element_size()
    cols = max(256, BWD_CHUNK_BYTES // (max(n_tok, 1) * elt) // 256 * 256)
    return min(cols, -(-vocab // 256) * 256)


# The bf16 G·E kernel's output tile (token rows, columns of D) and k tile
# (vocabulary rows), and the bytes its f32 partials may take beyond one copy
# of dh (csrc/score_ce.cu).
GE_TILE = (128, 256)
GE_K_TILE = 64
GE_PART_BYTES = 1 << 28


def ge_splits(n_tok: int, dim: int, width: int, sms: int) -> int:
    """Vocabulary splits of the bf16 G·E product of one chunk of ``width``
    columns: enough (row tile, column tile, split) blocks for one wave on
    ``sms`` SMs, no more splits than the chunk has k tiles, and the f32
    partials (splits × T × D) within GE_PART_BYTES unless one split alone is
    larger. At least 1."""
    tiles = -(-n_tok // GE_TILE[0]) * -(-dim // GE_TILE[1])
    s = min(-(-width // GE_K_TILE), sms // tiles, GE_PART_BYTES // (4 * n_tok * dim))
    return max(1, s)


def score_ce_de(G: torch.Tensor, ldg: int, hidden: torch.Tensor, de: torch.Tensor, c0: int,
                width: int) -> None:
    """Writes dE rows [c0, c0 + width) of ``de`` (V, D) bf16 = Gᵀ · hidden for
    one vocabulary chunk: G as ``score_ce_bwd``'s G pass left it, (T, ldg)
    bf16 in a buffer rows ``ldg`` apart, its first ``width`` columns the
    chunk's. The dE kernel of ``csrc/score_ce.cu``, one launch; CUDA bf16
    tensors only (``score_ce_bwd`` calls it once a chunk)."""
    T, D = hidden.shape
    rc = _lib().score_ce_de_launch(G.data_ptr(), ldg, hidden.data_ptr(), de.data_ptr(), T, D,
                                   de.shape[0], c0, width, _build.stream_ptr(hidden.device))
    if rc:
        raise RuntimeError(f"score_ce_de: kernel launch failed with CUDA error {rc}")
    score_ce_de.launches += 1


score_ce_de.launches = 0


def score_ce_bwd(hidden: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, grad: torch.Tensor, with_emb: bool = False):
    """dL/dhidden (T, D) in hidden's dtype for dL/dnll = ``grad`` (T,), given
    the forward's log-sum-exp, and with ``with_emb`` also dL/demb (V, D) in
    emb's dtype; for CPU tensors ``score_ce_bwd_plain``. For CUDA tensors
    the kernel runs one launch a vocabulary chunk, each writing that chunk's
    G = grad · (softmax − onehot) in hidden's dtype. bf16: the kernel also
    adds each chunk's G·E into f32 partials split over the vocabulary
    (``ge_splits``) and, after the last chunk, sums them in split order, so
    the whole sum is f32 and deterministic; dE's rows of the chunk are
    ``score_ce_de``'s, one launch a chunk, each row summed over the tokens
    in f32 in a fixed order. f32: G·E and Gᵀ·hidden are matrix products
    summed in f32 here. Without ``with_emb`` nothing is launched for dE."""
    if _build.device_kind(hidden, emb, labels, lse, grad) == "cpu":
        return score_ce_bwd_plain(hidden, emb, labels, lse, grad, with_emb)
    grad = grad.float().contiguous()
    _check(hidden, emb, labels, "score_ce_bwd", lse, grad)
    if lse.dtype != torch.float32 or lse.shape != labels.shape:
        raise ValueError("score_ce_bwd: lse must be (T,) f32")
    T, D = hidden.shape
    V = emb.shape[0]
    chunk = bwd_chunk(T, V, hidden.dtype)
    is_bf16 = hidden.dtype == torch.bfloat16
    dev = hidden.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = torch.empty((T, chunk), dtype=hidden.dtype, device=dev)   # each chunk's G, rows ldg apart
    if is_bf16:
        n_ge = ge_splits(T, D, chunk, sms)
        part = torch.empty((n_ge, T, D), dtype=torch.float32, device=dev)
        dh = torch.empty((T, D), dtype=hidden.dtype, device=dev)
    else:
        n_ge, part = 0, None
        dh = torch.zeros((T, D), dtype=torch.float32, device=dev)
    de = torch.empty((V, D), dtype=emb.dtype, device=dev) if with_emb else None
    lib = _lib()
    for c0 in range(0, V, chunk):
        width = min(chunk, V - c0)
        ldg = -(-width // 8) * 8
        rc = lib.score_ce_bwd_launch(
            hidden.data_ptr(), emb.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            grad.data_ptr(), G.data_ptr(), ldg, part.data_ptr() if is_bf16 else None,
            dh.data_ptr(), T, D, V, c0, width, num_splits(T, width, sms, hidden.dtype), n_ge,
            int(c0 == 0), int(c0 + chunk >= V), int(is_bf16), _build.stream_ptr(dev))
        if rc:
            raise RuntimeError(f"score_ce_bwd: kernel launch failed with CUDA error {rc}")
        score_ce_bwd.launches += 1
        if not is_bf16:
            g = G.view(-1)[:T * ldg].view(T, ldg)[:, :width]
            dh += g @ emb[c0:c0 + width]
            if with_emb:
                torch.matmul(g.T, hidden, out=de[c0:c0 + width])
        elif with_emb:
            score_ce_de(G, ldg, hidden, de, c0, width)
    return (dh.to(hidden.dtype), de) if with_emb else dh.to(hidden.dtype)


score_ce_bwd.launches = 0


class ScoreCE(torch.autograd.Function):
    """``score_ce`` with its backward: the forward keeps hidden, labels and
    the log-sum-exp; the backward is ``score_ce_bwd``, with dE only when
    ``emb`` requires grad (no gradient for labels)."""

    @staticmethod
    def forward(ctx, hidden, emb, labels):
        nll, lse = _forward(hidden, emb, labels, with_lse=True)
        ctx.save_for_backward(hidden, emb, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, grad):
        hidden, emb, labels, lse = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            dh, de = score_ce_bwd(hidden, emb, labels, lse, grad, with_emb=True)
            return dh, de, None
        return score_ce_bwd(hidden, emb, labels, lse, grad), None, None
