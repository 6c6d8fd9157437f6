"""The bf16 designs of the port's two backward kernels, restated on the CPU.

The CUDA kernels run only on the card, so their arithmetic is written out
here in torch and held against ``flash_attention_bwd_plain`` /
``score_ce_bwd_plain`` and against ``jax.vjp`` of the reference's oracles
(``repro.kernels.ref``):

- ``fa_bwd_mirror``: ``csrc/flash_attention_bwd.cu``'s single pass. Blocks
  of 128 KV rows in two halves of 64 (the consumer warpgroups), each walking
  the query tiles of 64 that the kernel's ``query_range`` lets see its KV
  tile; the mask applied only where the kernel's ``all_live`` says a 64 × 64
  tile needs it; P = exp2(s·scale·log2 e − lse·log2 e); P and dS rounded to
  bf16 before dV, dK and dQ; dQ summed in f32 over the KV tiles, in the
  kernel's 64-column shares. Head dim 112 runs padded to 128 with zero
  columns, which must stay 0; the padded design is also held in float64
  against autograd of float64 attention (1e-10).
- ``sce_bwd_mirror``: ``csrc/score_ce.cu``'s backward. G = g·(softmax −
  onehot) per vocabulary chunk (``bwd_chunk``), rounded to bf16; each chunk's
  G·E split over the vocabulary as the kernel divides it (``ge_splits``
  splits, ``ge_split_ranges``), the
  splits' f32 partials written by the first chunk and added to by later
  ones, then summed in split order and rounded once.

Tolerances: with the bf16 roundings off the mirrors are the f32 functions
in another order (2e-5); with them on, 3e-2 relative + 1e-2 × the largest
reference element, the card's bf16 tolerance for these kernels
(``chip_smoke.py`` BWD_RTOL / BWD_ATOL). The reference averages a row with
no live column where the port gives 0, so cases with such rows are held
against the plain version only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref, score_ce_ref
from repro_torch.kernels import score_ce as sc
from repro_torch.kernels.flash_attention import (BWD_QUERY_TILE, bwd_padded_head_dim,
                                                 bwd_work_floats, flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.score_ce import (GE_K_TILE, GE_PART_BYTES, GE_TILE, bwd_chunk,
                                          ge_splits, num_splits, score_ce_bwd_plain,
                                          score_ce_plain)

LOG2E = 1.4426950408889634
F32_TOL = 2e-5
BF16_RTOL, BF16_ATOL = 3e-2, 1e-2      # atol times the largest reference element
KV_TILE, HALF, Q_TILE = 128, 64, BWD_QUERY_TILE


def _close(out, ref, bf16: bool):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    if bf16:
        np.testing.assert_allclose(out, ref, rtol=BF16_RTOL,
                                   atol=BF16_ATOL * float(np.abs(ref).max()))
    else:
        np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)


def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if bf16 else x


# -- flash_attention_bwd ---------------------------------------------------------------

def query_range(S, kv_live, q_offset, causal, window, j0, rows=KV_TILE, tile=Q_TILE):
    """The kernel's query_range: the query rows [begin, end) that see some
    column of the KV tile [j0, j0 + rows), begin rounded down to a tile."""
    b = max(0, j0 - q_offset) if causal else 0
    e = S
    if window > 0:
        e = min(e, j0 + rows - 1 + window - q_offset)
    b -= b % tile
    return b, (e if j0 < kv_live else 0)


def all_live(S, kv_live, q_offset, causal, window, i0, j0):
    """The kernel's all_live: every pair of the 64 × 64 tile is live."""
    return (i0 + 64 <= S and j0 + 64 <= kv_live and (not causal or j0 + 63 <= q_offset + i0)
            and (window <= 0 or j0 > q_offset + i0 + 63 - window))


def fa_bwd_mirror(q, k, v, out, dout, lse, *, causal=True, window=0, q_offset=0, kv_len=None,
                  bf16=True, acc=torch.float32):
    """(dq, dk, dv) as the bf16 kernel computes them, in ``acc`` (see the
    module note); ``bf16`` False skips the roundings of P and dS.

    The tiles are whole 64-column blocks, hd padded to HP (112 -> 128) with
    the zeros TMA fills past the tensor maps' last column: Sᵀ and dPᵀ over
    the hd / 16 k-steps that hold data, dV and dK HP wide, and dQ in the
    kernel's shares (HP 128: columns [64w, +64) over the tile's 128 KV rows;
    HP 64: each warpgroup's 64 rows) summed into an HP-wide scratch. The
    padded columns must come out exactly 0; they are never stored."""
    B, H, S, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    HP = bwd_padded_head_dim(hd)
    G, scale = H // Hkv, hd ** -0.5
    kv_live = L if kv_len is None else min(int(kv_len), L)
    pad = lambda t: torch.nn.functional.pad(t.to(acc), (0, HP - hd))   # noqa: E731
    qf, kf, vf, dof = (pad(t) for t in (q, k, v, dout))
    delta = (dout.to(acc) * out.to(acc)).sum(-1)
    l2 = lse.to(acc) * LOG2E
    dq = torch.zeros(B, H, S, HP, dtype=acc)
    dk, dv = torch.zeros(B, Hkv, L, HP, dtype=acc), torch.zeros(B, Hkv, L, HP, dtype=acc)
    for j0 in range(0, L, KV_TILE):
        i_begin, i_end = query_range(S, kv_live, q_offset, causal, window, j0)
        for h in range(H):
            hk = h // G
            for i0 in range(i_begin, i_end, Q_TILE):
                qs = slice(i0, min(i0 + Q_TILE, S))
                i = torch.arange(qs.start, qs.stop)
                ds_tile = torch.zeros(B, qs.stop - qs.start, KV_TILE, dtype=acc)
                for jw0 in (j0, j0 + HALF):             # the two consumer warpgroups
                    if jw0 >= L:
                        continue
                    rows = slice(jw0, min(jw0 + HALF, L))
                    j = torch.arange(rows.start, rows.stop)
                    s = qf[:, h, qs, :hd] @ kf[:, hk, rows, :hd].transpose(-1, -2)
                    p = torch.exp2(s * (scale * LOG2E) - l2[:, h, qs, None])
                    if not all_live(S, kv_live, q_offset, causal, window, i0, jw0):
                        live = (j[None, :] < kv_live).expand(len(i), len(j))
                        if causal:
                            live = live & (j[None, :] <= q_offset + i[:, None])
                        if window > 0:
                            live = live & (j[None, :] > q_offset + i[:, None] - window)
                        p = torch.where(live, p, torch.zeros((), dtype=acc))
                    dp = dof[:, h, qs, :hd] @ vf[:, hk, rows, :hd].transpose(-1, -2)
                    ds = p * (dp - delta[:, h, qs, None])
                    pb, dsb = _round(p, bf16), _round(ds, bf16)
                    dv[:, hk, rows] += pb.transpose(-1, -2) @ dof[:, h, qs]
                    dk[:, hk, rows] += dsb.transpose(-1, -2) @ qf[:, h, qs]
                    ds_tile[:, :, jw0 - j0:jw0 - j0 + rows.stop - rows.start] = dsb
                    if HP == 64:                        # each warpgroup over its own rows
                        dq[:, h, qs] += dsb @ kf[:, hk, rows]
                if HP == 128:                           # share w: columns [64w, +64), 128 rows
                    krows = kf[:, hk, j0:j0 + KV_TILE]
                    n = krows.shape[1]
                    for w in range(2):
                        cols = slice(64 * w, 64 * w + 64)
                        dq[:, h, qs, cols] += ds_tile[:, :, :n] @ krows[:, :, cols]
    for g in (dq, dk, dv):
        assert (g[..., hd:] == 0).all(), "a padded column got a value"
    dq, dk, dv = dq[..., :hd] * scale, dk[..., :hd] * scale, dv[..., :hd]
    return tuple(g.to(t.dtype if acc == torch.float32 else acc)
                 for g, t in zip((dq, dk, dv), (q, k, v)))


FA_CASES = [  # B, H, Hkv, S, L, hd, kwargs, every row live (so JAX's reference applies)
    (1, 2, 2, 127, 127, 64, {}, True),
    (1, 2, 2, 128, 128, 128, {}, True),
    (1, 2, 2, 129, 129, 64, {}, True),
    (1, 2, 1, 257, 257, 64, {}, True),
    (1, 7, 1, 130, 130, 64, {}, True),                                     # GQA 7:1
    (1, 14, 2, 65, 200, 64, {"q_offset": 135}, True),
    (1, 2, 2, 200, 200, 64, {"window": 40, "kv_len": 150}, False),       # rows 189-199: nothing live
    (2, 2, 1, 150, 150, 64, {"window": 70}, True),
    (1, 2, 2, 129, 257, 128, {"causal": False, "kv_len": 100}, True),
    (1, 2, 1, 20, 20, 64, {"window": 4, "kv_len": 10}, False),            # rows 13-19: nothing live
    (1, 2, 2, 129, 129, 112, {}, True),                                   # hd 112, padded to 128
    (1, 4, 1, 140, 70, 112, {"causal": False, "kv_len": 60}, True),
]


def _fa_inputs(B, H, Hkv, S, L, hd, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return mk(B, H, S, hd), mk(B, Hkv, L, hd), mk(B, Hkv, L, hd), mk(B, H, S, hd)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,H,Hkv,S,L,hd,kw,all_rows_live", FA_CASES)
def test_fa_bwd_mirror_matches_plain_and_jax(B, H, Hkv, S, L, hd, kw, all_rows_live, bf16):
    kw = {"causal": True, **kw}
    q, k, v, do = _fa_inputs(B, H, Hkv, S, L, hd, S * L + hd + H)
    if bf16:   # the kernel's inputs: bf16 values, which every reference then reads exactly
        q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert bool((lse > -1e29).all()) == all_rows_live
    got = fa_bwd_mirror(q, k, v, out, do, lse, bf16=bf16, **kw)
    plain = flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), do.float(),
                                      lse, **kw)
    for g, p in zip(got, plain):
        _close(g.float().numpy(), p.numpy(), bf16)
    if not all_rows_live:
        dq = got[0].float()
        assert (dq[..., lse[0, 0] < -1e29, :] == 0).all()
        return
    jargs = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(a, b, c, **kw), *jargs)
    for g, jg in zip(got, vjp(jnp.asarray(do.float().numpy()))):
        _close(g.float().numpy(), np.asarray(jg), bf16)


def test_fa_bwd_query_ranges_cover_every_live_pair():
    """Every live (query, key) pair lies in a 64-row query tile that the
    kernel's query_range visits for the pair's 128-row KV tile, and only
    pairs inside a tile that all_live passes are left unmasked."""
    for S, L, kw in [(257, 257, {}), (65, 200, {"q_offset": 135, "window": 70}),
                     (200, 200, {"window": 100, "kv_len": 150}), (129, 257, {"causal": False}),
                     (300, 300, {"window": 129})]:
        causal, window, q_offset = kw.get("causal", True), kw.get("window", 0), kw.get("q_offset", 0)
        kv_live = min(kw.get("kv_len", L), L)
        for j0 in range(0, L, KV_TILE):
            b, e = query_range(S, kv_live, q_offset, causal, window, j0)
            for j in range(j0, min(j0 + KV_TILE, L)):
                for i in range(S):
                    pair = (j < kv_live and (not causal or j <= q_offset + i)
                            and (window <= 0 or j > q_offset + i - window))
                    if pair:
                        assert b <= i < e, (S, L, kw, i, j)
                    i0, jw0 = i - i % Q_TILE, j - (j - j0) % HALF
                    if all_live(S, kv_live, q_offset, causal, window, i0, jw0):
                        assert pair, (S, L, kw, i, j)


def _dense_f64(q, k, v, *, causal=True, window=0, q_offset=0, kv_len=None):
    """Attention written out in float64, GQA by repeating K and V."""
    B, H, S, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    k, v = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    i, j = torch.arange(S)[:, None] + q_offset, torch.arange(L)[None, :]
    live = j < (L if kv_len is None else kv_len)
    if causal:
        live = live & (j <= i)
    if window > 0:
        live = live & (j > i - window)
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    s = s.masked_fill(~live, -1e30)
    return torch.softmax(s, -1) @ v, torch.logsumexp(s, -1)


@pytest.mark.parametrize("B,H,Hkv,S,L,hd,kw,all_rows_live",
                         [c for c in FA_CASES if c[-1] and c[5] != 128][:3] +
                         [c for c in FA_CASES if c[5] == 112])
def test_fa_bwd_mirror_padded_design_holds_float64(B, H, Hkv, S, L, hd, kw, all_rows_live):
    """The padded design's arithmetic without roundings, in float64, against
    autograd of float64 attention: the zero columns change neither S nor dP,
    the 64-column dQ shares sum to dS·K, and the padded columns stay 0."""
    kw = {"causal": True, **kw}
    q, k, v, do = (t.double() for t in _fa_inputs(B, H, Hkv, S, L, hd, S * L + hd + H))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out, lse = _dense_f64(q, k, v, **kw)
    refs = torch.autograd.grad(out, (q, k, v), do)
    got = fa_bwd_mirror(q.detach(), k.detach(), v.detach(), out.detach(), do, lse.detach(),
                        bf16=False, acc=torch.float64, **kw)
    for g, r in zip(got, refs):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("S,hd,hp", [(1, 64, 64), (64, 128, 128), (65, 64, 64),
                                     (4112, 128, 128), (33, 112, 128)])
def test_fa_bwd_work_is_padded_to_query_tiles(S, hd, hp):
    """The bf16 scratch holds lse, D and an f32 dQ row per query row padded to
    a whole 64-row tile, each dQ row at the padded head dim (112 -> 128); f32
    holds D alone."""
    pad = -(-S // Q_TILE) * Q_TILE
    assert bwd_padded_head_dim(hd) == hp
    assert bwd_work_floats(2, 3, S, hd, torch.bfloat16) == 2 * 3 * pad * (2 + hp)
    assert bwd_work_floats(2, 3, S, hd, torch.float32) == 2 * 3 * S


# -- score_ce_bwd ----------------------------------------------------------------------

def ge_split_ranges(width, splits):
    """The chunk's columns each G·E split sums, as score_ce_ge_bf16 divides
    its 64-row k tiles: split s takes [s·n // splits, (s + 1)·n // splits)."""
    n = -(-width // GE_K_TILE)
    return [(min(width, s * n // splits * GE_K_TILE), min(width, (s + 1) * n // splits * GE_K_TILE))
            for s in range(splits)]


def sce_bwd_mirror(hidden, emb, labels, lse, grad, *, sms=132, bf16=True):
    """dL/dhidden as the bf16 kernel computes it, in f32 (see the module note);
    ``bf16`` False skips the rounding of G and of the result."""
    T, D = hidden.shape
    V = emb.shape[0]
    dtype = torch.bfloat16 if bf16 else torch.float32
    chunk = bwd_chunk(T, V, dtype)
    splits = ge_splits(T, D, chunk, sms)
    hf, ef = hidden.float(), emb.float()
    part = None
    for c0 in range(0, V, chunk):
        width = min(chunk, V - c0)
        logits = hf @ ef[c0:c0 + width].T
        g = torch.exp(logits - lse[:, None])
        onehot = (labels.long()[:, None] == torch.arange(c0, c0 + width)[None, :]).float()
        g = _round(grad[:, None] * (g - onehot), bf16)
        now = torch.stack([g[:, a:b] @ ef[c0 + a:c0 + b] for a, b in ge_split_ranges(width, splits)])
        part = now if part is None else part + now
    dh = part[0]
    for s in range(1, splits):
        dh = dh + part[s]
    return dh.to(dtype)


SCE_CASES = [(1, 64, 1000), (64, 64, 1000), (65, 64, 1000), (128, 32, 700), (129, 32, 700),
             (273, 16, 513)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("sms", [4, 132])
@pytest.mark.parametrize("T,D,V", SCE_CASES)
def test_sce_bwd_mirror_matches_plain_and_jax(T, D, V, sms, bf16, monkeypatch):
    # chunks of 256 columns at these sizes: several chunks, the last one ragged
    monkeypatch.setattr(sc, "BWD_CHUNK_BYTES", 256 * T * (2 if bf16 else 4))
    rng = np.random.default_rng(T * V + D)
    h = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32))
    e = torch.from_numpy((rng.normal(size=(V, D)) * 0.3).astype(np.float32))
    if bf16:
        h, e = h.to(torch.bfloat16), e.to(torch.bfloat16)
    lab = torch.from_numpy(rng.integers(0, V, T).astype(np.int32))
    lab[:3] = torch.tensor([0, V - 1, 256], dtype=torch.int32)[:T]   # the edges of chunks
    g = torch.from_numpy(rng.random(T).astype(np.float32))
    g[1::3] = 0.0                                                   # masked tokens
    _, lse = score_ce_plain(h, e, lab, return_lse=True)
    got = sce_bwd_mirror(h, e, lab, lse, g, sms=sms, bf16=bf16)
    assert bwd_chunk(T, V, h.dtype) == 256 and (got[1::3] == 0).all()
    _close(got.float().numpy(), score_ce_bwd_plain(h.float(), e.float(), lab, lse, g).numpy(),
           bf16)
    _, vjp = jax.vjp(lambda x: score_ce_ref(x, jnp.asarray(e.float().numpy()),
                                            jnp.asarray(lab.numpy())),
                     jnp.asarray(h.float().numpy()))
    (jdh,) = vjp(jnp.asarray(g.numpy()))
    _close(got.float().numpy(), np.asarray(jdh), bf16)


@pytest.mark.parametrize("T,D,V", [(1, 768, 50257), (136, 768, 50257), (273, 768, 50257),
                                   (512, 4096, 32000), (8192, 4096, 32000), (272, 5120, 102400),
                                   (65536, 4096, 32000), (7952, 5120, 102400)])
@pytest.mark.parametrize("sms", [1, 132])
def test_ge_splits_cover_the_chunk_within_budget(T, D, V, sms):
    """The G·E splits of every chunk: at least one; no more than the chunk's
    64-row k tiles or one wave of blocks; every column of every chunk in
    exactly one split, in order; the f32 partials within GE_PART_BYTES
    unless one split alone is larger."""
    chunk = bwd_chunk(T, V, torch.bfloat16)
    s = ge_splits(T, D, chunk, sms)
    tiles = -(-T // GE_TILE[0]) * -(-D // GE_TILE[1])
    assert s >= 1
    assert s == 1 or (s <= -(-chunk // GE_K_TILE) and s * tiles <= sms)
    assert s * T * D * 4 <= max(GE_PART_BYTES, T * D * 4)
    for c0 in range(0, V, chunk):
        width = min(chunk, V - c0)
        ranges = ge_split_ranges(width, s)
        assert ranges[0][0] == 0 and ranges[-1][1] == width
        assert all(a <= b for a, b in ranges)
        assert all(ranges[x][1] == ranges[x + 1][0] for x in range(len(ranges) - 1))
    assert 1 <= num_splits(T, chunk, sms, torch.bfloat16) <= max(1, sms)
