"""The port's kernel modules against the JAX package's kernels.

The same numpy inputs go to the Pallas kernels (interpret mode, as
tests/test_kernels.py runs them on the CPU), to their ``kernels/ref.py``
oracles, and to the port's plain PyTorch versions, which are what the
port's wrappers run on CPU tensors. The CUDA kernels themselves run only on
the card: ``test_cuda_kernels_match_plain`` holds them against the plain
versions there and skips elsewhere. ``fa_pv_mirror`` restates the bf16
``flash_attention`` kernel's softmax and P·V (P = P_hi + P_lo) on the CPU:
change it with ``csrc/flash_attention.cu``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import flash_attention_ref, score_ce_ref
from repro.kernels.score_ce import score_ce as jscore_ce
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.rwkv_wkv import rwkv6_wkv, rwkv6_wkv_plain
from repro_torch.kernels.score_ce import TILES, num_splits, score_ce, score_ce_plain

TOL = 2e-5   # f32, as tests/test_kernels.py


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# -- score_ce ------------------------------------------------------------------

@pytest.mark.parametrize("T,D,V,bt,bv", [
    (64, 64, 512, 32, 128),
    (37, 32, 509, 16, 509),       # odd V (one TPU vocab tile) and ragged T
    (100, 128, 1024, 32, 256),    # T not a tile multiple
])
def test_score_ce_plain_matches_pallas_and_ref(T, D, V, bt, bv):
    rng = np.random.default_rng(T + V)
    h = rng.normal(size=(T, D)).astype(np.float32)
    e = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)
    lab = rng.integers(0, V, size=(T,)).astype(np.int32)
    ours = score_ce(torch.from_numpy(h), torch.from_numpy(e), torch.from_numpy(lab))
    _close(ours, jscore_ce(jnp.asarray(h), jnp.asarray(e), jnp.asarray(lab),
                           bt=bt, bv=bv, interpret=True))
    _close(ours, score_ce_ref(jnp.asarray(h), jnp.asarray(e), jnp.asarray(lab)))


@pytest.mark.parametrize("T,D,V,bv", [
    (6, 64, 600, 200),        # V = 2·256 + 88: a ragged last 256-column tile
    (33, 32, 520, 520),       # V = 2·256 + 8: eight columns in the last tile
    (16, 48, 1000, 250),      # V = 15·64 + 40 (the f32 tiles' ragged edge)
])
def test_score_ce_plain_matches_pallas_at_vocabulary_edges(T, D, V, bv):
    """Labels on the vocabulary's first and last columns and inside the
    CUDA kernels' ragged last tile (V not a multiple of their 256- or
    64-column tiles; the Pallas kernel takes a tile bv that divides V)."""
    rng = np.random.default_rng(V + T)
    h = rng.normal(size=(T, D)).astype(np.float32)
    e = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)
    lab = rng.integers(0, V, size=(T,)).astype(np.int32)
    lab[:3] = [0, V - 1, V - 5]
    ours = score_ce(torch.from_numpy(h), torch.from_numpy(e), torch.from_numpy(lab))
    _close(ours, jscore_ce(jnp.asarray(h), jnp.asarray(e), jnp.asarray(lab),
                           bt=8, bv=bv, interpret=True))
    _close(ours, score_ce_ref(jnp.asarray(h), jnp.asarray(e), jnp.asarray(lab)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,V", [(1, 50257), (272, 50257), (7952, 50257), (272, 65536),
                                 (272, 102400), (40000, 50257)])
def test_score_ce_splits_fill_the_card_in_one_wave(dtype, T, V):
    """The vocabulary splits make at most one wave of blocks on a 132-SM
    card, at least one split, no more splits than vocabulary tiles, and a
    full card where the row tiles leave room: blocks that share a split run
    together, which the bf16 kernel's L2 reuse depends on."""
    sms = 132
    rows, cols, per_sm = TILES[dtype]
    n = num_splits(T, V, sms, dtype)
    row_tiles, vocab_tiles = -(-T // rows), -(-V // cols)
    assert 1 <= n <= vocab_tiles
    if row_tiles <= per_sm * sms:
        assert row_tiles * n <= per_sm * sms
        assert row_tiles * (n + 1) > per_sm * sms or n == vocab_tiles
    else:
        assert n == 1


def test_fused_score_ce_matches_jax_adapter():
    rng = np.random.default_rng(1)
    B, S, D, V = 3, 11, 64, 256
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    e = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)
    lab = rng.integers(0, V, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.4).astype(np.float32)
    mask[1] = 0.0                                   # an example with no target tokens
    mean, per = ops.fused_score_ce(*map(torch.from_numpy, (h, e, lab, mask)))
    jmean, jper = jops.fused_score_ce(*map(jnp.asarray, (h, e, lab, mask)))
    _close(mean, jmean)
    _close(per, jper)


# -- flash_attention -----------------------------------------------------------

FLASH_CASES = [  # B, H, Hkv, S, L, hd, causal, window, q_offset, kv_len
    (1, 2, 2, 16, 16, 32, True, 0, 0, None),       # MHA (G=1)
    (2, 4, 2, 24, 40, 32, True, 0, 16, None),      # GQA G=2, soft-prompt shift
    (1, 4, 2, 16, 48, 16, True, 8, 32, None),      # sliding window
    (1, 2, 1, 8, 64, 16, False, 0, 0, 33),         # dynamic kv_len, G=2
    (2, 2, 2, 33, 33, 64, True, 0, 0, None),       # ragged S = L
    (1, 4, 2, 20, 50, 32, True, 12, 30, 45),       # all masks at once
    (1, 2, 2, 17, 17, 112, True, 0, 0, None),      # hd 112 (zamba2-7b), MHA, ragged S = L
    (1, 4, 1, 9, 40, 112, True, 6, 31, 36),        # hd 112, G = 4, all masks at once
    (1, 2, 2, 12, 20, 112, False, 0, 0, 15),       # hd 112, not causal, short kv_len
    (1, 8, 1, 21, 40, 256, True, 0, 19, 35),       # hd 256 (paligemma-3b), G = 8, kv_len in a tile
    (1, 8, 1, 9, 30, 256, False, 0, 0, 22),        # hd 256, not causal, short kv_len
]


@pytest.mark.parametrize("B,H,Hkv,S,L,hd,causal,window,q_offset,kv_len", FLASH_CASES)
def test_flash_attention_plain_matches_pallas_and_ref(B, H, Hkv, S, L, hd, causal,
                                                       window, q_offset, kv_len):
    rng = np.random.default_rng(B * H + S + L)
    q = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, L, hd)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, L, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    ours = flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(ours, jflash(jq, jk, jv, bq=8, bk=16, interpret=True, **kw))
    _close(ours, flash_attention_ref(jq, jk, jv, **kw))


def test_flash_attention_plain_zeroes_rows_without_live_columns():
    """The kernel's convention: a row with no live column gives 0 (the
    reference's dense softmax would average every value there)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 2, 6, 16), (1, 2, 8, 16), (1, 2, 8, 16)))
    out = flash_attention_plain(q, k, v, causal=True, window=2, q_offset=8, kv_len=8)
    # rows at positions 8, 9 see kv 7 / nothing (kv_len 8, window 2): row 0
    # is live, rows 1.. are fully masked
    assert torch.all(out[:, :, 1:] == 0)
    assert torch.all(out[:, :, 0] != 0)


@pytest.mark.parametrize("S,L,q_offset", [(24, 24, 0), (16, 40, 24)])
def test_gqa_flash_matches_jax_adapter(S, L, q_offset):
    rng = np.random.default_rng(S + L)
    B, H, Hkv, hd = 2, 4, 2, 32
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32)
    ours = ops.gqa_flash(*map(torch.from_numpy, (q, k, v)), causal=True, q_offset=q_offset)
    assert ours.shape == (B, S, H, hd)
    _close(ours, jops.gqa_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                q_offset=q_offset, bq=8, bk=8))


def test_gqa_flash_rejects_oversized_head_dim():
    x = torch.zeros(1, 4, 2, 512)
    with pytest.raises(ValueError, match="head_dim=512"):
        ops.gqa_flash(x, x, x)


# -- the bf16 flash_attention's P·V, restated ----------------------------------------

def split_bf16(p: torch.Tensor):
    """P_hi + P_lo as csrc/flash_attention.cu's split_bf16 forms them: P
    rounded to bf16, and the (exact f32) remainder rounded to bf16."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def fa_pv_mirror(q, k, v, *, causal=True, window=0, q_offset=0, kv_len=None, split=True):
    """csrc/flash_attention.cu's bf16 forward in f32 on the CPU, before its
    output is rounded to bf16: KV tiles of 64 columns; the running max of
    the scores in base 2 (scale·log2 e) from -1e30; P = 2^(s·c - m) with
    masked scores at probability 0; each row's sum of P in f32; P·V with P
    as P_hi + P_lo (``split``) or as one bf16 P (the kernel before the
    split); the accumulators rescaled by 2^(m_old - m_new) each tile; the
    output the accumulators over the sum. q, k, v hold bf16 values."""
    B, H, S, hd = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    kf, vf = (t.float().repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    c = math.log2(math.e) / math.sqrt(hd)
    live_len = min(L, L if kv_len is None else kv_len)
    qpos = q_offset + torch.arange(S)[:, None]
    m = torch.full((B, H, S), -1e30)
    l, acc = torch.zeros(B, H, S), torch.zeros(B, H, S, hd)
    for j0 in range(0, L, 64):
        cols = torch.arange(j0, min(L, j0 + 64))[None, :]
        live = cols < live_len
        if causal:
            live = live & (cols <= qpos)
        if window:
            live = live & (cols > qpos - window)
        s = torch.einsum("bhsd,bhld->bhsl", q.float(), kf[:, :, j0:j0 + 64])
        s = s.masked_fill(~live, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        terms = split_bf16(p) if split else (p.to(torch.bfloat16).float(),)
        acc = acc * alpha[..., None] + sum(t @ vf[:, :, j0:j0 + 64] for t in terms)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def test_split_bf16_reproduces_f32_p_to_2_16():
    """P_hi + P_lo is within 2^-16 of every f32 probability (the remainder is
    exact in f32, and rounding it errs by 2^-8 of itself); one bf16 P errs
    by up to 2^-8, 2^-9 and more for most."""
    rng = np.random.default_rng(16)
    p = torch.from_numpy(np.exp2(-30 * rng.random(100_000)).astype(np.float32))
    p = torch.cat([p, torch.tensor([1.0, 0.5, 2.0 ** -20, 1 + 2.0 ** -8, 1 - 2.0 ** -24])])
    hi, lo = split_bf16(p)
    assert ((hi + lo - p).abs() / p).max().item() <= 2.0 ** -16
    one = (hi - p).abs() / p
    assert one.max().item() <= 2.0 ** -8
    assert one.max().item() > 2.0 ** -9 and (one > 2.0 ** -16).float().mean().item() > 0.9


@pytest.mark.parametrize("B,H,Hkv,S,L,hd,kw", [
    (1, 2, 2, 70, 70, 64, {}),                                         # two KV tiles, ragged
    (2, 6, 1, 33, 130, 128, {"window": 40, "q_offset": 97, "kv_len": 120}),   # G = 6
    (1, 4, 4, 17, 17, 112, {}),                                        # hd 112
    (1, 8, 1, 70, 70, 256, {"kv_len": 67}),                            # hd 256, G = 8
    (1, 12, 1, 9, 200, 64, {"q_offset": 191}),                         # G = 12, far along
    (1, 2, 2, 40, 150, 64, {"causal": False, "kv_len": 131}),
])
def test_fa_pv_mirror_matches_plain(B, H, Hkv, S, L, hd, kw):
    """With P split the mirror is flash_attention_plain in f32 up to 2^-16 of
    each probability: |out - plain| <= 2^-16 · max|v| (P·V over the row's
    sum weighs each v by P / sum) beside f32 rounding. With one bf16 P the
    same bound fails."""
    rng = np.random.default_rng(B * H + S + L)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
               for shape in ((B, H, S, hd), (B, Hkv, L, hd), (B, Hkv, L, hd)))
    kw = {"causal": True, **kw}
    ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    atol = 2.0 ** -16 * v.float().abs().max().item()
    np.testing.assert_allclose(fa_pv_mirror(q, k, v, **kw).numpy(), ref.numpy(), rtol=1e-5,
                               atol=atol)
    one_term = fa_pv_mirror(q, k, v, split=False, **kw) - ref
    assert (one_term.abs() > atol + 1e-5 * ref.abs()).any()


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    h = torch.randn(100, 64, generator=gen, device=cuda_device).to(dtype)
    e = (torch.randn(509, 64, generator=gen, device=cuda_device) * 0.05).to(dtype)
    lab = torch.randint(0, 509, (100,), generator=gen, device=cuda_device, dtype=torch.int32)
    torch.testing.assert_close(score_ce(h, e, lab), score_ce_plain(h, e, lab),
                               rtol=tol, atol=tol)
    for B, H, Hkv, S, L, hd, kw in [
            (2, 4, 2, 70, 100, 64, {}),
            (2, 4, 2, 70, 100, 128, {"window": 20, "q_offset": 30, "kv_len": 90}),
            (2, 4, 4, 1, 1, 64, {}),                                  # S = 1
            (2, 4, 2, 1, 513, 128, {"q_offset": 512}),                # one row, far along
            (2, 4, 2, 65, 65, 64, {}),                                # one row past a tile
            (1, 12, 4, 513, 513, 64, {}),
            (1, 28, 4, 513, 513, 128, {}),
            (2, 4, 2, 65, 200, 64, {"q_offset": 135, "window": 70}),  # window edge inside a tile
            (2, 4, 2, 65, 130, 64, {"causal": False, "kv_len": 100}),
            (2, 4, 4, 65, 65, 112, {}),                               # hd 112, MHA
            (2, 8, 2, 65, 200, 112, {"q_offset": 135, "window": 70}),
            (2, 4, 4, 1, 513, 112, {"q_offset": 512}),
            (1, 12, 2, 130, 130, 128, {}),                            # G = 6
            (2, 8, 1, 70, 100, 256, {"kv_len": 90}),                  # hd 256, G = 8
            (2, 8, 1, 65, 130, 256, {"causal": False, "kv_len": 100})]:
        q = torch.randn(B, H, S, hd, generator=gen, device=cuda_device).to(dtype)
        k = torch.randn(B, Hkv, L, hd, generator=gen, device=cuda_device).to(dtype)
        v = torch.randn(B, Hkv, L, hd, generator=gen, device=cuda_device).to(dtype)
        want = flash_attention_plain(q, k, v, **kw).float()
        # in bf16 the kernel keeps P in f32 (P_hi + P_lo), so both round an
        # f32 result once, as flash_decode's bound below says
        rtol, atol = ((tol, tol) if dtype == torch.float32
                      else (1e-2, 1e-3 * want.abs().max().item()))
        torch.testing.assert_close(flash_attention(q, k, v, **kw).float(), want,
                                   rtol=rtol, atol=atol)
    for B, H, Hkv, hd, L, kw in [
            (3, 4, 2, 64, 100, {}),
            (3, 28, 4, 128, 100, {"kv_len": 90, "window": 30}),
            (3, 7, 1, 128, 100, {"kv_len": 3}),
            (3, 28, 4, 128, 8192, {"kv_len": 5001}),
            (3, 28, 4, 128, 512, {"kv_len": 1}),
            (3, 28, 4, 128, 512, {"kv_len": 63}),
            (3, 28, 4, 128, 512, {"kv_len": 64}),
            (3, 32, 4, 64, 512, {"kv_len": 65}),                      # G = 8
            (3, 16, 4, 128, 4096, {"kv_len": 4000, "q_pos": 2500}),   # G = 4
            (2, 4, 4, 64, 1000, {"kv_len": 777}),                     # G = 1
            (2, 28, 4, 128, 32768, {"kv_len": 20001}),
            (2, 28, 4, 128, 4096, {"kv_len": 3000, "window": 1000}),  # window edge inside a tile
            (2, 28, 4, 128, 4096, {"kv_len": 5, "q_pos": 3, "splits": 8}),    # empty partitions
            (2, 32, 32, 112, 1000, {"kv_len": 777}),                  # hd 112, G = 1
            (2, 16, 2, 112, 512, {"kv_len": 65, "q_pos": 40}),        # hd 112, G = 8
            (2, 16, 4, 112, 4096, {"kv_len": 3000, "window": 1000}),  # hd 112, G = 4
            (2, 8, 1, 256, 1000, {"kv_len": 937}),                    # hd 256, G = 8
            (2, 8, 1, 256, 512, {"kv_len": 65, "q_pos": 40})]:        # hd 256
        q = torch.randn(B, H, hd, generator=gen, device=cuda_device).to(dtype)
        # k, v: the model's (B, L, Hkv, hd) cache, read through transposed views
        k, v = (torch.randn(B, L, Hkv, hd, generator=gen, device=cuda_device)
                .to(dtype).transpose(1, 2) for _ in range(2))
        want = flash_decode_plain(q, k, v, **kw).float()
        # in bf16 both round an f32 result once: about one unit in the last
        # place of outputs near 1/sqrt(kv_len), so the bound scales with them
        rtol, atol = ((tol, tol) if dtype == torch.float32
                      else (1e-2, 1e-3 * want.abs().max().item()))
        torch.testing.assert_close(flash_decode(q, k, v, **kw).float(), want,
                                   rtol=rtol, atol=atol)
    r, k, v = (torch.randn(2, 3, 40, 64, generator=gen, device=cuda_device).to(dtype)
               for _ in range(3))
    logw = -torch.rand(2, 3, 40, 64, generator=gen, device=cuda_device)
    u = torch.randn(3, 64, generator=gen, device=cuda_device)
    s0 = torch.randn(2, 3, 64, 64, generator=gen, device=cuda_device)
    for got, want in zip(rwkv6_wkv(r, k, v, logw, u, s0), rwkv6_wkv_plain(r, k, v, logw, u, s0)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)   # f32 sums over 40 steps
