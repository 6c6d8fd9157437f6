"""The port's kernel modules against the JAX package's kernels.

The same numpy inputs go to the Pallas kernels (interpret mode, as
tests/test_kernels.py runs them on the CPU), to their ``kernels/ref.py``
oracles, and to the port's plain PyTorch versions, which are what the
port's wrappers run on CPU tensors. The CUDA kernels themselves run only on
the card: ``test_cuda_kernels_match_plain`` holds them against the plain
versions there and skips elsewhere.
"""
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
from repro_torch.kernels.score_ce import score_ce, score_ce_plain

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
    for hd, kw in [(64, {}), (128, {"window": 20, "q_offset": 30, "kv_len": 90})]:
        q = torch.randn(2, 4, 70, hd, generator=gen, device=cuda_device).to(dtype)
        k = torch.randn(2, 2, 100, hd, generator=gen, device=cuda_device).to(dtype)
        v = torch.randn(2, 2, 100, hd, generator=gen, device=cuda_device).to(dtype)
        torch.testing.assert_close(flash_attention(q, k, v, **kw).float(),
                                   flash_attention_plain(q, k, v, **kw).float(),
                                   rtol=tol, atol=tol)
