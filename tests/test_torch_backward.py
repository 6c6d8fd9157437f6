"""The port's two backward kernels' plain versions against JAX's gradients.

The reference has no backward kernel: it differentiates its attention and
its logits through XLA. Its gradient is ``jax.vjp`` of the kernels' oracles
(``repro.kernels.ref.score_ce_ref`` and ``flash_attention_ref``), which is
what ``score_ce_bwd_plain`` and ``flash_attention_bwd_plain`` must give, in
f32 at 2e-5 as the forward kernels' tests hold. The reference's dense
softmax averages a row with no live column where the port's kernels give 0,
so these cases keep a live column in every row. The CUDA kernels run only on
the card: ``test_cuda_backward_kernels_match_plain`` holds them against the
plain versions there and skips elsewhere (``chip_smoke.py`` phase 9a holds
them at the tuning path's shapes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref, score_ce_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention,
                                                 flash_attention_bwd, flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.score_ce import (BWD_CHUNK_BYTES, ScoreCE, bwd_chunk, score_ce,
                                          score_ce_bwd, score_ce_bwd_plain, score_ce_plain)

TOL = 2e-5


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# -- score_ce ------------------------------------------------------------------

@pytest.mark.parametrize("T,D,V,masked", [(37, 64, 300, False), (37, 64, 300, True),
                                          (1, 16, 50, False), (130, 32, 1000, True)])
def test_score_ce_bwd_plain_matches_jax_vjp(T, D, V, masked):
    rng = np.random.default_rng(T + V)
    h = rng.normal(size=(T, D)).astype(np.float32)
    e = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, T).astype(np.int32)
    g = rng.random(T).astype(np.float32)
    if masked:
        g[::3] = 0.0
    nll, vjp = jax.vjp(lambda x: score_ce_ref(x, jnp.asarray(e), jnp.asarray(lab)),
                       jnp.asarray(h))
    (jdh,) = vjp(jnp.asarray(g))
    th, te, tl = torch.from_numpy(h), torch.from_numpy(e), torch.from_numpy(lab)
    tnll, lse = score_ce_plain(th, te, tl, return_lse=True)
    _close(tnll.numpy(), np.asarray(nll))
    dh = score_ce_bwd_plain(th, te, tl, lse, torch.from_numpy(g))
    _close(dh.numpy(), np.asarray(jdh))
    if masked:
        assert (dh[::3] == 0).all()


def test_score_ce_autograd_goes_through_its_backward():
    """Under autograd ``score_ce`` is ``ScoreCE``; on the CPU its gradient is
    the plain backward's, which equals autograd of the plain forward."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(20, 32)).astype(np.float32)).requires_grad_(True)
    e = torch.from_numpy((rng.normal(size=(90, 32)) * 0.3).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 90, 20).astype(np.int32))
    w = torch.from_numpy(rng.random(20).astype(np.float32))
    nll = score_ce(h, e, lab)
    assert nll.grad_fn is not None and type(nll.grad_fn).__name__ == "ScoreCEBackward"
    (dh,) = torch.autograd.grad((nll * w).sum(), h)
    (ref,) = torch.autograd.grad((score_ce_plain(h, e, lab) * w).sum(), h)
    _close(dh.numpy(), ref.numpy())
    with torch.no_grad():
        assert score_ce(h, e, lab).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,V", [(1, 50257), (136, 50257), (1024, 32000), (8192, 32000),
                                 (65536, 32000), (16, 300)])
def test_score_ce_bwd_chunks_stay_in_budget(dtype, T, V):
    """The backward's vocabulary chunks: whole 256-column tiles, one slice of
    the (T, V) gradient within BWD_CHUNK_BYTES unless one tile is already
    larger, never wider than the vocabulary's tiles."""
    c = bwd_chunk(T, V, dtype)
    elt = 2 if dtype == torch.bfloat16 else 4
    assert c % 256 == 0 and 256 <= c <= -(-V // 256) * 256
    assert c == 256 or T * c * elt <= BWD_CHUNK_BYTES


# -- flash_attention -----------------------------------------------------------

FLASH_BWD_CASES = [  # B, H, Hkv, S, L, hd, kwargs; every row keeps a live column
    (2, 4, 4, 24, 24, 64, {"causal": True}),
    (2, 4, 2, 24, 24, 64, {"causal": True}),                               # GQA
    (1, 6, 2, 16, 40, 128, {"causal": True, "q_offset": 24}),
    (2, 4, 2, 30, 30, 64, {"causal": True, "window": 7}),
    (2, 4, 1, 20, 48, 64, {"causal": True, "q_offset": 20, "window": 16, "kv_len": 38}),
    (1, 4, 2, 12, 40, 64, {"causal": False, "kv_len": 29}),
    (2, 8, 2, 33, 33, 128, {"causal": True, "window": 9}),
    # head dim 112 (zamba2-7b's shared attention)
    (1, 4, 2, 30, 30, 112, {"causal": True, "window": 6, "kv_len": 27}),
    (1, 2, 2, 40, 24, 112, {"causal": False, "kv_len": 20}),
    # not causal with S > L (seamless-m4t-medium's cross attention: the
    # decoder's queries against the encoder's rows)
    (1, 4, 2, 33, 20, 64, {"causal": False, "kv_len": 13}),
]


@pytest.mark.parametrize("B,H,Hkv,S,L,hd,kw", FLASH_BWD_CASES)
def test_flash_attention_bwd_plain_matches_jax_vjp(B, H, Hkv, S, L, hd, kw):
    rng = np.random.default_rng(S * L + hd)
    q = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, L, hd)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, L, hd)).astype(np.float32)
    do = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: flash_attention_ref(a, b, c, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tout, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    assert (lse > -1e29).all()                           # no fully masked row
    _close(tout.numpy(), np.asarray(out))
    grads = flash_attention_bwd_plain(tq, tk, tv, tout, torch.from_numpy(do), lse, **kw)
    for g, jg in zip(grads, jgrads):
        _close(g.numpy(), np.asarray(jg))


def test_flash_attention_bwd_plain_zeroes_rows_without_live_columns():
    """The port's convention: a query row that sees nothing gets output 0 and
    gradient 0, and adds nothing to dk or dv."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 2, 20, 64)).astype(np.float32))
                   for _ in range(4))
    kw = dict(causal=True, window=4, kv_len=10)          # rows 13..19 see nothing
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
    assert (lse[..., 13:] < -1e29).all() and (lse[..., :13] > -1e29).all()
    assert (dq[..., 13:, :] == 0).all()
    _, _, dv_live = flash_attention_bwd_plain(q[..., :13, :], k, v, out[..., :13, :],
                                              do[..., :13, :], lse[..., :13], **kw)
    _close(dv.numpy(), dv_live.numpy())


def test_gqa_flash_autograd_goes_through_its_backward():
    """``ops.gqa_flash`` (the model's attention) under autograd is
    ``FlashAttention``; on the CPU its gradients are the plain backward's,
    which equal autograd of the plain forward, for model-layout views."""
    rng = np.random.default_rng(8)
    B, S, H, Hkv, hd = 2, 17, 4, 2, 64
    q = torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(np.float32)).requires_grad_(True)
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)).requires_grad_(True)
    v = torch.from_numpy(rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(B, S, H, hd)).astype(np.float32))
    out = ops.gqa_flash(q, k, v, causal=True, window=5)           # a transposed view
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    ref_out = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    causal=True, window=5).transpose(1, 2)
    refs = torch.autograd.grad((ref_out * w).sum(), (q, k, v))
    for g, r in zip(grads, refs):
        _close(g.numpy(), r.numpy())


def test_backward_wrappers_count_no_cpu_launch():
    """On CPU tensors the wrappers run their plain versions, which launch
    nothing."""
    before = (score_ce_bwd.launches, flash_attention_bwd.launches)
    h = torch.zeros(4, 8)
    score_ce_bwd(h, torch.ones(10, 8), torch.zeros(4, dtype=torch.int32), torch.zeros(4),
                 torch.ones(4))
    q = torch.zeros(1, 2, 4, 64)
    flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 2, 4))
    assert (score_ce_bwd.launches, flash_attention_bwd.launches) == before
    assert issubclass(ScoreCE, torch.autograd.Function)
    assert issubclass(FlashAttention, torch.autograd.Function)


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# The bf16 kernels' tile edges: 64-row query tiles and 128-row KV tiles
# (two warpgroups of 64), a GQA group of 7, a window and kv_len ending inside
# a KV tile; score_ce's 64-row warpgroups and 128-row tiles.
CUDA_FLASH_EDGES = [
    (1, 4, 4, 127, 127, 128, {"causal": True}),
    (1, 4, 4, 128, 128, 64, {"causal": True}),
    (1, 4, 4, 129, 129, 128, {"causal": True}),
    (1, 4, 4, 257, 257, 64, {"causal": True}),
    (2, 14, 2, 129, 257, 128, {"causal": True, "q_offset": 128}),
    (1, 7, 1, 300, 300, 64, {"causal": True, "window": 100, "kv_len": 200}),
]
CUDA_SCORE_T = (100, 1, 64, 65, 128, 129, 273)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_kernels_match_plain(cuda_device, dtype):
    """Both backward kernels against their plain versions, at the tolerances
    of chip_smoke.py's phase 9a, also at the bf16 kernels' tile edges."""
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (3e-2, 1e-2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for T in CUDA_SCORE_T:
        h = torch.randn(T, 64, generator=gen, device=cuda_device).to(dtype)
        e = (torch.randn(509, 64, generator=gen, device=cuda_device) * 0.05).to(dtype)
        lab = torch.randint(0, 509, (T,), generator=gen, device=cuda_device, dtype=torch.int32)
        g = torch.rand(T, generator=gen, device=cuda_device)
        _, lse = score_ce_plain(h, e, lab, return_lse=True)
        ref = score_ce_bwd_plain(h, e, lab, lse, g).float()
        torch.testing.assert_close(score_ce_bwd(h, e, lab, lse, g).float(), ref, rtol=rtol,
                                   atol=atol * ref.abs().max().item())
    for B, H, Hkv, S, L, hd, kw in FLASH_BWD_CASES + CUDA_FLASH_EDGES:
        q = torch.randn(B, H, S, hd, generator=gen, device=cuda_device).to(dtype)
        k = torch.randn(B, Hkv, L, hd, generator=gen, device=cuda_device).to(dtype)
        v = torch.randn(B, Hkv, L, hd, generator=gen, device=cuda_device).to(dtype)
        do = torch.randn(B, H, S, hd, generator=gen, device=cuda_device).to(dtype)
        out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
        for a, b in zip(flash_attention_bwd(q, k, v, out, do, lse, **kw),
                        flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)):
            b = b.float()
            torch.testing.assert_close(a.float(), b, rtol=rtol, atol=atol * b.abs().max().item())
        _, klse = flash_attention(q, k, v, return_lse=True, **kw)
        torch.testing.assert_close(klse, lse, rtol=3e-2, atol=3e-2)
