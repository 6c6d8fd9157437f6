"""The port's MLA attention and its latent decode kernel against the JAX
package's.

- ``mla_decode_plain`` (what the port's ``mla_decode`` runs on CPU tensors)
  against the Pallas kernel in interpret mode, as tests/test_kernels.py runs
  it, and its ``kernels/ref.py`` oracle, at the reference test's dims;
- ``ops.mla_flash_decode`` against the reference's adapter;
- ``mla_forward`` and multi-step ``mla_decode`` against the reference on
  ``smoke_config("deepseek-v2-236b")``, with the kernel path and the
  position-masked path, the caches compared leaf by leaf;
- ``mla_tile_mirror``, the bf16 kernel's arithmetic written out on the CPU
  (64-row tiles, the split rule, f32 online softmax in log2 units, P in one
  bf16 term), against ``mla_decode_plain`` and the Pallas kernel, and at
  deepseek-v2's 128 heads over 32768 rows against phase 8a's bf16
  tolerances: the evidence for the kernel's single P term;
- ``auto_splits``: one wave of blocks, every live row in one partition;
- on the card only: the CUDA kernel against its plain version.

Inputs and weights come from numpy with a seed (weights at 1/sqrt(fan_in))
and the same arrays go to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.kernels.mla_decode import mla_decode as jmla_decode
from repro.kernels.ref import mla_decode_ref
from repro.models import attention as jattn
from repro.models import build_model
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_decode import NEG_INF, combine_partials_plain, rows_per_split
from repro_torch.kernels.mla_decode import (HEADS_PER_BLOCK, ROWS_PER_TILE, auto_splits,
                                            mla_decode, mla_decode_plain)
from repro_torch.models.attention import (MLAAttention, mla_decode as mla_decode_layer,
                                          mla_forward, mla_init_cache)

TOL = 1e-5


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def moe_numpy_params(jmodel, seed):
    """A parameter tree shaped like ``jmodel``'s (any family, MLA and MoE
    included), with well-conditioned numpy values: norms near 1, biases
    near 0, every matrix at 1/sqrt(fan_in) with fan_in the dims it
    contracts, the layer axis first."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        shape = leaf.shape
        if "gamma" in name:
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if "beta" in name or name in ("['bq']", "['bk']", "['bv']"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "['embedding']":
            fan_in = shape[-1]
        elif name in ("['wq']", "['wk']", "['wv']", "['wq_b']", "['wkv_b_k']", "['wkv_b_v']"):
            fan_in = shape[-3]                      # (L, in, H, k): contract in
        elif name == "['wo']":
            fan_in = shape[-3] * shape[-2]          # (L, H, hd, d): contract H*hd
        else:
            fan_in = shape[-2]                      # (..., in, out), expert stacks included
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, jmodel.abstract_params())


# -- mla_decode --------------------------------------------------------------------

# (qk_nope, qk_rope, kv_lora, H): the reference test's dims, deepseek-v2's
# latent geometry (512, 64) last
MLA_DIMS = [(32, 16, 64, 8), (64, 32, 128, 16), (128, 64, 512, 8)]


def _latent_inputs(B, H, L, r, rd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, r)).astype(np.float32) * 0.1,
            rng.normal(size=(B, H, rd)).astype(np.float32),
            rng.normal(size=(B, L, r)).astype(np.float32) * 0.1,
            rng.normal(size=(B, L, rd)).astype(np.float32))


@pytest.mark.parametrize("nope,rope,r,H", MLA_DIMS)
@pytest.mark.parametrize("kv_len,q_pos", [(1, None), (37, None), (96, None), (90, 61)])
def test_mla_decode_plain_matches_pallas_and_ref(nope, rope, r, H, kv_len, q_pos):
    B, L = 2, 96
    scale = 1.0 / np.sqrt(nope + rope)
    arrays = _latent_inputs(B, H, L, r, rope, seed=nope + kv_len)
    ours = mla_decode(*map(torch.from_numpy, arrays), scale=scale, kv_len=kv_len, q_pos=q_pos)
    assert ours.shape == (B, H, r) and ours.dtype == torch.float32
    jarrays = list(map(jnp.asarray, arrays))
    _close(ours, jmla_decode(*jarrays, scale=scale, kv_len=kv_len, q_pos=q_pos, splits=4,
                             bk=32, interpret=True))
    _close(ours, mla_decode_ref(*jarrays, scale=scale, kv_len=kv_len, q_pos=q_pos))


def test_mla_decode_plain_is_independent_of_splits():
    arrays = [torch.from_numpy(a) for a in _latent_inputs(2, 8, 70, 64, 16, seed=3)]
    ref = mla_decode_plain(*arrays, scale=0.2, kv_len=61, splits=1)
    for splits in (2, 7, 64, 100):          # 100 > 61 live rows: empty partitions
        _close(mla_decode_plain(*arrays, scale=0.2, kv_len=61, splits=splits), ref)


# -- the bf16 kernel's arithmetic on the CPU -------------------------------------------

TILE = ROWS_PER_TILE[torch.bfloat16]      # cache rows the bf16 kernel takes per step
LOG2E = 1.4426950408889634
# phase 8a's bf16 tolerances (chip_smoke.py DECODE_BF16_RTOL / _ATOL)
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3


def mla_tile_mirror(q_lat, q_pe, ckv, kpe, *, scale, hi, splits, round_p=True):
    """What the bf16 kernel computes, written out in f32 on the CPU: the live
    rows [0, hi) cut into ``splits`` partitions of ``rows_per_split`` rows,
    each walked in 64-row tiles, the last masked past the partition's end;
    per tile the scores from the (widened bf16) operands with f32 sums, the
    running max in log2 units (scale · log2 e folded in), P = 2^(s·c - m),
    which the running sum takes in f32 and P·ckv as one bf16 term
    (``round_p``), the accumulator rescaled by 2^(m_old - m_new); each
    partition normalised by its own sum, its LSE -1e30 when empty; then the
    exact LSE combine. Returns f32 (B, H, r), before the kernel rounds its
    output to bf16."""
    B, H, r = q_lat.shape
    c = scale * LOG2E
    per = rows_per_split(0, hi, splits)
    q, kv = torch.cat([q_lat, q_pe], -1), torch.cat([ckv, kpe], -1)
    o_part = torch.zeros(B, H, splits, r)
    lse = torch.full((B, H, splits), NEG_INF)
    for sp in range(splits):
        r0, r1 = sp * per, min(sp * per + per, hi)
        m, l, o = torch.full((B, H), NEG_INF), torch.zeros(B, H), torch.zeros(B, H, r)
        for j0 in range(r0, r1, TILE):
            tile = kv[:, j0:j0 + TILE]
            s = torch.einsum("bhk,blk->bhl", q, tile)
            s = torch.where(torch.arange(j0, j0 + tile.shape[1]) < r1, s, -torch.inf)
            mn = torch.maximum(m, s.amax(-1) * c)
            alpha = torch.exp2(m - mn)
            p = torch.exp2(s * c - mn[..., None])
            l = l * alpha + p.sum(-1)
            pv = p.bfloat16().float() if round_p else p
            o = o * alpha[..., None] + torch.einsum("bhl,blr->bhr", pv, tile[..., :r])
            m = mn
        if r1 > r0:
            o_part[:, :, sp] = o / l[..., None]
            lse[:, :, sp] = m / LOG2E + torch.log(l)
    return combine_partials_plain(o_part, lse, dim=2)


def _bf16_latent_inputs(B, H, L, r, rd, seed):
    """N(0, 1) inputs as phase 8a draws them, rounded to bf16 and widened."""
    return [torch.from_numpy(a / a.std()).bfloat16().float()
            for a in _latent_inputs(B, H, L, r, rd, seed)]


@pytest.mark.parametrize("kv_len,q_pos,splits", [
    (TILE - 1, None, 1), (TILE, None, 1), (TILE + 1, None, 1),   # the tile's edges
    (5 * TILE + 7, None, 2), (300, None, 3),                      # ragged tiles in each split
    (300, 150, 2),                                                # q_pos < kv_len - 1
    (3, None, 8),                                                 # five of eight splits empty
    (4, None, 4),                                                 # a split of one row each
])
def test_mla_tile_mirror_matches_plain_and_pallas(kv_len, q_pos, splits):
    """The kernel's tiling, masks, split rule and combine, with P unrounded,
    held to 1e-5 in f32 against the plain version and the Pallas kernel in
    interpret mode; with P in one bf16 term, to phase 8a's bf16 bound."""
    B, H, L, r, rd = 2, 8, 400, 64, 16
    scale = 1.0 / np.sqrt(48)
    arrays = _bf16_latent_inputs(B, H, L, r, rd, seed=kv_len + splits)
    hi = min(kv_len, (kv_len - 1 if q_pos is None else q_pos) + 1)
    ref = mla_decode_plain(*arrays, scale=scale, kv_len=kv_len, q_pos=q_pos, splits=splits)
    exact = mla_tile_mirror(*arrays, scale=scale, hi=hi, splits=splits, round_p=False)
    _close(exact, ref)
    _close(exact, jmla_decode(*map(jnp.asarray, arrays), scale=scale, kv_len=kv_len, q_pos=q_pos,
                              splits=4, bk=32, interpret=True))
    rounded = mla_tile_mirror(*arrays, scale=scale, hi=hi, splits=splits)
    torch.testing.assert_close(rounded, ref, rtol=BF16_RTOL, atol=BF16_ATOL * ref.abs().max().item())


def test_one_bf16_p_term_holds_the_card_tolerance_at_the_serve_width():
    """The evidence for rounding P to one bf16 term: at deepseek-v2's 128
    heads over 32768 live rows (the long_500k partitioning, 66 splits), the
    mirror's output, rounded to bf16 as the kernel rounds it, stays inside
    phase 8a's bound against the plain version; P's rounding alone takes
    under half of it. Two terms (hi + lo) would double P·ckv's products."""
    B, H, L = 1, 128, 32768
    arrays = _bf16_latent_inputs(B, H, L, 512, 64, seed=7)
    arrays = [a.bfloat16() for a in arrays]
    scale = 1.0 / np.sqrt(192)
    splits = auto_splits(B, H, L, 132)
    assert splits == 66
    ref = mla_decode_plain(*arrays, scale=scale, kv_len=L, splits=splits).float()
    mirror = mla_tile_mirror(*(a.float() for a in arrays), scale=scale, hi=L, splits=splits)
    bound = BF16_ATOL * ref.abs().max() + BF16_RTOL * ref.abs()
    assert ((mirror - ref).abs() / bound).max() < 0.5            # P's rounding alone
    torch.testing.assert_close(mirror.bfloat16().float(), ref, rtol=BF16_RTOL,
                               atol=BF16_ATOL * ref.abs().max().item())


@pytest.mark.parametrize("B,H,live,sms,want", [
    (16, 128, 32767, 132, 4),      # deepseek-v2 decode_32k: 128 blocks
    (1, 128, 524287, 132, 66),     # long_500k: 132 blocks
    (2, 64, 37, 132, 1),           # fewer live rows than a tile
    (16, 16, 999, 132, 8),         # one head group: 8 splits of 125 rows
])
def test_mla_auto_splits(B, H, live, sms, want):
    """One wave of one block an SM, no partition shorter than a tile unless
    all the live rows are, and every live row in exactly one partition."""
    splits = auto_splits(B, H, live, sms)
    assert splits == want
    groups = -(-H // HEADS_PER_BLOCK[torch.bfloat16])
    assert splits == 1 or B * groups * splits <= sms
    per = rows_per_split(0, live, splits)
    parts = [(s * per, min(s * per + per, live)) for s in range(splits)]
    assert sum(max(0, b - a) for a, b in parts) == live and parts[-1][1] == live
    assert all(b - a >= min(TILE, live) for a, b in parts)


@pytest.mark.parametrize("rank", [4, 3])
def test_mla_flash_decode_matches_jax_adapter(rank):
    B, H, L, r, rd = 2, 8, 40, 64, 16
    ql, qp, ckv, kpe = _latent_inputs(B, H, L, r, rd, seed=rank)
    if rank == 4:
        ql, qp = ql[:, None], qp[:, None]
    ours = ops.mla_flash_decode(*map(torch.from_numpy, (ql, qp, ckv, kpe)), scale=0.25,
                                kv_len=31, q_pos=30)
    assert ours.shape == ql.shape
    _close(ours, jops.mla_flash_decode(*map(jnp.asarray, (ql, qp, ckv, kpe)), scale=0.25,
                                       kv_len=31, q_pos=30))


# -- MLA attention -------------------------------------------------------------------

def _mla_pair(seed=3, q_lora=None):
    """One MLA layer's weights from numpy, as a reference dict and as the
    port's module."""
    jcfg, cfg = jax_smoke_config("deepseek-v2-236b"), smoke_config("deepseek-v2-236b")
    if q_lora is not None:
        jcfg = jcfg.with_overrides(mla=dataclasses.replace(jcfg.mla, q_lora_rank=q_lora))
        cfg = cfg.with_overrides(mla=dataclasses.replace(cfg.mla, q_lora_rank=q_lora))
    jtree = moe_numpy_params(build_model(jcfg), seed)["moe"]["attn"]
    tree = jax.tree.map(lambda a: np.asarray(a)[0], jtree)
    attn = MLAAttention(cfg, device=torch.device("cpu"), dtype=torch.float32)
    with torch.no_grad():
        for name, arr in tree.items():
            if isinstance(arr, dict):
                getattr(attn, name).gamma.copy_(torch.from_numpy(arr["gamma"]))
            else:
                getattr(attn, name).copy_(torch.from_numpy(arr))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), attn


@pytest.mark.parametrize("q_lora", [None, 0])       # the config's q_lora_rank, and wq
def test_mla_forward_matches_jax(q_lora):
    jcfg, cfg, jp, attn = _mla_pair(q_lora=q_lora)
    B, S = 2, 11
    x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    with torch.no_grad():
        ours = mla_forward(cfg, attn, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    _close(ours, jattn.mla_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos)))


def _filled_latent_cache(cfg, B, L, n, seed):
    """A latent cache whose first n slots hold positions 0..n-1."""
    rng = np.random.default_rng(seed)
    m = cfg.mla
    pos = np.full((B, L), -1, np.int32)
    pos[:, :n] = np.arange(n)
    return {"c_kv": rng.normal(size=(B, L, m.kv_lora_rank)).astype(np.float32),
            "k_rope": rng.normal(size=(B, L, m.qk_rope_head_dim)).astype(np.float32),
            "pos": pos}


@pytest.mark.parametrize("use_flash", [True, False])
def test_mla_decode_matches_jax(use_flash):
    """Five decode steps from a cache holding 10 positions, with the kernel
    path (its plain version here) and the position-masked path, against the
    reference's same path; caches leaf by leaf."""
    jcfg, cfg, jp, attn = _mla_pair()
    B, L, n = 2, 24, 10
    arrays = _filled_latent_cache(cfg, B, L, n, seed=7)
    jcache = {k: jnp.asarray(a) for k, a in arrays.items()}
    cache = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
    xs = np.random.default_rng(8).normal(size=(5, B, 1, cfg.d_model)).astype(np.float32)
    for step, x in enumerate(xs):
        jy, jcache = jattn.mla_decode(jcfg, jp, jnp.asarray(x), jcache, jnp.int32(n + step),
                                      use_flash=use_flash)
        with torch.no_grad():
            y, out_cache = mla_decode_layer(cfg, attn, torch.from_numpy(x), cache, n + step,
                                            use_flash=use_flash)
        assert out_cache is cache                 # written in place
        _close(y, jy)
    for name in ("c_kv", "k_rope", "pos"):
        _close(cache[name], jcache[name])


def test_mla_decode_raises_once_the_cache_wraps(monkeypatch):
    """cache_len >= L: the prefix is no longer contiguous. On CUDA (the
    device check mocked here) that raises before the cache is touched; on
    the CPU it takes the position-masked path, as the reference's CPU run
    does; asking for the kernel raises on both."""
    _, cfg, _, attn = _mla_pair()
    B, L = 1, 8
    x = torch.zeros(B, 1, cfg.d_model)
    cache = mla_init_cache(cfg, B, L, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        with pytest.raises(ValueError, match="use_flash"):
            mla_decode_layer(cfg, attn, x, cache, L, use_flash=True)
        mla_decode_layer(cfg, attn, x, cache, L)                 # CPU: masked path
        assert int(cache["pos"][0, 0]) == L
        monkeypatch.setattr(_build, "device_kind", lambda *ts: "cuda")
        with pytest.raises(ValueError, match="wrapped"):
            mla_decode_layer(cfg, attn, x, cache, L + 1)
    assert int(cache["pos"][0, 1]) == -1                         # untouched


def test_mla_decode_passes_tma_what_it_can_load(monkeypatch):
    """The checks a CUDA call makes before its launch, with the device, the
    card and the library mocked: views whose bases and strides are 16-byte
    multiples reach the launch, with the packed stride for size-1 dims; an
    unaligned base or a row stride TMA cannot take raises first."""
    from repro_torch.kernels import mla_decode as mla_mod
    calls = []

    class Lib:
        def mla_decode_launch(self, *args):
            calls.append(args)
            return 0

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(_build, "device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    monkeypatch.setattr(mla_mod, "_lib", lambda: Lib())
    monkeypatch.setattr(mla_mod.mla_decode, "launches", 0)
    ql, qp = torch.zeros(1, 64, 512, dtype=torch.bfloat16), torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    row = torch.zeros(1, 256, 584, dtype=torch.bfloat16)
    mla_decode(ql, qp, row[..., 8:520], row[..., 520:], scale=0.1, kv_len=200)
    (args,) = calls
    assert args[7:15] == (64 * 512, 512, 64 * 64, 64, 256 * 584, 584, 256 * 584, 584)
    assert args[15:20] == (1, 64, 200, 67, 3)         # B, H, hi, rows per split, splits
    assert mla_mod.mla_decode.launches == 1
    with pytest.raises(ValueError, match="16-byte"):
        mla_decode(ql, qp, row[..., 1:513], row[..., 520:], scale=0.1, kv_len=200)
    narrow = torch.zeros(1, 256, 580, dtype=torch.bfloat16)   # rows 1160 bytes apart
    with pytest.raises(ValueError, match="strides"):
        mla_decode(ql, qp, narrow[..., :512], narrow[..., 512:576], scale=0.1, kv_len=200)
    assert len(calls) == 1


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mla_decode_matches_plain(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for B, H, L, kw, layout in [
            (2, 16, 100, {"kv_len": 3, "splits": 8}, "apart"),     # 5 of 8 splits empty
            (2, 40, 300, {"kv_len": 257}, "apart"),                # H = 40: not a 64-head group
            (1, 128, 2000, {"kv_len": 1500, "q_pos": 900}, "apart"),
            (2, 128, 256, {"kv_len": TILE - 1, "splits": 1}, "apart"),   # the bf16 tile's edges
            (2, 128, 256, {"kv_len": TILE, "splits": 1}, "apart"),
            (2, 128, 256, {"kv_len": TILE + 1, "splits": 1}, "apart"),
            (1, 128, 512, {"kv_len": 5 * TILE + 1, "splits": 1}, "apart"),  # both ring stages, thrice
            (1, 128, 4096, {"kv_len": 3, "splits": 3}, "apart"),   # every split one row
            (2, 128, 3000, {"kv_len": 2999}, "fused")]:             # views of one wider row
        ql, qp = (torch.randn(B, H, d, generator=gen, device=cuda_device).to(dtype)
                  for d in (512, 64))
        if layout == "fused":   # bases 8 and 520 elements into rows of 584: 16-byte multiples
            row = torch.randn(B, L, 584, generator=gen, device=cuda_device).to(dtype)
            ckv, kpe = row[..., 8:520], row[..., 520:]
        else:
            ckv, kpe = (torch.randn(B, L, d, generator=gen, device=cuda_device).to(dtype)
                        for d in (512, 64))
        want = mla_decode_plain(ql, qp, ckv, kpe, scale=192 ** -0.5, **kw).float()
        # in bf16 both round an f32 result once, so the bound scales with it
        rtol, atol = ((2e-5, 2e-5) if dtype == torch.float32
                      else (1e-2, 1e-3 * want.abs().max().item()))
        torch.testing.assert_close(mla_decode(ql, qp, ckv, kpe, scale=192 ** -0.5, **kw).float(),
                                   want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mla_decode_refuses_an_unaligned_view(cuda_device, dtype):
    """A ckv view one element into its rows cannot be loaded by TMA: the
    wrapper says so before any launch."""
    ql, qp = (torch.randn(1, 64, d, device=cuda_device).to(dtype) for d in (512, 64))
    row = torch.randn(1, 256, 584, device=cuda_device).to(dtype)
    with pytest.raises(ValueError, match="16-byte"):
        mla_decode(ql, qp, row[..., 1:513], row[..., 520:], scale=0.1, kv_len=200)