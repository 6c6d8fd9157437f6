"""The port's decode path against the JAX package's.

- ``flash_decode_plain`` and ``combine_partials_plain`` (what the port's
  ``flash_decode`` runs on CPU tensors) against the Pallas kernel in interpret
  mode, as tests/test_kernels.py runs it, and its ``kernels/ref.py`` oracle;
- ``ops.gqa_flash_decode`` against the reference's adapter;
- ``gqa_decode``, ``Model.init_cache``/``decode_step`` and ``make_serve_step``
  against the reference on the smoke configs, with a sliding-window ring
  buffer that wraps, the caches compared leaf by leaf.

Inputs come from numpy with a seed and the same arrays go to both packages.
The CUDA kernel itself runs only on the card (tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.kernels.flash_decode import combine_partials
from repro.kernels.flash_decode import flash_decode as jflash_decode
from repro.kernels.ref import flash_decode_ref
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import attention as jattn
from repro.models import build_model
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_decode import (HEADS_PER_BLOCK, ROWS_PER_TILE,
                                              auto_splits, combine_partials_plain,
                                              flash_decode, flash_decode_plain, live_range,
                                              rows_per_split)
from repro_torch.launch import make_serve_step
from repro_torch.models import Model, params_from_jax
from repro_torch.models.attention import GQAAttention, gqa_decode, gqa_init_cache
from test_torch_model import numpy_params

from _hypothesis_compat import given, settings, st

TOL = 2e-5        # kernel plain versions in f32, as tests/test_kernels.py
MODEL_TOL = 1e-5  # the model in f32, as tests/test_torch_model.py


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# -- flash_decode ----------------------------------------------------------------

DECODE_CASES = [  # B, H, Hkv, L, hd, kv_len, q_pos, window, splits
    (2, 4, 4, 40, 32, None, None, 0, 4),      # MHA (G = 1), whole cache live
    (2, 4, 2, 50, 32, 33, None, 0, 8),        # G = 2, ragged kv_len
    (1, 7, 1, 64, 16, 64, 40, 0, 4),          # G = 7, q_pos < kv_len - 1
    (2, 14, 2, 48, 32, 45, 44, 12, 4),        # G = 7, sliding window
    (1, 4, 2, 64, 32, 5, None, 0, 8),         # 5 live rows in 8 splits: 3 partitions empty
    (2, 8, 2, 300, 16, 260, 259, 0, 3),       # several TPU KV tiles, ragged against them
    (2, 4, 4, 40, 112, 33, None, 0, 4),       # hd 112 (zamba2-7b), G = 1, ragged kv_len
    (1, 8, 2, 64, 112, 64, 40, 10, 4),        # hd 112, G = 4, q_pos < kv_len - 1, window
    (1, 8, 1, 70, 112, 65, None, 0, 8),       # hd 112, G = 8, 65 live rows in 8 splits
    (1, 8, 1, 70, 256, 67, None, 0, 8),       # hd 256 (paligemma-3b), G = 8, kv_len in a tile
    (2, 8, 1, 50, 256, 41, 38, 16, 4),        # hd 256, q_pos < kv_len - 1, window
]


@pytest.mark.parametrize("B,H,Hkv,L,hd,kv_len,q_pos,window,splits", DECODE_CASES)
def test_flash_decode_plain_matches_pallas_and_ref(B, H, Hkv, L, hd, kv_len, q_pos,
                                                    window, splits):
    rng = np.random.default_rng(B * H + L + splits)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, L, hd)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, L, hd)).astype(np.float32)
    kw = dict(kv_len=kv_len, q_pos=q_pos, window=window)
    ours = flash_decode(*map(torch.from_numpy, (q, k, v)), splits=splits, **kw)
    assert ours.shape == (B, H, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(ours, jflash_decode(jq, jk, jv, splits=splits, interpret=True, **kw))
    _close(ours, flash_decode_ref(jq, jk, jv, **kw))


def test_flash_decode_plain_is_independent_of_splits():
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 6, 32), (2, 2, 70, 32), (2, 2, 70, 32)))
    ref = flash_decode_plain(q, k, v, kv_len=61, splits=1)
    for splits in (2, 7, 64, 100):
        _close(flash_decode_plain(q, k, v, kv_len=61, splits=splits), ref)


def test_combine_partials_plain_matches_jax():
    """Empty partitions (lse = -1e30) get weight 0; a row whose partitions
    are all empty combines to 0."""
    rng = np.random.default_rng(5)
    o = rng.normal(size=(2, 3, 6, 4, 16)).astype(np.float32)
    lse = (3 * rng.normal(size=(2, 3, 6, 4))).astype(np.float32)
    lse[0, 1, 2:] = -1e30
    lse[1, 2] = -1e30
    ours = combine_partials_plain(torch.from_numpy(o), torch.from_numpy(lse), dim=2)
    _close(ours, combine_partials(jnp.asarray(o), jnp.asarray(lse), axis=2))
    assert torch.all(ours[1, 2] == 0)


@pytest.mark.parametrize("rank,window,L,kv_len", [(4, 0, 40, 31), (3, 0, 40, 31), (4, 9, 40, 31),
                                                  (4, 0, 300, 261)])   # several TPU KV tiles
def test_gqa_flash_decode_matches_jax_adapter(rank, window, L, kv_len):
    """``splits=None``, as ``gqa_decode`` passes it: on CPU tensors the
    reference's 8 partitions, so the result is the JAX adapter's."""
    rng = np.random.default_rng(rank + window)
    B, H, Hkv, hd = 2, 14, 2, 32
    q = rng.normal(size=(B, 1, H, hd) if rank == 4 else (B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32)
    ours = ops.gqa_flash_decode(*map(torch.from_numpy, (q, k, v)), kv_len=kv_len,
                                q_pos=kv_len - 1, window=window, splits=None)
    assert ours.shape == q.shape
    _close(ours, jops.gqa_flash_decode(*map(jnp.asarray, (q, k, v)), kv_len=kv_len,
                                       q_pos=kv_len - 1, window=window))


def test_gqa_flash_decode_rejects_oversized_head_dim():
    x = torch.zeros(1, 1, 4, 512)
    with pytest.raises(ValueError, match="head_dim=512"):
        ops.gqa_flash_decode(x, x, x, kv_len=1, q_pos=0)


# -- auto_splits -------------------------------------------------------------------

def _check_auto_splits(B, Hkv, G, sms, L, kv_len, q_pos, window):
    """The partitions ``auto_splits`` gives the kernel hold every live row
    exactly once, none is shorter than one tile (unless all the live rows
    are), and the grid gives no SM a second block (or takes one partition)."""
    lo, hi = live_range(L, kv_len, q_pos, window)
    splits = auto_splits(B, Hkv, G, hi - lo, sms)
    per = rows_per_split(lo, hi, splits)
    parts = [(lo + s * per, min(lo + (s + 1) * per, hi)) for s in range(splits)]
    assert [r for a, b in parts for r in range(a, b)] == list(range(lo, hi))
    assert all(b - a >= min(ROWS_PER_TILE, hi - lo) for a, b in parts)
    assert splits == 1 or splits * B * Hkv * -(-G // HEADS_PER_BLOCK) <= sms
    return splits


@pytest.mark.parametrize("B,L,kv_len,q_pos,window,want", [
    (16, 32768, 32767, None, 0, 2),     # the serve shape: 2 x 64 blocks on 132 SMs
    (16, 32768, 32768, None, 0, 2),
    (16, 32768, 20001, None, 0, 2),
    (16, 32768, 1, None, 0, 1),
    (16, 32768, 5, None, 0, 1),
    (1, 32768, 127, None, 0, 1),        # under two tiles: one partition
    (1, 32768, 128, None, 0, 2),
    (1, 32768, 32767, None, 0, 33),     # one sequence: 33 x 4 blocks
    (1, 4096, 4000, 2500, 0, 33),       # q_pos < kv_len - 1: 2501 live rows
    (1, 4096, 3000, None, 1000, 14),    # a window: 1000 live rows; 15 splits would leave 62
    (1, 4096, 3000, None, 100, 1),
])
def test_auto_splits_at_the_serve_shape(B, L, kv_len, q_pos, window, want):
    assert _check_auto_splits(B, 4, 7, 132, L, kv_len, q_pos, window) == want


@settings(max_examples=200, deadline=None, database=None, derandomize=True)
@given(B=st.integers(1, 64), Hkv=st.sampled_from([1, 2, 4, 8]), G=st.integers(1, 20),
       sms=st.sampled_from([78, 114, 132]), L=st.integers(1, 70000),
       live_share=st.floats(0.0, 1.0), window=st.sampled_from([0, 1, 63, 64, 65, 1000]))
def test_auto_splits_partitions_every_live_row_once(B, Hkv, G, sms, L, live_share, window):
    kv_len = max(1, int(L * live_share))
    _check_auto_splits(B, Hkv, G, sms, L, kv_len, None, window)


# -- gqa_decode --------------------------------------------------------------------

def _attention_pair(cfg_name="qwen2-7b", seed=3):
    """One attention layer's weights from numpy, as a reference dict and as
    the port's module."""
    jcfg, cfg = jax_smoke_config(cfg_name), smoke_config(cfg_name)
    jtree = numpy_params(build_model(jcfg), seed)["blocks"]["attn"]
    tree = {k: np.asarray(v)[0] for k, v in jtree.items()}
    attn = GQAAttention(cfg, device=torch.device("cpu"), dtype=torch.float32)
    with torch.no_grad():
        for name, arr in tree.items():
            getattr(attn, name).copy_(torch.from_numpy(arr))
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in tree.items()}, attn


def _filled_cache(cfg, B, L, n, seed):
    """A cache whose first n slots hold positions 0..n-1."""
    rng = np.random.default_rng(seed)
    Hkv, hd = cfg.kv_heads(), cfg.resolved_head_dim()
    k = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, hd)).astype(np.float32)
    pos = np.full((B, L), -1, np.int32)
    pos[:, :n] = np.arange(n)
    return {"k": k, "v": v, "pos": pos}


@pytest.mark.parametrize("use_flash,window", [(True, 0), (False, 0), (True, 6), (False, 6)])
def test_gqa_decode_matches_jax(use_flash, window):
    jcfg, cfg, jp, attn = _attention_pair()
    B, L, n = 2, 24, 10
    arrays = _filled_cache(cfg, B, L, n, seed=7)
    x = np.random.default_rng(8).normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jy, jcache = jattn.gqa_decode(jcfg, jp, jnp.asarray(x),
                                  {k: jnp.asarray(a) for k, a in arrays.items()},
                                  jnp.int32(n), window=window, use_flash=use_flash)
    cache = {k: torch.from_numpy(a.copy()) for k, a in arrays.items()}
    with torch.no_grad():
        y, out_cache = gqa_decode(cfg, attn, torch.from_numpy(x), cache, n, window=window,
                                  use_flash=use_flash)
    assert out_cache is cache                     # written in place
    _close(y, jy, MODEL_TOL)
    for name in ("k", "v", "pos"):
        _close(cache[name], jcache[name], MODEL_TOL)


def test_gqa_decode_raises_once_the_cache_wraps(monkeypatch):
    """No window and cache_len >= L: the prefix is no longer contiguous.
    On CUDA (the device check mocked here) that raises before the cache is
    touched; on the CPU it takes the position-masked path, as the
    reference's CPU run does; asking for the kernel raises on both."""
    _, cfg, _, attn = _attention_pair()
    B, L = 1, 8
    x = torch.zeros(B, 1, cfg.d_model)
    cache = gqa_init_cache(cfg, B, L, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        with pytest.raises(ValueError, match="use_flash"):
            gqa_decode(cfg, attn, x, cache, L, use_flash=True)
        gqa_decode(cfg, attn, x, cache, L)                       # CPU: masked path
        assert int(cache["pos"][0, 0]) == L
        monkeypatch.setattr(_build, "device_kind", lambda *ts: "cuda")
        with pytest.raises(ValueError, match="wrapped"):
            gqa_decode(cfg, attn, x, cache, L + 1)
    assert int(cache["pos"][0, 1]) == -1                         # untouched


# -- the model's decode step -------------------------------------------------------

DECODE_ARCHS = [("qwen2-7b", 0), ("gpt2-base", 0), ("qwen2-7b", 4),   # (arch, sliding window)
                ("command-r-plus-104b", 0), ("internlm2-20b", 0), ("command-r-plus-104b", 4)]


def _model_pair(arch, window, seed=2):
    jcfg = jax_smoke_config(arch).with_overrides(sliding_window=window)
    jmodel = build_model(jcfg)
    tree = numpy_params(jmodel, seed)
    model = Model(smoke_config(arch).with_overrides(sliding_window=window), device="cpu",
                  seed=None)
    model.load_state_dict(params_from_jax(tree))
    return jmodel, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("arch,window", DECODE_ARCHS)
def test_decode_step_matches_jax(arch, window):
    """Eight teacher-forced tokens into a 16-token cache; with a window of
    4 the buffer holds 4 slots and wraps twice."""
    jmodel, params, model = _model_pair(arch, window)
    B, S, length = 2, 8, 16
    tokens = np.random.default_rng(9).integers(3, 512, (B, S)).astype(np.int32)
    jstep = jax.jit(jmodel.decode_step)
    jcache, cache = jmodel.init_cache(B, length), model.init_cache(B, length)
    L = min(length, window) if window else length
    assert cache["blocks"]["kv"]["k"].shape == (2, B, L, 2, 64)
    for t in range(S):
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        assert logits.shape == (B, 1, 512) and logits.dtype == torch.float32
        _close(logits, jlogits, MODEL_TOL)
    for name in ("k", "v", "pos"):
        _close(cache["blocks"]["kv"][name], jcache["blocks"]["kv"][name], MODEL_TOL)


def _ring_positions(cache_len, slots):
    """The position each slot of a ring holds once positions 0 .. cache_len - 1
    were written at slot position % slots (chip_smoke.ring_positions)."""
    s = np.arange(slots)
    return ((cache_len - 1) - ((cache_len - 1 - s) % slots)).astype(np.int32)


def test_long_500k_decode_past_the_ring_wrap_matches_jax():
    """long_500k through model_for_shape on qwen2-7b's smoke cut: an
    8192-slot ring of the window (init_cache at 524288 tokens), seeded with
    K/V at the positions it holds at cache_len 524286, then the two steps to
    position 524287, each writing over the slot of a position that leaves
    the window. Logits per step and every cache leaf after, against the
    reference's.

    The reference runs eagerly: jitted, XLA folds RoPE's frequencies
    1 / theta ** (2i / hd) to other f32 values (one ulp in 10 of 32 at hd
    64), and an f32 angle of position x frequency near 5e5 turns that ulp
    into about 0.02 rad, so the jitted step's keys and queries part from
    the eager ones (and the port's) by about 2e-2. Eager, its frequencies
    are the port's bit for bit."""
    from repro.config import INPUT_SHAPES as JSHAPES
    from repro.launch.steps import model_for_shape as jmodel_for_shape
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.launch import model_for_shape

    shape = INPUT_SHAPES["long_500k"]
    jcfg = jmodel_for_shape(jax_smoke_config("qwen2-7b"), JSHAPES["long_500k"])
    cfg = model_for_shape(smoke_config("qwen2-7b"), shape)
    assert cfg.sliding_window == jcfg.sliding_window == 8192
    jmodel = build_model(jcfg)
    tree = numpy_params(jmodel, seed=6)
    model = Model(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(tree))
    params = jax.tree.map(jnp.asarray, tree)
    B, steps = 1, 2
    start = shape.seq_len - steps
    jcache, cache = jmodel.init_cache(B, shape.seq_len), model.init_cache(B, shape.seq_len)
    kv = cache["blocks"]["kv"]
    layers, _, slots, Hkv, hd = kv["k"].shape
    assert slots == 8192 and jcache["blocks"]["kv"]["k"].shape == kv["k"].shape
    rng = np.random.default_rng(11)
    arrays = {"k": rng.normal(size=kv["k"].shape).astype(np.float32),
              "v": rng.normal(size=kv["v"].shape).astype(np.float32),
              "pos": np.broadcast_to(_ring_positions(start, slots), kv["pos"].shape).copy()}
    jcache = {"blocks": {"kv": {k: jnp.asarray(a) for k, a in arrays.items()}}}
    for name, a in arrays.items():
        kv[name].copy_(torch.from_numpy(a))
    tokens = rng.integers(3, 512, (B, steps)).astype(np.int32)
    for t in range(steps):
        with jax.disable_jit():
            jlogits, jcache = jmodel.decode_step(params, jcache, jnp.asarray(tokens[:, t:t + 1]),
                                                 jnp.int32(start + t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), start + t)
        _close(logits, jlogits, MODEL_TOL)
    for name in ("k", "v", "pos"):
        _close(cache["blocks"]["kv"][name], jcache["blocks"]["kv"][name], MODEL_TOL)
    written = (start + np.arange(steps)) % slots
    assert (cache["blocks"]["kv"]["pos"][0, 0, written].numpy() == start + np.arange(steps)).all()


def test_serve_step_tokens_match_jax():
    jmodel, params, model = _model_pair("qwen2-7b", 0, seed=4)
    B = 3
    jserve, serve = jax.jit(jax_make_serve_step(jmodel)), make_serve_step(model)
    jcache, cache = jmodel.init_cache(B, 12), model.init_cache(B, 12)
    tok = np.random.default_rng(1).integers(3, 512, (B, 1)).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for t in range(6):
        jtok, jcache = jserve(params, jcache, jtok, jnp.int32(t))
        ttok, cache = serve(cache, ttok, t)
        assert ttok.dtype == torch.int32 and ttok.shape == (B, 1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
