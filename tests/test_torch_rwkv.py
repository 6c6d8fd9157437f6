"""The port's RWKV6 family against the JAX package's, on the smoke config.

- ``rwkv6_wkv_plain`` (what the port's ``rwkv6_wkv`` runs on CPU tensors)
  against the Pallas kernel in interpret mode and the sequential oracle;
- ``ops.wkv``, ``rwkv6_forward`` and ``rwkv6_decode`` against the reference
  (whose full-sequence WKV is the chunked scan);
- ``Model`` forward, ``lpt_loss`` and ``decode_step`` through
  ``params_from_jax``;
- a small Prompt Bank: the clustering is held exactly on the reference's
  features and the lookups pick the same origins (the K-medoid tie rule of
  tests/test_torch_slice.py).

Weights are made with numpy in the reference tree's shapes: matrices at
1/sqrt(fan_in), decay biases spread over the reference's [-6, -1], and the
token-shift mixes, LoRAs and bonus larger than the reference's 0.02 so that
every term is exercised.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TuneConfig as JaxTuneConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.core.bank_builder import build_bank_from_pretrain
from repro.core.bank_builder import make_score_fn as jax_make_score_fn
from repro.data import LoaderConfig as JaxLoaderConfig
from repro.data import TaskLoader as JaxTaskLoader
from repro.data import make_tasks as jax_make_tasks
from repro.kernels import ops as jops
from repro.kernels.ref import rwkv6_wkv_ref
from repro.kernels.rwkv_wkv import rwkv6_wkv as jrwkv6_wkv
from repro.models import build_model
from repro.models import ssm as jssm
from repro.train.objectives import lpt_loss as jax_lpt_loss
from repro.tuning.soft_prompt import _probe_tokens
from repro_torch.config import TuneConfig
from repro_torch.configs import smoke_config
from repro_torch.core import PromptBank, PromptEntry, build_bank, make_score_fn
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv_wkv import rwkv6_wkv, rwkv6_wkv_plain
from repro_torch.models import Model, params_from_jax
from repro_torch.models.ssm import RWKV6TimeMix, rwkv6_decode, rwkv6_forward
from repro_torch.train import lpt_loss, token_cross_entropy

TOL = 1e-5
# Whole-model outputs: the reference sums the WKV as a chunked scan, the
# port as the sequential recurrence. The two orders differ by about 2e-6 on
# one time-mix output of magnitude 3; through two blocks and the final norm
# that grows to 1.2e-5 on logits of magnitude 4 (2e-5 over other seeds).
MODEL_TOL = 3e-5
ARCH = "rwkv6-7b"
MIX_STD, LORA_STD, BONUS_STD = 0.3, 0.1, 0.3


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def numpy_params(jmodel, seed):
    """An RWKV6 parameter tree shaped like ``jmodel``'s."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        name = jax.tree_util.keystr(path).split("'")[-2]
        shape = leaf.shape
        if name in ("gamma", "ln_out"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "w0":
            return rng.uniform(-6.0, -1.0, size=shape).astype(np.float32)
        if name in ("mu_x", "mu_rkvwg"):
            return (MIX_STD * rng.normal(size=shape)).astype(np.float32)
        if name == "u":
            return (BONUS_STD * rng.normal(size=shape)).astype(np.float32)
        if name in ("tm_w1", "tm_w2", "decay_w1", "decay_w2"):
            return (LORA_STD * rng.normal(size=shape)).astype(np.float32)
        if name == "embedding":
            fan_in = shape[-1]
        elif name in ("wr", "wk", "wv"):
            fan_in = shape[-3]                       # (L, d, H, hd): contract d
        elif name == "wo":
            fan_in = shape[-3] * shape[-2]           # (L, H, hd, d): contract H*hd
        else:
            fan_in = shape[-2]
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, jmodel.abstract_params())


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, numpy tree, port model) with the same weights."""
    jmodel = build_model(jax_smoke_config(ARCH))
    tree = numpy_params(jmodel, seed=6)
    model = Model(smoke_config(ARCH), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(tree))
    return jmodel, jax.tree.map(jnp.asarray, tree), tree, model


def _wkv_inputs(seed, B, H, T, hd):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(B, H, T, hd)).astype(np.float32) for _ in range(3))
    logw = np.maximum(-np.exp(rng.normal(-1.5, 1.0, size=(B, H, T, hd))), -12.0).astype(np.float32)
    u = (0.5 * rng.normal(size=(H, hd))).astype(np.float32)
    state = (0.5 * rng.normal(size=(B, H, hd, hd))).astype(np.float32)
    return r, k, v, logw, u, state


# -- the WKV kernel's plain version ------------------------------------------------

@pytest.mark.parametrize("T,with_state", [(37, True), (37, False), (5, True)])
def test_rwkv6_wkv_plain_matches_pallas_and_ref(T, with_state):
    """T = 37 is not a multiple of the 16-token chunk."""
    B, H, hd = 2, 3, 32
    r, k, v, logw, u, state = _wkv_inputs(T, B, H, T, hd)
    if not with_state:
        state = np.zeros_like(state)
    y, s = rwkv6_wkv(*map(torch.from_numpy, (r, k, v, logw, u)),
                     torch.from_numpy(state) if with_state else None)
    assert y.shape == (B, H, T, hd) and y.dtype == torch.float32
    flat = lambda a: jnp.asarray(a.reshape(B * H, *a.shape[2:]))
    uu = jnp.asarray(np.broadcast_to(u[None], (B, H, hd)).reshape(B * H, hd))
    jy, js = jrwkv6_wkv(flat(r), flat(k), flat(v), flat(logw), uu, flat(state), chunk=16,
                        interpret=True)
    _close(y.reshape(B * H, T, hd), jy)
    _close(s.reshape(B * H, hd, hd), js)
    ry, rs = rwkv6_wkv_ref(flat(r), flat(k), flat(v), flat(logw), uu, flat(state))
    _close(y.reshape(B * H, T, hd), ry)
    _close(s.reshape(B * H, hd, hd), rs)


# -- the bf16 CUDA kernel's chunk decomposition, mirrored --------------------------

SUB = 16        # the kernel's sub-chunk (csrc/rwkv_wkv.cu kSub)
GUARD = 60.0    # its kMinDecay = e^{-GUARD}: past it a sub-chunk's scores go element by element


def _tf32(x):
    """x as the tensor core reads a TF32 operand: its top 19 bits (sign,
    exponent, 10 mantissa bits), the rest dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """The kernel's split x = hi + lo: hi truncated to TF32, lo = x - hi
    (exact in f32), read by the tensor core as TF32."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a, b):
    """a @ b on the tensor cores with both operands split: lo·hi + hi·lo + hi·hi."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _mm2(a, b):
    """a @ b with a split and b exact in TF32 (bf16 values)."""
    ah, al = _split(a)
    return al @ b + ah @ b


def wkv_chunked_mirror(r, k, v, logw, u, state):
    """What the bf16 kernel computes, written out in f32: sub-chunks of 16
    tokens (zero-padded: logw = 0, r = k = v = 0); per channel w = e^{logw}
    and every decay factor a running product of w (e^{b_t} from the
    sub-chunk's start, e^{c_15 - c_t} from its end, e^{c_15} the product of
    the two halves' products); keys stored as k ⊙ e^{-c} where e^{c_15} >=
    e^{-GUARD} (undone by kscale = e^{c_15} in the update), else as
    k ⊙ e^{c_15 - c}; the scores A by the factored product when every
    channel is inside the guard, else element by element with running
    products; the products in TF32 with split operands."""
    B, H, T, hd = r.shape
    n = -(-T // SUB)
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, n * SUB - T))
    r, k, v, logw = pad(r), pad(k), pad(v), pad(logw)
    S = state.clone() if state is not None else torch.zeros(B, H, hd, hd)
    tri = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), -1)
    eye = torch.eye(SUB, dtype=torch.bool)
    min_decay = torch.tensor(np.exp(-GUARD), dtype=torch.float32)
    ys = []
    for c in range(n):
        sl = slice(c * SUB, (c + 1) * SUB)
        rc, kc, vc = r[:, :, sl], k[:, :, sl], v[:, :, sl]
        w = torch.exp(logw[:, :, sl])
        eb, es = torch.empty_like(w), torch.empty_like(w)
        run = torch.ones(B, H, hd)
        for t in range(SUB):
            eb[:, :, t] = run
            run = run * w[:, :, t]
        run = torch.ones(B, H, hd)
        for t in range(SUB - 1, -1, -1):
            es[:, :, t] = run
            run = run * w[:, :, t]
        ec = eb[:, :, SUB // 2] * es[:, :, SUB // 2 - 1]      # the two halves' products
        safe = ec >= min_decay
        einv = torch.where(safe, 1.0 / ec, torch.ones_like(ec))
        kscale = torch.where(safe, ec, torch.ones_like(ec))
        rt, kt = rc * eb, kc * (es * einv[:, :, None])
        diag = (rc * u[None, :, None] * kc).sum(-1)
        a_fact = torch.where(tri, _mm3(rt, kt.transpose(-1, -2)), 0.0)
        a_elem = torch.zeros(B, H, SUB, SUB)
        for s_ in range(SUB):
            kk = kc[:, :, s_].clone()
            for t in range(s_ + 1, SUB):
                if t >= s_ + 2:
                    kk = kk * w[:, :, t - 1]
                a_elem[:, :, t, s_] = (rc[:, :, t] * kk).sum(-1)
        steep = (~safe).any(-1)[:, :, None, None]
        A = torch.where(steep, a_elem, a_fact) + torch.where(eye, diag[..., None], 0.0)
        ys.append(_mm3(rt, S) + _mm2(A, vc))
        S = ec[..., None] * S + kscale[..., None] * _mm2(kt.transpose(-1, -2), vc)
    return torch.cat(ys, dim=2)[:, :, :T], S


def wkv_float64(r, k, v, logw, u, state):
    """The sequential recurrence in float64 (numpy), the yardstick of the
    f32 versions."""
    B, H, T, hd = r.shape
    s = np.zeros((B, H, hd, hd)) if state is None else np.asarray(state, np.float64)
    r, k, v = (np.asarray(a, np.float64) for a in (r, k, v))
    w, u = np.exp(np.asarray(logw, np.float64)), np.asarray(u, np.float64)
    ys = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(np.einsum("bhd,bhde->bhe", r[:, :, t], s + u[None, :, :, None] * kv))
        s = w[:, :, t, :, None] * s + kv
    return np.stack(ys, axis=2), s


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float()


@pytest.mark.parametrize("T", [1, SUB - 1, SUB, SUB + 1, 2 * SUB + 1])
@pytest.mark.parametrize("decay", ["drawn", "none", "steep", "mixed", "edge"])
def test_chunked_wkv_mirror_matches_plain_and_pallas(T, decay):
    """The kernel's decomposition at the sub-chunk's edges, held to 1e-5 in
    f32 against the sequential recurrence (float64 and f32) and the Pallas
    kernel (interpret mode, chunk 16). Decays: the model's draws; none
    (logw = 0); steep (logw = -e^4 ≈ -55 in every step: element-by-element
    scores); mixed (steep in half the channels: element-by-element scores,
    and a state update that mixes both key scalings); edge (logw = -3.7, a
    sub-chunk total of -59.2 just inside the guard: factors up to e^59).

    The Pallas kernel exponentiates differences of f32 cumulative sums,
    which err by |sum|·2^-24: at steep decays (sums near -880) it is itself
    up to 5e-5 from the float64 recurrence. Against it the bound is 1e-5
    plus its own distance from float64, measured here."""
    B, H, hd = 1, 2, 64
    r, k, v, logw, u, state = _wkv_inputs(100 + T, B, H, T, hd)
    logw = {"drawn": logw, "none": np.zeros_like(logw),
            "steep": np.full_like(logw, -np.exp(4.0)),
            "mixed": np.where(np.arange(hd) % 2 == 0, -np.exp(4.0), logw),
            "edge": np.full_like(logw, -3.7)}[decay].astype(np.float32)
    rt, kt, vt = _bf16(r), _bf16(k), _bf16(v)       # the kernel's bf16 inputs, widened
    lt, ut = torch.from_numpy(logw), torch.from_numpy(u)
    st = torch.from_numpy(state) if T % 2 else None   # odd T from a given state
    y, s = wkv_chunked_mirror(rt, kt, vt, lt, ut, st)
    y64, s64 = wkv_float64(rt.numpy(), kt.numpy(), vt.numpy(), logw, u,
                           None if st is None else state)
    _close(y, y64)
    _close(s, s64)
    py, ps = rwkv6_wkv_plain(rt, kt, vt, lt, ut, st)
    _close(y, py)
    _close(s, ps)
    flat = lambda a: jnp.asarray(np.asarray(a).reshape(B * H, *a.shape[2:]))
    uu = jnp.asarray(np.broadcast_to(u[None], (B, H, hd)).reshape(B * H, hd))
    s0 = np.zeros((B, H, hd, hd), np.float32) if st is None else state
    jy, js = jrwkv6_wkv(flat(rt), flat(kt), flat(vt), flat(logw), uu, flat(s0), chunk=16,
                        interpret=True)
    for ours, ref, exact in ((y.reshape(B * H, T, hd), jy, y64), (s.reshape(B * H, hd, hd), js, s64)):
        ref, exact = np.asarray(ref, np.float64), exact.reshape(np.shape(ref))
        own = float(np.max(np.abs(ref - exact) / (1 + np.abs(exact))))
        _close(ours, ref, TOL + own)


def test_wkv_matches_jax_adapter():
    r, k, v, logw, u, state = _wkv_inputs(3, 2, 4, 21, 16)
    y, s = ops.wkv(*map(torch.from_numpy, (r, k, v, logw, u, state)))
    jy, js = jops.wkv(*map(jnp.asarray, (r, k, v, logw, u, state)), chunk=8)
    _close(y, jy)
    _close(s, js)


# -- time mixing --------------------------------------------------------------------

def _tmix(pair):
    jmodel, params, tree, model = pair
    jp = {k: v[0] for k, v in params["blocks"]["tmix"].items()}
    return jp, model.blocks[0].tmix


def test_time_mix_params_follow_the_reference(pair):
    jmodel, _, _, model = pair
    jspecs = jssm.rwkv6_params(jmodel.cfg, 1)
    tmix = RWKV6TimeMix(model.cfg, device=torch.device("cpu"), dtype=torch.bfloat16)
    names = dict(tmix.named_parameters())
    assert sorted(names) == sorted(jspecs)
    for name, spec in jspecs.items():
        assert tuple(names[name].shape) == spec.shape
        want = torch.float32 if spec.dtype == "float32" else torch.bfloat16
        assert names[name].dtype == want, name


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_forward_matches_jax(pair, with_state):
    jp, tmix = _tmix(pair)
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    rng = np.random.default_rng(12)
    B, S, d = 2, 21, cfg.d_model
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    state = {"s": (0.3 * rng.normal(size=(B, 8, 32, 32))).astype(np.float32),
             "x_prev": rng.normal(size=(B, d)).astype(np.float32)}
    jout, jst = jssm.rwkv6_forward(jcfg, jp, jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, state) if with_state else None)
    with torch.no_grad():
        out, st = rwkv6_forward(cfg, tmix, torch.from_numpy(x),
                                {k: torch.from_numpy(v) for k, v in state.items()}
                                if with_state else None)
    _close(out, jout)
    _close(st["s"], jst["s"])
    _close(st["x_prev"], jst["x_prev"])


def test_rwkv6_decode_matches_jax(pair):
    jp, tmix = _tmix(pair)
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    rng = np.random.default_rng(13)
    B, d = 3, cfg.d_model
    x = rng.normal(size=(B, 1, d)).astype(np.float32)
    state = {"s": (0.3 * rng.normal(size=(B, 8, 32, 32))).astype(np.float32),
             "x_prev": rng.normal(size=(B, d)).astype(np.float32)}
    jout, jst = jssm.rwkv6_decode(jcfg, jp, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    with torch.no_grad():
        out, st = rwkv6_decode(cfg, tmix, torch.from_numpy(x),
                               {k: torch.from_numpy(v) for k, v in state.items()})
    _close(out, jout)
    _close(st["s"], jst["s"])
    _close(st["x_prev"], jst["x_prev"])


# -- the model ------------------------------------------------------------------------

def _inputs(seed, d, B=2, S=12, P=4, V=512):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    prompt = (rng.normal(size=(P, d)) * 0.1).astype(np.float32)
    batch = {"tokens": tokens,
             "labels": rng.integers(0, V, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) > 0.3).astype(np.float32)}
    return tokens, prompt, batch


def test_checkpoint_tree_loads_unchanged(pair):
    _, _, tree, model = pair
    np.testing.assert_array_equal(model.blocks[1].tmix.w0.detach().numpy(),
                                  tree["blocks"]["tmix"]["w0"][1])
    np.testing.assert_array_equal(model.blocks[0].ffn.w_gate.detach().numpy(),
                                  tree["blocks"]["ffn"]["w_gate"][0])


@pytest.mark.parametrize("with_prompt", [False, True])
def test_backbone_and_forward_match_jax(pair, with_prompt):
    jmodel, params, _, model = pair
    tokens, prompt, _ = _inputs(0, model.cfg.d_model)
    jp = jnp.asarray(prompt) if with_prompt else None
    tp = torch.from_numpy(prompt) if with_prompt else None
    with torch.no_grad():
        hidden = model.backbone(torch.from_numpy(tokens), tp)
        logits = model(torch.from_numpy(tokens), tp)
    jhidden, _ = jmodel.backbone(params, jnp.asarray(tokens), prompt=jp)
    jlogits, _ = jmodel.forward(params, jnp.asarray(tokens), prompt=jp)
    assert logits.shape == (2, 12 + (4 if with_prompt else 0), 512)
    _close(hidden, jhidden, MODEL_TOL)
    _close(logits, jlogits, MODEL_TOL)


def test_lpt_loss_matches_jax(pair):
    jmodel, params, _, model = pair
    _, prompt, batch = _inputs(1, model.cfg.d_model)
    jtotal, (jmean, jper) = jax_lpt_loss(jmodel, params, jnp.asarray(prompt),
                                         {k: jnp.asarray(v) for k, v in batch.items()}, 4)
    with torch.no_grad():
        total, (mean, per) = lpt_loss(model, torch.from_numpy(prompt),
                                      {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(mean), float(jmean), rtol=TOL)
    _close(per, jper)
    assert float(total) == float(mean) and float(jtotal) == float(jmean)   # no auxiliary loss


@pytest.mark.parametrize("arch", ["qwen2-7b", ARCH])
def test_untied_output_embedding_is_kept_not_copied_per_call(arch):
    """lpt_loss reads one (V, d) copy of the untied unembedding, made when
    the weights are set, and follows the weights when they are loaded."""
    model = Model(smoke_config(arch), device="cpu", seed=1)
    _, prompt, batch = _inputs(2, model.cfg.d_model)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    emb = model.output_embedding()
    assert emb.shape == (512, model.cfg.d_model)
    torch.testing.assert_close(emb, model.unembed.detach().T, rtol=0, atol=0)
    with torch.no_grad():
        first = lpt_loss(model, torch.from_numpy(prompt), batch)
        second = lpt_loss(model, torch.from_numpy(prompt), batch)
        logits = model(batch["tokens"], torch.from_numpy(prompt))
        ref, _ = token_cross_entropy(logits[:, -12:], batch["labels"], batch["mask"])
    assert model.output_embedding().data_ptr() == emb.data_ptr()
    (_, (first_mean, _)), (_, (second_mean, _)) = first, second
    assert float(first_mean) == float(second_mean)
    np.testing.assert_allclose(float(first_mean), float(ref), rtol=TOL)
    state = model.state_dict()
    state["unembed"] = state["unembed"] * 2
    model.load_state_dict(state)
    torch.testing.assert_close(model.output_embedding(), 2 * emb, rtol=0, atol=0)


def test_untied_output_embedding_refuses_a_stale_copy():
    """An in-place write to the untied unembedding makes its kept copy stale:
    reading it raises until the weights are set again."""
    model = Model(smoke_config(ARCH), device="cpu", seed=1)
    with torch.no_grad():
        model.unembed.mul_(2)
    with pytest.raises(RuntimeError, match="no current"):
        model.output_embedding()
    model.load_state_dict(model.state_dict())
    torch.testing.assert_close(model.output_embedding(), model.unembed.detach().T,
                               rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="no current"):
        Model(smoke_config(ARCH), device="cpu", seed=None).output_embedding()


def test_decode_step_matches_jax(pair):
    jmodel, params, _, model = pair
    B, S = 2, 8
    tokens = np.random.default_rng(4).integers(3, 512, (B, S)).astype(np.int32)
    jstep = jax.jit(jmodel.decode_step)
    jcache, cache = jmodel.init_cache(B, 16), model.init_cache(B, 16)
    assert cache["blocks"]["state"]["s"].shape == (2, B, 8, 32, 32)
    outs = []
    for t in range(S):
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        _close(logits, jlogits, MODEL_TOL)
        outs.append(logits[:, 0])
    for name in ("s", "x_prev"):
        _close(cache["blocks"]["state"][name], jcache["blocks"]["state"][name], MODEL_TOL)
    with torch.no_grad():       # teacher-forced decode reproduces the forward
        _close(torch.stack(outs, dim=1), model(torch.from_numpy(tokens)), MODEL_TOL)


def test_init_weights_follow_the_reference_kinds():
    model = Model(smoke_config(ARCH), device="cpu", seed=0)
    w0 = torch.stack([b.tmix.w0.detach() for b in model.blocks])
    torch.testing.assert_close(w0.flatten(), torch.linspace(-6.0, -1.0, w0.numel()))
    tmix = model.blocks[1].tmix
    assert torch.all(tmix.ln_out == 1)
    for name in ("mu_x", "mu_rkvwg", "tm_w1", "tm_w2", "decay_w1", "decay_w2", "u"):
        assert 0.01 < float(getattr(tmix, name).detach().std()) < 0.03, name


# -- the Prompt Bank ----------------------------------------------------------------

@pytest.fixture(scope="module")
def banks(pair):
    """The reference's bank and the port's candidates on the reference's
    features (``same``), from 6 tasks x 2 variants."""
    jmodel, params, _, model = pair
    tasks = jax_make_tasks(vocab=32, partitions=2)[::4]
    rng = np.random.default_rng(21)
    prompts = {t.task_id: rng.normal(0, 1.0, (16, model.cfg.d_model)).astype(np.float32)
               for t in tasks}
    pre = SimpleNamespace(model=jmodel, params=params, tasks=tasks, task_prompts=prompts)
    jbank = build_bank_from_pretrain(pre, variants_per_prompt=2)
    probes = np.asarray(_probe_tokens(jmodel, 4, 9))
    bank = build_bank(model, prompts, variants_per_prompt=2, probes=probes)
    same = PromptBank(capacity=bank.capacity, num_clusters=bank.num_clusters, seed=bank.seed)
    same.add_candidates([PromptEntry(e.prompt, je.feature, e.origin)
                         for e, je in zip(bank.entries, jbank.entries)])
    same.build()
    return SimpleNamespace(pre=pre, model=model, tasks=tasks, jbank=jbank, bank=bank,
                           same=same)


def test_bank_has_same_clusters(banks):
    jbank, bank, same = banks.jbank, banks.bank, banks.same
    assert len(bank.entries) == 12 and bank.num_clusters == jbank.num_clusters == 3
    assert [e.origin for e in bank.entries] == [e.origin for e in jbank.entries]
    for e, je in zip(bank.entries, jbank.entries):
        np.testing.assert_array_equal(e.prompt, je.prompt)
        _close(e.feature, je.feature)
    assert same.medoid_ids == jbank.medoid_ids
    assert same.clusters == jbank.clusters


@pytest.mark.parametrize("task_index", [0, 2, 5])
def test_lookup_picks_same_prompt(banks, task_index):
    task = banks.tasks[task_index]
    loader = JaxTaskLoader(task, JaxLoaderConfig(batch_size=8))
    jres = banks.jbank.lookup(jax_make_score_fn(banks.pre, task, JaxTuneConfig(batch_size=8),
                                                loader))
    res = banks.same.lookup(make_score_fn(banks.model, task, TuneConfig(batch_size=8), loader))
    assert res.entry.origin == jres.entry.origin
    assert res.evaluations == jres.evaluations
    assert res.cluster == jres.cluster
    np.testing.assert_allclose(res.score, jres.score, rtol=TOL, atol=TOL)
