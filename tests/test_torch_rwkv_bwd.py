"""The RWKV6 WKV backward: ``rwkv6_wkv_bwd_plain`` and autograd through
``RWKV6WKV`` against JAX's gradients.

The reference has no backward kernel: XLA differentiates its sequential
oracle (``repro.kernels.ref.rwkv6_wkv_ref``) and its chunked scan
(``repro.models.ssm.rwkv6_forward``), so ``jax.vjp`` of those is what the
port's gradients must give. Both sides compute in f32, in other orders; each
gradient is held at 2e-5 of its largest element against a float64
recurrence (the JAX f32 gradient at 1e-4, since its own rounding is part of
that gap), T around the CUDA kernel's 8-token checkpoint interval and the
forward's 16-token sub-chunk, from a zero or a given state, with and
without a gradient for the final state, at gentle decays and at steep ones
(logw = -e^4, about -55, where w underflows to 1e-24: dlogw = w·Σ G ⊙ S is
formed from the state itself, never by dividing by w). The bf16 CUDA
kernel's chunked algebra is restated on the CPU by
``wkv_bwd_chunked_mirror`` and held to 1e-5 of the float64 gradients. The
CUDA kernels run only on the card: ``test_cuda_rwkv6_wkv_bwd_matches_plain``
holds them against the plain version there and skips elsewhere
(``chip_smoke.py`` phase 9e at the tuning shape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rwkv import ARCH, numpy_params

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.ref import rwkv6_wkv_ref
from repro.models import build_model
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.kernels.rwkv_wkv import (RWKV6WKV, rwkv6_wkv, rwkv6_wkv_bwd,
                                          rwkv6_wkv_bwd_plain)
from repro_torch.models import Model, params_from_jax
from repro_torch.models.ssm import rwkv6_forward

TOL = 2e-5        # against float64, relative to the largest element
JAX_TOL = 1e-4    # against JAX's f32 gradient, relative to the largest element
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


def rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def wkv_inputs(seed, B, H, T, hd, decay):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(B, H, T, hd)) for _ in range(3))
    if decay == "steep":
        logw = np.full((B, H, T, hd), -np.exp(4.0))
        logw[..., ::3, :] = -np.exp(rng.normal(-1.5, 1.0, size=logw[..., ::3, :].shape))
    else:
        logw = np.maximum(-np.exp(rng.normal(-1.5, 1.0, size=(B, H, T, hd))), -12.0)
    u = 0.5 * rng.normal(size=(H, hd))
    state = 0.5 * rng.normal(size=(B, H, hd, hd))
    dy = rng.normal(size=(B, H, T, hd))
    ds = rng.normal(size=(B, H, hd, hd))
    return [x.astype(np.float32) for x in (r, k, v, logw, u, state, dy, ds)]


def float64_grads(r, k, v, logw, u, state, dy, ds):
    """Autograd of the sequential recurrence in float64."""
    leaves = [torch.from_numpy(np.asarray(x, np.float64)).requires_grad_(True)
              for x in (r, k, v, logw, u, state)]
    r_, k_, v_, lw, u_, s = leaves
    w, ys = torch.exp(lw), []
    for t in range(r.shape[2]):
        kv = k_[:, :, t, :, None] * v_[:, :, t, None, :]
        ys.append(torch.einsum("bhd,bhde->bhe", r_[:, :, t], s + u_[None, :, :, None] * kv))
        s = w[:, :, t, :, None] * s + kv
    y = torch.stack(ys, 2)
    loss = (y * torch.from_numpy(np.asarray(dy, np.float64))).sum()
    if ds is not None:
        loss = loss + (s * torch.from_numpy(np.asarray(ds, np.float64))).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)   # T = 1 leaves logw unused
    return [np.zeros(x.shape) if g is None else g.numpy() for g, x in zip(grads, leaves)]


@jax.jit
def _ref_vjp(r, k, v, logw, u, state, dy, ds):
    return jax.vjp(rwkv6_wkv_ref, r, k, v, logw, u, state)[1]((dy, ds))


def jax_grads(r, k, v, logw, u, state, dy, ds):
    """jax.vjp of the reference's oracle, (B·H, T, hd) flattened as its
    kernels take it (compiled once per shape)."""
    B, H, T, hd = r.shape
    flat = lambda a: jnp.asarray(a.reshape(B * H, *a.shape[2:]))
    uu = jnp.asarray(np.broadcast_to(u[None], (B, H, hd)).reshape(B * H, hd))
    cot_s = flat(ds) if ds is not None else jnp.zeros((B * H, hd, hd), jnp.float32)
    g = _ref_vjp(flat(r), flat(k), flat(v), flat(logw), uu, flat(state), flat(dy), cot_s)
    shaped = [np.asarray(x).reshape(B, H, *x.shape[1:]) for x in g]
    shaped[4] = shaped[4].sum(0)                  # du: summed over the batch
    return shaped


ENDS = {"none": (False, False), "state": (True, False), "ds": (False, True),
        "both": (True, True)}


@pytest.mark.parametrize("decay", ["gentle", "steep"])
@pytest.mark.parametrize("ends", sorted(ENDS))
@pytest.mark.parametrize("T", [1, 15, 16, 17, 40])
def test_rwkv6_wkv_bwd_plain_matches_jax_vjp(T, ends, decay):
    with_state, with_ds = ENDS[ends]
    B, H, hd = 2, 3, 16
    r, k, v, logw, u, state, dy, ds = wkv_inputs(T * 7 + len(ends), B, H, T, hd, decay)
    if not with_state:
        state = np.zeros_like(state)
    ds = ds if with_ds else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    ours = rwkv6_wkv_bwd_plain(t(r), t(k), t(v), t(logw), t(u),
                               t(state) if with_state else None, t(dy), t(ds))
    ref64 = float64_grads(r, k, v, logw, u, state, dy, ds)
    refj = jax_grads(r, k, v, logw, u, state, dy, ds)
    for name, a, b64, bj in zip(NAMES, ours, ref64, refj):
        assert a.dtype == torch.float32 and a.shape == b64.shape, name
        assert np.isfinite(a.numpy()).all(), name
        assert rel_max(a, b64) <= TOL, (name, rel_max(a, b64))
        assert rel_max(a, bj) <= JAX_TOL, (name, rel_max(a, bj))


@pytest.mark.parametrize("decay", ["gentle", "steep"])
def test_autograd_goes_through_rwkv6wkv(decay):
    """Under autograd ``rwkv6_wkv`` is ``RWKV6WKV``, whose CPU backward is the
    plain one; the final state's gradient flows in when it is used, u's
    gradient is formed only when u requires grad, and without grad the call
    keeps no graph."""
    B, H, T, hd = 2, 2, 19, 16
    r, k, v, logw, u, state, dy, ds = wkv_inputs(5, B, H, T, hd, decay)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (r, k, v, logw, u, state)]
    y, s = rwkv6_wkv(*leaves)
    assert type(y.grad_fn).__name__ == "RWKV6WKVBackward"
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(ds)).sum(),
                                leaves)
    for name, a, b in zip(NAMES, grads, float64_grads(r, k, v, logw, u, state, dy, ds)):
        assert rel_max(a.detach(), b) <= TOL, name
    # u frozen (as the model's is) and the final state unused: no du, zeros for dS_T
    frozen = [torch.from_numpy(x).requires_grad_(True) for x in (r, k, v, logw)]
    y, _ = rwkv6_wkv(*frozen, torch.from_numpy(u), None)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), frozen)
    ref = float64_grads(r, k, v, logw, u, np.zeros_like(state), dy, None)
    for name, a, b in zip(NAMES, grads, ref):
        assert rel_max(a, b) <= TOL, name
    out = rwkv6_wkv_bwd(*map(torch.from_numpy, (r, k, v, logw, u)), None, torch.from_numpy(dy),
                        need_du=False)
    assert out[4] is None and out[5] is None
    with torch.no_grad():
        assert rwkv6_wkv(*leaves)[0].grad_fn is None
    assert issubclass(RWKV6WKV, torch.autograd.Function)


def test_bwd_takes_the_models_strided_views():
    """The model hands (B, T, H, hd) projections transposed to (B, H, T, hd)
    and autograd hands back dy in whatever strides it has; the gradients
    agree with those of contiguous inputs (up to the order of
    the plain version's sums, which follows the memory layout)."""
    B, H, T, hd = 2, 3, 11, 16
    r, k, v, logw, u, state, dy, ds = wkv_inputs(9, B, H, T, hd, "gentle")
    views = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)
             for x in (r, k, v, logw)]
    dy_t = torch.from_numpy(np.ascontiguousarray(dy.transpose(0, 2, 1, 3))).transpose(1, 2)
    a = rwkv6_wkv_bwd(*views, torch.from_numpy(u), torch.from_numpy(state), dy_t,
                      torch.from_numpy(ds))
    b = rwkv6_wkv_bwd(*map(torch.from_numpy, (r, k, v, logw, u, state, dy, ds)))
    for name, x, y in zip(NAMES, a, b):
        assert rel_max(x, y) <= 1e-6, name


# -- the bf16 CUDA kernel's chunked decomposition, mirrored ------------------------

SUB = 16        # the bf16 kernel's sub-chunk (csrc/rwkv_wkv_bwd.cu kSub)
GUARD = 60.0    # its kMinDecay = e^{-GUARD}: past it a sub-chunk's scores go element by element
MIRROR_TOL = 1e-5


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


def _mm2b(a, b):
    """a @ b with a exact in TF32 (bf16 values) and b split."""
    bh, bl = _split(b)
    return a @ bl + a @ bh


def _decays(logw):
    """Per channel, running products of w = e^{logw} over a sub-chunk, as a
    thread per channel forms them: (w, e^{b_t} = prod_{m<t} w_m,
    e^{c_15 - c_t} = prod_{m>t} w_m, e^{c_15} = the product of all 16)."""
    w = torch.exp(logw)
    eb, es = torch.empty_like(w), torch.empty_like(w)
    run = torch.ones_like(w[:, :, 0])
    for t in range(SUB):
        eb[:, :, t] = run
        run = run * w[:, :, t]
    ec = run
    run = torch.ones_like(ec)
    for t in range(SUB - 1, -1, -1):
        es[:, :, t] = run
        run = run * w[:, :, t]
    return w, eb, es, ec


def wkv_bwd_chunked_mirror(r, k, v, logw, u, state, dy, ds):
    """What the bf16 backward kernel computes, written out in f32: sub-chunks
    of 16 tokens (zero-padded: logw = 0, r = k = v = dy = 0). A forward walk
    keeps the state entering each sub-chunk, S <- e^{c_15} S + (v)ᵀ (k ⊙
    e^{c_15 - c}) on the tensor cores. Then from the last sub-chunk, with
    R̃ = r ⊙ e^{b}, K̃ = k ⊙ e^{c_15 - c} and dA = dY Vᵀ: A by the factored
    product (R̃ ⊙ e^{-c_15}) K̃ᵀ where e^{c_15} >= e^{-GUARD} in every
    channel, else element by element with running products; dY S_inᵀ,
    V G_outᵀ, dv = K̃ G_out + Aᵀ dY and G_in = e^{c_15} G_out + R̃ᵀ dY in TF32
    with split operands; then per channel, element by element, D[t] =
    e^{b_t} (S_in dy_t) gathering sum_{s<t} dA[t][s] e^{b_t - c_s} k_s as s
    advances, dlogw_m = sum_{t>m} r_t D[t] + sum_{s<m} k_s e^{c_15 - c_s}
    (G_out v_s) + e^{c_15} sum_j G_out ⊙ S_in (a sum of products, no
    difference of sums), dr, dk and du. Returns (dr, dk, dv, dlogw, du (H,
    hd), dS_0)."""
    B, H, T, hd = r.shape
    n = -(-T // SUB)
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, n * SUB - T))
    r, k, v, logw, dy = pad(r), pad(k), pad(v), pad(logw), pad(dy)
    sub = lambda x, c: x[:, :, c * SUB:(c + 1) * SUB]
    S = state.clone() if state is not None else torch.zeros(B, H, hd, hd)
    s_in = [S]
    for c in range(n - 1):
        _, _, es, ec = _decays(sub(logw, c))
        upd = _mm2b(sub(v, c).transpose(-1, -2), sub(k, c) * es).transpose(-1, -2)
        S = ec[..., None] * S + upd
        s_in.append(S)
    G = ds.clone() if ds is not None else torch.zeros(B, H, hd, hd)
    min_decay = torch.tensor(np.exp(-GUARD), dtype=torch.float32)
    below = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), -1)
    eye = torch.eye(SUB, dtype=torch.bool)
    dr, dk, dv, dlogw = (torch.zeros(B, H, n * SUB, hd) for _ in range(4))
    du = torch.zeros(B, H, hd)
    for c in reversed(range(n)):
        rc, kc, vc, dyc = (sub(x, c) for x in (r, k, v, dy))
        w, eb, es, ec = _decays(sub(logw, c))
        safe = ec >= min_decay
        einv = torch.where(safe, 1.0 / ec, torch.ones_like(ec))
        rt, kt = rc * eb, kc * es
        dA = _mm2(dyc, vc.transpose(-1, -2))
        a_fact = _mm3(rt * einv[:, :, None], kt.transpose(-1, -2))
        a_elem = torch.zeros(B, H, SUB, SUB)
        for s_ in range(SUB):
            kk = kc[:, :, s_].clone()
            for t in range(s_ + 1, SUB):
                if t >= s_ + 2:
                    kk = kk * w[:, :, t - 1]
                a_elem[:, :, t, s_] = (rc[:, :, t] * kk).sum(-1)
        steep = (~safe).any(-1)[:, :, None, None]
        diag = (rc * u[None, :, None] * kc).sum(-1)
        A = torch.where(below, torch.where(steep, a_elem, a_fact), 0.0) \
            + torch.where(eye, diag[..., None], 0.0)
        S_in = s_in[c]
        dri = _mm3(dyc, S_in.transpose(-1, -2))
        dki = _mm2b(vc, G.transpose(-1, -2))
        eg = ec * (G * S_in).sum(-1)
        dv[:, :, c * SUB:(c + 1) * SUB] = _mm3(kt, G) + _mm3(A.transpose(-1, -2), dyc)
        G = ec[..., None] * G + _mm3(rt.transpose(-1, -2), dyc)
        dd = torch.diagonal(dA, dim1=-2, dim2=-1)[..., None]
        D = [eb[:, :, t] * dri[:, :, t] for t in range(SUB)]
        py = torch.zeros(B, H, hd)
        q = sum(rc[:, :, t] * D[t] for t in range(1, SUB))
        dlogw[:, :, c * SUB] = q + py + eg
        for s_ in range(SUB):
            t_s = c * SUB + s_
            dr[:, :, t_s] = D[s_] + dd[:, :, s_] * u * kc[:, :, s_]
            ep, acc = torch.ones(B, H, hd), torch.zeros(B, H, hd)
            for t in range(s_ + 1, SUB):
                if t >= s_ + 2:
                    ep = ep * w[:, :, t - 1]
                x = dA[:, :, t, s_, None] * ep
                D[t] = D[t] + x * kc[:, :, s_]
                acc = acc + x * rc[:, :, t]
            ys = es[:, :, s_] * dki[:, :, s_]
            dk[:, :, t_s] = ys + acc + dd[:, :, s_] * u * rc[:, :, s_]
            py = py + kc[:, :, s_] * ys
            if s_ + 1 < SUB:
                q = sum((rc[:, :, t] * D[t] for t in range(s_ + 2, SUB)), torch.zeros(B, H, hd))
                dlogw[:, :, t_s + 1] = q + py + eg
            du = du + dd[:, :, s_] * rc[:, :, s_] * kc[:, :, s_]
    cut = lambda x: x[:, :, :T]
    return cut(dr), cut(dk), cut(dv), cut(dlogw), du.sum(0), G


def mirror_decay(logw, decay, hd):
    """The mirror test's decays: the model's draws; none (logw = 0); steep
    (logw = -e^4 ≈ -55 in every step: element-by-element scores); mixed
    (steep in half the channels: element-by-element scores beside channels
    that keep most of their state); edge (logw = -3.7, a sub-chunk total of
    -59.2 just inside the guard: factors up to e^59)."""
    return {"drawn": logw, "none": np.zeros_like(logw),
            "steep": np.full_like(logw, -np.exp(4.0)),
            "mixed": np.where(np.arange(hd) % 2 == 0, -np.exp(4.0), logw),
            "edge": np.full_like(logw, -3.7)}[decay].astype(np.float32)


@pytest.mark.parametrize("ends", sorted(ENDS))
@pytest.mark.parametrize("decay", ["drawn", "none", "steep", "mixed", "edge"])
@pytest.mark.parametrize("T", [1, SUB - 1, SUB, SUB + 1, 2 * SUB - 1, 2 * SUB, 2 * SUB + 1, 40])
def test_chunked_wkv_bwd_mirror_matches_float64_and_jax_vjp(T, decay, ends):
    """The bf16 kernel's decomposition at the sub-chunk's edges, each
    gradient held to 1e-5 of its largest element against the float64
    recurrence's, and against jax.vjp of the reference's oracle to 1e-5
    plus that oracle's own distance from float64 (its f32 sums)."""
    with_state, with_ds = ENDS[ends]
    B, H, hd = 1, 2, 64
    r, k, v, logw, u, state, dy, ds = wkv_inputs(300 + T, B, H, T, hd, "gentle")
    logw = mirror_decay(logw, decay, hd)
    r, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (r, k, v))
    if not with_state:
        state = np.zeros_like(state)
    ds = ds if with_ds else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    ours = wkv_bwd_chunked_mirror(t(r), t(k), t(v), t(logw), t(u),
                                  t(state) if with_state else None, t(dy), t(ds))
    ref64 = float64_grads(r, k, v, logw, u, state, dy, ds)
    refj = jax_grads(r, k, v, logw, u, state, dy, ds)
    for name, a, b64, bj in zip(NAMES, ours, ref64, refj):
        assert a.shape == b64.shape and np.isfinite(a.numpy()).all(), name
        assert rel_max(a, b64) <= MIRROR_TOL, (name, rel_max(a, b64))
        assert rel_max(a, bj) <= MIRROR_TOL + rel_max(bj, b64), (name, rel_max(a, bj))


# -- through the model's time mix: the reference's chunked scan ----------------------

@pytest.fixture(scope="module")
def pair():
    jmodel = build_model(jax_smoke_config(ARCH))
    tree = numpy_params(jmodel, seed=13)
    model = Model(smoke_config(ARCH), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(tree))
    return jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_forward_grads_match_jax_vjp(pair, with_state):
    """jax.vjp of the reference's ``rwkv6_forward`` (chunked scan, token
    shift, ddlerp, LoRAs, decay clamp) against autograd of the port's: the
    input's, the start state's and every time-mix weight's gradient, u's
    included, with S = 37 past two 16-token chunks."""
    params, model = pair
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    p = model.blocks[0].tmix
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["tmix"])
    rng = np.random.default_rng(3 + with_state)
    B, S, d = 2, 37, cfg.d_model
    H, hd = p.u.shape
    x = (rng.normal(size=(B, S, d))).astype(np.float32)
    s0 = (0.3 * rng.normal(size=(B, H, hd, hd))).astype(np.float32)
    xp = rng.normal(size=(B, d)).astype(np.float32)
    dout = rng.normal(size=(B, S, d)).astype(np.float32)

    def jfwd(jp, x, s0, xp):
        state = {"s": s0, "x_prev": xp} if with_state else None
        return jssm.rwkv6_forward(jcfg, jp, x, state)[0]

    _, vjp = jax.vjp(jfwd, jp, jnp.asarray(x), jnp.asarray(s0), jnp.asarray(xp))
    jgp, jgx, jgs, jgxp = vjp(jnp.asarray(dout))

    names = [n for n, _ in p.named_parameters()]
    try:
        p.requires_grad_(True)
        tx, ts, txp = (torch.from_numpy(a).requires_grad_(True) for a in (x, s0, xp))
        state = {"s": ts, "x_prev": txp} if with_state else None
        out, _ = rwkv6_forward(cfg, p, tx, state)
        leaves = [tx, *p.parameters()] + ([ts, txp] if with_state else [])
        grads = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), leaves)
    finally:
        p.requires_grad_(False)
    assert rel_max(grads[0], jgx) <= JAX_TOL
    for name, g in zip(names, grads[1:]):
        assert rel_max(g, jgp[name]) <= JAX_TOL, name
    if with_state:
        assert rel_max(grads[-2], jgs) <= JAX_TOL
        assert rel_max(grads[-1], jgxp) <= JAX_TOL


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rwkv6_wkv_bwd_matches_plain(cuda_device, dtype):
    """The kernel against its plain version at chip_smoke.py phase 9e's
    tolerances (2e-5 f32, 3e-2 bf16, of the largest element), around the
    f32 kernel's 8-token interval and the bf16 kernel's 16-token sub-chunk,
    with and without the two end states, at steep decays; two calls bitwise
    equal."""
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for T, decay, ends in ((1, "gentle", "both"), (7, "steep", "none"), (8, "gentle", "state"),
                           (9, "steep", "ds"), (15, "steep", "ds"), (16, "gentle", "both"),
                           (17, "gentle", "state"), (32, "steep", "both"), (33, "gentle", "both"),
                           (40, "steep", "both")):
        with_state, with_ds = ENDS[ends]
        r, k, v, logw, u, state, dy, ds = (
            torch.from_numpy(x).to(cuda_device)
            for x in wkv_inputs(T, 2, 4, T, 64, decay))
        r, k, v = (x.to(dtype) for x in (r, k, v))
        args = (r, k, v, logw, u, state if with_state else None, dy, ds if with_ds else None)
        out = rwkv6_wkv_bwd(*args)
        again = rwkv6_wkv_bwd(*args)
        torch.cuda.synchronize()
        ref = rwkv6_wkv_bwd_plain(*args)
        for name, a, b, c in zip(NAMES, out, ref, again):
            if a is None:
                assert not with_state and name == "ds0"
                continue
            assert torch.equal(a, c), name
            assert rel_max(a.float().cpu(), b.float().cpu()) <= tol, (T, decay, ends, name)
