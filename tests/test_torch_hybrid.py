"""The port's Mamba2 mixer and Zamba2 hybrid against the JAX package's.

- ``_causal_conv``, ``mamba2_forward`` and ``mamba2_decode`` against the
  reference's ``models/ssm.py`` (chunk 16: lengths under, at, one past and
  a padded last chunk; from a zero and from a given state);
- the smoke hybrid (``smoke_config("zamba2-7b")``: 5 Mamba2 layers in three
  segments, the shared attention block applied twice): ``backbone`` and
  ``forward`` with and without a prompt, ``decode_step`` with its cache
  compared leaf by leaf (``shared_attn/app<i>`` included), decode against
  forward, the same at head dim 112, the ``params_from_jax`` /
  ``params_to_jax`` round trip, and ``PromptTuner``'s loss and prompt
  gradient against ``jax.value_and_grad`` of the reference's ``lpt_loss``;
- zamba2-7b's full configuration: its 14 segments and shared block, and its
  parameter count, built on the meta device.

Weights are made with numpy in the reference tree's shapes and handed to
both packages: matrices at 1/sqrt(fan_in), norms and ``d_skip`` near 1,
``a_log`` in [-4, -1] and a conv larger than the reference's 0.02, so that
every term of the scan and the conv is exercised.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TuneConfig as JTuneConfig
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model
from repro.models import ssm as jssm
from repro.tuning import PromptTuner as JPromptTuner
from repro_torch.config import TuneConfig
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import Model, params_from_jax, params_to_jax
from repro_torch.models import transformer
from repro_torch.models.convert import flatten_tree, prompt_from_arrays
from repro_torch.models.ssm import (Mamba2Mixer, _causal_conv, mamba2_decode, mamba2_dims,
                                    mamba2_forward)
from repro_torch.models.transformer import plan_segments
from repro_torch.tuning import PromptTuner

TOL = 1e-5        # f32, as tests/test_torch_model.py
# Whole-model hidden states and logits: seven blocks (five Mamba2 layers, two
# shared-attention applications with their MLP) of f32 sums that XLA and
# PyTorch order differently. Measured: at most 1.25e-5 on values up to 4.6
# (3e-6 of the largest), so one element of 8192 near 0.2 lands just past
# 1e-5 + 1e-5·|ref|.
MODEL_TOL = 2e-5
GRAD_TOL = 1e-4   # relative norm of the prompt gradient, as tests/test_torch_train.py
ARCH = "zamba2-7b"


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def hybrid_numpy_params(jmodel, seed):
    """A parameter tree shaped like ``jmodel``'s, with numpy values."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        leaf_name, shape = jax.tree_util.keystr(path).split("'")[-2], leaf.shape
        if leaf_name in ("gamma", "d_skip", "norm_g"):
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if leaf_name in ("dt_bias", "conv_b"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if leaf_name == "a_log":
            return rng.uniform(-4.0, -1.0, size=shape).astype(np.float32)
        if leaf_name == "conv_w":
            return (0.3 * rng.normal(size=shape)).astype(np.float32)
        if leaf_name == "embedding":
            fan_in = shape[-1]
        elif leaf_name in ("wq", "wk", "wv"):
            fan_in = shape[-3]                       # (d, H, hd): contract d
        elif leaf_name == "wo":
            fan_in = shape[-3] * shape[-2]           # (H, hd, d): contract H*hd
        else:
            fan_in = shape[-2]
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, jmodel.abstract_params())


_PAIRS = {}


def pair(head_dim=None):
    """(jax model, jax params, numpy tree, port model) with the same weights."""
    if head_dim not in _PAIRS:
        jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
        if head_dim:
            jcfg, cfg = (c.with_overrides(head_dim=head_dim) for c in (jcfg, cfg))
        jmodel = build_model(jcfg)
        tree = hybrid_numpy_params(jmodel, seed=head_dim or 5)
        model = Model(cfg, device="cpu", seed=None)
        model.load_state_dict(params_from_jax(tree))
        _PAIRS[head_dim] = (jmodel, jax.tree.map(jnp.asarray, tree), tree, model)
    return _PAIRS[head_dim]


def mixer_pair(layer=1):
    """The reference's parameter dict and the port's ``Mamba2Mixer`` of
    layer ``layer`` of segment ``mamba0``."""
    jmodel, _, tree, model = pair()
    jp = {k: jnp.asarray(v[layer]) for k, v in tree["mamba0"]["mixer"].items()}
    return jmodel.cfg, jp, model.mamba0[layer].mixer


def _state(cfg, B, rng):
    ds = cfg.ssm.state_size
    d_inner, H, hd = mamba2_dims(cfg)
    return {"h": (0.5 * rng.normal(size=(B, H, ds, hd))).astype(np.float32),
            "conv": (0.5 * rng.normal(size=(B, cfg.ssm.conv_width - 1, d_inner + 2 * ds))
                     ).astype(np.float32)}


# -- the mixer ----------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(S, with_state):
    """Output and tail, S shorter and longer than the conv's 3-token tail."""
    rng = np.random.default_rng(S + 2 * with_state)
    B, C, W = 2, 24, 4
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    w = rng.normal(size=(W, C)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    init = rng.normal(size=(B, W - 1, C)).astype(np.float32) if with_state else None
    jout, jtail = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    None if init is None else jnp.asarray(init))
    out, tail = _causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                             None if init is None else torch.from_numpy(init))
    _close(out, jout)
    _close(tail, jtail)
    assert tail.shape == (B, W - 1, C)


@pytest.mark.parametrize("S", [1, 15, 16, 17, 40])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_jax(S, with_state):
    """Chunk 16: S under, at and one past a chunk, and 40 (a padded last
    chunk); the output, the final state and the conv tail."""
    jcfg, jp, mixer = mixer_pair()
    rng = np.random.default_rng(100 + S)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    st = _state(jcfg, 2, rng) if with_state else None
    jy, jst = jssm.mamba2_forward(jcfg, jp, jnp.asarray(x),
                                  None if st is None else jax.tree.map(jnp.asarray, st))
    with torch.no_grad():
        y, tst = mamba2_forward(smoke_config(ARCH), mixer, torch.from_numpy(x),
                                None if st is None else
                                {k: torch.from_numpy(v) for k, v in st.items()})
    _close(y, jy)
    _close(tst["h"], jst["h"])
    _close(tst["conv"], jst["conv"])


def test_mamba2_decode_steps_match_jax():
    jcfg, jp, mixer = mixer_pair()
    rng = np.random.default_rng(7)
    st = _state(jcfg, 3, rng)
    jst, tst = jax.tree.map(jnp.asarray, st), {k: torch.from_numpy(v) for k, v in st.items()}
    for t in range(6):
        x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jssm.mamba2_decode(jcfg, jp, jnp.asarray(x), jst)
        with torch.no_grad():
            y, tst = mamba2_decode(smoke_config(ARCH), mixer, torch.from_numpy(x), tst)
        _close(y, jy)
        for k in ("h", "conv"):
            _close(tst[k], jst[k])


def test_mamba2_forward_equals_its_decode_steps():
    """A sequence in one forward and token by token end in the same state."""
    _, _, mixer = mixer_pair()
    cfg = smoke_config(ARCH)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 21, cfg.d_model))
                         .astype(np.float32))
    with torch.no_grad():
        y, st = mamba2_forward(cfg, mixer, x)
        dst = {k: torch.zeros_like(v) for k, v in st.items()}
        ys = []
        for t in range(x.shape[1]):
            yt, dst = mamba2_decode(cfg, mixer, x[:, t:t + 1], dst)
            ys.append(yt)
    _close(torch.cat(ys, dim=1), y, 1e-4)
    _close(dst["h"], st["h"], 1e-4)
    _close(dst["conv"], st["conv"])


# -- the hybrid model ---------------------------------------------------------------

def _tokens(seed, B=2, S=12, V=512):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def test_smoke_hybrid_segments_follow_the_reference():
    jmodel, _, tree, model = pair()
    assert [(s.name, s.count, s.kind) for s in model.segments] == \
        [(s.name, s.count, s.kind) for s in jmodel.segments] == \
        [("mamba0", 2, "mamba"), ("mamba1", 2, "mamba"), ("mamba2", 1, "mamba")]
    assert isinstance(model.mamba0[0].mixer, Mamba2Mixer)
    assert set(model.state_dict()) == set(params_from_jax(tree))
    assert model.mamba0[0].mixer.a_log.dtype == torch.float32


@pytest.mark.parametrize("head_dim", [None, 112])
@pytest.mark.parametrize("with_prompt", [False, True])
def test_backbone_and_forward_match_jax(head_dim, with_prompt):
    """The smoke hybrid, and the same cut at head dim 112 (zamba2-7b's)."""
    jmodel, params, _, model = pair(head_dim)
    tokens = _tokens(1)
    prompt = (np.random.default_rng(2).normal(size=(4, model.cfg.d_model)) * 0.1
              ).astype(np.float32)
    jp = jnp.asarray(prompt) if with_prompt else None
    tp = torch.from_numpy(prompt) if with_prompt else None
    jh, _ = jmodel.backbone(params, jnp.asarray(tokens), prompt=jp)
    jlogits, _ = jmodel.forward(params, jnp.asarray(tokens), prompt=jp)
    with torch.no_grad():
        h = model.backbone(torch.from_numpy(tokens), tp)
        logits = model(torch.from_numpy(tokens), tp)
    assert logits.shape == (2, 12 + 4 * with_prompt, 512)
    _close(h, jh, MODEL_TOL)
    _close(logits, jlogits, MODEL_TOL)


@pytest.mark.parametrize("head_dim", [None, 112])
def test_decode_step_and_its_cache_match_jax(head_dim):
    """Eight teacher-forced tokens into a 12-token cache; every cache leaf,
    the Mamba2 states and each shared-attention application's K/V, after
    the last step."""
    jmodel, params, _, model = pair(head_dim)
    B, S, length = 2, 8, 12
    tokens = _tokens(3, B, S)
    jstep = jax.jit(jmodel.decode_step)
    jcache, cache = jmodel.init_cache(B, length), model.init_cache(B, length)
    assert sorted(cache["shared_attn"]) == ["app0", "app1"]
    for t in range(S):
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        assert logits.shape == (B, 1, 512) and logits.dtype == torch.float32
        _close(logits, jlogits, MODEL_TOL)
    ours, ref = flatten_tree(cache), flatten_tree(jax.tree.map(np.asarray, jcache))
    assert sorted(ours) == sorted(ref)
    assert "shared_attn/app1/kv/k" in ours and "mamba2/state/h" in ours
    for path in sorted(ref):
        assert tuple(ours[path].shape) == ref[path].shape, path
        _close(ours[path], ref[path])


def test_decode_matches_forward():
    """Teacher-forced decode against the port's own forward, as the
    reference's test_hybrid_decode_matches_forward does (its tolerance is
    5e-3 for the reference's own init; both here are f32 sums of the same
    terms in another order)."""
    _, _, _, model = pair()
    tokens = torch.from_numpy(_tokens(4, 1, 10))
    with torch.no_grad():
        full = model(tokens)
    cache = model.init_cache(1, 12)
    dec = torch.cat([model.decode_step(cache, tokens[:, t:t + 1], t)[0]
                     for t in range(tokens.shape[1])], dim=1)
    _close(dec, full, 1e-4)


def test_params_round_trip_a_hybrid_tree():
    _, _, tree, model = pair()
    state = params_from_jax(tree)
    np.testing.assert_array_equal(state["mamba0.1.mixer.in_z"].numpy(),
                                  tree["mamba0"]["mixer"]["in_z"][1])
    np.testing.assert_array_equal(state["mamba2.0.mixer.a_log"].numpy(),
                                  tree["mamba2"]["mixer"]["a_log"][0])
    np.testing.assert_array_equal(state["shared_attn.attn.wq"].numpy(),
                                  tree["shared_attn"]["attn"]["wq"])
    back = flatten_tree(params_to_jax(model.state_dict()))
    ref = flatten_tree(tree)
    assert sorted(back) == sorted(ref)
    for path in ref:
        np.testing.assert_array_equal(back[path], ref[path])


def test_prompt_tuner_loss_and_gradient_match_jax_value_and_grad():
    """One tuning step's loss and prompt gradient through the Mamba2 and
    shared-attention blocks, against ``jax.value_and_grad``."""
    jmodel, params, _, model = pair()
    kw = dict(prompt_len=4, algorithm="soft_prompt")
    jt, tt = JPromptTuner(jmodel, JTuneConfig(**kw)), PromptTuner(model, TuneConfig(**kw))
    pp = jt.init_prompt(params, jax.random.key(1))
    rng = np.random.default_rng(6)
    b = {"tokens": rng.integers(3, 512, (2, 12)).astype(np.int32),
         "labels": rng.integers(0, 512, (2, 12)).astype(np.int32),
         "mask": (rng.random((2, 12)) > 0.3).astype(np.float32)}
    (jtot, (jloss, _)), jgrads = jt._grad(pp, params, {k: jnp.asarray(v) for k, v in b.items()})
    tot, loss, grads = tt.loss_and_grad(prompt_from_arrays(pp, "cpu"),
                                        {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert abs(float(tot) - float(jtot)) <= TOL * abs(float(jtot))
    assert set(grads) == set(jgrads)
    for k in grads:
        g, jg = grads[k].numpy(), np.asarray(jgrads[k])
        assert np.linalg.norm(g - jg) <= GRAD_TOL * np.linalg.norm(jg), k


def test_full_config_builds_the_reference_segments(monkeypatch):
    """zamba2-7b at full width and depth: 81 layers in 14 segments (13 of 6
    and one of 3) and the shared block, with the reference's parameter
    count, built on the meta device (no memory)."""
    cfg = get_config(ARCH)
    segs = plan_segments(cfg)
    jsegs = build_model(jax_get_config(ARCH)).segments
    assert [(s.name, s.count) for s in segs] == [(s.name, s.count) for s in jsegs]
    assert [s.name for s in segs] == [f"mamba{g}" for g in range(14)]
    assert [s.count for s in segs] == [6] * 13 + [3]
    monkeypatch.setattr(transformer, "resolve_device", lambda device: torch.device("meta"))
    model = Model(cfg, seed=None)
    assert model.shared_attn.attn.wq.shape == (3584, 32, 112)
    assert model.mamba13[2].mixer.in_z.shape == (3584, 7168)
    n = sum(p.numel() for p in model.parameters())
    ref = sum(int(np.prod(a.shape)) for a in
              jax.tree.leaves(build_model(jax_get_config(ARCH)).abstract_params()))
    assert n == ref
    assert 6.6e9 < n < 6.7e9
