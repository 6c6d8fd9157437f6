"""The port's encoder-decoder (seamless-m4t-medium's family) against the JAX
package's.

At ``smoke_config`` size (2 encoder + 2 decoder layers, d 256, 4 heads of
64 over 2 KV heads, an 8-frame frontend of width 48, a 16-row cross cache),
in f32, on inputs drawn from a numpy seed:

- ``encode``, ``encode_cross_kv``, ``cross_attention`` (over several
  queries: ``flash_attention`` non-causal with S != L; and one:
  ``flash_decode`` over every encoder row), ``embed_inputs``' frontend,
  ``backbone`` and ``forward`` on a seeded frontend, ``lpt_loss`` and
  ``lpt_loss_chunked`` with the frontend in the batch, and
  ``activation_features`` (the reference's all-zero frontend);
- the prompt's loss and gradient of a ``PromptTuner.step`` and of a
  ``make_train_step`` with 2 microbatches (each splitting the frontend)
  against ``jax.value_and_grad`` of the reference's ``lpt_loss`` and its
  ``make_train_step`` (``lpt_loss_chunked``), the frontend in the batch:
  1e-5 on the loss, 1e-4 relative norm on the gradient;
- ``decode_step`` against the reference's ``decode_step`` on the same
  cache, with the cross cache left at zero as the reference leaves it and
  filled from ``encode`` + ``encode_cross_kv``; teacher-forced decode
  against the forward on a config whose cross cache has as many rows as
  the encoder's output (at smoke size 16 against 8, so 8 zero rows would
  stay live);
- ``flash_attention_plain`` non-causal with S != L against the reference's
  oracle and its Pallas kernel in interpret mode;
- the ``params_from_jax`` / ``params_to_jax`` round trip, the full config's
  segments and parameter count on the meta device, ``select_score``, and
  on the card (skipped elsewhere) the smoke model in f32 against the CPU.

The zero frontend feeds the encoder exactly 0, so that its attention and
the cross attention see degenerate inputs; every hold of them but
``activation_features`` runs on a frontend drawn from the seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TuneConfig as JTuneConfig
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.ref import flash_attention_ref
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import attention as jattn
from repro.models import build_model
from repro.models.common import unembed
from repro.train.objectives import lpt_loss as jax_lpt_loss
from repro.train.objectives import lpt_loss_chunked as jax_lpt_loss_chunked
from repro.tuning import PromptTuner as JPromptTuner
from repro.tuning import activation_features as jax_activation_features
from repro.tuning.soft_prompt import _probe_tokens
from repro_torch.config import TuneConfig
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import PromptBank, PromptEntry, ScoreContext, select_score
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import make_train_step
from repro_torch.models import (Model, opt_state_to_numpy, params_from_jax, params_to_jax,
                                prompt_from_arrays)
from repro_torch.models import transformer
from repro_torch.models.attention import cross_attention, encode_cross_kv
from repro_torch.models.convert import flatten_tree
from repro_torch.models.transformer import plan_segments
from repro_torch.train.objectives import lpt_loss, lpt_loss_chunked
from repro_torch.tuning import PromptTuner, activation_features

TOL = 1e-5        # f32, as tests/test_torch_model.py
ARCH = "seamless-m4t-medium"
V = 512           # smoke_config's vocabulary


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def encdec_numpy_params(jmodel, seed):
    """A parameter tree shaped like ``jmodel``'s, with numpy values: norms
    near 1, betas near 0, matrices at 1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        name, shape = jax.tree_util.keystr(path).split("'")[-2], leaf.shape
        if name == "gamma":
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "beta":
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "embedding":
            fan_in = shape[-1]
        elif name in ("wq", "wk", "wv"):
            fan_in = shape[-3]                       # (L, d, H, hd): contract d
        elif name == "wo":
            fan_in = shape[-3] * shape[-2]           # (L, H, hd, d): contract H*hd
        else:
            fan_in = shape[-2]
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, jmodel.abstract_params())


def equal_lengths(cfg):
    """The cut with a cross cache of as many rows as the encoder's output."""
    return cfg.with_overrides(encdec=dataclasses.replace(
        cfg.encdec, encoder_seq_len=cfg.frontend.num_embeddings))


_PAIRS = {}


def pair(equal=False):
    """(jax model, jax params, numpy tree, port model) with the same weights;
    ``equal``: the cut whose cross cache matches the encoder's length."""
    if equal not in _PAIRS:
        jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
        if equal:
            jcfg, cfg = equal_lengths(jcfg), equal_lengths(cfg)
        jmodel = build_model(jcfg)
        tree = encdec_numpy_params(jmodel, seed=11 + equal)
        model = Model(cfg, device="cpu", seed=None)
        model.load_state_dict(params_from_jax(tree))
        _PAIRS[equal] = (jmodel, jax.tree.map(jnp.asarray, tree), tree, model)
    return _PAIRS[equal]


def _frontend(seed, B=2, frames=8, width=48):
    return np.random.default_rng(seed).normal(size=(B, frames, width)).astype(np.float32)


def _tokens(seed, B=2, S=12):
    return np.random.default_rng(seed).integers(3, V, (B, S)).astype(np.int32)


def _layer(tree_part, i):
    return {k: jnp.asarray(v[i]) for k, v in tree_part.items()}


# -- the modules ----------------------------------------------------------------------

def test_segments_and_state_match_the_reference_tree():
    jmodel, _, tree, model = pair()
    assert [(s.name, s.count, s.kind) for s in model.segments] == \
        [(s.name, s.count, s.kind) for s in jmodel.segments] == [("decoder", 2, "decoder_cross")]
    assert set(model.state_dict()) == set(params_from_jax(tree))
    assert "encoder.blocks.1.attn.wq" in model.state_dict()
    assert model.frontend_proj.shape == (48, 256)


def test_encode_matches_jax():
    """The encoder on a seeded frontend: the projection in f32, the
    non-causal blocks with RoPE over frame positions, the final norm."""
    jmodel, params, _, model = pair()
    fe = _frontend(1)
    jout = jmodel.encode(params, jnp.asarray(fe))
    with torch.no_grad():
        out = model.encode(torch.from_numpy(fe))
    assert out.shape == (2, 8, 256)
    _close(out, jout)


def test_encode_needs_a_frontend():
    _, _, _, model = pair()
    with pytest.raises(ValueError, match="frontend"):
        model.encode(None)
    with pytest.raises(ValueError, match="frontend"):
        model(torch.from_numpy(_tokens(0)))


@pytest.mark.parametrize("layer", [0, 1])
def test_encode_cross_kv_matches_jax(layer):
    jmodel, params, tree, model = pair()
    enc = np.random.default_rng(layer).normal(size=(2, 8, 256)).astype(np.float32)
    jk, jv = jattn.encode_cross_kv(jmodel.cfg, _layer(tree["decoder"]["cross"], layer),
                                   jnp.asarray(enc))
    k, v = encode_cross_kv(model.cfg, model.decoder[layer].cross, torch.from_numpy(enc))
    assert k.shape == (2, 8, 2, 64)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("S", [1, 5, 13])
def test_cross_attention_matches_jax(S):
    """S queries against 8 encoder rows: S > 1 through flash_attention's
    plain version, non-causal, S != L; S = 1 through flash_decode's."""
    jmodel, _, tree, model = pair()
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 256)).astype(np.float32)
    enc = rng.normal(size=(2, 8, 256)).astype(np.float32)
    jp = _layer(tree["decoder"]["cross"], 1)
    jkv = jattn.encode_cross_kv(jmodel.cfg, jp, jnp.asarray(enc))
    jout = jattn.cross_attention(jmodel.cfg, jp, jnp.asarray(x), jkv)
    p = model.decoder[1].cross
    with torch.no_grad():
        out = cross_attention(model.cfg, p, torch.from_numpy(x),
                              encode_cross_kv(model.cfg, p, torch.from_numpy(enc)))
    assert out.shape == (2, S, 256)
    _close(out, jout)


def test_embed_inputs_prepends_the_projected_frontend():
    """[frontend][prompt][tokens], as the reference's embed_inputs orders
    them (the VLM path; an encoder-decoder sends its frontend to the
    encoder instead)."""
    jmodel, params, _, model = pair()
    fe, tokens = _frontend(2), _tokens(2, S=5)
    prompt = (np.random.default_rng(3).normal(size=(3, 256)) * 0.1).astype(np.float32)
    jx, jpos = jmodel.embed_inputs(params, jnp.asarray(tokens), jnp.asarray(prompt),
                                   jnp.asarray(fe))
    x, pos = model.embed_inputs(torch.from_numpy(tokens), torch.from_numpy(prompt),
                                torch.from_numpy(fe))
    assert x.shape == (2, 8 + 3 + 5, 256)
    _close(x, jx)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("with_prompt", [False, True])
def test_backbone_and_forward_match_jax(with_prompt):
    jmodel, params, _, model = pair()
    tokens, fe = _tokens(4), _frontend(4)
    prompt = (np.random.default_rng(5).normal(size=(4, 256)) * 0.1).astype(np.float32)
    jp = jnp.asarray(prompt) if with_prompt else None
    tp = torch.from_numpy(prompt) if with_prompt else None
    jh, _ = jmodel.backbone(params, jnp.asarray(tokens), prompt=jp, frontend=jnp.asarray(fe))
    jlogits = unembed(jmodel.cfg, params, jh)          # the reference's forward, from its backbone
    with torch.no_grad():
        h = model.backbone(torch.from_numpy(tokens), tp, torch.from_numpy(fe))
        logits = model(torch.from_numpy(tokens), tp, torch.from_numpy(fe))
    assert logits.shape == (2, 12 + 4 * with_prompt, V)
    _close(h, jh)
    _close(logits, jlogits)


def _batch(seed, S=12, B=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(3, V, (B, S)).astype(np.int32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32),
            "mask": (rng.random((B, S)) > 0.3).astype(np.float32),
            "frontend": _frontend(seed, B)}


@pytest.mark.parametrize("chunked", [False, True])
def test_lpt_loss_with_a_frontend_in_the_batch_matches_jax(chunked):
    """Eqn 1's loss of an audio model: the frontend rides in the batch."""
    jmodel, params, _, model = pair()
    b = _batch(6)
    prompt = (np.random.default_rng(7).normal(size=(4, 256)) * 0.1).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    if chunked:
        jtot, (jloss, jper) = jax_lpt_loss_chunked(jmodel, params, jnp.asarray(prompt), jb,
                                                   chunk=5)
        tot, (loss, per) = lpt_loss_chunked(model, torch.from_numpy(prompt), tb, chunk=5)
    else:
        jtot, (jloss, jper) = jax_lpt_loss(jmodel, params, jnp.asarray(prompt), jb, 4)
        tot, (loss, per) = lpt_loss(model, torch.from_numpy(prompt), tb)
    _close(loss, jloss)
    _close(tot, jtot)
    _close(per, jper)


def test_activation_features_match_jax_with_the_zero_frontend():
    jmodel, params, _, model = pair()
    prompts = (np.random.default_rng(8).normal(size=(3, 4, 256)) * 0.1).astype(np.float32)
    jfeat = np.asarray(jax_activation_features(jmodel, params, jnp.asarray(prompts)))
    feat = activation_features(model, prompts, probes=np.asarray(_probe_tokens(jmodel, 4, 9)))
    assert feat.shape == (3, 4 * 256)
    _close(feat, jfeat)


def test_select_score_is_the_two_layer_lookup():
    """select_score on an encoder-decoder: a ScoreContext whose eval batch
    carries a seeded frontend (the TaskLoader's batches carry none)."""
    _, _, _, model = pair()
    rng = np.random.default_rng(9)
    entries = [PromptEntry(prompt=(rng.normal(size=(4, 256)) * 0.1).astype(np.float32),
                           feature=rng.normal(size=8).astype(np.float32), origin=f"t{i}/v0")
               for i in range(6)]
    bank = PromptBank(capacity=16, num_clusters=2, seed=0)
    bank.add_candidates(entries)
    bank.build()
    batch = {k: torch.from_numpy(v) for k, v in _batch(10).items()}
    ctx = ScoreContext(PromptTuner(model, TuneConfig(prompt_len=4)), batch)
    res = select_score(bank, ctx)
    ref = bank.lookup(ctx)
    assert res.entry is ref.entry and res.score == ref.score
    assert np.isfinite(res.score)


# -- prompt tuning ----------------------------------------------------------------------

GRAD_TOL = 1e-4   # relative norm, as tests/test_torch_train.py


def _rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_prompt_tuner_step_with_a_frontend_matches_jax_value_and_grad():
    """A tuning step of an audio model: the encoder sees the batch's
    frontend and no prompt, the gradient reaches the prompt through the
    decoder's causal self attention and its non-causal cross attention."""
    jmodel, params, _, model = pair()
    cfg = dict(prompt_len=4, lr=0.1)
    jt, tt = JPromptTuner(jmodel, JTuneConfig(**cfg)), PromptTuner(model, TuneConfig(**cfg))
    pp = {"soft_prompt": (np.random.default_rng(12).normal(size=(4, 256)) * 0.1)
          .astype(np.float32)}
    b = _batch(13, S=9, B=3)
    (jtot, (jloss, _)), jgrads = jt._grad({"soft_prompt": jnp.asarray(pp["soft_prompt"])},
                                          params, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tot, loss, grads = tt.loss_and_grad(prompt_from_arrays(pp, "cpu"), tb)
    _close(loss, jloss)
    _close(tot, jtot)
    assert _rel_norm(grads["soft_prompt"].numpy(), jgrads["soft_prompt"]) <= GRAD_TOL
    new, _, step_loss = tt.step(prompt_from_arrays(pp, "cpu"),
                                tt.init_opt(prompt_from_arrays(pp, "cpu")), b)
    _close(step_loss, jloss)
    assert not np.allclose(new["soft_prompt"].detach().numpy(), pp["soft_prompt"])


def test_make_train_step_splits_the_frontend_into_microbatches_as_jax():
    """Two microbatches of 2 rows, each with its 2 rows of the frontend:
    the step's loss and the first Adam moment (0.1 x the gradient after one
    step) against the reference's scan over the same split."""
    jmodel, params, _, model = pair()
    cfg = dict(prompt_len=4, lr=0.1, weight_decay=0.01)
    jstep, jo = jax_make_train_step(jmodel, JTuneConfig(**cfg), microbatches=2, ce_chunk=5)
    tstep, to = make_train_step(model, TuneConfig(**cfg), microbatches=2, ce_chunk=5)
    sp = (np.random.default_rng(14).normal(size=(4, 256)) * 0.1).astype(np.float32)
    b = _batch(15, S=11, B=4)
    assert b["frontend"].shape[0] == 4
    jpp = {"soft_prompt": jnp.asarray(sp)}
    _, jstate, jloss = jstep(params, jpp, jo.init(jpp), {k: jnp.asarray(v) for k, v in b.items()})
    tpp = prompt_from_arrays({"soft_prompt": sp}, "cpu")
    _, tstate, loss = tstep(tpp, to.init(tpp), {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    mine = opt_state_to_numpy(tstate)
    assert mine["step"] == int(jstate.step) == 1
    for key in ("mu", "nu"):
        assert _rel_norm(mine[key]["soft_prompt"], getattr(jstate, key)["soft_prompt"]) \
            <= GRAD_TOL, key


# -- decode ----------------------------------------------------------------------------

def _fill_cross(jmodel, params, tree, frontend):
    """The cross cache made from ``encode`` + ``encode_cross_kv`` of the
    reference, layer by layer: {"k", "v"} (layers, B, F, Hkv, hd)."""
    enc = jmodel.encode(params, jnp.asarray(frontend))
    kv = [jattn.encode_cross_kv(jmodel.cfg, _layer(tree["decoder"]["cross"], i), enc)
          for i in range(jmodel.cfg.num_layers)]
    return {"k": np.stack([np.asarray(k) for k, _ in kv]),
            "v": np.stack([np.asarray(v) for _, v in kv])}


@pytest.mark.parametrize("cross", ["zero", "filled"])
def test_decode_step_and_its_cache_match_jax(cross):
    """Eight teacher-forced tokens into a 12-token cache against the
    reference's decode_step on the same cache: the cross cache left at zero
    as the reference leaves it, or filled from a 16-frame seeded frontend
    (all 16 rows of the smoke cut's cross cache). Every cache leaf after
    the last step; the cross cache comes back unchanged."""
    jmodel, params, tree, model = pair()
    B, S, length = 2, 8, 12
    tokens = _tokens(12, B, S)
    jstep = jax.jit(jmodel.decode_step)
    jcache, cache = jmodel.init_cache(B, length), model.init_cache(B, length)
    assert tuple(cache["cross_kv"]["k"].shape) == jcache["cross_kv"]["k"].shape == \
        (2, B, 16, 2, 64)
    if cross == "filled":
        filled = _fill_cross(jmodel, params, tree, _frontend(13, B, frames=16))
        jcache["cross_kv"] = {k: jnp.asarray(v) for k, v in filled.items()}
        for k, v in filled.items():
            cache["cross_kv"][k].copy_(torch.from_numpy(v))
    before = {k: v.clone() for k, v in cache["cross_kv"].items()}
    for t in range(S):
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t:t + 1]), jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        assert logits.shape == (B, 1, V) and logits.dtype == torch.float32
        _close(logits, jlogits)
    ours, ref = flatten_tree(cache), flatten_tree(jax.tree.map(np.asarray, jcache))
    assert sorted(ours) == sorted(ref)
    for path in sorted(ref):
        assert tuple(ours[path].shape) == ref[path].shape, path
        _close(ours[path], ref[path])
    for k, v in before.items():
        assert torch.equal(cache["cross_kv"][k], v)


def test_decode_matches_forward_when_the_cross_cache_is_the_encoders():
    """Teacher-forced decode against the port's own forward, on the cut
    whose cross cache has the encoder's 8 rows, filled by the port's own
    encode + encode_cross_kv: both are f32 sums of the same terms."""
    _, _, _, model = pair(equal=True)
    tokens, fe = torch.from_numpy(_tokens(14, 2, 10)), torch.from_numpy(_frontend(14))
    with torch.no_grad():
        full = model(tokens, None, fe)
        enc = model.encode(fe)
        cache = model.init_cache(2, 12)
        for i, block in enumerate(model.decoder):
            k, v = encode_cross_kv(model.cfg, block.cross, enc)
            cache["cross_kv"]["k"][i].copy_(k)
            cache["cross_kv"]["v"][i].copy_(v)
    dec = torch.cat([model.decode_step(cache, tokens[:, t:t + 1], t)[0]
                     for t in range(tokens.shape[1])], dim=1)
    _close(dec, full)


# -- the kernel's non-causal branch ---------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,S,L,hd,kv_len", [
    (2, 4, 2, 9, 16, 64, None),       # the smoke cut's cross attention: G = 2
    (1, 4, 4, 33, 80, 64, None),      # S = P + T against more encoder rows
    (1, 2, 2, 40, 24, 64, None),      # more queries than keys
    (1, 4, 2, 17, 48, 64, 30),        # and a short kv_len
])
def test_flash_attention_plain_non_causal_matches_pallas_and_ref(B, H, Hkv, S, L, hd, kv_len):
    rng = np.random.default_rng(B + H + S + L)
    q = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, L, hd)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, L, hd)).astype(np.float32)
    kw = dict(causal=False, kv_len=kv_len)
    ours = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), **kw)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(ours, flash_attention_ref(jq, jk, jv, **kw))
    _close(ours, jflash(jq, jk, jv, bq=8, bk=16, interpret=True, **kw))


# -- weights and the full config --------------------------------------------------------

def test_params_round_trip_an_encdec_tree():
    _, _, tree, model = pair()
    state = params_from_jax(tree)
    np.testing.assert_array_equal(state["encoder.blocks.1.attn.wq"].numpy(),
                                  tree["encoder"]["blocks"]["attn"]["wq"][1])
    np.testing.assert_array_equal(state["decoder.0.cross.wk"].numpy(),
                                  tree["decoder"]["cross"]["wk"][0])
    np.testing.assert_array_equal(state["encoder.final_norm.gamma"].numpy(),
                                  tree["encoder"]["final_norm"]["gamma"])
    np.testing.assert_array_equal(state["frontend_proj"].numpy(), tree["frontend_proj"])
    back = flatten_tree(params_to_jax(model.state_dict()))
    ref = flatten_tree(tree)
    assert sorted(back) == sorted(ref)
    for path in ref:
        np.testing.assert_array_equal(back[path], ref[path])


def test_full_config_builds_the_reference_tree(monkeypatch):
    """seamless-m4t-medium at full width and depth on the meta device: 12 +
    12 layers, the reference's parameter count (about 0.62 B, tied)."""
    cfg = get_config(ARCH)
    assert [(s.name, s.count) for s in plan_segments(cfg)] == \
        [(s.name, s.count) for s in build_model(jax_get_config(ARCH)).segments] == \
        [("decoder", 12)]
    monkeypatch.setattr(transformer, "resolve_device", lambda device: torch.device("meta"))
    model = Model(cfg, seed=None)
    assert len(model.encoder.blocks) == 12
    assert model.decoder[11].cross.wq.shape == (1024, 16, 64)
    assert model.frontend_proj.shape == (1024, 1024)
    n = sum(p.numel() for p in model.parameters())
    ref = sum(int(np.prod(a.shape)) for a in
              jax.tree.leaves(build_model(jax_get_config(ARCH)).abstract_params())
              )
    assert n == ref
    assert 0.6e9 < n < 0.65e9


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_encdec_matches_cpu(cuda_device):
    """The smoke cut in f32 on the card (flash_attention non-causal,
    flash_decode over the cross rows) against the CPU: forward and decode."""
    _, _, _, cpu = pair(equal=True)
    card = Model(cpu.cfg, device=cuda_device, seed=None)
    card.load_state_dict(cpu.state_dict())
    tokens, fe = torch.from_numpy(_tokens(15)), torch.from_numpy(_frontend(15))
    with torch.no_grad():
        _close(card(tokens.to(cuda_device), None, fe.to(cuda_device)).cpu(),
               cpu(tokens, None, fe), 1e-4)
    caches = [m.init_cache(2, 4) for m in (cpu, card)]
    for t in range(3):
        ref, _ = cpu.decode_step(caches[0], tokens[:, t:t + 1], t)
        out, _ = card.decode_step(caches[1], tokens[:, t:t + 1].to(cuda_device), t)
        _close(out.cpu(), ref, 1e-4)
