"""The port's VLM (paligemma-3b's family) against the JAX package's.

At ``smoke_config`` size (2 layers, d 256, 4 query heads over one KV head,
head dim 64, GELU, RMSNorm, tied embeddings, a vision frontend of 8
patches of width 48), in f32, with the reference's weights carried across
by ``params_from_jax`` and inputs drawn from a numpy seed:

- the segments and the state's names; ``Model.forward`` and ``backbone``
  with a seeded frontend and a prompt ([frontend][prompt][tokens]);
- ``lpt_loss`` and ``lpt_loss_chunked`` with ``batch["frontend"]``;
- ``activation_features`` (the reference's all-zero frontend);
- teacher-forced ``decode_step`` with every cache leaf, and
  ``make_serve_step``'s next tokens (the reference's decode embeds tokens
  only: text after the image is served from a text cache);
- a ``select_score`` lookup on a small bank whose evaluations carry the
  frontend: the same origin and score;
- the full config's segments and parameter count on the meta device, and
  on the card (skipped elsewhere) the smoke model in f32 against the CPU.

The kernels at paligemma-3b's head dim 256 are held in
tests/test_torch_kernels.py (``FLASH_CASES``, ``fa_pv_mirror``) and
tests/test_torch_decode.py (``DECODE_CASES``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TuneConfig as JTuneConfig
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.bank_builder import ScoreContext as JScoreContext
from repro.core.bank_builder import select_score as jax_select_score
from repro.core.prompt_bank import PromptBank as JPromptBank
from repro.core.prompt_bank import PromptEntry as JPromptEntry
from repro.launch.steps import make_serve_step as jax_make_serve_step
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
from repro_torch.launch import make_serve_step
from repro_torch.models import Model, params_from_jax
from repro_torch.models import transformer
from repro_torch.models.convert import flatten_tree
from repro_torch.models.transformer import plan_segments
from repro_torch.train.objectives import lpt_loss, lpt_loss_chunked
from repro_torch.tuning import PromptTuner, activation_features
from test_torch_model import numpy_params

TOL = 1e-5        # f32, as tests/test_torch_model.py
ARCH = "paligemma-3b"
V = 512           # smoke_config's vocabulary
D = 256           # smoke_config's width

_PAIR = {}


def pair():
    """(jax model, jax params, port model) with the same weights."""
    if not _PAIR:
        jmodel = build_model(jax_smoke_config(ARCH))
        tree = numpy_params(jmodel, seed=31)
        model = Model(smoke_config(ARCH), device="cpu", seed=None)
        model.load_state_dict(params_from_jax(tree))
        _PAIR["pair"] = (jmodel, jax.tree.map(jnp.asarray, tree), model)
    return _PAIR["pair"]


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _frontend(seed, B=2, patches=8, width=48):
    return np.random.default_rng(seed).normal(size=(B, patches, width)).astype(np.float32)


def _tokens(seed, B=2, S=12):
    return np.random.default_rng(seed).integers(3, V, (B, S)).astype(np.int32)


def _prompt(seed, P=4):
    return (np.random.default_rng(seed).normal(size=(P, D)) * 0.1).astype(np.float32)


def _batch(seed, S=12, B=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(3, V, (B, S)).astype(np.int32),
            "labels": rng.integers(0, V, (B, S)).astype(np.int32),
            "mask": (rng.random((B, S)) > 0.3).astype(np.float32),
            "frontend": _frontend(seed, B)}


def test_segments_and_state_match_the_reference_tree():
    jmodel, _, model = pair()
    assert [(s.name, s.count, s.kind) for s in model.segments] == \
        [(s.name, s.count, s.kind) for s in jmodel.segments] == [("blocks", 2, "dense")]
    assert model.cfg.kv_heads() == 1 and model.cfg.activation == "gelu"
    assert model.frontend_proj.shape == (48, D) and model.unembed is None
    assert set(model.state_dict()) == set(params_from_jax(numpy_params(jmodel, seed=31)))


@pytest.mark.parametrize("with_prompt", [False, True])
def test_forward_with_a_frontend_matches_jax(with_prompt):
    """[frontend][prompt][tokens]: the patches projected in f32, prepended
    with the prompt to the token embeddings, causal attention over all of
    them; the logits of every position."""
    jmodel, params, model = pair()
    tokens, fe, prompt = _tokens(1), _frontend(1), _prompt(2)
    jp = jnp.asarray(prompt) if with_prompt else None
    tp = torch.from_numpy(prompt) if with_prompt else None
    jh, _ = jmodel.backbone(params, jnp.asarray(tokens), prompt=jp, frontend=jnp.asarray(fe))
    jlogits, _ = jmodel.forward(params, jnp.asarray(tokens), prompt=jp,
                                frontend=jnp.asarray(fe))
    with torch.no_grad():
        h = model.backbone(torch.from_numpy(tokens), tp, torch.from_numpy(fe))
        logits = model(torch.from_numpy(tokens), tp, torch.from_numpy(fe))
    assert logits.shape == (2, 8 + 4 * with_prompt + 12, V)
    _close(h, jh)
    _close(logits, jlogits)
    _close(logits, unembed(jmodel.cfg, params, jh))


@pytest.mark.parametrize("chunked", [False, True])
def test_lpt_loss_with_a_frontend_in_the_batch_matches_jax(chunked):
    """Eqn 1's loss of a VLM: the frontend rides in the batch, and the loss
    reads the token region after the image and the prompt."""
    jmodel, params, model = pair()
    b, prompt = _batch(3), _prompt(4)
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
    jmodel, params, model = pair()
    prompts = (np.random.default_rng(5).normal(size=(3, 4, D)) * 0.1).astype(np.float32)
    jfeat = np.asarray(jax_activation_features(jmodel, params, jnp.asarray(prompts)))
    feat = activation_features(model, prompts, probes=np.asarray(_probe_tokens(jmodel, 4, 9)))
    assert feat.shape == (3, 4 * D)
    _close(feat, jfeat)


def test_decode_step_and_its_cache_match_jax():
    """Eight teacher-forced tokens into a 12-token cache against the
    reference's decode_step; every cache leaf after the last step."""
    jmodel, params, model = pair()
    B, S, length = 2, 8, 12
    tokens = _tokens(6, B, S)
    jstep = jax.jit(jmodel.decode_step)
    jcache, cache = jmodel.init_cache(B, length), model.init_cache(B, length)
    assert tuple(cache["blocks"]["kv"]["k"].shape) == jcache["blocks"]["kv"]["k"].shape == \
        (2, B, length, 1, 64)
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


def test_serve_step_tokens_match_jax():
    jmodel, params, model = pair()
    B = 3
    jserve, serve = jax.jit(jax_make_serve_step(jmodel)), make_serve_step(model)
    jcache, cache = jmodel.init_cache(B, 10), model.init_cache(B, 10)
    tok = _tokens(7, B, 1)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for t in range(6):
        jtok, jcache = jserve(params, jcache, jtok, jnp.int32(t))
        ttok, cache = serve(cache, ttok, t)
        assert ttok.dtype == torch.int32 and ttok.shape == (B, 1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_select_score_lookup_matches_jax():
    """The two-layer lookup on a bank of 6 candidates in 2 clusters, the
    same prompts and features in both packages, each evaluation's batch
    carrying a seeded frontend: the same entry, the same score."""
    jmodel, params, model = pair()
    rng = np.random.default_rng(8)
    cands = [((rng.normal(size=(4, D)) * 0.1).astype(np.float32),
              rng.normal(size=8).astype(np.float32), f"t{i}/v0") for i in range(6)]
    banks = []
    for bank_cls, entry_cls in ((JPromptBank, JPromptEntry), (PromptBank, PromptEntry)):
        bank = bank_cls(capacity=16, num_clusters=2, seed=0)
        bank.add_candidates([entry_cls(prompt=p, feature=f, origin=o) for p, f, o in cands])
        bank.build()
        banks.append(bank)
    b = _batch(9)
    jres = jax_select_score(banks[0], JScoreContext(
        JPromptTuner(jmodel, JTuneConfig(prompt_len=4)), params,
        {k: jnp.asarray(v) for k, v in b.items()}))
    res = select_score(banks[1], ScoreContext(PromptTuner(model, TuneConfig(prompt_len=4)),
                                              {k: torch.from_numpy(v) for k, v in b.items()}))
    assert res.entry.origin == jres.entry.origin
    assert res.evaluations == jres.evaluations
    np.testing.assert_allclose(res.score, jres.score, rtol=TOL)


def test_full_config_builds_the_reference_tree(monkeypatch):
    """paligemma-3b at full width and depth on the meta device: 18 layers
    of 8 heads of 256 over one KV head, the reference's parameter count
    (about 1.91 B, tied)."""
    cfg = get_config(ARCH)
    jcfg = jax_get_config(ARCH)
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "norm", "activation", "tie_embeddings", "arch_type"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert (cfg.frontend.num_embeddings, cfg.frontend.embed_dim) == (256, 1152)
    assert [(s.name, s.count, s.kind) for s in plan_segments(cfg)] == \
        [(s.name, s.count, s.kind) for s in build_model(jcfg).segments] == \
        [("blocks", 18, "dense")]
    monkeypatch.setattr(transformer, "resolve_device", lambda device: torch.device("meta"))
    model = Model(cfg, seed=None)
    assert model.blocks[17].attn.wq.shape == (2048, 8, 256)
    assert model.frontend_proj.shape == (1152, 2048)
    n = sum(p.numel() for p in model.parameters())
    ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(build_model(jcfg).abstract_params()))
    assert n == ref
    assert 1.90e9 < n < 1.91e9


# -- on the card ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_vlm_matches_cpu(cuda_device):
    """The smoke model in f32 on the card (flash_attention, flash_decode)
    against the CPU: the forward with a frontend and decode steps."""
    _, _, cpu = pair()
    card = Model(cpu.cfg, device=cuda_device, seed=None)
    card.load_state_dict(cpu.state_dict())
    tokens, fe = torch.from_numpy(_tokens(10)), torch.from_numpy(_frontend(10))
    with torch.no_grad():
        _close(card(tokens.to(cuda_device), None, fe.to(cuda_device)).cpu(),
               cpu(tokens, None, fe), 1e-4)
    caches = [m.init_cache(2, 4) for m in (cpu, card)]
    for t in range(3):
        ref, _ = cpu.decode_step(caches[0], tokens[:, t:t + 1], t)
        out, _ = card.decode_step(caches[1], tokens[:, t:t + 1].to(cuda_device), t)
        _close(out.cpu(), ref, 1e-4)
