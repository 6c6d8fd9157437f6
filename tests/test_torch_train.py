"""The port's prompt-tuning path against the JAX package's, on smoke cuts.

The same numpy weights, batches and initial prompts go to both packages
(the reference's ``jax.random`` prompts are handed to the port as arrays):
the Adam and SGD updates, the loss and prompt gradient of one
``PromptTuner`` step (``jax.value_and_grad`` of the reference's
``lpt_loss``), ten Adam steps, ``tune`` to a fixed target, the chunked loss
and ``make_train_step`` with microbatches. Tolerances in f32: 1e-5 relative
on losses, 1e-4 relative norm on gradients and on prompts after steps (Adam
divides each gradient element by its own running scale, so rounding in a
small element moves its update by a larger share).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import numpy_params
from test_torch_rwkv import numpy_params as rwkv_numpy_params

from repro.config import TuneConfig as JTuneConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.core import bank_builder as jbank
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model
from repro.train import optimizer as jopt
from repro.train.objectives import lpt_loss_chunked as jax_lpt_loss_chunked
from repro.tuning import PromptTuner as JPromptTuner
from repro_torch.config import TuneConfig
from repro_torch.configs import smoke_config
from repro_torch.core import bank_builder as tbank
from repro_torch.launch import make_prefill_step, make_train_step
from repro_torch.models import (Model, opt_state_from_jax, opt_state_to_numpy, params_from_jax,
                                prompt_from_arrays)
from repro_torch.train import lpt_loss, lpt_loss_chunked, optimizer as topt
from repro_torch.tuning import PromptTuner, init_prompt_from_tokens, init_prompt_random

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
P = 4


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- the optimizer ---------------------------------------------------------------

OPTIMIZERS = {  # name -> the optimizer, made from either package's optimizer module
    "adam": lambda m: m.adam(0.3),
    "adam_weight_decay": lambda m: m.adam(0.1, weight_decay=0.05),
    "adamw": lambda m: m.make_optimizer("adamw", 0.01),
    "adam_cosine": lambda m: m.adam(m.cosine_schedule(0.2, warmup=2, total=6)),
    "sgd": lambda m: m.make_optimizer("sgd", 0.5),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    """Four updates on a random tree (an f32 and a bf16 leaf) from the same
    gradients: the same updates, moments and step."""
    make = OPTIMIZERS[name]
    rng = np.random.default_rng(len(name))
    params = {"a": rng.normal(size=(4, 8)).astype(np.float32),
              "b": rng.normal(size=(8, 3)).astype(np.float32)}
    jparams = {"a": jnp.asarray(params["a"]), "b": jnp.asarray(params["b"], jnp.bfloat16)}
    tparams = {"a": torch.from_numpy(params["a"]),
               "b": torch.from_numpy(params["b"]).bfloat16()}
    jo, to = make(jopt), make(topt)
    jstate, tstate = jo.init(jparams), to.init(tparams)
    for _ in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) * 0.1 for k, v in params.items()}
        jupd, jstate = jo.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        tupd, tstate = to.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate,
                                 tparams)
        for k in params:
            assert tupd[k].dtype == tparams[k].dtype
            np.testing.assert_allclose(tupd[k].float().numpy(),
                                       np.asarray(jupd[k], np.float32), rtol=1e-5, atol=1e-6)
        jparams = jopt.apply_updates(jparams, jupd)
        tparams = topt.apply_updates(tparams, tupd)
    mine = opt_state_to_numpy(tstate)
    assert mine["step"] == int(jstate.step) == 4
    for key in ("mu", "nu"):
        ref = getattr(jstate, key)
        assert (mine[key] is None) == (ref is None)
        for k in (ref or {}):
            np.testing.assert_allclose(mine[key][k], np.asarray(ref[k]), rtol=1e-5, atol=1e-7)


def test_cosine_schedule_matches_jax():
    jfn, tfn = jopt.cosine_schedule(0.3, 3, 11), topt.cosine_schedule(0.3, 3, 11)
    for step in range(15):
        np.testing.assert_allclose(float(tfn(torch.tensor(step, dtype=torch.int32))),
                                   float(jfn(jnp.asarray(step, jnp.int32))), rtol=1e-6)


def test_apply_updates_keeps_prompt_leaves():
    p = {"soft_prompt": torch.zeros(2, 3, requires_grad=True)}
    new = topt.apply_updates(p, {"soft_prompt": torch.ones(2, 3)})
    assert new["soft_prompt"].requires_grad and new["soft_prompt"].grad_fn is None
    assert (new["soft_prompt"] == 1).all()


# -- models with the same weights ------------------------------------------------

ARCHS = {  # case -> (arch, algorithm)
    "gpt2-base": ("gpt2-base", "soft_prompt"),
    "qwen2-7b": ("qwen2-7b", "soft_prompt"),        # GQA groups, qkv_bias, untied
    "gpt2-base-prefix": ("gpt2-base", "prefix"),
    "deepseek-v2-236b": ("deepseek-v2-236b", "soft_prompt"),   # MLA, MoE aux loss
    "rwkv6-7b": ("rwkv6-7b", "soft_prompt"),        # WKV through RWKV6WKV's backward
}
_PAIRS = {}


def pair(arch):
    """(jax model, jax params, port model) with the same numpy weights."""
    if arch not in _PAIRS:
        jmodel = build_model(jax_smoke_config(arch))
        tree = (rwkv_numpy_params if arch == "rwkv6-7b" else numpy_params)(jmodel, seed=7)
        model = Model(smoke_config(arch), device="cpu")
        model.load_state_dict(params_from_jax(tree))
        _PAIRS[arch] = (jmodel, jax.tree.map(jnp.asarray, tree), model)
    return _PAIRS[arch]


def tuners(case, **tune_kw):
    arch, algorithm = ARCHS[case]
    jmodel, params, model = pair(arch)
    kw = dict(prompt_len=P, algorithm=algorithm, **tune_kw)
    jt = JPromptTuner(jmodel, JTuneConfig(**kw))
    return jt, params, PromptTuner(model, TuneConfig(**kw)), model


def batches(n, seed, B=2, S=12, V=512):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(3, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) > 0.3).astype(np.float32)} for _ in range(n)]


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_step_loss_and_grad_match_jax_value_and_grad(case):
    jt, params, tt, _ = tuners(case)
    pp = jt.init_prompt(params, jax.random.key(1))
    b = batches(1, 3)[0]
    (jtot, (jloss, _)), jgrads = jt._grad(pp, params, jbatch(b))
    tot, loss, grads = tt.loss_and_grad(prompt_from_arrays(pp, "cpu"), tbatch(b))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert abs(float(tot) - float(jtot)) <= LOSS_TOL * abs(float(jtot))
    if case == "deepseek-v2-236b":
        assert float(tot) > float(loss)                     # the router's aux loss is in
    assert set(grads) == set(jgrads)
    for k in grads:
        assert rel_norm(grads[k].numpy(), jgrads[k]) <= GRAD_TOL, k


# The prefix variant's MLP starts at std 0.02, so its weights' gradients are
# small and change sign between steps; Adam divides each element by its own
# running scale, which turns f32 rounding (CPU matmuls of two libraries) into
# update differences near 2e-3 of the norm after ten steps (1.5e-5 on the
# loss). The plain soft prompt tracks to a few 1e-6.
TRAJECTORY_TOL = {"gpt2-base": (GRAD_TOL, 10 * LOSS_TOL), "qwen2-7b": (GRAD_TOL, 10 * LOSS_TOL),
                  "gpt2-base-prefix": (1e-2, 1e-4), "rwkv6-7b": (GRAD_TOL, 10 * LOSS_TOL)}


@pytest.mark.parametrize("case", sorted(TRAJECTORY_TOL))
def test_ten_adam_steps_track_jax(case):
    prompt_tol, loss_tol = TRAJECTORY_TOL[case]
    jt, params, tt, _ = tuners(case)
    jpp = jt.init_prompt(params, jax.random.key(2))
    tpp = prompt_from_arrays(jpp, "cpu")
    jstate, tstate = jt.init_opt(jpp), tt.init_opt(tpp)
    for i, b in enumerate(batches(10, 11)):
        jpp, jstate, jloss = jt.step(jpp, jstate, params, b)
        tpp, tstate, loss = tt.step(tpp, tstate, b)
        assert abs(float(loss) - float(jloss)) <= loss_tol * abs(float(jloss)), i
        for k in tpp:
            assert rel_norm(tpp[k].detach().numpy(), jpp[k]) <= prompt_tol, (i, k)
    assert int(tstate.step) == int(jstate.step) == 10


def test_mid_run_state_carries_over():
    """Three reference steps, then the prompt and the OptState carried to the
    port; three more steps in each package from that state agree."""
    jt, params, tt, _ = tuners("gpt2-base")
    jpp = jt.init_prompt(params, jax.random.key(4))
    jstate = jt.init_opt(jpp)
    steps = batches(6, 21)
    for b in steps[:3]:
        jpp, jstate, _ = jt.step(jpp, jstate, params, b)
    tpp, tstate = prompt_from_arrays(jpp, "cpu"), opt_state_from_jax(jstate, "cpu")
    assert int(tstate.step) == 3
    for b in steps[3:]:
        jpp, jstate, _ = jt.step(jpp, jstate, params, b)
        tpp, tstate, _ = tt.step(tpp, tstate, b)
    assert rel_norm(tpp["soft_prompt"].detach().numpy(), jpp["soft_prompt"]) <= GRAD_TOL
    mine = opt_state_to_numpy(tstate)
    assert rel_norm(mine["nu"]["soft_prompt"], jstate.nu["soft_prompt"]) <= GRAD_TOL


class ListLoader:
    """A loader over fixed batches, so both packages tune on the same data
    (the two packages' task loaders seed differently)."""

    def __init__(self, train, eval_batch):
        self._it, self._eval = iter(train), eval_batch

    def __next__(self):
        return next(self._it)

    def eval_batch(self, n):
        return self._eval


def task_batches(n, seed, batch=8):
    """Batches of a synthetic LPT task (labels follow a rule, so a prompt
    can learn it) and its eval set, from the port's numpy sampler."""
    from repro_torch.data import TaskSpec, sample_batch
    rng = np.random.default_rng(seed)
    spec = TaskSpec("shift", 2, 32)
    return [sample_batch(spec, rng, batch) for _ in range(n)], sample_batch(spec, rng, 16)


def first_improvement_target(evals):
    """A target between the best eval loss so far and the first later one
    that beats it by a margin, so that both packages first meet it at that
    evaluation; and that evaluation's index."""
    for j in range(1, len(evals)):
        best = min(evals[:j])
        if evals[j] < best - 1e-3 * abs(best):
            return 0.5 * (best + evals[j]), j
    raise AssertionError(f"tuning never improved the eval loss: {evals}")


@pytest.mark.parametrize("where", ["after some steps", "ita 0"])
def test_tune_reaches_a_fixed_target_in_the_same_iters(where):
    jt, params, tt, _ = tuners("gpt2-base", eval_every=2, max_iters=16)
    jpp = jt.init_prompt(params, jax.random.key(5))
    train, ev = task_batches(16, 31)
    probe = jt.tune(params, ListLoader(train, ev), jpp, target_loss=-1.0)
    evals = [e for _, _, e in probe["history"]]           # at steps 0, 2, 4, ...
    if where == "ita 0":
        target, j = evals[0] + 0.01, 0                      # the initial prompt meets it
    else:
        target, j = first_improvement_target(evals)
    jres = jt.tune(params, ListLoader(train, ev), jpp, target_loss=target)
    tres = tt.tune(ListLoader(train, ev), prompt_from_arrays(jpp, "cpu"), target_loss=target)
    assert tres["iters"] == jres["iters"] == 2 * j
    assert tres["reached"] and jres["reached"]
    assert len(tres["history"]) == len(jres["history"]) == j + 1
    for (ti, tl, te), (ji, jl, je) in zip(tres["history"], jres["history"]):
        assert ti == ji and abs(te - je) <= 10 * LOSS_TOL * abs(je)
        assert (np.isnan(tl) and np.isnan(jl)) or abs(tl - jl) <= 10 * LOSS_TOL * abs(jl)


def test_measure_ita_and_select_ideal_match_jax():
    """``measure_ita`` is ``tune`` to the target from a given prompt; the Ideal
    baseline shortlists by score and picks the best ITA, in both packages."""
    jt, params, tt, model = tuners("gpt2-base", eval_every=2, max_iters=16)
    prompt = np.asarray(jt.init_prompt(params, jax.random.key(6))["soft_prompt"])
    train, ev = task_batches(16, 41)
    evals = [e for _, _, e in jt.tune(params, ListLoader(train, ev),
                                      {"soft_prompt": jnp.asarray(prompt)},
                                      target_loss=-1.0)["history"]]
    target, j = first_improvement_target(evals)
    iters, reached = tbank.measure_ita(model, None, prompt, tt.tune_cfg, target_loss=target,
                                       max_iters=16, loader=ListLoader(train, ev))
    res = jt.tune(params, ListLoader(train, ev), {"soft_prompt": jnp.asarray(prompt)},
                  target_loss=target, max_iters=16)
    assert (iters, reached) == (res["iters"], res["reached"]) == (2 * j, True)

    class Entry:
        def __init__(self, i):
            self.prompt, self.origin = np.full((2, 2), float(i)), f"t/{i}"

    entries = [Entry(i) for i in range(6)]
    entries[2].origin = "<evicted>"
    bank = type("Bank", (), {"entries": entries})()
    score = lambda e: (7 - float(e.prompt[0, 0])) % 5
    ita = lambda p: int(abs(float(p[0, 0]) - 3.5) * 10)
    for shortlist in (2, 4, 20):
        te, titas = tbank.select_ideal(bank, score, ita, shortlist=shortlist)
        je, jitas = jbank.select_ideal(bank, score, ita, shortlist=shortlist)
        assert te is je and titas == jitas


def test_select_induction_matches_jax():
    from repro.data import TaskSpec as JTaskSpec
    from repro_torch.data import TaskSpec
    rng = np.random.default_rng(0)
    prompts = {f"{f}:{p}": rng.normal(size=(4, 8)).astype(np.float32)
               for f in ("copy", "shift") for p in range(3)}
    pre = type("Pre", (), {"task_prompts": prompts})()
    for fam, cap in (("copy", 0.5), ("shift", 0.9), ("negate", 0.2)):
        ours = tbank.select_induction(prompts, TaskSpec(fam, 1, 32), capability=cap, seed=3)
        ref = jbank.select_induction(pre, JTaskSpec(fam, 1, 32), capability=cap, seed=3)
        np.testing.assert_array_equal(ours, ref)


def test_init_prompts():
    jt, params, tt, model = tuners("gpt2-base-prefix")
    ids = np.array([5, 9, 3, 100], np.int32)
    from repro.tuning.soft_prompt import init_prompt_from_tokens as jinit
    np.testing.assert_array_equal(init_prompt_from_tokens(model, ids)["soft_prompt"].detach(),
                                  np.asarray(jinit(None, params, jnp.asarray(ids))["soft_prompt"]))
    gen = torch.Generator().manual_seed(0)
    pp = tt.init_prompt(gen)
    d = model.cfg.d_model
    r = max(d // 4, 8)
    assert pp["soft_prompt"].shape == (P, d) and pp["reparam_w"].shape == (d, r)
    assert pp["reparam_v"].shape == (r, d)
    assert all(v.dtype == torch.float32 and v.requires_grad and v.is_leaf for v in pp.values())
    big = init_prompt_random(model, 4096 // d * 16, torch.Generator().manual_seed(1))
    assert abs(float(big["soft_prompt"].detach().std()) * np.sqrt(d) / 0.5 - 1) < 0.05
    assert set(tt.init_prompt(gen, token_ids=ids)) == {"soft_prompt", "reparam_w", "reparam_v"}


# -- the chunked loss and the step functions --------------------------------------

@pytest.mark.parametrize("arch", ["gpt2-base", "deepseek-v2-236b"])
@pytest.mark.parametrize("chunk", [5, 12, 512])
def test_lpt_loss_chunked_matches_jax(arch, chunk):
    jmodel, params, model = pair(arch)
    rng = np.random.default_rng(chunk)
    prompt = (rng.normal(size=(P, model.cfg.d_model)) * 0.1).astype(np.float32)
    b = batches(1, chunk + 1)[0]
    jtot, (jmean, jper) = jax_lpt_loss_chunked(jmodel, params, jnp.asarray(prompt), jbatch(b),
                                               chunk=chunk)
    with torch.no_grad():
        tot, (mean, per) = lpt_loss_chunked(model, torch.from_numpy(prompt), tbatch(b),
                                            chunk=chunk)
        ftot, (fmean, _) = lpt_loss(model, torch.from_numpy(prompt), tbatch(b))
    np.testing.assert_allclose(float(mean), float(jmean), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=LOSS_TOL)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(fmean), float(mean), rtol=LOSS_TOL)   # one function


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_jax(microbatches):
    """Three steps, each started in both packages from the reference's state
    (carried over by ``prompt_from_arrays``/``opt_state_from_jax``): the same
    loss and moments, and the same prompt in every element whose gradient
    stands above f32 noise. Adam's update lr·m/(sqrt(v) + 1e-8) normalises
    each element by its own scale, so an element whose gradient sits at the
    noise floor of the largest (1e-7 of it, as happens in this case) gets an
    update set by rounding; the moments hold such an element to the
    gradient tolerance."""
    jmodel, params, model = pair("qwen2-7b")
    cfg = dict(prompt_len=P, lr=0.1, weight_decay=0.01)
    jstep, jo = jax_make_train_step(jmodel, JTuneConfig(**cfg), microbatches=microbatches,
                                    ce_chunk=5)
    tstep, _ = make_train_step(model, TuneConfig(**cfg), microbatches=microbatches,
                               ce_chunk=5)
    rng = np.random.default_rng(microbatches)
    jpp = {"soft_prompt": jnp.asarray((rng.normal(size=(P, model.cfg.d_model)) * 0.1)
                                      .astype(np.float32))}
    jstate = jo.init(jpp)
    for b in batches(3, 50 + microbatches, B=4):
        tpp, tstate, loss = tstep(prompt_from_arrays(jpp, "cpu"), opt_state_from_jax(jstate, "cpu"),
                                  tbatch(b))
        jpp, jstate, jloss = jstep(params, jpp, jstate, jbatch(b))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
        mine = opt_state_to_numpy(tstate)
        assert mine["step"] == int(jstate.step)
        for key in ("mu", "nu"):
            assert rel_norm(mine[key]["soft_prompt"], getattr(jstate, key)["soft_prompt"]) \
                <= GRAD_TOL
        mu = np.abs(np.asarray(jstate.mu["soft_prompt"]))
        above = mu > 1e-2 * mu.max()
        assert above.mean() > 0.5
        ours, ref = tpp["soft_prompt"].detach().numpy(), np.asarray(jpp["soft_prompt"])
        assert rel_norm(ours[above], ref[above]) <= GRAD_TOL


def prefill_parity(arch: str, seed: int, b: dict, ce_chunk: int) -> None:
    """make_prefill_step on ``arch``'s smoke cut against the reference's on
    batch ``b``, per-example losses at LOSS_TOL."""
    jmodel, params, model = pair(arch)
    sp = (np.random.default_rng(seed).normal(size=(P, model.cfg.d_model)) * 0.1).astype(np.float32)
    ref = jax_make_prefill_step(jmodel, ce_chunk=ce_chunk)(params, {"soft_prompt": jnp.asarray(sp)},
                                                           jbatch(b))
    per = make_prefill_step(model, ce_chunk=ce_chunk)({"soft_prompt": torch.from_numpy(sp)},
                                                      tbatch(b))
    assert per.shape == (b["tokens"].shape[0],)
    np.testing.assert_allclose(per.numpy(), np.asarray(ref), rtol=LOSS_TOL, atol=LOSS_TOL)


def test_make_prefill_step_matches_jax():
    prefill_parity("gpt2-base", 9, batches(1, 60, B=3)[0], ce_chunk=7)


@pytest.mark.parametrize("arch", ["internlm2-20b", "phi3-medium-14b", "command-r-plus-104b"])
def test_make_prefill_step_matches_jax_on_the_dense_family(arch):
    """prefill_32k's step on the smoke cuts of the last three dense configs
    (command-r-plus-104b's parallel LayerNorm block and tied head among
    them): 40 tokens a row after the prompt, in chunks of 16 with a ragged
    last one, every token masked in or out at random."""
    prefill_parity(arch, 10, batches(1, 61, B=2, S=40)[0], ce_chunk=16)


def test_model_for_shape_matches_jax():
    from repro.config import INPUT_SHAPES as JSHAPES
    from repro.launch.steps import model_for_shape as jmfs
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch import model_for_shape, supports_shape
    from repro.configs import get_config as jget
    for arch in ("gpt2-base", "qwen2-7b", "rwkv6-7b", "deepseek-v2-236b", "vicuna-7b",
                 "internlm2-20b", "phi3-medium-14b", "command-r-plus-104b"):
        for name, shape in INPUT_SHAPES.items():
            ours = model_for_shape(get_config(arch), shape)
            ref = jmfs(jget(arch), JSHAPES[name])
            assert ours.sliding_window == ref.sliding_window, (arch, name)
            assert supports_shape(ours, shape) == (True, "")


# -- the frozen model -----------------------------------------------------------

def test_forward_only_paths_keep_no_graph_on_the_frozen_weights():
    _, _, model = pair("gpt2-base")
    assert not any(p.requires_grad for p in model.parameters())
    tokens = torch.from_numpy(batches(1, 70)[0]["tokens"])
    hidden = model.backbone(tokens)                    # no torch.no_grad() around it
    assert not hidden.requires_grad and hidden.grad_fn is None
    prompt = torch.zeros(P, model.cfg.d_model, requires_grad=True)
    out = model.backbone(tokens, prompt=prompt)
    assert out.grad_fn is not None
    (g,) = torch.autograd.grad(out.sum(), prompt)
    assert g.shape == prompt.shape
    fresh = Model(smoke_config("gpt2-base"), device="cpu", seed=None)
    fresh.load_state_dict({k: v.clone().requires_grad_(True)
                           for k, v in model.state_dict().items()}, assign=True)
    assert not any(p.requires_grad for p in fresh.parameters())
