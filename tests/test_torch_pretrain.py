"""The port's pretraining, checkpoints and Prompt Bank from the artifact,
against the JAX package's.

- dE, the embedding's gradient from ``score_ce`` (``score_ce_bwd_plain``
  with ``with_emb`` and autograd through ``ScoreCE``), against ``jax.vjp``
  of ``repro.kernels.ref.score_ce_ref`` with respect to E, at 2e-5 (f32, the
  backward tests' tolerance);
- checkpoints written by either package and read by the other: the same
  ``/``-joined keys, arrays and manifest;
- three joint steps of ``make_pretrain_step`` on ``testbed-gpt2-base``
  from the same numpy weights, prompt table and batches (the reference's:
  the loaders seed differently) against ``jax.value_and_grad`` of the
  reference's ``lpt_loss`` over {"params", "prompts"} with its ``adam``,
  ``cosine_schedule`` and ``apply_updates``: losses at 1e-5, every weight
  and the table after each step at 1e-4 relative norm (the training
  tolerances of tests/test_torch_train.py), apart from the few elements
  whose reference gradient was within rounding of zero at some step (Adam's
  early steps move an element by about lr in the sign of its gradient, and
  rounding decides that sign): those are held to the steps' bound;
- ``build_bank_from_pretrain`` on an artifact of seeded weights and prompt
  table, written as the reference writes its own, against the reference's:
  the same origins, features within 1e-5;
- ``pretrain`` end to end on the CPU, its artifact cached under the port's
  own prefix in a temporary directory: no test writes into ``artifacts/``.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import numpy_params

from repro.core.bank_builder import build_bank_from_pretrain as jax_build_bank_from_pretrain
from repro.data import LoaderConfig as JLoaderConfig
from repro.data import TaskLoader as JTaskLoader
from repro.data import make_tasks as jax_make_tasks
from repro.kernels.ref import score_ce_ref
from repro.models import build_model
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.objectives import lpt_loss as jax_lpt_loss
from repro.train.pretrain import PretrainResult as JPretrainResult
from repro.train.pretrain import testbed_config as jax_testbed_config
from repro.tuning.soft_prompt import _probe_tokens
from repro_torch.configs import smoke_config
from repro_torch.core import build_bank_from_pretrain
from repro_torch.data import batch_to_torch, make_tasks
from repro_torch.kernels.score_ce import (score_ce, score_ce_bwd, score_ce_bwd_plain,
                                          score_ce_plain)
from repro_torch.models import Model, params_from_jax, params_to_jax
from repro_torch.train import (PretrainResult, checkpoint_exists, load_checkpoint,
                               load_pretrain, make_pretrain_step, pretrain, save_checkpoint)
from repro_torch.train import testbed_config as torch_testbed_config   # no test_ prefix

pretrain_mod = importlib.import_module("repro_torch.train.pretrain")   # the module, not the function

TOL = 2e-5
LOSS_TOL = 1e-5
WEIGHT_TOL = 1e-4
FEATURE_TOL = 1e-5
P = 8
# Joint pretraining steps: a gradient element that is not 0 but below
# GRAD_ROUNDING (absolute) may have its sign decided by f32 rounding, which is of the order of 1e-7
# an element for these weights and can move between runs on a loaded
# machine. Such elements (at most ILL_SHARE of a leaf) are held to Adam's
# bound instead: in each of the first three steps an element moves by at
# most 1.003 lr_t (the bias-corrected |m| / sqrt(v) at b1 0.9, b2 0.999), so
# the two packages differ there by at most twice that, summed.
GRAD_ROUNDING = 1e-6
ILL_SHARE = 1e-2
ADAM_STEP_BOUND = 1.003


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- dE ----------------------------------------------------------------------------

@pytest.mark.parametrize("T,D,V,masked", [(37, 64, 300, False), (37, 64, 300, True),
                                          (1, 16, 50, False), (130, 32, 1000, True)])
def test_score_ce_de_matches_jax_vjp(T, D, V, masked):
    rng = np.random.default_rng(T + 3 * V)
    h = rng.normal(size=(T, D)).astype(np.float32)
    e = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, T).astype(np.int32)
    g = rng.random(T).astype(np.float32)
    if masked:
        g[::3] = 0.0
    _, vjp = jax.vjp(lambda x, w: score_ce_ref(x, w, jnp.asarray(lab)), jnp.asarray(h),
                     jnp.asarray(e))
    jdh, jde = vjp(jnp.asarray(g))
    th, te, tl, tg = map(torch.from_numpy, (h, e, lab, g))
    _, lse = score_ce_plain(th, te, tl, return_lse=True)
    dh, de = score_ce_bwd_plain(th, te, tl, lse, tg, with_emb=True)
    _close(dh.numpy(), np.asarray(jdh))
    _close(de.numpy(), np.asarray(jde))
    torch.testing.assert_close(score_ce_bwd(th, te, tl, lse, tg), dh, rtol=0, atol=0)
    # through ScoreCE: the same gradients, with emb's only when it requires grad
    hh, ee = th.clone().requires_grad_(True), te.clone().requires_grad_(True)
    nll = score_ce(hh, ee, tl)
    assert type(nll.grad_fn).__name__ == "ScoreCEBackward"
    gh, ge = torch.autograd.grad((nll * tg).sum(), (hh, ee))
    _close(gh.numpy(), np.asarray(jdh))
    _close(ge.numpy(), np.asarray(jde))
    (gh2,) = torch.autograd.grad((score_ce(hh, te, tl) * tg).sum(), hh)
    torch.testing.assert_close(gh2, gh, rtol=0, atol=0)


def test_tied_embedding_gradient_is_the_sum_of_gather_and_de():
    """The tied embedding reaches the loss twice, through the token gather
    and through score_ce; its gradient in the port is the sum, as XLA's."""
    jmodel = build_model(jax_testbed_config("gpt2-base"))
    tree = numpy_params(jmodel, seed=2)
    model = Model(torch_testbed_config("gpt2-base"), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(tree))
    b = JTaskLoader(jax_make_tasks(vocab=32, partitions=4)[7],
                    JLoaderConfig(batch_size=4, seed=1)).__next__()
    prompt = (np.random.default_rng(0).normal(size=(P, 128)) * 0.04).astype(np.float32)

    def jloss(params):
        return jax_lpt_loss(jmodel, params, jnp.asarray(prompt),
                            {k: jnp.asarray(v) for k, v in b.items()}, P)[0]

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, tree))["embedding"]
    from repro_torch.train import lpt_loss
    model.train_weights()
    try:
        tot, _ = lpt_loss(model, torch.from_numpy(prompt), batch_to_torch(b, "cpu"))
        (g,) = torch.autograd.grad(tot, model.embedding)
    finally:
        model.train_weights(False)
    assert rel_norm(g.numpy(), np.asarray(jg)) <= WEIGHT_TOL


# -- the frozen default and the untied limit ------------------------------------------

def test_train_weights_switches_and_refuses_untied_models():
    model = Model(smoke_config("gpt2-base"), device="cpu", seed=0)
    assert not any(p.requires_grad for p in model.parameters())
    assert model.train_weights() is model
    assert all(p.requires_grad for p in model.parameters())
    model.load_state_dict(model.state_dict())          # stays trainable while on
    assert all(p.requires_grad for p in model.parameters())
    model.train_weights(False)
    model.load_state_dict(model.state_dict())
    assert not any(p.requires_grad for p in model.parameters())
    untied = Model(smoke_config("qwen2-7b"), device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match="untied"):
        untied.train_weights()
    assert not any(p.requires_grad for p in untied.parameters())


# -- checkpoints across the two packages ----------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"embedding": rng.normal(size=(6, 4)).astype(np.float32),
                       "blocks": {"attn": {"wq": rng.normal(size=(2, 4, 2, 2))
                                           .astype(np.float32)}}},
            "prompt_table": rng.normal(size=(3, 2, 4)).astype(np.float32),
            "step": np.int32(7)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_are_read_across_packages(tmp_path, writer):
    tree = _tree(len(writer))
    path = str(tmp_path / "ck.npz")
    meta = {"llm": "testbed", "tasks": ["a:0", "b:1"]}
    if writer == "port":
        torch_tree = {**tree, "params": {**tree["params"],
                                         "embedding": torch.from_numpy(tree["params"]["embedding"])}}
        save_checkpoint(path, torch_tree, step=5, meta=meta)
        got, manifest = jckpt.load_checkpoint(path, as_jax=False)
    else:
        jckpt.save_checkpoint(path, tree, step=5, meta=meta)
        got, manifest = load_checkpoint(path)
    assert checkpoint_exists(path) and jckpt.checkpoint_exists(path)
    want, have = _flat(tree), _flat(got)
    assert sorted(have) == sorted(want) == manifest["keys"]
    assert manifest["step"] == 5 and manifest["meta"] == meta
    for k in want:
        np.testing.assert_array_equal(have[k], want[k])


def test_bf16_checkpoint_round_trips_bitwise(tmp_path):
    model = Model(smoke_config("gpt2-base").with_overrides(dtype="bfloat16",
                                                           param_dtype="bfloat16"),
                  device="cpu", seed=3)
    path = str(tmp_path / "bf16.npz")
    save_checkpoint(path, {"params": params_to_jax(model.state_dict())})
    tree, _ = load_checkpoint(path)
    back = Model(model.cfg, device="cpu", seed=None)
    back.load_state_dict(params_from_jax(tree["params"]))
    for (name, a), (_, b) in zip(model.state_dict().items(), back.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name


# -- joint pretraining steps against the reference's -----------------------------------

def test_three_joint_steps_match_jax():
    steps, batch_size = 3, 8
    jcfg = jax_testbed_config("gpt2-base")
    jmodel = build_model(jcfg)
    tree = numpy_params(jmodel, seed=11)
    tasks = jax_make_tasks(vocab=32, partitions=4)
    rng = np.random.default_rng(5)
    d = jcfg.d_model
    table0 = (rng.normal(size=(len(tasks), P, d)) * (0.5 / np.sqrt(d))).astype(np.float32)
    picks = [int(rng.integers(len(tasks))) for _ in range(steps)]
    loaders = {}
    batches = []
    for ti in picks:
        loaders.setdefault(ti, JTaskLoader(tasks[ti], JLoaderConfig(batch_size=batch_size)))
        batches.append(next(loaders[ti]))

    schedule = jopt.cosine_schedule(2e-3, min(200, steps), steps)
    opt = jopt.adam(schedule)

    def loss_fn(trainable, ti, batch):
        return jax_lpt_loss(jmodel, trainable["params"], trainable["prompts"][ti], batch, P)[0]

    @jax.jit
    def jstep(trainable, state, ti, batch):
        loss, grads = jax.value_and_grad(loss_fn)(trainable, ti, batch)
        updates, state = opt.update(grads, state, trainable)
        return jopt.apply_updates(trainable, updates), state, loss, grads

    trainable = {"params": jax.tree.map(jnp.asarray, tree), "prompts": jnp.asarray(table0)}
    jstate = opt.init(trainable)

    model = Model(torch_testbed_config("gpt2-base"), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(tree))
    model.train_weights()
    step, topt = make_pretrain_step(model, steps)
    table = torch.from_numpy(table0).requires_grad_(True)
    tstate = topt.init({**{f"params/{n}": p for n, p in model.named_parameters()},
                        "prompts": table})
    ill, lr_sum = {}, 0.0
    try:
        for i, (ti, b) in enumerate(zip(picks, batches)):
            trainable, jstate, jloss, jgrads = jstep(trainable, jstate, jnp.int32(ti),
                                                     {k: jnp.asarray(v) for k, v in b.items()})
            table, tstate, loss = step(table, tstate, ti, batch_to_torch(b, "cpu"))
            lr_sum += float(schedule(jnp.int32(i + 1)))
            assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss)), i
            ours = {**_flat(params_to_jax(model.state_dict())),
                    "prompts": table.detach().numpy()}
            wants = _flat(jax.tree.map(np.asarray, {**trainable["params"],
                                                    "prompts": trainable["prompts"]}))
            grads = _flat(jax.tree.map(np.asarray, {**jgrads["params"],
                                                    "prompts": jgrads["prompts"]}))
            for path, want in wants.items():
                g = grads[path]
                ill[path] = ill.get(path, False) | ((np.abs(g) < GRAD_ROUNDING) & (g != 0))
                mask = ill[path]
                assert mask.mean() <= ILL_SHARE, (i, path, mask.mean())
                diff = np.asarray(ours[path], np.float64) - want
                assert np.linalg.norm(diff[~mask]) <= WEIGHT_TOL * np.linalg.norm(want), (i, path)
                assert np.abs(diff[mask]).max(initial=0.0) <= 2 * ADAM_STEP_BOUND * lr_sum, \
                    (i, path)
    finally:
        model.train_weights(False)
    assert int(tstate.step) == int(jstate.step) == steps
    assert table.requires_grad and table.is_leaf


# -- the Prompt Bank from the artifact ---------------------------------------------------

def test_build_bank_from_pretrain_matches_jax(tmp_path):
    """An artifact of seeded weights and prompt table, saved as the reference
    saves its own and read by ``load_pretrain``; the bank built from it with
    the reference's probes. (The ``pre_base`` fixture is not used: JAX's
    pretraining on the CPU does not reproduce its weights from one run to the
    next, so each fresh checkout would compare on other data.)"""
    jmodel = build_model(jax_testbed_config("gpt2-base"))
    params = numpy_params(jmodel, seed=13)
    tasks = jax_make_tasks(vocab=32, partitions=4)
    d = jmodel.cfg.d_model
    rng = np.random.default_rng(7)
    table = (rng.normal(size=(len(tasks), P, d)) * (0.5 / np.sqrt(d))).astype(np.float32)
    jpre = JPretrainResult(jmodel, jax.tree.map(jnp.asarray, params),
                           {t.task_id: table[i] for i, t in enumerate(tasks)}, tasks)
    path = str(tmp_path / "pretrain_gpt2-base.npz")
    jckpt.save_checkpoint(path, {"params": params, "prompt_table": table})
    pre = load_pretrain(path, torch_testbed_config("gpt2-base"), make_tasks(vocab=32, partitions=4),
                        device="cpu")
    assert isinstance(pre, PretrainResult)
    assert [t.task_id for t in pre.tasks] == [t.task_id for t in tasks]
    probes = np.asarray(_probe_tokens(jmodel, 4, 9))
    bank = build_bank_from_pretrain(pre, variants_per_prompt=2, probes=probes)
    jbank = jax_build_bank_from_pretrain(jpre, variants_per_prompt=2)
    assert [e.origin for e in bank.entries] == [e.origin for e in jbank.entries]
    for e, je in zip(bank.entries, jbank.entries):
        np.testing.assert_array_equal(e.prompt, je.prompt)
        np.testing.assert_allclose(e.feature, je.feature, rtol=FEATURE_TOL, atol=FEATURE_TOL)
    assert bank.num_clusters == jbank.num_clusters


# -- pretrain end to end, into a temporary artifact directory ----------------------------

def test_pretrain_caches_under_its_own_prefix(tmp_path, monkeypatch):
    monkeypatch.setattr(pretrain_mod, "ARTIFACT_DIR", str(tmp_path))
    kw = dict(steps=3, batch_size=4, device="cpu")
    pre = pretrain("gpt2-base", **kw)
    assert not any(p.requires_grad for p in pre.model.parameters())
    assert sorted(os.listdir(tmp_path)) == ["torch_pretrain_gpt2-base_s3_p4.npz",
                                            "torch_pretrain_gpt2-base_s3_p4.npz.json"]
    tree, manifest = jckpt.load_checkpoint(str(tmp_path / "torch_pretrain_gpt2-base_s3_p4.npz"),
                                           as_jax=False)
    assert manifest["step"] == 3 and manifest["meta"]["llm"] == "gpt2-base"
    assert tree["prompt_table"].shape == (48, P, 128)
    assert tree["params"]["blocks"]["attn"]["wq"].shape == (2, 128, 4, 32)
    again = pretrain("gpt2-base", **kw)                 # read back from the cache
    for tid, p in pre.task_prompts.items():
        np.testing.assert_array_equal(again.task_prompts[tid], p)
    for (n, a), (_, b) in zip(pre.model.state_dict().items(), again.model.state_dict().items()):
        assert torch.equal(a, b), n
    longer = pretrain("gpt2-base", steps=5, batch_size=4, device="cpu", verbose=True)
    assert checkpoint_exists(str(tmp_path / "torch_pretrain_gpt2-base_s5_p4.npz"))
    assert all(np.isfinite(p).all() for p in longer.task_prompts.values())
    cold = pretrain("gpt2-base", steps=2, batch_size=4, device="cpu", cache=False)
    assert len(os.listdir(tmp_path)) == 4 and len(cold.task_prompts) == 48


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_score_ce_de_matches_plain(cuda_device, dtype):
    """dE against the plain version at chip_smoke.py phase 9f's tolerances
    (2e-5 f32; 3e-2 bf16, with atol scaled to the largest element), around
    the dE kernel's 128-row vocabulary tiles and 64-token stages; two calls
    bitwise equal."""
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (3e-2, 1e-2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for T, V in ((1, 509), (64, 509), (65, 300), (129, 257), (300, 1000)):
        h = torch.randn(T, 64, generator=gen, device=cuda_device).to(dtype)
        e = (torch.randn(V, 64, generator=gen, device=cuda_device) * 0.05).to(dtype)
        lab = torch.randint(0, V, (T,), generator=gen, device=cuda_device, dtype=torch.int32)
        g = torch.rand(T, generator=gen, device=cuda_device)
        _, lse = score_ce_plain(h, e, lab, return_lse=True)
        _, ref = score_ce_bwd_plain(h, e, lab, lse, g, with_emb=True)
        _, de = score_ce_bwd(h, e, lab, lse, g, with_emb=True)
        _, again = score_ce_bwd(h, e, lab, lse, g, with_emb=True)
        assert torch.equal(de, again)
        torch.testing.assert_close(de.float(), ref.float(), rtol=rtol,
                                   atol=atol * ref.float().abs().max().item())
