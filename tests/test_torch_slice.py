"""The whole slice against the JAX package, on the pretrained testbed.

The reference's artifact (the ``pre_base`` fixture) is loaded into the port
with numpy alone; both packages build the Prompt Bank from the same task
prompts (the port gets the reference's probe tokens, which come from
``jax.random``) and answer the same lookups on the same eval batches.

K-medoids breaks exact and near ties by float rounding: both members of a
two-member cluster have the same distance sum, and a candidate can sit
almost midway between two medoids. Features that agree to 1e-5 can
therefore cluster differently, in either package, depending on the artifact
(pretraining is not bitwise repeatable) and the thread count. So the
features are held to 1e-5, and the clustering is held exactly on the
reference's features: the port's copy of the bank must build the same
medoids and clusters from them. The lookups run on that bank.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import TuneConfig as JaxTuneConfig
from repro.core.bank_builder import build_bank_from_pretrain
from repro.core.bank_builder import make_score_fn as jax_make_score_fn
from repro.data import LoaderConfig as JaxLoaderConfig
from repro.data import TaskLoader as JaxTaskLoader
from repro.train.checkpoint import save_checkpoint
from repro.tuning import PromptTuner as JaxPromptTuner
from repro.tuning.soft_prompt import _probe_tokens
from repro_torch.config import TuneConfig
from repro_torch import configs
from repro_torch.core import PromptBank, PromptEntry, build_bank, make_score_fn, select_manual
from repro_torch.models import Model, load_jax_checkpoint, params_from_jax
from repro_torch.tuning import PromptTuner, activation_features

TOL = 1e-5
VARIANTS = 4


@pytest.fixture(scope="module")
def slice_pair(pre_base, tmp_path_factory):
    """The reference run (``pre``, ``jbank``) and the port's (``model``,
    ``bank``, and ``same``: its candidates on the reference's features).

    The fixture's tree is saved as the reference saves its artifact and read
    back with numpy alone. (Test processes that pretrain at the same time
    may rewrite the shared file under ``artifacts/``, so it is not read.)"""
    path = str(tmp_path_factory.mktemp("artifact") / "pretrain_gpt2-base.npz")
    table = np.stack([pre_base.task_prompts[t.task_id] for t in pre_base.tasks])
    save_checkpoint(path, {"params": pre_base.params, "prompt_table": table})
    tree = load_jax_checkpoint(path)
    model = Model(configs.testbed_config("gpt2-base"), device="cpu")
    model.load_state_dict(params_from_jax(tree["params"]))
    prompts = {t.task_id: tree["prompt_table"][i] for i, t in enumerate(pre_base.tasks)}
    probes = np.asarray(_probe_tokens(pre_base.model, 4, 9))
    jbank = build_bank_from_pretrain(pre_base, variants_per_prompt=VARIANTS)
    bank = build_bank(model, prompts, variants_per_prompt=VARIANTS, probes=probes)
    # the port's candidates with the reference's features, clustered by the port
    same = PromptBank(capacity=bank.capacity, num_clusters=bank.num_clusters,
                      seed=bank.seed)
    same.add_candidates([PromptEntry(e.prompt, je.feature, e.origin)
                         for e, je in zip(bank.entries, jbank.entries)])
    same.build()
    return SimpleNamespace(pre=pre_base, model=model, prompts=prompts, probes=probes,
                           jbank=jbank, bank=bank, same=same)


def test_artifact_loads_into_the_port(slice_pair):
    pre, model, prompts = slice_pair.pre, slice_pair.model, slice_pair.prompts
    np.testing.assert_array_equal(model.embedding.detach().numpy(),
                                  np.asarray(pre.params["embedding"]))
    for tid, p in prompts.items():
        np.testing.assert_array_equal(p, np.asarray(pre.task_prompts[tid]))


def test_activation_features_match_jax(slice_pair):
    from repro.tuning import activation_features as jax_activation_features

    pre, model, prompts = slice_pair.pre, slice_pair.model, slice_pair.prompts
    stacked = np.stack([prompts["shift:0"], prompts["xor:1"]])
    ours = activation_features(model, stacked, probes=slice_pair.probes)
    ref = jax_activation_features(pre.model, pre.params, jnp.asarray(stacked))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=TOL, atol=TOL)


def test_bank_has_same_clusters(slice_pair):
    jbank, bank, same = slice_pair.jbank, slice_pair.bank, slice_pair.same
    assert [e.origin for e in bank.entries] == [e.origin for e in jbank.entries]
    for e, je in zip(bank.entries, jbank.entries):
        np.testing.assert_array_equal(e.prompt, je.prompt)       # same numpy jitter
        np.testing.assert_allclose(e.feature, je.feature, rtol=TOL, atol=TOL)
    assert bank.num_clusters == jbank.num_clusters == 48
    assert same.medoid_ids == jbank.medoid_ids
    assert same.clusters == jbank.clusters


@pytest.mark.parametrize("task_index", [3, 17, 40])
def test_lookup_picks_same_prompt(slice_pair, task_index):
    pre, model, jbank, same = slice_pair.pre, slice_pair.model, slice_pair.jbank, slice_pair.same
    task = pre.tasks[task_index]
    tc = JaxTuneConfig(batch_size=8)
    loader = JaxTaskLoader(task, JaxLoaderConfig(batch_size=8))
    jres = jbank.lookup(jax_make_score_fn(pre, task, tc, loader))
    res = same.lookup(make_score_fn(model, task, TuneConfig(batch_size=8), loader))
    assert res.entry.origin == jres.entry.origin
    assert res.evaluations == jres.evaluations
    assert res.cluster == jres.cluster
    np.testing.assert_allclose(res.score, jres.score, rtol=TOL, atol=TOL)


def test_flat_score_matches_jax_over_tasks(slice_pair):
    pre, model, prompts = slice_pair.pre, slice_pair.model, slice_pair.prompts
    jtuner = JaxPromptTuner(pre.model, JaxTuneConfig())
    tuner = PromptTuner(model, TuneConfig())
    for task in pre.tasks[::6]:
        eb = JaxTaskLoader(task, JaxLoaderConfig()).eval_batch(16)
        for tid in (task.task_id, "copy:0"):
            jscore = jtuner.score({"soft_prompt": jnp.asarray(prompts[tid])}, pre.params, eb)
            score = tuner.score({"soft_prompt": prompts[tid]}, eb)
            np.testing.assert_allclose(score, jscore, rtol=TOL, atol=TOL)


def test_select_manual_matches_jax(slice_pair):
    from repro.core.bank_builder import select_manual as jax_select_manual

    pre, model, prompts = slice_pair.pre, slice_pair.model, slice_pair.prompts
    P, d = next(iter(prompts.values())).shape
    for seed in (0, 3):
        np.testing.assert_array_equal(select_manual(d, P, seed=seed),
                                      jax_select_manual(pre, seed=seed))


def test_prefix_score_matches_jax(slice_pair):
    """Eqn 1 through the prefix variant's reparameterization MLP."""
    import jax

    pre, model, prompts = slice_pair.pre, slice_pair.model, slice_pair.prompts
    jtuner = JaxPromptTuner(pre.model, JaxTuneConfig(algorithm="prefix"))
    tuner = PromptTuner(model, TuneConfig(algorithm="prefix"))
    pp = jtuner.init_prompt(pre.params, jax.random.key(1))
    pp["soft_prompt"] = jnp.asarray(prompts["mul:2"])
    eb = JaxTaskLoader(pre.tasks[13], JaxLoaderConfig()).eval_batch(16)
    jscore = jtuner.score(pp, pre.params, eb)
    score = tuner.score({k: np.array(v) for k, v in pp.items()}, eb)
    np.testing.assert_allclose(score, jscore, rtol=TOL, atol=TOL)
