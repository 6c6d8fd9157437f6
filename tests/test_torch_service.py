"""The port's ``PromptTunerService`` against the reference's, on the CPU.

The two services cannot share objects (the reference's requests, entries and
jobs are its own types), so each side builds its own from the same numpy
arrays and the results are compared as plain values:

- on the synthetic blob bank and cosine scorer of ``tests/test_api.py``,
  the same requests give equal handles (routing, lookups, shards,
  rejections), results, bank insertions, events and summaries, over one
  shard, sharded elastic fabrics with quotas, a fault plane and other
  policies;
- with Eqn-1 scorers on a gpt2-base smoke cut (the reference's JAX
  ``make_score_fn`` and the port's on the CPU, with the same weights via
  ``params_from_jax``), the lookups pick the same origins with scores within
  1e-5, and everything else is equal.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_cluster import plain
from test_torch_model import numpy_params

import repro.api as ref_api
import repro.cluster as ref_cluster
import repro.core.prompt_bank as ref_pb
import repro_torch.api as port_api
import repro_torch.cluster as port_cluster
import repro_torch.core.prompt_bank as port_pb
from repro.config import TuneConfig as JTuneConfig
from repro.configs import smoke_config as jax_smoke_config
from repro.core.bank_builder import make_score_fn as jax_make_score_fn
from repro.data import LoaderConfig as JLoaderConfig
from repro.data import TaskLoader as JTaskLoader
from repro.data import make_tasks as jax_make_tasks
from repro.models import build_model
from repro.tuning import activation_features as jax_activation_features
from repro.tuning.soft_prompt import _probe_tokens
from repro_torch.config import TuneConfig
from repro_torch.configs import smoke_config
from repro_torch.core import make_score_fn
from repro_torch.data import make_tasks
from repro_torch.models import Model, params_from_jax
from repro_torch.tuning import activation_features

REF = SimpleNamespace(api=ref_api, c=ref_cluster, pb=ref_pb, name="reference")
PORT = SimpleNamespace(api=port_api, c=port_cluster, pb=port_pb, name="port")
SCORE_TOL = 1e-5


def blob_bank(side, n=60, d=8, k=6, seed=0):
    """``tests/test_api.py``'s synthetic bank: ``k`` gaussian feature blobs,
    one entry family per blob, built with ``side``'s own types."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d))
    entries = []
    for i in range(n):
        c = i % k
        feat = centers[c] + 0.05 * rng.normal(size=d)
        entries.append(side.pb.PromptEntry(
            prompt=rng.normal(size=(4, d)).astype(np.float32),
            feature=feat.astype(np.float32), origin=f"blob{c}/v{i // k}"))
    bank = side.pb.PromptBank(capacity=64, num_clusters=k, seed=seed)
    bank.add_candidates(entries)
    bank.build()
    return bank, centers


def cosine_factory(side):
    """Eqn-1 stand-in: the cosine distance of an entry's feature to the
    request's feature."""
    def factory(req):
        target = np.asarray(req.feature)
        return lambda e: float(side.pb.cosine_distance(e.feature[None], target[None])[0, 0])
    return factory


def request_script(centers, seed=1):
    """Two waves of request fields (the second submitted at the service's
    clock): tenants, classes, tight and loose SLOs, three LLMs, and
    tuned prompts that the service inserts into the bank on completion.
    The tight SLOs fall outside the latency budget and are not routed."""
    rng = np.random.default_rng(seed)
    llms = ["gpt2-base", "gpt2-base", "vicuna-7b", "gpt2-base", "llama-30b"]
    classes = ["premium", "standard", "best-effort", None, "premium"]
    waves = []
    for wave, count in ((0, 9), (1, 5)):
        reqs = []
        for i in range(count):
            blob = int(rng.integers(len(centers)))
            feat = (centers[blob] + 0.05 * rng.normal(size=centers.shape[1])).astype(np.float32)
            carry = i % 3 != 2
            reqs.append(dict(
                task_id=f"w{wave}t{i}", llm=llms[i % len(llms)],
                slo=float(rng.choice([20.0, 35.0, 120.0, 300.0, 900.0])),
                iters_manual=int(rng.integers(100, 600)), iters_bank=int(rng.integers(20, 150)),
                submit_time=(float(2 * i) if wave == 0 and i % 4 else None),
                tenant=("acme", "globex")[i % 2], slo_class=classes[i % len(classes)],
                prompt=rng.normal(size=(4, centers.shape[1])).astype(np.float32) if carry else None,
                feature=feat))
        waves.append(reqs)
    return waves


SERVICES = {  # id -> (side, bank, factory, **service kwargs) -> service
    "one-shard": lambda s, bank, f, **kw: s.api.PromptTunerService(
        s.c.SimConfig(max_gpus=16), bank=bank, score_fn_factory=f, **kw),
    "two-shards-elastic-quota": lambda s, bank, f, **kw: s.api.PromptTunerService(
        s.c.SimConfig(max_gpus=16), bank=bank, score_fn_factory=f, shards=2,
        elastic=s.c.ElasticConfig(quotas={"acme": s.c.TenantQuota(max_outstanding=3)}), **kw),
    "three-shards-hash-infless-faults": lambda s, bank, f, **kw: s.api.PromptTunerService(
        s.c.SimConfig(max_gpus=12, checkpoint_interval_s=20.0), policy="infless", bank=bank,
        score_fn_factory=f, shards=3, placement="hash", elastic=s.c.ElasticConfig(),
        faults=s.c.FaultPlane(hazard=s.c.HazardConfig(
            crash_rate=40.0, preempt_rate=20.0, slow_rate=20.0, flap_rate=8.0,
            mean_downtime_s=30.0, horizon_s=300.0), seed=4), **kw),
    "prebuilt-fabric-edf": lambda s, bank, f, **kw: s.api.PromptTunerService(
        fabric=s.c.ClusterFabric(s.c.SimConfig(max_gpus=8), "edf-cold", shards=2),
        bank=bank, score_fn_factory=f, **kw),
    "no-bank": lambda s, bank, f, **kw: s.api.PromptTunerService(s.c.SimConfig(max_gpus=16), **kw),
}


def drive(side, service_id, waves, bank, factory, quota=None):
    """Runs the request script through one package's service. Returns every
    observable as a plain value."""
    svc = SERVICES[service_id](side, bank, factory)
    events = []
    svc.stream(lambda e: events.append(plain(e)))
    if quota is not None and svc.fabric.controller is not None:
        svc.set_quota("globex", side.c.TenantQuota(**quota))
    out = {"handles": [], "results": [], "errors": [], "bank": []}
    for reqs in waves:
        for fields in reqs:
            out["handles"].append(plain(svc.submit(side.api.SubmitRequest(**fields))))
        for bad in (dict(llm="gpt5"), dict(slo_class="platinum")):
            with pytest.raises(KeyError) as info:
                svc.submit(side.api.SubmitRequest(**{**reqs[0], **bad}))
            out["errors"].append(str(info.value))
        out["results"].append(plain(svc.run_until_idle()))
        if svc.bank is not None:
            out["bank"].append(plain((len(svc.bank), svc.bank.entries, svc.bank.clusters,
                                      svc.bank.medoid_ids)))
    out["events"] = events
    out["summary"] = plain(svc.summary())
    out["by_tenant"] = plain(svc.summary_by_tenant())
    out["sim_result"] = plain(svc.sim_result())
    out["now"] = plain(svc.now)
    out["routed"] = [svc.route_through_bank(side.api.SubmitRequest(**f))
                     for reqs in waves for f in reqs]
    return out, svc


@pytest.mark.parametrize("service_id", sorted(SERVICES))
def test_service_matches_reference(service_id):
    waves = request_script(blob_bank(REF)[1])
    got = {}
    for side in (REF, PORT):
        bank, _ = blob_bank(side)
        quota = dict(gpu_seconds=600.0) if service_id.startswith("two") else None
        got[side.name], _ = drive(side, service_id, waves, bank, cosine_factory(side),
                                  quota=quota)
    ref, port = got["reference"], got["port"]
    for key in ref:
        assert port[key] == ref[key], key
    assert any(ref["routed"]) and not all(ref["routed"])      # the budget splits the script


def test_service_loop_inserts_routes_and_rejects():
    """What the comparison above covers is not vacuous on the port's side:
    routed and unrouted requests, lookups, online insertions with
    ``/online`` origins, quota rejections and several shards."""
    waves = request_script(blob_bank(PORT)[1])
    bank, _ = blob_bank(PORT)
    size0 = len(bank)
    svc = SERVICES["two-shards-elastic-quota"](PORT, bank, cosine_factory(PORT))
    handles = [svc.submit(PORT.api.SubmitRequest(**f)) for reqs in waves for f in reqs]
    results = svc.run_until_idle()
    routed = [h for h in handles if h.routed_through_bank]
    assert routed and len(routed) < len(handles)
    assert all(h.bank_origin is not None and h.initial_prompt is not None for h in routed)
    assert all(h.bank_origin is None for h in handles if not h.routed_through_bank)
    assert any(h.rejected for h in handles) and {h.shard for h in handles} >= {0, 1}
    inserted = [r for r in results if r.inserted_to_bank]
    assert inserted and all(r.completed for r in inserted)
    # past its capacity of 64 the bank evicts (tombstones) one entry an insertion
    assert len(bank.entries) == size0 + len(inserted)
    assert len(bank) == min(size0 + len(inserted), bank.capacity)
    assert any(e.origin == "<evicted>" for e in bank.entries)
    # inserted in completion order; the results come in job order
    assert sorted(e.origin for e in bank.entries[size0:]) == \
        sorted(f"{r.handle.task_id}/online" for r in inserted)
    assert [r.handle.job_id for r in results] == sorted(r.handle.job_id for r in results)


def test_service_argument_errors_match_reference():
    for side in (REF, PORT):
        fab = side.c.ClusterFabric(side.c.SimConfig(max_gpus=8), "fifo", shards=2)
        with pytest.raises(ValueError, match="pass either fabric="):
            side.api.PromptTunerService(side.c.SimConfig(), fabric=fab)
        with pytest.raises(ValueError, match="quotas need an elastic fabric"):
            side.api.PromptTunerService().set_quota("t", side.c.TenantQuota())
        assert side.api.PromptTunerService.resolve_slo_class(None).name == "standard"
    assert sorted(port_api.__all__) == sorted(ref_api.__all__)


# -- Eqn-1 scorers on a gpt2-base smoke cut -----------------------------------------

P = 4


@pytest.fixture(scope="module")
def smoke_pair():
    """Both packages' gpt2-base smoke cuts with the same numpy weights, 24
    tasks, a prompt each with two variants, and the activation features of
    every candidate from both."""
    jmodel = build_model(jax_smoke_config("gpt2-base"))
    tree = numpy_params(jmodel, seed=3)
    model = Model(smoke_config("gpt2-base"), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    params = jax.tree.map(jnp.asarray, tree)
    jtasks, tasks = jax_make_tasks(vocab=32, partitions=2), make_tasks(vocab=32, partitions=2)
    rng = np.random.default_rng(5)
    d = model.cfg.d_model
    prompts, origins = [], []
    for t in tasks:
        base = rng.normal(0, 0.5 / np.sqrt(d), (P, d)).astype(np.float32)
        for v in range(2):
            prompts.append((base + v * 0.05 * rng.normal(0, 0.5 / np.sqrt(d), base.shape))
                           .astype(np.float32))
            origins.append(f"{t.task_id}/v{v}")
    stacked = np.stack(prompts)
    jfeat = np.asarray(jax_activation_features(jmodel, params, jnp.asarray(stacked)))
    probes = np.asarray(_probe_tokens(jmodel, 4, 9))
    feat = activation_features(model, stacked, probes=probes)
    return SimpleNamespace(pre=SimpleNamespace(model=jmodel, params=params), model=model,
                           jtasks={t.task_id: t for t in jtasks},
                           tasks={t.task_id: t for t in tasks}, prompts=prompts,
                           origins=origins, jfeat=jfeat, feat=feat)


def smoke_bank(side, sp):
    """The bank on the reference's features (K-medoids breaks near ties by
    rounding, so both packages cluster the same numbers)."""
    bank = side.pb.PromptBank(capacity=3000, num_clusters=12, seed=0)
    bank.add_candidates([side.pb.PromptEntry(p, f, o) for p, f, o in
                         zip(sp.prompts, sp.jfeat, sp.origins)])
    bank.build()
    return bank


def test_smoke_features_match_reference(smoke_pair):
    np.testing.assert_allclose(smoke_pair.feat, smoke_pair.jfeat, rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_service_with_eqn1_scorers_matches_reference(smoke_pair):
    """gpt2 smoke cut: the port's ``make_score_fn`` on the CPU against the
    reference's JAX one, through the two services (two shards, elastic).
    Both score each request's eval batch from the reference's loader (the
    two packages seed their loaders differently)."""
    sp = smoke_pair
    tc = dict(prompt_len=P, batch_size=8)
    loader = lambda tid: JTaskLoader(sp.jtasks[tid], JLoaderConfig(batch_size=8))
    factories = {
        "reference": lambda req: jax_make_score_fn(sp.pre, sp.jtasks[req.task_id],
                                                   JTuneConfig(**tc), loader(req.task_id)),
        "port": lambda req: make_score_fn(sp.model, sp.tasks[req.task_id], TuneConfig(**tc),
                                          loader(req.task_id)),
    }
    wave = [dict(task_id=tid, llm="gpt2-base", slo=slo, iters_manual=300, iters_bank=90,
                 tenant=tenant, slo_class=cls)
            for tid, slo, tenant, cls in (("copy:1", 300.0, "acme", "premium"),
                                          ("xor:0", 120.0, "globex", "standard"),
                                          ("shift:1", 600.0, "acme", "best-effort"),
                                          ("negate:0", 20.0, "globex", None))]
    # follow-ups carry a tuned prompt and its feature (here a bank prompt's)
    follow = [dict(w, prompt=sp.prompts[3 * i],
                   feature=sp.jfeat[3 * i], slo=400.0) for i, w in enumerate(wave[:2])]
    got = {}
    for side in (REF, PORT):
        bank = smoke_bank(side, sp)
        svc = side.api.PromptTunerService(side.c.SimConfig(max_gpus=16), bank=bank,
                                          score_fn_factory=factories[side.name], shards=2,
                                          elastic=side.c.ElasticConfig())
        size0 = len(bank)
        handles = [svc.submit(side.api.SubmitRequest(**f)) for f in wave + follow]
        results = svc.run_until_idle()
        inserted = [r.handle.task_id for r in results if r.inserted_to_bank]
        assert len(inserted) == len(follow) and len(bank) == size0 + len(follow)
        assert [e.origin for e in bank.entries[size0:]] == [f"{t}/online" for t in inserted]
        after = bank.lookup(factories[side.name](side.api.SubmitRequest(**wave[0])))
        got[side.name] = SimpleNamespace(
            scores=[h.bank_score for h in handles],
            handles=[plain(h.__class__(**{**vars(h), "bank_score": None})) for h in handles],
            results=[plain((r.gpus, r.start, r.finish, r.violated, r.used_bank,
                            r.inserted_to_bank)) for r in results],
            bank=plain((bank.entries, bank.clusters)), summary=svc.summary(),
            after=(after.entry.origin, after.score, after.evaluations))
    ref, port = got["reference"], got["port"]
    assert port.handles == ref.handles            # origins, prompts, routing, shards
    routed = [s for s in ref.scores if s is not None]
    assert len(routed) == len(wave) + len(follow) - 1
    np.testing.assert_allclose([s for s in port.scores if s is not None], routed,
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    assert [s is None for s in port.scores] == [s is None for s in ref.scores]
    assert port.results == ref.results and port.bank == ref.bank
    assert port.summary == ref.summary
    assert port.after[0] == ref.after[0] and port.after[2] == ref.after[2]
    np.testing.assert_allclose(port.after[1], ref.after[1], rtol=SCORE_TOL, atol=SCORE_TOL)
