"""PromptTunerService — the single front door tying the paper's pieces
together: Prompt Bank (§4.3) + latency-budget routing (§4.4.3) +
Workload Scheduler (§4.4) + online bank insertion (Fig 5b), now served
from a multi-tenant sharded :class:`~repro_torch.cluster.fabric.ClusterFabric`.

    service = PromptTunerService(SimConfig(max_gpus=32), bank=bank,
                                 score_fn_factory=my_scorer)
    handle = service.submit(SubmitRequest(task_id="t0", llm="gpt2-base",
                                          slo=120.0, iters_manual=400,
                                          iters_bank=120,
                                          tenant="acme",
                                          slo_class="premium"))
    service.stream(print)                # typed EngineEvent callbacks
    results = service.run_until_idle()
    service.summary_by_tenant()          # per-tenant SLO + billing

Per request the service:

1. resolves the tenant's service class (SLO multiplier / price tier /
   admission priority) and applies the class stringency to the SLO;
2. applies the §4.4.3 latency budget — the request is routed through the
   Prompt Bank only if the bank's lookup latency fits in
   ``latency_budget_frac`` of its effective SLO;
3. if routed (and a bank + scorer are attached), performs the two-layer
   lookup to pick the initial prompt, recording its origin and Eqn-1
   score on the handle;
4. places the job on a fabric shard and hands it to that shard's
   scheduling policy (any registry name — the facade is policy-agnostic);
5. on completion, inserts the freshly tuned prompt into the bank by
   feature similarity — no score evaluations (Fig 5b) — so later
   requests benefit from this request's tuning work.

The scorer is a factory ``score_fn_factory(request) -> (entry -> float)``
because Eqn-1 scores are computed against the *request's* eval set; the
bank itself stays agnostic to how scores are produced.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Union

import numpy as np

from repro_torch.cluster.engine import (
    ClusterEngine,
    EngineEvent,
    SimConfig,
    SimResult,
    bank_fits_budget,
)
from repro_torch.cluster.elastic import ElasticConfig, TenantQuota
from repro_torch.cluster.fabric import ClusterFabric
from repro_torch.cluster.faults import FaultPlane
from repro_torch.core.jobs import (
    DEFAULT_SLO_CLASS,
    LLM_PROFILES,
    SLO_CLASSES,
    Job,
    SLOClass,
)
from repro_torch.core.prompt_bank import PromptBank, PromptEntry
from repro_torch.obs import Telemetry

from repro_torch.api.types import JobHandle, JobResult, SubmitRequest

ScoreFn = Callable[[PromptEntry], float]


class PromptTunerService:
    """Facade over fabric + policy + bank. ``policy`` is any registry
    name (``prompttuner`` by default), so baselines and new policies get
    the same front door for free. Pass a pre-built ``fabric`` to serve
    from several shards, or ``shards=``/``placement=`` to have the
    service build one; the default is a single-shard fabric, which is
    float-for-float identical to the pre-fabric engine.

    ``telemetry=True`` (or an un-attached :class:`repro_torch.obs.Telemetry`)
    wires the fleet telemetry plane into the fabric: handles gain
    ``.timeline()``, and ``service.telemetry`` exposes the metrics
    registry, audit log, ``report()`` and trace exports. Recording rides
    the event stream only, so results are identical with it on or off."""

    def __init__(
        self,
        cfg: Optional[SimConfig] = None,
        *,
        policy: Optional[str] = None,
        bank: Optional[PromptBank] = None,
        score_fn_factory: Optional[Callable[[SubmitRequest], ScoreFn]] = None,
        fabric: Optional[ClusterFabric] = None,
        shards: Optional[int] = None,
        placement: Optional[str] = None,
        elastic: Optional[ElasticConfig] = None,
        faults: Optional[FaultPlane] = None,
        telemetry: Optional[Union[bool, Telemetry]] = None,
    ):
        if fabric is not None:
            conflicting = [name for name, given in [
                ("cfg", cfg), ("policy", policy), ("shards", shards),
                ("placement", placement), ("elastic", elastic),
                ("faults", faults),
            ] if given is not None]
            if conflicting:
                raise ValueError(
                    f"pass either fabric= or {conflicting} — a pre-built "
                    "fabric already fixes cfg/policy/shards/placement/"
                    "elastic/faults")
            self.fabric = fabric
            self.cfg = fabric.cfg
            self.policy_name = fabric.policy_name
        else:
            self.cfg = cfg or SimConfig()
            self.policy_name = policy or "prompttuner"
            self.fabric = ClusterFabric(
                self.cfg, self.policy_name, shards=shards or 1,
                placement=placement or "llm-affinity", elastic=elastic,
                faults=faults)
        if telemetry is None or telemetry is False:
            self.telemetry: Optional[Telemetry] = None
        else:
            self.telemetry = (Telemetry() if telemetry is True
                              else telemetry)
            if not self.telemetry.attached:
                self.telemetry.attach(self.fabric)
            elif self.telemetry._fabric is not self.fabric:
                raise ValueError(
                    "telemetry= is already attached to a different fabric; "
                    "use one Telemetry per fabric")
        self.bank = bank
        self.score_fn_factory = score_fn_factory
        self._handles: Dict[int, JobHandle] = {}
        self._requests: Dict[int, SubmitRequest] = {}
        self._reported: Set[int] = set()
        self._next_id = 0

    @property
    def engine(self) -> ClusterEngine:
        """The first fabric shard (back-compat with the pre-fabric,
        single-engine service surface)."""
        return self.fabric.shards[0]

    # -- service classes ---------------------------------------------------------

    @staticmethod
    def resolve_slo_class(slo_class) -> SLOClass:
        """None -> standard; a catalogue name -> its class; an SLOClass
        passes through."""
        if slo_class is None:
            return DEFAULT_SLO_CLASS
        if isinstance(slo_class, SLOClass):
            return slo_class
        try:
            return SLO_CLASSES[slo_class]
        except KeyError:
            raise KeyError(f"unknown SLO class {slo_class!r}; "
                           f"known: {sorted(SLO_CLASSES)}") from None

    # -- §4.4.3 latency budget -------------------------------------------------

    def route_through_bank(self, req: SubmitRequest) -> bool:
        """Would this request's bank lookup fit in its latency budget?
        (The same predicate the scheduler applies to the job — shared
        implementation, so handle and record can never disagree.)"""
        cls = self.resolve_slo_class(req.slo_class)
        return bank_fits_budget(
            self.cfg, LLM_PROFILES[req.llm].bank_lookup_s,
            req.slo * cls.slo_multiplier)

    # -- front door ------------------------------------------------------------

    def submit(self, req: SubmitRequest) -> JobHandle:
        """Admit one request: resolve its service class, route, look up
        an initial prompt if routed, and place the tuning job on a
        fabric shard for the next ``run_until_idle``."""
        if req.llm not in LLM_PROFILES:
            raise KeyError(f"unknown LLM {req.llm!r}; "
                           f"known: {sorted(LLM_PROFILES)}")
        cls = self.resolve_slo_class(req.slo_class)
        effective_slo = float(req.slo) * cls.slo_multiplier
        submitted_at = (self.fabric.now if req.submit_time is None
                        else float(req.submit_time))
        routed = self.route_through_bank(req)
        origin = score = init_prompt = None
        if routed and self.bank is not None and self.score_fn_factory is not None:
            lookup = self.bank.lookup(self.score_fn_factory(req))
            origin, score = lookup.entry.origin, lookup.score
            init_prompt = lookup.entry.prompt
        job_id = self._next_id
        self._next_id += 1
        job = Job(
            job_id=job_id,
            llm=req.llm,
            submit_time=submitted_at,
            slo=effective_slo,
            iters_manual=req.iters_manual,
            iters_bank=req.iters_bank,
            max_iters=req.max_iters,
            task_id=req.task_id,
            tenant=req.tenant,
            slo_class=cls,
        )
        shard = self.fabric.submit(job)
        rejected = shard < 0
        reason = self.fabric.rejections[-1][1] if rejected else None
        handle = JobHandle(
            job_id=job_id,
            task_id=req.task_id,
            llm=req.llm,
            submitted_at=submitted_at,
            routed_through_bank=routed,
            tenant=req.tenant,
            slo_class=cls.name,
            shard=shard,
            effective_slo=effective_slo,
            bank_origin=origin,
            bank_score=score,
            initial_prompt=init_prompt,
            rejected=rejected,
            reject_reason=reason,
            telemetry=self.telemetry,
        )
        if not rejected:
            self._handles[job_id] = handle
            self._requests[job_id] = req
        return handle

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        """Attach/replace a tenant's admission quota. Requires an
        elastic fabric (``elastic=ElasticConfig(...)`` or a pre-built
        fabric with a controller)."""
        if self.fabric.controller is None:
            raise ValueError(
                "quotas need an elastic fabric: pass elastic=ElasticConfig() "
                "(or a fabric built with one)")
        self.fabric.controller.set_quota(tenant, quota)

    def run_until_idle(self) -> List[JobResult]:
        """Drive every fabric shard until no submitted work is
        outstanding. Returns a JobResult per job not yet reported,
        inserting freshly tuned prompts into the bank (Fig 5b) as their
        jobs finish."""
        self.fabric.run()
        out: List[JobResult] = []
        for rec in self.fabric.records:
            jid = rec.job.job_id
            if jid in self._reported or jid not in self._handles:
                continue
            self._reported.add(jid)
            req = self._requests[jid]
            inserted = False
            if (self.bank is not None and np.isfinite(rec.finish)
                    and req.prompt is not None and req.feature is not None):
                self.bank.insert(PromptEntry(
                    prompt=np.asarray(req.prompt),
                    feature=np.asarray(req.feature),
                    origin=f"{req.task_id}/online",
                ))
                inserted = True
            out.append(JobResult(
                handle=self._handles[jid],
                gpus=rec.gpus,
                start=rec.start,
                finish=rec.finish,
                violated=rec.violated,
                wait=rec.wait,
                used_bank=rec.used_bank,
                init_overhead=rec.init_overhead,
                inserted_to_bank=inserted,
                retries=rec.job.restarts,
            ))
        out.sort(key=lambda r: r.handle.job_id)
        return out

    # -- streaming ---------------------------------------------------------------

    def stream(self, cb: Callable[[EngineEvent], None]) -> None:
        """Subscribe ``cb`` to the fabric-wide event stream: one typed
        :class:`EngineEvent` per ARRIVAL / ROUND / JOB_DONE, in global
        simulated-time order, stamped with the originating shard."""
        self.fabric.on_event(cb)

    # -- introspection -----------------------------------------------------------

    @property
    def now(self) -> float:
        return self.fabric.now

    def sim_result(self) -> SimResult:
        """The merged fleet-wide SimResult so far — including
        ``util_samples`` and the per-tenant ledgers (nothing is dropped
        in the re-wrap)."""
        return self.fabric.result()

    def summary(self) -> Dict[str, float]:
        """Aggregate SLO/cost summary over everything run so far."""
        return self.sim_result().summary()

    def summary_by_tenant(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant jobs / SLO violations / billed cost / GPU-seconds
        over everything run so far."""
        return self.sim_result().summary_by_tenant()

    def report(self, **kw) -> str:
        """The telemetry plane's SLO-attainment / queue-depth time-series
        report (requires ``telemetry=``)."""
        if self.telemetry is None:
            raise ValueError("no telemetry recorded: construct the service "
                             "with telemetry=True (or a Telemetry instance)")
        return self.telemetry.report(**kw)

    def forensics_report(self):
        """Per-violation blame attribution rolled up fleet-wide — a
        :class:`repro_torch.obs.forensics.ForensicsReport` answering *why*
        each violated/shed job missed its SLO (requires
        ``telemetry=``)."""
        if self.telemetry is None:
            raise ValueError("no telemetry recorded: construct the service "
                             "with telemetry=True (or a Telemetry instance)")
        return self.telemetry.forensics()
