"""SchedulingPolicy protocol + the string-keyed policy registry.

A policy is the **policy** half of the policy/mechanism split: it decides
*which* pending jobs get *how many* GPUs *when*, acting only through the
:class:`~repro_torch.cluster.engine.ResourceView` verbs. The engine owns all
state and billing.

Register a new system with the decorator::

    @register
    class MyPolicy(SchedulingPolicy):
        name = "mine"
        def on_round(self, view): ...

    engine = policies.build("mine", SimConfig())
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Type

from repro_torch.cluster.engine import ResourceView, SimConfig
from repro_torch.core.jobs import Job, exec_time


def admission_key(job: Job) -> Tuple[int, float]:
    """SLO-class-aware admission order: higher-priority service classes
    first, earliest deadline within a class. With a single class (all
    priorities equal) Python's stable sort makes this identical to pure
    EDF — which is what keeps the single-tenant goldens pinned."""
    return (-job.slo_class.priority, job.deadline)


def tenant_over_budget(view: ResourceView, job: Job, quota) -> bool:
    """Shard-local quota read: has ``job``'s tenant already burned its
    :class:`~repro_torch.cluster.elastic.TenantQuota` budget *on this shard's
    ledgers*? Policies can use this to deprioritize (or refuse) work
    for over-budget tenants inside a round. Fleet-wide enforcement —
    including in-flight commitments across every shard — happens at
    submit time in the :class:`~repro_torch.cluster.elastic.ElasticController`;
    this helper is the cheap, view-only approximation available to a
    policy that never sees beyond its own shard."""
    spent_s = view.tenant_gpu_seconds(job.tenant)
    if quota.gpu_seconds is not None and spent_s >= quota.gpu_seconds:
        return True
    spent_usd = view.tenant_cost(job.tenant)
    return quota.cost_usd is not None and spent_usd >= quota.cost_usd


def min_replicas_for_slo(job: Job, *, used_bank: bool, slo_rem: float,
                         max_rep: int, overhead: float) -> Tuple[int, bool]:
    """The admission loop shared by deadline-aware policies: the smallest
    replica count ``a`` in [1, max_rep] whose predicted completion
    (§4.4's upper bound, with a fixed allocation ``overhead``) fits the
    remaining SLO. Returns ``(a, feasible)``; when nothing fits, ``a``
    is ``max_rep`` and ``feasible`` is False. Caller ensures
    ``max_rep >= 1``."""
    prof = job.profile()
    a = 1
    while (exec_time(job, a * prof.gpus_per_replica, used_bank=used_bank,
                     alloc_overhead=overhead) > slo_rem and a < max_rep):
        a += 1
    feasible = exec_time(job, a * prof.gpus_per_replica, used_bank=used_bank,
                         alloc_overhead=overhead) <= slo_rem
    return a, feasible


class SchedulingPolicy:
    """Base policy: override :meth:`on_round`; the other hooks have
    sensible serverless defaults (warm-pool billing, release-to-warm on
    completion, reclaim after ``cfg.reclaim_window``)."""

    name = "base"

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg

    # -- required hook ---------------------------------------------------------

    def on_round(self, view: ResourceView) -> None:
        """Called every scheduler round, after :meth:`maintain`. Examine
        ``view.pending`` and start / warm up / delay jobs."""
        raise NotImplementedError

    # -- optional hooks --------------------------------------------------------

    def on_job_done(self, job: Job, gpus: int, view: ResourceView) -> None:
        """A job completed; decide where its GPUs go. Default: into the
        LLM's warm-idle set (runtime reuse)."""
        view.release(job.llm, gpus)

    def maintain(self, view: ResourceView) -> None:
        """Round upkeep before scheduling. Default: mature warming GPUs
        and reclaim those idle for >= ``cfg.reclaim_window`` seconds."""
        view.mature_and_reclaim(self.cfg.reclaim_window)

    def billed_gpus(self, view: ResourceView) -> int:
        """GPUs accruing cost right now. Default: every warm-pool GPU
        (idle, warming or busy) — serverless-style billing."""
        return view.total_warm()


_REGISTRY: Dict[str, Type[SchedulingPolicy]] = {}


def register(cls: Type[SchedulingPolicy]) -> Type[SchedulingPolicy]:
    """Class decorator: add ``cls`` to the registry under ``cls.name``."""
    key = cls.name
    if not key or key == "base":
        raise ValueError(f"{cls.__name__} needs a unique `name` attribute")
    _REGISTRY[key] = cls
    return cls


def get(name: str) -> Type[SchedulingPolicy]:
    """Look up a policy class by its registry key."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available() -> List[str]:
    return sorted(_REGISTRY)
