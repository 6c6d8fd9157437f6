"""Job model (Table 3), LLM execution profiles, and the cost model.

Times are seconds (floats, absolute sim time). An LPT job's execution time
with ``a`` GPUs is

    T_exec(a) = iters * iter_time(a) + overheads

where ``iter_time(a) = t1 / r * (1 + comm_frac * (r - 1))`` with
``r = a / gpus_per_replica`` — near-linear scaling, communication is
0.4-0.5 % of step time (paper Fig 2a). Tensor-parallel models allocate in
replica units (paper §6.2: LLaMA-30B/Qwen7B-R1 use 4-GPU replicas).

Cost model (§6.1): AWS p4de.24xlarge — 8xA100-80GB at ~$40.97/h
=> $5.12 per GPU-hour for every *provisioned* (warm or fixed-cluster)
GPU-second, plus a small storage/communication charge per multi-GPU job
(the Memcached/ElastiCache channel).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Optional

GPU_PRICE_PER_S = 40.97 / 8 / 3600.0        # $/GPU-second
STORAGE_PRICE_PER_JOB_S = 0.125 / 3600.0    # ElastiCache GB-hour sliver


@dataclass(frozen=True)
class LLMProfile:
    name: str
    iter_time_1replica: float      # seconds per LPT iteration on one replica
    cold_overhead: float           # container + runtime + weight load (s)
    warm_overhead: float           # connect instances / reuse runtime (s)
    gpus_per_replica: int = 1
    comm_frac: float = 0.005       # cross-GPU comm share per extra replica
    bank_lookup_s: float = 6.0     # Prompt Bank latency (Fig 10b: 5.3-9.2 s)


LLM_PROFILES: Dict[str, LLMProfile] = {
    "gpt2-base": LLMProfile("gpt2-base", 0.12, 12.0, 1.0, 1, bank_lookup_s=5.3),
    "gpt2-large": LLMProfile("gpt2-large", 0.30, 20.0, 1.5, 1, bank_lookup_s=6.1),
    "vicuna-7b": LLMProfile("vicuna-7b", 1.00, 45.0, 2.0, 1, bank_lookup_s=9.2),
    "llama-30b": LLMProfile("llama-30b", 2.50, 90.0, 3.0, 4, bank_lookup_s=12.0),
    "qwen7b-r1": LLMProfile("qwen7b-r1", 1.80, 60.0, 2.5, 4, bank_lookup_s=10.0),
}


class JobPhase(Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"


@dataclass(frozen=True)
class SLOClass:
    """A tenant-facing service class: how stringent the SLO is, what the
    tenant pays for it, and how the scheduler breaks admission ties.

    ``slo_multiplier`` scales the raw per-request SLO a tenant states
    (premium classes buy tighter deadlines than the trace's nominal
    duration-based SLO, best-effort classes relax them). ``price_tier``
    multiplies the base GPU price in the per-tenant ledger. ``priority``
    orders admission *between* classes (higher first); within a class
    the scheduler keeps its deadline order.
    """

    name: str = "standard"
    slo_multiplier: float = 1.0
    price_tier: float = 1.0
    priority: int = 0


DEFAULT_SLO_CLASS = SLOClass()

# A small catalogue of the classes the multi-tenant traces and
# benchmarks draw from; anything can construct ad-hoc classes too.
SLO_CLASSES: Dict[str, SLOClass] = {
    "premium": SLOClass("premium", slo_multiplier=0.75, price_tier=2.0,
                        priority=2),
    "standard": DEFAULT_SLO_CLASS,
    "best-effort": SLOClass("best-effort", slo_multiplier=1.5,
                            price_tier=0.5, priority=-1),
}

DEFAULT_TENANT = "default"


@dataclass
class Job:
    """One LPT request (Table 3)."""
    job_id: int
    llm: str
    submit_time: float
    slo: float                     # seconds from submit (deadline = submit+slo)
    iters_manual: int              # ITA with the user's manual initial prompt
    iters_bank: int                # ITA with the Prompt Bank's initial prompt
    max_iters: int = 10_000
    task_id: str = ""
    tenant: str = DEFAULT_TENANT
    slo_class: SLOClass = DEFAULT_SLO_CLASS
    # runtime state
    phase: JobPhase = JobPhase.PENDING
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    gpus: int = 0
    used_bank: bool = False
    init_overhead: float = 0.0     # allocation / instance-init share, set at start
    # fault-tolerance state (crash-aware recovery; see cluster/faults.py)
    iters_done: int = 0            # checkpointed progress surviving a crash
    restarts: int = 0              # times this job was orphaned and retried

    @property
    def deadline(self) -> float:
        return self.submit_time + self.slo

    def profile(self) -> LLMProfile:
        return LLM_PROFILES[self.llm]

    def iters(self, used_bank: bool) -> int:
        """Remaining iterations: the route's ITA minus checkpointed
        progress (``iters_done`` is 0 unless the job survived a crash)."""
        total = min(self.iters_bank if used_bank else self.iters_manual,
                    self.max_iters)
        return max(total - self.iters_done, 0)


def iter_time(profile: LLMProfile, gpus: int) -> float:
    replicas = max(gpus // profile.gpus_per_replica, 1)
    return (
        profile.iter_time_1replica / replicas
        * (1.0 + profile.comm_frac * (replicas - 1))
    )


def exec_time(
    job: Job, gpus: int, *, used_bank: bool, alloc_overhead: float
) -> float:
    """Upper-bound completion estimate (§4.4: max remaining iters x max
    per-iter time + allocation overhead [+ bank lookup])."""
    prof = job.profile()
    t = job.iters(used_bank) * iter_time(prof, gpus) + alloc_overhead
    if used_bank:
        t += prof.bank_lookup_s
    return t
