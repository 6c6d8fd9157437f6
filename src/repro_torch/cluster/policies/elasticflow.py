"""ElasticFlow [41] (§3, §6.1) — SLO-aware elastic DL *training* system:

  * a statically provisioned fixed-size cluster (all ``max_gpus`` billed
    for the whole experiment — Inefficiency 1),
  * deadline-ordered admission with minimum-satisfactory-share
    allocation (its core algorithm),
  * elastic (it can choose any GPU count), but every job start pays the
    cold bring-up: no runtime reuse across jobs.
"""
from __future__ import annotations

from typing import List

from repro_torch.cluster.engine import ResourceView, SimConfig
from repro_torch.cluster.policies.base import (
    SchedulingPolicy,
    min_replicas_for_slo,
    register,
)
from repro_torch.core.jobs import Job, exec_time


@register
class ElasticFlowPolicy(SchedulingPolicy):
    name = "elasticflow"

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg)
        self.free = cfg.max_gpus          # policy-local: static cluster share

    def billed_gpus(self, view: ResourceView) -> int:
        return self.cfg.max_gpus          # static provisioning: always billed

    def maintain(self, view: ResourceView) -> None:
        pass                              # no pools to mature/reclaim

    def on_job_done(self, job: Job, gpus: int, view: ResourceView) -> None:
        self.free += gpus

    def on_round(self, view: ResourceView) -> None:
        # global deadline order (ElasticFlow's admission control)
        all_pending: List[Job] = [j for q in view.pending.values() for j in q]
        all_pending.sort(key=lambda j: j.deadline)
        started = set()
        for job in all_pending:
            prof = job.profile()
            used_bank = view.use_bank_for(job)
            slo_rem = view.slo_remaining(job)
            max_rep = min(self.free // prof.gpus_per_replica,
                          self.cfg.max_replicas_per_job)
            if max_rep < 1:
                continue
            a, feasible = min_replicas_for_slo(
                job, used_bank=used_bank, slo_rem=slo_rem, max_rep=max_rep,
                overhead=prof.cold_overhead)
            g = a * prof.gpus_per_replica
            hopeless = exec_time(
                job, max_rep * prof.gpus_per_replica, used_bank=used_bank,
                alloc_overhead=prof.cold_overhead) > slo_rem
            if feasible or (hopeless and self.cfg.best_effort):
                if hopeless:
                    g = prof.gpus_per_replica     # best effort: min share
                self.free -= g
                # every start is a cold bring-up: no runtime reuse
                view.start_job(job, g, prof.cold_overhead, used_bank)
                started.add(job.job_id)
        for llm in view.pending:
            view.pending[llm] = [j for j in view.pending[llm]
                                 if j.job_id not in started]
