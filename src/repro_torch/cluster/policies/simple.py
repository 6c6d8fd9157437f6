"""Cheap reference baselines the registry makes nearly free to add.

**FIFO** — the naive serverless strawman: per-LLM FIFO order, one replica
per job, no SLO awareness. Reuses warm GPUs when idle ones exist
(paying the warm connect) and cold-starts otherwise; completed jobs
release into the warm pool and idle GPUs are reclaimed after the default
window. A floor for every SLO-aware system.

**EDF-cold** — classic earliest-deadline-first admission over a cold pool
only: globally deadline-sorted, minimum GPU share that meets the SLO
assuming a cold bring-up, GPUs returned straight to the cold pool on
completion (no runtime reuse, but also no idle billing). Isolates the
value of PromptTuner's warm pools: EDF-cold has the same admission
urgency-ordering but pays every bring-up.
"""
from __future__ import annotations

from typing import List

from repro_torch.cluster.engine import ResourceView
from repro_torch.cluster.policies.base import (
    SchedulingPolicy,
    min_replicas_for_slo,
    register,
)
from repro_torch.core.jobs import Job


@register
class FIFOPolicy(SchedulingPolicy):
    name = "fifo"

    def on_round(self, view: ResourceView) -> None:
        for llm, queue in view.pending.items():
            if not queue:
                continue
            pool = view.pool(llm)
            prof = queue[0].profile()
            queue.sort(key=lambda j: j.submit_time)
            leftover: List[Job] = []
            for job in queue:
                g = prof.gpus_per_replica
                used_bank = view.use_bank_for(job)
                if len(pool.idle) >= g:
                    pool.take_idle(g)
                    view.start_job(job, g, prof.warm_overhead, used_bank)
                elif view.cold_free >= g:
                    view.claim_cold_busy(llm, g)
                    view.start_job(job, g, prof.cold_overhead, used_bank)
                else:
                    leftover.append(job)
            view.pending[llm] = leftover


@register
class EDFColdPolicy(SchedulingPolicy):
    name = "edf-cold"

    def maintain(self, view: ResourceView) -> None:
        pass                               # nothing warms or idles

    def on_job_done(self, job: Job, gpus: int, view: ResourceView) -> None:
        view.return_cold(job.llm, gpus)    # no runtime reuse

    def on_round(self, view: ResourceView) -> None:
        all_pending: List[Job] = [j for q in view.pending.values() for j in q]
        all_pending.sort(key=lambda j: j.deadline)
        started = set()
        for job in all_pending:
            prof = job.profile()
            used_bank = view.use_bank_for(job)
            slo_rem = view.slo_remaining(job)
            max_rep = min(view.cold_free // prof.gpus_per_replica,
                          self.cfg.max_replicas_per_job)
            if max_rep < 1:
                continue
            a, feasible = min_replicas_for_slo(
                job, used_bank=used_bank, slo_rem=slo_rem, max_rep=max_rep,
                overhead=prof.cold_overhead)
            g = a * prof.gpus_per_replica
            if not feasible:
                if not self.cfg.best_effort:
                    continue
                g = prof.gpus_per_replica  # best effort: min share
            view.claim_cold_busy(job.llm, g)
            view.start_job(job, g, prof.cold_overhead, used_bank)
            started.add(job.job_id)
        for llm in view.pending:
            view.pending[llm] = [j for j in view.pending[llm]
                                 if j.job_id not in started]
