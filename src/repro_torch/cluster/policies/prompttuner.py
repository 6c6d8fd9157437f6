"""PromptTuner Workload Scheduler (§4.4) — Algorithms 1 & 2 as a policy.

Two-tier GPU pools: a single shared *cold* pool (free until claimed) and
per-LLM *warm* pools (pre-loaded runtime + weights; billed). Each round:

  1. **Algorithm 1** (warm allocation): sort pending jobs by service-
     class priority, then SLO ascending (single-class traces reduce to
     pure EDF); grow each job's allocation ``A_i`` until the predicted
     completion ``T_warm(A_i)`` fits the remaining SLO, then claim idle
     warm GPUs and start.
  2. **Algorithm 2** (cold allocation): for jobs Algorithm 1 could not
     satisfy, first try ``DelaySchedulable`` — can the job still meet its
     SLO by waiting for GPUs that running jobs will release (earliest-
     release list ``E_l``, taken from the engine's actual completion
     events)? Only if not, grow the warm pool from the cold pool, paying
     ``T_cold``.
  3. Reclaim warm GPUs idle for >= 60 s back to the cold pool (the
     default ``maintain`` hook).

The latency budget (§4.4.3) routes a job through the Prompt Bank only if
the bank's lookup latency fits in 20 % of the job's SLO.

Best-effort backstop (not in the paper's pseudocode, required for a
complete system): jobs whose SLO is already infeasible still execute with
one replica when warm GPUs would otherwise sit idle — users still get
their prompt back; the job simply counts as an SLO violation.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.cluster.engine import ResourceView
from repro_torch.cluster.policies.base import (
    SchedulingPolicy,
    admission_key,
    min_replicas_for_slo,
    register,
)
from repro_torch.core.jobs import Job, exec_time


@register
class PromptTunerPolicy(SchedulingPolicy):
    """The full PromptTuner system as a pluggable policy."""

    name = "prompttuner"

    # -- prediction -------------------------------------------------------------

    def _t_warm(self, job: Job, replicas: int, used_bank: bool) -> float:
        """T_i^warm(a): upper-bound completion estimate from a warm pool
        (§4.4: max remaining iterations x per-iteration time + warm
        allocation overhead [+ bank lookup])."""
        prof = job.profile()
        return exec_time(
            job,
            replicas * prof.gpus_per_replica,
            used_bank=used_bank,
            alloc_overhead=prof.warm_overhead,
        )

    # -- Algorithm 1: GPU allocation from a warm pool ------------------------------

    def _alg1_warm(self, view: ResourceView) -> List[Job]:
        """Allocate idle warm GPUs to pending jobs (SLO-ascending).
        Returns the jobs that could NOT be satisfied from warm pools."""
        unsatisfied: List[Job] = []
        for llm, queue in view.pending.items():
            if not queue:
                continue
            pool = view.pool(llm)
            prof = queue[0].profile()
            queue.sort(key=admission_key)
            leftover: List[Job] = []
            for job in queue:
                used_bank = view.use_bank_for(job)
                slo_rem = view.slo_remaining(job)
                r_l = len(pool.idle) // prof.gpus_per_replica
                a = 1
                while (self._t_warm(job, a, used_bank) > slo_rem
                       and a <= min(r_l, self.cfg.max_replicas_per_job) - 1):
                    a += 1
                feasible = (a <= r_l
                            and self._t_warm(job, a, used_bank) <= slo_rem)
                if feasible and self.cfg.use_warm:
                    took = pool.take_idle(a * prof.gpus_per_replica)
                    assert took == a * prof.gpus_per_replica
                    # Table 8 'w/o Warm Allocator': per-instance sequential
                    # connects instead of one simultaneous gang allocation
                    if self.cfg.use_warm_allocator:
                        overhead = prof.warm_overhead
                    else:
                        overhead = prof.warm_overhead * took
                    view.start_job(job, took, overhead, used_bank)
                else:
                    leftover.append(job)
                    unsatisfied.append(job)
            view.pending[llm] = leftover
        return unsatisfied

    # -- Algorithm 2: GPU allocation from the cold pool ------------------------------

    def _delay_schedulable(self, view: ResourceView, E_l: List[float],
                           job: Job) -> bool:
        """DelaySchedulable (Alg 2 lines 23-35): True if waiting for
        soon-to-be-released warm GPUs still meets the SLO. Mutates E_l to
        mark the claimed GPUs (so later jobs in this round see them as
        taken)."""
        if not self.cfg.use_delay:
            return False
        prof = job.profile()
        used_bank = view.use_bank_for(job)
        n = len(E_l)
        k = 1
        while k <= n // prof.gpus_per_replica:
            g = k * prof.gpus_per_replica
            avail_at = E_l[g - 1]            # k replicas available then
            finish = avail_at + self._t_warm(job, k, used_bank)
            if finish <= job.deadline:
                # claim: those GPUs release only after this job finishes
                for i in range(g):
                    E_l[i] = finish
                E_l.sort()
                return True
            k += 1
        return False

    def _alg2_cold(self, view: ResourceView, unsatisfied: List[Job]) -> None:
        """Grow warm pools from the cold pool for jobs that cannot be
        delayed (SLO-ascending)."""
        timelines: Dict[str, List[float]] = {}
        unsatisfied.sort(key=admission_key)
        for job in unsatisfied:
            llm = job.llm
            prof = job.profile()
            E_l = timelines.setdefault(llm, view.release_timeline(llm))
            if self._delay_schedulable(view, E_l, job):
                continue
            used_bank = view.use_bank_for(job)
            slo_rem = view.slo_remaining(job)
            t_cold = prof.cold_overhead
            max_rep = min(view.cold_free // prof.gpus_per_replica,
                          self.cfg.max_replicas_per_job)
            if max_rep < 1:
                continue
            a, feasible = min_replicas_for_slo(
                job, used_bank=used_bank, slo_rem=slo_rem, max_rep=max_rep,
                overhead=t_cold)
            if feasible:
                g = a * prof.gpus_per_replica
                view.warm_up(llm, g, t_cold)
                # the job stays pending; Algorithm 1 starts it once the
                # warm-up matures. Mark claims on the timeline.
                ready = view.now + t_cold
                finish = ready + self._t_warm(job, a, used_bank)
                E_l.extend([finish] * g)
                E_l.sort()

    # -- best-effort backstop ----------------------------------------------------------

    def _best_effort(self, view: ResourceView) -> None:
        if not self.cfg.best_effort:
            return
        for llm, queue in view.pending.items():
            if not queue:
                continue
            pool = view.pool(llm)
            prof = queue[0].profile()
            leftover: List[Job] = []
            for job in sorted(queue, key=admission_key):
                g = prof.gpus_per_replica
                # run hopeless jobs on idle warm GPUs (lowest priority)
                hopeless = (self._t_warm(job, self.cfg.max_replicas_per_job,
                                         False) > view.slo_remaining(job))
                if hopeless and len(pool.idle) >= g:
                    pool.take_idle(g)
                    view.start_job(job, g, prof.warm_overhead,
                                   view.use_bank_for(job))
                elif hopeless and view.cold_free >= g and not pool.warming:
                    # bring up minimal capacity for a starved LLM
                    view.warm_up(llm, g, prof.cold_overhead)
                    leftover.append(job)
                else:
                    leftover.append(job)
            view.pending[llm] = leftover

    # -- round ---------------------------------------------------------------------------

    def on_round(self, view: ResourceView) -> None:
        if not self.cfg.use_warm:
            # runtime-reuse ablation: every allocation is a cold start and
            # GPUs return to cold immediately on completion
            self._round_no_warm(view)
            return
        unsatisfied = self._alg1_warm(view)
        self._alg2_cold(view, unsatisfied)
        self._best_effort(view)

    # -- ablation: no runtime reusing (Fig 8a/b 'w/o R.R.') ---------------------------------

    def _round_no_warm(self, view: ResourceView) -> None:
        for llm, queue in view.pending.items():
            if not queue:
                continue
            prof = queue[0].profile()
            queue.sort(key=admission_key)
            leftover: List[Job] = []
            for job in queue:
                used_bank = view.use_bank_for(job)
                slo_rem = view.slo_remaining(job)
                max_rep = min(view.cold_free // prof.gpus_per_replica,
                              self.cfg.max_replicas_per_job)
                if max_rep < 1:
                    leftover.append(job)
                    continue
                a, feasible = min_replicas_for_slo(
                    job, used_bank=used_bank, slo_rem=slo_rem,
                    max_rep=max_rep, overhead=prof.cold_overhead)
                g = a * prof.gpus_per_replica
                if feasible or self.cfg.best_effort:
                    view.claim_cold_busy(llm, g)
                    view.start_job(job, g, prof.cold_overhead, used_bank)
                else:
                    leftover.append(job)
            view.pending[llm] = leftover

    def on_job_done(self, job: Job, gpus: int, view: ResourceView) -> None:
        if self.cfg.use_warm:
            view.release(job.llm, gpus)
        else:
            view.return_cold(job.llm, gpus)
