"""Pure discrete-event cluster engine for LPT scheduling (§4.4, §6).

This module is the **mechanism** half of the policy/mechanism split:

* :class:`ClusterEngine` advances an event heap (arrivals / scheduler
  rounds / job completions) one :meth:`~ClusterEngine.step` at a time
  and accrues resource cost continuously as ``billed_gpus * dt * price``
  — globally and per tenant. It owns the pending queues, the per-LLM
  warm pools, the shared cold pool, and the billing and record-keeping —
  and contains **no system-specific scheduling logic**. Each processed
  event is also published to ``on_event`` subscribers as a typed
  :class:`EngineEvent` (service-level streaming).
* :class:`ResourceView` is the narrow API a
  :class:`~repro_torch.cluster.policies.SchedulingPolicy` sees each round:
  pending queues, warm pools, cold capacity, release timelines, and the
  ``start_job`` / ``warm_up`` / ``reclaim`` verbs. The view enforces the
  resource invariants (cold pool never negative, warm-pool accounting
  conserved) so a buggy policy fails loudly instead of corrupting state.

Systems (PromptTuner, INFless, ElasticFlow, ...) live in
``repro_torch.cluster.policies`` and are obtained via the string-keyed
registry::

    from repro_torch.cluster import policies
    engine = policies.build("prompttuner", SimConfig(max_gpus=32))
    result = engine.run(jobs)

Execution model (calibrated by §2.2's characterization):
    finish = start + alloc_overhead [+ bank_lookup] + iters * iter_time(g)
with near-linear scaling ``iter_time(g)`` from ``repro_torch.core.jobs`` (comm
is 0.4-0.5 % per extra replica — Fig 2a). Allocation is non-preemptive:
the GPU count is fixed at job start, matching Algorithms 1/2 which decide
allocations for *pending* jobs only. Scheduler rounds fire every
``round_interval`` seconds (paper §5.3: 50 ms rounds; the default here is
coarser purely to keep event counts small — results are insensitive below
~1 s because job durations are seconds-to-minutes).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

from repro_torch.core.jobs import (
    GPU_PRICE_PER_S,
    STORAGE_PRICE_PER_JOB_S,
    Job,
    JobPhase,
    SLOClass,
    exec_time,
    iter_time,
)

ARRIVAL, ROUND, JOB_DONE = "arrival", "round", "job_done"

# Ledger key for provisioned-but-not-busy capacity (idle / warming warm
# GPUs): billed globally, attributable to no single tenant.
SHARED_POOL = "(shared-pool)"


@dataclass(frozen=True)
class EngineEvent:
    """One observable engine transition, delivered to ``on_event``
    subscribers in simulated-time order.

    ``kind`` is one of :data:`ARRIVAL` (a job entered the pending
    queues), :data:`ROUND` (a scheduler round ran), :data:`JOB_DONE`
    (a job completed — exactly one per completed job). ``shard`` is 0
    for a bare engine; :class:`~repro_torch.cluster.fabric.ClusterFabric`
    rewrites it to the originating shard index when forwarding. The
    elastic control plane (:mod:`repro_torch.cluster.elastic`) additionally
    emits fabric-level kinds (job stolen / shard resized / job
    rejected), using ``detail`` for the human-readable specifics.
    """

    kind: str
    time: float
    job: Optional[Job] = None
    shard: int = 0
    detail: Optional[str] = None


def bank_fits_budget(cfg: "SimConfig", bank_lookup_s: float,
                     slo: float) -> bool:
    """§4.4.3 latency budget: route through the Prompt Bank only if its
    lookup latency fits within ``latency_budget_frac`` of the SLO. The
    single implementation shared by the engine and the service facade."""
    if not cfg.use_bank:
        return False
    if not cfg.use_latency_budget:
        return True                    # Table 8: bank for EVERY request
    return bank_lookup_s <= cfg.latency_budget_frac * slo


@dataclass
class SimConfig:
    max_gpus: int = 32                 # cold-pool size / cluster size
    round_interval: float = 0.5        # scheduler round period (s)
    reclaim_window: float = 60.0       # idle warm GPU -> cold after this (s)
    keep_alive: float = 60.0           # INFless instance keep-alive (s)
    price_per_gpu_s: float = GPU_PRICE_PER_S
    latency_budget_frac: float = 0.2   # §4.4.3
    use_bank: bool = True              # prompt reusing on/off (Fig 8a/b)
    use_warm: bool = True              # runtime reusing on/off
    use_warm_allocator: bool = True    # simultaneous multi-GPU alloc (Table 8)
    use_delay: bool = True             # DelaySchedulable on/off (Table 8)
    use_latency_budget: bool = True    # Table 8 'w/o Latency Budget'
    max_replicas_per_job: int = 16
    best_effort: bool = True           # run SLO-infeasible jobs when idle
    # Crash-aware checkpointing (None = off: durations are bit-identical
    # to a checkpoint-free engine, which is what the goldens pin). With
    # an interval, every `checkpoint_interval_s` of tuning compute pays
    # one `checkpoint_write_s`; a job resuming from checkpointed
    # progress (iters_done > 0) pays `checkpoint_restore_s` once.
    checkpoint_interval_s: Optional[float] = None
    checkpoint_write_s: float = 1.5
    checkpoint_restore_s: float = 4.0
    # Jobs whose remaining tuning compute is below this never checkpoint
    # (no writes, no crash credit): the write tax is paid by every job
    # up front while the credit only pays out for the few that actually
    # die mid-flight, so snapshotting short jobs is negative expected
    # value. 0.0 (default) checkpoints everything.
    checkpoint_min_compute_s: float = 0.0


@dataclass
class JobRecord:
    job: Job
    gpus: int
    used_bank: bool
    start: float
    finish: float
    violated: bool
    wait: float                        # queueing delay
    init_overhead: float               # allocation / instance-init share


@dataclass
class SimResult:
    records: List[JobRecord]
    cost: float
    gpu_seconds: float
    makespan: float
    util_samples: List[Tuple[float, float]] = field(default_factory=list)
    cost_by_tenant: Dict[str, float] = field(default_factory=dict)
    gpu_seconds_by_tenant: Dict[str, float] = field(default_factory=dict)

    @property
    def slo_violation(self) -> float:
        if not self.records:
            return 0.0
        return sum(r.violated for r in self.records) / len(self.records)

    def summary(self) -> Dict[str, float]:
        return {
            "jobs": len(self.records),
            "slo_violation_pct": 100.0 * self.slo_violation,
            "cost_usd": self.cost,
            "gpu_seconds": self.gpu_seconds,
            "makespan_s": self.makespan,
        }

    def summary_by_tenant(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant SLO/billing breakdown: the tenant's own jobs and
        violations plus its share of the cost/GPU-second ledgers (busy
        time at the tenant's price tier; the :data:`SHARED_POOL` row
        carries idle/warming capacity attributable to no tenant)."""
        per: Dict[str, List[JobRecord]] = {}
        for r in self.records:
            per.setdefault(r.job.tenant, []).append(r)
        tenants = set(per) | set(self.cost_by_tenant) | set(
            self.gpu_seconds_by_tenant)
        out: Dict[str, Dict[str, float]] = {}
        for t in sorted(tenants):
            recs = per.get(t, [])
            out[t] = {
                "jobs": len(recs),
                "slo_violation_pct": (
                    100.0 * sum(r.violated for r in recs) / len(recs)
                    if recs else 0.0),
                "cost_usd": self.cost_by_tenant.get(t, 0.0),
                "gpu_seconds": self.gpu_seconds_by_tenant.get(t, 0.0),
            }
        return out


class WarmPool:
    """Per-LLM warm GPU pool: idle (with idle-since), warming (ready-at),
    and busy counts. All GPUs in the pool are billed."""

    def __init__(self) -> None:
        self.idle: List[float] = []        # idle_since per idle GPU
        self.warming: List[float] = []     # ready_at (heap)
        self.busy: int = 0

    def total(self) -> int:
        return len(self.idle) + len(self.warming) + self.busy

    def take_idle(self, n: int) -> int:
        """Claim up to n idle GPUs; returns how many were claimed."""
        n = min(n, len(self.idle))
        # take the most recently idle ones (LIFO keeps cold candidates old)
        for _ in range(n):
            self.idle.pop()
        self.busy += n
        return n

    def release(self, n: int, now: float) -> None:
        self.busy -= n
        assert self.busy >= 0
        self.idle.extend([now] * n)

    def mature(self, now: float) -> None:
        """Move warming GPUs whose ready_at has passed into idle."""
        ready = [t for t in self.warming if t <= now + 1e-9]
        self.warming = [t for t in self.warming if t > now + 1e-9]
        self.idle.extend([now] * len(ready))

    def reclaim(self, now: float, window: float) -> int:
        """Return idle GPUs unused for `window` seconds to the cold pool."""
        keep = [t for t in self.idle if now - t < window]
        n = len(self.idle) - len(keep)
        self.idle = keep
        return n


class ResourceView:
    """The resource API a scheduling policy acts through.

    Read surface: ``now`` / ``cfg`` / ``cold_free`` / ``pending`` /
    ``pool`` / ``running`` / ``release_timeline`` / ``slo_remaining`` /
    ``slo_class_of`` / ``tenant_of`` / ``tenants`` / ``use_bank_for``.
    Write verbs: ``start_job``, ``warm_up``,
    ``claim_cold_busy``, ``return_cold``, ``release``,
    ``mature_and_reclaim``. The verbs assert the engine's resource
    invariants (cold pool non-negative, warm-pool counts conserved).
    """

    def __init__(self, engine: "ClusterEngine") -> None:
        self._e = engine

    # -- read surface --------------------------------------------------------

    @property
    def now(self) -> float:
        return self._e.now

    @property
    def cfg(self) -> SimConfig:
        return self._e.cfg

    @property
    def cold_free(self) -> int:
        return self._e.cold_free

    @property
    def pending(self) -> Dict[str, List[Job]]:
        """Live per-LLM pending queues. Policies admit a job by removing
        it from its queue and calling :meth:`start_job` (or by replacing
        the queue wholesale: ``view.pending[llm] = leftover``)."""
        return self._e.pending

    def pool(self, llm: str) -> WarmPool:
        return self._e.pool(llm)

    def pools(self) -> Dict[str, WarmPool]:
        return self._e.pools

    def running(self) -> Iterable[Tuple[Job, int]]:
        return self._e.running.values()

    def total_warm(self) -> int:
        return sum(p.total() for p in self._e.pools.values())

    def release_timeline(self, llm: str) -> List[float]:
        """E_l (§4.4 Algorithm 2): earliest timestamps at which each warm
        GPU of LLM ``llm`` becomes available — idle now, warming, or
        released by running jobs at their **actual scheduled completion
        events** (not a recomputed estimate, which can drift when the
        start paid a different allocation overhead)."""
        return self._e.release_timeline(llm)

    def slo_remaining(self, job: Job) -> float:
        return job.deadline - self._e.now

    def slo_class_of(self, job: Job) -> SLOClass:
        """The job's service class (priority / price tier / stringency) —
        the hook class-aware policies order admission by."""
        return job.slo_class

    def tenant_of(self, job: Job) -> str:
        return job.tenant

    def tenants(self) -> List[str]:
        """Tenants with work currently pending or running, sorted."""
        names = {j.tenant for q in self._e.pending.values() for j in q}
        names.update(j.tenant for j, _ in self._e.running.values())
        return sorted(names)

    def use_bank_for(self, job: Job) -> bool:
        return self._e.use_bank_for(job)

    def tenant_gpu_seconds(self, tenant: str) -> float:
        """Completed-work GPU-second ledger for ``tenant`` on this shard
        — the quota read a budget-aware policy orders admission by.
        (Fleet-wide enforcement, including in-flight commitments, lives
        in :class:`~repro_torch.cluster.elastic.ElasticController`.)"""
        return self._e.gpu_seconds_by_tenant.get(tenant, 0.0)

    def tenant_cost(self, tenant: str) -> float:
        """Completed-work billed cost for ``tenant`` on this shard (at
        the tenant's class price tier)."""
        return self._e.cost_by_tenant.get(tenant, 0.0)

    # -- write verbs ---------------------------------------------------------

    def start_job(self, job: Job, gpus: int, alloc_overhead: float,
                  used_bank: bool) -> None:
        """Commit a job to run on ``gpus`` GPUs starting now. The caller
        must already have claimed the GPUs (warm ``take_idle`` or a cold
        verb); the engine schedules the completion event and bills."""
        self._e.start_job(job, gpus, alloc_overhead, used_bank)

    def warm_up(self, llm: str, n: int, ready_in: float) -> None:
        """Grow ``llm``'s warm pool by ``n`` GPUs from the cold pool; they
        become idle (schedulable) after ``ready_in`` seconds."""
        if n > self._e.cold_free:
            raise ValueError(
                f"warm_up({llm}, {n}): only {self._e.cold_free} cold GPUs free")
        self._e.cold_free -= n
        self._e.pool(llm).warming.extend([self._e.now + ready_in] * n)

    def claim_cold_busy(self, llm: str, n: int) -> None:
        """Take ``n`` cold GPUs straight into ``llm``'s busy count (a cold
        start that skips the warming state; the job pays the cold
        overhead in its own execution time)."""
        if n > self._e.cold_free:
            raise ValueError(
                f"claim_cold_busy({llm}, {n}): only {self._e.cold_free} free")
        self._e.cold_free -= n
        self._e.pool(llm).busy += n

    def return_cold(self, llm: str, n: int) -> None:
        """Return ``n`` busy GPUs of ``llm`` directly to the cold pool
        (no warm reuse)."""
        p = self._e.pool(llm)
        if n > p.busy:
            raise ValueError(f"return_cold({llm}, {n}): only {p.busy} busy")
        p.busy -= n
        self._e.cold_free += n

    def release(self, llm: str, n: int) -> None:
        """Release ``n`` busy GPUs of ``llm`` into its warm-idle set."""
        self._e.pool(llm).release(n, self._e.now)

    def mature_and_reclaim(self, window: float) -> int:
        """Round upkeep: mature warming GPUs and reclaim those idle for
        >= ``window`` seconds back to the cold pool. Returns the number
        reclaimed."""
        total = 0
        for p in self._e.pools.values():
            p.mature(self._e.now)
            total += p.reclaim(self._e.now, window)
        self._e.cold_free += total
        return total


class ClusterEngine:
    """Event-driven cluster mechanism, driven by a pluggable policy.

    ``ClusterEngine(cfg, policy)`` is the canonical form. For backwards
    compatibility the engine can also be subclassed with ``_schedule``
    overridden (the pre-registry ``ClusterSim`` contract); the legacy
    hooks delegate to the policy when one is attached.
    """

    name = "base"

    def __init__(self, cfg: SimConfig, policy: Optional[Any] = None):
        self.cfg = cfg
        self.policy = policy
        if policy is not None and getattr(policy, "name", None):
            self.name = policy.name
        self.view = ResourceView(self)
        self.now = 0.0
        self._seq = itertools.count()
        self._events: List[Tuple[float, int, str, Any]] = []
        self.pending: Dict[str, List[Job]] = {}
        self.running: Dict[int, Tuple[Job, int]] = {}    # job_id -> (job, gpus)
        self._finish_at: Dict[int, float] = {}           # job_id -> scheduled done
        self.records: List[JobRecord] = []
        self.cost = 0.0
        self.gpu_seconds = 0.0
        self.cost_by_tenant: Dict[str, float] = {}
        self.gpu_seconds_by_tenant: Dict[str, float] = {}
        self.cold_free = cfg.max_gpus
        self.pools: Dict[str, WarmPool] = {}
        self.util_samples: List[Tuple[float, float]] = []
        self.outstanding_jobs = 0      # submitted, not yet recorded
        self._subscribers: List[Callable[[EngineEvent], None]] = []
        self._rounds_armed = 0         # ROUND events currently queued
        # fault-plane state: step-time multiplier (straggler) and the
        # per-running-job info needed to credit checkpoints at a crash
        self.speed = 1.0
        self._run_info: Dict[int, Dict[str, float]] = {}

    # -- event stream ---------------------------------------------------------

    def on_event(self, cb: Callable[[EngineEvent], None]) -> None:
        """Subscribe ``cb`` to the engine's event stream. It is called
        synchronously, in simulated-time order, with one
        :class:`EngineEvent` per ARRIVAL / ROUND / JOB_DONE transition
        (exactly one JOB_DONE per completed job)."""
        self._subscribers.append(cb)

    def _emit(self, kind: str, job: Optional[Job] = None) -> None:
        if not self._subscribers:
            return
        ev = EngineEvent(kind=kind, time=self.now, job=job)
        for cb in self._subscribers:
            cb(ev)

    # -- billing --------------------------------------------------------------

    def billed_gpus(self) -> int:
        """GPUs currently accruing cost. Default: all warm-pool GPUs."""
        if self.policy is not None:
            return self.policy.billed_gpus(self.view)
        return sum(p.total() for p in self.pools.values())

    def _advance(self, t: float) -> None:
        dt = t - self.now
        if dt > 0:
            g = self.billed_gpus()
            self.cost += g * dt * self.cfg.price_per_gpu_s
            self.gpu_seconds += g * dt
            self.now = t

    # -- event plumbing --------------------------------------------------------

    def _push(self, t: float, kind: str, payload: Any = None) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _push_round(self, t: float) -> None:
        self._rounds_armed += 1
        self._push(t, ROUND)

    def ensure_round(self, at: float) -> None:
        """Arm a scheduler round at ``at`` (clamped to now) if none is
        queued. Used by mid-run injection (:meth:`admit_at`): a drained
        engine's round chain has stopped, and without re-arming an
        injected job would sit in pending forever."""
        if self._rounds_armed == 0:
            self._push_round(max(at, self.now))

    def pool(self, llm: str) -> WarmPool:
        if llm not in self.pools:
            self.pools[llm] = WarmPool()
        return self.pools[llm]

    # -- job lifecycle ----------------------------------------------------------

    def use_bank_for(self, job: Job) -> bool:
        """§4.4.3 latency budget applied to one job."""
        return bank_fits_budget(self.cfg, job.profile().bank_lookup_s, job.slo)

    def release_timeline(self, llm: str) -> List[float]:
        """Earliest availability per warm GPU of ``llm``, ascending. Uses
        the actual JOB_DONE events the engine has scheduled for running
        jobs — the single source of truth for completion times."""
        pool = self.pool(llm)
        ts: List[float] = [self.now] * len(pool.idle)
        ts.extend(pool.warming)
        for job, gpus in self.running.values():
            if job.llm != llm:
                continue
            release = self._finish_at.get(job.job_id, self.now)
            ts.extend([max(release, self.now)] * gpus)
        return sorted(ts)

    def start_job(self, job: Job, gpus: int, alloc_overhead: float,
                  used_bank: bool) -> None:
        prof = job.profile()
        dur = exec_time(job, gpus, used_bank=used_bank,
                        alloc_overhead=alloc_overhead)
        overhead = alloc_overhead + (
            prof.bank_lookup_s if used_bank else 0.0
        )
        ckpt = self.cfg.checkpoint_interval_s
        ckpt_on = False
        if ckpt is not None:
            # crash-aware: restore once when resuming from checkpointed
            # progress, plus one write per completed checkpoint interval
            # of tuning compute (jobs too short to plausibly benefit are
            # exempt — see checkpoint_min_compute_s).
            if job.iters_done > 0:
                dur += self.cfg.checkpoint_restore_s
                overhead += self.cfg.checkpoint_restore_s
            compute_s = job.iters(used_bank) * iter_time(prof, gpus)
            ckpt_on = compute_s >= self.cfg.checkpoint_min_compute_s
            if ckpt_on:
                dur += int(compute_s // ckpt) * self.cfg.checkpoint_write_s
        if self.speed != 1.0:              # straggler multiplier
            dur *= self.speed
        job.phase = JobPhase.RUNNING
        job.start_time = self.now
        job.gpus = gpus
        job.used_bank = used_bank
        job.init_overhead = overhead
        self.running[job.job_id] = (job, gpus)
        self._finish_at[job.job_id] = self.now + dur
        self._run_info[job.job_id] = {
            "start": self.now,
            "iter_s": iter_time(prof, gpus),
            "used_bank": float(used_bank),
            "overhead_wall": overhead * self.speed,
            "speed": self.speed,
            "ckpt_on": float(ckpt_on),
        }
        self._push(self.now + dur, JOB_DONE, job)
        if gpus > prof.gpus_per_replica:   # multi-replica => storage channel
            self.cost += STORAGE_PRICE_PER_JOB_S * dur

    def _complete(self, job: Job) -> None:
        job.phase = JobPhase.DONE
        job.finish_time = self.now
        _, gpus = self.running.pop(job.job_id)
        self._finish_at.pop(job.job_id, None)
        self._run_info.pop(job.job_id, None)
        self.outstanding_jobs -= 1
        # Per-tenant ledger, alongside the global one. A job's GPU count
        # is fixed for its whole [start, finish] span, so the tenant's
        # busy share accrues once here (at the class price tier) instead
        # of taxing every _advance; result() derives the idle remainder
        # as the shared-pool row.
        dur = self.now - job.start_time
        if dur > 0:
            self.gpu_seconds_by_tenant[job.tenant] = (
                self.gpu_seconds_by_tenant.get(job.tenant, 0.0)
                + gpus * dur)
            self.cost_by_tenant[job.tenant] = (
                self.cost_by_tenant.get(job.tenant, 0.0)
                + gpus * dur * self.cfg.price_per_gpu_s
                * job.slo_class.price_tier)
        self._on_job_done(job, gpus)
        self.records.append(
            JobRecord(
                job=job,
                gpus=gpus,
                used_bank=job.used_bank,
                start=job.start_time,
                finish=self.now,
                violated=self.now > job.deadline + 1e-9,
                wait=job.start_time - job.submit_time,
                init_overhead=job.init_overhead,
            )
        )
        self._emit(JOB_DONE, job)

    # -- policy hooks (overridable by legacy subclasses) -------------------------

    def _on_job_done(self, job: Job, gpus: int) -> None:
        if self.policy is not None:
            self.policy.on_job_done(job, gpus, self.view)
        else:
            self.pool(job.llm).release(gpus, self.now)

    def _schedule(self) -> None:
        if self.policy is None:
            raise NotImplementedError("attach a SchedulingPolicy or "
                                      "override _schedule")
        self.policy.on_round(self.view)

    def _maintain(self) -> None:
        """Round upkeep: mature warming GPUs, reclaim idle ones."""
        if self.policy is not None:
            self.policy.maintain(self.view)
        else:
            self.view.mature_and_reclaim(self.cfg.reclaim_window)

    # -- main loop --------------------------------------------------------------------

    def submit(self, job: Job) -> None:
        """Enqueue an arrival (at its submit_time, or now if in the past).
        Takes effect on the next :meth:`run` / :meth:`step` cycle."""
        self.outstanding_jobs += 1
        self._push(max(job.submit_time, self.now), ARRIVAL, job)

    # -- elastic-mechanism verbs (used by the fabric control plane) ------------

    def admit_at(self, job: Job, at: float) -> None:
        """Inject ``job`` mid-run with an arrival at ``max(at, now)`` —
        the work-stealing requeue path. Unlike :meth:`submit` this also
        re-arms the scheduler-round chain: a drained engine would
        otherwise never look at its pending queue again."""
        self.outstanding_jobs += 1
        t = max(at, self.now)
        self._push(t, ARRIVAL, job)
        self.ensure_round(t)

    def extract_pending(self, job_id: int) -> Optional[Job]:
        """Remove and return a still-pending job (the donor half of a
        steal); ``None`` if the job is not pending here — already
        running, done, or still an undelivered arrival event."""
        for llm, queue in self.pending.items():
            for k, j in enumerate(queue):
                if j.job_id == job_id:
                    queue.pop(k)
                    self.outstanding_jobs -= 1
                    return j
        return None

    def cancel_running(self, job_id: int, at: float
                       ) -> Optional[Tuple[Job, int]]:
        """Kill a running job mid-flight (the graceful-degradation shed
        path): its GPUs release back to the warm pool immediately, the
        partial run is billed to its tenant, and the already-scheduled
        JOB_DONE event is lazily invalidated (:meth:`step` skips
        completions for jobs no longer running). The caller owns the
        terminal outcome — no JobRecord is appended here. Returns
        ``(job, gpus)``, or None if the job is not running."""
        if job_id not in self.running:
            return None
        t = max(at, self.now)
        self._advance(t)
        job, gpus = self.running.pop(job_id)
        self._finish_at.pop(job_id, None)
        self._run_info.pop(job_id, None)
        self.outstanding_jobs -= 1
        dur = t - job.start_time
        if dur > 0:
            self.gpu_seconds_by_tenant[job.tenant] = (
                self.gpu_seconds_by_tenant.get(job.tenant, 0.0)
                + gpus * dur)
            self.cost_by_tenant[job.tenant] = (
                self.cost_by_tenant.get(job.tenant, 0.0)
                + gpus * dur * self.cfg.price_per_gpu_s
                * job.slo_class.price_tier)
        self._on_job_done(job, gpus)
        return job, gpus

    def pending_jobs(self) -> List[Job]:
        """Every job currently in a pending queue (all LLMs)."""
        return [j for q in self.pending.values() for j in q]

    def queued_arrivals(self) -> List[Job]:
        """Jobs submitted but whose arrival event has not fired yet."""
        return [p for _, _, k, p in self._events if k == ARRIVAL]

    def finish_time_of(self, job_id: int) -> Optional[float]:
        """The scheduled completion time of a running job (None if the
        job is not running)."""
        return self._finish_at.get(job_id)

    def resize(self, new_max_gpus: int) -> int:
        """Grow or shrink this engine's fleet slice between scheduling
        rounds. Growth adds cold (free, unbilled) GPUs; shrinkage can
        only take cold GPUs — warm and busy capacity is never revoked,
        so ledgers and running jobs are untouched. Returns the actual
        new capacity (a shrink is clamped to the free cold pool). A
        negative target is a caller bug, rejected loudly."""
        if new_max_gpus < 0:
            raise ValueError(
                f"resize target must be >= 0 GPUs, got {new_max_gpus}")
        delta = new_max_gpus - self.cfg.max_gpus
        if delta >= 0:
            self.cold_free += delta
        else:
            take = min(-delta, self.cold_free)
            self.cold_free -= take
            delta = -take
        self.cfg.max_gpus += delta
        return self.cfg.max_gpus

    # -- fault-plane verbs (used by repro_torch.cluster.faults) ----------------------

    def _credit_checkpoint(self, job: Job, t: float, *,
                           final: bool = False) -> None:
        """Credit a killed job with the iterations its last completed
        checkpoint covers. Progress advances in whole checkpoint blocks:
        one block = ``checkpoint_interval_s`` of compute plus one write,
        both stretched by the shard's speed multiplier at start time.
        ``final=True`` models a snapshot flushed during a preemption
        warning lead: every completed iteration survives, not just the
        last periodic block."""
        info = self._run_info.get(job.job_id)
        ckpt = self.cfg.checkpoint_interval_s
        if info is None or ckpt is None or info["iter_s"] <= 0:
            return
        if not info.get("ckpt_on", 1.0):
            return
        block_wall = (ckpt + self.cfg.checkpoint_write_s) * info["speed"]
        work = t - info["start"] - info["overhead_wall"]
        if work <= 0 or block_wall <= 0:
            return
        if final:
            stalls = int(work // block_wall) * (
                self.cfg.checkpoint_write_s * info["speed"])
            compute = (work - stalls) / info["speed"]
            credit = int(compute / info["iter_s"])
        else:
            credit = int(int(work // block_wall) * ckpt / info["iter_s"])
        remaining = job.iters(bool(info["used_bank"]))
        job.iters_done += min(credit, remaining)

    def crash(self, at: float, *, final_snapshot: bool = False
              ) -> Tuple[List[Job], int]:
        """Fail this shard at ``at``: billing advances to the crash
        instant, every running job is killed (checkpointed progress
        credited onto ``job.iters_done``), pending jobs and undelivered
        arrivals are orphaned, all pools are dropped, and capacity goes
        to zero (a dead shard neither bills nor attracts placement).
        ``final_snapshot=True`` means the kill was announced (spot
        preemption warning) and the lead time flushed a last checkpoint,
        so running jobs keep all completed iterations. Returns
        ``(orphans, capacity_lost)``; the orphans still carry their
        runtime state so the fabric can emit lifecycle events before
        scrubbing them for requeue."""
        t = max(at, self.now)
        self._advance(t)
        orphans: List[Job] = []
        for job, _gpus in self.running.values():
            self._credit_checkpoint(job, t, final=final_snapshot)
            orphans.append(job)
        self.running.clear()
        self._finish_at.clear()
        self._run_info.clear()
        for q in self.pending.values():
            orphans.extend(q)
        self.pending.clear()
        orphans.extend(self.queued_arrivals())
        self._events.clear()
        self._rounds_armed = 0
        self.outstanding_jobs -= len(orphans)
        for p in self.pools.values():
            p.idle.clear()
            p.warming.clear()
            p.busy = 0
        lost = self.cfg.max_gpus
        self.cfg.max_gpus = 0
        self.cold_free = 0
        self.speed = 1.0
        return orphans, lost

    def restore(self, capacity: int, at: float) -> None:
        """Bring a crashed/preempted shard back with ``capacity`` cold
        GPUs at ``at``. Work re-enters via :meth:`admit_at`."""
        self._advance(max(at, self.now))
        self.cfg.max_gpus += capacity
        self.cold_free += capacity

    def set_speed(self, factor: float, at: float) -> None:
        """Apply a straggler step-time multiplier (> 1 is slower) to
        jobs started from ``at`` on. Already-running jobs keep their
        scheduled completions — the slowdown models degraded instances
        picking up new work, deterministically."""
        if factor <= 0:
            raise ValueError(f"speed factor must be > 0, got {factor}")
        self._advance(max(at, self.now))
        self.speed = factor

    def begin(self, jobs: Sequence[Job] = ()) -> None:
        """Submit ``jobs`` and arm the scheduler-round clock. Follow with
        :meth:`step` until it returns False, then :meth:`finish`."""
        for j in jobs:
            self.submit(j)
        self._push_round(self.now)

    def has_events(self) -> bool:
        return bool(self._events)

    def next_event_time(self) -> Optional[float]:
        """Timestamp of the next queued event (None when drained). Lets a
        fabric interleave several shards in global time order."""
        return self._events[0][0] if self._events else None

    def step(self) -> bool:
        """Process exactly one event (advance time, dispatch, notify
        subscribers). Returns False when the event heap is empty."""
        if not self._events:
            return False
        t, _, kind, payload = heapq.heappop(self._events)
        self._advance(t)
        if kind == ARRIVAL:
            if payload.profile().gpus_per_replica > self.cfg.max_gpus:
                # physically unschedulable on this fleet: no policy can
                # ever place it — record the violation immediately
                # instead of spinning rounds to the 24 h horizon
                self.records.append(
                    JobRecord(job=payload, gpus=0, used_bank=False,
                              start=float("inf"), finish=float("inf"),
                              violated=True, wait=float("inf"),
                              init_overhead=0.0)
                )
                self.outstanding_jobs -= 1
            else:
                self.pending.setdefault(payload.llm, []).append(payload)
            self._emit(ARRIVAL, payload)
        elif kind == JOB_DONE:
            # lazy invalidation: cancel_running leaves its stale
            # completion event in the heap
            if payload.job_id in self.running:
                self._complete(payload)
        elif kind == ROUND:
            self._rounds_armed -= 1
            self._maintain()
            self._schedule()
            self.util_samples.append(
                (self.now, sum(g for _, g in self.running.values()))
            )
            outstanding = (
                any(self.pending.values())
                or self.running
                or any(k == ARRIVAL for _, _, k, _ in self._events)
            )
            if outstanding and self.now < 24 * 3600:   # hard horizon
                self._push_round(self.now + self.cfg.round_interval)
            self._emit(ROUND)
        return True

    def finish(self) -> SimResult:
        """Close out a (possibly partial) run: anything still pending is
        recorded as an SLO violation, and the accumulated result is
        returned. Running again later continues from this state."""
        for q in self.pending.values():
            for j in q:
                self.records.append(
                    JobRecord(job=j, gpus=0, used_bank=False,
                              start=float("inf"), finish=float("inf"),
                              violated=True, wait=float("inf"),
                              init_overhead=0.0)
                )
                self.outstanding_jobs -= 1
            q.clear()
        return self.result()

    def result(self) -> SimResult:
        """The accumulated SimResult so far (no draining side effects).

        The shared-pool ledger row is derived here: whatever slice of
        the globally billed GPU-seconds is not attributed to a tenant's
        completed jobs — idle/warming warm capacity, a static cluster's
        slack, and (mid-run) still-running jobs whose busy time settles
        onto their tenant at completion."""
        gpu_bt = dict(self.gpu_seconds_by_tenant)
        cost_bt = dict(self.cost_by_tenant)
        shared_s = self.gpu_seconds - sum(gpu_bt.values())
        if shared_s > 1e-9:
            gpu_bt[SHARED_POOL] = shared_s
            cost_bt[SHARED_POOL] = shared_s * self.cfg.price_per_gpu_s
        return SimResult(
            records=self.records,
            cost=self.cost,
            gpu_seconds=self.gpu_seconds,
            makespan=self.now,
            util_samples=self.util_samples,
            cost_by_tenant=cost_bt,
            gpu_seconds_by_tenant=gpu_bt,
        )

    def run(self, jobs: Sequence[Job] = ()) -> SimResult:
        """Drive the event loop until no work is outstanding. May be
        called repeatedly (the service facade submits between calls);
        time and records accumulate monotonically."""
        self.begin(jobs)
        while self.step():
            pass
        return self.finish()


# Deprecated alias: the pre-registry base class. Subclass ClusterEngine
# (overriding _schedule) or, preferably, write a SchedulingPolicy.
ClusterSim = ClusterEngine
