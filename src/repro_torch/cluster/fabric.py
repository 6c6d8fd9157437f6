"""Multi-tenant sharded cluster fabric.

A :class:`ClusterFabric` composes N independent :class:`ClusterEngine`
shards behind one submit/run surface — the ROADMAP's "sharded /
multi-cluster engines behind the same ``ResourceView``". Each shard is
a full engine with its own slice of the GPU fleet, its own warm/cold
pools, and its own policy instance, so every registered
:class:`~repro_torch.cluster.policies.SchedulingPolicy` runs unmodified per
shard.

Placement (which shard a submitted job lands on) is a pluggable layer
with its own string-keyed registry:

* ``llm-affinity`` (default) — jobs of the same LLM share a shard, so
  warm runtimes consolidate instead of fragmenting across the fleet;
* ``least-loaded`` — the shard with the least outstanding work at
  submit time (pending queue depth + committed running GPUs);
* ``hash`` — uniform stable hash of (tenant, job id): tenant-striped,
  placement-oblivious.

Execution interleaves the shards' event loops in **global simulated-time
order** (the shard with the earliest next event steps first), so an
``on_event`` subscriber observes one time-ordered stream across the
whole fabric, each event stamped with its shard index.

Golden equivalence: ``ClusterFabric(cfg, shards=1)`` is exactly one
``ClusterEngine(cfg)`` — same events, same float-for-float summaries —
which is what pins this layer to the pre-fabric behaviour in
``tests/test_fabric.py``.
"""
from __future__ import annotations

import zlib
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.cluster.elastic import (
    JOB_REJECTED,
    JOB_STOLEN,
    SHARD_RESIZED,
    ElasticConfig,
    ElasticController,
)
from repro_torch.cluster.engine import (
    ClusterEngine,
    EngineEvent,
    JobRecord,
    SimConfig,
    SimResult,
)
from repro_torch.cluster.faults import (
    FaultPlane,
    JOB_ORPHANED,
    JOB_RETRIED,
    JOB_SHED,
    SHARD_FAILED,
    SHARD_RECOVERED,
    SHARD_SLOWED,
    SHARD_WARNED,
)
from repro_torch.cluster.health import fleet_health
from repro_torch.core.jobs import Job, JobPhase

PlacementFn = Callable[[Job, Sequence[ClusterEngine]], int]

_PLACEMENTS: Dict[str, PlacementFn] = {}


def register_placement(name: str):
    """Decorator: add a ``(job, shards) -> shard_index`` strategy to the
    placement registry under ``name``."""

    def deco(fn: PlacementFn) -> PlacementFn:
        _PLACEMENTS[name] = fn
        return fn

    return deco


def placements() -> List[str]:
    return sorted(_PLACEMENTS)


def _stable_hash(s: str) -> int:
    # zlib.crc32 (not hash()): str hashing is salted per process, and
    # placement must be reproducible across runs.
    return zlib.crc32(s.encode("utf-8"))


@register_placement("llm-affinity")
def place_llm_affinity(job: Job, shards: Sequence[ClusterEngine]) -> int:
    """All jobs of one LLM land on one shard: warm pools consolidate,
    runtime reuse stays as effective as on a monolithic cluster."""
    return _stable_hash(job.llm) % len(shards)


@register_placement("least-loaded")
def place_least_loaded(job: Job, shards: Sequence[ClusterEngine]) -> int:
    """The shard with the least outstanding work at submit time:
    jobs submitted but not yet finished (queued arrivals included —
    placement happens before the event loop runs), normalized per
    shard GPU."""
    def load(e: ClusterEngine) -> float:
        return e.outstanding_jobs / max(e.cfg.max_gpus, 1)

    return min(range(len(shards)), key=lambda i: (load(shards[i]), i))


@register_placement("hash")
def place_hash(job: Job, shards: Sequence[ClusterEngine]) -> int:
    """Uniform stable hash of (tenant, job id)."""
    return _stable_hash(f"{job.tenant}/{job.job_id}") % len(shards)


def _merge_results(per_shard: List[SimResult]) -> SimResult:
    if len(per_shard) == 1:
        return per_shard[0]
    records = [r for res in per_shard for r in res.records]
    records.sort(key=lambda r: (r.job.submit_time, r.job.job_id))
    util: List = sorted(
        (s for res in per_shard for s in res.util_samples),
        key=lambda s: s[0])
    cost_by_tenant: Dict[str, float] = {}
    gpu_s_by_tenant: Dict[str, float] = {}
    for res in per_shard:
        for t, v in res.cost_by_tenant.items():
            cost_by_tenant[t] = cost_by_tenant.get(t, 0.0) + v
        for t, v in res.gpu_seconds_by_tenant.items():
            gpu_s_by_tenant[t] = gpu_s_by_tenant.get(t, 0.0) + v
    return SimResult(
        records=records,
        cost=sum(res.cost for res in per_shard),
        gpu_seconds=sum(res.gpu_seconds for res in per_shard),
        makespan=max(res.makespan for res in per_shard),
        util_samples=util,
        cost_by_tenant=cost_by_tenant,
        gpu_seconds_by_tenant=gpu_s_by_tenant,
    )


class ClusterFabric:
    """N engine shards behind one submit/run/stream surface.

    ``cfg.max_gpus`` is the fleet total; it is split as evenly as
    possible across shards (earlier shards absorb the remainder). With
    ``shards=1`` the fabric is a transparent wrapper over a single
    engine and reproduces its results exactly.
    """

    def __init__(
        self,
        cfg: Optional[SimConfig] = None,
        policy: str = "prompttuner",
        *,
        shards: int = 1,
        placement: str = "llm-affinity",
        elastic: Optional[Union[ElasticConfig, bool]] = None,
        faults: Optional[FaultPlane] = None,
    ):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        cfg = cfg or SimConfig()
        if cfg.max_gpus < shards:
            raise ValueError(
                f"cannot split {cfg.max_gpus} GPUs across {shards} shards")
        if placement not in _PLACEMENTS:
            raise KeyError(
                f"unknown placement {placement!r}; available: {placements()}")
        from repro_torch.cluster.policies import get as get_policy

        self.cfg = cfg
        self.policy_name = policy
        self.placement_name = placement
        self._place = _PLACEMENTS[placement]
        base, rem = divmod(cfg.max_gpus, shards)
        self.shards: List[ClusterEngine] = []
        self._subscribers: List[Callable[[EngineEvent], None]] = []
        for i in range(shards):
            shard_cfg = (cfg if shards == 1 else
                         replace(cfg, max_gpus=base + (1 if i < rem else 0)))
            self.shards.append(
                ClusterEngine(shard_cfg, get_policy(policy)(shard_cfg)))
            self._wire_shard(i)
        self.placed: Dict[int, int] = {}      # job_id -> shard index
        self.rejections: List[Tuple[Job, str]] = []   # quota-bounced jobs
        self._shed_records: List[JobRecord] = []      # fault-plane sheds
        self.controller: Optional[ElasticController] = None
        if elastic:
            self.controller = ElasticController(
                self, elastic if isinstance(elastic, ElasticConfig) else None)
        self.faults: Optional[FaultPlane] = None
        if faults is not None:
            self.faults = faults.attach(self)

    # -- streaming -----------------------------------------------------------

    def _wire_shard(self, i: int) -> None:
        """Register the one-and-only forwarding callback on shard ``i``.
        Called exactly once per shard, at shard creation: user
        subscriptions go through the fabric's own subscriber list, so
        subscribing at any time — and calling :meth:`run` repeatedly —
        never re-registers anything with an engine."""
        self.shards[i].on_event(
            lambda ev, _i=i: self._dispatch(replace(ev, shard=_i)))

    def _dispatch(self, ev: EngineEvent) -> None:
        for cb in list(self._subscribers):
            cb(ev)

    def announce(self, ev: EngineEvent) -> None:
        """Inject an externally-built event into the fabric-wide stream
        (delivered to every subscriber, exactly like an engine event).
        This is how stream-derived evaluators — the obs-layer
        ``AlertRules`` — publish typed ``alert_fired`` /
        ``alert_resolved`` events back onto the same bus the controller
        and telemetry already watch. ``_dispatch`` iterates a snapshot
        of the subscriber list, so announcing from inside a subscriber
        callback is safe."""
        self._dispatch(ev)

    def on_event(self, cb: Callable[[EngineEvent], None]) -> None:
        """Subscribe to the fabric-wide event stream (globally time-
        ordered; each event's ``shard`` is the originating shard).

        Subscribing any time after construction — before or between
        :meth:`run` calls — is the contract: delivery starts with the
        next processed event, each event is delivered exactly once per
        subscriber, and repeated ``run()`` calls never duplicate
        registrations. Besides the engine kinds (ARRIVAL / ROUND /
        JOB_DONE), an elastic fabric also emits ``job_stolen`` /
        ``shard_resized`` / ``job_rejected`` control-plane events."""
        self._subscribers.append(cb)

    # -- submit / run --------------------------------------------------------

    def submit(self, job: Job) -> int:
        """Place ``job`` on a shard and enqueue its arrival; returns the
        shard index, or ``-1`` if a tenant quota rejected the
        submission (recorded in :attr:`rejections` and emitted as a
        typed ``job_rejected`` event — the job is never placed and
        never billed). Placement only considers shards large enough for
        the job's replica unit — an uneven GPU split must not strand a
        fleet-feasible job on a too-small shard. If no shard can ever
        hold one replica the job is genuinely unschedulable and any
        shard may record the violation."""
        if self.controller is not None:
            reason = self.controller.admission_error(job)
            if reason is not None:
                self.rejections.append((job, reason))
                self.controller.rejections += 1
                if self.controller.audit is not None:
                    self.controller.audit.decision(
                        time=self.now, action=JOB_REJECTED, shard=-1,
                        job_id=job.job_id, tenant=job.tenant, detail=reason,
                        inputs={f"shard{h.shard}": h
                                for h in fleet_health(self.shards,
                                                      self.faults)})
                self._dispatch(EngineEvent(
                    kind=JOB_REJECTED, time=self.now, job=job, shard=-1,
                    detail=reason))
                return -1
        need = job.profile().gpus_per_replica
        eligible = [i for i, e in enumerate(self.shards)
                    if e.cfg.max_gpus >= need]
        if self.faults is not None:
            # avoid dead / preemption-warned / quarantined shards while
            # any healthy one remains (with none left, fall through to
            # the capacity-only list: queueing somewhere beats nowhere)
            healthy = [i for i in eligible if self.shard_admissible(i)]
            if healthy:
                eligible = healthy
        if eligible and len(eligible) < len(self.shards):
            sub = [self.shards[i] for i in eligible]
            k = self._place(job, sub)
            if not 0 <= k < len(sub):
                raise ValueError(
                    f"placement {self.placement_name!r} returned shard "
                    f"index {k} for job {job.job_id}, valid range is "
                    f"0..{len(sub) - 1}")
            i = eligible[k]
        else:
            i = self._place(job, self.shards)
            if not 0 <= i < len(self.shards):
                raise ValueError(
                    f"placement {self.placement_name!r} returned shard "
                    f"index {i} for job {job.job_id}, valid range is "
                    f"0..{len(self.shards) - 1}")
        self.placed[job.job_id] = i
        self.shards[i].submit(job)
        return i

    def run(self, jobs: Sequence[Job] = ()) -> SimResult:
        """Drive every shard until no work is outstanding, interleaving
        shard event loops in global time order, and return the merged
        fleet-wide :class:`SimResult`. Like ``ClusterEngine.run`` this
        may be called repeatedly; state accumulates."""
        for j in jobs:
            self.submit(j)
        for eng in self.shards:
            eng.begin()
        while True:
            live = [(eng.next_event_time(), i)
                    for i, eng in enumerate(self.shards) if eng.has_events()]
            ft = self.faults.next_time() if self.faults is not None else None
            if not live and ft is None:
                break
            if ft is not None and (not live or ft <= min(live)[0]):
                # fault-plane actions (injections, recoveries, retry
                # backoffs) fire at their exact simulated time, even
                # when every engine is idle
                self.faults.fire_next()
                continue
            _, i = min(live)
            self.shards[i].step()
        return self._final_result([eng.finish() for eng in self.shards])

    def _final_result(self, per_shard: List[SimResult]) -> SimResult:
        """Merge shard results plus any fault-plane shed records (each a
        terminal, violated outcome billed to no shard)."""
        if self._shed_records:
            per_shard = per_shard + [SimResult(
                records=list(self._shed_records), cost=0.0,
                gpu_seconds=0.0, makespan=0.0)]
        return _merge_results(per_shard)

    # -- elastic control-plane verbs -----------------------------------------

    def migrate(self, job_id: int, dst: int, *, at: Optional[float] = None
                ) -> bool:
        """Steal a still-pending job from its current shard onto ``dst``
        (placement-aware requeue): extracted from the donor's pending
        queue, re-admitted on ``dst`` with an arrival at the steal time,
        re-arming ``dst``'s round chain if it had drained. Returns False
        — with no state changed — if the job is not currently pending
        (already running/done) or ``dst`` cannot hold one replica.
        Emits a ``job_stolen`` event stamped with the receiving shard."""
        src = self.placed.get(job_id)
        if src is None or src == dst or not (0 <= dst < len(self.shards)):
            return False
        job_probe = None
        for j in self.shards[src].pending_jobs():
            if j.job_id == job_id:
                job_probe = j
                break
        if (job_probe is not None and
                job_probe.profile().gpus_per_replica
                > self.shards[dst].cfg.max_gpus):
            return False
        job = self.shards[src].extract_pending(job_id)
        if job is None:
            return False
        t = self.now if at is None else at
        self.placed[job_id] = dst
        self.shards[dst].admit_at(job, t)
        self._dispatch(EngineEvent(
            kind=JOB_STOLEN, time=t, job=job, shard=dst,
            detail=f"shard {src} -> {dst}"))
        return True

    def resize_shard(self, i: int, new_max_gpus: int, *,
                     at: Optional[float] = None) -> int:
        """Grow/shrink shard ``i``'s GPU slice (autoscaling hook).
        Shrinks only take free cold GPUs — warm pools, running jobs, and
        ledgers are untouched — so the returned actual capacity may be
        larger than requested. Emits a ``shard_resized`` event when the
        capacity changed. The fleet total is the caller's to conserve.
        A negative target raises ``ValueError`` (engine contract)."""
        eng = self.shards[i]
        before = eng.cfg.max_gpus
        after = eng.resize(new_max_gpus)
        if after != before:
            self._dispatch(EngineEvent(
                kind=SHARD_RESIZED, time=self.now if at is None else at,
                shard=i, detail=f"{before} -> {after} GPUs"))
        return after

    # -- fault-plane verbs (driven by repro_torch.cluster.faults.FaultPlane) --------

    def shard_admissible(self, i: int) -> bool:
        """May new/retried work be placed on shard ``i`` right now? No
        while the fault plane has it dead or preemption-warned, or the
        controller has it quarantined for flapping."""
        if self.faults is not None and not self.faults.placeable(i):
            return False
        if self.controller is not None and self.controller.is_quarantined(
                i, self.now):
            return False
        return True

    def fail_shard(self, i: int, at: float, *, reason: str = "crash",
                   final_snapshot: bool = False) -> Tuple[List[Job], int]:
        """Kill shard ``i`` at ``at``: the engine's :meth:`crash` credits
        checkpoints and returns the orphans; this layer emits the
        lifecycle events (``shard_failed`` + one ``job_orphaned`` per
        orphan, while the job still carries its runtime state so span
        folding can close truncated init/running spans), scrubs each
        orphan back to a pristine pending job, and hands it to the fault
        plane's retry scheduler."""
        orphans, lost = self.shards[i].crash(at, final_snapshot=final_snapshot)
        self._dispatch(EngineEvent(
            kind=SHARD_FAILED, time=at, shard=i,
            detail=f"{reason}: -{lost} GPUs, {len(orphans)} jobs orphaned"))
        for job in orphans:
            self._dispatch(EngineEvent(
                kind=JOB_ORPHANED, time=at, job=job, shard=i, detail=reason))
            self._scrub(job)
            self.placed.pop(job.job_id, None)
            if self.faults is not None:
                self.faults.on_orphaned(job, at)
        return orphans, lost

    def recover_shard(self, i: int, capacity: int, at: float) -> None:
        """Restore ``capacity`` cold GPUs to a failed shard at ``at``."""
        self.shards[i].restore(capacity, at)
        self._dispatch(EngineEvent(
            kind=SHARD_RECOVERED, time=at, shard=i,
            detail=f"+{capacity} GPUs restored"))

    def slow_shard(self, i: int, factor: float, at: float) -> None:
        """Apply (or clear, with ``factor=1.0``) a straggler step-time
        multiplier on shard ``i``."""
        self.shards[i].set_speed(factor, at)
        self._dispatch(EngineEvent(
            kind=SHARD_SLOWED, time=at, shard=i,
            detail=f"x{factor:g} step time"))

    def warn_shard(self, i: int, at: float, *, kill_at: float) -> None:
        """Announce a spot preemption of shard ``i`` (the lead-time
        window a failure-aware controller drains in)."""
        self._dispatch(EngineEvent(
            kind=SHARD_WARNED, time=at, shard=i,
            detail=f"spot preemption at t={kill_at:g}"))

    def requeue(self, job: Job, at: float, *, attempt: int = 1) -> bool:
        """Re-place an orphaned job through the fabric's placement at
        ``at``. Prefers admissible shards (alive, unwarned, not
        quarantined) but falls back to any shard with replica capacity;
        returns False — job untouched — only when no shard can hold one
        replica."""
        need = job.profile().gpus_per_replica
        eligible = [i for i, e in enumerate(self.shards)
                    if e.cfg.max_gpus >= need]
        healthy = [i for i in eligible if self.shard_admissible(i)]
        pool = healthy or eligible
        if not pool:
            return False
        sub = [self.shards[i] for i in pool]
        k = self._place(job, sub)
        i = pool[k] if 0 <= k < len(sub) else pool[0]
        job.restarts += 1
        self.placed[job.job_id] = i
        self.shards[i].admit_at(job, at)
        self._dispatch(EngineEvent(
            kind=JOB_RETRIED, time=at, job=job, shard=i,
            detail=f"attempt {attempt} -> shard {i}"))
        return True

    def shed_job(self, job: Job, at: float, reason: str) -> None:
        """Terminal failure outcome: record the job as violated (it will
        never run) and emit ``job_shed``. Exactly one terminal record
        per submitted job is the invariant the property tests pin."""
        self.placed.pop(job.job_id, None)
        self._shed_records.append(JobRecord(
            job=job, gpus=0, used_bank=False, start=float("inf"),
            finish=float("inf"), violated=True, wait=float("inf"),
            init_overhead=0.0))
        self._dispatch(EngineEvent(
            kind=JOB_SHED, time=at, job=job, shard=-1, detail=reason))

    def _scrub(self, job: Job) -> None:
        """Reset a killed job's runtime state so it re-enters placement
        as a pristine pending job (checkpointed ``iters_done`` and the
        ``restarts`` count survive — that is the recovery model)."""
        job.phase = JobPhase.PENDING
        job.start_time = None
        job.finish_time = None
        job.gpus = 0
        job.used_bank = False
        job.init_overhead = 0.0

    # -- introspection -------------------------------------------------------

    @property
    def now(self) -> float:
        """The fabric clock: the furthest-advanced shard."""
        return max(eng.now for eng in self.shards)

    @property
    def records(self):
        return ([r for eng in self.shards for r in eng.records]
                + list(self._shed_records))

    def result(self) -> SimResult:
        """Merged fleet-wide result so far (no draining side effects)."""
        return self._final_result([eng.result() for eng in self.shards])

    def summary(self) -> Dict[str, float]:
        return self.result().summary()

    def summary_by_tenant(self) -> Dict[str, Dict[str, float]]:
        return self.result().summary_by_tenant()
