"""Per-shard pressure signals for the elastic control plane.

A :class:`ShardHealth` is an immutable snapshot of one
:class:`~repro_torch.cluster.engine.ClusterEngine` shard, computed between
scheduling rounds: queue depth and GPU demand of the pending queues,
committed (running) GPUs, free warm/cold capacity, and projected
deadline slack. :func:`fleet_health` snapshots every shard of a fabric
at once so the :class:`~repro_torch.cluster.elastic.ElasticController` can
compare shards on a consistent basis.

The headline signal is ``pressure`` — outstanding GPU demand (pending +
running) normalized by shard capacity. ``pressure > 1`` means the shard
cannot serve its queue even if everything it owns were free;
sustained high pressure next to idle neighbours is exactly the
imbalance the paper's elastic Workload Scheduler removes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.cluster.engine import ClusterEngine
from repro_torch.core.jobs import exec_time


@dataclass(frozen=True)
class ShardHealth:
    """One shard's load/capacity snapshot at ``now``."""

    shard: int
    now: float
    gpus: int                  # shard capacity (cfg.max_gpus)
    cold_free: int             # free cold GPUs (unbilled)
    warm_idle: int             # idle warm GPUs across all LLM pools
    warm_total: int            # idle + warming + busy warm GPUs
    running_gpus: int          # GPUs committed to running jobs
    pending_jobs: int          # jobs sitting in pending queues
    pending_gpu_demand: int    # sum of one-replica GPU needs over pending
    late_pending: int          # pending jobs whose best-case finish misses SLO
    min_slack: float           # tightest projected deadline slack (inf if idle)
    # failure-plane signals (defaults describe a fault-free shard)
    alive: bool = True         # False once the fault plane killed the shard
    draining: bool = False     # inside a spot-preemption warning window
    recent_failures: int = 0   # crash/preempt count in the flap window

    @property
    def pressure(self) -> float:
        """Outstanding GPU demand per owned GPU. > 1: over-committed."""
        return (self.pending_gpu_demand + self.running_gpus) / max(self.gpus, 1)

    @property
    def free_capacity(self) -> int:
        """GPUs a newly placed job could claim this round (cold + idle
        warm), net of the demand already queued here."""
        return self.cold_free + self.warm_idle - self.pending_gpu_demand


def projected_slack(engine: ClusterEngine, job) -> float:
    """Projected deadline slack if ``job`` started *now* on one warm
    replica: ``deadline - now - T_warm(1)``. Negative means the shard
    can no longer meet the SLO without multi-replica catch-up."""
    prof = job.profile()
    t = exec_time(job, prof.gpus_per_replica,
                  used_bank=engine.use_bank_for(job),
                  alloc_overhead=prof.warm_overhead)
    return job.deadline - engine.now - t


def shard_health(engine: ClusterEngine, shard: int = 0,
                 faults=None, *, flap_window: float = 300.0) -> ShardHealth:
    """Snapshot one engine shard's pressure signals. Pass the fabric's
    :class:`~repro_torch.cluster.faults.FaultPlane` to fill the failure
    signals (alive / draining / recent failure count); without one the
    snapshot describes a fault-free shard."""
    warm_idle = sum(len(p.idle) for p in engine.pools.values())
    warm_total = sum(p.total() for p in engine.pools.values())
    running_gpus = sum(g for _, g in engine.running.values())
    demand = 0
    late = 0
    min_slack = float("inf")
    n_pending = 0
    for queue in engine.pending.values():
        for job in queue:
            n_pending += 1
            demand += job.profile().gpus_per_replica
            slack = projected_slack(engine, job)
            min_slack = min(min_slack, slack)
            if slack < 0.0:
                late += 1
    return ShardHealth(
        shard=shard,
        now=engine.now,
        gpus=engine.cfg.max_gpus,
        cold_free=engine.cold_free,
        warm_idle=warm_idle,
        warm_total=warm_total,
        running_gpus=running_gpus,
        pending_jobs=n_pending,
        pending_gpu_demand=demand,
        late_pending=late,
        min_slack=min_slack,
        alive=faults is None or not faults.is_down(shard),
        draining=faults is not None and shard in faults.warned,
        recent_failures=(0 if faults is None else
                         faults.recent_failures(shard, engine.now,
                                                flap_window)),
    )


def fleet_health(shards: Sequence[ClusterEngine],
                 faults=None) -> List[ShardHealth]:
    """One :class:`ShardHealth` per shard, in shard order."""
    return [shard_health(eng, i, faults) for i, eng in enumerate(shards)]
