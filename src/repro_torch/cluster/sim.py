"""Deprecated module kept for import compatibility.

The discrete-event mechanism now lives in :mod:`repro_torch.cluster.engine`
(:class:`ClusterEngine` + :class:`ResourceView`); the system-specific
scheduling logic lives in :mod:`repro_torch.cluster.policies`. ``ClusterSim``
remains as an alias of :class:`ClusterEngine` — legacy subclasses that
override ``_schedule`` keep working, but new systems should be written
as :class:`~repro_torch.cluster.policies.SchedulingPolicy` classes and built
via ``policies.build(name, cfg)``.
"""
from repro_torch.cluster.engine import (
    ARRIVAL,
    JOB_DONE,
    ROUND,
    ClusterEngine,
    ClusterSim,
    JobRecord,
    ResourceView,
    SimConfig,
    SimResult,
    WarmPool,
)

__all__ = [
    "ClusterEngine",
    "ClusterSim",
    "JobRecord",
    "ResourceView",
    "SimConfig",
    "SimResult",
    "WarmPool",
]
