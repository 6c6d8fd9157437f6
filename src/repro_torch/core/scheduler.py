"""Deprecated shim for the PromptTuner Workload Scheduler (§4.4).

Algorithms 1 & 2 now live in
:mod:`repro_torch.cluster.policies.prompttuner` as
:class:`~repro_torch.cluster.policies.PromptTunerPolicy`, running over the
pure event engine in :mod:`repro_torch.cluster.engine`. ``PromptTunerSim``
stays importable as a one-line policy wrapper; prefer::

    from repro_torch.cluster import policies
    engine = policies.build("prompttuner", cfg)

or the service front door :class:`repro_torch.api.PromptTunerService`.
"""
from __future__ import annotations

from repro_torch.cluster.engine import ClusterEngine, SimConfig
from repro_torch.cluster.policies.prompttuner import PromptTunerPolicy


class PromptTunerSim(ClusterEngine):
    """Deprecated: use ``policies.build('prompttuner', cfg)``."""

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg, PromptTunerPolicy(cfg))
