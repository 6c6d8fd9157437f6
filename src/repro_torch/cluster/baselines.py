"""Deprecated shims for the baseline systems (§3, §6.1).

The INFless and ElasticFlow models now live in
:mod:`repro_torch.cluster.policies` (``infless.py`` / ``elasticflow.py``);
this module keeps the old class names importable as one-line policy
wrappers. Prefer::

    from repro_torch.cluster import policies
    engine = policies.build("infless", cfg)
"""
from __future__ import annotations

from repro_torch.cluster.engine import ClusterEngine, SimConfig
from repro_torch.cluster.policies import available, get


class INFlessSim(ClusterEngine):
    """Deprecated: use ``policies.build('infless', cfg)``."""

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg, get("infless")(cfg))


class ElasticFlowSim(ClusterEngine):
    """Deprecated: use ``policies.build('elasticflow', cfg)``."""

    def __init__(self, cfg: SimConfig):
        super().__init__(cfg, get("elasticflow")(cfg))


# name -> policy class, for callers that used to introspect this dict
SYSTEMS = {name: get(name) for name in available()}


def make_system(name: str, cfg: SimConfig) -> ClusterEngine:
    """Deprecated alias of ``policies.build(name, cfg)``."""
    return ClusterEngine(cfg, get(name)(cfg))
