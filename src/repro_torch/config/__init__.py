from repro_torch.config.base import (
    EncDecConfig,
    FrontendConfig,
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    TuneConfig,
)

__all__ = [
    "EncDecConfig",
    "FrontendConfig",
    "HybridConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "TuneConfig",
]
