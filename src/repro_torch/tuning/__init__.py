from repro_torch.tuning.soft_prompt import PromptTuner, activation_features, default_probes

__all__ = ["PromptTuner", "activation_features", "default_probes"]
