from repro_torch.tuning.soft_prompt import (PromptTuner, activation_features, default_probes,
                                            init_prompt_from_tokens, init_prompt_random)

__all__ = ["PromptTuner", "activation_features", "default_probes", "init_prompt_from_tokens",
           "init_prompt_random"]
