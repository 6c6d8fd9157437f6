from repro_torch.launch.steps import (LONG_CONTEXT_WINDOW, make_prefill_step, make_serve_step,
                                      make_train_step, model_for_shape, supports_shape)

__all__ = ["LONG_CONTEXT_WINDOW", "make_prefill_step", "make_serve_step", "make_train_step",
           "model_for_shape", "supports_shape"]
